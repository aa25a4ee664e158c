"""Reed-Solomon RS(255,223) over GF(2^8) — FEC extension.

The reference's protocol spec promises RS(255,223) forward error correction
(docs/protocol_spec.md:56) but the implementation ships only CRC-32
detection + repetition coding. This module provides the real thing: a
systematic RS(255,223) codec (16-error-correcting), host-side (GF(256)
arithmetic is table-driven byte work — control-plane, not TPU math), with
encode/syndromes vectorized ACROSS codeword blocks in numpy so large chunked
transfers encode in bulk.

Conventions: field polynomial 0x11D (x^8+x^4+x^3+x^2+1), generator element
alpha = 2, first consecutive root fcr = 0 (generator polynomial
g(x) = prod_{i=0}^{31} (x - alpha^i)). Shortened codewords (k' < 223) are
zero-prefixed virtually, as usual.
"""

from __future__ import annotations

import numpy as np

N = 255
K = 223
NSYM = N - K  # 32 parity bytes, corrects up to 16 errors

_PRIM = 0x11D

# ---- GF(256) tables ----
_EXP = np.zeros(512, dtype=np.int32)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
_EXP[255:510] = _EXP[:255]


def _gf_mul(a, b):
    """Elementwise GF multiply for numpy arrays (0-safe)."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = _EXP[(_LOG[a] + _LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _gf_pow(a: int, p: int) -> int:
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * p) % 255])


def _gf_inv(a: int) -> int:
    return int(_EXP[255 - _LOG[a] - 0]) if a else 0


def _gen_poly() -> np.ndarray:
    """g(x) = prod (x - alpha^i), coefficients DESCENDING (g[0] = 1)."""
    g = np.array([1], dtype=np.int32)
    for i in range(NSYM):
        root = int(_EXP[i])
        nxt = np.zeros(len(g) + 1, dtype=np.int32)
        nxt[: len(g)] ^= g  # g * x
        nxt[1:] ^= _gf_mul(g, root).astype(np.int32)  # g * root
        g = nxt
    return g


_GEN = _gen_poly()


def encode_blocks(data: np.ndarray) -> np.ndarray:
    """Systematic encode: [B, k] message bytes -> [B, k + 32] codewords.

    Polynomial long division by g(x), vectorized across the block axis (the
    division recurrence is sequential over the k message bytes but each step
    is one table-lookup multiply over all B blocks at once).
    """
    data = np.asarray(data, dtype=np.int32)
    b, k = data.shape
    rem = np.zeros((b, NSYM), dtype=np.int32)
    gen = _GEN[1:]  # monic: skip leading 1; coefficients for feedback
    for j in range(k):
        feedback = data[:, j] ^ rem[:, 0]
        shifted = np.concatenate([rem[:, 1:], np.zeros((b, 1), np.int32)], axis=1)
        rem = shifted ^ _gf_mul(feedback[:, None], gen[None, :])
    return np.concatenate([data, rem], axis=1).astype(np.uint8)


def _syndromes(cw: np.ndarray) -> np.ndarray:
    """[B, n] codewords -> [B, 32] syndromes S_j = r(alpha^j), vectorized."""
    cw = np.asarray(cw, dtype=np.int32)
    b, n = cw.shape
    # Horner across the byte axis for all 32 roots at once
    roots = _EXP[:NSYM].astype(np.int32)  # alpha^0..alpha^31
    s = np.zeros((b, NSYM), dtype=np.int32)
    for j in range(n):
        s = _gf_mul(s, roots[None, :]) ^ cw[:, j : j + 1]
    return s


def _berlekamp_massey(s: np.ndarray) -> np.ndarray:
    """Syndrome sequence (length <= 32) -> error locator sigma (ascending).

    Accepts shortened sequences: errors-and-erasures decoding runs BM on the
    modified syndromes T_f..T_31 (length NSYM - f), finding an error locator
    of degree <= (NSYM - f)/2."""
    c = np.zeros(NSYM + 1, dtype=np.int32)
    b = np.zeros(NSYM + 1, dtype=np.int32)
    c[0] = b[0] = 1
    l, m, bb = 0, 1, 1
    for n_i in range(len(s)):
        d = int(s[n_i])
        for i in range(1, l + 1):
            d ^= int(_gf_mul(c[i], s[n_i - i]))
        if d == 0:
            m += 1
        elif 2 * l <= n_i:
            t = c.copy()
            coef = _gf_mul(d, _gf_inv(bb))
            shifted = np.zeros_like(b)
            shifted[m:] = b[: NSYM + 1 - m]
            c = c ^ _gf_mul(coef, shifted)
            l = n_i + 1 - l
            b = t
            bb = d
            m = 1
        else:
            coef = _gf_mul(d, _gf_inv(bb))
            shifted = np.zeros_like(b)
            shifted[m:] = b[: NSYM + 1 - m]
            c = c ^ _gf_mul(coef, shifted)
            m += 1
    return c[: l + 1], l


def _poly_eval(poly: np.ndarray, x: int) -> int:
    """Evaluate poly (ascending powers) at x."""
    y = 0
    for coef in poly[::-1]:
        y = int(_gf_mul(y, x)) ^ int(coef)
    return y


def _poly_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) polynomial product, ascending powers."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = np.zeros(len(a) + len(b) - 1, dtype=np.int32)
    for i in range(len(a)):
        if a[i]:
            out[i : i + len(b)] ^= _gf_mul(int(a[i]), b).astype(np.int32)
    return out


def decode_block(
    cw: np.ndarray, n: int | None = None, erasures: tuple[int, ...] = ()
) -> tuple[np.ndarray, int]:
    """Decode one codeword [n] -> (corrected message [n-32], n_corrected).

    ``erasures`` are byte positions (0 = first byte of cw) known to be
    unreliable — e.g. carried by OFDM symbols whose EVM marks them as hit by
    a dropout/burst. Errors-and-erasures decoding corrects e errors plus f
    erasures whenever 2e + f <= 32, i.e. up to DOUBLE the error-only radius
    when positions are known. Raises ValueError when uncorrectable.
    """
    cw = np.asarray(cw, dtype=np.int32).copy()
    n = n or len(cw)
    erasures = tuple(sorted({int(i) for i in erasures if 0 <= int(i) < n}))
    f = len(erasures)
    if f > NSYM:
        raise ValueError(f"RS decode failure: {f} erasures > {NSYM}")
    s = _syndromes(cw[None, :])[0]
    if not s.any():
        # valid codeword: erasure hints were false alarms
        return cw[: n - NSYM].astype(np.uint8), 0
    # erasure locator Gamma(x) = prod (1 + X_i x), X_i = alpha^{n-1-i}
    gamma = np.array([1], dtype=np.int32)
    for i in erasures:
        x_i = _gf_pow(2, (n - 1 - i) % 255)
        gamma = _poly_mul(gamma, np.array([1, x_i], dtype=np.int32))
    if f:
        # modified syndromes T = S*Gamma mod x^32; BM on T_f..T_31 finds the
        # locator of the remaining (non-erased) errors
        t = _poly_mul(s.astype(np.int32), gamma)[:NSYM]
        sigma, l = _berlekamp_massey(t[f:])
    else:
        sigma, l = _berlekamp_massey(s)
    psi = _poly_mul(sigma, gamma) if f else sigma  # combined locator
    # Chien search over the shortened length
    positions = []
    for i in range(n):
        # candidate position i (0 = first byte); root test at alpha^{-(n-1-i)}
        xinv = _gf_pow(2, (255 - (n - 1 - i)) % 255)
        if _poly_eval(psi, xinv) == 0:
            positions.append(i)
    if len(positions) != l + f:
        raise ValueError("RS decode failure: uncorrectable error pattern")
    # error evaluator Omega = (S(x) * psi(x)) mod x^32
    omega = _poly_mul(psi, s.astype(np.int32))[:NSYM]
    # Forney: e_i = X_i * Omega(Xi^-1) / psi'(Xi^-1)
    sigma_deriv = psi[1::2]  # odd-power coefficients (formal derivative, GF(2))
    for i in positions:
        xinv = _gf_pow(2, (255 - (n - 1 - i)) % 255)
        num = _poly_eval(omega, xinv)
        # sigma'(x) = sum odd coeffs * x^{even}: evaluate at xinv
        den = 0
        xp = 1
        xinv2 = int(_gf_mul(xinv, xinv))
        for coef in sigma_deriv:
            den ^= int(_gf_mul(coef, xp))
            xp = int(_gf_mul(xp, xinv2))
        if den == 0:
            raise ValueError("RS decode failure: Forney denominator zero")
        # fcr = 0: e_i = X_i * Omega(X_i^-1) / sigma'(X_i^-1)
        x_i = _gf_pow(2, (n - 1 - i) % 255)
        mag = _gf_mul(x_i, _gf_mul(num, _gf_inv(den)))
        cw[i] ^= int(mag)
    # verify
    if _syndromes(cw[None, :])[0].any():
        raise ValueError("RS decode failure: residual syndromes")
    return cw[: n - NSYM].astype(np.uint8), len(positions)


def interleave(coded: bytes, n_rows: int) -> bytes:
    """Block interleaver: write ``n_rows`` codeword rows, read column-wise.

    Spreads a burst of B consecutive byte errors across rows so each
    codeword sees only ~B/n_rows of them — with RS(255,223) a burst of up
    to 16*n_rows bytes stays correctable. Rows may be ragged (last codeword
    shortened); column-major traversal skips missing cells deterministically.
    """
    if n_rows <= 1:
        return coded
    rows = []
    off = 0
    while off < len(coded):
        rows.append(coded[off : off + N])
        off += N
    out = bytearray()
    max_len = max(len(r) for r in rows)
    for col in range(max_len):
        for r in rows:
            if col < len(r):
                out.append(r[col])
    return bytes(out)


def deinterleave(data: bytes, n_rows: int, row_lens: list[int]) -> bytes:
    """Inverse of :func:`interleave` given the original row lengths."""
    if n_rows <= 1:
        return data
    rows = [bytearray(l) for l in row_lens]
    it = iter(data)
    max_len = max(row_lens)
    for col in range(max_len):
        for r in rows:
            if col < len(r):
                r[col] = next(it)
    return b"".join(bytes(r) for r in rows)


def codeword_lengths(coded_len: int) -> list[int]:
    """Row lengths of concatenated codewords for a coded byte count."""
    lens = []
    off = 0
    while off < coded_len:
        lens.append(min(N, coded_len - off))
        off += lens[-1]
    return lens


def rs_encode(data: bytes) -> bytes:
    """Encode a byte string into concatenated RS(255,223) codewords.

    Blocks of 223 bytes; the final block is shortened to its actual length
    (its codeword is len + 32 bytes). The original length is recoverable
    from the coded length: full blocks of 255 plus one shortened block.
    """
    out = bytearray()
    for off in range(0, len(data), K):
        block = np.frombuffer(data[off : off + K], dtype=np.uint8)
        out += encode_blocks(block[None, :].astype(np.int32)).tobytes()
    return bytes(out)


def rs_decode(coded: bytes, erasures: "np.ndarray | None" = None) -> tuple[bytes, int]:
    """Decode concatenated codewords -> (data, total_corrected).

    Inverse of rs_encode; accepts a trailing shortened codeword. ``erasures``
    is an optional bool array aligned with ``coded`` marking unreliable
    bytes (errors-and-erasures decoding, see decode_block).
    """
    out = bytearray()
    corrected = 0
    off = 0
    n_bytes = len(coded)
    while off < n_bytes:
        n = min(N, n_bytes - off)
        if n <= NSYM:
            raise ValueError("RS decode failure: truncated codeword")
        cw = np.frombuffer(coded[off : off + n], dtype=np.uint8)
        ers: tuple[int, ...] = ()
        if erasures is not None:
            ers = tuple(int(i) for i in np.nonzero(erasures[off : off + n])[0])
        msg, c = decode_block(cw, n, erasures=ers)
        out += msg.tobytes()
        corrected += c
        off += n
    return bytes(out), corrected
