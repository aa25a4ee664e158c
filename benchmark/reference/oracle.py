"""The benchmark's plain reference of the modem: the float64 oracle of the
reference JS modem (the repository's tests/oracle/jsmodem.py, itself a model
of modem.js), transcribed to PyTorch so that it runs batched on the card
after a window and on the CPU in the tests.

Transmit (modem.js:158-208, 322-362, 498-555, 694-766): every frame is
built in float64 and stored in float32, as the oracle builds it. Receive
(modem.js:213-440, 557-654): DC removal and unit-peak normalization,
Schmidl-Cox scan with the first-peak commit (app.js:829-839), the
normalized cross-correlation refine over +-3 CP, the channel estimate, the
per-symbol DFT with ZF equalization, pilot phase and nearest-point demap,
then the repetition vote and the frame parse.

``Precision`` says how the receive side stores what it computes. The
reference (``REFERENCE``) keeps the oracle's: samples stored in float32
after the preprocess, everything else float64. The control (``CONTROL``)
stores the samples, the templates and the spectra in bfloat16, with float64
arithmetic in between: what a bfloat16 path with wide accumulation would
give. It imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.profiles import (
    CONSTELLATIONS, FRAME_DATA, FRAME_META, MODES, Mode, Profile, crc32, crc32_rows, js_lcg_signs,
)

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    samples: torch.dtype
    products: torch.dtype | None

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` stored as a sample (after the preprocess), back in float64."""
        return x.to(self.samples).to(F64)

    def qp(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` stored as a product (a template, a spectrum), back in float64."""
        if self.products is None:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(self.products).to(F64), x.imag.to(self.products).to(F64))
        return x.to(self.products).to(F64)


REFERENCE = Precision("float32 samples, float64 arithmetic (the oracle)", torch.float32, None)
CONTROL = Precision("bfloat16 samples, templates and spectra", torch.bfloat16, torch.bfloat16)


# ---------- transmit ----------


def _symbols(spec: torch.Tensor, bins: np.ndarray, p: Profile) -> torch.Tensor:
    """Complex values [N, len(bins)] on ``bins`` -> real symbols with CP,
    float32 [N, symbol_len] (modem.js:164-169, 202-208)."""
    half = torch.zeros((spec.shape[0], p.fft_size // 2 + 1), dtype=torch.complex128, device=spec.device)
    half[:, torch.as_tensor(bins, device=spec.device)] = spec
    td = torch.fft.irfft(half, n=p.fft_size)
    return torch.cat([td[:, -p.cp_len :], td], dim=1).to(torch.float32)


def _sign_symbol(p: Profile, bins: np.ndarray, seed: int, device) -> torch.Tensor:
    signs = torch.as_tensor(js_lcg_signs(seed, len(bins)), device=device).to(torch.complex128)
    return _symbols(signs[None], bins, p)[0]


def preamble1(p: Profile, device="cpu") -> torch.Tensor:
    return _sign_symbol(p, np.arange(p.sub_start, p.sub_end + 1, 2), 42, device)


def header(p: Profile, device="cpu") -> torch.Tensor:
    """Preamble 1, preamble 2 and the CE symbol: float32 [3 * symbol_len]."""
    active = np.arange(p.sub_start, p.sub_end + 1)
    return torch.cat([preamble1(p, device), _sign_symbol(p, active, 43, device), _sign_symbol(p, active, 44, device)])


def ce_known(p: Profile, device="cpu") -> torch.Tensor:
    return torch.as_tensor(js_lcg_signs(44, p.num_active), device=device)


def unpack_bits(by: torch.Tensor) -> torch.Tensor:
    """uint8 [..., L] -> int64 bits [..., 8 L], MSB first."""
    shifts = torch.arange(7, -1, -1, device=by.device)
    return ((by.to(torch.int64)[..., None] >> shifts) & 1).reshape(*by.shape[:-1], -1)


def modulate(bits: torch.Tensor, mode: Mode) -> torch.Tensor:
    """int64 bits [F, n] -> float32 [F, n_sym, symbol_len] (modem.js:322-362)."""
    p = mode.profile
    bps = mode.bps
    f, n = bits.shape
    per_sym = p.num_data * bps
    n_sym = -(-n // per_sym)
    bits = torch.nn.functional.pad(bits, (0, n_sym * per_sym - n))
    groups = bits.reshape(f, n_sym, p.num_data, bps)
    idx = (groups * (2 ** torch.arange(bps - 1, -1, -1, device=bits.device))).sum(-1)
    pts = torch.as_tensor(CONSTELLATIONS[mode.constellation], device=bits.device)
    data = torch.complex(pts[idx, 0], pts[idx, 1])
    active = np.arange(p.sub_start, p.sub_end + 1)
    pilot = torch.as_tensor(np.isin(active, p.pilots), device=bits.device)
    spec = torch.ones((f, n_sym, p.num_active), dtype=torch.complex128, device=bits.device)
    spec[:, :, ~pilot] = data
    return _symbols(spec.reshape(f * n_sym, -1), active, p).reshape(f, n_sym, p.symbol_len)


def frames(payloads: torch.Tensor, mode: Mode, silence_pre: int, silence_post: int) -> torch.Tensor:
    """Equal-length payloads uint8 [F, L] -> frames float32 [F, frame_len]:
    silence, preambles, CE, data, silence, scaled to a 0.8 peak
    (modem.js:498-555, 758-766)."""
    p = mode.profile
    bits = unpack_bits(payloads)
    if mode.repetition > 1:
        bits = bits.repeat_interleave(mode.repetition, dim=1)
    syms = modulate(bits, mode).reshape(payloads.shape[0], -1)
    f = syms.shape[0]
    dev = syms.device
    sig = torch.cat([
        torch.zeros((f, silence_pre), dtype=torch.float32, device=dev),
        header(p, dev).expand(f, -1),
        syms,
        torch.zeros((f, silence_post), dtype=torch.float32, device=dev),
    ], dim=1)
    mx = sig.abs().amax(dim=1)
    scale = torch.where(mx > 0, torch.full_like(mx, 0.8) / torch.where(mx > 0, mx, 1.0), 1.0)
    return (sig.to(F64) * scale.to(F64)[:, None]).to(torch.float32)


def frame_len(n_payload_bytes: int, mode: Mode, silence_pre: int, silence_post: int) -> int:
    p = mode.profile
    n_bits = 8 * n_payload_bytes * mode.repetition
    return silence_pre + (3 + -(-n_bits // mode.bits_per_symbol)) * p.symbol_len + silence_post


def be32(v: int) -> bytes:
    return int(v).to_bytes(4, "big")


def legacy_payload(data: bytes, file_name: str) -> bytes:
    """[nameLen:1][name][dataLen:4][data][CRC:4] (modem.js:498-522)."""
    name = (file_name or "file").encode("utf-8")[:255]
    body = bytes([len(name)]) + name + be32(len(data)) + data
    return body + be32(crc32(body))


def metadata_payload(total_chunks: int, total_size: int, chunk_size: int, file_name: str) -> bytes:
    """modem.js:666-692."""
    name = (file_name or "file").encode("utf-8")[:255]
    body = (bytes([FRAME_META]) + be32(total_chunks) + be32(total_size)
            + bytes([(chunk_size >> 8) & 0xFF, chunk_size & 0xFF, len(name)]) + name)
    return body + be32(crc32(body))


def data_chunk_payloads(chunks: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Equal-length chunks uint8 [F, L] and their seqs int64 [F] -> data-chunk
    payloads uint8 [F, 11 + L] (modem.js:694-714), CRCs on the chunks'
    device."""
    n = chunks.shape[1]
    head = torch.stack([torch.full_like(seq, FRAME_DATA)] + [(seq >> s) & 0xFF for s in (24, 16, 8, 0)]
                       + [torch.full_like(seq, (n >> 8) & 0xFF), torch.full_like(seq, n & 0xFF)], dim=1)
    body = torch.cat([head.to(torch.uint8), chunks], dim=1)
    crc = crc32_rows(body)
    tail = torch.stack([(crc >> s) & 0xFF for s in (24, 16, 8, 0)], dim=1).to(torch.uint8)
    return torch.cat([body, tail], dim=1)


def transmit_signal(data: bytes, mode_name: str, file_name: str, device="cpu") -> torch.Tensor:
    """One legacy frame (modem.js:498-555), float32 [n]."""
    mode = MODES[mode_name]
    p = mode.profile
    pl = torch.frombuffer(bytearray(legacy_payload(data, file_name)), dtype=torch.uint8).to(device)
    return frames(pl[None], mode, p.silence_pre_legacy(), p.silence_post_legacy())[0]


# ---------- receive ----------


def gather(sig: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """[len(rows), length] cut from rows ``rows`` of ``sig`` at ``starts``;
    samples outside the row read as 0."""
    t = sig.shape[1]
    idx = starts.to(torch.int64)[:, None] + torch.arange(length, device=sig.device)
    inside = (idx >= 0) & (idx < t)
    vals = sig[rows.to(torch.int64)[:, None], idx.clamp(0, t - 1)]
    return torch.where(inside, vals, 0.0)


def preprocess(x: torch.Tensor, n_valid: torch.Tensor, prec: Precision = REFERENCE) -> torch.Tensor:
    """DC removal and unit-peak normalization over the first n_valid samples
    of each row of [R, T] (modem.js:213-232); samples past it are 0."""
    t = x.shape[1]
    nv = n_valid.to(torch.int64)[:, None]
    mask = torch.arange(t, device=x.device) < nv
    s = torch.where(mask, x.to(F64), 0.0)
    out = torch.where(mask, s - s.sum(1, keepdim=True) / nv.clamp(min=1), 0.0)
    mx = out.abs().amax(1, keepdim=True)
    return prec.q(torch.where(mx > 1e-6, out / torch.where(mx > 1e-6, mx, 1.0), out))


def detect(sig: torch.Tensor, p: Profile, n_valid: torch.Tensor, min_pos: torch.Tensor) -> torch.Tensor:
    """Schmidl-Cox coarse position of each row (modem.js:286-319) with the
    first-peak commit: the scan stops where the metric first drops below
    0.7x its running max once that max is past 0.5. Positions before
    ``min_pos`` or past n_valid - fft do not count. -1 where nothing peaks."""
    half = p.fft_size // 2
    r, t = sig.shape
    zero = torch.zeros((r, 1), dtype=F64, device=sig.device)
    cp = torch.cat([zero, torch.cumsum(sig[:, : t - half] * sig[:, half:], 1)], 1)
    cs = torch.cat([zero, torch.cumsum(sig * sig, 1)], 1)
    n_pos = t - 2 * half + 1
    d = torch.arange(n_pos, device=sig.device)
    pp = cp[:, half : half + n_pos] - cp[:, :n_pos]
    ra = cs[:, half : half + n_pos] - cs[:, :n_pos]
    rb = cs[:, 2 * half : 2 * half + n_pos] - cs[:, half : half + n_pos]
    valid = ((ra > 0.01) & (rb > 0.01) & (d >= min_pos.to(torch.int64)[:, None])
             & (d <= n_valid.to(torch.int64)[:, None] - 2 * half))
    metric = torch.where(valid, pp * pp / torch.where(valid, ra * rb, 1.0), 0.0)
    runmax = torch.cummax(metric, 1).values
    drop = (runmax > 0.5) & (metric < 0.7 * runmax)
    end = torch.where(drop.any(1), torch.argmax(drop.to(torch.uint8), 1), n_pos - 1)
    metric = torch.where(d <= end[:, None], metric, 0.0)
    best, idx = metric.max(1)
    return torch.where(best > 0.5, idx, -1)


def refine(sig: torch.Tensor, rows: torch.Tensor, coarse: torch.Tensor, p: Profile, n_valid: torch.Tensor,
           prec: Precision = REFERENCE) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized cross-correlation with preamble 1 over
    d in [max(0, c - 3 CP), min(n_valid - sym, c + 3 CP)] of rows ``rows``
    (modem.js:567-588): (start, best metric); the first maximum wins, and a
    row with no usable offset keeps its coarse position with metric -inf."""
    plen, radius = p.symbol_len, 3 * p.cp_len
    n_off = 2 * radius + 1
    coarse = coarse.to(torch.int64)
    lo = (coarse - radius).clamp(min=0)
    hi = torch.minimum(n_valid.to(torch.int64)[rows] - plen, coarse + radius)
    tpl = prec.qp(preamble1(p, sig.device).to(F64))
    win = gather(sig, rows, lo, n_off + plen - 1).unfold(1, plen, 1)
    corr = win @ tpl
    denom = torch.sqrt((win * win).sum(-1) * (tpl * tpl).sum())
    ok = (denom > 0.001) & (lo[:, None] + torch.arange(n_off, device=sig.device) <= hi[:, None])
    metric = torch.where(ok, corr / torch.where(ok, denom, 1.0), float("-inf"))
    best, arg = metric.max(1)
    return torch.where(torch.isfinite(best), lo + arg, coarse), best


def channel(sig: torch.Tensor, rows: torch.Tensor, start: torch.Tensor, p: Profile,
            prec: Precision = REFERENCE) -> torch.Tensor:
    """H = Y X on the active bins from the CE symbol after the preambles
    (modem.js:421-440): complex128 [len(rows), n_active]."""
    ce = gather(sig, rows, start + 2 * p.symbol_len, p.symbol_len)[:, p.cp_len : p.cp_len + p.fft_size]
    spec = torch.fft.fft(ce)[:, p.sub_start : p.sub_end + 1]
    return prec.qp(spec * ce_known(p, sig.device))


def demodulate(data: torch.Tensor, ch: torch.Tensor, mode: Mode) -> torch.Tensor:
    """Symbols [n_sym, symbol_len] -> hard bits int64 [n_sym * bps]: DFT, ZF
    EQ, pilot common-phase correction, nearest point (modem.js:365-418)."""
    p = mode.profile
    spec = torch.fft.fft(data[:, p.cp_len : p.cp_len + p.fft_size])[:, p.sub_start : p.sub_end + 1]
    h_mag = ch.real ** 2 + ch.imag ** 2
    eq = torch.where(h_mag > 1e-10, spec * ch.conj() / torch.where(h_mag > 1e-10, h_mag, 1.0), spec)
    pilot = torch.as_tensor(np.isin(np.arange(p.sub_start, p.sub_end + 1), p.pilots), device=data.device)
    pr = eq[:, pilot]
    usable = pr.real.abs() > 1e-6
    ratio = torch.where(usable, pr.imag / torch.where(usable, pr.real, 1.0), 0.0)
    phase = torch.where(usable.any(1), ratio.sum(1) / usable.sum(1).clamp(min=1), 0.0)[:, None]
    d = eq[:, ~pilot]
    cr, ci = d.real + d.imag * phase, d.imag - d.real * phase
    pts = torch.as_tensor(CONSTELLATIONS[mode.constellation], device=data.device)
    idx = ((cr[..., None] - pts[:, 0]) ** 2 + (ci[..., None] - pts[:, 1]) ** 2).argmin(-1)
    shifts = torch.arange(mode.bps - 1, -1, -1, device=data.device)
    return ((idx[..., None] >> shifts) & 1).reshape(-1)


def to_bytes(bits: torch.Tensor, repetition: int) -> bytes:
    if repetition > 1:
        m = bits.shape[0] // repetition
        bits = (bits[: m * repetition].reshape(m, repetition).sum(1) * 2 >= repetition).to(torch.int64)
    n = bits.shape[0] // 8 * 8
    return np.packbits(bits[:n].cpu().numpy().astype(np.uint8)).tobytes()


def parse(by: bytes) -> dict:
    """The frame parse by type (modem.js:622-653, 805-849)."""
    if len(by) < 10:
        return {"error": "Decoded data too short"}
    if by[0] == FRAME_META:
        name_len = by[11]
        off = 12 + name_len
        return {"type": "meta", "total_chunks": int.from_bytes(by[1:5], "big"),
                "crc_valid": int.from_bytes(by[off : off + 4], "big") == crc32(by[:off])}
    if by[0] == FRAME_DATA:
        n = int.from_bytes(by[5:7], "big")
        off = 7 + n
        return {"type": "data", "seq": int.from_bytes(by[1:5], "big"), "data": by[7:off],
                "crc_valid": int.from_bytes(by[off : off + 4], "big") == crc32(by[:off])}
    off = 1 + by[0]
    if off + 8 > len(by):
        return {"error": "too short for header"}
    name = by[1:off].decode("utf-8", errors="replace")
    n = int.from_bytes(by[off : off + 4], "big")
    off += 4
    if n <= 0 or off + n + 4 > len(by):
        return {"error": f"Invalid data length: {n}"}
    return {"type": "legacy", "file_name": name, "data": by[off : off + n],
            "crc_valid": int.from_bytes(by[off + n : off + n + 4], "big") == crc32(by[: off + n])}


def receive(x: torch.Tensor, n_valid: torch.Tensor, min_pos: torch.Tensor, p: Profile,
            prec: Precision = REFERENCE) -> dict:
    """The front end over rows [R, T]: preprocess, coarse scan, refine, CE.
    "detected" is a coarse peak with a refined metric of at least 0.1
    (modem.js:590-593)."""
    sig = preprocess(x, n_valid, prec)
    rows = torch.arange(sig.shape[0], device=sig.device)
    coarse = detect(sig, p, n_valid, min_pos)
    start, fine = refine(sig, rows, coarse.clamp(min=0), p, n_valid, prec)
    return {"sig": sig, "coarse": coarse, "start": start, "fine": fine,
            "detected": (coarse >= 0) & (fine >= 0.1), "ch": channel(sig, rows, start, p, prec)}


def decode_signal(x: torch.Tensor, mode_name: str, prec: Precision = REFERENCE) -> dict:
    """Full-signal decode of one recording (modem.js:557-654): the front end,
    then every symbol to the end of the signal, the vote and the parse."""
    mode = MODES[mode_name]
    p = mode.profile
    n = x.shape[0]
    fe = receive(x[None], torch.tensor([n], device=x.device), torch.zeros(1, dtype=torch.int64, device=x.device),
                 p, prec)
    out = {k: fe[k][0] for k in ("coarse", "start", "fine", "detected", "ch")}
    if not bool(out["detected"]):
        return out | {"parsed": {"error": "Preamble not detected"}}
    start = int(out["start"])
    data_start = start + 3 * p.symbol_len
    n_sym = (n - data_start) // p.symbol_len
    data = fe["sig"][0, data_start : data_start + n_sym * p.symbol_len].reshape(n_sym, p.symbol_len)
    return out | {"parsed": parse(to_bytes(demodulate(data, out["ch"], mode), mode.repetition))}
