"""Kernel C's FFT tile and slot chain (csrc/receive.cu, fft_demod_tile and
predicted_chain_kernel) modelled on the CPU.

* ``fft_bins``: a float32 model of the tile's FFT plan, the same radix order
  (the 512-sample body packed as 256 complex points, a 16 x 16 complex FFT
  whose 16-point DFTs are radix-4 pairs, twiddles W256^(n2 k1) between
  them), the same twiddle table (``Tables.fft_twiddle``) and the same real
  split at the data and pilot bins (``Tables.demod_bins``). On random bodies
  of each profile it matches the plain version's product with rx_demod
  within 1e-5 of the body's norm, and numpy's float64 rfft within float32
  error.
* The twiddle table is float64 cos / -sin rounded once, and the bins are the
  profile's; both are bit for bit the same through ``profile_tables`` and
  through ``tables_from_numpy`` on the JAX package's arrays.
* ``chain_cover``, the chain's prefetch span, holds every region the next
  slot can refine, at the clamps (coarse index 0 and T - 1, regions that
  cross n_valid or T) too; staged as the kernel stages it (``stage_span``:
  16-byte aligned base, zeros outside the valid samples), the buffer holds
  the normalized samples the plain loop refines, and the refine's reads stay
  inside the kernel's span buffer.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_modem_tpu.configs import OFDM_PROFILES as JPROFILES
from audio_modem_tpu.ops import dft as jdft
from audio_modem_tpu_torch import tables
from audio_modem_tpu_torch.configs import OFDM_PROFILES

CU = Path(tables.__file__).resolve().parent / "csrc" / "receive.cu"
PROFILES = sorted(OFDM_PROFILES)
F32_EPS = float(np.finfo(np.float32).eps)


def cu_constant(name: str) -> int:
    """An integer ``constexpr int`` of csrc/receive.cu, its expression
    evaluated over the constants defined before it."""
    src = CU.read_text()
    env: dict = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        env[key] = eval(expr, {}, dict(env))  # noqa: S307 - integer expressions of the kernel's own source
    return env[name]


# ---- the FFT plan ----

# bin k of a 16-point DFT ends at index 4 (k % 4) + k // 4 (digit reversal of the radix-4 pair)
_ORDER = [4 * (k % 4) + k // 4 for k in range(16)]


def _cmul(re, im, w):
    return re * w[..., 0] - im * w[..., 1], re * w[..., 1] + im * w[..., 0]


def _dft4(re, im, idx):
    i0, i1, i2, i3 = idx
    ar, ai = re[..., i0] + re[..., i2], im[..., i0] + im[..., i2]
    br, bi = re[..., i0] - re[..., i2], im[..., i0] - im[..., i2]
    cr, ci = re[..., i1] + re[..., i3], im[..., i1] + im[..., i3]
    dr, di = re[..., i1] - re[..., i3], im[..., i1] - im[..., i3]
    re[..., i0], im[..., i0] = ar + cr, ai + ci
    re[..., i1], im[..., i1] = br + di, bi - dr  # b - i d
    re[..., i2], im[..., i2] = ar - cr, ai - ci
    re[..., i3], im[..., i3] = br - di, bi + dr  # b + i d


def dft16(re: np.ndarray, im: np.ndarray, tw: np.ndarray):
    """The kernel's 16-point DFT over the last axis (float32): DFT4 over m1
    of a[4 m1 + m2], twiddles W16^(m2 l1) = tw[32 m2 l1], DFT4 over m2;
    returned in natural order."""
    re, im = re.copy(), im.copy()
    for m2 in range(4):
        _dft4(re, im, [m2, m2 + 4, m2 + 8, m2 + 12])
    for m2 in range(1, 4):
        for l1 in range(1, 4):
            i = m2 + 4 * l1
            re[..., i], im[..., i] = _cmul(re[..., i], im[..., i], tw[32 * m2 * l1])
    for l1 in range(4):
        _dft4(re, im, [4 * l1, 4 * l1 + 1, 4 * l1 + 2, 4 * l1 + 3])
    return re[..., _ORDER], im[..., _ORDER]


def fft_bins(bodies: np.ndarray, tw: np.ndarray, bins: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The FFT tile's spectrum of real bodies [R, 512] at ``bins`` (float32
    re, im [R, len(bins)]): z[n] = x[2n] + i x[2n+1]; thread n2 takes the
    16-point DFT of z[16 n1 + n2] and multiplies bin k1 by W256^(n2 k1) =
    tw[2 n2 k1]; thread k1 the 16-point DFT of that column; Z[k1 + 16 k2];
    then X[b] = (Z[b] + conj Z[256-b]) / 2 - i W512^b (Z[b] - conj Z[256-b]) / 2."""
    x = np.asarray(bodies, np.float32)
    tw = np.asarray(tw, np.float32)
    r = x.shape[0]
    z_re, z_im = x[:, 0::2], x[:, 1::2]
    a_re = z_re.reshape(r, 16, 16).transpose(0, 2, 1)  # [R, n2, n1]
    a_im = z_im.reshape(r, 16, 16).transpose(0, 2, 1)
    y_re, y_im = dft16(a_re, a_im, tw)  # [R, n2, k1]
    n2k1 = 2 * np.arange(16)[:, None] * np.arange(16)[None, :]
    y_re, y_im = _cmul(y_re, y_im, tw[n2k1])
    z2_re, z2_im = dft16(y_re.transpose(0, 2, 1), y_im.transpose(0, 2, 1), tw)  # [R, k1, k2]
    zr = z2_re.transpose(0, 2, 1).reshape(r, 256)  # Z[k1 + 16 k2]
    zi = z2_im.transpose(0, 2, 1).reshape(r, 256)
    b = np.asarray(bins)
    zbr, zbi = zr[:, b & 255], zi[:, b & 255]
    zcr, zci = zr[:, (256 - b) & 255], zi[:, (256 - b) & 255]
    half = np.float32(0.5)
    er, ei = half * (zbr + zcr), half * (zbi - zci)
    orr, oi = half * (zbi + zci), -half * (zbr - zcr)
    w = tw[b]
    return er + (w[:, 0] * orr - w[:, 1] * oi), ei + (w[:, 0] * oi + w[:, 1] * orr)


def spectrum_columns(re: np.ndarray, im: np.ndarray, nd: int) -> np.ndarray:
    """Bins' (re, im) in rx_demod's column layout: data re | data im | pilot re | pilot im."""
    return np.concatenate([re[:, :nd], im[:, :nd], re[:, nd:], im[:, nd:]], axis=1)


@pytest.mark.parametrize("name", PROFILES)
def test_fft_plan_matches_the_product_and_rfft(name):
    p = OFDM_PROFILES[name]
    tabs = tables.profile_tables(p, "cpu")
    rng = np.random.default_rng(13)
    bodies = rng.standard_normal((64, p.fft_size)).astype(np.float32)
    bodies[:8] *= np.float32(1e-3)  # quiet rows: the tolerance scales with the norm
    bins = tabs.demod_bins.numpy()
    nd = p.num_data_subs
    re, im = fft_bins(bodies, tabs.fft_twiddle.numpy(), bins)
    assert re.dtype == im.dtype == np.float32
    norm = np.linalg.norm(bodies.astype(np.float64), axis=1, keepdims=True)
    ncol = 2 * len(bins)
    product = torch.matmul(torch.from_numpy(bodies), tabs.rx_demod).numpy()[:, :ncol]
    err = np.abs(spectrum_columns(re, im, nd) - product)
    assert (err <= 1e-5 * norm).all(), float((err / norm).max())
    exact = np.fft.rfft(bodies.astype(np.float64), axis=1)[:, bins]
    err64 = np.maximum(np.abs(re - exact.real), np.abs(im - exact.imag))
    # float32 error of a radix-4 FFT: about eps per stage (9) on the norm
    assert (err64 <= 9 * F32_EPS * norm).all(), float((err64 / norm).max())


def test_fft_plan_of_a_constant_and_of_a_tone():
    """A constant body has no energy off bin 0 in the plan (the first DFT4s
    cancel exactly), and a tone at an active bin lands there."""
    p = OFDM_PROFILES[PROFILES[0]]
    tabs = tables.profile_tables(p, "cpu")
    tw = tabs.fft_twiddle.numpy()
    bins = tabs.demod_bins.numpy()
    re, im = fft_bins(np.full((1, 512), 0.37, np.float32), tw, bins)
    assert not re.any() and not im.any()
    k = int(bins[3])
    t = np.arange(512)
    re, im = fft_bins(np.cos(2 * np.pi * k * t / 512)[None].astype(np.float32), tw, np.array([k, k + 1]))
    assert abs(re[0, 0] - 256) < 1e-3 and abs(im[0, 0]) < 1e-3 and abs(re[0, 1]) < 1e-3


# ---- the tables ----


@pytest.mark.parametrize("name", PROFILES)
def test_twiddles_and_bins_from_configs_and_from_jax_arrays(name):
    p, jp = OFDM_PROFILES[name], JPROFILES[name]
    got = tables.profile_tables(p, "cpu")
    ang = 2.0 * np.pi * np.arange(p.fft_size, dtype=np.float64) / p.fft_size
    want = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    assert got.fft_twiddle.dtype == torch.float32 and np.array_equal(got.fft_twiddle.numpy(), want)
    assert got.demod_bins.dtype == torch.int32
    assert np.array_equal(got.demod_bins.numpy(), np.concatenate([p.data_bins, p.pilot_bins]))
    assert int(got.demod_bins.max()) <= p.fft_size // 2
    arrays = dict(tables.numpy_tables(p))
    arrays["rx_active"] = jdft._rx_matrix(jp)
    arrays["rx_data"] = jdft._rx_matrix_for_bins(jp, tuple(int(b) for b in jp.data_bins))
    arrays["rx_pilot"] = jdft._rx_matrix_for_bins(jp, tuple(int(b) for b in jp.pilot_bins))
    from_jax = tables.tables_from_numpy(arrays, "cpu")
    for field in ("fft_twiddle", "demod_bins", "rx_demod"):
        x, y = getattr(from_jax, field), getattr(got, field)
        assert x.dtype == y.dtype and torch.equal(x, y), field


def test_fft_tile_constants_fit_every_profile():
    """The tile's rows hold a body at any alignment and the FFT's 16 x 17
    complex; a thread of a row takes at most 16 bins; its shared memory fits
    two CTAs an SM at the standard profile."""
    rows, ld, threads = cu_constant("kFftRows"), cu_constant("kFftLd"), cu_constant("kThreadsFft")
    assert ld % 4 == 0 and ld >= 512 + 4 and ld >= 2 * 16 * 17 and threads % 32 == 0 and threads >= rows
    for name in PROFILES:
        p = OFDM_PROFILES[name]
        nd, npi = p.num_data_subs, len(p.pilots)
        assert nd + npi <= 16 * 16 and p.symbol_len % 4 == 0
        floats = rows * ld + -(-(3 * nd + 3 * npi + rows + 2 * rows * npi) // 4) * 4
        assert 2 * (4 * floats + 1024) <= 232_448


# ---- the chain's prefetch span ----


def chain_cover(w_lo: int, w_hi: int, t: int, radius: int, length: int) -> tuple[int, int]:
    """csrc/receive.cu chain_cover: samples [first, end) holding the refine
    region [max(c - radius, 0), + length) of every c = clamp(w, 0, T - 1)
    with w in [w_lo, w_hi]."""
    c_lo, c_hi = min(max(w_lo, 0), t - 1), min(max(w_hi, 0), t - 1)
    return max(c_lo - radius, 0), max(c_hi - radius, 0) + length


def stage_span(sample, first: int, end: int, misalign: int, span: int) -> tuple[int, np.ndarray]:
    """csrc/receive.cu stage_span + land_span: (base, buffer of ``span``
    floats) with buffer[i] = sample(base + i) for the staged quads, NaN past
    them; base is ``first`` less the row's misalignment there."""
    base = first - (misalign + first) % 4
    nq = -(-(end - base) // 4)
    assert 4 * nq <= span
    buf = np.full(span, np.nan, np.float32)
    buf[: 4 * nq] = sample(np.arange(base, base + 4 * nq))
    return base, buf


def refine_reach(off: int, n_off: int, sym: int) -> int:
    """One past the last buffer index the register-blocked refine reads:
    thread t reads float4s from (off - a) + 4 t up to (off - a) + 4 (t +
    sym / 4 + 1), one step ahead of the taps it sums."""
    a = off % 4
    n_thr = (n_off + a + 3) // 4
    return (off - a) + 4 * (n_thr - 1) + sym + 8


@pytest.mark.parametrize("cp", [64, 128, 256])
def test_chain_cover_holds_every_next_region(cp):
    sym = 512 + cp
    radius, n_off = 3 * cp, 6 * cp + 1
    length = n_off + sym - 1
    span = cu_constant("kSpanFloats")
    rng = np.random.default_rng(cp)
    t, cadence = 40_000, 8_000
    x = rng.standard_normal(t).astype(np.float32)
    for nv in (t, t - 700, 9_000):  # n_valid at T, a region across it, far inside
        valid = np.arange(t) < nv
        mean, scale = np.float32(x[valid].mean()), np.float32(0.5)

        def sample(i, nv=nv, mean=mean, scale=scale):
            inside = (i >= 0) & (i < min(nv, t))
            return np.where(inside, (x[np.clip(i, 0, t - 1)] - mean) * scale, 0.0).astype(np.float32)

        # coarse indices at and near the clamps, then every start the refine can give
        for c in (0, 1, radius - 1, radius + 5, nv - sym - 3, nv - 1, t - cadence - radius, t - cadence + 2,
                  t - 2, t - 1, 12_345):
            first, end = chain_cover(c - radius + cadence, c + radius + cadence, t, radius, length)
            for misalign in (0, 1, 2, 3):
                base, buf = stage_span(sample, first, end, misalign, span)
                for start in range(c - radius, c + radius + 1, 7 if radius > 200 else 1):
                    c_next = min(max(start + cadence, 0), t - 1)
                    lo = max(c_next - radius, 0)
                    assert first <= lo and lo + length <= end, (c, start)
                    off = lo - base
                    assert np.array_equal(buf[off : off + length], sample(np.arange(lo, lo + length)))
                    assert refine_reach(off, n_off, sym) <= span
    # slot 0's span is its own region, clamped predictions included
    for want in (-(10**6), -1, 0, 500, t - 1, t + 10**6):
        first, end = chain_cover(want, want, t, radius, length)
        c0 = min(max(want, 0), t - 1)
        assert (first, end) == (max(c0 - radius, 0), max(c0 - radius, 0) + length)
