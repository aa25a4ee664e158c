"""The card's roofline: published peaks keyed by card name, and the least
work of each hand-written kernel as (bytes, float32 operations).

The port computes in float32 on the CUDA cores with TF32 off (see the
package docstring), so a kernel's least time is the larger of its bytes
over the card's memory rate and its float32 operations over the card's
float32 peak. Bytes count each input read once and each output written
once; each DFT is counted at the cost of a real-input FFT. ``chip_smoke.py``
(bounds beside each kernel's time) and ``bench.py`` (shares at the bench's
rates) both read these definitions.
"""

from __future__ import annotations

import math

from audio_modem_tpu_torch.configs import ModemMode, OfdmProfile
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

# Published peaks at 700 W (NVIDIA's data sheet, SXM part): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores. A card absent here has no peaks:
# its shares are not computed, never taken from another card.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
PEAKS: dict[str, tuple[float, float]] = {"NVIDIA H100 80GB HBM3": (HBM_BYTES_PER_S, FP32_FLOPS)}


def card_peaks(name: str) -> tuple[float, float] | None:
    """(HBM bytes/s, float32 FLOP/s) of the card called ``name``
    (``torch.cuda.get_device_name``), or None for a card not in ``PEAKS``."""
    return PEAKS.get(name)


def bound_ms(n_bytes: float, n_flops: float, peaks: tuple[float, float]) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / peaks[0] * 1e3, n_flops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fft_flops(mode: ModemMode, n_ffts: int) -> float:
    """Real-input FFTs of fft_size samples, 2.5 N log2 N flops each: the least
    work that yields the active, data and pilot bins of a symbol."""
    n = mode.profile.fft_size
    return 2.5 * n * math.log2(n) * n_ffts


def work_decode_fused(mode: ModemMode, b: int, t: int, max_syms: int) -> tuple[float, float]:
    """(bytes, flops) of kernel A: window, tables and outputs once; mean, normalize
    (2), block sums (4 per sample), window sums and metric (~50 per position),
    the +-3*CP refine (2 FMAs per tap), one FFT for the CE and one per symbol."""
    p = mode.profile
    n_off = 6 * p.cp_len + 1
    tables = 4 * p.fft_size * 2 * (p.num_active_subs + p.num_data_subs + len(p.pilots)) + 4 * p.symbol_len
    out = b * (17 + max_syms * bits_per_symbol(mode) + 8 * p.num_active_subs)
    n_bytes = 4.0 * b * t + 8 * b + tables + out
    flops = (7.0 * b * t + 50.0 * b * (t // 16) + 4.0 * b * n_off * p.symbol_len
             + _fft_flops(mode, b * (1 + max_syms)))
    return n_bytes, flops


def work_decode_predicted(mode: ModemMode, b: int, w: int, n_sym_frame: int, k: int) -> tuple[float, float]:
    """(bytes, flops) of kernel C over k predicted slots: window, tables and
    outputs (the packed rows, and each slot's start, fine metric and flag)
    once; mean, max and normalize (4 a sample), the +-3*CP refine (2 FMAs
    per tap), one FFT for the CE and one per symbol of every slot."""
    p = mode.profile
    n_off = 6 * p.cp_len + 1
    tables = 4 * p.fft_size * 2 * (p.num_active_subs + p.num_data_subs + len(p.pilots)) + 4 * p.symbol_len
    n_bytes = n_sym_frame * bits_per_symbol(mode) // mode.repetition // 8
    out = b * k * (5 + n_bytes + 9)
    n_bytes_moved = 4.0 * b * w + 9 * b + tables + out
    flops = 4.0 * b * w + 4.0 * b * k * n_off * p.symbol_len + _fft_flops(mode, b * k * (1 + n_sym_frame))
    return n_bytes_moved, flops


def work_chunks(mode: ModemMode, b: int, t: int, n_sym: int) -> tuple[float, float]:
    """(bytes, flops) of kernel B: frames and bits once; peak, scale, one FFT
    for the CE and one per symbol."""
    return (4.0 * b * t + b * n_sym * bits_per_symbol(mode), 2.0 * b * t + _fft_flops(mode, b * (1 + n_sym)))


def work_stream_demod(mode: ModemMode, b: int, n_sym: int) -> tuple[float, float]:
    """(bytes, flops) of the streaming demod: the region, channel and bits once;
    scale and one FFT per symbol."""
    p = mode.profile
    return (4.0 * b * n_sym * p.symbol_len + 8 * b * p.num_active_subs + b * n_sym * bits_per_symbol(mode),
            1.0 * b * n_sym * p.symbol_len + _fft_flops(mode, b * n_sym))


def work_decode_tail(b: int, n_bits: int, n_active: int, row_bytes: int) -> tuple[float, float]:
    """(bytes, flops) of the one-shot decoder's tail: the head (12 bytes),
    bits and channel in, the ``row_bytes`` row out, once; |H| (two products,
    a sum and a root a bin) and one vote step a bit."""
    return 1.0 * b * (12 + n_bits + 8 * n_active + row_bytes), 1.0 * b * (4 * n_active + n_bits)


def work_stream_scan(b: int, w: int, n_pos: int) -> tuple[float, float]:
    """(bytes, flops) of the chunked receiver's scan: the window in and an
    8-byte row out, once; a square and a product with their sums a sample,
    three 16-block window sums and the metric (a product, a product, a
    square and a division) a position."""
    return 4.0 * b * w + 8.0 * b, 4.0 * b * w + b * n_pos * (3 * 15 + 4.0)


def work_stream_refine(profile: OfdmProfile) -> tuple[float, float]:
    """(bytes, flops) of the chunked receiver's refine at one region: the
    region (6 cp + sym samples) and preamble 1 in and an 8-byte row out,
    once; two FMAs (corr and energy) a tap of each of the 6 cp + 1 offsets."""
    n_off, sym = 6 * profile.cp_len + 1, profile.symbol_len
    return 4.0 * (n_off + sym - 1) + 4.0 * sym + 8.0, 4.0 * n_off * sym


def share(work: tuple[float, float], n_samples: int, msps: float, peaks: tuple[float, float] | None) -> dict:
    """A kernel's roofline at a measured rate: ``work`` (bytes, flops) of one
    call over ``n_samples`` samples, run at ``msps`` Msamples/s. Bytes and
    float32 operations a sample, the percent of the card's memory rate and
    float32 peak that rate uses, and which one binds; the percents and the
    binding resource are None without ``peaks``."""
    bps, fps = work[0] / n_samples, work[1] / n_samples
    out = {"at_msps": msps, "bytes_per_sample": bps, "fp32_flops_per_sample": fps,
           "pct_of_hbm": None, "pct_of_fp32": None, "bound_by": None}
    if peaks is not None:
        rate = msps * 1e6
        pct_hbm, pct_fp32 = 100 * bps * rate / peaks[0], 100 * fps * rate / peaks[1]
        out.update(pct_of_hbm=pct_hbm, pct_of_fp32=pct_fp32,
                   bound_by="bytes" if pct_hbm >= pct_fp32 else "operations")
    return out
