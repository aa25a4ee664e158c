"""The card's roofline for the benchmark: published peaks keyed by card name,
and the least work of kernels A and C as (bytes, float32 operations).

A frozen copy of the port's ``roofline.work_decode_fused`` and
``work_decode_predicted``, so that the yardstick stays put when the
program changes. One change: C's refine and DFT work counts the slots it
predicts (``n_pred``), which is one fewer than the round's slots when
kernel A decoded slot 0; its packed rows still count all ``k``.

Bytes count each input read once and each output written once; each DFT
counts as a real-input FFT (2.5 N log2 N flops).
"""

from __future__ import annotations

import math

from benchmark.reference.profiles import Mode

# Published peaks at 700 W (NVIDIA's data sheet, H100 SXM): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores. A card absent here has no peaks,
# and the roofline metrics then read nothing.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


def least_seconds(work: tuple[float, float], peaks: tuple[float, float]) -> float:
    """The larger of bytes over the memory rate and flops over the float32 peak."""
    return max(work[0] / peaks[0], work[1] / peaks[1])


def _fft_flops(mode: Mode, n_ffts: int) -> float:
    n = mode.profile.fft_size
    return 2.5 * n * math.log2(n) * n_ffts


def _tables(mode: Mode) -> int:
    p = mode.profile
    return 4 * p.fft_size * 2 * (p.num_active + p.num_data + len(p.pilots)) + 4 * p.symbol_len


def work_decode_fused(mode: Mode, b: int, t: int, max_syms: int) -> tuple[float, float]:
    """Kernel A over [b, t] windows: window, tables and outputs once; mean,
    normalize, block sums, window sums and metric, the +-3 CP refine, one
    FFT for the CE and one a symbol."""
    p = mode.profile
    n_off = 6 * p.cp_len + 1
    out = b * (17 + max_syms * mode.bits_per_symbol + 8 * p.num_active)
    n_bytes = 4.0 * b * t + 8 * b + _tables(mode) + out
    flops = (7.0 * b * t + 50.0 * b * (t // 16) + 4.0 * b * n_off * p.symbol_len
             + _fft_flops(mode, b * (1 + max_syms)))
    return n_bytes, flops


def work_decode_predicted(mode: Mode, b: int, w: int, n_sym_frame: int, k: int, n_pred: int) -> tuple[float, float]:
    """Kernel C over [b, w] windows, ``n_pred`` predicted slots of a
    ``k``-slot round: window, tables and outputs once; mean, max and
    normalize, the +-3 CP refine and one FFT for the CE and one a symbol of
    every predicted slot."""
    p = mode.profile
    n_off = 6 * p.cp_len + 1
    n_bytes = n_sym_frame * mode.bits_per_symbol // mode.repetition // 8
    out = b * k * (5 + n_bytes) + b * n_pred * 9
    moved = 4.0 * b * w + 9 * b + _tables(mode) + out
    flops = (4.0 * b * w + 4.0 * b * n_pred * n_off * p.symbol_len
             + _fft_flops(mode, b * n_pred * (1 + n_sym_frame)))
    return moved, flops
