"""The least work of the streaming demod (kernel B', ``stream_demod``) as
(bytes, float32 operations), for ``stream_demod_roofline.chunked``.

A frozen copy of the port's ``roofline.work_stream_demod``, so that the
yardstick stays put when the program changes: the region, the channel and
the bits once; the scale and one real-input FFT (2.5 N log2 N flops) a
symbol. The peaks are ``roofline.PEAKS``.
"""

from __future__ import annotations

import math

from benchmark.reference.profiles import Mode


def work_stream_demod(mode: Mode, b: int, n_sym: int) -> tuple[float, float]:
    """(bytes, flops) of one call over ``b`` rows of ``n_sym`` symbols."""
    p = mode.profile
    n = p.fft_size
    return (4.0 * b * n_sym * p.symbol_len + 8 * b * p.num_active + b * n_sym * mode.bits_per_symbol,
            1.0 * b * n_sym * p.symbol_len + 2.5 * n * math.log2(n) * b * n_sym)
