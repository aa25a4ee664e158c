"""The least work of the timing-tracked demod (``reference.tracked``, the
one-shot decoder's ``decode.track``) as (bytes, float32 operations), for
``track_roofline.drift``: counted from the work, whatever implements it.

Each of the three passes reads each data symbol's FFT window once (4 B a
sample) and transforms it; the channel is read once and the bits of the
last pass are written once, a bit each. A transform counts as a
real-input FFT (2.5 N log2 N flops), as ``roofline.py`` counts every
kernel's: a direct transform at the data and pilot bins (8 flops a sample
and bin for the complex product and sum) would count a loop built on an
FFT above its least time. Each active bin of a symbol adds its derotation
and equalization (two complex products, 6 flops each), each data bin its
phase rotation and decision (4 and 1), each pilot step its product (6):
the profile's bins from ``profiles.py``. The peaks are ``roofline.PEAKS``.
"""

from __future__ import annotations

import math

from benchmark.reference.profiles import Mode

PASSES = 3


def work_tracked(mode: Mode, n_sym: int) -> tuple[float, float]:
    """(bytes, flops) of one tracked demod of ``n_sym`` data symbols."""
    p = mode.profile
    n = p.fft_size
    per_symbol = (2.5 * n * math.log2(n) + 12.0 * p.num_active + 5.0 * p.num_data
                  + 6.0 * (len(p.pilots) - 1))
    moved = PASSES * 4.0 * n_sym * n + 8.0 * p.num_active + n_sym * mode.bits_per_symbol / 8
    return moved, PASSES * n_sym * per_symbol
