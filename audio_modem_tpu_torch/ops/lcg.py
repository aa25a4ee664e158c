"""Bit-exact emulation of the reference's JavaScript seeded LCG.

The reference (modem.js:153-156) draws preamble/CE signs from

    s = (s * 1103515245 + 12345) & 0x7fffffff;  return s / 0x7fffffff;

evaluated under *JavaScript number semantics*: the product is computed in
IEEE-754 float64 (and is ROUNDED once s*1103515245 exceeds 2^53), then `&`
applies ToInt32 (truncate toward zero, wrap mod 2^32, two's complement) before
the mask.  The resulting sequence is therefore defined by float64 rounding,
not by exact integer LCG math.  Seeds 42/43/44 fix the Schmidl-Cox preamble
symbols and the channel-estimation symbol (modem.js:158-200), so every sync
correlation and channel estimate depends on reproducing this exactly.

Python floats are IEEE-754 doubles with identical correctly-rounded * and +,
so this emulation is bit-exact by construction. No transcendentals involved.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 1 << 32
_MAX31 = 0x7FFFFFFF


def js_lcg_states(seed: int, n: int) -> np.ndarray:
    """Return the first ``n`` post-update 31-bit states for ``seed``.

    Mirrors modem.js:153-156 under JS float64 semantics (see module doc).
    """
    out = np.empty(n, dtype=np.int64)
    s = float(seed)
    for i in range(n):
        x = s * 1103515245.0 + 12345.0  # float64, correctly rounded like JS
        # ECMA-262 ToInt32: truncate toward zero, wrap mod 2^32. The `& 0x7fffffff`
        # keeps only the low 31 bits, so the signed reinterpretation is irrelevant.
        s_int = int(x) % _MASK32 & _MAX31
        out[i] = s_int
        s = float(s_int)
    return out


def js_lcg_uniforms(seed: int, n: int) -> np.ndarray:
    """First ``n`` draws of the JS RNG: state / 0x7fffffff, as float64."""
    return js_lcg_states(seed, n).astype(np.float64) / float(_MAX31)


def js_lcg_signs(seed: int, n: int) -> np.ndarray:
    """BPSK signs as the reference derives them: +1 if draw > 0.5 else -1.

    Used with seed 42 (preamble 1), 43 (preamble 2), 44 (CE symbol);
    see modem.js:162,176,191.
    """
    # draw > 0.5  <=>  state >= 2^30 (exact: state/0x7fffffff rounds to >0.5
    # iff state >= 0x40000000; verified against the float64 division).
    u = js_lcg_uniforms(seed, n)
    return np.where(u > 0.5, 1.0, -1.0)
