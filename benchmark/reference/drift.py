"""The benchmark's sample-clock offset: a recording made by a receiver whose
clock runs ``ppm`` parts per million away from the sender's, in float64.

A clock offset is a pure time shift that grows along the recording: output
sample ``n`` is the bandlimited input waveform at ``n * (1 + ppm * 1e-6)``.
The waveform between samples is read through a windowed-sinc interpolator,
the Kaiser window of beta 8 over 65 taps (Kaiser and Schafer, "On the use
of the I0-sinh window for spectrum analysis", 1980), whose taps are
normalized to sum to 1 so that a constant passes unchanged. The output has
the input's length; positions past either end read the end sample.

Departures from an ideal resampler, each on purpose: the taps, the window
and the normalization are those the repository's channel model names
(65 taps, Kaiser beta 8, unit sum), so a recording made here is the one its
clock-offset tests describe. Positions are computed in float64, where the
model computes them in float32; so this resampler stays exact to the end of
a 7.9 M-sample recording, where a float32 position moves in half samples.

Plain ``torch``; imports nothing of the program under test.
"""

from __future__ import annotations

import torch

F64 = torch.float64
TAPS = 65
BETA = 8.0
BLOCK = 65536


def clock_drift(x: torch.Tensor, ppm: float, taps: int = TAPS, beta: float = BETA,
                block: int = BLOCK) -> torch.Tensor:
    """Rows ``x`` [..., T] resampled by (1 + ``ppm`` * 1e-6): float64
    [..., T] on ``x``'s device, ``block`` output samples at a time. A zero
    offset returns the rows unchanged, in float64."""
    x = x.to(F64)
    if ppm == 0.0:
        return x.clone()
    t = x.shape[-1]
    half = taps // 2
    dev = x.device
    offs = torch.arange(-half, half + 1, device=dev)
    i0_beta = torch.special.i0(torch.tensor(beta, dtype=F64, device=dev))
    out = torch.empty_like(x)
    for b0 in range(0, t, block):
        n = torch.arange(b0, min(b0 + block, t), dtype=F64, device=dev)
        pos = n * (1.0 + ppm * 1e-6)
        base = torch.floor(pos)
        u = offs.to(F64)[None, :] - (pos - base)[:, None]  # tap distance from the position, in samples
        r = u / (half + 1)
        win = torch.special.i0(beta * torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))) / i0_beta
        k = torch.sinc(u) * win
        k = k / k.sum(-1, keepdim=True)
        idx = (base.to(torch.int64)[:, None] + offs[None, :]).clamp(0, t - 1)
        out[..., b0 : b0 + n.shape[0]] = (x[..., idx] * k).sum(-1)
    return out
