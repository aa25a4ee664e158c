"""Constellation map / hard demap in closed form (modem.js:101-150;
counterpart of audio_modem_tpu/ops/constellations.py).

Gray-coded BPSK, QPSK and square 16/64-QAM at unit average power. Both
directions are elementwise: no point tables, no gathers. Rounding is half to
even (``torch.round``), as ``jnp.round`` and CUDA ``rintf`` do.
"""

from __future__ import annotations

import math

import torch

from audio_modem_tpu_torch.configs import ModemMode

BPS = {"BPSK": 1, "QPSK": 2, "QAM16": 4, "QAM64": 6}

_SQ = 1.0 / math.sqrt(2.0)


def bits_per_symbol(mode: ModemMode) -> int:
    """Payload bits per OFDM symbol (data bins x bits per point)."""
    return mode.profile.num_data_subs * BPS[mode.constellation]


def qam_scale(name: str) -> float:
    """Half the level spacing of a square QAM, in float64, computed as the
    reference builds its point table: max level (top * s) over top."""
    bpa = BPS[name] // 2
    m = 1 << bpa
    top = m - 1
    levels = [2 * g - top for g in range(m)]
    s = 1.0 / math.sqrt(2 * sum(l * l for l in levels) / m)
    return (top * s) / top


def map_bits(name: str, bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MSB-first bits [..., n*bps] -> (re, im), each [..., n] float32."""
    bps = BPS[name]
    *lead, nb = bits.shape
    groups = bits.reshape(*lead, nb // bps, bps).to(torch.int32)
    if name == "BPSK":
        re = (1 - 2 * groups[..., 0]).to(torch.float32)
        return re, torch.zeros_like(re)
    if name == "QPSK":
        b0, b1 = groups[..., 0], groups[..., 1]
        sq = torch.tensor(_SQ, dtype=torch.float32)
        im = (1 - 2 * b0).to(torch.float32) * sq
        re = (1 - 2 * (b0 ^ b1)).to(torch.float32) * sq
        return re, im
    bpa = bps // 2
    m = 1 << bpa
    top = m - 1
    s = qam_scale(name)

    def to_int(sl: torch.Tensor) -> torch.Tensor:
        v = sl[..., 0]
        for j in range(1, bpa):
            v = (v << 1) | sl[..., j]
        return v

    def axis_value(v: torch.Tensor) -> torch.Tensor:
        g = v ^ (v >> 1)
        out = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for lvl in range(m):
            out = torch.where(g == lvl, torch.tensor((2 * lvl - top) * s, dtype=torch.float32), out)
        return out

    row = to_int(groups[..., :bpa])
    col = to_int(groups[..., bpa:])
    return axis_value(col), axis_value(row)


def _inverse_gray(g: torch.Tensor, nbits: int) -> torch.Tensor:
    b = g
    shift = 1
    while shift < nbits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def demap(name: str, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Nearest-point hard demap [..., n] -> MSB-first bits [..., n*bps] int8.

    BPSK: re < 0. QPSK: b0 = im < 0, b1 = b0 ^ (re < 0). Square QAM: each
    axis slices to its nearest level index (the Gray code), inverted to bits;
    row (im) bits are the high half of the point index."""
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    if name == "BPSK":
        return (re < 0).to(torch.int8)
    if name == "QPSK":
        b0 = (im < 0).to(torch.int8)
        b1 = b0 ^ (re < 0).to(torch.int8)
        bits = torch.stack([b0, b1], dim=-1)
        return bits.reshape(*bits.shape[:-2], bits.shape[-2] * 2)
    bps = BPS[name]
    bpa = bps // 2
    top = (1 << bpa) - 1
    scale = qam_scale(name)

    def axis_bits(x: torch.Tensor) -> torch.Tensor:
        g = torch.clamp(torch.round((x / scale + top) * 0.5), 0, top).to(torch.int32)
        return _inverse_gray(g, bpa)

    idx = (axis_bits(im) << bpa) | axis_bits(re)
    shifts = torch.arange(bps - 1, -1, -1, dtype=torch.int32, device=idx.device)
    bits = ((idx[..., None] >> shifts) & 1).to(torch.int8)
    return bits.reshape(*bits.shape[:-2], bits.shape[-2] * bps)
