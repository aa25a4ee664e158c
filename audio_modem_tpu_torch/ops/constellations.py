"""Constellation tables and map / hard demap in closed form
(modem.js:101-150; counterpart of audio_modem_tpu/ops/constellations.py).

Gray-coded BPSK, QPSK and square 16/64-QAM at unit average power. The point
tables (``CONSTELLATIONS``) are host data, built as the reference builds
them; map and demap are elementwise and read only their bits per point and
level spacing: no gathers. Rounding is half to even (``torch.round``), as
``jnp.round`` and CUDA ``rintf`` do.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from audio_modem_tpu_torch.configs import ModemMode


@dataclasses.dataclass(frozen=True)
class Constellation:
    name: str
    bps: int
    # points as [n, 2] float64 (re, im), index = MSB-first packed bits
    points: tuple[tuple[float, float], ...]

    @property
    def n_points(self) -> int:
        return 1 << self.bps

    def points_np(self) -> np.ndarray:
        return np.asarray(self.points, dtype=np.float64)


def _square_qam_points(bits_per_axis: int) -> tuple[tuple[float, float], ...]:
    """Gray-coded square QAM at unit average power: index -> (row, col), Gray
    map each axis, levels 2g - (2^b - 1), scaled by 1/sqrt(average power)
    (modem.js:117-129 for 16-QAM; 64-QAM by the same construction)."""
    m = 1 << bits_per_axis
    top = m - 1
    levels = [2 * g - top for g in range(m)]
    avg = 2 * sum(l * l for l in levels) / m
    s = 1.0 / math.sqrt(avg)
    pts = []
    for i in range(m * m):
        row, col = i >> bits_per_axis, i & top
        gr, gc = row ^ (row >> 1), col ^ (col >> 1)
        pts.append(((2 * gc - top) * s, (2 * gr - top) * s))
    return tuple(pts)


_SQ = 1.0 / math.sqrt(2.0)

CONSTELLATIONS: dict[str, Constellation] = {
    "BPSK": Constellation("BPSK", 1, ((1.0, 0.0), (-1.0, 0.0))),
    "QPSK": Constellation("QPSK", 2, ((_SQ, _SQ), (-_SQ, _SQ), (-_SQ, -_SQ), (_SQ, -_SQ))),
    "QAM16": Constellation("QAM16", 4, _square_qam_points(2)),
    "QAM64": Constellation("QAM64", 6, _square_qam_points(3)),  # the extension mode
}


def bits_per_symbol(mode: ModemMode) -> int:
    """Payload bits per OFDM symbol (data bins x bits per point)."""
    return mode.profile.num_data_subs * CONSTELLATIONS[mode.constellation].bps


def qam_scale(name: str) -> float:
    """Half the level spacing of a square QAM, in float64: the largest level
    of its point table over the top level index, as the reference slices."""
    c = CONSTELLATIONS[name]
    top = (1 << (c.bps // 2)) - 1
    return float(c.points_np()[:, 0].max() / top)


def map_bits(name: str, bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MSB-first bits [..., n*bps] -> (re, im), each [..., n] float32."""
    bps = CONSTELLATIONS[name].bps
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
    bps = CONSTELLATIONS[name].bps
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
