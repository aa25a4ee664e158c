"""The modem's wire constants, frozen for the benchmark's reference and
transmitter: OFDM profiles (modem.js:69-85), modes (app.js:60-66, chunk
sizes app.js:195-199), silences (modem.js:533-535, 728-733), the JS seeded
LCG (modem.js:153-156), CRC-32 (modem.js:443-457) and the constellations
(modem.js:101-150).

A copy, not an import: the benchmark's yardstick must not move when the
program under test changes, so nothing here comes from either package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FFT_SIZE = 512
SAMPLE_RATE = 44100
CHUNK_THRESHOLD = 32 * 1024
FRAME_META = 0xFE
FRAME_DATA = 0xFF


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    cp_len: int
    sub_start: int
    sub_end: int
    pilots: tuple[int, ...]
    fft_size: int = FFT_SIZE

    @property
    def symbol_len(self) -> int:
        return self.fft_size + self.cp_len

    @property
    def num_active(self) -> int:
        return self.sub_end - self.sub_start + 1

    @property
    def num_data(self) -> int:
        return self.num_active - len(self.pilots)

    @property
    def is_acoustic(self) -> bool:
        return self.cp_len >= 128

    def silence_pre_legacy(self) -> int:
        return int(SAMPLE_RATE * (0.5 if self.is_acoustic else 0.3))

    def silence_post_legacy(self) -> int:
        return int(SAMPLE_RATE * (0.5 if self.is_acoustic else 0.2))

    def silence_pre_chunk(self, first: bool) -> int:
        if first:
            return round(SAMPLE_RATE * (0.5 if self.is_acoustic else 0.3))
        return round(SAMPLE_RATE * 0.05)

    def silence_post_chunk(self) -> int:
        return round(SAMPLE_RATE * 0.02)


PROFILES = {
    "standard": Profile("standard", 64, 12, 232,
                        (15, 29, 43, 57, 71, 85, 99, 113, 127, 141, 155, 169, 183, 197, 211, 225)),
    "acoustic": Profile("acoustic", 128, 23, 93, (25, 35, 45, 55, 65, 75, 85)),
    "narrowband": Profile("narrowband", 256, 35, 58, (37, 45, 53)),
}


@dataclasses.dataclass(frozen=True)
class Mode:
    name: str
    profile_name: str
    constellation: str
    repetition: int
    chunk_size: int

    @property
    def profile(self) -> Profile:
        return PROFILES[self.profile_name]

    @property
    def bps(self) -> int:
        return {"BPSK": 1, "QPSK": 2, "QAM16": 4}[self.constellation]

    @property
    def bits_per_symbol(self) -> int:
        return self.profile.num_data * self.bps


MODES = {
    "QPSK": Mode("QPSK", "standard", "QPSK", 1, 2048),
    "16-QAM": Mode("16-QAM", "standard", "QAM16", 1, 4096),
    "BPSK-ACOUSTIC": Mode("BPSK-ACOUSTIC", "acoustic", "BPSK", 1, 512),
    "BPSK-REPEAT": Mode("BPSK-REPEAT", "acoustic", "BPSK", 3, 512),
    "BPSK-NARROW": Mode("BPSK-NARROW", "narrowband", "BPSK", 3, 512),
}


def js_lcg_signs(seed: int, n: int) -> np.ndarray:
    """+1 where the JS RNG's draw exceeds 0.5, else -1 (modem.js:153-156,
    162): the state update runs in float64 as JS numbers do, then ToInt32
    and the 31-bit mask."""
    out = np.empty(n, dtype=np.float64)
    s = float(seed)
    for i in range(n):
        s = float(int(s * 1103515245.0 + 12345.0) % (1 << 32) & 0x7FFFFFFF)
        out[i] = 1.0 if s / 0x7FFFFFFF > 0.5 else -1.0
    return out


def _crc_table() -> np.ndarray:
    t = np.empty(256, dtype=np.int64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0xEDB88320 ^ (c >> 1)) if c & 1 else c >> 1
        t[i] = c
    return t


CRC_TABLE = _crc_table()


def crc32(data: bytes) -> int:
    """CRC-32 (IEEE, reflected, init and xorout 0xFFFFFFFF), byte by byte."""
    c = 0xFFFFFFFF
    for b in data:
        c = int(CRC_TABLE[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32_rows(rows: torch.Tensor) -> torch.Tensor:
    """CRC-32 of every row of a uint8 [R, L] tensor -> int64 [R], the same
    table walk as ``crc32`` run over all rows at once on their device."""
    table = torch.as_tensor(CRC_TABLE, device=rows.device)
    c = torch.full((rows.shape[0],), 0xFFFFFFFF, dtype=torch.int64, device=rows.device)
    cols = rows.to(torch.int64)
    for j in range(rows.shape[1]):
        c = table[(c ^ cols[:, j]) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _square_qam(bits_per_axis: int) -> np.ndarray:
    m = 1 << bits_per_axis
    top = m - 1
    s = 1.0 / math.sqrt(2 * sum((2 * g - top) ** 2 for g in range(m)) / m)
    pts = []
    for i in range(m * m):
        row, col = i >> bits_per_axis, i & top
        gr, gc = row ^ (row >> 1), col ^ (col >> 1)
        pts.append(((2 * gc - top) * s, (2 * gr - top) * s))
    return np.asarray(pts, dtype=np.float64)


_SQ = 1.0 / math.sqrt(2.0)
# [n_points, 2] (re, im), index = the symbol's bits MSB first
CONSTELLATIONS = {
    "BPSK": np.asarray([(1.0, 0.0), (-1.0, 0.0)]),
    "QPSK": np.asarray([(_SQ, _SQ), (-_SQ, _SQ), (-_SQ, -_SQ), (_SQ, -_SQ)]),
    "QAM16": _square_qam(2),
}
