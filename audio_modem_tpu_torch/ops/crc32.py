"""CRC-32 (IEEE 802.3, reflected, poly 0xEDB88320) matching modem.js:443-457.

The reference uses the standard zlib CRC-32 (init/xorout 0xFFFFFFFF), so the
host path delegates to the C implementation in :mod:`zlib` — byte streams are
host-side protocol work, not TPU work.  A vectorized numpy fallback is kept
for clarity/verification.
"""

from __future__ import annotations

import zlib

import numpy as np

_TABLE: np.ndarray | None = None


def _table() -> np.ndarray:
    global _TABLE
    if _TABLE is None:
        t = np.empty(256, dtype=np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = np.uint32(0xEDB88320) ^ (c >> np.uint32(1)) if c & np.uint32(1) else c >> np.uint32(1)
            t[i] = c
        _TABLE = t
    return _TABLE


def crc32(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """CRC-32 of ``data`` as an unsigned 32-bit int (modem.js:453-457)."""
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def crc32_table_driven(data: bytes) -> int:
    """Reference-style table CRC, for cross-validation in tests."""
    t = _table()
    c = np.uint32(0xFFFFFFFF)
    for b in data:
        c = t[(int(c) ^ b) & 0xFF] ^ (c >> np.uint32(8))
    return int(c ^ np.uint32(0xFFFFFFFF))
