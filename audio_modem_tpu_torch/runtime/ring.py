"""Ring buffer with global-sample-offset addressing (app.js:563-595; a copy
of audio_modem_tpu/runtime/ring.py).

Positions are monotonically increasing global sample coordinates; reads of
overwritten regions return None. Vectorized numpy instead of the reference's
per-sample loops.
"""

from __future__ import annotations

import numpy as np


class RingBuffer:
    def __init__(self, capacity: int):
        self.buffer = np.zeros(capacity, dtype=np.float32)
        self.capacity = capacity
        self.total_written = 0

    def write(self, samples: np.ndarray) -> None:
        orig_len = len(samples)
        if orig_len >= self.capacity:
            # only the tail survives, but global coordinates advance fully
            samples = samples[-self.capacity :]
            start = (self.total_written + orig_len - self.capacity) % self.capacity
            first = self.capacity - start
            self.buffer[start:] = samples[:first]
            self.buffer[:start] = samples[first:]
            self.total_written += orig_len
            return
        n = orig_len
        pos = self.total_written % self.capacity
        first = min(n, self.capacity - pos)
        self.buffer[pos : pos + first] = samples[:first]
        if n > first:
            self.buffer[: n - first] = samples[first:]
        self.total_written += n

    def get_range(self, global_start: int, length: int) -> np.ndarray | None:
        """Samples [global_start, global_start+length) or None if overwritten
        or not yet written."""
        oldest = self.total_written - self.capacity
        if global_start < oldest or global_start + length > self.total_written:
            return None
        start = global_start % self.capacity
        first = min(length, self.capacity - start)
        out = np.empty(length, dtype=np.float32)
        out[:first] = self.buffer[start : start + first]
        if length > first:
            out[first:] = self.buffer[: length - first]
        return out

    def available_from(self, global_start: int) -> int:
        return self.total_written - global_start
