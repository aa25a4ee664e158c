"""Decode metrics / observability (SURVEY §5 'metrics' gap-fill).

The reference surfaces progress/ETA/error counters in the DOM
(app.js:1000-1023, 1164-1185); here a Metrics dataclass travels with every
decode and a StatsCounter aggregates across a streaming session.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class DecodeMetrics:
    """Per-decode quality numbers (diag + bench surface)."""

    preamble_metric: float = 0.0
    fine_metric: float = 0.0
    snr_db: float = 0.0
    ber: float | None = None
    evm: float | None = None
    samples_processed: int = 0
    wall_seconds: float = 0.0

    @property
    def msamples_per_sec(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.samples_processed / self.wall_seconds / 1e6

    @property
    def realtime_factor(self) -> float:
        """How many 44.1 kHz streams this throughput sustains."""
        return self.msamples_per_sec * 1e6 / 44100.0


@dataclasses.dataclass
class StreamStats:
    """Streaming session counters (app.js:736-739, 1000-1023 analog)."""

    frames_decoded: int = 0
    frame_errors: int = 0
    crc_errors: int = 0
    chunks_received: int = 0
    total_chunks: int = 0
    started_at: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.started_at

    @property
    def eta_seconds(self) -> float | None:
        if self.chunks_received == 0 or self.total_chunks == 0:
            return None
        rate = self.chunks_received / max(self.elapsed, 1e-9)
        return (self.total_chunks - self.chunks_received) / rate
