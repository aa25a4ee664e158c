"""Tracing / profiling helpers (counterpart of audio_modem_tpu/utils/trace.py).

* ``device_trace(logdir)`` — context manager around ``torch.profiler``
  that writes a TensorBoard / Chrome trace of host and device execution.
* ``StageTimer`` — lightweight wall-clock stage accounting for host-side
  pipelines (detect/refine/demod breakdowns, Msamples/s counters).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a profile into ``logdir`` (view with tensorboard or
    chrome://tracing): host activity always, device activity when a CUDA
    device is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StageTimer:
    """Accumulates wall time + item counts per named stage.

    with timer.stage("demod", samples=n):
        ...
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = defaultdict(float)
        self.cpu_seconds: dict[str, float] = defaultdict(float)
        self.items: dict[str, int] = defaultdict(int)
        self.calls: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, samples: int = 0):
        t0 = time.perf_counter()
        c0 = time.process_time()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            # wall >> cpu for a stage means it BLOCKS (IO / GIL wait / device
            # sync), not computes
            self.cpu_seconds[name] += time.process_time() - c0
            self.items[name] += samples
            self.calls[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, sec in self.seconds.items():
            n = self.items[name]
            out[name] = {
                "seconds": round(sec, 6),
                "cpu_seconds": round(self.cpu_seconds[name], 6),
                "calls": self.calls[name],
                "samples": n,
                "msamples_per_sec": round(n / sec / 1e6, 3) if sec > 0 and n else 0.0,
            }
        return out
