"""Reading the device trace: torch.profiler's device events over the traced
window, the time in which any of them ran, a kernel's device time by the
launch order of its pipeline, and the breakdown the result line carries.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

_KERNEL = re.compile(r"(\w+_kernel)\b")


def short_name(name: str) -> str:
    """A kernel's own name without its template arguments; a copy's or any
    other event's first 60 characters."""
    m = _KERNEL.search(name)
    return m.group(1) if m else name[:60]


class DeviceTrace:
    """torch.profiler over the card alone (kernels, copies, sets), from
    ``start`` (or entering) to ``stop`` (or leaving), each end after a
    synchronize. Disabled, it does nothing and leaves ``events`` None; on
    the CPU (the tests' tiny runs) it traces nothing and finds no device
    event."""

    def __init__(self, enabled: bool, device: str = "cuda"):
        self.enabled = enabled
        self.on_card = device != "cpu"
        self.events: list | None = None
        self.window_s = 0.0
        self.active = False
        self._prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        if self.on_card:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        if not self.on_card:
            self.window_s = time.perf_counter() - self._t0
            self.events = []
            return
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        self.events = sorted(((ev.name, ev.time_range.start, ev.time_range.end)
                              for ev in self._prof.events() if ev.device_type == cuda), key=lambda e: e[1])
        self._prof = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _merged(events) -> list[tuple[float, float, str, str]]:
    """Busy spans (start_us, end_us, first event's name, last event's name)."""
    spans: list[list] = []
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        if spans and s <= spans[-1][1]:
            if e > spans[-1][1]:
                spans[-1][1], spans[-1][3] = e, name
        else:
            spans.append([s, e, name, name])
    return [tuple(sp) for sp in spans]


def busy_seconds(events) -> float:
    """Seconds in which any device event ran (the union of their intervals)."""
    return sum(e - s for s, e, _, _ in _merged(events)) * 1e-6


def kernel_seconds(events, own: tuple[str, ...], others: tuple[str, ...], shared: tuple[str, ...]) -> float:
    """Device seconds of one kernel pipeline: its own launches (``own``),
    and each launch of a stage it shares with another pipeline
    (``shared``) that runs before its own next launch, not before one of
    ``others``. Launches of one stream run in their launch order."""
    total, pending = 0.0, 0.0
    for name, s, e in events:
        k = short_name(name)
        if k in shared:
            pending += e - s
        elif k in own:
            total += pending + e - s
            pending = 0.0
        elif k in others:
            pending = 0.0
    return total * 1e-6


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the operations on either side of them."""
    ops: dict[str, float] = defaultdict(float)
    for name, s, e in events:
        ops[short_name(name)] += (e - s) * 1e-6
    gaps: dict[str, float] = defaultdict(float)
    spans = _merged(events)
    for a, b in zip(spans, spans[1:]):
        gaps[f"after {short_name(a[3])} before {short_name(b[2])}"] += (b[0] - a[1]) * 1e-6
    return {"device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]}
