"""Tracing / profiling helpers (counterpart of audio_modem_tpu/utils/trace.py).

* The span recorder: ``span(name, **attrs)`` times a region and ``count(name,
  n)`` adds to a counter, both kept in memory while the recorder is on
  (``enable``, ``disable``; ``drain`` hands them over). Off, the default,
  ``span`` returns one shared no-op and ``count`` returns at once: one test
  of a module flag, no clock read. ``follow_profiler`` turns it on over a
  block while torch.profiler records, so a profiled decode carries its
  spans. ``setup_span`` records once-a-process set-up whether the recorder
  is on or off. At most ``MAX_SPANS`` spans wait for a drain; the counter
  ``spans_dropped`` counts those past it.
* ``clock_pair`` and ``on_profile_clock`` put spans on torch.profiler's
  clock, so a span lines up with the host and device events around it.
* ``device_trace(logdir)`` — context manager around ``torch.profiler``
  that writes a Chrome trace of host and device execution, with the
  program's spans over its window.
* ``StageTimer`` — lightweight wall-clock stage accounting for host-side
  pipelines (detect/refine/demod breakdowns, Msamples/s counters); each
  stage is also a span while the recorder is on.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch

_on = False
_follows = 0  # blocks of follow_profiler open, on any thread
_follow_lock = threading.Lock()
MAX_SPANS = 1 << 18
# name, start_ns, end_ns, thread, attrs of each span as it closes, flat: the
# list holds no object the garbage collector tracks (the attributes are plain
# values), so a long window's records add nothing to its full collections
_closed: list = []
_counters: dict[str, int] = defaultdict(int)
_ids = itertools.count(1)
_clock = time.perf_counter_ns
_thread = threading.get_ident
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A drained span: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns()``, its own ``id``, its parent's (``parent``, 0
    at a root: the innermost span recorded around it on the same thread),
    ``decode`` (the id of the ``decode`` span it lies in, 0 outside one) and
    ``attrs``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    decode: int
    attrs: dict


class _Open:
    """A span being recorded; it keeps only its name, attributes and start,
    and becomes a record as it closes."""

    __slots__ = ("name", "attrs", "start")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Open":
        self.start = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if len(_closed) < 5 * MAX_SPANS:
            _closed.extend((self.name, self.start, _clock(), _thread(), self.attrs))
        else:
            _counters["spans_dropped"] += 1
        return False


class _NoSpan:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs) -> "_Open | _NoSpan":
    """A context manager that records ``name`` over its block while the
    recorder is on; the shared no-op while it is off."""
    if not _on:
        return _NO_SPAN
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if _on:
        _counters[name] += n


def setup_span(name: str, **attrs) -> _Open:
    """A span of once-a-process set-up (``setup.*``), recorded whether the
    recorder is on or off."""
    return _Open(name, attrs)


class _Following:
    """The recorder on over a block of ``follow_profiler``: on while any
    such block is open, on any thread, and off once the last one closes."""

    __slots__ = ()

    def __enter__(self) -> "_Following":
        global _on, _follows
        with _follow_lock:
            _follows += 1
            _on = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _on, _follows
        with _follow_lock:
            _follows -= 1
            if not _follows:
                _on = False
        return False


_FOLLOWING = _Following()


def follow_profiler() -> "_Following | _NoSpan":
    """A context manager that turns the recorder on over its block while
    torch.profiler records, so the spans line up with a profile of the same
    work; the shared no-op where no profiler records or ``enable`` turned
    the recorder on."""
    if not _profiling() or (_on and not _follows):
        return _NO_SPAN
    return _FOLLOWING


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> tuple[list[Span], dict[str, int]]:
    """The spans closed and the counters counted since the last drain; the
    recorder forgets them. Spans come in the order they started, each with
    its id, its parent and its decode, found from how the spans of one
    thread nest (a span still open is drained once it closes; its children
    drained before it are roots)."""
    flat = _closed[:]
    del _closed[: len(flat)]
    closed = [flat[i : i + 5] for i in range(0, len(flat) - len(flat) % 5, 5)]
    counters = dict(_counters)
    _counters.clear()
    spans: list[Span] = []
    stacks: dict[int, list[Span]] = {}
    for name, t0, t1, thread, attrs in sorted(closed, key=lambda c: (c[1], -c[2])):
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1].end_ns <= t0:
            stack.pop()
        up = stack[-1] if stack else None
        sid = next(_ids)
        decode = up.decode if up is not None else 0
        if name == "decode" and not decode:
            decode = sid
        sp = Span(name, t0, t1, sid, up.id if up is not None else 0, decode, attrs)
        stack.append(sp)
        spans.append(sp)
    return spans, counters


def clock_pair() -> tuple[int, int]:
    """(``time.perf_counter_ns()``, ``time.time_ns()``) read back to back: the
    spans' clock beside the epoch clock that torch.profiler's times count
    from."""
    return time.perf_counter_ns(), time.time_ns()


def on_profile_clock(spans: list[Span], pair: tuple[int, int], base_ns: int) -> list[Span]:
    """The spans with ``start_ns`` and ``end_ns`` in nanoseconds past the
    epoch time ``base_ns``: torch.profiler's event times count (in
    microseconds) from ``prof.profiler.kineto_results.trace_start_ns()``, a
    Chrome trace's from its ``baseTimeNanoseconds``. ``pair`` is a
    ``clock_pair()`` read in the same process."""
    shift = pair[1] - pair[0] - base_ns
    return [s._replace(start_ns=s.start_ns + shift, end_ns=s.end_ns + shift) for s in spans]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a profile into ``logdir`` as a Chrome trace (view with
    chrome://tracing, Perfetto or tensorboard): host activity always,
    device activity when a CUDA device is present, and the program's spans
    over the window, on the profile's clock, in a row of their own. The
    recorder is on over the window."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _on
    pair = clock_pair()

    def write(prof) -> None:
        spans, _ = drain()
        out = Path(logdir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{os.uname().nodename}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        pid = os.getpid()
        doc["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                                   "args": {"name": "program spans"}})
        for s in on_profile_clock(spans, pair, doc.get("baseTimeNanoseconds", 0)):
            doc["traceEvents"].append({
                "ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": 0, "ts": s.start_ns / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3, "args": {**s.attrs, "id": s.id, "parent": s.parent,
                                                               "decode": s.decode}})
        path.write_text(json.dumps(doc))

    with profile(activities=activities, on_trace_ready=write):
        enable()
        try:
            yield
        finally:
            if not was_on:
                disable()


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
            with span(name):
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
