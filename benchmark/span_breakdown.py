"""One traced run of a decode cell, read by the program's spans:

    python3 benchmark/span_breakdown.py --workload <cell> --seed <n> --seconds <s>

Runs the cell's loop driver as ``run.py --trace 1`` does (the device trace
over the window's first seconds, the program's recorder following it), then
prints one JSON line: the card's idle time split among the innermost spans
open over it (``idle_by_span``, with the share of it inside a span), the
spans that carry the slowest 5 % of the traced decodes (``tail_by_span``),
the traced decodes' root spans against the host clock over the same
decodes, and the least dispatch time of a decode. The result line's
``breakdown`` does not carry these: that needs an edit of ``trace.py``
(PERF.md, section 7).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parent.parent)
if sys.path and sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness, spans, trace  # noqa: E402


DEVICE = "cuda"
OVERRIDES: dict = {}  # traffic parameters a test shrinks


class _Traced(trace.DeviceTrace):
    """The device trace, keeping what puts the program's spans on its clock:
    a clock pair at the start and the profile's ``trace_start_ns()`` (on the
    CPU, which traces no device, the pair's own time)."""

    made: list = []

    def start(self) -> None:
        from audio_modem_tpu_torch.utils import trace as program_trace

        super().start()
        self.pair = program_trace.clock_pair()
        _Traced.made.append(self)

    def stop(self) -> None:
        prof = self._prof
        super().stop()
        self.base_ns = prof.profiler.kineto_results.trace_start_ns() if prof is not None else self.pair[1]


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = harness.parse_args([*(argv if argv is not None else sys.argv[1:]), "--trace", "1"])
    harness.use_checkout_caches()
    harness.require_program()
    import torch

    if DEVICE == "cuda":
        harness.require_cards(1)

    from audio_modem_tpu_torch.utils import trace as program_trace

    if not hasattr(program_trace, "follow_profiler"):
        print("span_breakdown: the program has no span recorder", file=sys.stderr)
        return 2
    wl, cfg = harness.load_cell(args.workload)
    ctx = harness.Context(wl, cfg, args.seed, args.seconds, True, DEVICE, t_start, dict(OVERRIDES))
    driver = harness.load_driver(wl["driver"])
    host_ms = []
    api = driver.api
    real = api.decode

    def timed(*a, **kw):  # the host clock over the decodes the profiler sees
        if not torch.autograd._profiler_enabled():
            return real(*a, **kw)
        t = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            host_ms.append((time.perf_counter() - t) * 1e3)

    original = trace.DeviceTrace
    trace.DeviceTrace, api.decode = _Traced, timed
    try:
        out = driver.run(ctx)
    finally:
        trace.DeviceTrace, api.decode = original, real
    tr = _Traced.made[-1]
    found, counters = program_trace.drain()
    found = spans.in_us(program_trace.on_profile_clock(found, tr.pair, tr.base_ns))
    roots = spans.decodes(found)
    idle = spans.idle_by_span(tr.events, found)
    total = sum(idle.values())
    line = {
        "correct": all(v <= lim for v, lim in out.checks.values()),
        "decodes": len(roots), "host_decodes": len(host_ms),
        "root_mean_ms": sum(d.end_us - d.start_us for d in roots) / len(roots) * 1e-3,
        "host_mean_ms": sum(host_ms) / len(host_ms),
        "idle_s": total, "idle_inside_spans_pct": 100 * (1 - idle.get(spans.OUTSIDE, 0.0) / total) if total else None,
        "idle_by_span": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1]),
        "tail_by_span": spans.tail_by_span(found)[:6],
        "least_dispatch_ms": min(spans.self_ms(found, spans.DISPATCH_LESS)),
        "counters": counters, "device": torch.cuda.get_device_name(0),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
