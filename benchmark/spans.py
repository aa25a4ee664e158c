"""The program's spans and counters, for the per-layer metrics that read them.

The port's span recorder (``audio_modem_tpu_torch.utils.trace``) records a
decode's spans and counters while torch.profiler records, so a ``--trace 1``
run leaves in it the decodes of the slice the device trace profiles, beside
the ``setup.*`` spans of its set-up. The first reader of a run drains them
into its readings (``of``); a program without the recorder leaves them
empty, and the readers then return None.

``idle_by_span`` (the card's idle gaps split among the spans open over
them) and ``tail_by_span`` (the spans that carry the slow decodes) read the
same spans on the device events' clock (the program's ``on_profile_clock``,
then ``in_us``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

from benchmark import trace

OUTSIDE = "outside the program"
# what a decode's own host time leaves out: the waits on the card, the
# upload and the parse (dispatch_ms_per_decode.decode)
DISPATCH_LESS = ("decode.sync", "decode.upload", "decode.parse")


class ProgramSpan(NamedTuple):
    """A span of the program's recorder, in microseconds: on the device
    events' clock where the program put it there, else on
    ``perf_counter``."""

    name: str
    start_us: float
    end_us: float
    id: int = 0
    parent: int = 0
    decode: int = 0
    attrs: dict = {}


def _recorder():
    """The program's span recorder, or None where the program has none."""
    from audio_modem_tpu_torch.utils import trace as program_trace

    return program_trace if hasattr(program_trace, "drain") else None


def in_us(spans) -> list[ProgramSpan]:
    """The recorder's spans (``start_ns``/``end_ns``) in microseconds."""
    return [ProgramSpan(s.name, s.start_ns / 1e3, s.end_ns / 1e3, s.id, s.parent, s.decode, dict(s.attrs))
            for s in spans]


def of(r) -> tuple[list[ProgramSpan], dict]:
    """(spans, counters) of the run whose readings are ``r``: drained from
    the program's recorder at the first call and kept on ``r`` as
    ``program``."""
    got = getattr(r, "program", None)
    if got is None:
        rec = _recorder()
        spans, counters = rec.drain() if rec is not None else ([], {})
        got = r.program = (in_us(spans), counters)
    return got


def decodes(spans) -> list:
    """The root ``decode`` spans: one a decode the program made."""
    return [sp for sp in spans if sp.name == "decode" and not sp.parent]


def span_ms_per_decode(spans, name: str) -> float | None:
    """Milliseconds in spans named ``name`` inside decodes, over the decodes."""
    n = len(decodes(spans))
    if not n:
        return None
    return sum(sp.end_us - sp.start_us for sp in spans if sp.name == name and sp.decode) / n * 1e-3


def self_ms(spans, less: tuple[str, ...]) -> list[float]:
    """Each decode's own host time, ms: its root span less the spans named in
    ``less`` inside it (the outermost of them, where one holds another)."""
    by_id = {sp.id: sp for sp in spans}
    taken: dict[int, float] = defaultdict(float)
    for sp in spans:
        if sp.name in less and sp.decode:
            up = by_id.get(sp.parent)
            while up is not None and up.name not in less:
                up = by_id.get(up.parent)
            if up is None:
                taken[sp.decode] += sp.end_us - sp.start_us
    return [(d.end_us - d.start_us - taken[d.id]) * 1e-3 for d in decodes(spans)]


def _innermost(spans) -> list[tuple[float, float, str]]:
    """The spans flattened into (start_us, end_us, name) pieces in time
    order, each named by the innermost span open over it: of the spans open
    there, the one that started last (at one start, the shorter)."""
    cuts = []
    for i, sp in enumerate(spans):
        if sp.end_us > sp.start_us:
            cuts += [(sp.start_us, 1, i), (sp.end_us, 0, i)]
    cuts.sort()
    pieces, live, prev = [], set(), None
    for t, opens, i in cuts:
        if live and t > prev:
            inner = spans[max(live, key=lambda j: (spans[j].start_us, -spans[j].end_us))]
            pieces.append((prev, t, inner.name))
        if opens:
            live.add(i)
        else:
            live.discard(i)
        prev = t
    return pieces


def idle_by_span(events, spans) -> dict[str, float]:
    """The card's idle time (the gaps between its merged busy intervals,
    those ``trace.breakdown``'s ``idle_gaps`` sums), split among the
    innermost program spans open over it, in seconds by span name;
    ``OUTSIDE`` holds the part no span covers. Events and spans on one
    clock."""
    busy = trace._merged(events)
    pieces = _innermost(spans)
    out: dict[str, float] = defaultdict(float)
    j = 0
    for (_, s, _, _), (e, _, _, _) in zip(busy, busy[1:]):
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        covered = 0.0
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            part = min(e, pieces[k][1]) - max(s, pieces[k][0])
            out[pieces[k][2]] += part * 1e-6
            covered += part
            k += 1
        if e - s > covered:
            out[OUTSIDE] += (e - s - covered) * 1e-6
    return dict(out)


def tail_by_span(spans, q: float = 95.0) -> list[tuple[str, float]]:
    """Where the slow decodes spend their extra time: for each span name, its
    mean self time (its span less its children) in the slowest ``100 - q``
    per cent of the decodes (one at least) less its median self time in a
    decode, ms, largest first."""
    import numpy as np

    roots = decodes(spans)
    if len(roots) < 2:
        return []
    own: dict[int, dict[str, float]] = {d.id: defaultdict(float) for d in roots}
    kids: dict[int, float] = defaultdict(float)
    for sp in spans:
        kids[sp.parent] += sp.end_us - sp.start_us
    for sp in spans:
        if sp.decode in own:
            own[sp.decode][sp.name] += (sp.end_us - sp.start_us - kids[sp.id]) * 1e-3
    by_length = sorted(roots, key=lambda d: d.end_us - d.start_us)
    slow = [d.id for d in by_length[-max(1, round(len(roots) * (100 - q) / 100)):]]
    names = {name for d in own.values() for name in d}
    gap = {name: float(np.mean([own[i][name] for i in slow]) - np.median([d[name] for d in own.values()]))
           for name in names}
    return sorted(gap.items(), key=lambda kv: -kv[1])
