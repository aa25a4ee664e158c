"""The timing tracker's share of its roofline: the least time of every
tracker call in the traced decodes (its symbol count, at the card's
published peaks, ``reference/roofline_track.py``) over the card's busy
time inside the program's ``decode.track`` spans (the union of the device
intervals, on the device trace's clock)."""

from benchmark import spans, trace
from benchmark.reference import roofline, roofline_track


def busy_inside(events, windows) -> float:
    """Seconds in which a device event ran inside one of ``windows``
    ((start_us, end_us), on the events' clock)."""
    total = 0.0
    for s, e, _, _ in trace._merged(events):
        for a, b in windows:
            total += max(0.0, min(e, b) - max(s, a))
    return total * 1e-6


def read(r):
    calls = r.shapes.get("tracked_core")
    shift = r.counts.get("clock_shift_ns")
    if not calls or not r.events or r.peaks is None or shift is None:
        return None
    windows = [(sp.start_us + shift * 1e-3, sp.end_us + shift * 1e-3)
               for sp in spans.of(r)[0] if sp.name == "decode.track"]
    device_s = busy_inside(r.events, windows)
    if device_s <= 0:
        return None
    least = sum(roofline.least_seconds(roofline_track.work_tracked(r.mode, c["n_sym"]), r.peaks) for c in calls)
    return 100.0 * least / device_s
