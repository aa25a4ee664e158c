"""Host time the chunked receiver spends refining committed preambles, per
frame it cut: the program's ``rx.refine`` spans (the region's upload, the
xcorr refine and its read, false peaks included) over its ``frames``
counter, ms."""

from benchmark import spans


def read(r):
    found, counters = spans.of(r)
    ms = [sp.end_us - sp.start_us for sp in found if sp.name == "rx.refine"]
    if not ms or not counters.get("frames"):
        return None
    return sum(ms) * 1e-3 / counters["frames"]
