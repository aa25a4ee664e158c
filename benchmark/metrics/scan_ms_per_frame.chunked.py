"""Host time the chunked receiver spends scanning for preambles, per frame
it cut: the program's ``rx.scan`` spans (the windows' cut, upload, scan
launches and the index's read) over its ``frames`` counter, ms."""

from benchmark import spans


def read(r):
    found, counters = spans.of(r)
    ms = [sp.end_us - sp.start_us for sp in found if sp.name == "rx.scan"]
    if not ms or not counters.get("frames"):
        return None
    return sum(ms) * 1e-3 / counters["frames"]
