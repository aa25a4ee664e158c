"""Blocking reads of a device value back to the host per frame the chunked
receiver cut: the program's ``host_syncs`` counter (one a call of
``decoder._read``: each scan window's index, each refine's pair, each
frame's bits) over its ``frames`` counter; nothing where the recorder
dropped spans past its cap."""

from benchmark import spans


def read(r):
    counters = spans.of(r)[1]
    if not counters.get("frames") or "host_syncs" not in counters or counters.get("spans_dropped"):
        return None
    return counters["host_syncs"] / counters["frames"]
