"""Blocking reads of a device value back to the host in a decode: the
program's ``host_syncs`` counter over the traced slice's decodes (the root
``decode`` spans); nothing where the recorder dropped spans past its
cap, which leaves decodes out of the roots but not of the counter."""

from benchmark import spans


def read(r):
    found, counters = spans.of(r)
    n = len(spans.decodes(found))
    if not n or "host_syncs" not in counters or counters.get("spans_dropped"):
        return None
    return counters["host_syncs"] / n
