"""Device time of a decode: the union of every kernel and copy interval in
the traced window over the decodes, ms."""

from benchmark import trace


def read(r):
    if not r.events or not r.counts.get("decodes"):
        return None
    return trace.busy_seconds(r.events) / r.counts["decodes"] * 1e3
