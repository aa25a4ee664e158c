"""Share of the traced decodes' window in which no kernel, copy or set ran
on the card."""

from benchmark import trace


def read(r):
    if not r.events or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(r.events) / r.window_s)
