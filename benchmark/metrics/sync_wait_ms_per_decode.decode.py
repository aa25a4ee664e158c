"""Host time a decode spends waiting on those reads, and copying back what
they read: the program's ``decode.sync`` spans over the traced slice's
decodes, ms."""

from benchmark import spans


def read(r):
    return spans.span_ms_per_decode(spans.of(r)[0], "decode.sync")
