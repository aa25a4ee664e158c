"""Host time a decode spends putting its recording on the card: the
program's ``decode.upload`` spans (a host recording's copy and its
transfer; a card recording's dtype and reshape) over the traced slice's
decodes, ms."""

from benchmark import spans


def read(r):
    return spans.span_ms_per_decode(spans.of(r)[0], "decode.upload")
