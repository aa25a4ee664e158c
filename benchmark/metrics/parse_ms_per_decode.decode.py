"""Host time a decode spends parsing the payload's bytes (CRC, and RS
where the frame carries FEC): the program's ``decode.parse`` spans over
the traced slice's decodes, ms."""

from benchmark import spans


def read(r):
    return spans.span_ms_per_decode(spans.of(r)[0], "decode.parse")
