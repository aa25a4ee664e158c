"""The decoder's own host time in a decode (its Python, allocations and
launches): each root ``decode`` span less the ``decode.sync``,
``decode.upload`` and ``decode.parse`` spans inside it, averaged over the
traced slice's decodes, ms."""

from benchmark import spans


def read(r):
    per = spans.self_ms(spans.of(r)[0], spans.DISPATCH_LESS)
    return sum(per) / len(per) if per else None
