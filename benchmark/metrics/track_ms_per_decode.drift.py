"""Host time the one-shot decoder spends in its timing tracker per traced
decode: the program's ``decode.track`` spans (the preprocess, the channel
estimate and the tracking loop's three passes over the frame's blocks)
over the traced decodes' root spans, ms; nothing where the program records
no such span."""

from benchmark import spans


def read(r):
    found = spans.of(r)[0]
    if not any(sp.name == "decode.track" for sp in found):
        return None
    return spans.span_ms_per_decode(found, "decode.track")
