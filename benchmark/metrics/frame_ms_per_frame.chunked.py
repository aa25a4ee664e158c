"""Host time the chunked receiver spends on a frame once it is collected:
the program's ``rx.frame`` spans (the cut and normalization on the host,
``decoder.decode_chunk_frame``: upload, CE, streaming demod, the bits' read
and the parse, and the assembler) over its ``frames`` counter, ms."""

from benchmark import spans


def read(r):
    found, counters = spans.of(r)
    ms = [sp.end_us - sp.start_us for sp in found if sp.name == "rx.frame"]
    if not ms or not counters.get("frames"):
        return None
    return sum(ms) * 1e-3 / counters["frames"]
