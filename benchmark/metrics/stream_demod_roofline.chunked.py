"""The streaming demod's (kernel B') share of its roofline on the chunked
path: the least time of every call in the traced decodes (its shape, at the
card's published peaks) over the device time of its launches."""

from benchmark import trace
from benchmark.reference import roofline, roofline_stream

OWN = ("stream_demod_kernel",)


def read(r):
    calls = r.shapes.get("stream_demod")
    if not calls or not r.events or r.peaks is None:
        return None
    device_s = trace.kernel_seconds(r.events, OWN, (), ())
    if device_s <= 0:
        return None
    least = sum(roofline.least_seconds(roofline_stream.work_stream_demod(r.mode, c["b"], c["n_sym"]), r.peaks)
                for c in calls)
    return 100.0 * least / device_s
