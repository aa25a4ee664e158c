"""Kernel A's share of its roofline at B = 1 in the single-signal decoder: the least time
of every call in the traced window (its shapes, at the card's published
peaks) over the device time of A's launches."""

from benchmark import trace
from benchmark.reference import roofline

OWN = ("scan_kernel", "commit_kernel", "refine_ce_kernel", "receive_demod_kernel")
OTHERS = ("predicted_chain_kernel", "predicted_demod_kernel", "predicted_pack_kernel")
SHARED = ("pre_stats_kernel", "combine_kernel")


def read(r):
    calls = r.shapes.get("decode_fused")
    if not calls or not r.events or r.peaks is None:
        return None
    device_s = trace.kernel_seconds(r.events, OWN, OTHERS, SHARED)
    if device_s <= 0:
        return None
    least = sum(roofline.least_seconds(roofline.work_decode_fused(r.mode, *c["signals"], c["max_syms"]), r.peaks)
                for c in calls)
    return 100.0 * least / device_s
