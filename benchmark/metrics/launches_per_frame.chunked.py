"""Kernels the chunked receiver launches per frame it cut: every kernel in
the traced decodes (the scan windows', the refines' and the frame decodes'
plain PyTorch operations and the streaming demod) over the frames the
driver saw cut in them. Copies and sets are not kernels."""


def read(r):
    if not r.events or not r.counts.get("frames"):
        return None
    kernels = sum(1 for name, _, _ in r.events if not name.startswith(("Memcpy", "Memset")))
    return kernels / r.counts["frames"]
