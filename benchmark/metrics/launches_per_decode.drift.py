"""Kernels a tracked decode launches: every kernel in the traced decodes
(kernel A's, the tail's, and the timing loop's plain PyTorch operations)
over the decodes. Copies and sets are not kernels."""


def read(r):
    if not r.events or not r.counts.get("decodes"):
        return None
    kernels = sum(1 for name, _, _ in r.events if not name.startswith(("Memcpy", "Memset")))
    return kernels / r.counts["decodes"]
