"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the device's upload and read-back: the layer every other
module of the port calls down into. It imports nothing above it.

The dispatch rule has no switch: a wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches its kernel or raises. Nothing falls
back. Every launch (``_build.launch``) adds one to its kernel's entry in the
launch counts, so a run can show that its main path went through the
kernels.

A value goes to the device through ``upload`` and comes back through
``read_back`` (``read_pair`` for an index and its metric): while the span
recorder is on (``utils.trace``), every read back is counted in
``host_syncs`` and spanned as ``decode.sync``, and every upload is spanned
as ``decode.upload``.

Importing this package needs neither ``nvcc`` nor a GPU: the library is
built and loaded at the first launch (``_build.load_library``).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_modem_tpu_torch.kernels._build import launch_counts, reset_launch_counts  # noqa: F401
from audio_modem_tpu_torch.utils import trace


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Entry points default to ``"cuda"``;
    asking for CUDA where there is no CUDA device raises, it never runs on
    the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions on the CPU")
    return dev


def runs_on_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix, on
    CUDA tensors of more than one card, or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) > 1:
            raise ValueError(f"tensors must lie on one card, got {sorted({str(t.device) for t in tensors})}")
        return True
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got {sorted(kinds)}")


def upload(signal: "np.ndarray | torch.Tensor", device) -> torch.Tensor:
    """1-D float32 signal on ``device``; a tensor elsewhere raises."""
    dev = resolve_device(device)
    with trace.span("decode.upload"):
        if isinstance(signal, torch.Tensor):
            if signal.device.type != dev.type or (dev.index is not None and signal.device.index != dev.index):
                raise ValueError(f"signal lies on {signal.device}, decode asked for {dev}")
            return signal.to(torch.float32).reshape(-1)
        return torch.from_numpy(np.array(signal, np.float32).reshape(-1)).to(dev)


def read_back(what: str, t: torch.Tensor, cast=None):
    """``cast(t)`` (``int``, ``float``, ``torch.Tensor.tolist`` or
    ``pinned``), or ``t`` as a numpy array where ``cast`` is None: a
    blocking read of a device value. While the recorder is on it counts one
    ``host_syncs`` and runs in a ``decode.sync`` span (attr ``what``)."""
    if not trace.enabled():
        return t.cpu().numpy() if cast is None else cast(t)
    trace.count("host_syncs")
    with trace.span("decode.sync", what=what):
        return t.cpu().numpy() if cast is None else cast(t)


def read_pair(what: str, index: torch.Tensor, metric: torch.Tensor) -> tuple[int, float]:
    """A 0-dim index and its 0-dim metric in one ``read_back``. Where they
    are the two words of one int32 row (the index, then the float32
    metric's bits, as ``receive.stream_refine`` writes them), one 8-byte
    copy of that row; otherwise one float64 copy of both, which holds both
    exactly."""
    if (index.dtype == torch.int32 and metric.dtype == torch.float32 and index.dim() == metric.dim() == 0
            and index.untyped_storage().data_ptr() == metric.untyped_storage().data_ptr()
            and metric.storage_offset() == index.storage_offset() + 1):
        row = read_back(what, index.as_strided((2,), (1,)))
        return int(row[0]), float(row[1:].view(np.float32)[0])
    i, m = read_back(what, torch.stack([index.to(torch.float64), metric.to(torch.float64)]), torch.Tensor.tolist)
    return int(i), m


def pinned(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array: a card's tensor through a fresh block of pinned
    host memory, one copy and one wait on its stream."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()
