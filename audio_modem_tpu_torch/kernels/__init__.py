"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

The dispatch rule has no switch: a wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches its kernel or raises. Nothing falls
back. Every launch adds one to the wrapper's entry in the launch counts, so
a run can show that its main path went through the kernels.

Importing this package needs neither ``nvcc`` nor a GPU: the library is
built and loaded at the first launch (``_build.load_library``).
"""

from __future__ import annotations

import torch

_LAUNCHES: dict[str, int] = {
    "decode_fused": 0, "decode_predicted": 0, "decode_chunks_fused": 0, "stream_demod": 0, "decode_tail": 0,
    "stream_scan": 0,
}


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel wrapper since the last reset."""
    return dict(_LAUNCHES)


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


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
