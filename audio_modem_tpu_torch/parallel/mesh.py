"""Device mesh for stream-batch sharding (counterpart of
audio_modem_tpu/parallel/mesh.py).

A mesh is a 1-D tuple of devices along the stream axis. A batch is sharded
over it as contiguous leading-axis slabs, one per mesh device, each a tensor
on its own device (``Sharded``); work on a sharded batch runs shard by
shard, each on its device, and nothing crosses devices but what a caller
gathers. Streams are independent, so a decode needs no other traffic.

``make_mesh`` takes CUDA cards and raises when there are fewer than asked;
it never returns a smaller mesh or the CPU. A caller that names the devices
gets exactly those, repeats allowed: ``["cpu"] * 8`` is the CPU tests'
virtual mesh (the JAX package's 8 virtual CPU devices), ``["cuda:0"] * 2``
two shards on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_modem_tpu_torch.kernels import resolve_device

STREAM_AXIS = "streams"


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """The devices of the stream axis, in shard order."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A batch cut along its leading axis: ``shards[k]`` holds rows
    ``k * rows .. (k + 1) * rows`` on ``mesh.devices[k]``."""

    mesh: StreamMesh
    shards: tuple[torch.Tensor, ...]

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch on one device (default: the mesh's first)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards])

    def numpy(self) -> np.ndarray:
        """The whole batch on the host: one device-to-host copy per shard,
        joined in shard order."""
        return np.concatenate([s.cpu().numpy() for s in self.shards])


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev}: only {torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", index)
    return dev


def make_mesh(n_devices: int | None = None, devices=None) -> StreamMesh:
    """1-D mesh along the stream axis.

    Without ``devices``: the first ``n_devices`` CUDA cards (all of them by
    default); raises if fewer exist. With ``devices``: exactly those
    devices, repeats allowed (a virtual mesh); ``n_devices``, if given,
    must equal their count."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"make_mesh: {len(devs)} device(s) named, n_devices={n_devices}")
        return StreamMesh(devs)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1:
        if n_devices is not None:
            raise ValueError(f"make_mesh: n_devices must be >= 1, got {n_devices}")
        raise RuntimeError("make_mesh: no CUDA device; name the devices for a virtual mesh, e.g. devices=['cpu'] * 8")
    if count < n:
        raise RuntimeError(
            f"make_mesh({n}): only {count} CUDA device(s); name the devices for a virtual mesh, "
            f"e.g. devices=['cpu'] * {n}"
        )
    return StreamMesh(tuple(torch.device("cuda", i) for i in range(n)))


def shard_rows(n: int, mesh: StreamMesh) -> int:
    """Rows per shard of an ``n``-row batch; raises unless the mesh divides it."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not divide over a mesh of {mesh.size} devices")
    return n // mesh.size


def batch_sharding(mesh: StreamMesh, n: int) -> tuple[tuple[torch.device, slice], ...]:
    """Leading-axis (stream-batch) sharding of an ``n``-row batch over
    ``STREAM_AXIS``: each mesh device, in shard order, with the contiguous
    slab of rows it holds."""
    rows = shard_rows(n, mesh)
    return tuple((dev, slice(k * rows, (k + 1) * rows)) for k, dev in enumerate(mesh.devices))


def shard_batch(x: "np.ndarray | torch.Tensor", mesh: StreamMesh) -> Sharded:
    """Place a batch on the mesh by ``batch_sharding`` (one upload per shard
    from the host; a view where the slab already lies on its device)."""
    x = torch.as_tensor(x)
    return Sharded(mesh, tuple(x[rows].to(dev) for dev, rows in batch_sharding(mesh, x.shape[0])))


def replicated(x: "np.ndarray | torch.Tensor", mesh: StreamMesh) -> tuple[torch.Tensor, ...]:
    """The same tensor on every mesh device, in shard order."""
    x = torch.as_tensor(x)
    return tuple(x.to(dev) for dev in mesh.devices)
