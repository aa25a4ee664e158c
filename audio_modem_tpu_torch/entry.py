"""Driver entry points of the port (counterpart of __graft_entry__.py): one
compile-free forward step on the card, the sharded step on a mesh, and the
same across processes.

    python -m audio_modem_tpu_torch.entry

runs ``entry()`` and ``dryrun_multichip`` over every card. A mesh larger
than the card count raises: a virtual mesh exists only where the caller
names its devices (``devices=["cpu"] * 8``, ``["cuda:0"] * 2``).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import resolve_device
from audio_modem_tpu_torch.parallel.batch import batch_decode_chunk_frames
from audio_modem_tpu_torch.parallel.mesh import make_mesh
from audio_modem_tpu_torch.parallel.multihost import run_dryrun, sharded_step


def entry(device="cuda"):
    """(fn, example_args): the flagship step, batched OFDM chunk-frame
    demodulation (CE + EQ + pilot phase + demap; kernel B on the card),
    over 8 seeded QPSK frames of 4 data symbols."""
    mode = MODES["QPSK"]
    n_sym = 4
    frame_len = (3 + n_sym) * mode.profile.symbol_len
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((8, frame_len)).astype(np.float32)).to(resolve_device(device))

    def fn(frames):
        return batch_decode_chunk_frames(frames, mode, n_sym)

    return fn, (frames,)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run ONE sharded step (loopback with the BER mean across shards, and
    the full receive) on an ``n_devices`` mesh: the first ``n_devices``
    cards, or the ``devices`` named. Raises if fewer cards exist, or if the
    step fails."""
    mesh = make_mesh(n_devices, devices)
    mode = MODES["QPSK"]
    b = 2 * n_devices
    bits = np.random.default_rng(1).integers(0, 2, (b, 2 * mode.bits_per_symbol), dtype=np.int8)
    ber, detected = sharded_step(mesh, bits)
    if ber >= 0.01:
        raise RuntimeError(f"loopback BER {ber} too high on the {n_devices}-device mesh {mesh.devices}")
    if not (detected.shape == (b,) and detected.all()):
        raise RuntimeError(f"sharded decode missed a frame on {mesh.devices}: {detected}")


def dryrun_multihost(n_processes: int = 2, devices_per_process: int = 4, backend: str | None = None,
                     device="cuda") -> list[dict]:
    """The sharded step across ``n_processes`` processes of a
    ``torch.distributed`` group (``parallel.multihost.run_dryrun``):
    returns each process's report; raises if any fails."""
    return run_dryrun(n_processes, devices_per_process, backend=backend, device=device)


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", tuple(fn(*args).shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK")
