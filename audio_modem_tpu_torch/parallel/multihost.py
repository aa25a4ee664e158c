"""Multi-process distribution on ``torch.distributed`` (counterpart of
audio_modem_tpu/parallel/multihost.py).

Each process owns a local mesh of its own streams and feeds them itself:
the audio never leaves the process that captured it. Streams are
independent, so a process runs the sharded step (``sharded_step``, which
``entry.dryrun_multichip`` runs in one process) on its mesh alone, and the
only traffic between processes is the result: the loopback's BER, one
all-reduced scalar, and the detected flags, one all-gathered vector.

``run_dryrun`` starts ``n_processes`` children (``python -m
audio_modem_tpu_torch.parallel.multihost --child ...``, which import no
JAX) on a TCP store at 127.0.0.1 and a free port, each with a local mesh of
``devices_per_process`` devices, and checks what each reports.

Backends: ``gloo`` on the CPU, and for ranks that share a card (the
collectives then run on host tensors, a scalar and a flag vector);
``nccl`` where each rank owns its own cards. ``nccl`` with more ranks'
devices than cards raises.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts, resolve_device
from audio_modem_tpu_torch.parallel.batch import (
    batch_decode_signals,
    batch_loopback_step,
    pad_signals,
    shard_generators,
)
from audio_modem_tpu_torch.parallel.mesh import make_mesh, shard_batch

REPORT = "multihost report "
ROOT = Path(__file__).resolve().parents[2]


def sharded_step(mesh, bits: np.ndarray, seed: int = 0) -> tuple[float, np.ndarray]:
    """The sharded step of the dry runs on ``mesh``: the TX -> AWGN (30 dB)
    -> RX loopback of ``bits`` [B, 2 * bits_per_symbol] with its BER mean
    across shards, then the full receive (kernel A on the card) of one
    64-byte QPSK chunk frame per stream. Returns (BER, detected flags [B])."""
    mode = MODES["QPSK"]
    n_sym = 2
    ber, _ = batch_loopback_step(shard_batch(bits, mesh), shard_generators(seed, mesh), mode, n_sym, 30.0)
    frame = framing.build_data_chunk_frame(b"\x42" * 64, 0, mode, device=mesh.devices[0]).cpu().numpy()
    signals, n_valid = pad_signals([frame] * bits.shape[0], pad_len=len(frame) + mode.profile.symbol_len)
    out = batch_decode_signals(shard_batch(signals, mesh), shard_batch(n_valid, mesh), mode, 4)
    return float(ber), out["detected"].numpy()


def _local_devices(rank: int, devices_per_process: int, device: str, backend: str) -> list[str]:
    """The devices of ``rank``'s local mesh: CPUs, its own cards under nccl,
    or cards shared round-robin under gloo."""
    if device == "cpu":
        return ["cpu"] * devices_per_process
    count = torch.cuda.device_count()
    first = rank * devices_per_process
    if backend == "nccl":
        return [f"cuda:{first + j}" for j in range(devices_per_process)]
    return [f"cuda:{(first + j) % count}" for j in range(devices_per_process)]


def _child_main(rank: int, world: int, devices_per_process: int, store: str, backend: str, device: str,
                timeout: float) -> None:
    """One process: join the group, run the sharded step on the local mesh,
    all-reduce the BER and all-gather the flags, print a report line."""
    import torch.distributed as dist


    torch.set_num_threads(2)
    mesh = make_mesh(devices=_local_devices(rank, devices_per_process, device, backend))
    # nccl's collectives run on this rank's first card; gloo's on the host
    coll = mesh.devices[0] if backend == "nccl" else torch.device("cpu")
    if coll.type == "cuda":
        torch.cuda.set_device(coll)
    dist.init_process_group(backend, init_method=store, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        mode = MODES["QPSK"]
        per_dev = 2
        b_local = per_dev * devices_per_process
        bits = np.random.default_rng(100 + rank).integers(0, 2, (b_local, 2 * mode.bits_per_symbol), dtype=np.int8)
        reset_launch_counts()
        ber_local, det_local = sharded_step(mesh, bits)
        launches = launch_counts()
        ber = torch.tensor([ber_local], dtype=torch.float64, device=coll)
        dist.all_reduce(ber)
        ber_mean = float(ber.item()) / world
        flags = [torch.zeros(b_local, dtype=torch.uint8, device=coll) for _ in range(world)]
        dist.all_gather(flags, torch.from_numpy(det_local.astype(np.uint8)).to(coll))
        detected = torch.cat(flags).cpu().numpy().astype(bool)
        if not ber_mean < 0.01:
            raise RuntimeError(f"multihost loopback BER {ber_mean}")
        if not (detected.shape == (b_local * world,) and detected.all()):
            raise RuntimeError(f"multihost decode: {detected}")
        print(REPORT + json.dumps({
            "rank": rank, "world": world, "backend": backend, "devices": [str(d) for d in mesh.devices],
            "ber_local": ber_local, "ber": ber_mean, "detected": detected.astype(int).tolist(),
            "launches": launches, "jax_loaded": "jax" in sys.modules or "audio_modem_tpu" in sys.modules,
        }), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_command(rank: int, world: int, devices_per_process: int, store: str, backend: str, device: str,
                   timeout: float) -> list[str]:
    return [sys.executable, "-m", "audio_modem_tpu_torch.parallel.multihost", "--child", str(rank), str(world),
            str(devices_per_process), store, backend, device, str(timeout)]


def run_dryrun(n_processes: int = 2, devices_per_process: int = 4, timeout: float = 900.0,
               backend: str | None = None, device="cuda") -> list[dict]:
    """Start ``n_processes`` processes of one ``torch.distributed`` group,
    each running the sharded step on a local mesh of
    ``devices_per_process`` devices, and return their reports in rank
    order. ``backend`` defaults to nccl where every rank's devices are
    cards of their own, else gloo. Each child has ``timeout`` seconds;
    when one fails or runs out of time the rest are stopped and this
    raises with every child's output."""
    dev = resolve_device(device)
    if n_processes < 1 or devices_per_process < 1:
        raise ValueError(f"need at least one process and one device each, got {n_processes} x {devices_per_process}")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and n_processes * devices_per_process <= cards else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices: use gloo on the CPU")
        if n_processes * devices_per_process > cards:
            raise RuntimeError(f"nccl: {n_processes} ranks x {devices_per_process} devices need that many cards, "
                               f"only {cards}: use gloo for ranks that share a card")
    elif backend != "gloo":
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    store = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "2"
    with tempfile.TemporaryDirectory() as td, contextlib.ExitStack() as files:
        procs = []
        try:
            for rank in range(n_processes):
                out = files.enter_context(open(Path(td) / f"out{rank}", "w+"))
                err = files.enter_context(open(Path(td) / f"err{rank}", "w+"))
                cmd = _child_command(rank, n_processes, devices_per_process, store, backend, dev.type, timeout)
                procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err, text=True), out, err))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p, _, _ in procs]
                if any(c not in (None, 0) for c in codes):
                    failed = "a child failed"
                    break
                if None not in codes:
                    failed = None
                    break
                if time.monotonic() > deadline:
                    failed = f"a child ran past its {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for p, out, err in procs:
            out.seek(0)
            err.seek(0)
            texts.append((p.returncode, out.read(), err.read()))
    reports = [next((json.loads(line[len(REPORT):]) for line in text.splitlines() if line.startswith(REPORT)), None)
               for _, text, _ in texts]
    if failed or None in reports:
        why = failed or "a child printed no report"
        detail = "\n".join(f"--- child {r} rc={rc} ---\n{out[-1500:]}\n{err[-3000:]}"
                           for r, (rc, out, err) in enumerate(texts))
        raise RuntimeError(f"multihost dryrun: {why}:\n{detail}")
    return reports


if __name__ == "__main__":
    if len(sys.argv) == 9 and sys.argv[1] == "--child":
        _child_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6], sys.argv[7],
                    float(sys.argv[8]))
        sys.exit(0)
    for report in run_dryrun():
        print(json.dumps(report))
    print("multihost dryrun OK")
