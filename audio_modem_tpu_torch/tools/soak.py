"""Config-5 soak (counterpart of tools/soak.py): N streams x multi-MB
transfers through the whole BatchReceiver runtime, wire-accurate signals,
sqlite persistence, zero lost chunks required.

    python -m audio_modem_tpu_torch.tools.soak [per_stream_MB=0.82] [n_streams=64]
        [--mesh N | --mesh cuda:0,cuda:0] [--out build/soak_torch.json] [--torch-device cuda]

Frames are synthesized on the device (``framing._synth_frames_core``) and
stay there: 8 seeded datasets, each a metadata frame followed by its data
frames (the ``api.encode_chunked`` wire layout, held to it in the tests),
tiled x8 over the 64 streams; lockstep blocks of 65,536 samples are cut on
the device and fed to ``BatchReceiver(device_ingest=True)`` at K = 8 frames
a round, sharded over a mesh with ``--mesh`` (a card count, or the devices
by name for a virtual mesh). A short warm-up transfer first builds the kernels and
fills the allocators. The JSON record (sustained Msamples/s, real-time
streams, chunks received against expected, CRC errors, incomplete streams,
payload bit-exact, the receiver's stage split, the device) goes to
``--out``; 7.819264 MB a stream x 64 is the 500 MB transfer.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES, SAMPLE_RATE, ModemMode
from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts, resolve_device
from audio_modem_tpu_torch.parallel.mesh import make_mesh
from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver

ROOT = Path(__file__).resolve().parents[2]
BLOCK = 65536
FRAMES_PER_ROUND = 8
T0 = time.time()


def log(m: str) -> None:
    print(f"[soak +{time.time() - T0:7.1f}s] {m}", file=sys.stderr, flush=True)


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def chunk_payloads(data: bytes, chunk: int, fec: bool = False) -> np.ndarray:
    """The data-chunk payloads of ``data`` (whole chunks), [n_chunks, n_bytes] uint8."""
    n_chunks = len(data) // chunk
    pls = [framing.build_data_chunk_payload(data[s * chunk : (s + 1) * chunk], s) for s in range(n_chunks)]
    if fec:
        pls = [framing.wrap_fec(p) for p in pls]
    return np.frombuffer(b"".join(pls), np.uint8).reshape(n_chunks, -1)


def synth_signal(data: bytes, name: str, mode: ModemMode, dev: torch.device, fec: bool = False) -> torch.Tensor:
    """One transfer of ``data`` (whole chunks) on ``dev``: the metadata frame
    then every data frame, one batched synthesis (the wire layout of
    ``api.encode_chunked``)."""
    p = mode.profile
    chunk = mode.chunk_size
    pls = chunk_payloads(data, chunk, fec)
    meta = framing.build_metadata_frame(len(pls), len(data), chunk, name, mode, fec=fec, device=dev)
    n_sym = framing.num_symbols_for_payload(pls.shape[1], mode)
    frames = framing._synth_frames_core(
        torch.from_numpy(pls.copy()).to(dev), mode, n_sym, p.silence_pre_chunk(False), p.silence_post_chunk()
    )
    return torch.cat([meta, frames.reshape(-1)])


def stack_padded(sigs: "list[torch.Tensor]", block: int = BLOCK) -> tuple[torch.Tensor, int]:
    """[len(sigs), t_pad] zero-padded to whole blocks, and the longest length."""
    t = max(s.shape[0] for s in sigs)
    t_pad = -(-t // block) * block
    return torch.stack([torch.nn.functional.pad(s, (0, t_pad - s.shape[0])) for s in sigs]), t


def tiled_block(sig: torch.Tensor, off: int, reps: int, block: int = BLOCK) -> torch.Tensor:
    """Rows ``off .. off + block`` of every signal, tiled ``reps`` times:
    stream i carries signal i % len(sig)."""
    return sig[:, off : off + block].repeat(reps, 1)


def feed(rx: BatchReceiver, sig: torch.Tensor, reps: int, progress: bool = False) -> None:
    n_blocks = sig.shape[1] // BLOCK
    for j in range(n_blocks):
        rx.process_blocks(tiled_block(sig, j * BLOCK, reps))
        if progress and j % 200 == 0:
            done = sum(s.assembler.received_count for s in rx.streams)
            log(f"block {j}/{n_blocks}, chunks {done}")
    rx.flush()


def run_soak(per_mb: float = 0.82, n: int = 64, device="cuda", mesh=None) -> dict:
    """The soak: returns its record (see the module docstring). ``mesh``
    shards the streams (``device`` is then not read)."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    mode = MODES["QPSK"]
    chunk = mode.chunk_size
    per_bytes = int(per_mb * 1e6)
    per_bytes -= per_bytes % chunk  # whole chunks: one steady-state frame length
    n_chunks = per_bytes // chunk
    n_sig = min(8, n)
    if n % n_sig:
        raise ValueError(f"{n} streams do not tile {n_sig} signals")
    reps = n // n_sig
    rng = np.random.default_rng(83)
    files = [rng.bytes(per_bytes) for _ in range(n_sig)]
    log(f"{n} streams x {per_bytes / 1e6:.2f} MB ({n_chunks} chunks) = {n * per_bytes / 1e6:.0f} MB aggregate")
    sig, t = stack_padded([synth_signal(f, f"s{i}.bin", mode, dev) for i, f in enumerate(files)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"TX done: {list(sig.shape)} on {dev} ({sig.numel() * 4 / 1e9:.2f} GB), {t} samples a stream")

    def receiver(persist_dir=None) -> BatchReceiver:
        return BatchReceiver(mode, n, persist_dir=persist_dir, scan_bucket=BLOCK, device_ingest=True,
                             frames_per_round=FRAMES_PER_ROUND, device=dev, mesh=mesh)

    n_warm = min(4 * FRAMES_PER_ROUND, n_chunks)
    wsig, _ = stack_padded([synth_signal(files[0][: n_warm * chunk], "w.bin", mode, dev)] * n_sig)
    rx = receiver()
    feed(rx, wsig, reps)
    if not all(r["complete"] for r in rx.results()):
        raise RuntimeError("soak: the warm-up transfer did not complete")
    del rx, wsig
    log("warm-up done")
    with tempfile.TemporaryDirectory() as td:
        rx = receiver(td)
        reset_launch_counts()
        t0 = time.perf_counter()
        feed(rx, sig, reps, progress=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        results = rx.results()
        total_chunks = sum(s.assembler.received_count for s in rx.streams)
        crc_errors = sum(s.assembler.crc_errors for s in rx.streams)
        incomplete = [i for i, r in enumerate(results) if not r["complete"]]
        data_ok = all(r["data"] == files[i % n_sig] for i, r in enumerate(results))
        stage = rx.timer.report()
        rx.cleanup()
    msps = n * t / dt / 1e6
    return {
        "config": {
            "streams": n,
            "per_stream_bytes": per_bytes,
            "aggregate_mb": n * per_bytes / 1e6,
            "chunks_per_stream": n_chunks,
            "samples_per_stream": t,
            "mode": "QPSK",
            "assembler": "sqlite (persist_dir, WAL)",
            "frames_per_round": FRAMES_PER_ROUND,
            "mesh": [str(d) for d in mesh.devices] if mesh is not None else None,
        },
        "wall_s": dt,
        "sustained_msps": msps,
        "realtime_streams": msps * 1e6 / SAMPLE_RATE,
        "chunks_received": total_chunks,
        "chunks_expected": n * n_chunks,
        "crc_errors": crc_errors,
        "incomplete_streams": incomplete,
        "payload_bitexact": data_ok,
        "launches": launches,
        "stage_breakdown": stage,
        "device": device_name(dev),
    }


def passed(record: dict) -> bool:
    return (not record["incomplete_streams"] and record["payload_bitexact"]
            and record["chunks_received"] == record["chunks_expected"] and record["crc_errors"] == 0)


def write_record(record: dict, out: "str | Path") -> None:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2) + "\n")


def parse_mesh(spec: str):
    """``--mesh``: a card count ("2") or devices by name ("cuda:0,cuda:0")."""
    if not spec:
        return None
    return make_mesh(int(spec)) if spec.isdigit() else make_mesh(devices=spec.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("per_mb", nargs="?", type=float, default=0.82, help="MB a stream")
    ap.add_argument("n", nargs="?", type=int, default=64, help="streams")
    ap.add_argument("--mesh", default="", help="shard the streams: a card count, or devices by name, comma-separated")
    ap.add_argument("--out", default=str(ROOT / "build" / "soak_torch.json"))
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    record = run_soak(args.per_mb, args.n, args.torch_device, parse_mesh(args.mesh))
    write_record(record, args.out)
    log(json.dumps({k: v for k, v in record.items() if k != "stage_breakdown"}))
    ok = passed(record)
    log(f"SOAK {'PASS' if ok else 'FAIL'} -> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
