"""Lossy-channel ARQ soak (counterpart of tools/soak_lossy.py): 64 streams
in two 32-stream sessions, one plain QPSK and one RS(255,223) FEC, through
AWGN and per-stream dropouts, completed to 100% by selective-repeat ARQ.

    python -m audio_modem_tpu_torch.tools.soak_lossy [per_stream_MB=0.79] [streams_per_session=32]
        [--out build/soak_torch_lossy.json] [--torch-device cuda]

Round 1, the bulk, stays on the device: frames are synthesized there in
tools/soak.py's layout and the channel is applied there per ingest block:
a per-stream dropout mask (3-6 spans a stream, each 0.5-2 frame cadences,
past the metadata frame) and then ``channel.awgn`` with a
``torch.Generator``. The resend rounds are small and go through the
``arq`` host path: ``build_request_frame`` over a noisy back link,
``_decode_request`` with its full retry ladder, ``_synthesize_mixed``
resends. A session passes when every stream ends complete and exact.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from audio_modem_tpu_torch import arq, channel, framing
from audio_modem_tpu_torch.channel import ChannelSpec, apply_channel_np
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts, resolve_device
from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver
from audio_modem_tpu_torch.tools.soak import BLOCK, ROOT, device_name, stack_padded, synth_signal, write_record

T0 = time.time()
MAX_ROUNDS = 6
SNR_DB = 18.0  # the forward channel's and the back link's AWGN


def log(m: str) -> None:
    print(f"[lossy +{time.time() - T0:7.1f}s] {m}", file=sys.stderr, flush=True)


def dropout_spans(rng: np.random.Generator, n: int, meta_len: int, n_chunks: int, cadence: int):
    """3-6 spans a stream, each 0.5-2 cadences long, past the metadata frame:
    ([n, 6, 2] int64 (start, end), per stream the sorted chunks they hit)."""
    spans = np.zeros((n, 6, 2), np.int64)
    hit_chunks = []
    for i in range(n):
        hit = set()
        for j in range(int(rng.integers(3, 7))):
            start = int(rng.integers(meta_len, n_chunks * cadence + meta_len))
            length = int(rng.integers(cadence // 2, 2 * cadence))
            spans[i, j] = (start, start + length)
            first = max((start - meta_len) // cadence, 0)
            last = min((start + length - meta_len) // cadence, n_chunks - 1)
            hit.update(range(first, last + 1))
        hit_chunks.append(sorted(hit))
    return spans, hit_chunks


def channel_block(sig: torch.Tensor, off: int, reps: int, spans: torch.Tensor, snr_db: float,
                  gen: torch.Generator) -> torch.Tensor:
    """Block ``off`` of every stream (stream i carries signal i % len(sig))
    with its dropout spans zeroed, then AWGN at ``snr_db`` from ``gen``."""
    blk = sig[:, off : off + BLOCK].repeat(reps, 1)
    idx = off + torch.arange(BLOCK, device=sig.device)
    drop = ((idx >= spans[:, :, :1]) & (idx < spans[:, :, 1:])).any(dim=1)
    return channel.awgn(torch.where(drop, 0.0, blk), snr_db, gen)


def run_session(per_mb: float, n: int, fec: bool, seed: int, snr_db: float, dev: torch.device,
                rng: np.random.Generator) -> dict:
    mode = MODES["QPSK"]
    p = mode.profile
    chunk = mode.chunk_size
    per_bytes = int(per_mb * 1e6)
    per_bytes -= per_bytes % chunk
    n_chunks = per_bytes // chunk
    n_sig = min(8, n)
    reps = n // n_sig
    srng = np.random.default_rng(seed)
    files = [srng.bytes(per_bytes) for _ in range(n_sig)]
    mp_payload = chunk + 11
    if fec:
        mp_payload = framing.fec_wire_len(mp_payload)
    pre_d, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    cadence = framing.estimate_frame_samples(mp_payload, mode) + pre_d + post
    log(f"[fec={fec}] {n} x {per_bytes / 1e6:.2f} MB ({n_chunks} chunks), cadence {cadence}")
    sigs = [synth_signal(f, f"s{i}.bin", mode, dev, fec=fec) for i, f in enumerate(files)]
    meta_len = sigs[0].shape[0] - n_chunks * cadence
    sig, _ = stack_padded(sigs)
    spans, injected = dropout_spans(rng, n, meta_len, n_chunks, cadence)
    spans_dev = torch.from_numpy(spans).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    rx = BatchReceiver(mode, n, fec=fec, scan_bucket=BLOCK, device_ingest=True, frames_per_round=8, device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    for j in range(sig.shape[1] // BLOCK):
        rx.process_blocks(channel_block(sig, j * BLOCK, reps, spans_dev, snr_db, gen))
    rx.flush()
    round1_s = time.perf_counter() - t0

    def missing(s) -> list[int]:
        return s.assembler.missing_chunks() if s.meta_received else list(range(n_chunks))

    missing_after_1 = [missing(s) for s in rx.streams]

    def crc_since(before: list[int]) -> tuple[int, list[int]]:
        """CRC errors the streams counted since ``before`` (a stream's first
        metadata frame restarts its count), and the counts now."""
        now = [s.assembler.crc_errors for s in rx.streams]
        return sum(c - b if c >= b else c for c, b in zip(now, before)), now

    crc_round, crc_seen = crc_since([0] * n)
    crc_per_round = [crc_round]
    log(f"[fec={fec}] round 1 in {round1_s:.1f} s; missing {sum(map(len, missing_after_1))} chunks "
        f"(dropouts hit {sum(map(len, injected))})")

    def payload(f: bytes, s: int) -> bytes:
        body = framing.build_data_chunk_payload(f[s * chunk : (s + 1) * chunk], s)
        return framing.wrap_fec(body) if fec else body

    rounds, resent = 1, [0]  # one count a round; the first transmission resends nothing
    pre_m = p.silence_pre_chunk(True)
    while rounds < MAX_ROUNDS:
        requests = {}
        for i, s in enumerate(rx.streams):
            want = missing(s)
            if not want and s.meta_received:
                continue
            # the request crosses the noisy back link, the full retry ladder behind it
            req_sig = apply_channel_np(arq.build_request_frame(want, mode, device=dev).cpu().numpy(),
                                       ChannelSpec(snr_db=snr_db), seed=rounds * 1000 + i, device=dev)
            req = arq._decode_request(req_sig, mode, device=dev)
            if isinstance(req, framing.FrameError) or not req.crc_valid:
                requests[i] = want  # a lost request: the sender resends all that is missing
            elif not req.is_ack:
                requests[i] = list(req.missing)
        if not requests:
            break
        rounds += 1
        resent.append(sum(len(m) for m in requests.values()))
        flat, slots = [], []
        for i, want in requests.items():
            f = files[i % n_sig]
            if not rx.streams[i].meta_received:
                mp = framing.build_metadata_payload(n_chunks, per_bytes, chunk, f"s{i % n_sig}.bin")
                flat.append((framing.wrap_fec(mp) if fec else mp, pre_m, post))
                slots.append(i)
            for s in want:
                flat.append((payload(f, s), pre_d, post))
                slots.append(i)
        per: dict[int, list[np.ndarray]] = {i: [] for i in requests}
        for i, frame in zip(slots, arq._synthesize_mixed(flat, mode, dev)):
            per[i].append(frame)
        signals = {i: apply_channel_np(np.concatenate(s), ChannelSpec(snr_db=snr_db), seed=rounds * 77 + i,
                                       device=dev) for i, s in per.items()}
        length = -(-max(len(s) for s in signals.values()) // BLOCK) * BLOCK
        for off in range(0, length, BLOCK):
            buf = np.zeros((n, BLOCK), np.float32)
            for i, s in signals.items():
                seg = s[off : off + BLOCK]
                buf[i, : len(seg)] = seg
            rx.process_blocks(buf)
        rx.flush()
        crc_round, crc_seen = crc_since(crc_seen)
        crc_per_round.append(crc_round)
        log(f"[fec={fec}] ARQ round {rounds}: resent {resent[-1]} chunks to {len(requests)} streams")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    results = rx.results()
    out = {
        "fec": fec,
        "streams": n,
        "chunks_per_stream": n_chunks,
        "aggregate_mb": n * per_bytes / 1e6,
        "snr_db": snr_db,
        "injected_dropout_chunks": sum(map(len, injected)),
        "missing_after_round1": sum(map(len, missing_after_1)),
        "arq_rounds": rounds,
        "resend_counts_per_round": resent,
        "crc_errors": sum(crc_per_round),
        "crc_errors_per_round": crc_per_round,
        "incomplete_streams": [i for i, r in enumerate(results) if not r["complete"]],
        "payload_bitexact": all(r["complete"] and r["data"] == files[i % n_sig] for i, r in enumerate(results)),
        "round1_s": round1_s,
        "wall_s": wall,
        "launches": launch_counts(),
    }
    rx.cleanup()
    return out


def run_lossy(per_mb: float = 0.79, n: int = 32, device="cuda") -> dict:
    """Both sessions; returns the record."""
    dev = resolve_device(device)
    rng = np.random.default_rng(19)
    snr_db = SNR_DB
    sessions = [run_session(per_mb, n, False, 101, snr_db, dev, rng), run_session(per_mb, n, True, 202, snr_db, dev, rng)]
    return {
        "config": {
            "mode": "QPSK",
            "sessions": f"2 x {n} streams (plain + RS(255,223) FEC)",
            "channel": f"dropout spans (3-6 a stream, 0.5-2 frame cadences each) then AWGN {snr_db} dB per "
                       "ingest block; noisy back link",
        },
        "aggregate_mb": sum(s["aggregate_mb"] for s in sessions),
        "total_streams": sum(s["streams"] for s in sessions),
        "sessions": sessions,
        "pass": all(not s["incomplete_streams"] and s["payload_bitexact"] for s in sessions),
        "device": device_name(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("per_mb", nargs="?", type=float, default=0.79, help="MB a stream")
    ap.add_argument("n", nargs="?", type=int, default=32, help="streams a session")
    ap.add_argument("--out", default=str(ROOT / "build" / "soak_torch_lossy.json"))
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    record = run_lossy(args.per_mb, args.n, args.torch_device)
    write_record(record, Path(args.out))
    for s in record["sessions"]:
        log(json.dumps(s))
    log(f"LOSSY SOAK {'PASS' if record['pass'] else 'FAIL'} -> {args.out}")
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
