"""Device-free microbench of ``BatchReceiver._consume_multi`` at soak volume
(counterpart of tools/bench_consume.py).

    python -m audio_modem_tpu_torch.tools.bench_consume [n_streams=64] [chunks_per_stream=3818]

Drives ``_consume_multi`` directly with synthetic packed result matrices
(wire-exact CRC-valid chunk payload rows at the steady-state cadence) for
the config-5 shape: 64 streams x 3,818 chunks, sqlite assemblers,
speculative rounds (``spec_gens``). No device work: the receiver is built
with ``device="cpu"`` by name, since only its host half runs. Prints
us/chunk per quarter of the transfer, so volume dependence shows, and the
garbage collector's collections.
"""

from __future__ import annotations

import gc
import sys
import tempfile
import time

import numpy as np

from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver

K = 8


def run(n: int = 64, n_chunks: int = 3818) -> dict:
    """The microbench; returns per-quarter seconds and us/chunk, chunks stored
    and expected, and the collections per generation."""
    mode = MODES["QPSK"]
    p = mode.profile
    chunk = mode.chunk_size
    mp_payload = chunk + 11
    est_len = framing.estimate_frame_samples(mp_payload, mode)
    cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
    rng = np.random.default_rng(3)
    n_rounds = n_chunks // K
    quarters = 4
    per_q = n_rounds // quarters
    if per_q < 1:
        raise ValueError(f"need at least {quarters * K} chunks a stream, got {n_chunks}")
    with tempfile.TemporaryDirectory() as td:
        rx = BatchReceiver(mode, n, persist_dir=td, scan_bucket=65536, device_ingest=True, device="cpu")
        # steady state: metadata received on every stream
        meta = framing.MetaFrame(total_chunks=n_chunks, total_file_size=n_chunks * chunk, chunk_size=chunk,
                                 file_name="b.bin", crc_valid=True)
        for s in rx.streams:
            s.assembler.handle_metadata(meta)
            s.meta_received = True
        # a packed round per K chunk seqs: [detected, start (4 bytes big-endian), payload, pad]
        n_bytes = 5 + mp_payload + 32
        data = rng.integers(0, 256, (n_chunks, chunk), np.uint8)

        def packed_round(r: int) -> np.ndarray:
            out = np.zeros((n, K, n_bytes), np.uint8)
            for j in range(K):
                seq = r * K + j
                row = np.frombuffer(framing.build_data_chunk_payload(data[seq].tobytes(), seq), np.uint8)
                start = j * cadence  # relative to the round's base
                out[:, j, 0] = 1
                out[:, j, 1:5] = [(start >> sh) & 0xFF for sh in (24, 16, 8, 0)]
                out[:, j, 5 : 5 + len(row)] = row
            return out

        t_build = time.perf_counter()
        rounds = [packed_round(r) for r in range(n_rounds)]  # built first: the timed loop is consume only
        print(f"built {n_rounds} rounds in {time.perf_counter() - t_build:.1f}s", file=sys.stderr)
        gc0 = gc.get_stats()
        w = K * cadence + 4096
        seconds = []
        for q in range(quarters):
            t0 = time.perf_counter()
            for r in range(q * per_q, (q + 1) * per_q):
                base = r * K * cadence
                for s in rx.streams:
                    s.pred_start = base + K * cadence  # as the dispatch-time advance left it
                    s.inflight = K
                    s.defer_total = 1 << 60  # the ring does not hold the next round yet
                rx._consume_multi(
                    list(range(n)), {i: base for i in range(n)}, np.full(n, w, np.int32), rounds[r], est_len,
                    cadence, w, predicted=True, spec_gens={i: rx.streams[i].gen for i in range(n)},
                )
            seconds.append(time.perf_counter() - t0)
            print(f"quarter {q}: {seconds[-1]:.2f}s = {seconds[-1] / (per_q * K * n) * 1e6:.1f} us/chunk "
                  f"(cum chunks/stream {rx.streams[0].assembler.received_count})", file=sys.stderr)
        collections = [a["collections"] - b["collections"] for a, b in zip(gc.get_stats(), gc0)]
        stored = sum(s.assembler.received_count for s in rx.streams)
        rx.cleanup()
    result = {
        "streams": n, "chunks_per_stream": n_chunks, "quarter_seconds": seconds,
        "us_per_chunk": [s / (per_q * K * n) * 1e6 for s in seconds],
        "stored": stored, "expected": n * per_q * quarters * K, "gc_collections": collections,
    }
    print(f"gc gen collections delta: {collections}", file=sys.stderr)
    print(f"stored {stored}/{result['expected']}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    result = run(*(int(a) for a in argv[:2]))
    return 0 if result["stored"] == result["expected"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
