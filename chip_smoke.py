#!/usr/bin/env python3
"""Smoke run of the PyTorch port (audio_modem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full size: the turbo receive round (64 QPSK
streams, 2048-byte chunks, 32 frames per round, kernels A and C; BASELINE
config 5), the
single-signal decode (api.encode -> api.decode of a 32,736-byte file as one
BPSK-REPEAT legacy frame of 7,906,500 samples under 12 dB AWGN; BASELINE
config 2), the chunked-file receive (api.encode_chunked ->
api.decode_chunked of a 1 MiB file in QPSK, 513 frames, 14.6 M samples;
BASELINE config 3) and the multi-stream runtime (BatchReceiver, 64 QPSK
streams fed in lockstep blocks of 65,536 samples; BASELINE config 5), and
the application layer on top of them (the CLI, play | listen over a pipe,
single-stream and 64-stream selective-repeat ARQ, the BER curve), the
receiver sharded over a mesh, the driver entry points and a multi-process
torch.distributed group, the config-5 soaks and the demo, and the JAX
package's test contract (BASELINE configs 1 and 4, the edge cases, the
golden WAVs).
Phases, one line each:

  1. card (nvidia-smi name and power limit), torch and CUDA versions
  2. build the CUDA kernels from audio_modem_tpu_torch/csrc
  3. TX: 64 x 32 data frames synthesized on the card, cut into the
     [64, 914,688] turbo windows
  4. kernel A (decode_fused, six gridded launches) against its plain
     version on those windows: start, coarse, coarse metric and detected
     equal, fine metric within 1e-5, channel within 1e-4, 0 flipped bits
  5. kernel B (decode_chunks_fused: peak, then CE and demod gridded over
     symbol tiles) against its plain version on 64 frame-aligned frames
  6. the main path with launch counts from zero: one turbo round
     (_batch_window_decode_multi: kernel A for slot 0, kernel C once for the
     31 predicted slots) and the frame-aligned packed demod of its frames;
     every slot must be detected, CRC-valid and in sequence
  7. times from CUDA events (median of 10 after warm-up, plain and kernel
     in turns); kernels A and B beside their bounds and roofline shares.
     Then kernel C (decode_predicted) against its plain version on the same
     round in both branches (slot 0 from kernel A; every slot predicted):
     start, flags and heads equal on every (stream, slot), fine metric
     within 1e-5, payload bytes equal on every slot, all CRC-valid and in
     sequence; its time and its plain version's (median of 5, in turns)
     beside its bound, then its five launches (pre_stats, combine, chain,
     demod, pack) apart from torch.profiler, each beside C's bound and share
  8. the streaming demod (decode_chunks_fused_stream) against its plain
     version and kernel B on 64 BPSK-NARROW 512-byte chunk frames (598
     symbols of 768 samples) and 64 QPSK 2048-byte chunk frames (41 of 576)
  9. the single-signal decode with launch counts from zero: config 2 and a
     clean 32,736-byte QPSK legacy frame through api.decode on the card,
     exact bytes, kernel A (decode_fused, B = 1) and the tail (decode_tail)
     launched once per call of the decoder's device core and the streaming
     demod not at all; kernel A against its plain version on the inputs the
     decoder gave it (phase 17's checks), and the tail bit for bit against
     its plain version on the inputs the decoder gave it (every other phase
     whose inputs path_inputs keeps holds the tail so too); decode_long_fused
     and kernel A at B = 1 against their
     plain version on config 2's padded signal (the checks of phase 4)
 10. times: stream_demod vs plain on config 2's 12,361-symbol data region,
     decode_long_fused vs kernel A at B = 1 (kernel A beside its bound),
     the streaming demod vs kernel B on the 64 narrowband frames, the tail
     vs plain on config 2's kernel A row (device time from torch.profiler,
     beside its bound), and the
     host wall of api.decode of config 2 through kernel A and through
     decode_long_fused (median of 10 a route, in turns)
 11. SHA-256 of the int8 bits the three kernels gave in phases 4, 5 and 9,
     and of kernel C's chain (start, fine metric, cumulative flag) and
     packed rows in both branches of phase 7: two checkouts whose kernels
     agree bit for bit print the same digests (tools/torch_kernel_digest.py
     prints them for more inputs)
 12. the chunked receive with launch counts from zero: a seeded 1 MiB file
     through api.encode_chunked on the card, brought to the host as audio,
     through api.decode_chunked(device="cuda") twice: complete, 512 chunks,
     none missing, no CRC error, exact bytes, stream_demod launched once per
     frame and stream_scan once per scan window; wall time, Msamples/s,
     multiple of real time, and the host's ms per scan, refine and
     frame-decode call (second run); then stream_demod alone at one chunk
     frame's shape, and stream_scan alone on one window around a preamble
     (bit for bit its plain version; both timed, the scan beside its bound)
 13. the same at 768-sample symbols: an 8 KiB file in BPSK-NARROW behind
     20,000 samples of seeded noise at amplitude 1e-3; exact bytes
 14. persist and resume: the metadata frame and the first 256 data frames
     of the 1 MiB transfer into a StreamingReceiver with a sqlite store,
     then a second receiver with resume=True takes a replayed metadata
     frame and the other 256; the assembled file is exact
 15. device-ring rounds: 64 staggered streams of 2 x 32 frames written in
     blocks into a DeviceRing(64, 2 x 914,688) whose write position wraps;
     round 1 (_batch_window_decode_multi_dev) equals
     _batch_window_decode_multi on the same windows, round 2
     (_batch_window_decode_pred_dev) is predicted from round 1's last start
     plus the cadence; every slot of both detected, CRC-valid and in
     sequence; decode_fused launches in round 1 only, decode_predicted once
     a round; both rounds' ms, the ring's write and gather ms
 16. the retry ladder's timing tracker: api.decode(track_timing=True) of the
     32,736-byte QPSK frame, exact bytes, wall ms
 17. BatchReceiver, host-fed: a seeded file of 4 chunks per stream into 64
     streams as host numpy blocks, through the staged machine (scan,
     refine, kernel B) and again with window_decode=True (kernel A); one
     warm pass, then one timed pass of each: all 64 complete and exact,
     decode_chunks_fused launched in the staged run; wall, Msamples/s,
     launches; kernels A and B against their plain versions (phase 4's and
     5's checks) on the first input of each shape the warm passes gave them
 18. BatchReceiver, device ingest, steady state: 128 chunks per stream
     (3.68 M samples, 235 M stream-samples), blocks cut on the card as
     broadcast slices of one signal, ring [64, 3,597,568], K = 8,
     pipeline_depth 8: all 64 complete and exact, decode_fused launched,
     decode_predicted once a K-round (multi_dispatch + pred_dispatch
     calls, at both depths), predicted rounds carry at least the scanned
     rounds' samples,
     speculative fetches happened; wall, Msamples/s, real-time streams,
     the receiver's stage split and launches; then the same transfer at
     pipeline_depth 0, exact, its wall beside depth 8's. Then rows that
     differ: 8 seeded files of 64 chunks, stream i carrying file i % 8
     behind 3,001 * i samples of noise; a warm and a timed pass, each
     stream's own file exact, wall and stage split, and the [64, 232,320]
     window cut out of the ring for lockstep and for staggered rows. Kernels
     A and C against their plain versions on the first input of each shape
     the warm passes gave them (the startup windows [64, 65,536] at
     max_syms 110, slot 0 of the scanned K-rounds at [64, 232,320], the
     shorter tail rounds; C in both branches by compare_predicted's rule
     for a live runtime's windows)
 19. the application layer: the port's CLI (cli.main in this process, on
     the card by default) with launch counts from zero before each
     subcommand: encode -> decode of a seeded 32,736-byte file (one QPSK
     legacy frame, kernel A launched), encode -> receive of the 1 MiB file of phase 12 (513
     frames), play --no-pace of it into an os.pipe with listen on the other
     end in f32 and s16 (real-time factor printed), testsignal -> diagnose
     (detected, ber 0, excellent), diagnose --live through a channel of
     20 dB SNR, 100 ppm drift and a 50-sample echo (detected), sweep, info;
     every file exact, stream_demod launched at least once per frame
     received
 20. selective-repeat ARQ: arq.run_arq_session of the 1 MiB file with every
     20th data-chunk frame zeroed in round 1 (exact, round 2 resends the
     26 dropped chunks and only them); arq.run_batch_arq_session of 64
     seeded 16-chunk files (config 5's widths, cut in depth) through one
     BatchReceiver with one chunk frame zeroed on every even stream in
     round 1 (64 exact files, even streams resend one chunk, kernel B
     launched); diag.ber_vs_snr of 64 x 64 QPSK symbols (0 at 30 dB, no
     rise beyond noise as the SNR grows); walls per round; kernel A
     launched by each request decode. Then kernels A and B and the
     streaming demod against their plain versions on the first input of
     each shape phases 19-20 gave them: A by phase 17's checks, B bit for
     bit, the streaming demod bit for bit on every symbol that carries
     signal (its junk symbols, constant or past the signal's end, reported
     apart)
 21. the receiver sharded over a mesh: phase 18's transfer through
     BatchReceiver(mesh=...) on two shards of cuda:0, on make_mesh() (every
     card) and, with two or more cards, on make_mesh(2) (with one card it
     says that the two-card mesh was not run); a warm and a timed pass each,
     64 exact files, results, counters, final state and stage counts equal
     to phase 18's un-sharded receiver, kernels A and C launched once a
     shard for each of their launches there; wall and stage split beside
     phase 18's; kernels A and C against their plain versions on every
     shard's inputs
 22. entry points and the cluster: entry() on the card (kernel B once,
     bit for bit against its plain version), dryrun_multichip on
     [cuda:0] x 2 and on every card, then parallel.multihost.run_dryrun
     with 2 gloo ranks x 2 devices sharing the card(s) and with one nccl
     rank per card: each child's BER (< 0.01), all-gathered flags (all
     set), launches (kernel A once a device) and devices are checked; then
     kernels A and B against their plain versions on the inputs of
     entry() and of every dryrun_multichip shard, which are the ranks'
     shard inputs too (the same sharded step and shard shape): B bit for
     bit, A by phase 17's checks and bit for bit on every detected symbol
     that carries signal (the silent symbol after the frame is reported)
 23. the soak (tools/soak.py: 64 streams x 0.82 MB, 400 chunks a stream,
     sqlite, exact), the lossy soak (tools/soak_lossy.py: 2 sessions x 32
     streams, plain and FEC, cut to 8 chunks a stream; every stream
     complete and exact after ARQ), the demo (examples/demo.py at 6,000 B,
     payload match) in a temporary directory; then kernels A, B, C and the
     streaming demod against their plain versions on the first input of
     each shape these runs gave them (phase 20's checks; on the lossy
     soak's frames, noisy by design, B may flip at most 2 points a frame,
     each within 1e-4 of the frame's rms point magnitude of a decision
     boundary in the plain version)
 24. the bench (audio_modem_tpu_torch.bench.run, the counterpart of the
     root bench.py) in this process at its default sizes, launch counts
     from zero, its details file in a temporary directory: no stage skipped
     or failed, its headline the four-key line; the headline, the
     batch4096, frame_demod, long-frame, device-ingest and per-mode rates,
     the roofline shares and the bench's wall on one line. Then the
     kernels against their plain versions on the first input of each shape
     (and mode) the bench gave them: kernel A at 512 rows in each of the
     six modes and at 4096 rows by phase 4's checks and bit for bit on
     every symbol that carries signal (the plain version in slices of 512
     rows), at 64 rows by phase 17's; kernel B bit for bit, on the long
     BPSK-NARROW and 32 KB QPSK frames too; the streaming demod by phase
     20's rule
 25. the JAX package's test contract (tests/test_torch_roundtrip.py,
     test_torch_edge_cases.py, test_torch_decoder.py) on the card, each
     decode with launch counts from zero and its result equal to the
     port's own CPU decode of the same host audio (every field of the
     frame, preamble_idx, fine_metric within 1e-5), kernel A launched at
     least once a decode and the streaming demod only where the decode went
     on to a chunk frame: the five golden WAVs of tests/golden (the
     manifest's file name and sha256); BASELINE config 1 (1 KB, one
     BPSK-NARROW frame from the card's TX, clean); config 4 (2,000 bytes of
     16-QAM through echoes, gain, DC and AWGN, as its CPU test makes it)
     exact at 28 and 22 dB, failing its CRC at 18 dB; one byte; an empty
     file ("Invalid data length"); 205, 410 and 1,025-byte payloads that
     fill their symbols; 200, 253 and 300-byte names (the last collides
     with a frame magic); a frame behind a lag-periodic decoy, through
     api.decode and decoder.decode_raw (the scan's resume); a preamble cut
     off at the end of its padded bucket (QPSK, BPSK-NARROW); silence and
     noise ("Preamble not detected"); two-chunk
     transfers in 16-QAM, BPSK-REPEAT and 64-QAM through
     api.decode_chunked (once a frame). Then kernel A (phase 17's checks,
     the decoy's resume with min_pos > 0 among them) and the streaming demod
     (phase 20's rule) against their plain versions on every input of those
     decodes, the phase's wall, and the host wall of api.decode for config
     1 and config 4 at 28 dB through kernel A and through decode_long_fused
     (median of 10 a route, in turns)
 26. kernel C against its plain version on edge inputs at full width, in
     both branches: phase 3's 64 x 32 QPSK windows with slot 5's frame
     zeroed (exact DC removal: flags drop from slot 5 on, slot 6 finds its
     frame from slot 5's start), predictions clamped at w - 1 and at 0 (a
     silent row), BPSK-REPEAT at its 512-byte chunks (64 x 8, the vote;
     every slot CRC-valid, in sequence), K = 1; start, flags and heads
     equal on every slot, fine within 1e-5, payload equal on detected slots

then the kernels as one JSON line (time, plain time, launches summed over
the paths of phases 6, 9, 12, 13, 15 and 17-25, each counted from zero
(kernel A's on the decode path of phases 9, 19, 20 and 25 among them;
the tail's on the decode path of phases 9 and 17-25, its error the largest
|H| difference on the inputs that path_inputs kept)
(kernel C's time and bound: every slot predicted, phase 7),
the bound: bytes over the card's memory rate or float32 operations over
its float32 peak, whichever is larger, from this run's shapes, each DFT
counted at the cost of a real-input FFT; audio_modem_tpu_torch/roofline.py
holds the peaks and the work models), and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero. There is no
CPU fallback: without a CUDA device the script stops before any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_STREAMS = 64
K = 32
SEED = 0
# Kernel B on noisy frames: flipped points a frame, and their largest distance from a
# decision boundary in the plain version, over the frame's rms point magnitude.
B_FLIPS_A_FRAME = 2
B_BOUNDARY = 1e-4
PATH_ERR_C = [0.0]  # kernel C's largest fine-metric error on the inputs that path_inputs kept
PATH_ERR_TAIL = [0.0]  # the tail's largest |H| error on the inputs that path_inputs kept


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def launch_split(fn, reps: int = 5) -> list[tuple[str, float]]:
    """(kernel name, device ms per call) of every kernel ``fn`` launches,
    from torch.profiler over ``reps`` calls after one warm call; empty
    where the profiler sees no device time."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            name = re.search(r"\w+_kernel", ev.key)
            rows.append((name.group(0) if name else ev.key[:60], ev.self_device_time_total / reps / 1e3))
    return sorted(rows, key=lambda r: -r[1])


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def turbo_windows(dev, rng):
    """BASELINE config 5's slot-0 input, as the bench's headline builds it:
    64 streams x 32 QPSK data frames (2048-byte chunks) synthesized on
    ``dev`` and cut into [64, 914,688] windows. Returns (mode, frames
    [64 * 32, cadence], windows, n_valid, min_pos, n_sym, cadence)."""
    import torch

    from audio_modem_tpu_torch import MODES, bench

    mode = MODES["QPSK"]
    u8 = bench.turbo_payloads(rng, N_STREAMS, K, mode.chunk_size)
    windows, cadence, n_sym = bench.turbo_windows(u8, mode, N_STREAMS, K, dev)
    frames = windows[:, : K * cadence].reshape(N_STREAMS * K, cadence)
    n_valid = torch.full((N_STREAMS,), K * cadence, dtype=torch.int32, device=dev)
    min_pos = torch.zeros(N_STREAMS, dtype=torch.int32, device=dev)
    return mode, frames, windows, n_valid, min_pos, n_sym, cadence


def config2_signal(dev):
    """BASELINE config 2 on ``dev``: a seeded 32,736-byte file as one
    BPSK-REPEAT legacy frame of 7,906,500 samples under 12 dB AWGN from a
    seeded torch.Generator. Returns (mode, file bytes, noisy signal)."""
    import numpy as np
    import torch

    from audio_modem_tpu_torch import MODES, api, channel

    mode = MODES["BPSK-REPEAT"]
    data = np.random.default_rng(SEED + 2).bytes(32 * 1024 - 32)
    sigs = api.encode(data, mode, "big.bin", device=dev)
    if len(sigs) != 1 or sigs[0].shape[0] != 7_906_500:
        fail(f"config 2 TX: {len(sigs)} frames of {[int(x.shape[0]) for x in sigs]} samples")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return mode, data, channel.apply_channel(sigs[0], channel.ChannelSpec(snr_db=12.0), gen)


@contextlib.contextmanager
def receiver_stages():
    """A StageTimer over the streaming receiver while the block runs. Stages,
    on the host's clock (each ends in a copy back to the host, so device
    time is inside): ``scan``, ``refine`` and ``frame`` are the receiver's
    three state handlers; ``scan_call``, ``refine_call`` count the device
    calls inside the first two (their time is the enqueue alone);
    ``assembler`` is the chunk store inside ``frame``."""
    from audio_modem_tpu_torch.runtime import assembler, receiver
    from audio_modem_tpu_torch.utils.trace import StageTimer

    timer = StageTimer()
    patched = []

    def wrap(owner, attr: str, stage: str) -> None:
        inner = getattr(owner, attr)

        def timed(*args, **kw):
            with timer.stage(stage):
                return inner(*args, **kw)

        patched.append((owner, attr, inner))
        setattr(owner, attr, timed)

    wrap(receiver.StreamingReceiver, "_scan", "scan")
    wrap(receiver.StreamingReceiver, "_refine", "refine")
    wrap(receiver.StreamingReceiver, "_demodulate_frame", "frame")
    wrap(receiver, "_scan_window", "scan_call")
    wrap(receiver, "_refine_window", "refine_call")
    wrap(assembler.ChunkAssembler, "handle_metadata", "assembler")
    wrap(assembler.ChunkAssembler, "handle_data_chunk", "assembler")
    try:
        yield timer
    finally:
        for owner, attr, inner in reversed(patched):
            setattr(owner, attr, inner)


def chunked_frames(data: bytes, mode_name: str, file_name: str, dev) -> list:
    """The frames of a chunked transmission, synthesized on ``dev`` and
    brought to the host as the float32 audio a sound card would deliver."""
    from audio_modem_tpu_torch import api

    return [f.cpu().numpy() for f in api.encode_chunked(data, mode_name, file_name, device=dev)]


def stage_split(timer, wall_s: float) -> dict:
    """Seconds and ms per call of the receiver's stages from a
    ``receiver_stages`` timer, and what is left of ``wall_s`` (ingest: DC
    removal, ring writes, the FSM)."""
    sec, calls = timer.seconds, timer.calls
    frame = sec["frame"] - sec["assembler"]

    def per(seconds: float, n: int) -> float:
        return seconds / n * 1e3 if n else 0.0

    return {
        "scan_s": sec["scan"], "scan_calls": calls["scan_call"], "scan_ms": per(sec["scan"], calls["scan_call"]),
        "refine_s": sec["refine"], "refine_calls": calls["refine_call"],
        "refine_ms": per(sec["refine"], calls["refine_call"]),
        "frame_s": frame, "frame_calls": calls["frame"], "frame_ms": per(frame, calls["frame"]),
        "assembler_s": sec["assembler"],
        "ingest_s": wall_s - sec["scan"] - sec["refine"] - sec["frame"],
    }


def chunked_receive(label: str, data: bytes, mode_name: str, signal, dev, runs: int) -> tuple[dict, str]:
    """``api.decode_chunked`` of ``signal`` on ``dev``, ``runs`` times, launch
    counts from zero each time: the file must come back complete and exact
    with ``stream_demod`` launched at least once per frame and
    ``stream_scan`` once per scan window. Returns (``launch_counts()`` of
    the last run, a report line)."""
    from audio_modem_tpu_torch import MODES, api
    from audio_modem_tpu_torch.configs import SAMPLE_RATE
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts

    chunk = MODES[mode_name].chunk_size
    total = -(-len(data) // chunk)
    walls = []
    for _ in range(runs):
        reset_launch_counts()
        with receiver_stages() as timer:
            t0 = time.perf_counter()
            res = api.decode_chunked(signal, mode_name, device=dev)
            walls.append(time.perf_counter() - t0)
        counts = launch_counts()
        if not isinstance(res, api.ChunkedDecodeResult):
            fail(f"{label}: decode_chunked gave {getattr(res, 'error', res)}")
        if not (res.complete and res.total_chunks == total and res.received_chunks == total
                and res.missing_chunks == [] and res.crc_errors == 0):
            fail(f"{label}: {res.received_chunks} of {res.total_chunks} chunks, missing "
                 f"{res.missing_chunks[:8]}, {res.crc_errors} CRC errors")
        if res.data != data:
            fail(f"{label}: the assembled file differs from what was sent")
        if counts["stream_demod"] < total + 1:
            fail(f"{label}: {total + 1} frames but stream_demod launched {counts['stream_demod']} times")
        if counts["stream_scan"] != timer.calls["scan_call"]:
            fail(f"{label}: {timer.calls['scan_call']} scan windows but stream_scan launched "
                 f"{counts['stream_scan']} times")
    wall = walls[-1]
    split = stage_split(timer, wall)
    n = len(signal)
    line = (f"{n} samples ({n / SAMPLE_RATE:.1f} s of audio) -> {len(data)} exact bytes in {total} chunks, none "
            f"missing, 0 CRC errors; launches {counts}; wall {wall:.3f} s (runs "
            f"{', '.join(f'{w:.3f}' for w in walls)}) = {n / wall / 1e6:.3f} Msamples/s = "
            f"{n / SAMPLE_RATE / wall:.1f}x real time; host clock: scan {split['scan_s']:.3f} s in "
            f"{split['scan_calls']} calls ({split['scan_ms']:.3f} ms each), refine {split['refine_s']:.3f} s in "
            f"{split['refine_calls']} ({split['refine_ms']:.3f} ms), frame decode {split['frame_s']:.3f} s in "
            f"{split['frame_calls']} ({split['frame_ms']:.3f} ms), assembler {split['assembler_s']:.3f} s, "
            f"ingest {split['ingest_s']:.3f} s")
    return counts, line


def resume_receive(data: bytes, frames: list, mode_name: str, dev) -> str:
    """Persist and resume: the metadata frame and the first half of the data
    frames into a receiver with a sqlite store; a second receiver with
    ``resume=True`` on the same store takes a replayed metadata frame and
    the other half. Returns a report line."""
    import numpy as np

    from audio_modem_tpu_torch import MODES
    from audio_modem_tpu_torch.runtime.receiver import StreamingReceiver

    mode = MODES[mode_name]
    half = 1 + (len(frames) - 1) // 2

    def feed(rx, signal) -> None:
        for off in range(0, len(signal), 4096):
            rx.process_audio_block(signal[off : off + 4096])
        rx.flush()

    with tempfile.TemporaryDirectory() as tmp:
        db = str(Path(tmp) / "chunks.db")
        rx1 = StreamingReceiver(mode, persist_path=db, device=dev)
        feed(rx1, np.concatenate(frames[:half]))
        stored = rx1.assembler.received_count
        rx1.cleanup()
        if stored != half - 1:
            fail(f"persist: {stored} chunks stored of the first {half - 1}")
        rx2 = StreamingReceiver(mode, persist_path=db, resume=True, device=dev)
        resumed = rx2.assembler.received_count
        if resumed != stored:
            fail(f"resume: the store gave back {resumed} chunks of {stored}")
        feed(rx2, np.concatenate([frames[0]] + frames[half:]))
        asm = rx2.assembler
        ok = asm.is_complete and asm.crc_errors == 0 and asm.assemble() == data
        size = Path(db).stat().st_size
        rx2.cleanup()
        if not ok:
            fail(f"resume: {asm.received_count} of {asm.total_chunks} chunks, file differs or incomplete")
    return (f"{stored} chunks persisted by the first receiver, {resumed} found by the second "
            f"(resume=True), {len(frames) - half} more received; the assembled {len(data)} bytes are exact "
            f"(sqlite store {size} bytes)")


def ring_rounds(dev, mode, frames, n_sym: int, cadence: int, block: int = 65536) -> tuple[Counter, str]:
    """Two rounds out of a DeviceRing. ``frames`` [n * K, cadence] are K data
    frames per stream; stream i is delayed by 16 * (i % 8) samples and sends
    its K frames twice. After a quiet lead-in that makes the ring's write
    position wrap, everything is written in blocks. Kernel C launches once a
    round. Returns (the two rounds' launches, a report line)."""
    import numpy as np
    import torch

    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    n, k = N_STREAMS, K
    sym = mode.profile.symbol_len
    w = -(-(k * cadence + 4 * sym + mode.profile.fft_size + 2048) // 128) * 128
    leads = [16 * (i % 8) for i in range(n)]
    lead_in = w // 2
    length = lead_in + max(leads) + k * cadence + w
    stream = torch.zeros((n, length), dtype=torch.float32, device=dev)
    twice = frames.reshape(n, k * cadence).repeat(1, 2)
    for i, lead in enumerate(leads):
        stream[i, lead_in + lead : lead_in + lead + 2 * k * cadence] = twice[i]
    ring = mr.DeviceRing(n, 2 * w, device=dev)
    for off in range(0, length, block):
        ring.write(stream[:, off : off + block])
    if not ring.total_written == length > ring.capacity:
        fail(f"device ring: wrote {ring.total_written} of {length} samples into {ring.capacity}")

    def windows_at(base: int) -> torch.Tensor:
        return stream[:, base : base + w].contiguous()

    def check(label: str, packed: torch.Tensor) -> np.ndarray:
        cls = mr._classify_round(packed.cpu().numpy(), mode.chunk_size)
        if cls is None:
            fail(f"{label}: packed rows too narrow")
        det, starts, full, seq = cls
        if not (det.all() and full.all() and (seq == np.arange(k)[None, :]).all()):
            fail(f"{label}: {int((~det).sum())} slots not detected, {int((~full).sum())} not CRC-valid, "
                 f"or out of sequence")
        return starts

    # round 1: slot 0 scanned
    g1 = lead_in
    n_valid = np.full(n, w, np.int32)
    params1 = np.stack([np.full(n, ring.rel(g1), np.int32), np.zeros(n, np.int32), n_valid])
    reset_launch_counts()
    packed1 = mr._batch_window_decode_multi_dev(ring, params1, mode, n_sym, k, cadence, w)
    l1 = launch_counts()
    c1 = l1["decode_fused"]
    starts1 = check("device ring round 1", packed1)
    dev1 = torch.from_numpy(params1).to(dev)
    direct = mr._batch_window_decode_multi(windows_at(g1), dev1[1], dev1[2], mode, n_sym, k, cadence)
    if not torch.equal(packed1, direct):
        fail("device ring round 1 differs from _batch_window_decode_multi on the same windows")
    # round 2: the next window, every slot predicted
    g2 = g1 + k * cadence
    pred0 = (starts1[:, -1] + cadence - k * cadence).astype(np.int32)
    params2 = np.stack([np.full(n, ring.rel(g2), np.int32), pred0, n_valid])
    reset_launch_counts()
    packed2 = mr._batch_window_decode_pred_dev(ring, params2, mode, n_sym, k, cadence, w)
    l2 = launch_counts()
    c2 = l2["decode_fused"]
    starts2 = check("device ring round 2", packed2)
    if not np.array_equal(starts2, starts1):
        fail("device ring round 2: the repeated frames were found at other window positions than round 1's")
    wraps = (ring.total_written + ring.rel(g2)) % ring.capacity + w > ring.capacity
    if c1 < 1 or c2 != 0:
        fail(f"device ring: decode_fused launched {c1} times in round 1 and {c2} in round 2")
    if l1["decode_predicted"] != 1 or l2["decode_predicted"] != 1:
        fail(f"device ring: decode_predicted launched {l1['decode_predicted']} and {l2['decode_predicted']} times, "
             "not once a round")
    t1 = time_ms(lambda: mr._batch_window_decode_multi_dev(ring, params1, mode, n_sym, k, cadence, w), reps=5, warm=1)
    t2 = time_ms(lambda: mr._batch_window_decode_pred_dev(ring, params2, mode, n_sym, k, cadence, w), reps=5, warm=1)
    t_gather = time_ms(lambda: mr._ring_gather(ring, range(n), params2[0].tolist(), w))
    blk = stream[:, :block].contiguous()
    t_write = time_ms(lambda: ring.write(blk))  # last: the writes move the ring on
    msps = k * cadence * n / 1e3
    return Counter(l1) + Counter(l2), (f"ring [{n}, {ring.capacity}] written in blocks of {block} ({length} samples a stream, write "
                f"position wrapped; round 2's windows {'cross' if wraps else 'do not cross'} the buffer's end); "
                f"round 1 (_batch_window_decode_multi_dev) equals _batch_window_decode_multi on the same windows, "
                f"round 2 (_batch_window_decode_pred_dev) predicted from round 1's last start + cadence; "
                f"{n} x {k} slots of each detected, CRC-valid, in sequence; decode_fused launches {c1} and {c2}, "
                f"decode_predicted {l1['decode_predicted']} and {l2['decode_predicted']}; "
                f"round 1 {t1:.3f} ms = {msps / t1:.1f} Msamples/s, round 2 {t2:.3f} ms = {msps / t2:.1f} "
                f"Msamples/s; window gather {t_gather:.3f} ms, block write {t_write:.4f} ms")


STREAM_BLOCK = 65536  # BatchReceiver's lockstep block and scan bucket in phases 17-18


def config5_signal(n_chunks: int, seed: int, dev):
    """A seeded file of ``n_chunks`` 2048-byte chunks as one QPSK chunked
    transmission synthesized on ``dev``: (file bytes, signal on ``dev``)."""
    import numpy as np
    import torch

    from audio_modem_tpu_torch import MODES, api

    data = np.random.default_rng(seed).bytes(MODES["QPSK"].chunk_size * n_chunks)
    return data, torch.cat(list(api.encode_chunked(data, "QPSK", "b.bin", device=dev)))


def feed_batch(rx, blocks) -> float:
    """Every block into ``rx``, then ``flush``; returns the host wall in s."""
    import torch

    t0 = time.perf_counter()
    for b in blocks:
        rx.process_blocks(b)
    rx.flush()
    if rx.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_batch(label: str, rx, want: list) -> None:
    """Every stream of ``rx`` complete with the bytes ``want[i]``."""
    for i, r in enumerate(rx.results()):
        if not (r["complete"] and r["data"] == want[i]):
            fail(f"{label}: stream {i} {'exact' if r['data'] == want[i] else 'differs'}, missing "
                 f"{r['missing'][:8]}, {r['stats']}")


@contextlib.contextmanager
def path_inputs(store: dict, tag: str, shards: int = 1, by_mode: bool = False):
    """While the block runs, keep a copy of the first input of each shape
    that the batched path hands kernels A and B (``batch.decode_fused`` and
    ``batch.decode_chunks_fused``), that the turbo round hands kernel C
    (``multi_receiver.decode_predicted``; its shape carries K and the
    branch), that the decoder's device core hands kernel A
    (``decoder.decode_fused``, B = 1; tagged "``tag`` decoder", and
    "``tag`` decoder resume" for a try with min_pos > 0), that the decoder
    hands its tail after that try (``decoder.decode_tail``, under the try's
    tag; its shape carries n_active, its symbols are the repetition) and
    that the decoder hands the streaming demod (``decoder.stream_demod``, and
    ``receive.stream_demod``), each looked up at call time, in ``store``,
    keyed by (kernel, tag, shape, symbols). The kernels run as they would;
    ``check_path_inputs`` holds them to their plain versions afterwards.
    With ``shards`` > 1 (a receiver sharded over a mesh, whose rounds call
    kernel A once a shard, in shard order) kernel A's inputs are kept per
    shard: the tag of the k-th call of a shape is "``tag`` shard k % shards",
    and so are kernel C's.
    With ``by_mode`` the mode's name follows the tag, so modes whose inputs
    share a shape are each kept."""
    from audio_modem_tpu_torch import decoder
    from audio_modem_tpu_torch.kernels import receive
    from audio_modem_tpu_torch.parallel import batch, multi_receiver

    real_a, real_b, real_s = batch.decode_fused, batch.decode_chunks_fused, receive.stream_demod
    real_c, real_d, real_t = multi_receiver.decode_predicted, decoder.decode_fused, decoder.decode_tail
    calls_a: Counter = Counter()
    calls_c: Counter = Counter()
    last_try = [""]  # the tag of the decoder's last kernel A try, which its tail follows

    def tag_of(mode) -> str:
        return f"{tag} {mode.name}" if by_mode else tag

    def record_a(signals, n_valid, min_pos, mode, max_syms):
        shard = calls_a[tuple(signals.shape)] % shards
        calls_a[tuple(signals.shape)] += 1
        key = ("decode_fused", f"{tag_of(mode)} shard {shard}" if shards > 1 else tag_of(mode),
               tuple(signals.shape), max_syms)
        if key not in store:
            store[key] = (signals.clone(), n_valid.clone(), min_pos.clone(), mode)
        return real_a(signals, n_valid, min_pos, mode, max_syms)

    def record_d(signals, n_valid, min_pos, mode, max_syms):
        resume = " resume" if bool((min_pos > 0).any()) else ""
        key = ("decode_fused", f"{tag_of(mode)} decoder{resume}", tuple(signals.shape), max_syms)
        last_try[0] = key[1]
        if key not in store:
            store[key] = (signals.clone(), n_valid.clone(), min_pos.clone(), mode)
        return real_d(signals, n_valid, min_pos, mode, max_syms)

    def record_t(coarse, start, fine_metric, bits, ch_re, ch_im, repetition):
        key = ("decode_tail", last_try[0], (*bits.shape, ch_re.shape[1]), repetition)
        if key not in store:
            store[key] = (*(t.clone() for t in (coarse, start, fine_metric, bits, ch_re, ch_im)), repetition)
        return real_t(coarse, start, fine_metric, bits, ch_re, ch_im, repetition)

    def record_c(windows, n_valid, start0, ok0, mode, n_sym, k, cadence, bits0=None):
        shape = (*windows.shape, k, "predicted" if bits0 is None else "scanned")
        shard = calls_c[shape] % shards
        calls_c[shape] += 1
        key = ("decode_predicted", f"{tag_of(mode)} shard {shard}" if shards > 1 else tag_of(mode), shape, n_sym)
        if key not in store:
            store[key] = (windows.clone(), n_valid.clone(), start0.clone(), ok0.clone(), mode, k, cadence,
                          None if bits0 is None else bits0.clone())
        return real_c(windows, n_valid, start0, ok0, mode, n_sym, k, cadence, bits0)

    def record_b(frames, mode, n_sym):
        key = ("decode_chunks_fused", tag_of(mode), tuple(frames.shape), n_sym)
        if key not in store:
            store[key] = (frames.clone(), mode)
        return real_b(frames, mode, n_sym)

    def record_s(data, ch_re, ch_im, scale, mode, n_sym):
        key = ("stream_demod", tag_of(mode), tuple(data.shape), n_sym)
        if key not in store:
            store[key] = (data.clone(), ch_re.clone(), ch_im.clone(), scale.clone(), mode)
        return real_s(data, ch_re, ch_im, scale, mode, n_sym)

    batch.decode_fused, batch.decode_chunks_fused = record_a, record_b
    receive.stream_demod = decoder.stream_demod = record_s
    multi_receiver.decode_predicted, decoder.decode_fused, decoder.decode_tail = record_c, record_d, record_t
    try:
        yield store
    finally:
        batch.decode_fused, batch.decode_chunks_fused = real_a, real_b
        receive.stream_demod = decoder.stream_demod = real_s
        multi_receiver.decode_predicted, decoder.decode_fused, decoder.decode_tail = real_c, real_d, real_t


def b_points(frames, mode, n_sym: int) -> tuple:
    """Kernel B's plain version (``receive.decode_chunks_fused_reference``)
    up to its demap: the pilot-corrected, equalized data points (re, im),
    each [B, n_sym, data bins]."""
    import torch

    from audio_modem_tpu_torch import phy

    p = mode.profile
    sym, need = p.symbol_len, (3 + n_sym) * p.symbol_len
    mx = frames.abs().amax(dim=-1, keepdim=True)
    big = mx > 1e-6
    frames = torch.where(big, frames / torch.where(big, mx, 1.0), frames)
    frames = torch.nn.functional.pad(frames, (0, max(need - frames.shape[1], 0)))
    ch_re, ch_im = phy.estimate_channel(frames[:, 2 * sym : 3 * sym], p)
    return phy._corrected_data(frames[:, 3 * sym : need].reshape(-1, n_sym, sym), ch_re, ch_im, p)


def boundary_margin(name: str, re, im):
    """Distance of each point to the nearest decision boundary of the hard
    demap (``ops.constellations.demap``): 0 on each axis for BPSK (re only)
    and QPSK, the midpoints between levels for square QAM."""
    import torch

    from audio_modem_tpu_torch.ops.constellations import CONSTELLATIONS, qam_scale

    if name in ("BPSK", "QPSK"):
        bounds = torch.zeros(1, device=re.device)
    else:
        top = (1 << (CONSTELLATIONS[name].bps // 2)) - 1
        bounds = qam_scale(name) * (2 * torch.arange(top, device=re.device) + 1 - top)
    axes = (re,) if name == "BPSK" else (re, im)
    return torch.stack([(x[..., None] - bounds).abs().amin(-1) for x in axes]).amin(0)


def signal_symbols(sig, start, n_valid, mode, n_sym: int):
    """[B, n_sym] True where kernel A's k-th data symbol of a row (at start
    + (3 + k) * symbol_len) lies inside n_valid and its samples are not all
    equal. The others are junk: the front end turns a constant stretch
    (silence) into a constant, whose data bins hold rounding residue."""
    import torch

    sym = mode.profile.symbol_len
    pos = start.to(torch.int64)[:, None] + (3 + torch.arange(n_sym, device=sig.device)) * sym  # [B, n_sym]
    inside = pos + sym <= n_valid.to(torch.int64)[:, None]
    idx = torch.clamp(pos[..., None] + torch.arange(sym, device=sig.device), max=sig.shape[1] - 1)
    x = torch.gather(sig, 1, idx.reshape(sig.shape[0], -1)).reshape(*idx.shape)
    return inside & ~(x == x[..., :1]).all(-1)


def plain_receive(sig, n_valid, min_pos, mode, max_syms: int, rows: int = 512) -> dict:
    """Kernel A's plain version (``receive.decode_fused_reference``) in
    slices of ``rows`` rows, which are independent; the slices' outputs
    concatenated."""
    import torch

    from audio_modem_tpu_torch.kernels import receive

    parts = [receive.decode_fused_reference(sig[i : i + rows], n_valid[i : i + rows], min_pos[i : i + rows], mode,
                                            max_syms) for i in range(0, sig.shape[0], rows)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def check_path_inputs(label: str, store: dict, noisy: tuple = (), clean: tuple = (),
                      stream_errs: "list | None" = None) -> tuple[float, str]:
    """Kernels A, B and C, the decoder's tail and the streaming demod against
    their plain versions on every input that ``path_inputs`` kept: A by
    ``compare_receive(by_frame=True)``, C by ``compare_predicted(strict=False)``,
    B by equal bits over the frame's symbols, the tail by equal rows bit for
    bit (``torch.equal``, on the same card tensors; its largest |H| error to
    ``PATH_ERR_TAIL``), the streaming demod by equal bits over its whole output. Under
    a tag in ``noisy`` (frames through a noisy channel, whose points may sit
    on a decision boundary, where the kernel's and cuBLAS's summation orders
    round apart) B may flip the bits of at most ``B_FLIPS_A_FRAME`` points a
    frame, and only of a point whose plain equalized value lies within
    ``B_BOUNDARY`` of the frame's rms point magnitude from a decision
    boundary (``b_points``). Under a tag in ``clean`` (noiseless frames)
    A is held bit for bit as well, on every detected row's symbols that
    carry signal (``signal_symbols``); flips in its junk symbols are
    reported. The streaming demod's largest bit difference on the symbols
    that carry signal goes to ``stream_errs``, one entry an input, where a
    list is given; kernel C's largest fine error to ``PATH_ERR_C``. Returns
    (kernel A's largest fine or channel error, a report)."""
    import torch

    from audio_modem_tpu_torch.kernels import receive
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol, demap

    err, parts = 0.0, []
    for (name, tag, shape, n_sym), args in store.items():
        count = {"decode_fused": "max_syms", "decode_tail": "repetition"}.get(name, "n_sym")
        where = f"{list(shape)} {count} {n_sym} ({tag})"
        if name == "decode_fused":
            sig, n_valid, min_pos, mode = args
            out = receive.decode_fused(sig, n_valid, min_pos, mode, n_sym)
            ref = plain_receive(sig, n_valid, min_pos, mode, n_sym)
            e_fine, e_ch, flips, n_in, by_kind = compare_receive(
                f"{label}: kernel A at {where}", out, ref, n_valid, mode, by_frame=True)
            err = max(err, e_fine, e_ch)
            exact = ""
            if tag in clean:
                n_max = out["bits"].shape[1] // bits_per_symbol(mode)
                carry = signal_symbols(sig, out["start"], n_valid, mode, n_max) & out["detected"][:, None]
                flipped = (out["bits"] != ref["bits"]).reshape(shape[0], n_max, -1)
                in_sig, junk = int(flipped[carry].sum().item()), int(flipped[~carry].sum().item())
                if in_sig:
                    fail(f"{label}: kernel A at {where} flips {in_sig} bits in symbols that carry signal")
                exact = (f"; on clean frames: 0 of {int(flipped[carry].numel())} bits flipped in the "
                         f"{int(carry.sum().item())} detected symbols that carry signal, {junk} in junk symbols "
                         f"(constant, or past n_valid)")
            parts.append(f"A at {where}: {int(out['detected'].sum())} of {shape[0]} detected, every detected "
                         f"row parses as the plain version's, fine err {e_fine:.3e}, ch err {e_ch:.3e}, flipped "
                         f"bits {flips} of {n_in} ({by_kind}){exact}")
        elif name == "decode_predicted":
            windows, n_valid, start0, ok0, mode, k, cadence, bits0 = args
            out = receive.decode_predicted(windows, n_valid, start0, ok0, mode, n_sym, k, cadence, bits0)
            ref = receive.decode_predicted_reference(windows, n_valid, start0, ok0, mode, n_sym, k, cadence, bits0)
            e_fine, rep = compare_predicted(f"{label}: kernel C at {where}", out, ref, strict=False)
            PATH_ERR_C[0] = max(PATH_ERR_C[0], e_fine)
            parts.append(f"C at {where}: {rep}")
        elif name == "decode_tail":
            out = receive.decode_tail(*args)
            ref = receive.decode_tail_reference(*args)
            mag = slice(receive.TAIL_HEAD, receive.TAIL_HEAD + 4 * shape[2])
            e_mag = float((out[:, mag].contiguous().view(torch.float32)
                           - ref[:, mag].contiguous().view(torch.float32)).abs().max().item())
            if out.shape != ref.shape or not torch.equal(out, ref):
                bad = int((out != ref).sum().item()) if out.shape == ref.shape else -1
                fail(f"{label}: decode_tail at {where} differs from its plain version in {bad} bytes of "
                     f"{ref.numel()} (|H| err {e_mag:.3e})")
            PATH_ERR_TAIL[0] = max(PATH_ERR_TAIL[0], e_mag)
            n_bytes = shape[1] // n_sym // 8
            parts.append(f"tail at {where}: {shape[0]} row(s) of {ref.shape[1]} bytes equal bit for bit (head, "
                         f"|H| of {shape[2]} bins, {n_bytes} voted bytes; {int((args[0] >= 0).sum().item())} "
                         f"detected)")
        elif name == "stream_demod":
            data, ch_re, ch_im, scale, mode = args
            out = receive.stream_demod(data, ch_re, ch_im, scale, mode, n_sym)
            ref = receive.stream_demod_reference(data, ch_re, ch_im, scale, mode, n_sym)
            # Every symbol that carries signal must give equal bits. The others are junk that no
            # caller reads, as phase 9 leaves them out: a symbol that reaches into the zeros past
            # the signal's end (the front end zeroes samples past n_valid; a frame is padded with
            # zeros), or whose samples are all equal (silence after the DC removal). Their data
            # bins hold rounding residue, so a decision there is a tie that rounding breaks.
            sym = mode.profile.symbol_len
            x = torch.nn.functional.pad(data[:, : n_sym * sym], (0, max(n_sym * sym - data.shape[1], 0)))
            ends = torch.arange(1, x.shape[1] + 1, device=x.device) * (x != 0)
            inside = torch.arange(1, n_sym + 1, device=x.device) * sym <= ends.amax(-1, keepdim=True)
            x = x.reshape(shape[0], n_sym, sym)
            carry = inside & ~(x == x[..., :1]).all(-1)
            flipped = (out != ref).reshape(shape[0], n_sym, -1)
            flips, junk = int(flipped[carry].sum().item()), int(flipped[~carry].sum().item())
            if flips or out.shape != ref.shape:
                fail(f"{label}: stream_demod at {where} flips {flips} bits against its plain version")
            if stream_errs is not None:
                stream_errs.append(float(flipped[carry].any().item()))
            parts.append(f"stream_demod at {where} {mode.name}: flipped bits {flips} of "
                         f"{int(flipped[carry].numel())} in the {int(carry.sum().item())} symbols that carry "
                         f"signal; {junk} of {int(flipped[~carry].numel())} in {int((~carry).sum().item())} junk "
                         f"symbols (constant, or past the signal's end)")
        else:
            frames, mode = args
            nb = n_sym * bits_per_symbol(mode)
            out = receive.decode_chunks_fused(frames, mode, n_sym)[:, :nb].to(torch.int32)
            ref = receive.decode_chunks_fused_reference(frames, mode, n_sym)[:, :nb].to(torch.int32)
            flips = int((out != ref).sum().item())
            if flips and tag not in noisy:
                fail(f"{label}: kernel B at {where} flips {flips} bits against its plain version")
            near = ""
            if flips:
                re, im = b_points(frames, mode, n_sym)
                if not torch.equal(demap(mode.constellation, re, im).reshape(shape[0], -1).to(torch.int32), ref):
                    fail(f"{label}: b_points at {where} does not demap to kernel B's plain version")
                per_point = (out != ref).reshape(*re.shape, -1).any(-1)  # [B, n_sym, nd]
                rel = boundary_margin(mode.constellation, re, im) / torch.sqrt(
                    (re * re + im * im).mean((1, 2), keepdim=True))
                worst = float(rel[per_point].max().item())
                most = int(per_point.sum((1, 2)).max().item())
                if most > B_FLIPS_A_FRAME or worst > B_BOUNDARY:
                    fail(f"{label}: kernel B at {where} flips {flips} bits in up to {most} points a frame, one "
                         f"{worst:.3e} x the frame's rms from a decision boundary (limits {B_FLIPS_A_FRAME} points, "
                         f"{B_BOUNDARY:.0e})")
                near = (f" in {int(per_point.sum().item())} point(s), at most {most} a frame, each within "
                        f"{worst:.3e} x the frame's rms point of a decision boundary in the plain version")
            parts.append(f"B at {where}: flipped bits {flips} of {out.numel()}{near}")
    return err, "; ".join(parts)


def receiver_state(rx) -> tuple:
    """What two receivers fed the same blocks must agree on: per stream the
    results, the counters, the final scan position, FSM state, speculation
    generation and bitmap; the stage call and sample counts."""
    import dataclasses

    streams = []
    for s, r in zip(rx.streams, rx.results()):
        stats = dataclasses.asdict(r["stats"])
        stats.pop("started_at")
        streams.append((r["complete"], r["data"], r["file_name"], tuple(r["missing"]), tuple(sorted(stats.items())),
                        s.scan_pos, s.state.name, s.gen, s.assembler.bitmap().tobytes()))
    return streams, {k: (v["calls"], v["samples"]) for k, v in rx.timer.report().items()}


def batch_receive_host(dev, n: int = N_STREAMS, n_chunks: int = 4, block: int = STREAM_BLOCK) -> tuple[Counter, str]:
    """Phase 17: ``n_chunks`` chunks a stream into ``n`` streams as host numpy
    blocks, through the staged machine and through the turbo machine
    (window_decode); a warm pass, then a timed one with launch counts from
    zero. Kernels A and B are held to their plain versions on the first input
    of each shape the warm passes gave them. Returns (launches of the timed
    passes, kernel A's largest fine or channel error, a report line)."""
    import numpy as np

    from audio_modem_tpu_torch import MODES
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver

    mode = MODES["QPSK"]
    data, sig = config5_signal(n_chunks, SEED + 17, dev)
    want = [data] * n
    host = sig.cpu().numpy()
    blocks = []
    for off in range(0, len(host), block):
        buf = np.zeros((n, block), np.float32)
        seg = host[off : off + block]
        buf[:, : len(seg)] = seg[None, :]
        blocks.append(buf)
    total = Counter()
    parts = []
    inputs: dict = {}
    for label, tag, kw in (("staged", "staged", {}), ("turbo (window_decode)", "turbo", {"window_decode": True})):
        warm = BatchReceiver(mode, n, scan_bucket=block, device=dev, **kw)
        with path_inputs(inputs, tag):
            feed_batch(warm, blocks)
        check_batch(f"host-fed {label}, warm pass", warm, want)
        reset_launch_counts()
        rx = BatchReceiver(mode, n, scan_bucket=block, device=dev, **kw)
        wall = feed_batch(rx, blocks)
        counts = launch_counts()
        check_batch(f"host-fed {label}", rx, want)
        if not kw and counts["decode_chunks_fused"] < 1:
            fail(f"host-fed staged: decode_chunks_fused never launched: {counts}")
        total.update(counts)
        parts.append(f"{label} wall {wall:.3f} s = {n * len(host) / wall / 1e6:.2f} Msamples/s, launches {counts}")
    if not {("decode_chunks_fused", "staged"), ("decode_fused", "turbo")} <= {k[:2] for k in inputs}:
        fail(f"host-fed: kernel inputs recorded only at {sorted(k[:3] for k in inputs)}")
    err, checked = check_path_inputs("host-fed", inputs)
    return total, err, (f"{n} streams x {len(host)} samples ({n_chunks} chunks + metadata, {len(blocks)} blocks of "
                        f"{block}) -> {n} exact files in each mode; " + "; ".join(parts)
                        + f"; against the plain versions at every shape of the warm passes: {checked}")


def stage_report(rep: dict) -> str:
    """``timer.report()`` as 'stage seconds/calls' pairs, largest first."""
    return ", ".join(f"{k} {v['seconds']:.4f} s/{v['calls']}"
                     for k, v in sorted(rep.items(), key=lambda kv: -kv[1]["seconds"]))


def config5_device_blocks(dev, n: int = N_STREAMS, n_chunks: int = 128, block: int = STREAM_BLOCK):
    """Phase 18's input: a seeded file of ``n_chunks`` chunks synthesized on
    ``dev``, cut into [n, block] blocks that broadcast the one signal to every
    stream (no copy per stream). Returns (file bytes, samples a stream,
    blocks)."""
    import torch

    data, sig = config5_signal(n_chunks, SEED + 18, dev)
    t = sig.shape[0]
    padded = torch.nn.functional.pad(sig, (0, -(-t // block) * block - t))
    return data, t, [padded[off : off + block].expand(n, block) for off in range(0, padded.shape[0], block)]


def config5_staggered_blocks(dev, n: int = N_STREAMS, n_files: int = 8, n_chunks: int = 64,
                             block: int = STREAM_BLOCK):
    """Streams whose rows differ: ``n_files`` seeded files of ``n_chunks``
    chunks synthesized on ``dev``; stream i carries file i % n_files behind
    3,001 * i samples of seeded noise at 0.002, so no two streams start
    together. Returns (each stream's file bytes, its lead, samples a stream,
    [n, block] blocks)."""
    import torch

    files = [config5_signal(n_chunks, SEED + 180 + j, dev) for j in range(n_files)]
    leads = [3001 * i for i in range(n)]
    t = max(lead + files[i % n_files][1].shape[0] for i, lead in enumerate(leads))
    rows = torch.zeros((n, -(-t // block) * block), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    for i, lead in enumerate(leads):
        sig = files[i % n_files][1]
        rows[i, :lead] = torch.randn(lead, generator=gen, device=dev) * 0.002
        rows[i, lead : lead + sig.shape[0]] = sig
    blocks = [rows[:, off : off + block] for off in range(0, rows.shape[1], block)]
    return [files[i % n_files][0] for i in range(n)], leads, t, blocks


def batch_receive_device(dev, n: int = N_STREAMS, n_chunks: int = 128, block: int = STREAM_BLOCK):
    """Phase 18: the device-ingest steady state. ``n_chunks`` chunks a stream,
    blocks cut on ``dev`` as broadcast slices of one signal, default K = 8;
    a warm pass, a timed pass at pipeline_depth 8 and one at depth 0, each
    with launch counts from zero. Then rows that differ
    (``config5_staggered_blocks``): a warm pass and a timed one, every
    stream's own file exact, and the ring's window cut for staggered rows
    timed beside the lockstep cut. Kernel C must launch once a K-round.
    Kernels A and C are held to their plain versions on the first input of
    each shape that the two warm passes gave them. Returns
    (launches of the timed passes, kernel A's largest fine or channel error,
    a report line, and depth 8's reference for phase 21: its wall, stage
    report, launches and ``receiver_state``)."""
    from audio_modem_tpu_torch import MODES
    from audio_modem_tpu_torch.configs import SAMPLE_RATE
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver, _ring_gather

    mode = MODES["QPSK"]
    data, t, blocks = config5_device_blocks(dev, n, n_chunks, block)
    want = [data] * n
    samples = n * t

    def receiver(depth: int):
        return BatchReceiver(mode, n, scan_bucket=block, device_ingest=True, pipeline_depth=depth, device=dev)

    inputs: dict = {}
    warm = receiver(8)
    with path_inputs(inputs, "broadcast"):
        feed_batch(warm, blocks)
    check_batch("device ingest, warm pass", warm, want)
    ring, k = tuple(warm.dring.buf.shape), warm.frames_per_round
    del warm
    total = Counter()
    walls = {}
    for depth in (8, 0):
        reset_launch_counts()
        rx = receiver(depth)
        walls[depth] = feed_batch(rx, blocks)
        counts = launch_counts()
        check_batch(f"device ingest, pipeline_depth {depth}", rx, want)
        rep = rx.timer.report()
        rounds = sum(rep.get(f"{st}_dispatch", {}).get("calls", 0) for st in ("multi", "pred"))
        if counts["decode_predicted"] != rounds or rounds < 1:
            fail(f"device ingest, pipeline_depth {depth}: decode_predicted launched {counts['decode_predicted']} "
                 f"times in {rounds} K-rounds")
        if depth:
            if counts["decode_fused"] < 1:
                fail(f"device ingest: decode_fused never launched: {counts}")
            pred = rep.get("pred_dispatch", {}).get("samples", 0)
            if pred < max(rep.get("multi_dispatch", {}).get("samples", 0), 1):
                fail(f"device ingest: predicted rounds carried {pred} samples, scanned rounds more: {rep}")
            if "pipe_fetch" not in rep:
                fail(f"device ingest: no speculative fetch at pipeline_depth 8: {rep}")
            rep8, counts8, state8 = rep, counts, receiver_state(rx)
        elif "pipe_fetch" in rep:
            fail("device ingest: a speculative fetch at pipeline_depth 0")
        total.update(counts)
        del rx
    del blocks
    # rows that differ: each stream its own file and start
    files, leads, t_s, blocks_s = config5_staggered_blocks(dev, n, block=block)
    warm = receiver(8)
    with path_inputs(inputs, "staggered"):
        feed_batch(warm, blocks_s)
    check_batch("device ingest, staggered rows, warm pass", warm, files)
    del warm
    reset_launch_counts()
    rx = receiver(8)
    wall_s = feed_batch(rx, blocks_s)
    counts_s = launch_counts()
    check_batch("device ingest, staggered rows", rx, files)
    if counts_s["decode_fused"] < 1:
        fail(f"device ingest, staggered rows: decode_fused never launched: {counts_s}")
    total.update(counts_s)
    rep_s = rx.timer.report()
    if not {("decode_fused", "broadcast"), ("decode_fused", "staggered"), ("decode_predicted", "broadcast"),
            ("decode_predicted", "staggered")} <= {k_[:2] for k_ in inputs}:
        fail(f"device ingest: kernel inputs recorded only at {sorted(k_[:3] for k_ in inputs)}")
    # the widest window kernel A was given: slot 0 of a scanned K-round
    w = max(k_[2][1] for k_ in inputs if k_[0] == "decode_fused")
    t_lock = time_ms(lambda: _ring_gather(rx.dring, range(n), [0] * n, w))
    t_stag = time_ms(lambda: _ring_gather(rx.dring, range(n), leads, w))
    del rx, blocks_s
    err, checked = check_path_inputs("device ingest", inputs)
    msps = samples / walls[8] / 1e6
    line = (f"{n} streams x {t} samples ({n_chunks} chunks + metadata, {t / SAMPLE_RATE:.1f} s of audio; {samples} "
            f"stream-samples; {-(-t // block)} broadcast blocks of {block}), ring {list(ring)}, K = {k}: {n} exact "
            f"files at pipeline_depth 8 and 0; depth 8 wall {walls[8]:.3f} s = "
            f"{msps:.2f} Msamples/s = {msps * 1e6 / SAMPLE_RATE:.0f} real-time streams; depth 0 wall {walls[0]:.3f} s "
            f"= {samples / walls[0] / 1e6:.2f} Msamples/s; launches at depth 8 {counts8}; stages at depth 8 (host "
            f"clock): {stage_report(rep8)}; staggered rows ({len(set(files))} files of "
            f"{len(files[0]) // mode.chunk_size} chunks, "
            f"stream i behind {leads[1]} * i samples of noise, {t_s} samples a stream): {n} exact files, depth 8 wall "
            f"{wall_s:.3f} s = {n * t_s / wall_s / 1e6:.2f} Msamples/s, launches {counts_s}, stages "
            f"{stage_report(rep_s)}; window cut [{n}, {w}] out of the ring: lockstep {t_lock:.3f} ms, staggered "
            f"{t_stag:.3f} ms; against the plain versions at every shape of the warm passes: {checked}")
    return total, err, line, {"wall": walls[8], "rep": rep8, "counts": counts8, "state": state8}


def mesh_receive(dev, ref: dict, n: int = N_STREAMS, n_chunks: int = 128, block: int = STREAM_BLOCK):
    """Phase 21: phase 18's transfer (same seed, broadcast blocks on ``dev``,
    K = 8, pipeline_depth 8) through ``BatchReceiver(mesh=...)``: two shards
    on ``dev``, every card, and two cards where there are two. A warm pass,
    then a timed one with launch counts from zero, each 64 files exact; the
    timed pass's results, counters, final state and stage counts must equal
    phase 18's un-sharded receiver (``ref``), and kernels A and C must
    launch once a shard for each of their launches there. Kernels A and C
    are held to their plain versions on the first input of each shape on
    every shard. Returns
    (launches, kernel A's largest fine or channel error, a report line)."""
    import torch

    from audio_modem_tpu_torch import MODES
    from audio_modem_tpu_torch.configs import SAMPLE_RATE
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from audio_modem_tpu_torch.parallel.mesh import make_mesh
    from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver

    mode = MODES["QPSK"]
    data, t, blocks = config5_device_blocks(dev, n, n_chunks, block)
    want = [data] * n
    count = torch.cuda.device_count()
    meshes = [(f"[{dev}] x 2", make_mesh(devices=[dev] * 2)), (f"every card ({count})", make_mesh())]
    if count >= 2:
        meshes.append(("two cards", make_mesh(2)))
    inputs: dict = {}
    total = Counter()
    parts = [f"phase 18 (un-sharded) wall {ref['wall']:.3f} s = {n * t / ref['wall'] / 1e6:.2f} Msamples/s, "
             f"launches {ref['counts']}, stages {stage_report(ref['rep'])}"]
    for label, mesh in meshes:
        warm = BatchReceiver(mode, n, scan_bucket=block, pipeline_depth=8, mesh=mesh)
        with path_inputs(inputs, label, shards=mesh.size):
            feed_batch(warm, blocks)
        check_batch(f"mesh {label}, warm pass", warm, want)
        del warm
        reset_launch_counts()
        rx = BatchReceiver(mode, n, scan_bucket=block, pipeline_depth=8, mesh=mesh)
        wall = feed_batch(rx, blocks)
        counts = launch_counts()
        check_batch(f"mesh {label}", rx, want)
        if [b.device for b in rx.dring.shards] != list(mesh.devices):
            fail(f"mesh {label}: ring shards on {[str(b.device) for b in rx.dring.shards]}")
        if receiver_state(rx) != ref["state"]:
            fail(f"mesh {label}: results, counters or state differ from phase 18's un-sharded receiver")
        for kernel in ("decode_fused", "decode_predicted"):
            if counts[kernel] != mesh.size * ref["counts"][kernel]:
                fail(f"mesh {label}: {kernel} launched {counts[kernel]} times, not {mesh.size} x "
                     f"{ref['counts'][kernel]}")
        total.update(counts)
        msps = n * t / wall / 1e6
        parts.append(f"mesh {label} ({', '.join(map(str, mesh.devices))}): {n} exact files, state equal to phase "
                     f"18's, wall {wall:.3f} s = {msps:.2f} Msamples/s = {msps * 1e6 / SAMPLE_RATE:.0f} real-time "
                     f"streams, launches {counts}, stages {stage_report(rx.timer.report())}")
        del rx
    if count < 2:
        parts.append("the two-card mesh was not run: this machine has one card")
    for kernel in ("decode_fused", "decode_predicted"):
        tags = {k[1] for k in inputs if k[0] == kernel}
        for label, mesh in meshes:
            if mesh.size > 1 and not {f"{label} shard {k}" for k in range(mesh.size)} <= tags:
                fail(f"mesh {label}: {kernel}'s inputs recorded only for {sorted(tags)}")
    err, checked = check_path_inputs("mesh", inputs)
    return total, err, (f"{n} streams x {t} samples ({n_chunks} chunks, K = 8, pipeline_depth 8); "
                        + "; ".join(parts) + f"; kernels A and C against their plain versions on every shard: "
                        f"{checked}")


def entry_and_cluster(dev, store: dict) -> tuple[Counter, str]:
    """Phase 22: ``entry()`` on the card (kernel B bit for bit against its
    plain version), ``dryrun_multichip`` on [dev] x 2 and on every card,
    and the multi-process dry run: 2 gloo ranks x 2 devices sharing the
    card(s), and one nccl rank per card. Kernel inputs of entry() and of
    the two dryrun_multichip meshes go to ``store``, kernel A's per shard;
    each rank runs the same ``multihost.sharded_step`` on a local mesh of
    the same shard shape (2 rows of the one 64-byte chunk frame a device),
    so these inputs are the ranks' too. Each child reports its BER, flags
    and launches; every report is checked here. Returns (launches, line)."""
    import torch

    from audio_modem_tpu_torch import MODES, entry
    from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
    from audio_modem_tpu_torch.parallel.multihost import run_dryrun

    total = Counter()
    parts = []
    reset_launch_counts()
    with path_inputs(store, "entry"):
        fn, (frames,) = entry.entry()
        bits = fn(frames)
    counts = launch_counts()
    plain = receive.decode_chunks_fused_reference(frames, MODES["QPSK"], 4)
    if counts["decode_chunks_fused"] != 1 or not torch.equal(bits, plain):
        fail(f"entry(): launches {counts}, bits {tuple(bits.shape)}, "
             f"{int((bits != plain).sum()) if bits.shape == plain.shape else 'all'} differ from the plain version")
    total.update(counts)
    parts.append(f"entry() bits {tuple(bits.shape)} on {frames.device}, launches {counts}, equal to the plain "
                 f"version's (8 frames of seeded noise, no signal)")
    count = torch.cuda.device_count()
    meshes = ((f"[{dev}] x 2", {"n_devices": 2, "devices": [dev] * 2}), (f"{count} card(s)", {"n_devices": count}))
    for label, kw in meshes:
        reset_launch_counts()
        t0 = time.perf_counter()
        with path_inputs(store, f"dryrun_multichip {label}", shards=kw["n_devices"]):
            entry.dryrun_multichip(**kw)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if counts["decode_fused"] != kw["n_devices"]:
            fail(f"dryrun_multichip {label}: launches {counts}")
        total.update(counts)
        parts.append(f"dryrun_multichip {label} passed in {wall:.3f} s, launches {counts}")
    tags = {k[:2] for k in store}
    want = {("decode_chunks_fused", "entry")} | {
        ("decode_fused", f"dryrun_multichip {label}" + (f" shard {k}" if kw["n_devices"] > 1 else ""))
        for label, kw in meshes for k in range(kw["n_devices"])}
    if not want <= tags:
        fail(f"phase 22: kernel inputs recorded only at {sorted(tags)}")
    for label, kw in (("gloo, 2 ranks x 2 devices", {"n_processes": 2, "devices_per_process": 2, "backend": "gloo"}),
                      (f"nccl, {count} rank(s) x 1 card", {"n_processes": count, "devices_per_process": 1,
                                                           "backend": "nccl"})):
        t0 = time.perf_counter()
        reports = run_dryrun(timeout=300.0, **kw)
        wall = time.perf_counter() - t0
        world, dpp = kw["n_processes"], kw["devices_per_process"]
        for r in reports:
            if not (r["ber"] < 0.01 and r["detected"] == [1] * (2 * dpp * world)
                    and r["launches"]["decode_fused"] == dpp and not r["jax_loaded"]
                    and all(d.startswith("cuda:") for d in r["devices"])):
                fail(f"multihost {label}: rank {r['rank']} reported {r}")
            total["decode_fused"] += r["launches"]["decode_fused"]
        parts.append(f"multihost {label} in {wall:.1f} s: " + "; ".join(
            f"rank {r['rank']} on {','.join(r['devices'])} BER {r['ber']} (local {r['ber_local']}), flags "
            f"{''.join(map(str, r['detected']))}, launches {r['launches']}" for r in reports))
    return total, "; ".join(parts)


def soak_and_demo(dev, store: dict) -> tuple[Counter, str]:
    """Phase 23: the soak (64 streams x 0.82 MB, 400 chunks a stream,
    sqlite), the lossy soak cut to 8 chunks a stream (2 sessions of 32
    streams, plain and FEC), the demo at its default size in a temporary
    directory. Kernel inputs go to ``store``. Returns (launches, line)."""
    import io

    from audio_modem_tpu_torch.examples import demo
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from audio_modem_tpu_torch.tools import soak, soak_lossy

    total = Counter()
    with path_inputs(store, "soak"):
        rec = soak.run_soak(0.82, N_STREAMS, device=dev)
    if not (soak.passed(rec) and rec["chunks_expected"] == N_STREAMS * 400):
        fail(f"soak: {json.dumps({k: v for k, v in rec.items() if k != 'stage_breakdown'})}")
    total.update(rec["launches"])
    soak_line = (f"soak {rec['config']['streams']} x {rec['config']['per_stream_bytes']} B "
                 f"({rec['config']['samples_per_stream']} samples a stream, sqlite): {rec['chunks_received']} of "
                 f"{rec['chunks_expected']} chunks, {rec['crc_errors']} CRC errors, exact; wall {rec['wall_s']:.3f} s "
                 f"= {rec['sustained_msps']:.2f} Msamples/s = {rec['realtime_streams']:.0f} real-time streams; "
                 f"launches {rec['launches']}; stages {stage_report(rec['stage_breakdown'])}")
    with path_inputs(store, "lossy"):
        lossy = soak_lossy.run_lossy(0.0164, 32, device=dev)
    if not lossy["pass"]:
        fail(f"lossy soak: {json.dumps(lossy)}")
    for s in lossy["sessions"]:
        total.update(s["launches"])
    lossy_line = "lossy soak: " + "; ".join(
        f"{'FEC' if s['fec'] else 'plain'} {s['streams']} x {s['chunks_per_stream']} chunks, dropouts hit "
        f"{s['injected_dropout_chunks']}, missing after round 1 {s['missing_after_round1']}, {s['arq_rounds']} "
        f"rounds (resent {s['resend_counts_per_round']}), every stream complete and exact; round 1 "
        f"{s['round1_s']:.3f} s, wall {s['wall_s']:.3f} s, launches {s['launches']}" for s in lossy["sessions"])
    reset_launch_counts()
    printed = io.StringIO()
    with tempfile.TemporaryDirectory() as td, contextlib.chdir(td), contextlib.redirect_stdout(printed), \
            path_inputs(store, "demo"):
        t0 = time.perf_counter()
        ok = demo.main([])
        wall = time.perf_counter() - t0
    counts = launch_counts()
    if not ok or "payload match: True" not in printed.getvalue():
        fail(f"demo: {printed.getvalue()}")
    total.update(counts)
    demo_line = (f"demo (6,000 B QPSK, 20 dB + multipath + gain + DC) in {wall:.3f} s: "
                 + " / ".join(printed.getvalue().strip().splitlines()) + f"; launches {counts}")
    return total, "; ".join([soak_line, lossy_line, demo_line])


BENCH_RATES = ("batch4096_full_pipeline_msps", "frame_demod_only_msps", "predicted_kernel_msps",
               "long_frame_kernel_msps", "long_std_kernel_msps", "batch_receiver_device_msps")


def bench_phase(store: dict) -> tuple[Counter, str, tuple]:
    """Phase 24: ``audio_modem_tpu_torch.bench.run()`` at its default sizes in
    this process, its details file in a temporary directory and its stdout
    captured, launch counts from zero; kernel inputs go to ``store``, each
    keyed by its mode too (two modes give kernel A the same shape). Fails on
    a skipped or failed stage, on a last line that is not the four-key
    headline, and on a kernel that never launched. Kernel A's inputs of
    more rows than a stream batch (the batch512, batch4096 and per-mode
    stages: clean frames) are tagged " clean". Returns (launches, line,
    the tags to hold A bit for bit on)."""
    import io
    import os
    from unittest import mock

    from audio_modem_tpu_torch import bench
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bench_torch.json"
        with mock.patch.dict(os.environ, {"AMT_BENCH_DETAILS": str(path)}):
            reset_launch_counts()
            t0 = time.perf_counter()
            with path_inputs(store, "bench", by_mode=True), contextlib.redirect_stdout(out):
                headline, d = bench.run()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        written = json.loads(path.read_text())
    if d.get("failed_stages") or d.get("skipped_stages"):
        fail(f"bench: failed {d.get('failed_stages')}, skipped {d.get('skipped_stages')}")
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    if set(last) != {"metric", "value", "unit", "vs_baseline"} or last != headline or written["value"] != last["value"]:
        fail(f"bench: last stdout line {last}, headline {headline}")
    if min(counts[k] for k in ("decode_fused", "decode_predicted", "decode_chunks_fused", "stream_demod")) < 1:
        fail(f"bench: a kernel never launched: {counts}")  # the tail is the one-shot decoder's alone
    missing = [k for k in BENCH_RATES + ("per_mode_msps", "roofline") if k not in d]
    if missing or len(d["per_mode_msps"]) != 6:
        fail(f"bench: details lack {missing} or a mode: {sorted(d)}")
    if len(d["roofline"]["kernels"]) != 4 or any(r["bound_by"] is None for r in d["roofline"]["kernels"].values()):
        fail(f"bench: roofline {d['roofline']}")
    for key in [k for k in store if k[0] == "decode_fused" and k[2][0] > N_STREAMS]:
        store[(key[0], f"{key[1]} clean", *key[2:])] = store.pop(key)
    shares = "; ".join(f"{name} at {r['at_msps']} Msamples/s: {r['bytes_per_sample']:.3f} B, "
                       f"{r['fp32_flops_per_sample']:.1f} float32 operations a sample, {r['pct_of_hbm']:.3f}% of the "
                       f"memory rate, {r['pct_of_fp32']:.3f}% of the float32 peak ({r['bound_by']})"
                       for name, r in d["roofline"]["kernels"].items())
    line = (f"bench.run() at its default sizes in {wall:.1f} s, no stage skipped or failed; headline "
            f"{json.dumps(last)}; " + ", ".join(f"{k} {d[k]}" for k in BENCH_RATES)
            + f", per_mode_msps {json.dumps(d['per_mode_msps'])}; roofline: {shares}; launches {counts}")
    return Counter(counts), line, tuple({k[1] for k in store if k[1].endswith(" clean")})


GOLDEN = ROOT / "tests" / "golden"
# (mode, samples, preamble start before the end): the inputs of
# tests/test_torch_decoder.py::test_preamble_cut_off_at_the_end_of_the_padded_buffer
CUT_PREAMBLES = (("QPSK", 32768, 586), ("BPSK-NARROW", 49152, 778))


def cut_preamble(name: str, total: int, tail: int):
    """``total`` samples of seeded noise at 1e-3 (a whole padded bucket) with
    a legacy frame's preamble starting ``tail`` samples before the end, as
    the CPU test makes it: the refine region reaches past the padded
    signal, and the decode must find the true start, then fail its CE."""
    import numpy as np

    from audio_modem_tpu_torch import MODES, framing

    mode = MODES[name]
    clean = framing.build_transmit_signal(b"cut" * 40, mode, "t.bin", device="cpu").numpy()
    pre = mode.profile.silence_pre_legacy()
    sig = (1e-3 * np.random.default_rng(1).standard_normal(total)).astype(np.float32)
    sig[total - tail :] += clean[pre : pre + tail]
    return sig


def decode_walls(sig, name: str, dev, reps: int = 5) -> dict:
    """Host wall in ms of ``api.decode(sig, name, device=dev)`` through each
    route of the decoder's device core: kernel A at B = 1 (the decoder's
    route) and ``decode_long_fused`` (the route it replaced, put in for these
    calls alone), a warm call of each, then ``reps`` calls a route in the
    turns A, long, long, A. Returns {route: its 2 * ``reps`` walls}."""
    from audio_modem_tpu_torch import api, decoder
    from audio_modem_tpu_torch.kernels import receive

    routes = {"kernel A": decoder.decode_fused, "decode_long_fused": receive.decode_long_fused}
    walls: dict = {route: [] for route in routes}
    try:
        for route in ("kernel A", "decode_long_fused", "decode_long_fused", "kernel A"):
            decoder.decode_fused = routes[route]
            if not walls[route]:
                api.decode(sig, name, device=dev)
            for _ in range(reps):
                t0 = time.perf_counter()
                api.decode(sig, name, device=dev)
                walls[route].append((time.perf_counter() - t0) * 1e3)
    finally:
        decoder.decode_fused = routes["kernel A"]
    return walls


def walls_line(label: str, n: int, walls: dict) -> str:
    """``decode_walls``' result as one report: each route's median and runs."""
    return f"{label} ({n} samples): " + ", ".join(
        f"{route} {statistics.median(runs):.3f} ms (runs {', '.join(f'{w:.3f}' for w in runs)})"
        for route, runs in walls.items())


def contract_phase(dev, store: dict) -> tuple[Counter, str, dict, tuple]:
    """Phase 25: the JAX package's test contract on the card. Each input is
    host audio (``tests/golden``'s WAVs, or made by the port, on the card
    unless its CPU test makes it on the CPU), decoded with ``device=dev`` and
    again with ``device="cpu"``: the card's result must equal the CPU's
    (every field of the frame or the chunked result, preamble_idx,
    fine_metric within 1e-5) and pass the JAX test's own assertion, with
    launch counts from zero for each: ``decode_fused`` (kernel A, the
    decoder's device core) at least once an ``api.decode`` or
    ``decode_raw``, ``stream_demod`` there only where the decode went on to
    a chunk frame (``decoder.decode_chunk_frame``, the xcorr
    re-acquisition), and once a frame for ``decode_chunked``. Kernel A's and
    the streaming demod's inputs go to ``store`` under each case's label.
    Returns (launches, line, ``decode_walls`` of config 1 and of config 4 at
    28 dB, with their signals' lengths, the tags of kernel A's inputs that
    carry no noise: ``check_path_inputs``' ``clean``)."""
    import dataclasses

    import numpy as np

    from audio_modem_tpu_torch import MODES, api, channel, decoder, framing
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from audio_modem_tpu_torch.utils.wav import read_wav

    def legacy(data: bytes, name: str, file_name: str) -> np.ndarray:
        return api.encode_legacy(data, name, file_name, device=dev).cpu().numpy()

    def exact(data: bytes, file_name: "str | None" = None):
        return lambda r: (isinstance(r, framing.LegacyFrame) and r.crc_valid and r.data == data
                          and file_name in (None, r.file_name))

    def fails_crc(r) -> bool:
        return not (isinstance(r, framing.LegacyFrame) and r.crc_valid)

    def describe(r) -> str:
        if isinstance(r, framing.FrameError):
            return f"FrameError({r.error!r})"
        return f"{type(r).__name__} crc_valid={r.crc_valid} {len(r.data)} B"

    def on_card(fn, label: str, chunked: bool = False):
        """``fn()`` with launch counts from zero and the kernels' inputs kept
        under ``label``; returns (its result, the launches, the chunk frames
        the decoder decoded)."""
        real_chunk, frames = decoder.decode_chunk_frame, []

        def chunk_frame(*args, **kw):
            frames.append(1)
            return real_chunk(*args, **kw)

        decoder.decode_chunk_frame = chunk_frame
        try:
            with path_inputs(store, label):
                reset_launch_counts()
                out = fn()
                counts = launch_counts()
        finally:
            decoder.decode_chunk_frame = real_chunk
        if chunked:
            if counts["stream_demod"] < 1:
                fail(f"phase 25 {label}: stream_demod never launched: {counts}")
        elif counts["decode_fused"] < 1 or (counts["stream_demod"] and not frames):
            fail(f"phase 25 {label}: {len(frames)} chunk frames decoded, launches {counts}")
        return out, counts, len(frames)

    cases = []  # (label, mode name, host signal, the JAX test's assertion)
    manifest = json.loads((GOLDEN / "manifest.json").read_text())
    for name, entry in sorted(manifest.items()):
        sig, rate = read_wav(str(GOLDEN / entry["wav"]))
        if rate != 44100 or len(sig) != entry["samples"]:
            fail(f"phase 25: {entry['wav']} holds {len(sig)} samples at {rate} Hz")
        cases.append((f"golden {entry['wav']}", name, sig,
                      lambda r, e=entry: (isinstance(r, framing.LegacyFrame) and r.crc_valid
                                          and r.file_name == e["file_name"]
                                          and hashlib.sha256(r.data).hexdigest() == e["sha256"])))
    data1 = np.random.default_rng(SEED + 25).bytes(1024)
    sig1 = legacy(data1, "BPSK-NARROW", "config1.bin")
    cases.append(("config 1", "BPSK-NARROW", sig1, exact(data1, "config1.bin")))
    # config 4 exactly as tests/test_torch_decoder.py makes it: TX and channel on the CPU
    data4 = np.random.default_rng(47).bytes(2000)
    tx4 = api.encode_legacy(data4, "16-QAM", "mp.bin", device="cpu").numpy()
    sig4 = {}
    for snr in (28.0, 22.0, 18.0):
        spec = channel.ChannelSpec(snr_db=snr, multipath=((23, 0.25), (61, 0.12)), gain=0.7, dc_offset=0.01)
        sig4[snr] = channel.apply_channel_np(tx4, spec, seed=2, device="cpu")
        cases.append((f"config 4 at {snr:.0f} dB", "16-QAM", sig4[snr], exact(data4) if snr > 20 else fails_crc))
    cases.append(("one byte", "QPSK", legacy(b"\x42", "QPSK", "a"), exact(b"\x42")))
    cases.append(("empty", "QPSK", legacy(b"", "QPSK", "empty"),
                  lambda r: isinstance(r, framing.FrameError) and "Invalid data length" in r.error))
    for total in (205, 410, 1025):  # payloads that fill their QPSK symbols (410 bits) exactly
        data = b"z" * (total - 13)  # name length, "abcd", data length and CRC: 13 bytes
        cases.append((f"symbol-exact {total}", "QPSK", legacy(data, "QPSK", "abcd"), exact(data, "abcd")))
    for file_name, check in (("п" * 100, exact(b"x" * 50, "п" * 100)), ("n" * 253, exact(b"x" * 50, "n" * 253)),
                             ("n" * 300, fails_crc)):  # 300 bytes truncate to 255: the name length collides with 0xFF
        cases.append((f"{len(file_name.encode())}-byte name", "QPSK", legacy(b"x" * 50, "QPSK", file_name), check))
    qpsk = MODES["QPSK"]
    p = qpsk.profile
    data_d = np.random.default_rng(11).bytes(400)
    t = np.arange(2 * p.fft_size)
    decoy = (0.4 * np.sin(2 * np.pi * 4 * t / p.fft_size)).astype(np.float32)  # inactive bin 4: lag-periodic
    composite = np.concatenate([decoy, np.zeros(2 * p.fft_size, np.float32), legacy(data_d, "QPSK", "d.bin")])
    cases.append(("decoy resume", "QPSK", composite, exact(data_d, "d.bin")))
    for name, total, tail in CUT_PREAMBLES:
        cases.append((f"preamble cut off {name}", name, cut_preamble(name, total, tail),
                      lambda r: isinstance(r, framing.FrameError) and r.error == "Signal too short for CE"))
    noise = (np.random.default_rng(5).standard_normal(40000) * 0.05).astype(np.float32)
    for label, sig in (("silence", np.zeros(40000, np.float32)), ("noise", noise)):
        cases.append((label, "QPSK", sig,
                      lambda r: isinstance(r, framing.FrameError) and r.error.startswith("Preamble not detected")))

    total_counts: Counter = Counter()
    parts, worst_fine = [], 0.0
    for label, name, sig, check in cases:
        ref, rinfo = api.decode(sig, name, device="cpu")
        (out, info), counts, n_frames = on_card(lambda: api.decode(sig, name, device=dev), label)
        total_counts.update(counts)
        if type(out).__name__ != type(ref).__name__ or dataclasses.asdict(out) != dataclasses.asdict(ref):
            fail(f"phase 25 {label}: the card gave {describe(out)}, the CPU {describe(ref)}")
        if (info is None) != (rinfo is None):
            fail(f"phase 25 {label}: sync info {info} on the card, {rinfo} on the CPU")
        if info is not None:
            worst_fine = max(worst_fine, abs(info.fine_metric - rinfo.fine_metric))
            if info.preamble_idx != rinfo.preamble_idx or abs(info.fine_metric - rinfo.fine_metric) > 1e-5:
                fail(f"phase 25 {label}: preamble {info.preamble_idx} / fine {info.fine_metric} on the card, "
                     f"{rinfo.preamble_idx} / {rinfo.fine_metric} on the CPU")
        if not check(out):
            fail(f"phase 25 {label}: {describe(out)}")
        parts.append(f"{label} ({len(sig)} samples, {name}): {describe(out)}"
                     + (f" at {info.preamble_idx}" if info is not None else "")
                     + f", decode_fused x{counts['decode_fused']}, stream_demod x{counts['stream_demod']}"
                     + (f" ({n_frames} chunk frame{'s' * (n_frames > 1)})" if n_frames else ""))

    # the decoy resume without the xcorr fallback: decode_raw alone, payload bytes equal
    (raw, info), counts, _ = on_card(lambda: decoder.decode_raw(composite, qpsk, device=dev), "decoy raw")
    total_counts.update(counts)
    rraw, rinfo = decoder.decode_raw(composite, qpsk, device="cpu")
    payload = framing.build_legacy_payload(data_d, "d.bin")
    if not (isinstance(raw, bytes) and isinstance(rraw, bytes) and raw[: len(payload)] == rraw[: len(payload)] == payload
            and info.preamble_idx == rinfo.preamble_idx >= len(decoy)
            and abs(info.fine_metric - rinfo.fine_metric) <= 1e-5):
        fail(f"phase 25 decoy: decode_raw gave {type(raw).__name__} at {getattr(info, 'preamble_idx', None)} on the "
             f"card, {type(rraw).__name__} at {getattr(rinfo, 'preamble_idx', None)} on the CPU")
    if counts["decode_fused"] < 2 or counts["stream_demod"]:
        fail(f"phase 25 decoy: decode_raw resumed the scan with launches {counts}")
    parts.append(f"decoy decode_raw: payload exact past the decoy at {info.preamble_idx}, decode_fused "
                 f"x{counts['decode_fused']} (the resume loop's tries)")

    for name in ("16-QAM", "BPSK-REPEAT", "64-QAM"):  # two chunks: metadata + 2 data frames
        mode = MODES[name]
        data = np.random.default_rng(7).bytes(mode.chunk_size + 63)
        sig = np.concatenate(chunked_frames(data, name, "m.bin", dev))
        ref = api.decode_chunked(sig, name, device="cpu")
        out, counts, _ = on_card(lambda: api.decode_chunked(sig, name, device=dev), f"chunked {name}", chunked=True)
        total_counts.update(counts)
        if not isinstance(out, api.ChunkedDecodeResult) or dataclasses.asdict(out) != dataclasses.asdict(ref):
            fail(f"phase 25 chunked {name}: the card gave {out}, the CPU {ref}")
        if not (out.complete and out.data == data) or counts["stream_demod"] < 3:
            fail(f"phase 25 chunked {name}: missing {out.missing_chunks}, launches {counts}")
        parts.append(f"chunked {name} ({len(sig)} samples): {len(data)} exact bytes in {out.total_chunks} chunks, "
                     f"stream_demod x{counts['stream_demod']}")

    kept = {k[1] for k in store if k[0] == "decode_fused"}
    unkept = [label for label in [c[0] for c in cases] + ["decoy raw"] if f"{label} decoder" not in kept]
    if unkept or "decoy raw decoder resume" not in kept:
        fail(f"phase 25: no input of kernel A kept for {unkept}, resume kept: {'decoy raw decoder resume' in kept}")

    noisy = {c[0] for c in cases if c[0].startswith(("config 4", "preamble cut off", "noise"))}
    clean = tuple(f"{label} decoder{resume}" for label in [c[0] for c in cases if c[0] not in noisy] + ["decoy raw"]
                  for resume in ("", " resume"))
    walls = {label: (len(sig), decode_walls(sig, name, dev))
             for label, name, sig in (("config 1", "BPSK-NARROW", sig1), ("config 4 at 28 dB", "16-QAM", sig4[28.0]))}
    line = (f"{len(cases) + 4} decodes equal to the CPU's (largest fine_metric difference {worst_fine:.3e}, tol "
            f"1e-5); " + "; ".join(parts) + f"; launches {dict(total_counts)}")
    return total_counts, line, walls, clean


class CliRun:
    """``cli.main`` of the port in this process, so the launch counters see
    its work, on its default compute device, the card. Use inside
    ``capture()``."""

    def __init__(self):
        self.out = self.err = None

    @contextlib.contextmanager
    def capture(self):
        """Standard output into a byte buffer (play and listen use
        ``sys.stdout.buffer``), standard error into a string."""
        import io

        self.out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
        self.err = io.StringIO()
        with contextlib.redirect_stdout(self.out), contextlib.redirect_stderr(self.err):
            yield self

    def __call__(self, *argv: str) -> tuple[str, float]:
        """Run one subcommand; it must exit 0. Returns (its stdout, wall s)."""
        from audio_modem_tpu_torch import cli

        start = len(self.out.buffer.getvalue())
        t0 = time.perf_counter()
        rc = cli.main(list(argv))
        wall = time.perf_counter() - t0
        text = self.out.buffer.getvalue()[start:].decode()
        if rc != 0:
            fail(f"cli {' '.join(argv)}: exit {rc}: {text[-300:]} {self.err.getvalue()[-300:]!r}")
        return text, wall

    def piped(self, play_args: list, listen_args: list) -> tuple[str, float]:
        """``play ... | listen ...`` as a shell runs it, over one ``os.pipe``:
        play on a thread writes its standard output into the write end, listen
        here reads its standard input from the read end; both must exit 0.
        Returns (listen's stdout, its wall s)."""
        import io
        import os
        import threading

        from audio_modem_tpu_torch import cli

        r, w = os.pipe()
        sink = io.TextIOWrapper(os.fdopen(w, "wb"), encoding="utf-8")
        failed = []

        def writer():
            try:
                # the sink "-" right after the input: argparse in Python 3.12.3 takes no optional
                # positional after options
                rc = cli.main([*play_args[:2], "-", *play_args[2:]])
                if rc != 0:
                    failed.append(f"exit {rc}")
            except (Exception, SystemExit) as e:  # reported on the main thread, which fails the run
                failed.append(repr(e))
            finally:
                sys.stdout = self.out  # listen prints its result after the end of the stream
                sink.close()

        real_stdin = sys.stdin
        sys.stdin = io.TextIOWrapper(os.fdopen(r, "rb"), encoding="utf-8")
        sys.stdout = sink
        t = threading.Thread(target=writer)
        t.start()
        try:
            text, wall = self(listen_args[0], "-", *listen_args[1:])
        finally:
            sys.stdin.close()  # a writer still blocked on a full pipe gets EPIPE
            sys.stdin = real_stdin
            t.join(timeout=120)
        if failed or t.is_alive():
            fail(f"cli play into a pipe: {failed[0] if failed else 'still running'}: {self.err.getvalue()[-300:]!r}")
        return text, wall


def cli_phase(store: dict, small: bytes, big: bytes, n_big_frames: int) -> tuple[Counter, str]:
    """Phase 19: the port's CLI, every subcommand but bench, launch counts from
    zero before each and read after it: encode -> decode of ``small`` (one
    legacy QPSK frame), encode -> receive of ``big`` (chunked, ``n_big_frames``
    frames), play --no-pace of ``big`` into a pipe with listen on the other
    end in f32 and in s16, testsignal -> diagnose, diagnose --live through a
    channel, sweep and info. Files must come back exact, ``decode_fused``
    launch for decode (the decoder's device core) and ``stream_demod`` at
    least once per frame received. Returns (launches, a report line)."""
    import re

    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts

    run = CliRun()
    total = Counter()
    parts = []

    def counted(label: str, least: int, call, *args, kernel: str = "stream_demod") -> tuple[str, float]:
        reset_launch_counts()
        text, wall = call(*args)
        counts = launch_counts()
        if counts[kernel] < least:
            fail(f"cli {label}: {kernel} launched {counts[kernel]} times, fewer than {least}")
        total.update(counts)
        return text, wall

    with tempfile.TemporaryDirectory() as tmp, path_inputs(store, "cli"), run.capture():
        d = Path(tmp)
        (d / "small.bin").write_bytes(small)
        (d / "big.bin").write_bytes(big)

        def exact(name: str, want: bytes, label: str) -> None:
            if (d / name).read_bytes() != want:
                fail(f"cli {label}: {name} differs from what was sent")

        _, t_enc_s = counted("encode", 0, run, "encode", str(d / "small.bin"), str(d / "s.wav"))
        _, t_dec = counted("decode", 1, run, "decode", str(d / "s.wav"), "-o", str(d / "s.out"),
                           kernel="decode_fused")
        exact("s.out", small, "decode")
        _, t_enc_b = counted("encode", 0, run, "encode", str(d / "big.bin"), str(d / "b.wav"))
        text, t_rx = counted("receive", n_big_frames, run, "receive", str(d / "b.wav"), "-o", str(d / "b.out"))
        exact("b.out", big, "receive")
        if "[complete]" not in text:
            fail(f"cli receive: {text.strip()}")
        parts.append(f"encode {len(small)} bytes {t_enc_s:.3f} s, decode {t_dec:.3f} s (exact); encode "
                     f"{len(big)} bytes {t_enc_b:.3f} s, receive {t_rx:.3f} s (exact, {n_big_frames} frames)")
        for pcm in ("f32", "s16"):
            text, t_listen = counted(
                f"play | listen {pcm}", n_big_frames, run.piped,
                ["play", str(d / "big.bin"), "--no-pace", "--pcm", pcm],
                ["listen", "-o", str(d / f"l_{pcm}.out"), "--pcm", pcm])
            exact(f"l_{pcm}.out", big, f"play | listen {pcm}")
            rtf = re.search(r"([0-9.]+)x realtime", text)
            if "[complete]" not in text or rtf is None:
                fail(f"cli listen {pcm}: {text.strip()}")
            parts.append(f"play --no-pace | listen {pcm}: exact, wall {t_listen:.3f} s, realtime_factor "
                         f"{rtf.group(1)}")
        counted("testsignal", 0, run, "testsignal", str(d / "ts.wav"))
        text, t_diag = counted("diagnose", 0, run, "diagnose", str(d / "ts.wav"))
        rep = json.loads(text.strip().splitlines()[-1])
        if not (rep["detected"] and rep["ber"] == 0 and rep["quality"] == "excellent"):
            fail(f"cli diagnose of the test signal: {rep}")
        spec = "snr=20,ppm=100,echo=50:0.3"
        text, t_live = counted("diagnose --live", 0, run, "diagnose", "--live", "--channel", spec)
        live = json.loads(text.strip().splitlines()[-1])
        if not live["detected"]:
            fail(f"cli diagnose --live --channel {spec}: {live}")
        counted("sweep", 0, run, "sweep", str(d / "sw.wav"))
        text, _ = counted("info", 0, run, "info")
        parts.append(f"diagnose of testsignal {t_diag:.3f} s (detected, ber 0, excellent); diagnose --live "
                     f"--channel {spec} {t_live:.3f} s (detected, ber {live['ber']}, snr {live['snr_db']} dB, "
                     f"{live['quality']}); sweep and info exit 0 ({len(text.splitlines()) - 1} modes)")
    return total, "; ".join(parts)


def arq_phase(dev, store: dict, big: bytes, n_streams: int = N_STREAMS, n_chunks: int = 16,
              n_sym: int = 64) -> tuple[Counter, str]:
    """Phase 20: selective-repeat ARQ and the loopback curve on ``dev``, launch
    counts from zero before each session. ``arq.run_arq_session`` of ``big``
    with every 20th data-chunk frame zeroed in round 1: complete and exact in
    two or more rounds, the first request naming exactly the dropped chunks
    and round 2 resending only them, kernel A launched by every request
    decode. ``arq.run_batch_arq_session`` of
    ``n_streams`` seeded files of ``n_chunks`` chunks (config 5's widths)
    with one chunk frame killed on every even stream in round 1: every
    stream exact, even streams resend one chunk, kernel B launched. Then
    ``diag.ber_vs_snr`` over ``n_streams`` x ``n_sym`` QPSK symbols: 0 at
    30 dB and rising with falling SNR by no more than noise. Returns
    (launches, a report line)."""
    import numpy as np

    from audio_modem_tpu_torch import MODES, arq, diag, framing
    from audio_modem_tpu_torch.kernels import launch_counts, reset_launch_counts

    mode = MODES["QPSK"]
    cs = mode.chunk_size
    total = Counter()
    parts = []

    def frame_lens(n_chunk: int, size: int, name: str) -> tuple[int, int]:
        meta = framing.build_metadata_frame(n_chunk, size, cs, name, mode, device=dev).shape[0]
        return meta, framing.build_data_chunk_frame(bytes(cs), 0, mode, device=dev).shape[0]

    def round_walls(starts: list, end: float) -> str:
        return ", ".join(f"{b - a:.3f}" for a, b in zip(starts, starts[1:] + [end]))

    # one stream, 1 MiB, every 20th chunk frame lost in round 1
    n_total = -(-len(big) // cs)
    meta_len, chunk_len = frame_lens(n_total, len(big), "arq.bin")
    dropped = list(range(0, n_total, 20))
    stamps = []

    def forward(sig):
        stamps.append(time.perf_counter())
        if len(stamps) == 1:
            sig = sig.copy()
            for s in dropped:
                sig[meta_len + s * chunk_len : meta_len + (s + 1) * chunk_len] = 0.0
        return sig

    requests = []
    real_request = arq.build_request_frame

    def record_request(missing, mode_, device="cuda"):
        requests.append(list(missing))
        return real_request(missing, mode_, device)

    arq.build_request_frame = record_request
    try:
        with path_inputs(store, "arq"):
            reset_launch_counts()
            t0 = time.perf_counter()
            rep = arq.run_arq_session(big, mode, "arq.bin", forward, device=dev)
            t_end = time.perf_counter()
            counts = launch_counts()
    finally:
        arq.build_request_frame = real_request
    total.update(counts)
    if not (rep.complete and rep.data == big and rep.file_name == "arq.bin" and rep.rounds >= 2):
        fail(f"arq session: complete {rep.complete}, exact {rep.data == big}, rounds {rep.rounds}")
    if rep.chunks_sent_per_round[:2] != [n_total, len(dropped)] or requests[0] != dropped:
        fail(f"arq session: sent {rep.chunks_sent_per_round}, first request {requests[0][:8]}..., "
             f"dropped {dropped[:8]}...")
    if counts["stream_demod"] < n_total + 1:
        fail(f"arq session: stream_demod launched {counts['stream_demod']} times for {n_total + 1} frames")
    if counts["decode_fused"] < len(requests):
        fail(f"arq session: decode_fused launched {counts['decode_fused']} times for {len(requests)} requests")
    parts.append(f"run_arq_session {len(big)} bytes, {len(dropped)} of {n_total} chunk frames zeroed in round 1: "
                 f"exact in {rep.rounds} rounds, chunks sent {rep.chunks_sent_per_round}, first request = the "
                 f"dropped chunks, wall {t_end - t0:.3f} s (rounds {round_walls([t0] + stamps[1:], t_end)}), "
                 f"launches {counts}")

    # config 5's widths over the batched runtime: n_streams x n_chunks, one frame lost on every even stream
    rng = np.random.default_rng(SEED + 20)
    datas = [rng.bytes(cs * n_chunks) for _ in range(n_streams)]
    names = [f"s{i:02d}.bin" for i in range(n_streams)]
    meta_b, chunk_b = frame_lens(n_chunks, cs * n_chunks, names[0])
    seen = [0] * n_streams
    firsts: dict = {}

    def forward_b(i, sig):
        seen[i] += 1
        firsts.setdefault(seen[i], time.perf_counter())
        if seen[i] == 1 and i % 2 == 0:
            a = meta_b + ((i // 2) % n_chunks) * chunk_b
            sig = sig.copy()
            sig[a : a + chunk_b] = 0.0
        return sig

    with path_inputs(store, "batch arq"):
        reset_launch_counts()
        t0 = time.perf_counter()
        reps = arq.run_batch_arq_session(datas, mode, names, forward_b, device=dev)
        t_end = time.perf_counter()
        counts = launch_counts()
    total.update(counts)
    for i, r in enumerate(reps):
        want_sent = [n_chunks, 1] if i % 2 == 0 else [n_chunks]
        if not (r.complete and r.data == datas[i] and r.file_name == names[i] and r.chunks_sent_per_round == want_sent):
            fail(f"batch arq: stream {i} complete {r.complete}, exact {r.data == datas[i]}, sent "
                 f"{r.chunks_sent_per_round} (want {want_sent})")
    if counts["decode_chunks_fused"] < 1:
        fail(f"batch arq: decode_chunks_fused never launched: {counts}")
    starts = [t0] + [firsts[k] for k in sorted(firsts) if k > 1]
    parts.append(f"run_batch_arq_session {n_streams} streams x {n_chunks} chunks ({cs * n_chunks} bytes a stream), "
                 f"one chunk frame zeroed on every even stream in round 1: {n_streams} exact files in "
                 f"{reps[0].rounds} rounds, even streams resent 1 chunk, wall {t_end - t0:.3f} s (rounds "
                 f"{round_walls(starts, t_end)}), launches {counts}")

    # the loopback curve
    t0 = time.perf_counter()
    curve = diag.ber_vs_snr(mode, n_streams=n_streams, n_sym=n_sym, seed=SEED, device=dev)
    t_curve = time.perf_counter() - t0
    draws = n_streams * mode.profile.num_data_subs  # one channel estimate per data bin and stream
    snrs = sorted(curve)
    for lo, hi in zip(snrs, snrs[1:]):
        pq = max(curve[lo] * (1 - curve[lo]), 1 / draws)
        if curve[hi] > curve[lo] + 5 * (2 * pq / draws) ** 0.5 + 5 / draws:
            fail(f"ber_vs_snr rises from {curve[lo]} at {lo} dB to {curve[hi]} at {hi} dB")
    if curve[30.0] != 0.0:
        fail(f"ber_vs_snr: BER {curve[30.0]} at 30 dB")
    parts.append(f"ber_vs_snr QPSK {n_streams} x {n_sym} symbols "
                 + ", ".join(f"{s:g} dB {b:.5f}" for s, b in curve.items()) + f" ({t_curve:.3f} s)")
    return total, "; ".join(parts)


def compare_receive(label: str, out: dict, ref: dict, n_valid, mode, by_frame: bool = False):
    """Kernel A's output dict against its plain version: start, coarse,
    coarse metric and detected equal, fine metric within 1e-5, channel within
    1e-4, and no flipped bit in the symbols inside n_valid.

    ``by_frame`` is for a live runtime's windows, where a detected row may
    be a false detection (a noise edge) whose channel is estimated from
    silence, so its hard decisions rest on rounding: the bits are then held
    as the runtime reads them. Each detected row's bytes must parse to the
    same frame as the plain version's, or both must fail to parse (the
    runtime then hands the frame to the staged machine, which re-reads the
    samples); a CRC-valid frame is thus bit for bit the plain version's.
    Flipped bits are counted by kind of row and reported.

    Returns (fine err, channel err, flipped bits, bits inside n_valid, a
    report of the flips by kind of row)."""
    import torch

    from audio_modem_tpu_torch import decoder, framing
    from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

    for key in ("start", "coarse", "coarse_metric", "detected"):
        if not torch.equal(out[key], ref[key]):
            fail(f"{label} {key} differs from plain: {out[key][:8].tolist()} vs {ref[key][:8].tolist()}")
    fine = torch.where(out["fine_metric"] == ref["fine_metric"], 0.0, (out["fine_metric"] - ref["fine_metric"]).abs())
    err_fine = fine.max().item()
    err_ch = max((out[k] - ref[k]).abs().max().item() for k in ("ch_re", "ch_im"))
    sym = mode.profile.symbol_len
    bps_sym = bits_per_symbol(mode)
    n_sym_max = out["bits"].shape[1] // bps_sym
    starts = out["start"].tolist()
    per_row = []  # (flipped bits, bits inside n_valid)
    for i, (s, nv) in enumerate(zip(starts, n_valid.tolist())):
        nb = min(max((nv - (s + 3 * sym)) // sym, 0), n_sym_max) * bps_sym
        per_row.append((int((out["bits"][i, :nb] != ref["bits"][i, :nb]).sum().item()), nb))
    flips, n_in = sum(f for f, _ in per_row), sum(n for _, n in per_row)
    if err_fine > 1e-5 or err_ch > 1e-4 or (flips and not by_frame):
        fail(f"{label} outside tolerance: fine err {err_fine:.3e}, ch err {err_ch:.3e}, flipped bits {flips}")
    if not by_frame:
        return err_fine, err_ch, flips, n_in, ""

    def parsed(bits) -> list:
        by = bits_to_bytes(majority_vote(bits, mode.repetition) if mode.repetition > 1 else bits).cpu().numpy()
        return [framing.parse_payload_bytes(row.tobytes(), min_len=6) for row in by]

    got, want = parsed(out["bits"]), parsed(ref["bits"])
    kinds: dict = {}
    flipped = []
    for i, det in enumerate(out["detected"].tolist()):
        failed = decoder._parse_failed(want[i])
        if det and got[i] != want[i] and not (failed and decoder._parse_failed(got[i])):
            fail(f"{label}: row {i} (start {starts[i]}) decodes to {got[i]!r:.120} against plain {want[i]!r:.120}")
        kind = "undetected" if not det else "no frame" if failed else type(want[i]).__name__
        f, n = per_row[i]
        k = kinds.setdefault(kind, [0, 0, 0])
        k[0], k[1], k[2] = k[0] + 1, k[1] + f, k[2] + n
        if f:
            flipped.append(f"{i} ({kind}, start {starts[i]}, {f})")
    report = ", ".join(f"{kind} {r} rows {f} of {n}" for kind, (r, f, n) in kinds.items())
    return err_fine, err_ch, flips, n_in, f"{report}; rows with flips: {', '.join(flipped[:12]) or 'none'}"


def zeroed_exact(x, nv: int, lo: int, hi: int):
    """``x`` [n, T] on steps of 2**-8, samples [lo, hi) set to 0, and the first
    ``nv`` samples of every row summing to exactly 0: the rest of a row's
    sum goes out as steps of -+2**-8 on samples spread evenly outside
    [lo, hi). Every sum the DC removal takes is then exact in any order, the
    mean is 0, and the zeroed stretch stays 0 after it (a constant there
    would hold rounding residue that decides the refine and the bits)."""
    import numpy as np

    q = np.round(x.astype(np.float64) * 256)
    q[:, lo:hi] = 0.0
    pos = np.concatenate([np.arange(lo), np.arange(hi, nv)])
    for row in q:
        r = int(row[:nv].sum())
        while r:
            at = pos[:: max(1, len(pos) // abs(r))][: abs(r)]
            row[at] -= np.sign(r)
            r -= int(np.sign(r)) * len(at)
    return (q / 256).astype(np.float32)


def predicted_edges(dev, mode, windows, n_sym: int, cadence: int, record: list | None = None) -> tuple[float, str]:
    """Phase 26: kernel C against its plain version (``compare_predicted``,
    strict) on edge inputs at full width, both branches of the round where
    they differ (slot 0 from kernel A, or every slot predicted from slot 0's
    start), kernel C launched once a call:
      - phase 3's 64 x 32 QPSK windows with slot 5's frame zeroed on every
        stream, from twice the refine radius before its preamble to slot 6
        (``zeroed_exact``: exact DC removal, the stretch stays 0). Slots 0-4
        detected, 5 onward not; slot
        6 finds its frame from slot 5's start;
      - predictions clamped into the window: stream i at slot 0's start + 3
        (i % 4 = 0), at w - 1, far past the window, and far before it on a
        silent row (clamped at 0, every later slot a cadence on);
      - BPSK-REPEAT (the vote) at its 512-byte chunks, 64 streams x K = 8:
        every slot detected, CRC-valid and in sequence;
      - K = 1 on phase 3's windows.
    ``record``, where given, gets (label, kernel C's output) of every case.
    Returns (the largest fine error, a report line)."""
    import numpy as np
    import torch

    from audio_modem_tpu_torch import MODES, bench
    from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    p = mode.profile
    n, w = windows.shape
    k = K
    nv_k = k * cadence
    n_valid = torch.full((n,), nv_k, dtype=torch.int32, device=dev)
    err, parts = 0.0, []

    def run(label: str, x, nv, m, ns: int, kk: int, cad: int, pred0=None) -> tuple:
        nonlocal err
        if pred0 is None:
            out0 = receive.decode_fused(x, nv, torch.zeros_like(nv), m, ns)
            s0, o0, b0 = out0["start"], out0["detected"], out0["bits"]
        else:
            s0, o0, b0 = (pred0 - cad).to(torch.int32), torch.ones(x.shape[0], dtype=torch.bool, device=dev), None
        reset_launch_counts()
        out = receive.decode_predicted(x, nv, s0, o0, m, ns, kk, cad, b0)
        if launch_counts()["decode_predicted"] != 1:
            fail(f"phase 26 {label}: decode_predicted launched {launch_counts()}")
        ref = receive.decode_predicted_reference(x, nv, s0, o0, m, ns, kk, cad, b0)
        e, rep = compare_predicted(f"phase 26 {label}", out, ref)
        if record is not None:
            record.append((label, out))
        err = max(err, e)
        parts.append(f"{label} {list(x.shape)} K = {kk}: {rep}")
        return out, out["packed"][..., 0].bool().cpu().numpy(), kk - out["start"].shape[1]

    start0 = receive.decode_fused(windows, n_valid, torch.zeros_like(n_valid), mode, n_sym)["start"]
    # slot 5 zeroed, exact DC removal
    zero = 5
    pre = p.silence_pre_chunk(False)
    zeroed = torch.from_numpy(zeroed_exact(windows.cpu().numpy(), nv_k, zero * cadence + pre - 6 * p.cp_len,
                                           (zero + 1) * cadence)).to(dev)
    for branch, pred0 in (("zeroed slot 5, slot 0 from kernel A", None), ("zeroed slot 5, predicted", start0 + 3)):
        out, det, first = run(branch, zeroed, n_valid, mode, n_sym, k, cadence, pred0)
        st6 = out["start"][:, zero + 1 - first]
        if not (det[:, :zero].all() and not det[:, zero:].any() and torch.equal(st6, start0 + (zero + 1) * cadence)
                and bool((out["fine_metric"][:, zero + 1 - first] > 0.9).all())):
            fail(f"phase 26 {branch}: flags {det[0].astype(int).tolist()}, slot 6 at {st6[:4].tolist()}")
    del zeroed
    # clamped predictions, a silent row
    rows = torch.arange(n, device=dev) % 4
    clamped = torch.where((rows == 3)[:, None], 0.0, windows)
    pred0 = torch.where(rows == 0, start0 + 3, torch.where(rows == 1, w - 1, torch.where(rows == 2, w + 10**6, -(10**6))))
    out, det, _ = run("clamped predictions", clamped, n_valid, mode, n_sym, k, cadence, pred0.to(torch.int32))
    silent = out["start"][rows == 3]
    ramp = torch.arange(k, device=dev, dtype=torch.int32) * cadence
    if not (det[rows.cpu().numpy() == 0].all() and not det[rows.cpu().numpy() != 0].any()
            and bool((silent == ramp).all()) and bool((out["start"][(rows == 1) | (rows == 2)] == w - 1).all())):
        fail(f"phase 26 clamped predictions: flags {det[:4].astype(int).tolist()}, silent row starts {silent[0, :4].tolist()}")
    del clamped
    # BPSK-REPEAT at full width
    rep_mode = MODES["BPSK-REPEAT"]
    u8 = bench.turbo_payloads(np.random.default_rng(SEED + 26), n, 8, rep_mode.chunk_size)
    rep_w, rep_cad, rep_sym = bench.turbo_windows(u8, rep_mode, n, 8, dev)
    rep_nv = torch.full((n,), 8 * rep_cad, dtype=torch.int32, device=dev)
    rep_start = None
    for branch in ("slot 0 from kernel A", "predicted"):
        out, _, _ = run(f"BPSK-REPEAT, {branch}", rep_w, rep_nv, rep_mode, rep_sym, 8, rep_cad, rep_start)
        cls = mr._classify_round(out["packed"].cpu().numpy(), rep_mode.chunk_size)
        if cls is None or not (cls[0].all() and cls[2].all() and (cls[3] == np.arange(8)[None, :]).all()):
            fail(f"phase 26 BPSK-REPEAT, {branch}: not every slot detected, CRC-valid and in sequence")
        rep_start = torch.from_numpy(cls[1][:, 0].astype(np.int32)).to(dev) + 3
    del rep_w
    # K = 1
    for branch, pred0 in (("K = 1, slot 0 from kernel A", None), ("K = 1, predicted", start0 + 3)):
        _, det, _ = run(branch, windows, n_valid, mode, n_sym, 1, cadence, pred0)
        if not det.all():
            fail(f"phase 26 {branch}: not every stream detected")
    return err, "; ".join(parts)


def compare_predicted(label: str, out: dict, ref: dict, strict: bool = True) -> tuple[float, str]:
    """Kernel C's output (``receive.decode_predicted``) against its plain
    version's: the cumulative flag equal on every (stream, slot), the fine
    metric within 1e-5 (-inf where the plain version's is), and the payload
    bytes of every detected slot equal. ``strict`` (inputs made for the
    check): start and the packed row's 5-byte head equal on every slot too.
    Otherwise (a live runtime's windows, where a slot predicted into noise or
    silence may pass the 0.1 threshold on a metric that ties, or demodulate
    a channel estimated from silence) start and head are held on detected
    slots, and a detected slot's payload must parse to the plain version's
    frame or both fail to parse, as ``compare_receive(by_frame=True)`` holds
    kernel A; flips are reported. Returns (largest fine error, report)."""
    import torch

    from audio_modem_tpu_torch import decoder, framing

    got, want = out["packed"], ref["packed"]
    if got.shape != want.shape or not torch.equal(out["detected"], ref["detected"]):
        fail(f"{label}: kernel C's slot flags differ from its plain version's")
    first = want.shape[1] - ref["start"].shape[1]
    hold = torch.ones_like(ref["detected"]) if strict else ref["detected"]
    if not torch.equal(out["start"][hold], ref["start"][hold]):
        fail(f"{label}: kernel C's starts differ from its plain version's")
    f, g = out["fine_metric"][hold], ref["fine_metric"][hold]
    fin = torch.isfinite(g)
    err = (f[fin] - g[fin]).abs().max().item() if bool(fin.any()) else 0.0
    if not (torch.equal(torch.isfinite(f), fin) and torch.equal(f[~fin], g[~fin])) or err > 1e-5:
        fail(f"{label}: kernel C's fine metric differs from its plain version's by {err:.3e} (tol 1e-5)")
    rows = want[..., 0].bool()  # detected slots, slot 0 from kernel A included
    heads = torch.ones_like(rows) if strict else torch.cat([torch.ones_like(rows[:, :first]), hold], 1)
    if not torch.equal(got[..., :5][heads], want[..., :5][heads]):
        fail(f"{label}: kernel C's packed heads differ from its plain version's")
    same = (got == want).all(-1)
    bad = rows & ~same
    if strict and bool(bad.any()):
        fail(f"{label}: kernel C's payload differs on {int(bad.sum())} detected slots")
    for i, j in bad.nonzero().tolist():
        a = framing.parse_payload_bytes(got[i, j, 5:].cpu().numpy().tobytes(), min_len=6)
        b = framing.parse_payload_bytes(want[i, j, 5:].cpu().numpy().tobytes(), min_len=6)
        if not (decoder._parse_failed(a) and decoder._parse_failed(b)):
            fail(f"{label}: stream {i} slot {j} decodes to {a!r:.120} against plain {b!r:.120}")
    return err, (f"{int(rows.sum())} of {rows.numel()} slots detected, flags{'' if strict else ' (detected: starts)'} "
                 f"equal, fine err {err:.3e}, payload equal on {int((rows & same).sum())} detected slots"
                 + (f", {int(bad.sum())} detected slots whose payload parses in neither" if bool(bad.any()) else ""))


def main() -> None:
    if not (ROOT / "audio_modem_tpu_torch" / "csrc").is_dir():
        fail(f"no audio_modem_tpu_torch/csrc beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    import faulthandler

    import numpy as np
    import torch

    faulthandler.dump_traceback_later(1100, exit=True)  # a phase that hangs ends the run inside its time limit
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    from audio_modem_tpu_torch import MODES, api, assert_full_fp32, bench, decoder, framing
    from audio_modem_tpu_torch.kernels import _build, launch_counts, receive, reset_launch_counts
    from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
    from audio_modem_tpu_torch.parallel import batch, multi_receiver
    from audio_modem_tpu_torch.roofline import (bound_ms, card_peaks, work_chunks, work_decode_fused,
                                                work_decode_predicted, work_decode_tail, work_stream_demod,
                                                work_stream_scan)

    assert_full_fp32()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    if peaks is None:
        fail(f"no published peaks for {torch.cuda.get_device_name(0)!r} in audio_modem_tpu_torch/roofline.py: "
             "the bounds need the card's memory rate and float32 peak")

    # 1. card
    smi = bench.card_line()
    if smi is None:
        fail("nvidia-smi did not give the card's name and power limit")
    print(smi)
    card = f"[{smi}]"
    print(f"phase 1 card: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR / _build.LIB_NAME})", flush=True)

    # 3. TX on the card
    rng = np.random.default_rng(SEED)
    mode, frames, windows, n_valid, min_pos, n_sym, cadence = turbo_windows(dev, rng)
    p = mode.profile
    sym = p.symbol_len
    chunk = mode.chunk_size
    pre_s = p.silence_pre_chunk(False)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(windows).all()):
        fail("TX produced non-finite samples")
    print(f"phase 3 tx: windows {tuple(windows.shape)} cadence {cadence} n_sym {n_sym}", flush=True)

    # 4. kernel A against plain A
    ka = receive.decode_fused(windows, n_valid, min_pos, mode, n_sym)
    pa = receive.decode_fused_reference(windows, n_valid, min_pos, mode, n_sym)
    torch.cuda.synchronize()
    if not bool(ka["detected"].all()):
        fail("kernel A: not every stream detected")
    err_fine, err_ch, flips, n_in, _ = compare_receive("kernel A", ka, pa, n_valid, mode)
    print(f"phase 4 kernel A vs plain: start/coarse/coarse metric/detected equal, fine err {err_fine:.3e} "
          f"(tol 1e-5), ch err {err_ch:.3e} (tol 1e-4), flipped in-frame bits {flips} of {n_in}", flush=True)

    # 5. kernel B against plain B on frame-aligned frames (first frame of each stream)
    aligned = frames.reshape(N_STREAMS, K, cadence)[:, 0, pre_s : pre_s + (3 + n_sym) * sym].contiguous()
    n_bits = n_sym * bits_per_symbol(mode)
    kb_bits = receive.decode_chunks_fused(aligned, mode, n_sym)
    kb = bits_to_bytes(kb_bits[:, :n_bits])
    pb = bits_to_bytes(receive.decode_chunks_fused_reference(aligned, mode, n_sym)[:, :n_bits])
    torch.cuda.synchronize()
    err_b = (kb.to(torch.int32) - pb.to(torch.int32)).abs().max().item()
    print(f"phase 5 kernel B vs plain: packed bytes {'equal' if err_b == 0 else 'DIFFER'} "
          f"({kb.shape[0]} x {kb.shape[1]})", flush=True)
    if err_b:
        fail("kernel B packed bytes differ from plain")

    # 6. the main path, launch counts from zero
    reset_launch_counts()
    packed = multi_receiver._batch_window_decode_multi(windows, min_pos, n_valid, mode, n_sym, K, cadence)
    by_rows = batch.batch_decode_chunk_frames_packed(aligned, mode, n_sym)
    torch.cuda.synchronize()
    counts = launch_counts()
    cls = multi_receiver._classify_round(packed.cpu().numpy(), chunk)
    if cls is None:
        fail("turbo packed rows too narrow")
    det, _, full, seq = cls
    if not det.all():
        fail(f"turbo round: {int((~det).sum())} slots not detected")
    if not full.all():
        fail(f"turbo round: {int((~full).sum())} slots not CRC-valid")
    if not (seq == np.arange(K)[None, :]).all():
        fail("turbo round: sequence numbers out of order")
    for row in by_rows.cpu().numpy():
        parsed = framing.parse_payload_bytes(row.tobytes())
        if not (isinstance(parsed, framing.DataFrame) and parsed.crc_valid and parsed.seq_num == 0):
            fail("frame-aligned demod: a frame failed its CRC")
    if min(counts["decode_fused"], counts["decode_chunks_fused"]) < 1 or counts["decode_predicted"] != 1:
        fail(f"a kernel of the turbo path never launched, or kernel C not once a round: {counts}")
    print(f"phase 6 main path: {N_STREAMS} x {K} slots detected, CRC-valid, in sequence; "
          f"{N_STREAMS} aligned frames CRC-valid; launches {counts}", flush=True)

    # 7. times (plain and kernel in turns within this call)
    t_round = time_ms(lambda: multi_receiver._batch_window_decode_multi(
        windows, min_pos, n_valid, mode, n_sym, K, cadence))
    msps = K * cadence * N_STREAMS / (t_round * 1e-3) / 1e6
    run_a = lambda: receive.decode_fused(windows, n_valid, min_pos, mode, n_sym)  # noqa: E731
    plain_a = lambda: receive.decode_fused_reference(windows, n_valid, min_pos, mode, n_sym)  # noqa: E731
    run_b = lambda: receive.decode_chunks_fused(aligned, mode, n_sym)  # noqa: E731
    plain_b = lambda: receive.decode_chunks_fused_reference(aligned, mode, n_sym)  # noqa: E731
    pa1, ka1, ka2, pa2 = time_ms(plain_a), time_ms(run_a), time_ms(run_a), time_ms(plain_a)
    pb1, kb1, kb2, pb2 = time_ms(plain_b), time_ms(run_b), time_ms(run_b), time_ms(plain_b)
    ms_a, plain_ms_a = statistics.median([ka1, ka2]), statistics.median([pa1, pa2])
    ms_b, plain_ms_b = statistics.median([kb1, kb2]), statistics.median([pb1, pb2])
    bound_a = bound_ms(*work_decode_fused(mode, N_STREAMS, windows.shape[1], n_sym), peaks)
    bound_b = bound_ms(*work_chunks(mode, N_STREAMS, aligned.shape[1], n_sym), peaks)
    print(f"phase 7 times {card}: turbo round {t_round:.3f} ms = {msps:.1f} Msamples/s; "
          f"kernel A {ms_a:.3f} ms (runs {ka1:.3f}, {ka2:.3f}) vs plain A {plain_ms_a:.3f} ms "
          f"(runs {pa1:.3f}, {pa2:.3f}), bound {bound_a[0]:.4f} ms ({bound_a[1]}), roofline share "
          f"{bound_a[0] / ms_a:.1%}; kernel B {ms_b:.3f} ms ({kb1:.3f}, {kb2:.3f}) vs plain B "
          f"{plain_ms_b:.3f} ms ({pb1:.3f}, {pb2:.3f}), bound {bound_b[0]:.4f} ms ({bound_b[1]}), "
          f"roofline share {bound_b[0] / ms_b:.1%}", flush=True)
    # kernel C on the same round, both branches: slot 0 from kernel A (phase 4's output), or every slot
    # predicted from slot 0's start as the receiver's steady state predicts it
    c_args = {"slot 0 from kernel A": (ka["start"], ka["detected"], ka["bits"]),
              "every slot predicted": ((ka["start"] - cadence).to(torch.int32), torch.ones_like(ka["detected"]), None)}
    err_c, c_times, c_digests = 0.0, {}, {}
    for label, (s0, o0, b0) in c_args.items():
        out_c = receive.decode_predicted(windows, n_valid, s0, o0, mode, n_sym, K, cadence, b0)
        ref_c = receive.decode_predicted_reference(windows, n_valid, s0, o0, mode, n_sym, K, cadence, b0)
        e, rep = compare_predicted(f"kernel C ({label})", out_c, ref_c)
        c_digests[label] = {key: hashlib.sha256(out_c[key].cpu().numpy().tobytes()).hexdigest()[:16]
                            for key in ("start", "fine_metric", "detected", "packed")}
        cls_c = multi_receiver._classify_round(out_c["packed"].cpu().numpy(), chunk)
        if not (cls_c[0].all() and cls_c[2].all() and (cls_c[3] == np.arange(K)[None, :]).all()):
            fail(f"kernel C ({label}): not every slot detected, CRC-valid and in sequence")
        err_c = max(err_c, e)
        del out_c, ref_c
        run_c = lambda: receive.decode_predicted(windows, n_valid, s0, o0, mode, n_sym, K, cadence, b0)  # noqa: E731
        plain_c = lambda: receive.decode_predicted_reference(  # noqa: E731
            windows, n_valid, s0, o0, mode, n_sym, K, cadence, b0)
        pc1, kc1, kc2, pc2 = (time_ms(f, reps=5, warm=1) for f in (plain_c, run_c, run_c, plain_c))
        n_pred = K - (b0 is not None)
        bound_c = bound_ms(*work_decode_predicted(mode, N_STREAMS, windows.shape[1], n_sym, n_pred), peaks)
        c_times[label] = (statistics.median([kc1, kc2]), statistics.median([pc1, pc2]), bound_c)
        print(f"phase 7 kernel C ({label}, {n_pred} predicted slots) vs plain: {rep}; all {N_STREAMS} x {K} slots "
              f"CRC-valid, in sequence; {card} kernel C {c_times[label][0]:.3f} ms ({kc1:.3f}, {kc2:.3f}) vs plain "
              f"{c_times[label][1]:.3f} ms ({pc1:.3f}, {pc2:.3f}), bound {bound_c[0]:.4f} ms ({bound_c[1]}), "
              f"roofline share {bound_c[0] / c_times[label][0]:.1%}", flush=True)
        split = launch_split(run_c)
        print(f"phase 7 kernel C's launches ({label}) {card}, device ms a call (torch.profiler, 5 calls): "
              + ("; ".join(f"{name} {ms:.4f}" for name, ms in split) if split else "not measured (no device time)")
              + f"; C's bound {bound_c[0]:.4f} ms ({bound_c[1]}), share of the launches' sum "
              + (f"{bound_c[0] / sum(ms for _, ms in split):.1%}" if split else "not measured"), flush=True)
    ms_c, plain_ms_c, bound_c = c_times["every slot predicted"]

    # 8. streaming demod against its plain version and kernel B
    stream_frames = {}
    err_s = 0  # largest |kernel bit - plain bit| of the streaming demod
    for name, size in (("BPSK-NARROW", 512), ("QPSK", 2048)):
        m = MODES[name]
        pm = m.profile
        ns = framing.num_symbols_for_payload(size + 11, m)
        fr = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(N_STREAMS)], 0, m, device=dev)
        pre = pm.silence_pre_chunk(False)
        fr = fr[:, pre : pre + (3 + ns) * pm.symbol_len].contiguous()
        ks = receive.decode_chunks_fused_stream(fr, m, ns)
        ps = receive.decode_chunks_fused_reference(fr, m, ns)
        kb8 = receive.decode_chunks_fused(fr, m, ns)
        torch.cuda.synchronize()
        flips_plain = int((ks != ps).sum().item())
        err_s = max(err_s, int((ks.to(torch.int32) - ps).abs().max().item()))
        flips_b = int((ks != kb8).sum().item())
        for row in batch.batch_decode_chunk_frames_packed(fr, m, ns).cpu().numpy():
            parsed = framing.parse_payload_bytes(row.tobytes())
            if not (isinstance(parsed, framing.DataFrame) and parsed.crc_valid):
                fail(f"{name}: a chunk frame failed its CRC")
        by = bits_to_bytes(ks if m.repetition == 1 else majority_vote(ks, m.repetition)).cpu().numpy()
        for row in by:
            parsed = framing.parse_payload_bytes(row.tobytes())
            if not (isinstance(parsed, framing.DataFrame) and parsed.crc_valid):
                fail(f"{name}: the streaming demod's bits fail the CRC")
        print(f"phase 8 stream demod {name}: frames {tuple(fr.shape)} n_sym {ns}; flipped bits vs plain "
              f"{flips_plain}, vs kernel B {flips_b} of {ks.numel()}; all {N_STREAMS} CRC-valid", flush=True)
        if flips_plain or flips_b:
            fail(f"{name}: streaming demod differs from its plain version or kernel B")
        stream_frames[name] = (fr, m, ns)

    # 9. single-signal decode (BASELINE config 2), launch counts from zero
    mode2, data2, noisy2 = config2_signal(dev)
    data3 = np.random.default_rng(SEED + 3).bytes(32 * 1024 - 32)
    sig3 = api.encode(data3, "QPSK", "q.bin", device=dev)[0]
    if sig3.shape[0] != 392_418:
        fail(f"QPSK legacy TX: {sig3.shape[0]} samples")
    decode_inputs: dict = {}
    decode_launches = Counter()  # kernel A's and the tail's launches on the decode path (phase 9)
    real_core = decoder._core_dispatch
    for label, sig, m, want in (("config 2", noisy2, mode2, data2), ("QPSK legacy", sig3, MODES["QPSK"], data3)):
        cores = []

        def core(*args, **kw):
            cores.append(1)
            return real_core(*args, **kw)

        decoder._core_dispatch = core
        try:
            with path_inputs(decode_inputs, label):
                reset_launch_counts()
                res, info = api.decode(sig, m, device=dev)
                torch.cuda.synchronize()
                counts9 = launch_counts()
        finally:
            decoder._core_dispatch = real_core
        if not (isinstance(res, framing.LegacyFrame) and res.crc_valid and res.data == want):
            fail(f"{label}: api.decode gave {getattr(res, 'error', type(res).__name__)}")
        if counts9["decode_fused"] != len(cores) or counts9["decode_tail"] != len(cores) or counts9["stream_demod"]:
            fail(f"{label}: {len(cores)} core calls of the decoder, launches {counts9}")
        decode_launches.update(counts9)
        print(f"phase 9 api.decode {label}: {sig.shape[0]} samples -> {len(res.data)} exact bytes, CRC valid, "
              f"preamble {info.preamble_idx}; {len(cores)} core call(s), launches {counts9}", flush=True)
    want9 = {(kernel, f"{label} decoder") for kernel in ("decode_fused", "decode_tail")
             for label in ("config 2", "QPSK legacy")}
    if not want9 <= {k[:2] for k in decode_inputs}:
        fail(f"phase 9: the decoder's kernel inputs recorded only at {sorted({k[:2] for k in decode_inputs})}")
    err9, checked = check_path_inputs("phase 9", decode_inputs, clean=("QPSK legacy decoder",))
    print(f"phase 9 kernel A and the tail against their plain versions on the decoder's inputs: {checked}",
          flush=True)
    del decode_inputs
    n2 = noisy2.shape[0]
    padded2 = decoder.pad_to_bucket(noisy2)
    ms2 = decoder._max_symbols(padded2.shape[0], mode2)
    nv2 = torch.tensor([n2], dtype=torch.int32, device=dev)
    mp2 = torch.zeros(1, dtype=torch.int32, device=dev)
    kl = receive.decode_long_fused(padded2[None], nv2, mp2, mode2, ms2)
    pl = receive.decode_fused_reference(padded2[None], nv2, mp2, mode2, ms2)
    torch.cuda.synchronize()
    for key in ("start", "coarse", "detected"):
        if not torch.equal(kl[key], pl[key]):
            fail(f"decode_long_fused {key} differs from plain: {kl[key].tolist()} vs {pl[key].tolist()}")
    err_fine_l = (kl["fine_metric"] - pl["fine_metric"]).abs().max().item()
    err_ch_l = max((kl[k] - pl[k]).abs().max().item() for k in ("ch_re", "ch_im"))
    n_pay = (n2 - (int(kl["start"][0]) + 3 * mode2.profile.symbol_len)) // mode2.profile.symbol_len
    nb2 = n_pay * bits_per_symbol(mode2)
    flips_l = int((kl["bits"][0, :nb2] != pl["bits"][0, :nb2]).sum().item())
    err_s = max(err_s, int((kl["bits"][0, :nb2].to(torch.int32) - pl["bits"][0, :nb2]).abs().max().item()))
    print(f"phase 9 decode_long_fused vs plain on config 2 (max_syms {ms2}): start/coarse/detected equal, "
          f"fine err {err_fine_l:.3e} (tol 1e-5), ch err {err_ch_l:.3e} (tol 1e-4), flipped payload bits "
          f"{flips_l} of {nb2}", flush=True)
    if err_fine_l > 1e-5 or err_ch_l > 1e-4 or flips_l:
        fail("decode_long_fused outside tolerance")
    ka_1 = receive.decode_fused(padded2[None], nv2, mp2, mode2, ms2)
    torch.cuda.synchronize()
    if not bool(ka_1["detected"][0]):
        fail("kernel A at B = 1: config 2 not detected")
    err_fine_1, err_ch_1, flips_1, n_in_1, _ = compare_receive("kernel A at B = 1", ka_1, pl, nv2, mode2)
    print(f"phase 9 kernel A vs plain at B = 1 on config 2 ({padded2.shape[0]} samples, max_syms {ms2}): "
          f"start/coarse/coarse metric/detected equal, fine err {err_fine_1:.3e} (tol 1e-5), ch err "
          f"{err_ch_1:.3e} (tol 1e-4), flipped in-frame bits {flips_1} of {n_in_1}", flush=True)

    # 10. times (kernel and plain in turns)
    head, region = receive._front_end(padded2[None], nv2, mp2, mode2, ms2)
    ones = torch.ones(1, dtype=torch.float32, device=dev)
    run_s = lambda: receive.stream_demod(region, head["ch_re"], head["ch_im"], ones, mode2, ms2)  # noqa: E731
    plain_s = lambda: receive.stream_demod_reference(region, head["ch_re"], head["ch_im"], ones, mode2, ms2)  # noqa: E731
    ps1, ks1, ks2, ps2 = time_ms(plain_s), time_ms(run_s), time_ms(run_s), time_ms(plain_s)
    ms_s, plain_ms_s = statistics.median([ks1, ks2]), statistics.median([ps1, ps2])
    run_l = lambda: receive.decode_long_fused(padded2[None], nv2, mp2, mode2, ms2)  # noqa: E731
    run_a1 = lambda: receive.decode_fused(padded2[None], nv2, mp2, mode2, ms2)  # noqa: E731
    ta1, tl1, tl2, ta2 = (time_ms(f, reps=5, warm=1) for f in (run_a1, run_l, run_l, run_a1))
    ms_a1 = statistics.median([ta1, ta2])
    bound_a1 = bound_ms(*work_decode_fused(mode2, 1, padded2.shape[0], ms2), peaks)
    bound_s = bound_ms(*work_stream_demod(mode2, 1, ms2), peaks)
    fr_n, m_n, ns_n = stream_frames["BPSK-NARROW"]
    run_cs = lambda: receive.decode_chunks_fused_stream(fr_n, m_n, ns_n)  # noqa: E731
    run_cb = lambda: receive.decode_chunks_fused(fr_n, m_n, ns_n)  # noqa: E731
    tb1, tcs1, tcs2, tb2 = time_ms(run_cb), time_ms(run_cs), time_ms(run_cs), time_ms(run_cb)
    tail_args = tuple(ka_1[k] for k in ("coarse", "start", "fine_metric", "bits", "ch_re", "ch_im"))
    run_t = lambda: receive.decode_tail(*tail_args, mode2.repetition)  # noqa: E731
    plain_t = lambda: receive.decode_tail_reference(*tail_args, mode2.repetition)  # noqa: E731
    pt1, kt1, kt2, pt2 = time_ms(plain_t), time_ms(run_t), time_ms(run_t), time_ms(plain_t)
    # A call of either is shorter than its host launch, which the events take in: the device
    # time a call comes from the profiler (the events' times where it sees none)
    split_t, split_p = launch_split(run_t, reps=10), launch_split(plain_t, reps=10)
    ms_t = sum(ms for _, ms in split_t) if split_t else statistics.median([kt1, kt2])
    plain_ms_t = sum(ms for _, ms in split_p) if split_p else statistics.median([pt1, pt2])
    n_bits_t, n_active_t = ka_1["bits"].shape[1], ka_1["ch_re"].shape[1]
    row_t = receive.tail_row_bytes(n_bits_t, n_active_t, mode2.repetition)
    bound_t = bound_ms(*work_decode_tail(1, n_bits_t, n_active_t, row_t), peaks)
    walls10 = decode_walls(noisy2, mode2, dev)
    print(f"phase 10 times {card}: stream_demod on config 2 ({ms2} symbols) {ms_s:.3f} ms ({ks1:.3f}, "
          f"{ks2:.3f}) vs plain {plain_ms_s:.3f} ms ({ps1:.3f}, {ps2:.3f}); B = 1 decode_long_fused "
          f"{statistics.median([tl1, tl2]):.3f} ms ({tl1:.3f}, {tl2:.3f}) vs kernel A "
          f"{ms_a1:.3f} ms ({ta1:.3f}, {ta2:.3f}), kernel A's bound {bound_a1[0]:.4f} ms ({bound_a1[1]}), "
          f"roofline share {bound_a1[0] / ms_a1:.1%}; stream_demod's bound {bound_s[0]:.4f} ms "
          f"({bound_s[1]}), roofline share {bound_s[0] / ms_s:.1%}; 64 narrowband frames "
          f"decode_chunks_fused_stream {statistics.median([tcs1, tcs2]):.3f} ms ({tcs1:.3f}, {tcs2:.3f}) vs "
          f"kernel B {statistics.median([tb1, tb2]):.3f} ms ({tb1:.3f}, {tb2:.3f}); decode_tail on config 2's "
          f"kernel A row ({n_bits_t} bits, {n_active_t} bins, a {row_t}-byte row) {ms_t:.4f} ms on the device "
          f"({'profiler' if split_t else 'no profiler time, events'}: {split_t}) vs plain {plain_ms_t:.4f} ms "
          f"({len(split_p)} kernels), between events with the host's launch {kt1:.4f}, {kt2:.4f} vs plain "
          f"{pt1:.4f}, {pt2:.4f} ms, its bound {bound_t[0]:.5f} ms ({bound_t[1]}), roofline share "
          f"{bound_t[0] / ms_t:.1%}; host wall of api.decode of a "
          f"signal on the card, median of 10 a route, {walls_line('config 2', n2, walls10)}", flush=True)

    # 11. digests of the kernels' bits
    digests = {name: hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]
               for name, bits in (("decode_fused", ka["bits"]), ("decode_chunks_fused", kb_bits),
                                  ("stream_demod", kl["bits"]))}
    print("phase 11 digests of the kernels' bits (phases 4, 5, 9): "
          + ", ".join(f"{k} {v}" for k, v in digests.items()), flush=True)
    for label, dig in c_digests.items():
        print(f"phase 11 digests of kernel C ({label}, phase 7): chain "
              + ", ".join(f"{k} {dig[k]}" for k in ("start", "fine_metric", "detected"))
              + f"; packed rows {dig['packed']}", flush=True)

    # 12. chunked receive, BASELINE config 3 at full width
    data12 = np.random.default_rng(SEED + 12).bytes(1 << 20)
    frames12 = chunked_frames(data12, "QPSK", "config3.bin", dev)
    counts12, line = chunked_receive("chunked QPSK", data12, "QPSK", np.concatenate(frames12), dev, runs=2)
    chunked_launches = counts12["stream_demod"]
    print(f"phase 12 chunked receive QPSK {card}: {line}", flush=True)
    # stream_demod as that path calls it: one frame, B = 1, the symbol bucket of a 2048-byte chunk
    m12 = MODES["QPSK"]
    pre12 = m12.profile.silence_pre_chunk(False)
    fr12, _, nb12 = decoder.pad_aligned_frame(frames12[1][pre12:] / np.abs(frames12[1]).max(), m12, device=dev)
    ch12 = decoder._frame_channel(fr12, m12)
    region12 = fr12[None, 3 * m12.profile.symbol_len :]
    run_f = lambda: receive.stream_demod(region12, ch12[0][None], ch12[1][None], ones, m12, nb12)  # noqa: E731
    plain_f = lambda: receive.stream_demod_reference(  # noqa: E731
        region12, ch12[0][None], ch12[1][None], ones, m12, nb12)
    if not torch.equal(run_f(), plain_f()):
        fail("stream_demod differs from its plain version on a chunk frame")
    pf1, kf1, kf2, pf2 = time_ms(plain_f), time_ms(run_f), time_ms(run_f), time_ms(plain_f)
    ms_f = statistics.median([kf1, kf2])
    bound_f = bound_ms(*work_stream_demod(m12, 1, nb12), peaks)
    print(f"phase 12 stream_demod on one chunk frame ({nb12} symbols, B = 1) {card}: {ms_f:.4f} ms ({kf1:.4f}, "
          f"{kf2:.4f}) vs plain {statistics.median([pf1, pf2]):.4f} ms ({pf1:.4f}, {pf2:.4f}), bound "
          f"{bound_f[0]:.6f} ms ({bound_f[1]}); {chunked_launches} launches x (time - bound) = "
          f"{chunked_launches * (ms_f - bound_f[0]):.1f} ms of the transfer", flush=True)
    # stream_scan as the receiver calls it: one full window around the first data frame's preamble, B = 1
    from audio_modem_tpu_torch.runtime.receiver import SCAN_BUCKET, STREAM_MIN_ENERGY

    sig12 = np.concatenate(frames12[:3])
    w12 = torch.from_numpy(np.ascontiguousarray(sig12[len(frames12[0]) + pre12 - 3000:][:SCAN_BUCKET])).to(dev)
    out_sc = torch.empty((1, 2), dtype=torch.int32, device=dev)
    run_sc = lambda: receive.stream_scan(w12[None], SCAN_BUCKET, m12.profile, STREAM_MIN_ENERGY, out_sc)  # noqa: E731
    plain_sc = lambda: receive.stream_scan_reference(  # noqa: E731
        w12[None], SCAN_BUCKET, m12.profile, STREAM_MIN_ENERGY)
    row_sc, ref_sc = run_sc(), plain_sc()
    if not torch.equal(row_sc, ref_sc) or int(row_sc[0, 0]) < 0:
        fail(f"stream_scan gave {row_sc.tolist()} on a window with a preamble, its plain version {ref_sc.tolist()}")
    psc1, ksc1, ksc2, psc2 = time_ms(plain_sc), time_ms(run_sc), time_ms(run_sc), time_ms(plain_sc)
    plain_ms_sc = statistics.median([psc1, psc2])
    split_sc = launch_split(run_sc, reps=20)
    ms_sc = sum(ms for _, ms in split_sc) or None
    bound_sc = bound_ms(*work_stream_scan(1, SCAN_BUCKET, receive._scan_positions(SCAN_BUCKET, m12.profile)), peaks)
    print(f"phase 12 stream_scan on one window ({SCAN_BUCKET} samples, B = 1, coarse {int(row_sc[0, 0])}) {card}: "
          f"between events with the host's launch {statistics.median([ksc1, ksc2]):.4f} ms ({ksc1:.4f}, {ksc2:.4f}) vs "
          f"plain {plain_ms_sc:.4f} ms ({psc1:.4f}, {psc2:.4f}); device time "
          f"{ms_sc or 0.0:.5f} ms ({split_sc or 'no profiler time'}), bound {bound_sc[0]:.6f} ms ({bound_sc[1]}), "
          f"roofline share {bound_sc[0] / ms_sc if ms_sc else 0.0:.2%}", flush=True)

    # 13. the same at a second symbol length, behind noise
    data13 = np.random.default_rng(SEED + 13).bytes(8 << 10)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    gap = (torch.randn(20000, generator=gen, device=dev) * 1e-3).cpu().numpy()
    sig13 = np.concatenate([gap] + chunked_frames(data13, "BPSK-NARROW", "narrow.bin", dev))
    counts13, line = chunked_receive("chunked BPSK-NARROW", data13, "BPSK-NARROW", sig13, dev, runs=1)
    print(f"phase 13 chunked receive BPSK-NARROW {card}: 20000 samples of noise at 1e-3, then {line}", flush=True)

    # 14. persist and resume
    print(f"phase 14 persist/resume: {resume_receive(data12, frames12, 'QPSK', dev)}", flush=True)
    del frames12

    # 15. device-ring rounds
    ring_launches, line = ring_rounds(dev, mode, frames, n_sym, cadence)
    print(f"phase 15 device ring {card}: {line}", flush=True)

    # 16. the retry ladder's timing tracker
    walls16 = []
    for _ in range(3):
        t0 = time.perf_counter()
        res16, _ = api.decode(sig3, "QPSK", track_timing=True, device=dev)
        walls16.append((time.perf_counter() - t0) * 1e3)
        if not (isinstance(res16, framing.LegacyFrame) and res16.crc_valid and res16.data == data3):
            fail(f"api.decode(track_timing=True): {getattr(res16, 'error', type(res16).__name__)}")
    print(f"phase 16 retry ladder {card}: api.decode(track_timing=True) of the {sig3.shape[0]}-sample QPSK frame -> "
          f"{len(data3)} exact bytes; wall {statistics.median(walls16):.1f} ms (runs "
          f"{', '.join(f'{w:.1f}' for w in walls16)})", flush=True)

    # 17. BatchReceiver, host-fed (staged and turbo)
    launches17, err17, line = batch_receive_host(dev)
    print(f"phase 17 BatchReceiver host-fed {card}: {line}", flush=True)

    # 18. BatchReceiver, device ingest, steady state
    launches18, err18, line, ref18 = batch_receive_device(dev)
    print(f"phase 18 BatchReceiver device ingest {card}: {line}", flush=True)

    # 19. the CLI on the card; 20. ARQ and the loopback curve
    app_inputs: dict = {}
    small19 = np.random.default_rng(SEED + 19).bytes(32 * 1024 - 32)
    launches19, line = cli_phase(app_inputs, small19, data12, 1 + -(-len(data12) // chunk))
    print(f"phase 19 cli {card}: {line}", flush=True)
    launches20, line = arq_phase(dev, app_inputs, data12)
    print(f"phase 20 arq and loopback curve {card}: {line}", flush=True)
    tags = {k[:2] for k in app_inputs}
    if not {("stream_demod", "cli"), ("stream_demod", "arq"), ("decode_chunks_fused", "batch arq"),
            ("decode_fused", "cli decoder"), ("decode_fused", "arq decoder")} <= tags:
        fail(f"phases 19-20: kernel inputs recorded only at {sorted(k[:3] for k in app_inputs)}")
    err20, checked = check_path_inputs("phases 19-20", app_inputs,
                                       clean=("cli decoder", "arq decoder", "batch arq decoder"))
    print(f"phase 20 kernels against their plain versions on the inputs of phases 19-20: {checked}", flush=True)

    # 21. the receiver sharded over a mesh; 22. entry points and the cluster; 23. soak and demo
    launches21, err21, line = mesh_receive(dev, ref18)
    print(f"phase 21 mesh {card}: {line}", flush=True)
    del ref18
    cluster_inputs: dict = {}
    launches22, line = entry_and_cluster(dev, cluster_inputs)
    print(f"phase 22 entry and cluster {card}: {line}", flush=True)
    err22, checked = check_path_inputs("phase 22", cluster_inputs, clean=tuple({k[1] for k in cluster_inputs}))
    print(f"phase 22 kernels against their plain versions on the inputs of entry() and dryrun_multichip "
          f"(each shard): {checked}", flush=True)
    soak_inputs: dict = {}
    launches23, line = soak_and_demo(dev, soak_inputs)
    print(f"phase 23 soak and demo {card}: {line}", flush=True)
    err23, checked = check_path_inputs("phase 23", soak_inputs, noisy=("lossy",))
    print(f"phase 23 kernels against their plain versions on the inputs of phase 23: {checked}", flush=True)

    # 24. the bench at its default sizes
    bench_inputs: dict = {}
    launches24, line, clean24 = bench_phase(bench_inputs)
    print(f"phase 24 bench {card}: {line}", flush=True)
    err24, checked = check_path_inputs("phase 24", bench_inputs, clean=clean24)
    print(f"phase 24 kernels against their plain versions at every shape and mode of the bench: {checked}", flush=True)
    del bench_inputs

    # 25. the JAX package's test contract on the card
    t25 = time.perf_counter()
    contract_inputs: dict = {}
    launches25, line, walls25, clean25 = contract_phase(dev, contract_inputs)
    print(f"phase 25 contract {card}: {line}", flush=True)
    stream_errs25: list = []
    err25, checked = check_path_inputs("phase 25", contract_inputs, clean=clean25, stream_errs=stream_errs25)
    print(f"phase 25 kernel A and the streaming demod against their plain versions on the inputs of phase 25: "
          f"{checked}", flush=True)
    del contract_inputs
    print(f"phase 25 walls {card}: phase {time.perf_counter() - t25:.2f} s; host wall of api.decode of host audio, "
          f"median of 10 a route: " + "; ".join(walls_line(label, n, w) for label, (n, w) in walls25.items()),
          flush=True)

    # 26. kernel C on edge inputs at full width
    err26, line = predicted_edges(dev, mode, windows, n_sym, cadence)
    print(f"phase 26 kernel C on edge inputs {card}: {line}", flush=True)

    batch_launches = (launches17 + launches18 + launches19 + launches20 + launches21 + launches22 + launches23
                      + launches24 + launches25)
    print(f"phases 1-26 passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    source = "audio_modem_tpu_torch/csrc/receive.cu"
    print(json.dumps({"kernels": [
        {"name": "decode_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:375",
         "launches": counts["decode_fused"] + decode_launches["decode_fused"] + ring_launches["decode_fused"]
         + batch_launches["decode_fused"],
         "max_abs_err": max(err_fine, err_ch, err_fine_1, err_ch_1, err9, err17, err18, err20, err21, err22, err23,
                            err24, err25),
         "ms": ms_a, "plain_ms": plain_ms_a,
         "bound_ms": bound_a[0], "bound_by": bound_a[1], "library_ms": None},
        {"name": "decode_predicted", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/parallel/multi_receiver.py:314-330",
         "launches": counts["decode_predicted"] + ring_launches["decode_predicted"]
         + batch_launches["decode_predicted"],
         "max_abs_err": max(err_c, err26, PATH_ERR_C[0]), "ms": ms_c, "plain_ms": plain_ms_c,
         "bound_ms": bound_c[0], "bound_by": bound_c[1], "library_ms": None},
        {"name": "decode_chunks_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:604",
         "launches": counts["decode_chunks_fused"] + batch_launches["decode_chunks_fused"],
         "max_abs_err": float(err_b), "ms": ms_b, "plain_ms": plain_ms_b,
         "bound_ms": bound_b[0], "bound_by": bound_b[1], "library_ms": None},
        {"name": "stream_demod", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:666, :728",
         "launches": counts12["stream_demod"] + counts13["stream_demod"] + batch_launches["stream_demod"],
         "max_abs_err": max([float(err_s), *stream_errs25]), "ms": ms_s, "plain_ms": plain_ms_s,
         "bound_ms": bound_s[0], "bound_by": bound_s[1], "library_ms": None},
        {"name": "decode_tail", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/decoder.py:298, :316-318",
         "launches": decode_launches["decode_tail"] + batch_launches["decode_tail"],
         "max_abs_err": PATH_ERR_TAIL[0], "ms": ms_t, "plain_ms": plain_ms_t,
         "bound_ms": bound_t[0], "bound_by": bound_t[1], "library_ms": None},
        {"name": "stream_scan", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/runtime/receiver.py:49-50 (plain jnp)",
         "launches": counts12["stream_scan"] + counts13["stream_scan"],
         "max_abs_err": 0.0, "ms": ms_sc, "plain_ms": plain_ms_sc,
         "bound_ms": bound_sc[0], "bound_by": bound_sc[1], "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
