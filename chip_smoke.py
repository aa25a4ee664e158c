#!/usr/bin/env python3
"""Smoke run of the PyTorch port (audio_modem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at full size: the turbo receive round (64 QPSK
streams, 2048-byte chunks, 32 frames per round; BASELINE config 5), the
single-signal decode (api.encode -> api.decode of a 32,736-byte file as one
BPSK-REPEAT legacy frame of 7,906,500 samples under 12 dB AWGN; BASELINE
config 2), the chunked-file receive (api.encode_chunked ->
api.decode_chunked of a 1 MiB file in QPSK, 513 frames, 14.6 M samples;
BASELINE config 3) and the multi-stream runtime (BatchReceiver, 64 QPSK
streams fed in lockstep blocks of 65,536 samples; BASELINE config 5).
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
     (_batch_window_decode_multi) and the frame-aligned packed demod of its
     frames; every slot must be detected, CRC-valid and in sequence
  7. times from CUDA events (median of 10 after warm-up, plain and kernel
     in turns); kernels A and B beside their bounds and roofline shares
  8. the streaming demod (decode_chunks_fused_stream) against its plain
     version and kernel B on 64 BPSK-NARROW 512-byte chunk frames (598
     symbols of 768 samples) and 64 QPSK 2048-byte chunk frames (41 of 576)
  9. the single-signal decode with launch counts from zero: config 2 and a
     clean 32,736-byte QPSK legacy frame through api.decode on the card,
     exact bytes; decode_long_fused and kernel A at B = 1 against their
     plain version on config 2's padded signal (the checks of phase 4)
 10. times: stream_demod vs plain on config 2's 12,361-symbol data region,
     decode_long_fused vs kernel A at B = 1 (kernel A beside its bound),
     the streaming demod vs kernel B on the 64 narrowband frames, one
     api.decode of config 2 (host clock)
 11. SHA-256 of the int8 bits the three kernels gave in phases 4, 5 and 9:
     two checkouts whose kernels agree bit for bit print the same digests
     (tools/torch_kernel_digest.py prints them for more inputs)
 12. the chunked receive with launch counts from zero: a seeded 1 MiB file
     through api.encode_chunked on the card, brought to the host as audio,
     through api.decode_chunked(device="cuda") twice: complete, 512 chunks,
     none missing, no CRC error, exact bytes, stream_demod launched once per
     frame; wall time, Msamples/s, multiple of real time, and the host's
     ms per scan, refine and frame-decode call (second run)
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
     sequence; decode_fused launches in round 1 only; both rounds' ms, the
     ring's write and gather ms
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
     predicted rounds carry at least the scanned rounds' samples,
     speculative fetches happened; wall, Msamples/s, real-time streams,
     the receiver's stage split and launches; then the same transfer at
     pipeline_depth 0, exact, its wall beside depth 8's. Then rows that
     differ: 8 seeded files of 64 chunks, stream i carrying file i % 8
     behind 3,001 * i samples of noise; a warm and a timed pass, each
     stream's own file exact, wall and stage split, and the [64, 232,320]
     window cut out of the ring for lockstep and for staggered rows. Kernel
     A against its plain version on the first input of each shape the warm
     passes gave it (the startup windows [64, 65,536] at max_syms 110, slot
     0 of the scanned K-rounds at [64, 232,320], the shorter tail rounds)

then the kernels as one JSON line (time, plain time, launches summed over
the paths of phases 6, 9, 12, 13, 15, 17 and 18, each counted from zero,
the bound: bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
whichever is larger, from this run's shapes, each DFT counted at the cost
of a real-input FFT), and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero. There is no
CPU fallback: without a CUDA device the script stops before any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_STREAMS = 64
K = 32
SEED = 0
# Published H100 SXM peaks at 700 W: HBM3 bytes/s, float32 FLOP/s without tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fft_flops(mode, n_ffts: int) -> float:
    """Real-input FFTs of fft_size samples, 2.5 N log2 N flops each: the least
    work that yields the active, data and pilot bins of a symbol."""
    n = mode.profile.fft_size
    return 2.5 * n * math.log2(n) * n_ffts


def work_decode_fused(mode, b: int, t: int, max_syms: int) -> tuple[float, float]:
    """(bytes, flops) of kernel A: window, tables and outputs once; mean, normalize
    (2), block sums (4 per sample), window sums and metric (~50 per position),
    the +-3*CP refine (2 FMAs per tap), one FFT for the CE and one per symbol."""
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

    p = mode.profile
    n_off = 6 * p.cp_len + 1
    tables = 4 * p.fft_size * 2 * (p.num_active_subs + p.num_data_subs + len(p.pilots)) + 4 * p.symbol_len
    out = b * (17 + max_syms * bits_per_symbol(mode) + 8 * p.num_active_subs)
    n_bytes = 4.0 * b * t + 8 * b + tables + out
    flops = (7.0 * b * t + 50.0 * b * (t // 16) + 4.0 * b * n_off * p.symbol_len
             + _fft_flops(mode, b * (1 + max_syms)))
    return n_bytes, flops


def work_chunks(mode, b: int, t: int, n_sym: int) -> tuple[float, float]:
    """(bytes, flops) of kernel B: frames and bits once; peak, scale, one FFT
    for the CE and one per symbol."""
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

    return (4.0 * b * t + b * n_sym * bits_per_symbol(mode), 2.0 * b * t + _fft_flops(mode, b * (1 + n_sym)))


def work_stream_demod(mode, b: int, n_sym: int) -> tuple[float, float]:
    """(bytes, flops) of the streaming demod: the region, channel and bits once;
    scale and one FFT per symbol."""
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

    p = mode.profile
    return (4.0 * b * n_sym * p.symbol_len + 8 * b * p.num_active_subs + b * n_sym * bits_per_symbol(mode),
            1.0 * b * n_sym * p.symbol_len + _fft_flops(mode, b * n_sym))


def turbo_windows(dev, rng):
    """BASELINE config 5's slot-0 input: 64 streams x 32 QPSK data frames
    (2048-byte chunks) synthesized on ``dev`` and cut into [64, 914,688]
    windows. Returns (mode, frames, windows, n_valid, min_pos, n_sym, cadence)."""
    import numpy as np
    import torch

    from audio_modem_tpu_torch import MODES, framing

    mode = MODES["QPSK"]
    p = mode.profile
    chunk = mode.chunk_size
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre_s, post_s = p.silence_pre_chunk(False), p.silence_post_chunk()
    cadence = framing.estimate_frame_samples(chunk + 11, mode) + pre_s + post_s
    w = -(-(K * cadence + 4 * p.symbol_len + p.fft_size + 2048) // 128) * 128
    payloads = [framing.build_data_chunk_payload(rng.bytes(chunk), s % K) for s in range(N_STREAMS * K)]
    u8 = torch.from_numpy(np.frombuffer(b"".join(payloads), np.uint8).reshape(N_STREAMS * K, -1).copy()).to(dev)
    frames = framing._synth_frames_core(u8, mode, n_sym, pre_s, post_s)
    windows = torch.nn.functional.pad(frames.reshape(N_STREAMS, K * cadence), (0, w - K * cadence)).contiguous()
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


def chunked_receive(label: str, data: bytes, mode_name: str, signal, dev, runs: int) -> tuple[int, str]:
    """``api.decode_chunked`` of ``signal`` on ``dev``, ``runs`` times, launch
    counts from zero each time: the file must come back complete and exact
    with ``stream_demod`` launched at least once per frame. Returns (launches
    of the last run, a report line)."""
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
    return counts["stream_demod"], line


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


def ring_rounds(dev, mode, frames, n_sym: int, cadence: int, block: int = 65536) -> tuple[int, str]:
    """Two rounds out of a DeviceRing. ``frames`` [n * K, cadence] are K data
    frames per stream; stream i is delayed by 16 * (i % 8) samples and sends
    its K frames twice. After a quiet lead-in that makes the ring's write
    position wrap, everything is written in blocks. Returns (decode_fused
    launches of the two rounds, a report line)."""
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
    c1 = launch_counts()["decode_fused"]
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
    c2 = launch_counts()["decode_fused"]
    starts2 = check("device ring round 2", packed2)
    if not np.array_equal(starts2, starts1):
        fail("device ring round 2: the repeated frames were found at other window positions than round 1's")
    wraps = (ring.total_written + ring.rel(g2)) % ring.capacity + w > ring.capacity
    if c1 < 1 or c2 != 0:
        fail(f"device ring: decode_fused launched {c1} times in round 1 and {c2} in round 2")
    t1 = time_ms(lambda: mr._batch_window_decode_multi_dev(ring, params1, mode, n_sym, k, cadence, w), reps=5, warm=1)
    t2 = time_ms(lambda: mr._batch_window_decode_pred_dev(ring, params2, mode, n_sym, k, cadence, w), reps=5, warm=1)
    t_gather = time_ms(lambda: mr._ring_gather(ring, range(n), params2[0].tolist(), w))
    blk = stream[:, :block].contiguous()
    t_write = time_ms(lambda: ring.write(blk))  # last: the writes move the ring on
    msps = k * cadence * n / 1e3
    return c1, (f"ring [{n}, {ring.capacity}] written in blocks of {block} ({length} samples a stream, write "
                f"position wrapped; round 2's windows {'cross' if wraps else 'do not cross'} the buffer's end); "
                f"round 1 (_batch_window_decode_multi_dev) equals _batch_window_decode_multi on the same windows, "
                f"round 2 (_batch_window_decode_pred_dev) predicted from round 1's last start + cadence; "
                f"{n} x {k} slots of each detected, CRC-valid, in sequence; decode_fused launches {c1} and {c2}; "
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
def path_inputs(store: dict, tag: str):
    """While the block runs, keep a copy of the first input of each shape
    that the batched path hands kernels A and B (``batch.decode_fused`` and
    ``batch.decode_chunks_fused``, looked up at call time) in ``store``,
    keyed by (kernel, tag, shape, symbols). The kernels run as they would;
    ``check_path_inputs`` holds them to their plain versions afterwards."""
    from audio_modem_tpu_torch.parallel import batch

    real_a, real_b = batch.decode_fused, batch.decode_chunks_fused

    def record_a(signals, n_valid, min_pos, mode, max_syms):
        key = ("decode_fused", tag, tuple(signals.shape), max_syms)
        if key not in store:
            store[key] = (signals.clone(), n_valid.clone(), min_pos.clone(), mode)
        return real_a(signals, n_valid, min_pos, mode, max_syms)

    def record_b(frames, mode, n_sym):
        key = ("decode_chunks_fused", tag, tuple(frames.shape), n_sym)
        if key not in store:
            store[key] = (frames.clone(), mode)
        return real_b(frames, mode, n_sym)

    batch.decode_fused, batch.decode_chunks_fused = record_a, record_b
    try:
        yield store
    finally:
        batch.decode_fused, batch.decode_chunks_fused = real_a, real_b


def check_path_inputs(label: str, store: dict) -> tuple[float, str]:
    """Kernels A and B against their plain versions on every input that
    ``path_inputs`` kept: A by ``compare_receive(by_frame=True)``, B by equal
    bits over the frame's symbols. Returns (largest fine or channel error, a report)."""
    import torch

    from audio_modem_tpu_torch.kernels import receive
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

    err, parts = 0.0, []
    for (name, tag, shape, n_sym), args in store.items():
        where = f"{list(shape)} {'max_syms' if name == 'decode_fused' else 'n_sym'} {n_sym} ({tag})"
        if name == "decode_fused":
            sig, n_valid, min_pos, mode = args
            out = receive.decode_fused(sig, n_valid, min_pos, mode, n_sym)
            ref = receive.decode_fused_reference(sig, n_valid, min_pos, mode, n_sym)
            e_fine, e_ch, flips, n_in, by_kind = compare_receive(
                f"{label}: kernel A at {where}", out, ref, n_valid, mode, by_frame=True)
            err = max(err, e_fine, e_ch)
            parts.append(f"A at {where}: {int(out['detected'].sum())} of {shape[0]} detected, every detected "
                         f"row parses as the plain version's, fine err {e_fine:.3e}, ch err {e_ch:.3e}, flipped "
                         f"bits {flips} of {n_in} ({by_kind})")
        else:
            frames, mode = args
            nb = n_sym * bits_per_symbol(mode)
            out = receive.decode_chunks_fused(frames, mode, n_sym)[:, :nb].to(torch.int32)
            ref = receive.decode_chunks_fused_reference(frames, mode, n_sym)[:, :nb].to(torch.int32)
            flips = int((out != ref).sum().item())
            if flips:
                fail(f"{label}: kernel B at {where} flips {flips} bits against its plain version")
            parts.append(f"B at {where}: flipped bits {flips} of {out.numel()}")
    return err, "; ".join(parts)


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
    timed beside the lockstep cut. Kernel A is held to its plain version on
    the first input of each shape that the two warm passes gave it. Returns
    (launches of the timed passes, kernel A's largest fine or channel error,
    a report line, depth 8's stage report, depth 8's and depth 0's walls)."""
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
        if depth:
            if counts["decode_fused"] < 1:
                fail(f"device ingest: decode_fused never launched: {counts}")
            pred = rep.get("pred_dispatch", {}).get("samples", 0)
            if pred < max(rep.get("multi_dispatch", {}).get("samples", 0), 1):
                fail(f"device ingest: predicted rounds carried {pred} samples, scanned rounds more: {rep}")
            if "pipe_fetch" not in rep:
                fail(f"device ingest: no speculative fetch at pipeline_depth 8: {rep}")
            rep8, counts8 = rep, counts
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
    if not {("decode_fused", "broadcast"), ("decode_fused", "staggered")} <= {k_[:2] for k_ in inputs}:
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
    return total, err, line, rep8, walls


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


def main() -> None:
    if not (ROOT / "audio_modem_tpu_torch" / "csrc").is_dir():
        fail(f"no audio_modem_tpu_torch/csrc beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    from audio_modem_tpu_torch import MODES, api, assert_full_fp32, decoder, framing
    from audio_modem_tpu_torch.kernels import _build, launch_counts, receive, reset_launch_counts
    from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
    from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
    from audio_modem_tpu_torch.parallel import batch, multi_receiver

    assert_full_fp32()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
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
    if min(counts["decode_fused"], counts["decode_chunks_fused"]) < 1:
        fail(f"a kernel of the turbo path never launched: {counts}")
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
    bound_a = bound_ms(*work_decode_fused(mode, N_STREAMS, windows.shape[1], n_sym))
    bound_b = bound_ms(*work_chunks(mode, N_STREAMS, aligned.shape[1], n_sym))
    print(f"phase 7 times {card}: turbo round {t_round:.3f} ms = {msps:.1f} Msamples/s; "
          f"kernel A {ms_a:.3f} ms (runs {ka1:.3f}, {ka2:.3f}) vs plain A {plain_ms_a:.3f} ms "
          f"(runs {pa1:.3f}, {pa2:.3f}), bound {bound_a[0]:.4f} ms ({bound_a[1]}), roofline share "
          f"{bound_a[0] / ms_a:.1%}; kernel B {ms_b:.3f} ms ({kb1:.3f}, {kb2:.3f}) vs plain B "
          f"{plain_ms_b:.3f} ms ({pb1:.3f}, {pb2:.3f}), bound {bound_b[0]:.4f} ms ({bound_b[1]}), "
          f"roofline share {bound_b[0] / ms_b:.1%}", flush=True)

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
    stream_launches = 0
    for label, sig, m, want in (("config 2", noisy2, mode2, data2), ("QPSK legacy", sig3, MODES["QPSK"], data3)):
        reset_launch_counts()
        res, info = api.decode(sig, m, device=dev)
        torch.cuda.synchronize()
        counts9 = launch_counts()
        if not (isinstance(res, framing.LegacyFrame) and res.crc_valid and res.data == want):
            fail(f"{label}: api.decode gave {getattr(res, 'error', type(res).__name__)}")
        if counts9["stream_demod"] < 1:
            fail(f"{label}: the decode never launched stream_demod: {counts9}")
        stream_launches += counts9["stream_demod"]
        print(f"phase 9 api.decode {label}: {sig.shape[0]} samples -> {len(res.data)} exact bytes, CRC valid, "
              f"preamble {info.preamble_idx}; launches {counts9}", flush=True)
    n2 = noisy2.shape[0]
    padded2 = decoder._padded(noisy2)
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
    bound_a1 = bound_ms(*work_decode_fused(mode2, 1, padded2.shape[0], ms2))
    bound_s = bound_ms(*work_stream_demod(mode2, 1, ms2))
    fr_n, m_n, ns_n = stream_frames["BPSK-NARROW"]
    run_cs = lambda: receive.decode_chunks_fused_stream(fr_n, m_n, ns_n)  # noqa: E731
    run_cb = lambda: receive.decode_chunks_fused(fr_n, m_n, ns_n)  # noqa: E731
    tb1, tcs1, tcs2, tb2 = time_ms(run_cb), time_ms(run_cs), time_ms(run_cs), time_ms(run_cb)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        api.decode(noisy2, mode2, device=dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 10 times {card}: stream_demod on config 2 ({ms2} symbols) {ms_s:.3f} ms ({ks1:.3f}, "
          f"{ks2:.3f}) vs plain {plain_ms_s:.3f} ms ({ps1:.3f}, {ps2:.3f}); B = 1 decode_long_fused "
          f"{statistics.median([tl1, tl2]):.3f} ms ({tl1:.3f}, {tl2:.3f}) vs kernel A "
          f"{ms_a1:.3f} ms ({ta1:.3f}, {ta2:.3f}), kernel A's bound {bound_a1[0]:.4f} ms ({bound_a1[1]}), "
          f"roofline share {bound_a1[0] / ms_a1:.1%}; stream_demod's bound {bound_s[0]:.4f} ms "
          f"({bound_s[1]}), roofline share {bound_s[0] / ms_s:.1%}; 64 narrowband frames "
          f"decode_chunks_fused_stream {statistics.median([tcs1, tcs2]):.3f} ms ({tcs1:.3f}, {tcs2:.3f}) vs "
          f"kernel B {statistics.median([tb1, tb2]):.3f} ms ({tb1:.3f}, {tb2:.3f}); api.decode of config 2 "
          f"wall {statistics.median(walls):.1f} ms (runs {', '.join(f'{w:.1f}' for w in walls)})", flush=True)

    # 11. digests of the kernels' bits
    digests = {name: hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]
               for name, bits in (("decode_fused", ka["bits"]), ("decode_chunks_fused", kb_bits),
                                  ("stream_demod", kl["bits"]))}
    print("phase 11 digests of the kernels' bits (phases 4, 5, 9): "
          + ", ".join(f"{k} {v}" for k, v in digests.items()), flush=True)

    # 12. chunked receive, BASELINE config 3 at full width
    data12 = np.random.default_rng(SEED + 12).bytes(1 << 20)
    frames12 = chunked_frames(data12, "QPSK", "config3.bin", dev)
    chunked_launches, line = chunked_receive("chunked QPSK", data12, "QPSK", np.concatenate(frames12), dev, runs=2)
    stream_launches += chunked_launches
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
    bound_f = bound_ms(*work_stream_demod(m12, 1, nb12))
    print(f"phase 12 stream_demod on one chunk frame ({nb12} symbols, B = 1) {card}: {ms_f:.4f} ms ({kf1:.4f}, "
          f"{kf2:.4f}) vs plain {statistics.median([pf1, pf2]):.4f} ms ({pf1:.4f}, {pf2:.4f}), bound "
          f"{bound_f[0]:.6f} ms ({bound_f[1]}); {chunked_launches} launches x (time - bound) = "
          f"{chunked_launches * (ms_f - bound_f[0]):.1f} ms of the transfer", flush=True)

    # 13. the same at a second symbol length, behind noise
    data13 = np.random.default_rng(SEED + 13).bytes(8 << 10)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    gap = (torch.randn(20000, generator=gen, device=dev) * 1e-3).cpu().numpy()
    sig13 = np.concatenate([gap] + chunked_frames(data13, "BPSK-NARROW", "narrow.bin", dev))
    narrow_launches, line = chunked_receive("chunked BPSK-NARROW", data13, "BPSK-NARROW", sig13, dev, runs=1)
    stream_launches += narrow_launches
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
    launches18, err18, line, _, _ = batch_receive_device(dev)
    print(f"phase 18 BatchReceiver device ingest {card}: {line}", flush=True)

    batch_launches = launches17 + launches18
    source = "audio_modem_tpu_torch/csrc/receive.cu"
    print(json.dumps({"kernels": [
        {"name": "decode_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:375",
         "launches": counts["decode_fused"] + ring_launches + batch_launches["decode_fused"],
         "max_abs_err": max(err_fine, err_ch, err_fine_1, err_ch_1, err17, err18), "ms": ms_a,
         "plain_ms": plain_ms_a,
         "bound_ms": bound_a[0], "bound_by": bound_a[1], "library_ms": None},
        {"name": "decode_chunks_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:604",
         "launches": counts["decode_chunks_fused"] + batch_launches["decode_chunks_fused"],
         "max_abs_err": float(err_b), "ms": ms_b, "plain_ms": plain_ms_b,
         "bound_ms": bound_b[0], "bound_by": bound_b[1], "library_ms": None},
        {"name": "stream_demod", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:666, :728",
         "launches": stream_launches + batch_launches["stream_demod"],
         "max_abs_err": float(err_s), "ms": ms_s, "plain_ms": plain_ms_s,
         "bound_ms": bound_s[0], "bound_by": bound_s[1], "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
