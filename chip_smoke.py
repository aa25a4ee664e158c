#!/usr/bin/env python3
"""Smoke run of the PyTorch port (audio_modem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at full size: 64 QPSK streams, 2048-byte
chunks, 32 frames per turbo round (BASELINE config 5). Phases, one line each:

  1. card (nvidia-smi name and power limit), torch and CUDA versions
  2. build the CUDA kernels from audio_modem_tpu_torch/csrc
  3. TX: 64 x 32 data frames synthesized on the card, cut into the
     [64, 914,688] turbo windows
  4. kernel A (decode_fused) against its plain version on those windows
  5. kernel B (decode_chunks_fused) against its plain version on 64
     frame-aligned frames
  6. the main path with launch counts from zero: one turbo round
     (_batch_window_decode_multi) and the frame-aligned packed demod of its
     frames; every slot must be detected, CRC-valid and in sequence
  7. times from CUDA events (median of 10 after warm-up)

then the kernels as one JSON line, and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero. There is no
CPU fallback: without a CUDA device the script stops before any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_STREAMS = 64
K = 32
SEED = 0


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


def main() -> None:
    if not (ROOT / "audio_modem_tpu_torch" / "csrc").is_dir():
        fail(f"no audio_modem_tpu_torch/csrc beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    from audio_modem_tpu_torch import MODES, assert_full_fp32, framing
    from audio_modem_tpu_torch.kernels import _build, launch_counts, receive, reset_launch_counts
    from audio_modem_tpu_torch.ops.bits import bits_to_bytes
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
    mode = MODES["QPSK"]
    p = mode.profile
    sym = p.symbol_len
    chunk = mode.chunk_size
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre_s, post_s = p.silence_pre_chunk(False), p.silence_post_chunk()
    cadence = framing.estimate_frame_samples(chunk + 11, mode) + pre_s + post_s
    w = -(-(K * cadence + 4 * sym + p.fft_size + 2048) // 128) * 128
    rng = np.random.default_rng(SEED)
    payloads = [framing.build_data_chunk_payload(rng.bytes(chunk), s % K) for s in range(N_STREAMS * K)]
    u8 = torch.from_numpy(np.frombuffer(b"".join(payloads), np.uint8).reshape(N_STREAMS * K, -1).copy()).to(dev)
    frames = framing._synth_frames_core(u8, mode, n_sym, pre_s, post_s)
    windows = torch.nn.functional.pad(frames.reshape(N_STREAMS, K * cadence), (0, w - K * cadence)).contiguous()
    n_valid = torch.full((N_STREAMS,), K * cadence, dtype=torch.int32, device=dev)
    min_pos = torch.zeros(N_STREAMS, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(windows).all()):
        fail("TX produced non-finite samples")
    print(f"phase 3 tx: windows {tuple(windows.shape)} cadence {cadence} n_sym {n_sym}", flush=True)

    # 4. kernel A against plain A
    ka = receive.decode_fused(windows, n_valid, min_pos, mode, n_sym)
    pa = receive.decode_fused_reference(windows, n_valid, min_pos, mode, n_sym)
    torch.cuda.synchronize()
    for key in ("start", "coarse", "detected"):
        if not torch.equal(ka[key], pa[key]):
            fail(f"kernel A {key} differs from plain: {ka[key][:8].tolist()} vs {pa[key][:8].tolist()}")
    if not bool(ka["detected"].all()):
        fail("kernel A: not every stream detected")
    err_fine = (ka["fine_metric"] - pa["fine_metric"]).abs().max().item()
    err_cm = (ka["coarse_metric"] - pa["coarse_metric"]).abs().max().item()
    err_ch = max((ka[k] - pa[k]).abs().max().item() for k in ("ch_re", "ch_im"))
    flips = int((ka["bits"] != pa["bits"]).sum().item())
    print(f"phase 4 kernel A vs plain: start/coarse/detected equal, fine err {err_fine:.3e} "
          f"(tol 1e-5), coarse metric err {err_cm:.3e}, ch err {err_ch:.3e} (tol 1e-4), "
          f"flipped in-frame bits {flips} of {ka['bits'].numel()}", flush=True)
    if err_fine > 1e-5 or err_ch > 1e-4 or flips:
        fail("kernel A outside tolerance")

    # 5. kernel B against plain B on frame-aligned frames (first frame of each stream)
    aligned = frames.reshape(N_STREAMS, K, cadence)[:, 0, pre_s : pre_s + (3 + n_sym) * sym].contiguous()
    n_bits = n_sym * bits_per_symbol(mode)
    kb = bits_to_bytes(receive.decode_chunks_fused(aligned, mode, n_sym)[:, :n_bits])
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
    if min(counts.values()) < 1:
        fail(f"a kernel of the main path never launched: {counts}")
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
    print(f"phase 7 times {card}: turbo round {t_round:.3f} ms = {msps:.1f} Msamples/s; "
          f"kernel A {ms_a:.3f} ms (runs {ka1:.3f}, {ka2:.3f}) vs plain A {plain_ms_a:.3f} ms "
          f"(runs {pa1:.3f}, {pa2:.3f}); kernel B {ms_b:.3f} ms ({kb1:.3f}, {kb2:.3f}) vs plain B "
          f"{plain_ms_b:.3f} ms ({pb1:.3f}, {pb2:.3f})", flush=True)

    source = "audio_modem_tpu_torch/csrc/receive.cu"
    print(json.dumps({"kernels": [
        {"name": "decode_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:375", "launches": counts["decode_fused"],
         "max_abs_err": max(err_fine, err_ch), "ms": ms_a, "plain_ms": plain_ms_a},
        {"name": "decode_chunks_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:604", "launches": counts["decode_chunks_fused"],
         "max_abs_err": float(err_b), "ms": ms_b, "plain_ms": plain_ms_b},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
