#!/usr/bin/env python3
"""Smoke run of the PyTorch port (audio_modem_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at full size: the turbo receive round (64 QPSK
streams, 2048-byte chunks, 32 frames per round; BASELINE config 5) and the
single-signal decode (api.encode -> api.decode of a 32,736-byte file as one
BPSK-REPEAT legacy frame of 7,906,500 samples under 12 dB AWGN; BASELINE
config 2). Phases, one line each:

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

then the kernels as one JSON line (time, plain time, launches on the main
path, the bound: bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
whichever is larger, from this run's shapes, each DFT counted at the cost
of a real-input FFT), and as the last line
{"ok": true, "device": {...}}. Any failed phase exits non-zero. There is no
CPU fallback: without a CUDA device the script stops before any result.
"""

from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
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

    from audio_modem_tpu_torch import MODES, api

    mode = MODES["BPSK-REPEAT"]
    data = np.random.default_rng(SEED + 2).bytes(32 * 1024 - 32)
    sigs = api.encode(data, mode, "big.bin", device=dev)
    if len(sigs) != 1 or sigs[0].shape[0] != 7_906_500:
        fail(f"config 2 TX: {len(sigs)} frames of {[int(x.shape[0]) for x in sigs]} samples")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    noise_power = (sigs[0] * sigs[0]).mean() / (10.0 ** (12.0 / 10.0))
    return mode, data, sigs[0] + torch.randn(sigs[0].shape, generator=gen, device=dev) * torch.sqrt(noise_power)


def compare_receive(label: str, out: dict, ref: dict, n_valid, mode) -> tuple[float, float, int, int]:
    """Kernel A's output dict against its plain version: start, coarse,
    coarse metric and detected equal, fine metric within 1e-5, channel within
    1e-4, no flipped bit in the symbols inside n_valid. Returns (fine err,
    channel err, flipped bits, in-frame bits)."""
    import torch

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
    flips = n_in = 0
    for i, (s, nv) in enumerate(zip(out["start"].tolist(), n_valid.tolist())):
        nb = min(max((nv - (s + 3 * sym)) // sym, 0), n_sym_max) * bps_sym
        flips += int((out["bits"][i, :nb] != ref["bits"][i, :nb]).sum().item())
        n_in += nb
    if err_fine > 1e-5 or err_ch > 1e-4 or flips:
        fail(f"{label} outside tolerance: fine err {err_fine:.3e}, ch err {err_ch:.3e}, flipped bits {flips}")
    return err_fine, err_ch, flips, n_in


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
    err_fine, err_ch, flips, n_in = compare_receive("kernel A", ka, pa, n_valid, mode)
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
    err_fine_1, err_ch_1, flips_1, n_in_1 = compare_receive("kernel A at B = 1", ka_1, pl, nv2, mode2)
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

    source = "audio_modem_tpu_torch/csrc/receive.cu"
    print(json.dumps({"kernels": [
        {"name": "decode_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:375", "launches": counts["decode_fused"],
         "max_abs_err": max(err_fine, err_ch, err_fine_1, err_ch_1), "ms": ms_a, "plain_ms": plain_ms_a,
         "bound_ms": bound_a[0], "bound_by": bound_a[1], "library_ms": None},
        {"name": "decode_chunks_fused", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:604", "launches": counts["decode_chunks_fused"],
         "max_abs_err": float(err_b), "ms": ms_b, "plain_ms": plain_ms_b,
         "bound_ms": bound_b[0], "bound_by": bound_b[1], "library_ms": None},
        {"name": "stream_demod", "route": "cuda", "source": source,
         "replaces": "audio_modem_tpu/kernels/receive.py:666, :728", "launches": stream_launches,
         "max_abs_err": float(err_s), "ms": ms_s, "plain_ms": plain_ms_s,
         "bound_ms": bound_s[0], "bound_by": bound_s[1], "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
