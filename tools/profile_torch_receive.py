#!/usr/bin/env python3
"""Device-side profile of the port's receive on one NVIDIA GPU, from
torch.profiler: the time per launch of kernel A (audio_modem_tpu_torch/
csrc/receive.cu, ``amtpu_decode_fused``, six launches), kernel C
(``amtpu_decode_predicted``, five launches, on the turbo round's windows
with all 32 slots predicted), kernel B
(``amtpu_decode_chunks_fused``: peak, then CE and demod in one launch) and the streaming demod
(``amtpu_stream_demod``), and the turbo round's device busy share.

    python3 tools/profile_torch_receive.py [--reps 20]

Inputs as chip_smoke.py builds them: the turbo round's slot 0 (64 QPSK
windows of 914,688 samples, max_syms 41) and its 64 frame-aligned frames,
BASELINE config 2 at B = 1 (7,913,472 samples, 12,361 symbols; kernel A
and its plain version) and its data region, and 64 BPSK-NARROW 512-byte chunk frames (598 symbols). For each,
the whole call from CUDA events (median of ``--reps``), then every kernel's
mean device time per call, and for the two stages of kernel A that stream
the window (pre_stats, scan) the rate at which they read it. Beside each
demod, as a yardstick for its DFT stage alone (neither computes the
kernel's function, and the port calls neither): ``torch.fft.rfft`` of the
same symbol bodies, and ``torch.matmul`` of them with ``Tables.rx_demod``.
Then the turbo round
(``_batch_window_decode_multi``, 64 streams x 32 frames): its time from
CUDA events without the profiler (median of ``--reps``), and the device
time of its kernels and copies per round under the profiler; their ratio
is the share of the round in which the card is busy. Then the device ring
(``profile_ring``): a block write and the cut of the round's windows at
[64, 2 x 914,688], for ``DeviceRing`` (a true ring) and for the alternative
it was chosen over, a ping-pong shift buffer kept in this file only to be
measured. Last the chunked receive (``profile_chunked``): a 1 MiB QPSK file
through ``api.decode_chunked`` as chip_smoke.py sends it: the wall split
into scan / refine / frame decode / assembler / ingest on the host's clock,
then under the profiler the device time, its share of the wall (the card's
busy share), device events per 4096-sample block and the largest device
items. Last the multi-stream runtime (``profile_batch_receiver``): chip_smoke
phase 18's transfer (64 streams x 128 chunks through
``BatchReceiver(device_ingest=True)``, K = 8, pipeline_depth 8): its wall
and stage split on the host's clock, then under the profiler the device
time, the card's busy share, device events per round and the largest device
items; before the profiler, the same transfer at pipeline_depth 8, 1 and 0
in turns (six walls each). ``--only batch_receiver`` runs that part alone.
``--only soak [--soak-mb 7.819264]`` runs the config-5 soak alone
(``profile_soak``: the 500 MB transfer at 7.819264): wall, stage split and
seconds a call without the profiler, then device time and busy share under
it. ``--only round`` runs kernel C's launches (both branches) and the turbo
round alone. Prints the card's name and power limit first. Needs a CUDA
device.

    python3 tools/profile_torch_receive.py --only soak --soak-mb 7.819264
    python3 tools/profile_torch_receive.py --only round
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from audio_modem_tpu_torch import MODES, api, decoder, framing  # noqa: E402
from audio_modem_tpu_torch.kernels import receive  # noqa: E402
from audio_modem_tpu_torch.parallel import multi_receiver  # noqa: E402
from audio_modem_tpu_torch.tables import profile_tables  # noqa: E402

STREAMING_STAGES = ("pre_stats_kernel", "scan_kernel")


def device_events(call, reps: int) -> list[tuple[str, float, int]]:
    """(name, device us in all, count) of every device-side event of ``reps`` calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return [(ev.key, ev.self_device_time_total, ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]


def profile_call(label: str, call, reps: int, n_bytes_window: int = 0) -> None:
    """One wrapper call: its time from CUDA events, then its kernels by name."""
    ms = chip_smoke.time_ms(call, reps=reps)
    rows = [(name, us / reps, n / reps) for name, us, n in device_events(call, reps)]
    total = sum(r[1] for r in rows)
    print(f"{label}: call {ms:.4f} ms (CUDA events, median of {reps}); kernels {total / 1e3:.4f} ms per call "
          f"(torch.profiler)")
    for name, us, per_call in sorted(rows, key=lambda r: -r[1]):
        kernel = re.search(r"\w+_kernel", name)
        tile = re.search(r"Tile<[^>]*>", name)
        short = (kernel.group(0) if kernel else name[:100]) + (f" [{tile.group(0)}]" if tile else "")
        rate = ""
        if n_bytes_window and any(s in short for s in STREAMING_STAGES):
            rate = f", window read at {n_bytes_window / (us * 1e-6) / 1e12:.2f} TB/s"
        print(f"  {short}: {us / 1e3:.4f} ms per call ({per_call:g} launches){rate}")


def dft_yardsticks(label: str, region: torch.Tensor, mode, n_sym: int, reps: int) -> None:
    """The DFT stage alone on the symbols of ``region`` [B, >= n_sym * sym]:
    rfft of the [B * n_sym, fft] bodies, and their product with rx_demod."""
    p = mode.profile
    bodies = region[:, : n_sym * p.symbol_len].reshape(-1, p.symbol_len)[:, p.cp_len :].contiguous()
    tab = profile_tables(mode, region.device).rx_demod
    t_fft = chip_smoke.time_ms(lambda: torch.fft.rfft(bodies), reps=reps)
    t_mm = chip_smoke.time_ms(lambda: torch.matmul(bodies, tab), reps=reps)
    print(f"  yardstick for the DFT stage of {label} ({bodies.shape[0]} bodies of {bodies.shape[1]}): "
          f"torch.fft.rfft {t_fft:.4f} ms, torch.matmul with rx_demod {tuple(tab.shape)} {t_mm:.4f} ms")


def chunk_frames(name: str, size: int, dev, rng):
    """64 frame-aligned chunk frames of ``size`` payload bytes: (frames, mode, n_sym)."""
    mode = MODES[name]
    p = mode.profile
    n_sym = framing.num_symbols_for_payload(size + 11, mode)
    fr = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(chip_smoke.N_STREAMS)], 0, mode, device=dev)
    pre = p.silence_pre_chunk(False)
    return fr[:, pre : pre + (3 + n_sym) * p.symbol_len].contiguous(), mode, n_sym


def profile_kernel_c(windows, n_valid, min_pos, mode, n_sym: int, cadence: int, reps: int) -> None:
    """Kernel C's launches (pre_stats, combine, chain, demod, pack) apart, on
    the turbo round's windows in both branches: all 32 slots predicted, and
    31 after kernel A's slot 0."""
    k = chip_smoke.K
    ka = receive.decode_fused(windows, n_valid, min_pos, mode, n_sym)
    ok0 = torch.ones_like(ka["detected"])
    start0 = (ka["start"] - cadence).to(torch.int32)
    profile_call(f"kernel C, the turbo round's {k} slots all predicted [64, {windows.shape[1]}]",
                 lambda: receive.decode_predicted(windows, n_valid, start0, ok0, mode, n_sym, k, cadence),
                 reps, windows.numel() * 4)
    profile_call(f"kernel C, the turbo round's {k - 1} slots after kernel A [64, {windows.shape[1]}]",
                 lambda: receive.decode_predicted(windows, n_valid, ka["start"], ka["detected"], mode, n_sym, k,
                                                  cadence, ka["bits"]),
                 reps, windows.numel() * 4)


def profile_round(windows, n_valid, min_pos, mode, n_sym: int, cadence: int, reps: int) -> None:
    run = lambda: multi_receiver._batch_window_decode_multi(  # noqa: E731
        windows, min_pos, n_valid, mode, n_sym, chip_smoke.K, cadence)
    ms = chip_smoke.time_ms(run, reps=reps, warm=3)
    events = device_events(run, reps)
    dev_ms = sum(us for _, us, _ in events) / reps / 1e3
    n_ev = sum(n for _, _, n in events) / reps
    busy = f"{dev_ms / ms:.1%}" if dev_ms > 0 else "not measured (the profiler saw no device time)"
    print(f"turbo round [64 x 32 frames]: {ms:.3f} ms (CUDA events, median of {reps}, no profiler); "
          f"device time {dev_ms:.3f} ms per round in {n_ev:.0f} device events (torch.profiler); device busy {busy}")
    for name, us, n in sorted(events, key=lambda r: -r[1])[:5]:
        print(f"  {name[:100]}: {us / reps / 1e3:.4f} ms per round ({n / reps:g} events)")


class ShiftRing:
    """The device ring as a ping-pong shift buffer: ``buf[:, 0]`` is always
    the oldest sample, so a window is one contiguous slice per row, and
    every write copies the kept samples into the second buffer (an
    overlapping copy within one buffer is undefined in PyTorch). Not part
    of the port: ``DeviceRing`` is measured against it."""

    def __init__(self, n: int, capacity: int, device):
        self.buf = torch.zeros((n, capacity), dtype=torch.float32, device=device)
        self.other = torch.empty_like(self.buf)

    def write(self, blocks: torch.Tensor) -> None:
        l = blocks.shape[1]
        keep = self.buf.shape[1] - l
        self.other[:, :keep].copy_(self.buf[:, l:])
        self.other[:, keep:].copy_(blocks)
        self.buf, self.other = self.other, self.buf

    def windows(self, rel_starts: list, w: int) -> torch.Tensor:
        if len(set(rel_starts)) == 1:  # lockstep: one strided copy, as _ring_gather makes
            return self.buf[:, rel_starts[0] : rel_starts[0] + w].contiguous()
        out = torch.empty((self.buf.shape[0], w), dtype=torch.float32, device=self.buf.device)
        for i, r in enumerate(rel_starts):
            out[i].copy_(self.buf[i, r : r + w])
        return out


def profile_ring(dev, w: int, reps: int) -> None:
    """Block writes and the window cut at [64, 2 * w], both ring designs in
    turns (CUDA events, median of ``reps``)."""
    n = chip_smoke.N_STREAMS
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    ring = multi_receiver.DeviceRing(n, 2 * w, device=dev)
    shift = ShiftRing(n, ring.capacity, dev)
    fill = torch.randn((n, w), generator=gen, device=dev)
    for r in (ring, shift):
        r.write(fill)
        r.write(fill)
        r.write(fill[:, : w // 2 + 4096])  # the true ring's write position now sits mid-buffer
    early = [16 * (i % 8) for i in range(n)]  # windows from the oldest samples: contiguous in the true ring
    late = [w - 4096 + s for s in early]  # windows up to the newest samples: they cross its buffer's end
    cases = (("staggered starts, contiguous", early, False), ("staggered starts, wrapping", late, True),
             ("one start (lockstep), contiguous", [0] * n, False), ("one start (lockstep), wrapping", [w] * n, True))
    for label, rel, wraps in cases:
        pos = (ring.total_written + rel[0]) % ring.capacity
        if (pos + w > ring.capacity) != wraps:
            raise SystemExit("profile_torch_receive: FAILED: the ring's write position is not where this expects")
        cut_true = lambda: multi_receiver._ring_gather(ring, range(n), rel, w)  # noqa: E731
        cut_shift = lambda: shift.windows(rel, w)  # noqa: E731
        if not torch.equal(cut_true(), cut_shift()):
            raise SystemExit("profile_torch_receive: FAILED: the two rings disagree on their windows")
        a1, b1, b2, a2 = (chip_smoke.time_ms(f, reps=reps) for f in (cut_true, cut_shift, cut_shift, cut_true))
        print(f"device ring [{n}, {ring.capacity}], cut of [{n}, {w}] windows, {label}: true ring {a1:.4f}, {a2:.4f} ms; "
              f"shift ring {b1:.4f}, {b2:.4f} ms")
    for block in (4096, 65536):
        blk = fill[:, :block].contiguous()
        a1, b1, b2, a2 = (chip_smoke.time_ms(f, reps=reps) for f in (
            lambda: ring.write(blk), lambda: shift.write(blk), lambda: shift.write(blk), lambda: ring.write(blk)))
        print(f"device ring [{n}, {ring.capacity}], write of a [{n}, {block}] block: true ring {a1:.4f}, {a2:.4f} ms; "
              f"shift ring {b1:.4f}, {b2:.4f} ms")


def profile_chunked(dev) -> None:
    """The 1 MiB QPSK chunked receive: host-clock split, then device time
    and events under the profiler."""
    import time

    data = np.random.default_rng(chip_smoke.SEED + 12).bytes(1 << 20)
    signal = np.concatenate(chip_smoke.chunked_frames(data, "QPSK", "config3.bin", dev))
    n_blocks = -(-len(signal) // 4096)

    def run() -> float:
        t0 = time.perf_counter()
        res = api.decode_chunked(signal, "QPSK", device=dev)
        wall = time.perf_counter() - t0
        if not (isinstance(res, api.ChunkedDecodeResult) and res.complete and res.data == data):
            raise SystemExit("profile_torch_receive: FAILED: the chunked receive did not return the file")
        return wall

    run()  # warm-up
    with chip_smoke.receiver_stages() as timer:
        wall = run()
    split = chip_smoke.stage_split(timer, wall)
    print(f"chunked receive, 1 MiB QPSK ({len(signal)} samples, {n_blocks} blocks of 4096): wall {wall:.3f} s "
          f"(host clock, stage timer on, no profiler)")
    for stage in ("scan", "refine", "frame"):
        print(f"  {stage}: {split[stage + '_s']:.3f} s = {split[stage + '_s'] / wall:.1%} of the wall, "
              f"{split[stage + '_calls']} calls, {split[stage + '_ms']:.3f} ms each")
    print(f"  assembler: {split['assembler_s']:.3f} s = {split['assembler_s'] / wall:.1%}; ingest (DC removal, ring "
          f"write, FSM): {split['ingest_s']:.3f} s = {split['ingest_s'] / wall:.1%}")
    plain_wall = run()
    events = device_events(run, 1)
    dev_ms = sum(us for _, us, _ in events) / 1e3
    n_ev = sum(n for _, _, n in events)
    busy = f"{dev_ms / 1e3 / plain_wall:.1%}" if dev_ms > 0 else "not measured (the profiler saw no device time)"
    print(f"  wall without timer or profiler {plain_wall:.3f} s; device time {dev_ms:.1f} ms in {n_ev} device events "
          f"= {n_ev / n_blocks:.1f} per block (torch.profiler); device busy {busy}")
    for name, us, n in sorted(events, key=lambda r: -r[1])[:8]:
        print(f"  {name[:100]}: {us / 1e3:.2f} ms in {n} events")
    for name, us, n in events:
        if "stream_demod_kernel" in name:
            print(f"  stream_demod_kernel alone: {us / n / 1e3:.4f} ms of device time per launch ({n} launches seen)")


def profile_batch_receiver(dev) -> None:
    """Phase 18's device-ingest transfer: host-clock wall and stage split,
    then device time, busy share and events per round under the profiler."""
    from audio_modem_tpu_torch.parallel.multi_receiver import BatchReceiver

    n, block = chip_smoke.N_STREAMS, chip_smoke.STREAM_BLOCK
    data, t, blocks = chip_smoke.config5_device_blocks(dev, n, 128, block)

    def receiver(depth: int = 8):
        return BatchReceiver(MODES["QPSK"], n, scan_bucket=block, device_ingest=True, pipeline_depth=depth,
                             device=dev)

    def run(rx) -> float:
        wall = chip_smoke.feed_batch(rx, blocks)
        chip_smoke.check_batch("profile_batch_receiver", rx, [data] * n)
        return wall

    run(receiver())  # warm-up
    rx = receiver()
    wall = run(rx)
    rep = rx.timer.report()
    kinds = [f"{k} {rep[k]['calls']}" for k in ("pred_dispatch", "multi_dispatch", "single_dispatch") if k in rep]
    rounds = sum(rep.get(f"{k}_dispatch", {}).get("calls", 0) for k in ("pred", "multi", "single"))
    print(f"BatchReceiver device ingest [{n} streams x {t} samples, {len(blocks)} blocks of {block}]: wall "
          f"{wall:.3f} s = {n * t / wall / 1e6:.2f} Msamples/s (host clock, no profiler); {rounds} rounds "
          f"({', '.join(kinds)})")
    print(f"  stages: {chip_smoke.stage_report(rep)}")
    # before the profiler: launches may stay slower once it has run
    walls = {depth: [] for depth in (8, 1, 0)}
    for order in ((8, 1, 0), (0, 1, 8)) * 3:
        for depth in order:
            walls[depth].append(run(receiver(depth)))
    print("  pipeline_depth in turns, wall s: " + "; ".join(
        f"{depth}: median {statistics.median(w):.3f} ({', '.join(f'{x:.3f}' for x in w)})"
        for depth, w in walls.items()))
    rx = receiver()
    events = device_events(lambda: run(rx), 1)
    dev_ms = sum(us for _, us, _ in events) / 1e3
    n_ev = sum(cnt for _, _, cnt in events)
    busy = f"{dev_ms / 1e3 / wall:.1%}" if dev_ms > 0 else "not measured (the profiler saw no device time)"
    print(f"  device time {dev_ms:.1f} ms in {n_ev} device events = {n_ev / max(rounds, 1):.0f} per round "
          f"(torch.profiler); device busy {busy} of the wall without the profiler")
    for name, us, cnt in sorted(events, key=lambda r: -r[1])[:8]:
        print(f"  {name[:100]}: {us / 1e3:.2f} ms in {cnt} events")


def profile_soak(dev, per_mb: float) -> None:
    """The config-5 soak (``tools/soak.py``, 64 streams x ``per_mb`` MB,
    sqlite): its record's wall and stage split without the profiler, each
    round kind's seconds a call; then the same soak under the profiler:
    device time, device events a round and the card's busy share of the
    un-profiled wall."""
    from audio_modem_tpu_torch.tools import soak

    rec = soak.run_soak(per_mb, chip_smoke.N_STREAMS, device=dev)
    if not soak.passed(rec):
        raise SystemExit(f"profile_torch_receive: FAILED: the soak lost data: {rec['chunks_received']} of "
                         f"{rec['chunks_expected']} chunks")
    rep = rec["stage_breakdown"]
    rounds = sum(rep.get(f"{k}_dispatch", {}).get("calls", 0) for k in ("pred", "multi", "single"))
    print(f"soak {rec['config']['streams']} x {rec['config']['per_stream_bytes']} B ({rec['chunks_expected']} "
          f"chunks, sqlite): wall {rec['wall_s']:.3f} s = {rec['sustained_msps']:.2f} Msamples/s (host clock, no "
          f"profiler); {rounds} rounds; launches {rec['launches']}")
    print(f"  stages: {chip_smoke.stage_report(rep)}")
    print("  seconds a call: " + "; ".join(f"{k} {v['seconds'] / v['calls'] * 1e3:.3f} ms ({v['calls']} calls)"
                                            for k, v in rep.items() if v.get("calls")))
    events = device_events(lambda: soak.run_soak(per_mb, chip_smoke.N_STREAMS, device=dev), 1)
    dev_ms = sum(us for _, us, _ in events) / 1e3
    n_ev = sum(cnt for _, _, cnt in events)
    busy = f"{dev_ms / 1e3 / rec['wall_s']:.1%}" if dev_ms > 0 else "not measured (the profiler saw no device time)"
    print(f"  under the profiler (TX, warm-up and transfer): device time {dev_ms:.1f} ms in {n_ev} device events; "
          f"device busy {busy} of the un-profiled transfer's wall (an upper bound: the profiled run also holds "
          f"the TX and the warm-up)")
    for name, us, cnt in sorted(events, key=lambda r: -r[1])[:8]:
        print(f"  {name[:100]}: {us / 1e3:.2f} ms in {cnt} events")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=["all", "round", "batch_receiver", "soak"], default="all")
    ap.add_argument("--soak-mb", type=float, default=0.82, help="MB a stream of the soak (7.819264: 500 MB)")
    args = ap.parse_args()
    reps = args.reps
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_receive: FAILED: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    if args.only == "batch_receiver":
        profile_batch_receiver(dev)
        return
    if args.only == "soak":
        profile_soak(dev, args.soak_mb)
        return
    rng = np.random.default_rng(chip_smoke.SEED)
    mode, frames, windows, n_valid, min_pos, n_sym, cadence = chip_smoke.turbo_windows(dev, rng)
    if args.only == "round":
        profile_kernel_c(windows, n_valid, min_pos, mode, n_sym, cadence, reps)
        profile_round(windows, n_valid, min_pos, mode, n_sym, cadence, reps)
        return
    profile_call("kernel A, turbo slot 0 [64, 914688]",
                 lambda: receive.decode_fused(windows, n_valid, min_pos, mode, n_sym), reps, windows.numel() * 4)
    sym = mode.profile.symbol_len
    pre_s = mode.profile.silence_pre_chunk(False)
    aligned = frames.reshape(chip_smoke.N_STREAMS, chip_smoke.K, cadence)[
        :, 0, pre_s : pre_s + (3 + n_sym) * sym].contiguous()
    profile_call(f"kernel B, 64 QPSK frames x {n_sym} symbols",
                 lambda: receive.decode_chunks_fused(aligned, mode, n_sym), reps)
    dft_yardsticks("the 64 QPSK frames", aligned[:, 3 * sym :], mode, n_sym, reps)

    mode2, _, noisy2 = chip_smoke.config2_signal(dev)
    padded2 = decoder.pad_to_bucket(noisy2)
    ms2 = decoder._max_symbols(padded2.shape[0], mode2)
    args2 = (padded2[None], torch.tensor([noisy2.shape[0]], dtype=torch.int32, device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev), mode2, ms2)
    profile_call(f"kernel A, config 2 at B = 1 [1, {padded2.shape[0]}]",
                 lambda: receive.decode_fused(*args2), reps, padded2.numel() * 4)
    profile_call(f"kernel A's plain version, config 2 at B = 1 [1, {padded2.shape[0]}]",
                 lambda: receive.decode_fused_reference(*args2), reps)
    head, region = receive._front_end(*args2)
    ones = torch.ones(1, dtype=torch.float32, device=dev)
    profile_call(f"streaming demod, config 2 ({ms2} symbols)",
                 lambda: receive.stream_demod(region, head["ch_re"], head["ch_im"], ones, mode2, ms2), reps)
    dft_yardsticks("config 2", region, mode2, ms2, reps)

    fr_n, mode_n, ns_n = chunk_frames("BPSK-NARROW", 512, dev, rng)
    profile_call(f"kernel B, 64 BPSK-NARROW frames x {ns_n} symbols",
                 lambda: receive.decode_chunks_fused(fr_n, mode_n, ns_n), reps)
    profile_call(f"decode_chunks_fused_stream (plain prologue + streaming demod), the same {ns_n}-symbol frames",
                 lambda: receive.decode_chunks_fused_stream(fr_n, mode_n, ns_n), reps)
    dft_yardsticks("the 64 narrowband frames", fr_n[:, 3 * mode_n.profile.symbol_len :], mode_n, ns_n, reps)
    profile_kernel_c(windows, n_valid, min_pos, mode, n_sym, cadence, reps)
    profile_round(windows, n_valid, min_pos, mode, n_sym, cadence, reps)
    profile_ring(dev, windows.shape[1], reps)
    del windows, frames
    profile_chunked(dev)
    profile_batch_receiver(dev)


if __name__ == "__main__":
    main()
