#!/usr/bin/env python3
"""Device-side profile of the port's receive on one NVIDIA GPU, from
torch.profiler: kernel A's time per stage (audio_modem_tpu_torch/csrc/
receive.cu, ``amtpu_decode_fused``, six launches) and the turbo round's
device busy share.

    python3 tools/profile_torch_receive.py [--reps 20]

Inputs as chip_smoke.py builds them: the turbo round's slot 0 (64 QPSK
windows of 914,688 samples, max_syms 41) and BASELINE config 2 at B = 1
(7,913,472 samples, 12,361 symbols). For each, kernel A's whole call from
CUDA events (median of ``--reps``), then every kernel's mean device time
per call, and for the two stages that stream the window (pre_stats, scan)
the rate at which they read it. Then the turbo round
(``_batch_window_decode_multi``, 64 streams x 32 frames): its time from
CUDA events without the profiler (median of ``--reps``), and the device
time of its kernels and copies per round under the profiler; their ratio
is the share of the round in which the card is busy. Prints the card's
name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from audio_modem_tpu_torch import decoder  # noqa: E402
from audio_modem_tpu_torch.kernels import receive  # noqa: E402
from audio_modem_tpu_torch.parallel import multi_receiver  # noqa: E402

STREAMING_STAGES = ("pre_stats_kernel", "scan_kernel")


def device_events(call, reps: int) -> list[tuple[str, float, int]]:
    """(name, device us in all, count) of every device-side event of ``reps`` calls."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return [(ev.key, ev.self_device_time_total, ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]


def profile_kernel_a(label: str, args: tuple, reps: int, n_bytes_window: int) -> None:
    call = lambda: receive.decode_fused(*args)  # noqa: E731
    ms = chip_smoke.time_ms(call, reps=reps)
    rows = [(name, us / reps, n / reps) for name, us, n in device_events(call, reps)]
    total = sum(r[1] for r in rows)
    print(f"{label}: call {ms:.4f} ms (CUDA events, median of {reps}); kernels {total / 1e3:.4f} ms per call "
          f"(torch.profiler)")
    for name, us, per_call in sorted(rows, key=lambda r: -r[1]):
        short = next((s for s in name.split("(")[0].split() if "kernel" in s), name)
        rate = ""
        if any(s in short for s in STREAMING_STAGES):
            rate = f", window read at {n_bytes_window / (us * 1e-6) / 1e12:.2f} TB/s"
        print(f"  {short}: {us / 1e3:.4f} ms per call ({per_call:g} launches){rate}")


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_receive: FAILED: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    mode, _, windows, n_valid, min_pos, n_sym, cadence = chip_smoke.turbo_windows(
        dev, np.random.default_rng(chip_smoke.SEED))
    profile_kernel_a("turbo slot 0 [64, 914688]", (windows, n_valid, min_pos, mode, n_sym), reps,
                     windows.numel() * 4)
    mode2, _, noisy2 = chip_smoke.config2_signal(dev)
    padded2 = decoder._padded(noisy2)
    args2 = (padded2[None], torch.tensor([noisy2.shape[0]], dtype=torch.int32, device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev), mode2, decoder._max_symbols(padded2.shape[0], mode2))
    profile_kernel_a(f"config 2 at B = 1 [1, {padded2.shape[0]}]", args2, reps, padded2.numel() * 4)
    profile_round(windows, n_valid, min_pos, mode, n_sym, cadence, reps)


if __name__ == "__main__":
    main()
