#!/usr/bin/env python3
"""SHA-256 digests of what the port's hand kernels emit on chip_smoke.py's
inputs, to compare two checkouts bit for bit.

    python3 tools/torch_kernel_digest.py [--root CHECKOUT]

Imports ``audio_modem_tpu_torch`` from ``--root`` (this checkout by
default) and builds the inputs with this checkout's ``chip_smoke`` as
chip_smoke.py does, from the same seeds in the same order: the turbo
windows (phase 4), their 64 frame-aligned frames (phase 5), the 64
BPSK-NARROW and 64 QPSK chunk frames (phase 8) and BASELINE config 2's
padded signal (phase 9): one line per (input, entry point), the digest of
the whole bits tensor. Then kernel C (``decode_predicted``) on phase 7's
round in both branches and on phase 26's edge inputs
(``chip_smoke.predicted_edges``, which also holds C to its plain version):
one line per input for the chain's start, fine metric and cumulative flag,
and one for the packed rows (C's bits). Two checkouts whose kernels agree
bit for bit print the same lines. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    root = ap.parse_args().root.resolve()
    sys.path.insert(0, str(root))
    import importlib.util

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_digest: FAILED: torch.cuda.is_available() is False")
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from audio_modem_tpu_torch import MODES, decoder, framing
    from audio_modem_tpu_torch.kernels import receive

    def show(label: str, bits: torch.Tensor) -> None:
        torch.cuda.synchronize()
        digest = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
        print(f"{label}: {tuple(bits.shape)} {digest}", flush=True)

    def show_c(label: str, out: dict) -> None:
        for key in ("start", "fine_metric", "detected"):
            show(f"{label} decode_predicted chain {key}", out[key])
        show(f"{label} decode_predicted packed", out["packed"])

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(chip_smoke.SEED)
    mode, frames, windows, n_valid, min_pos, n_sym, cadence = chip_smoke.turbo_windows(dev, rng)
    p = mode.profile
    ka = receive.decode_fused(windows, n_valid, min_pos, mode, n_sym)
    show("phase 4 turbo windows decode_fused", ka["bits"])
    pre_s = p.silence_pre_chunk(False)
    aligned = frames.reshape(chip_smoke.N_STREAMS, chip_smoke.K, cadence)[
        :, 0, pre_s : pre_s + (3 + n_sym) * p.symbol_len].contiguous()
    show("phase 5 aligned frames decode_chunks_fused", receive.decode_chunks_fused(aligned, mode, n_sym))
    for name, size in (("BPSK-NARROW", 512), ("QPSK", 2048)):
        m = MODES[name]
        pm = m.profile
        ns = framing.num_symbols_for_payload(size + 11, m)
        fr = framing.build_data_chunk_frames(
            [rng.bytes(size) for _ in range(chip_smoke.N_STREAMS)], 0, m, device=dev)
        pre = pm.silence_pre_chunk(False)
        fr = fr[:, pre : pre + (3 + ns) * pm.symbol_len].contiguous()
        show(f"phase 8 {name} frames decode_chunks_fused", receive.decode_chunks_fused(fr, m, ns))
        show(f"phase 8 {name} frames decode_chunks_fused_stream", receive.decode_chunks_fused_stream(fr, m, ns))
    mode2, _, noisy2 = chip_smoke.config2_signal(dev)
    padded2 = decoder.pad_to_bucket(noisy2)
    ms2 = decoder._max_symbols(padded2.shape[0], mode2)
    nv2 = torch.tensor([noisy2.shape[0]], dtype=torch.int32, device=dev)
    mp2 = torch.zeros(1, dtype=torch.int32, device=dev)
    show("phase 9 config 2 decode_long_fused (stream_demod)",
         receive.decode_long_fused(padded2[None], nv2, mp2, mode2, ms2)["bits"])
    show("phase 9 config 2 decode_fused at B = 1", receive.decode_fused(padded2[None], nv2, mp2, mode2, ms2)["bits"])
    del padded2, noisy2
    k = chip_smoke.K
    show_c("phase 7 slot 0 from kernel A",
           receive.decode_predicted(windows, n_valid, ka["start"], ka["detected"], mode, n_sym, k, cadence, ka["bits"]))
    show_c("phase 7 every slot predicted",
           receive.decode_predicted(windows, n_valid, (ka["start"] - cadence).to(torch.int32),
                                    torch.ones_like(ka["detected"]), mode, n_sym, k, cadence))
    edges: list = []
    chip_smoke.predicted_edges(dev, mode, windows, n_sym, cadence, record=edges)
    for label, out in edges:
        show_c(f"phase 26 {label}", out)


if __name__ == "__main__":
    main()
