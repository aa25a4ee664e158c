"""Benchmark of the port on one CUDA card: stage for stage the counterpart
of the root ``bench.py``, at its sizes, through the port's entry points.

    python -m audio_modem_tpu_torch.bench
    python -m audio_modem_tpu_torch.cli bench

Prints ONE JSON line last on stdout, with four keys:
  metric       streaming demod Msamples/s on one card: the steady-state
               turbo round (``parallel.multi_receiver._batch_window_decode_multi``,
               64 QPSK streams x 32 frames a round: kernel A for slot 0,
               kernel C for the cadence-predicted slots after it, where the
               CPU runs their plain versions), every slot detected,
               CRC-valid and in sequence
  value, unit  the rate, "Msamples/s"
  vs_baseline  value / 44.1: multiples of the BASELINE.json target of 1000x
               real-time demodulation at 44.1 kHz

Every other figure goes to a details file, ``docs/bench_torch_local.json``
in the checkout or the path in ``AMT_BENCH_DETAILS``, under the root bench's
keys (``*_plain_msps`` where the root bench has ``*_xla_msps``: the plain
PyTorch version); ``device`` names the card, its power limit and the
versions. Each stage is gated by the budget (``AMT_BENCH_BUDGET_S``, 1500 s
by default): a stage that would start with less than its minimum left is
listed in ``skipped_stages``. A stage that raises is listed with its
exception in ``failed_stages``; the headline is still printed last, and
``main`` returns 1. Progress goes to stderr.

Times are host wall clock around work that ends in
``torch.cuda.synchronize()``, the best of several runs as the root bench
takes them; ``p50_detect_latency_device_ms`` comes from CUDA events. The
roofline (``roofline.py``) sets kernel A at the batch4096 rate, kernel B at
the frame_demod rate, kernel C at its own rate on the headline's windows
(``predicted_kernel_msps``: all 32 slots predicted, the receiver's steady
state) and the streaming demod at the long-frame rate against
the card's published memory rate and float32 peak; a card without published
peaks gets null shares. On the CPU (``device="cpu"``, as the tests run it at
small sizes) every kernel wrapper runs its plain version, the metric says
so, and the card-only figures are null.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from audio_modem_tpu_torch import MODES, api, framing, phy, roofline, sync
from audio_modem_tpu_torch.configs import SAMPLE_RATE, ModemMode
from audio_modem_tpu_torch.kernels import receive, resolve_device
from audio_modem_tpu_torch.ops.bits import bits_to_bytes
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.parallel.multi_receiver import (BatchReceiver, _batch_window_decode_multi, _classify_round,
                                                          _unpack_round)

BASELINE_MSPS = 44.1  # BASELINE.json: 1000x real time at 44.1 kHz
DETAILS_PATH = Path(__file__).resolve().parent.parent / "docs" / "bench_torch_local.json"
MODE_NAMES = ("QPSK", "16-QAM", "64-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "BPSK-REPEAT")
RECEIVER_BLOCK = 65536  # BatchReceiver's lockstep block and scan bucket
LONG_NOISE = 0.02  # AWGN amplitude on the long frames


def card_line() -> str | None:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (first card), or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info(dev: torch.device) -> dict:
    """What ran the bench: the card's name, its power limit (nvidia-smi), the
    torch and CUDA versions and the number of cards; "cpu" off the card."""
    smi = card_line() if dev.type == "cuda" else None
    return {
        "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "power_limit": smi.rsplit(",", 1)[-1].strip() if smi else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "count": torch.cuda.device_count(),
    }


def mode_payload(name: str) -> int:
    """Payload bytes of the per-mode stage's frames, as the root bench sizes
    them: 128 for BPSK-NARROW (127,503-sample frames), 512 / repetition for
    the other BPSK modes (BPSK-REPEAT's x3 frame is then as long as
    BPSK-ACOUSTIC's), the mode's chunk size otherwise."""
    m = MODES[name]
    return 128 if name == "BPSK-NARROW" else 512 // m.repetition if "BPSK" in name else m.chunk_size


def chunk_frame_signals(rng: np.random.Generator, mode: ModemMode, payload: int, n_unique: int, n_rows: int,
                        device) -> tuple:
    """``n_unique`` data chunk frames of ``payload`` random bytes (seq 0, 1,
    ...), synthesized on ``device`` in one call, as padded windows whose row
    i holds frame i % n_unique (``batch.pad_signals``' layout: zeros to a
    multiple of 128). Returns (frames [n_unique, L], signals [n_rows, T],
    n_valid [n_rows] int32, max_syms)."""
    frames = framing.build_data_chunk_frames([rng.bytes(payload) for _ in range(n_unique)], 0, mode, device=device)
    length = frames.shape[1]
    t = -(-length // 128) * 128
    rows = torch.arange(n_rows, device=frames.device) % n_unique
    signals = torch.nn.functional.pad(frames, (0, t - length))[rows].contiguous()
    n_valid = torch.full((n_rows,), length, dtype=torch.int32, device=frames.device)
    sym = mode.profile.symbol_len
    return frames, signals, n_valid, max((t - 3 * sym) // sym, 1)


def turbo_payloads(rng: np.random.Generator, n_streams: int, k: int, chunk: int) -> np.ndarray:
    """The headline's payloads: [n_streams * k, chunk + 11] uint8, stream s's
    j-th frame carrying sequence number j."""
    return np.frombuffer(
        b"".join(framing.build_data_chunk_payload(rng.bytes(chunk), s % k) for s in range(n_streams * k)), np.uint8
    ).reshape(n_streams * k, -1)


def turbo_windows(payloads: np.ndarray, mode: ModemMode, n_streams: int, k: int, device) -> tuple:
    """The headline's round input: every payload synthesized on ``device`` in
    one ``framing._synth_frames_core`` call, each stream's k frames back to
    back at the chunk cadence, zero-padded to the round's window (the
    runtime's margin, a multiple of 128). Returns (windows [n_streams, w],
    cadence, data symbols a frame)."""
    p = mode.profile
    n_sym = framing.num_symbols_for_payload(payloads.shape[1], mode)
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    cadence = framing.estimate_frame_samples(payloads.shape[1], mode) + pre + post
    w = -(-(k * cadence + 4 * p.symbol_len + p.fft_size + 2048) // 128) * 128
    u8 = torch.from_numpy(payloads.copy()).to(device)
    frames = framing._synth_frames_core(u8, mode, n_sym, pre, post).reshape(n_streams, k * cadence)
    return torch.nn.functional.pad(frames, (0, w - k * cadence)).contiguous(), cadence, n_sym


def _require(ok: bool, msg: str) -> None:
    """A check of a stage's output: raises, so the stage fails."""
    if not ok:
        raise RuntimeError(msg)


class _Bench:
    """One run: the device, the sizes, the random stream every stage draws
    from in the root bench's order, and the details it fills."""

    def __init__(self, dev: torch.device, n_streams: int, k: int, iters: int, unique: int, batches: tuple,
                 chunk: int, long_bytes: tuple, receiver_chunks: tuple, budget_s: float):
        self.t0 = time.time()
        self.dev, self.cuda = dev, dev.type == "cuda"
        self.n, self.k, self.iters, self.unique = n_streams, k, iters, unique
        self.batches, self.chunk, self.long_bytes, self.receiver_chunks = batches, chunk, long_bytes, receiver_chunks
        self.budget = budget_s
        self.rng = np.random.default_rng(0)
        self.mode = MODES["QPSK"]
        self.n_sym = framing.num_symbols_for_payload(chunk + 11, self.mode)
        self.details: dict = {"device": device_info(dev)}
        self.peaks = roofline.card_peaks(self.details["device"]["name"]) if self.cuda else None
        self.skipped: list[str] = []
        self.failed: list[dict] = []
        self.works: dict = {}  # roofline inputs: name -> (work, samples a call, details key of its rate)

    def log(self, msg: str) -> None:
        print(f"[bench +{time.time() - self.t0:6.1f}s] {msg}", file=sys.stderr, flush=True)

    def left(self) -> float:
        return self.budget - (time.time() - self.t0)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def best_s(self, fn, reps: int, depth: int | None = None) -> float:
        """Best host wall (s) of ``reps`` runs of ``depth`` (default
        ``iters``) back-to-back calls, each run ending when the card is done;
        one warm call first."""
        fn()
        self.sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(depth or self.iters):
                fn()
            self.sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def stage(self, name: str, min_left_s: float, fn) -> None:
        """Budget gate: run ``fn`` if ``min_left_s`` of the budget remains,
        else list it as skipped; a stage that raises is listed as failed
        (with its exception) and the run goes on, so the headline prints."""
        if self.left() < min_left_s:
            self.log(f"SKIP {name} (budget: {self.left():.0f}s left)")
            self.skipped.append(name)
            return
        self.log(f"stage {name} (budget: {self.left():.0f}s left)")
        try:
            fn()
        except Exception as e:  # the boundary of a stage: record, report, go on
            self.log(f"stage {name} FAILED:\n{traceback.format_exc()}")
            self.failed.append({"stage": name, "error": f"{type(e).__name__}: {e}"})

    # ---- correctness spot-check + single-frame rate (64 streams, one frame each) ----

    def spot_check(self) -> None:
        m, d = self.mode, self.details
        sym = m.profile.symbol_len
        self.log(f"building {self.n} QPSK frames")
        self.frames, self.sig, self.nv, self.max_syms = chunk_frame_signals(
            self.rng, m, self.chunk, self.unique, self.n, self.dev)
        full = lambda: batch.batch_decode_signals(self.sig, self.nv, m, self.max_syms)  # noqa: E731
        out = full()
        _require(bool(out["detected"].all()), "bench decode failed detection")
        start0 = int(out["start"][0])
        n_sym0 = (int(self.nv[0]) - (start0 + 3 * sym)) // sym
        by0 = bits_to_bytes(out["bits"][0, : n_sym0 * bits_per_symbol(m)]).cpu().numpy().tobytes()
        parsed = framing.parse_payload_bytes(by0)
        _require(isinstance(parsed, framing.DataFrame) and parsed.crc_valid, "bench payload corrupt")
        dt = self.best_s(full, 5)
        d["headline_1frame_msps"] = round(int(self.nv.sum()) * self.iters / dt / 1e6, 2)
        self.log(f"single frame a stream per call: {d['headline_1frame_msps']} Msps")

    # ---- the headline: the steady-state K-frame turbo round ----

    def headline(self) -> None:
        m, d, n, k = self.mode, self.details, self.n, self.k
        self.log(f"building {n}x{k}-frame turbo windows")
        windows, cadence, n_sym = turbo_windows(turbo_payloads(self.rng, n, k, self.chunk), m, n, k, self.dev)
        minp = torch.zeros(n, dtype=torch.int32, device=self.dev)
        nvt = torch.full((n,), k * cadence, dtype=torch.int32, device=self.dev)
        rnd = lambda: _batch_window_decode_multi(windows, minp, nvt, m, n_sym, k, cadence)  # noqa: E731
        cls = _classify_round(rnd().cpu().numpy(), self.chunk)
        _require(cls is not None, "turbo packed rows too narrow")
        det, _, full, seq = cls
        _require(bool(det.all()), "turbo round: not all slots detected")
        _require(bool(full.all()), "turbo round: not all slots CRC-valid")
        _require(bool((seq == np.arange(k)[None, :]).all()), "turbo seq mismatch")
        self.log("timing K-frame turbo rounds")
        dt = self.best_s(rnd, 5)
        # kernel C alone on the same windows, every slot predicted from slot 0's start
        start0 = torch.from_numpy(_unpack_round(rnd().cpu().numpy())[1][:, 0].astype(np.int32)).to(self.dev) - cadence
        ok0 = torch.ones(n, dtype=torch.bool, device=self.dev)
        dt_c = self.best_s(lambda: receive.decode_predicted(windows, nvt, start0, ok0, m, n_sym, k, cadence), 5)
        d["predicted_kernel_msps"] = round(windows.numel() * self.iters / dt_c / 1e6, 2)
        self.works["C (decode_predicted) at the turbo round"] = (
            roofline.work_decode_predicted(m, n, windows.shape[1], n_sym, k), windows.numel(), "predicted_kernel_msps")
        # samples consumed a round: K frame cadences a stream (the runtime's
        # pred_dispatch accounting)
        self.block_samples = k * cadence * n
        self.msps = self.block_samples * self.iters / dt / 1e6
        d["headline_frames_per_dispatch"] = k
        d["headline_samples_per_dispatch"] = self.block_samples
        d["headline_percall_ms"] = round(dt / self.iters * 1e3, 3)
        d["frames_per_sec"] = round(n * k * self.iters / dt, 1)
        self.log(f"headline: {self.msps:.1f} Msps")

    # ---- batch scaling: the same windows at 512 and 4096 rows ----

    def batch_rows(self, key: str, rows: int) -> None:
        idx = torch.arange(rows, device=self.dev) % self.n
        sig, nv = self.sig[idx].contiguous(), self.nv[idx]
        dt = self.best_s(lambda: batch.batch_decode_signals(sig, nv, self.mode, self.max_syms), 2)
        msps = sig.numel() * self.iters / dt / 1e6
        self.details[f"{key}_full_pipeline_msps"] = round(msps, 2)
        self.details[f"{key}_realtime_streams"] = round(msps * 1e6 / SAMPLE_RATE, 0)
        if key == "batch4096":
            self.works["A (decode_fused) at batch4096"] = (
                roofline.work_decode_fused(self.mode, rows, sig.shape[1], self.max_syms), sig.numel(),
                "batch4096_full_pipeline_msps")

    # ---- launch overhead ----

    def dispatch_floor(self) -> None:
        d = self.details
        tiny = torch.zeros((8, 128), dtype=torch.float32, device=self.dev)

        def chain():
            o = tiny
            for _ in range(self.iters):
                o = o + 1.0

        floor_ms = self.best_s(chain, 5, depth=1) / self.iters * 1e3
        d["dispatch_floor_ms"] = round(floor_ms, 4)
        # enqueue cost of one launch: the host's side alone
        t0 = time.perf_counter()
        outs = [tiny + 1.0 for _ in range(100)]
        enq_ms = (time.perf_counter() - t0) / 100 * 1e3
        self.sync()
        del outs
        d["local_dispatch_proxy_ms"] = round(enq_ms, 4)
        percall_ms = d["headline_percall_ms"]
        d["headline_dispatch_bound_msps"] = round(self.block_samples / (floor_ms * 1e-3) / 1e6, 1)
        d["headline_floor_fraction"] = round(floor_ms / percall_ms, 5)
        where = f"on {d['device']['name']}" if self.cuda else "on the CPU (plain versions; not a card figure)"
        ceiling = d.get("batch4096_full_pipeline_msps")
        d["headline_analysis"] = (
            f"K={self.k} turbo round {where}: a trivial op (x + 1 on [8, 128]) costs {floor_ms:.4f} ms a call "
            f"at depth {self.iters}, {enq_ms:.4f} ms of it to enqueue; one such call a round would bound "
            f"{d['headline_dispatch_bound_msps']:.0f} Msps at {self.block_samples} samples a round. The measured "
            f"round takes {percall_ms:.3f} ms, {percall_ms / floor_ms:.0f} times that floor: slot 0 is one call "
            f"of kernel A and the {self.k - 1} predicted slots one call of kernel C (refine, CE, demod, vote and "
            f"pack of every slot; alone, all {self.k} slots predicted, at {d.get('predicted_kernel_msps')} Msps)."
            + (f" Kernel A alone over the same frames at 4096 rows (batch4096) runs at {ceiling} Msps." if ceiling
               else ""))

    # ---- detection latency, one stream ----

    def detect_latency(self) -> None:
        d, p = self.details, self.mode.profile
        s1, nv1 = self.sig[0], self.nv[0]
        one = lambda: sync.detect_preamble(s1, p, nv1)  # noqa: E731
        one()
        self.sync()
        lats = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(10):
                one()
            self.sync()
            lats.append((time.perf_counter() - t0) / 10)
        p50 = statistics.median(lats) * 1e3
        d["p50_detect_latency_ms"] = round(p50, 4)
        dev_ms = None
        if self.cuda:
            pairs = []
            for _ in range(50):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                one()
                b.record()
                pairs.append((a, b))
            self.sync()
            dev_ms = statistics.median(a.elapsed_time(b) for a, b in pairs)
        d["p50_detect_latency_device_ms"] = None if dev_ms is None else round(dev_ms, 4)
        d["detect_latency_note"] = (
            f"sync.detect_preamble on one {s1.shape[0]}-sample stream: p50 {p50:.4f} ms a call on the host clock "
            "(10 calls back to back, each run ending in a synchronize); "
            + (f"p50_detect_latency_device_ms {dev_ms:.4f} ms is the median span between CUDA events around "
               "single calls (the card's stream time of a call, gaps between its launches included)"
               if self.cuda else "no card, so no device time"))

    # ---- frame-aligned demod (kernel B) ----

    def frame_demod(self) -> None:
        m, p = self.mode, self.mode.profile
        pre = p.silence_pre_chunk(False)
        rows = torch.arange(self.n, device=self.dev) % self.unique
        aligned = self.frames[:, pre : pre + (3 + self.n_sym) * p.symbol_len][rows].contiguous()
        dt = self.best_s(lambda: batch.batch_decode_chunk_frames(aligned, m, self.n_sym), 1)
        self.details["frame_demod_only_msps"] = round(aligned.numel() * self.iters / dt / 1e6, 2)
        self.works["B (decode_chunks_fused) at frame_demod"] = (
            roofline.work_chunks(m, self.n, aligned.shape[1], self.n_sym), aligned.numel(), "frame_demod_only_msps")

    # ---- TX: modulate alone, then whole frames ----

    def encode(self) -> None:
        m, p = self.mode, self.mode.profile
        bits_one = framing.payload_to_bits(framing.build_data_chunk_payload(self.rng.bytes(self.chunk), 0), m)
        bits = torch.from_numpy(np.tile(bits_one, (self.n, 1))).to(self.dev)
        dt = self.best_s(lambda: phy.modulate(bits, m), 5)
        self.details["encode_modulate_msps"] = round(self.n * self.n_sym * p.symbol_len * self.iters / dt / 1e6, 2)

    def encode_frames(self, key: str, nb: int, reps: int, depth: int) -> None:
        m, p = self.mode, self.mode.profile
        pls = [framing.build_data_chunk_payload(self.rng.bytes(self.chunk), s) for s in range(nb)]
        u8 = torch.from_numpy(np.frombuffer(b"".join(pls), np.uint8).reshape(nb, -1).copy()).to(self.dev)
        pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
        total = nb * (framing.estimate_frame_samples(u8.shape[1], m) + pre + post)
        dt = self.best_s(lambda: framing._synth_frames_core(u8, m, self.n_sym, pre, post), reps, depth)
        self.details[key] = round(total * depth / dt / 1e6, 2)

    # ---- long frames: the streaming demod against its plain version and kernel B ----

    def long_frames(self, prefix: str, mode: ModemMode, payload: int) -> None:
        p = mode.profile
        n_sym = framing.num_symbols_for_payload(payload + 11, mode)
        one = framing.build_data_chunk_frame(self.rng.bytes(payload), 0, mode, device=self.dev)
        one = one[p.silence_pre_chunk(False) :][: (3 + n_sym) * p.symbol_len].cpu().numpy()
        host = np.tile(one, (self.unique, 1))
        host += LONG_NOISE * self.rng.standard_normal(host.shape).astype(np.float32)
        rows = torch.arange(self.n, device=self.dev) % self.unique
        frames = torch.from_numpy(host).to(self.dev)[rows].contiguous()
        for key, fn in (
            (f"{prefix}_kernel_msps", lambda: receive.decode_chunks_fused_stream(frames, mode, n_sym)),
            (f"{prefix}_plain_msps", lambda: receive.decode_chunks_fused_reference(frames, mode, n_sym)),
            (f"{prefix}_dispatch_msps", lambda: batch.batch_decode_chunk_frames(frames, mode, n_sym)),
        ):
            dt = self.best_s(fn, 3)
            self.details[key] = round(frames.numel() * self.iters / dt / 1e6, 2)
        if prefix == "long_frame":
            self.works["streaming demod (stream_demod) at long_frame"] = (
                roofline.work_stream_demod(mode, self.n, n_sym), frames.numel(), "long_frame_kernel_msps")

    # ---- the roofline of the four kernels at the rates above ----

    def roofline(self) -> None:
        name = self.details["device"]["name"]
        peaks = self.peaks
        if peaks is None:
            self.log(f"roofline: no published peaks for {name!r}: shares not computed")
        kernels = {key: roofline.share(work, n_samples, self.details[rate_key], peaks)
                   for key, (work, n_samples, rate_key) in self.works.items() if rate_key in self.details}
        parts = []
        for key, r in kernels.items():
            line = (f"{key} at {r['at_msps']} Msps moves {r['bytes_per_sample']:.2f} B and runs "
                    f"{r['fp32_flops_per_sample']:.1f} float32 operations a sample")
            if peaks is not None:
                line += (f": {r['pct_of_hbm']:.2f}% of the memory rate, {r['pct_of_fp32']:.2f}% of the float32 "
                         f"peak, bound by {r['bound_by']}")
            parts.append(line)
        self.details["roofline"] = {
            "device_kind": name,
            "assumed_peaks": None if peaks is None else {"hbm_bytes_per_s": peaks[0], "fp32_flops": peaks[1]},
            "kernels": kernels,
            "bound_argument": "; ".join(parts) + (
                "." if peaks is not None else f". No published peaks for {name!r}: shares not computed."),
        }
        self.log(f"roofline: {self.details['roofline']['bound_argument']}")

    # ---- the whole multi-stream runtime ----

    def batch_receiver(self) -> None:
        d, m, n, block = self.details, self.mode, self.n, RECEIVER_BLOCK
        host_chunks, dev_chunks = self.receiver_chunks

        def feed(rx, blocks) -> float:
            t0 = time.perf_counter()
            for b in blocks:
                rx.process_blocks(b)
            rx.flush()
            self.sync()
            return time.perf_counter() - t0

        def check(label: str, rx, want: bytes) -> None:
            for i, r in enumerate(rx.results()):
                _require(r["complete"] and r["data"] == want, f"batch_receiver bench decode failed ({label}, "
                         f"stream {i}: missing {r['missing'][:8]})")

        # host-fed: every block crosses from host memory
        data = self.rng.bytes(m.chunk_size * host_chunks)
        sig = torch.cat(list(api.encode_chunked(data, m, "b.bin", batch=4, device=self.dev))).cpu().numpy()
        blocks_list = []
        for off in range(0, len(sig), block):
            buf = np.zeros((n, block), np.float32)
            seg = sig[off : off + block]
            buf[:, : len(seg)] = seg[None, :]
            blocks_list.append(buf)
        for label, kw in (("batch_receiver_msps", {}), ("batch_receiver_turbo_msps", {"window_decode": True})):
            warm = BatchReceiver(m, n, scan_bucket=block, device=self.dev, **kw)
            feed(warm, blocks_list)
            check(f"{label}, warm", warm, data)
            del warm
            rx = BatchReceiver(m, n, scan_bucket=block, device=self.dev, **kw)
            d[label] = round(n * len(sig) / feed(rx, blocks_list) / 1e6, 2)
            check(label, rx, data)
            del rx

        # device-resident ingest at steady state: blocks are broadcast slices
        # of one signal on the card, so no copy from the host in the loop
        data2 = self.rng.bytes(m.chunk_size * dev_chunks)
        sig2 = torch.cat(list(api.encode_chunked(data2, m, "b2.bin", batch=16, device=self.dev)))
        n_blocks = -(-sig2.shape[0] // block)
        padded = torch.nn.functional.pad(sig2, (0, n_blocks * block - sig2.shape[0]))
        dev_blocks = [padded[i * block : (i + 1) * block].expand(n, block) for i in range(n_blocks)]
        warm = BatchReceiver(m, n, scan_bucket=block, device_ingest=True, device=self.dev)
        feed(warm, dev_blocks)
        check("device, warm", warm, data2)
        del warm
        dt = float("inf")
        for _ in range(3):
            rx = BatchReceiver(m, n, scan_bucket=block, device_ingest=True, device=self.dev)
            dt_rep = feed(rx, dev_blocks)
            check("device", rx, data2)
            dt = min(dt, dt_rep)
            rep = rx.timer.report()
            del rx
        samples = n * sig2.shape[0]
        d["batch_receiver_device_msps"] = round(samples / dt / 1e6, 2)
        d["batch_receiver_realtime_streams"] = round(d["batch_receiver_device_msps"] * 1e6 / SAMPLE_RATE, 0)
        d["batch_receiver_stage_breakdown"] = rep
        # the last pass with its blocking fetch waits taken out (an upper
        # bound: part of the wait overlaps the card's work)
        fetch_s = sum(v["seconds"] for k, v in rep.items() if k.endswith("_fetch"))
        d["batch_receiver_nonfetch_msps"] = round(samples / max(dt_rep - fetch_s, 1e-9) / 1e6, 2)
        d["batch_receiver_nonfetch_note"] = (
            "the last device-ingest pass's wall less its *_fetch stages (waits for rounds' results, part of "
            "which overlaps the card's work): an upper bound")

        if not self.cuda:
            d["h2d_bandwidth_mbps"] = d["d2h_bandwidth_mbps"] = d["batch_receiver_d2h_bound_msps"] = None
            d["batch_receiver_analysis"] = "no card: nothing crosses PCIe on the CPU, so no bandwidth figure"
            return
        # PCIe from pageable host memory, as the host-fed receiver copies
        torch.from_numpy(blocks_list[0]).to(self.dev)
        self.sync()
        t0 = time.perf_counter()
        for b in blocks_list:
            torch.from_numpy(b).to(self.dev)
        self.sync()
        bw = sum(b.nbytes for b in blocks_list) / (time.perf_counter() - t0) / 1e6
        d["h2d_bandwidth_mbps"] = round(bw, 1)

        def t_d2h(size: int) -> float:
            best = float("inf")
            for i in range(3):
                arr = torch.full((size,), i, dtype=torch.uint8, device=self.dev)
                self.sync()
                t0 = time.perf_counter()
                arr.cpu()
                best = min(best, time.perf_counter() - t0)
            return best

        t_d2h(1 << 10)  # warm
        small, big = 1 << 18, 1 << 22
        d2h = (big - small) / max(t_d2h(big) - t_d2h(small), 1e-9) / 1e6
        d["d2h_bandwidth_mbps"] = round(d2h, 1)
        # decoded bytes a slot brings back (5 + the wire payload) per frame of samples
        frame_samp = framing.estimate_frame_samples(m.chunk_size + 11, m)
        slot_bytes = m.chunk_size + 11 + 5
        d["batch_receiver_d2h_bound_msps"] = round(d2h * frame_samp / slot_bytes, 1)
        top, top_v = max(rep.items(), key=lambda kv: kv[1]["seconds"])
        d["batch_receiver_analysis"] = (
            f"on {d['device']['name']}: host-fed, every sample crosses PCIe from pageable memory at {bw:.0f} MB/s "
            f"(a cap of {bw / 4:.0f} Msamples/s); the staged receiver ran at {d['batch_receiver_msps']} and the "
            f"turbo one at {d['batch_receiver_turbo_msps']} Msamples/s. Device ingest ran at "
            f"{d['batch_receiver_device_msps']} Msamples/s; its last pass spent {fetch_s:.3f} s of "
            f"{dt_rep:.3f} s in *_fetch stages and {top_v['seconds']:.3f} s in {top} ({top_v['calls']} calls); "
            f"the decoded bytes ({slot_bytes} a {frame_samp}-sample frame) come back at {d2h:.0f} MB/s, which "
            f"would bound the runtime at {d['batch_receiver_d2h_bound_msps']:.0f} Msamples/s.")

    # ---- every mode at the batch512 rows ----

    def per_mode(self, name: str) -> None:
        m = MODES[name]
        _, sig, nv, max_syms = chunk_frame_signals(
            self.rng, m, mode_payload(name), self.unique, self.batches[0], self.dev)
        out = batch.batch_decode_signals(sig, nv, m, max_syms)
        _require(bool(out["detected"].all()), f"{name} bench decode failed detection")
        dt = self.best_s(lambda: batch.batch_decode_signals(sig, nv, m, max_syms), 2)
        self.details.setdefault("per_mode_msps", {})[name] = round(int(nv.sum()) * self.iters / dt / 1e6, 1)

    def stages(self) -> list:
        """(name, least budget left to start it, body) in the root bench's
        order, but the roofline: it reads the four kernels' rates, so it
        runs after the last of them."""
        rows512, rows4096 = self.batches
        return [
            ("batch512", 150.0, lambda: self.batch_rows("batch512", rows512)),
            ("batch4096", 220.0, lambda: self.batch_rows("batch4096", rows4096)),
            ("dispatch_floor", 60.0, self.dispatch_floor),
            ("detect_latency", 90.0, self.detect_latency),
            ("frame_demod", 120.0, self.frame_demod),
            ("encode", 120.0, self.encode),
            ("encode_frames64", 150.0, lambda: self.encode_frames("encode_frame_synth_msps", self.n, 5, self.iters)),
            ("encode_frames512", 150.0, lambda: self.encode_frames("encode_frames512_msps", rows512, 3, self.iters)),
            # depth 4: each call holds a [4096, 28,431] float32 output (466 MB)
            ("encode_frames4096", 200.0, lambda: self.encode_frames("encode_frames4096_msps", rows4096, 3, 4)),
            ("long_frame", 280.0, lambda: self.long_frames("long_frame", MODES["BPSK-NARROW"], self.long_bytes[0])),
            ("long_frame_standard", 200.0, lambda: self.long_frames("long_std", self.mode, self.long_bytes[1])),
            ("roofline", 5.0, self.roofline),
            ("batch_receiver", 250.0, self.batch_receiver),
        ] + [(f"mode:{name}", 200.0, lambda name=name: self.per_mode(name)) for name in MODE_NAMES]

    def emit(self) -> dict:
        d = self.details
        d["realtime_streams_per_chip"] = round(self.msps * 1e6 / SAMPLE_RATE, 0)
        if self.skipped:
            d["skipped_stages"] = self.skipped
        if self.failed:
            d["failed_stages"] = self.failed
        where = "/card" if self.cuda else " on the CPU (plain versions, not a card figure)"
        headline = {
            "metric": f"streaming demod Msamples/s{where} ({self.n}-stream QPSK, {self.k}-frame turbo rounds, "
                      "full pipeline)",
            "value": round(self.msps, 2),
            "unit": "Msamples/s",
            "vs_baseline": round(self.msps / BASELINE_MSPS, 3),
        }
        # the details go to a file and the headline, compact, is the last line of stdout
        path = Path(os.environ.get("AMT_BENCH_DETAILS") or DETAILS_PATH)
        try:
            path.write_text(json.dumps({**headline, "details": d}, indent=2) + "\n")
            self.log(f"details written to {path}")
        except OSError as e:
            self.log(f"could not write details file: {e}")
        print(json.dumps(headline), flush=True)
        return headline


def run(device="cuda", *, n_streams: int = 64, K: int = 32, iters: int = 10, unique: int = 8,
        batches: tuple = (512, 4096), chunk: int | None = None, long_bytes: tuple = (512, 32768),
        receiver_chunks: tuple = (4, 128)) -> tuple[dict, dict]:
    """Every stage of the root bench on ``device``; returns (headline,
    details) after printing the headline as the last line of stdout.

    The sizes are the root bench's by default: ``n_streams`` QPSK streams,
    ``K`` frames a turbo round, ``iters`` calls a timed run, ``unique``
    distinct frames tiled over the rows, ``batches`` the rows of the
    batch512 and batch4096 stages (and of the per-mode and 512/4096-frame
    TX stages), ``chunk`` payload bytes of the QPSK frames (the mode's chunk
    size), ``long_bytes`` the long BPSK-NARROW and QPSK frames' payloads,
    ``receiver_chunks`` the host-fed and device-ingest transfers' chunks a
    stream."""
    dev = resolve_device(device)
    bench = _Bench(dev, n_streams, K, iters, unique, tuple(batches), chunk or MODES["QPSK"].chunk_size,
                   tuple(long_bytes), tuple(receiver_chunks), float(os.environ.get("AMT_BENCH_BUDGET_S", "1500")))
    bench.spot_check()
    bench.headline()
    for name, min_left, fn in bench.stages():
        bench.stage(name, min_left, fn)
    headline = bench.emit()
    bench.log("done")
    return headline, bench.details


def main(device="cuda", **sizes) -> int:
    """Run the bench (``run``'s sizes); 1 if a stage failed, else 0."""
    _, details = run(device, **sizes)
    return 1 if details.get("failed_stages") else 0


if __name__ == "__main__":
    raise SystemExit(main())
