"""The one-shot decoder under sample-clock offset:
``api.decode(recording, mode, track_timing=True)`` of host recordings, one
closed-loop caller, until the window has lasted ``--seconds``.

Traffic, made from the seed at set-up on the card: a pool of seeded legacy
frames (one file each) from the benchmark's own transmitter
(``decode_loop.make_pool``, clean), each resampled as a receiver whose
clock is off by its own fixed offset records it (``reference.drift``,
float64; the offsets come from the cell, recording ``i`` takes the
``i``-th, so the seed changes the data and the noise, not the work), then
AWGN, then stored as float32 on the host, where the caller hands it over.

Compared after the window, outside the set-up: every decode's file, CRC
and name against the seeded payload (``bad_decodes``); its frame start,
refined metric and channel magnitude against the reference's receive of
the same recording (``decode_loop.compare``); and the timing tracker: a
tap on ``decoder._tracked_core`` (the name ``decode_raw`` looks it up by)
keeps ``KEEP`` of its calls, drawn from the seed, with their inputs and
outputs, and ``reference.tracked`` demodulates the same inputs in float64,
its timing measured over the seeded payload's own symbols: the widest gap
of the final tau (``tau_gap``, samples) and the widest share of the bits of
the frame's own symbols that differ (``track_bit_gap``). The symbols the
program measured, the bound it read from the untracked header, are held
to the payload's count apart (``track_len_gap``, symbols).

Set-up decodes every recording once; a program that gets one of them
wrong cannot be timed on this configuration, and the run stops there
with the harness's refusal (exit code 2, no result line) before the
window opens.

A ``--trace 1`` run profiles the card and turns the program's span
recorder on over the window's first ``TRACED_DECODES`` decodes, whole,
and keeps what puts the recorder's spans on the device trace's clock
(``counts["clock_shift_ns"]``).
"""

from __future__ import annotations

import sys
import time

import torch

from audio_modem_tpu_torch import api, decoder
from benchmark import capture, spans, trace
from benchmark.harness import Context, Outcome, Readings, Refused
from benchmark.reference import drift, oracle, roofline, tracked
from benchmark.reference.profiles import MODES
from benchmark.traffic import decode_loop

# Decodes the device trace covers: a tracked decode of config 2 launches
# tens of thousands of device operations.
TRACED_DECODES = 1
# Tracker calls kept for the comparison with the reference.
KEEP = 4
# The noise's generator: the seed's, on a stream of its own.
NOISE_STREAM = 0x5EED_D41F7


def make_pool(mode_name: str, n: int, size: int, file_name: str, ppm: list, snr_db: float, seed: int,
              device) -> tuple[torch.Tensor, list[bytes]]:
    """(recordings: float32 [n, T] on ``device``, files) of ``n`` seeded
    files, recording ``i`` off by ``ppm[i % len(ppm)]``; the noise's power
    is ``snr_db`` under the resampled recording's mean power, its silences
    included."""
    clean, files = decode_loop.make_pool(mode_name, n, size, file_name, None, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed ^ NOISE_STREAM) % (1 << 63))
    recs = torch.empty_like(clean)
    for i in range(n):
        x = drift.clock_drift(clean[i : i + 1], float(ppm[i % len(ppm)]))
        power = (x * x).mean()
        noise = torch.randn(x.shape, generator=gen, device=device, dtype=torch.float32)
        recs[i] = (x + noise * (power / 10 ** (snr_db / 10)).sqrt()).to(torch.float32)[0]
    return recs, files


class ClockedTrace(trace.DeviceTrace):
    """The device trace, keeping what puts the program's spans on its clock:
    the nanoseconds to add to a span's ``perf_counter`` time (``shift_ns``;
    None where the program has no recorder, and on the CPU, which traces
    no device)."""

    shift_ns: int | None = None

    def start(self) -> None:
        super().start()
        rec = spans._recorder()
        self._pair = rec.clock_pair() if self.active and rec is not None and hasattr(rec, "clock_pair") else None

    def stop(self) -> None:
        prof = self._prof
        super().stop()
        if prof is not None and self._pair is not None:
            self.shift_ns = self._pair[1] - self._pair[0] - prof.profiler.kineto_results.trace_start_ns()


def _exact(result, file: bytes, name: str) -> bool:
    """The decode's parsed frame is CRC-valid, names ``name`` and holds ``file``."""
    return (getattr(result, "data", None) == file and bool(getattr(result, "crc_valid", False))
            and getattr(result, "file_name", None) == name)


def _kept(tap, n_signal: int) -> dict:
    """The kept calls' inputs stacked for the reference, which measures the
    timing over the payload's ``n_signal`` symbols (at most a call's
    ``n_sym``), and the program's bits, final tau and measured symbols (a
    program without the bound measures every symbol)."""
    calls = [args for args, _ in tap.kept]
    x = torch.stack([a["signal"] for a in calls])  # the pool's recordings are of one length
    n_sym = torch.tensor([a["n_sym"] for a in calls])
    measured = [a["n_sym"] if a.get("n_valid_sym") is None else a["n_valid_sym"] for a in calls]
    return {"x": x, "n_valid": torch.tensor([a["n_valid"] for a in calls]),
            "start": torch.tensor([a["start"] for a in calls]), "n_sym": n_sym,
            "n_measured": torch.clamp(n_sym, max=n_signal), "program_measured": torch.tensor(measured),
            "bits": [out[0] for _, out in tap.kept], "tau": [float(out[1]) for _, out in tap.kept]}


def track_gaps(kept: dict, mode_name: str, n_signal: int, subject=None) -> dict:
    """``tau_gap`` and ``track_bit_gap`` of the kept calls against the
    reference on their inputs, and the program's ``track_len_gap``;
    ``subject`` a ``Precision`` judges the reference computed in it instead
    of the program."""
    args = (kept["x"], kept["n_valid"], kept["start"], kept["n_sym"], mode_name)
    bits, tau = tracked.demodulate(*args, n_measured=kept["n_measured"])
    res = {"tau_gap": 0.0, "track_bit_gap": 0.0}
    if subject is not None:
        got_bits, got_tau = tracked.demodulate(*args, prec=subject, n_measured=kept["n_measured"])
        got = [(got_bits[i], float(got_tau[i])) for i in range(bits.shape[0])]
    else:
        got = list(zip(kept["bits"], kept["tau"]))
        res["track_len_gap"] = int((kept["program_measured"] - kept["n_measured"]).abs().max())
    per_sym = MODES[mode_name].bits_per_symbol
    for i, (b, t) in enumerate(got):
        n = min(n_signal, int(kept["n_sym"][i])) * per_sym
        res["tau_gap"] = max(res["tau_gap"], abs(t - float(tau[i])))
        differ = (b[:n].to(bits.device, torch.int64) != bits[i, :n]).sum()
        res["track_bit_gap"] = max(res["track_bit_gap"], float(differ) / n)
    return res


def run(ctx: Context) -> Outcome:
    mode_name = ctx.param("mode")
    mode = MODES[mode_name]
    if ctx.param("feed") != "host":
        raise ValueError("this cell hands the decoder host recordings: feed must be host")
    name = ctx.param("file_name")
    t_pool = time.perf_counter()
    recs, files = make_pool(mode_name, ctx.param("pool"), ctx.param("file_bytes"), name, ctx.param("ppm"),
                            ctx.param("snr_db"), ctx.seed, ctx.device)
    recs = recs.cpu()
    feed = [r.numpy() for r in recs]
    if ctx.device != "cpu":  # the peak from here on: the program's, not the transmitter's scratch
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    ppm = ctx.param("ppm")
    for i, rec in enumerate(feed):  # every recording once: builds and loads the kernels, fills the allocators
        result, _ = api.decode(rec, mode_name, track_timing=True, device=ctx.device)
        if not _exact(result, files[i], name):
            raise Refused(f"the program does not decode this configuration: recording {i} "
                          f"({ppm[i % len(ppm)]:+g} ppm) came back wrong at set-up, so there is nothing to time")
    t_ready = time.perf_counter()
    setup_s = t_ready - ctx.t_start
    print(f"setup split s: before the pool {t_pool - ctx.t_start:.3f}, pool {t_warm - t_pool:.3f}, "
          f"warm decodes {t_ready - t_warm:.3f}", file=sys.stderr)

    recorder = spans._recorder() if ctx.trace else None
    lat, out = [], []
    targets = {"tracked_core": (decoder, "_tracked_core")}
    with capture.Taps(ctx.seed, KEEP, ctx.trace, targets) as taps, ClockedTrace(ctx.trace, ctx.device) as tr:
        if recorder is not None:
            recorder.enable()
        t_w0 = time.perf_counter()
        while time.perf_counter() - t_w0 < ctx.seconds:
            k = len(out) % len(feed)
            t = time.perf_counter()
            result, info = api.decode(feed[k], mode_name, track_timing=True, device=ctx.device)
            lat.append((time.perf_counter() - t) * 1e3)
            out.append((k, result, info))
            if tr.active and len(out) == TRACED_DECODES:
                if recorder is not None:
                    recorder.disable()
                taps.stop_shapes()
                t_read = time.perf_counter()
                tr.stop()
                print(f"device trace: {len(tr.events)} events, read in {time.perf_counter() - t_read:.3f} s",
                      file=sys.stderr)
        t_w1 = time.perf_counter()
        if recorder is not None:
            recorder.disable()
    peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0
    traced = min(len(out), TRACED_DECODES) if ctx.trace else 0
    print(f"decode ms: {' '.join(f'{x:.1f}' for x in lat)}", file=sys.stderr)

    t_cmp = time.perf_counter()
    bad = sum(1 for k, r, _ in out if not _exact(r, files[k], name))
    gaps = decode_loop.compare(recs, [(k, info) for k, _, info in out], mode_name, ctx.device)
    n_signal = tracked.signal_symbols(len(oracle.legacy_payload(files[0], name)), mode_name)
    tap = taps.by_name["tracked_core"]
    kept = _kept(tap, n_signal) if tap.kept else None
    if kept is not None:
        kept["x"] = kept["x"].to(ctx.device)
        gaps.update(track_gaps(kept, mode_name, n_signal))
    else:  # no call reached the tracker: nothing of it to compare, and the decodes fail
        gaps.update({"tau_gap": float("inf"), "track_bit_gap": 1.0, "track_len_gap": n_signal})
    print(f"compared in {time.perf_counter() - t_cmp:.3f} s ({len(tap.kept)} tracker calls of {tap.calls})",
          file=sys.stderr)
    limits = ctx.config["limits"]
    found = {"bad_decodes": bad + gaps.pop("undetected"), **gaps}
    counts = {"decodes": traced}
    if tr.shift_ns is not None:
        counts["clock_shift_ns"] = tr.shift_ns
    readings = Readings(
        mode=mode, counts=counts, shapes=taps.shapes(), latencies_ms=lat, events=tr.events, window_s=tr.window_s,
        peaks=roofline.PEAKS.get(torch.cuda.get_device_name(0)) if ctx.device != "cpu" else None)

    def control(subject) -> dict:
        res = decode_loop.compare(recs, [(k, None) for k in sorted({k for k, _, _ in out})], mode_name,
                                  ctx.device, subject)
        res.pop("undetected")
        if kept is not None:
            res.update(track_gaps(kept, mode_name, n_signal, subject))
        return res

    return Outcome(
        metrics={"setup_s": setup_s, "decode_ms": (t_w1 - t_w0) / len(out) * 1e3},
        checks={k: (v, limits[k]) for k, v in found.items() if k in limits},
        attempted=len(out), failed=bad, readings=readings, memory_peak_bytes=peak,
        breakdown=trace.breakdown(tr.events) if tr.events is not None else None, control=control)
