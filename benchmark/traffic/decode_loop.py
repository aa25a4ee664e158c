"""The one-shot decoder's loop: ``api.decode(recording, mode)`` of host
recordings, one closed-loop caller, until the window has lasted
``--seconds``.

Traffic, made from the seed at set-up by the benchmark's own transmitter
on the card, in one batch: a pool of seeded legacy frames (one file each),
under AWGN where the configuration says so, decoded in turns, as host
float32 arrays (``feed: host``) or as float32 rows left on the card
(``feed: card``).

Compared after the window: every decode's file against its seeded
payload, and its frame start, refined metric and channel magnitude
(``DecodeInfo``) against the reference's decode of the same recording.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from audio_modem_tpu_torch import api, decoder
from benchmark import capture, trace
from benchmark.harness import Context, Outcome, Readings
from benchmark.reference import oracle, roofline
from benchmark.reference.profiles import MODES

# The device trace covers the window's first seconds only: a longer trace of
# ~30 events a decode takes longer to read than a run may last.
TRACE_SLICE_S = 8.0


def make_pool(mode_name: str, n: int, size: int, file_name: str, snr_db: float, seed: int, device) -> tuple:
    """(recordings: float32 [n, T] on ``device``, payloads: bytes) of ``n``
    seeded files; ``snr_db`` None leaves the channel clean."""
    mode = MODES[mode_name]
    p = mode.profile
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    data = torch.randint(0, 256, (n, size), generator=gen, device=device, dtype=torch.uint8).cpu().numpy()
    files = [row.tobytes() for row in data]
    pl = torch.tensor(np.frombuffer(b"".join(oracle.legacy_payload(f, file_name) for f in files), np.uint8)
                      .reshape(n, -1), device=device)
    x = oracle.frames(pl, mode, p.silence_pre_legacy(), p.silence_post_legacy())
    if snr_db is not None:
        power = (x.to(torch.float64) ** 2).mean(dim=1, keepdim=True)
        x += torch.randn(x.shape, generator=gen, device=device) * (power / 10 ** (snr_db / 10)).sqrt().float()
    return x, files


def compare(recs: list, results: list, mode_name: str, device, subject=None) -> dict:
    """The decodes' starts, fine metrics and channel magnitudes against the
    reference's receive of the same recording (widest gaps; the magnitude's
    as a share of the largest reference bin). ``results`` holds
    (recording index, DecodeInfo); ``subject`` a ``Precision`` judges the
    reference computed in it instead."""
    res = {"start_gap": 0.0, "fine_gap": 0.0, "ce_gap": 0.0, "undetected": 0}
    refs = {}
    p = MODES[mode_name].profile
    for i in sorted({i for i, _ in results}):
        x = recs[i : i + 1].to(device)
        nv, mp = torch.tensor([x.shape[1]], device=device), torch.zeros(1, dtype=torch.int64, device=device)
        r = {k: v[0] for k, v in oracle.receive(x, nv, mp, p).items()}
        s = {k: v[0] for k, v in oracle.receive(x, nv, mp, p, subject).items()} if subject is not None else None
        refs[i] = (r, s)
    for i, info in results:
        r, s = refs[i]
        if s is not None:
            info = decoder.DecodeInfo(int(s["start"]), int(s["coarse"]), float(s["fine"]),
                                      s["ch"].abs().cpu().numpy())
        if info is None or not bool(r["detected"]):
            res["undetected"] += 1
            continue
        mag = r["ch"].abs().cpu().numpy()
        res["start_gap"] = max(res["start_gap"], float(abs(info.preamble_idx - int(r["start"]))))
        res["fine_gap"] = max(res["fine_gap"], abs(float(info.fine_metric) - float(r["fine"])))
        if info.channel_mag is not None:  # the xcorr re-acquisition reports no channel
            gap = np.abs(np.asarray(info.channel_mag, np.float64) - mag).max() / mag.max()
            res["ce_gap"] = max(res["ce_gap"], float(gap))
    return res


def run(ctx: Context) -> Outcome:
    mode_name = ctx.param("mode")
    mode = MODES[mode_name]
    t_pool = time.perf_counter()
    recs, files = make_pool(mode_name, ctx.param("pool"), ctx.param("file_bytes"), ctx.param("file_name"),
                            ctx.param("snr_db"), ctx.seed, ctx.device)
    if ctx.param("feed") == "host":  # the host holds the recordings, and the card only what the program puts there
        recs = recs.cpu()
        feed = [r.numpy() for r in recs]
    else:
        feed = list(recs)
    if ctx.device != "cpu":  # the peak from here on: the pool and the program, not the transmitter's scratch
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    for rec in feed:  # every recording once: builds and loads the kernels, fills the allocators
        api.decode(rec, mode_name, device=ctx.device)
    t_ready = time.perf_counter()
    setup_s = t_ready - ctx.t_start
    print(f"setup split s: before the pool {t_pool - ctx.t_start:.3f}, pool {t_warm - t_pool:.3f}, "
          f"warm decodes {t_ready - t_warm:.3f}", file=sys.stderr)

    lat, out = [], []
    targets = {"decode_fused": (decoder, "decode_fused")}
    traced = None  # decodes in the traced slice
    with capture.Taps(ctx.seed, 0, ctx.trace, targets) as taps, trace.DeviceTrace(ctx.trace, ctx.device) as tr:
        t_w0 = time.perf_counter()
        while (now := time.perf_counter()) - t_w0 < ctx.seconds:
            if tr.active and now - t_w0 >= TRACE_SLICE_S:
                tr.stop()
                taps.stop_shapes()
                traced = len(out)
            k = len(out) % len(recs)
            t = time.perf_counter()
            result, info = api.decode(feed[k], mode_name, device=ctx.device)
            lat.append((time.perf_counter() - t) * 1e3)
            out.append((k, result, info))
        t_w1 = time.perf_counter()
    traced = len(out) if traced is None else traced
    peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0

    by_rec = {k: float(np.mean([ms for (j, _, _), ms in zip(out, lat) if j == k])) for k in {j for j, _, _ in out}}
    print("decode ms by recording " + " ".join(f"{by_rec[k]:.3f}" for k in sorted(by_rec))
          + "; quantiles 10/50/90 " + " ".join(f"{np.percentile(lat, q):.3f}" for q in (10, 50, 90)),
          file=sys.stderr)
    name = ctx.param("file_name")
    bad = sum(1 for k, r, _ in out
              if getattr(r, "data", None) != files[k] or not getattr(r, "crc_valid", False)
              or getattr(r, "file_name", None) != name)
    gaps = compare(recs, [(k, info) for k, _, info in out], mode_name, ctx.device)
    limits = ctx.config["limits"]
    found = {"bad_decodes": bad + gaps.pop("undetected"), **gaps}
    # the host-clock quantiles leave out the traced slice, whose profiler adds host work to every launch
    readings = Readings(
        mode=mode, counts={"decodes": traced}, shapes=taps.shapes(), latencies_ms=lat[traced:] or lat,
        events=tr.events, window_s=tr.window_s,
        peaks=roofline.PEAKS.get(torch.cuda.get_device_name(0)) if ctx.device != "cpu" else None)
    return Outcome(
        metrics={"setup_s": setup_s, "decode_ms": (t_w1 - t_w0) / len(out) * 1e3},
        checks={k: (v, limits[k]) for k, v in found.items() if k in limits},
        attempted=len(out), failed=bad, readings=readings, memory_peak_bytes=peak,
        breakdown=trace.breakdown(tr.events) if tr.events is not None else None,
        control=lambda subject: compare(recs, [(k, None) for k in sorted({k for k, _, _ in out})], mode_name,
                                        ctx.device, subject))
