"""The chunked receiver's loop: ``api.decode_chunked(recording, mode)`` of
host recordings of whole chunked transfers, one closed-loop caller, until
the window has lasted ``--seconds``.

Traffic, made from the seed at set-up by the benchmark's own transmitter
(``reference.oracle``) on the card: a pool of recordings, each one seeded
file sent as the metadata frame and one data frame a chunk with the
transmitter's own silences (the wire layout of app.js:201-303), behind a
seeded lead-in of silence, under AWGN over the whole recording, then
brought to the host as float32 (``feed: host``), where the receiver takes
it in blocks.

Compared after the window, outside the set-up: every decode's file, name
and chunks against the seeded payload (``bad_chunks``: missing, CRC-failed
and wrong chunks, a wrong name or total), and every frame the receiver cut
against the reference's receive of the same recording
(``reference.chunked``): its refined start (``start_gap``), the refine's
metric (``fine_gap``) and the |H| of the channel the frame decode hands
the streaming demod (``ce_gap``). Taps at names the receiver and the
decoder look up (``receiver._refine_window``, ``decoder.stream_demod``,
``StreamingReceiver._demodulate_frame``) keep those numbers as device
values and read them after the window.

A ``--trace 1`` run profiles the card and turns the program's span recorder
on over the window's first ``TRACED_DECODES`` decodes, whole.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from audio_modem_tpu_torch import api, decoder
from audio_modem_tpu_torch.runtime import receiver
from benchmark import spans, trace
from benchmark.harness import Context, Outcome, Readings
from benchmark.reference import chunked, oracle, roofline
from benchmark.reference.profiles import MODES, Mode

# Decodes the device trace covers: one decode of 1 MiB launches ~10^5 device
# operations, and reading a longer trace back would not fit a run.
TRACED_DECODES = 1


def make_pool(mode: Mode, n: int, file_bytes: int, file_name: str, lead: list, snr_db: float, seed: int,
              device) -> tuple[torch.Tensor, list[bytes]]:
    """(recordings: float32 [n, T] on ``device``, files) of ``n`` seeded
    transfers (see the module docstring). Lead-ins come from a NumPy
    generator on the seed, payloads and noise from a torch.Generator on the
    device; the noise's power is ``snr_db`` under the transfer's mean power,
    its silences included."""
    p = mode.profile
    chunk = mode.chunk_size
    if file_bytes % chunk:
        raise ValueError(f"file_bytes must be a whole number of {chunk}-byte chunks, got {file_bytes}")
    n_chunks = file_bytes // chunk
    lead_in = np.random.default_rng(seed).integers(lead[0], lead[1] + 1, size=n)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    files = torch.randint(0, 256, (n, file_bytes), generator=gen, device=device, dtype=torch.uint8)
    post = p.silence_post_chunk()
    meta_payload = oracle.metadata_payload(n_chunks, file_bytes, chunk, file_name)
    meta = oracle.frames(torch.tensor(list(meta_payload), dtype=torch.uint8, device=device)[None], mode,
                         p.silence_pre_chunk(True), post)[0]
    seqs = torch.arange(n_chunks, device=device)
    body = meta.shape[0] + oracle.frame_len(11 + chunk, mode, p.silence_pre_chunk(False), post) * n_chunks
    t = int(lead_in.max()) + body + chunked.BLOCK  # a block of noise after the last frame
    sig = torch.zeros((n, t), dtype=torch.float32, device=device)
    for i in range(n):
        payloads = oracle.data_chunk_payloads(files[i].reshape(n_chunks, chunk), seqs)
        data = oracle.frames(payloads, mode, p.silence_pre_chunk(False), post).reshape(-1)
        a = int(lead_in[i])
        sig[i, a : a + meta.shape[0]] = meta
        sig[i, a + meta.shape[0] : a + body] = data
        power = float((sig[i, a : a + body].to(torch.float64) ** 2).mean())
        sig[i] += torch.randn(t, generator=gen, device=device) * (power / 10 ** (snr_db / 10)) ** 0.5
    return sig, [bytes(row) for row in files.cpu().numpy()]


class FrameTaps:
    """Per decode: each refine's outputs, and for each frame the receiver
    cut its start, its refine (index, or -1) and the channel its decode
    handed the streaming demod (index, or -1), as device values; in the
    traced slice, each streaming demod call's shape for the roofline."""

    def __init__(self):
        self.record_shapes = False
        self.shapes: list[dict] = []
        self._reset()

    def _reset(self) -> None:
        self.refines: list = []
        self.channels: list = []
        self.frames: list[tuple[int, int, int]] = []

    def take(self) -> tuple[list, list, list]:
        out = (self.frames, self.refines, self.channels)
        self._reset()
        return out

    def __enter__(self):
        taps = self
        self._inner = (receiver._refine_window, decoder.stream_demod, receiver.StreamingReceiver._demodulate_frame)
        refine_window, stream_demod, demodulate_frame = self._inner

        def refine(window, coarse_rel, n_valid, profile):
            out = refine_window(window, coarse_rel, n_valid, profile)
            taps.refines.append(out[1])
            return out

        def demod(data, ch_re, ch_im, scale, mode, n_sym):
            taps.channels.append((ch_re[0], ch_im[0]))
            if taps.record_shapes:
                taps.shapes.append({"b": data.shape[0], "n_sym": n_sym})
            return stream_demod(data, ch_re, ch_im, scale, mode, n_sym)

        def frame(rx, *args, **kwargs):
            refined = rx.state is not receiver.RecvState.PREAMBLE_DETECTED
            n_ch, start = len(taps.channels), rx.preamble_pos
            out = demodulate_frame(rx, *args, **kwargs)
            taps.frames.append((start, len(taps.refines) - 1 if refined else -1,
                                n_ch if len(taps.channels) > n_ch else -1))
            return out

        receiver._refine_window, decoder.stream_demod = refine, demod
        receiver.StreamingReceiver._demodulate_frame = frame
        return self

    def __exit__(self, *exc):
        receiver._refine_window, decoder.stream_demod, receiver.StreamingReceiver._demodulate_frame = self._inner
        return False


def frame_numbers(frames: list, refines: list, channels: list) -> tuple[list, list, list]:
    """(starts, fine metrics, |H| rows) of one decode's frames, read back."""
    fine = torch.stack(refines).to(torch.float64).cpu().numpy() if refines else np.zeros(0)
    mags = []
    if channels:
        re = torch.stack([c[0] for c in channels]).to(torch.float64)
        im = torch.stack([c[1] for c in channels]).to(torch.float64)
        mags = list(torch.sqrt(re * re + im * im).cpu().numpy())
    return ([s for s, _, _ in frames], [float(fine[r]) if r >= 0 else math.nan for _, r, _ in frames],
            [mags[c] if c >= 0 else None for _, _, c in frames])


def bad_chunks(result, file: bytes, name: str, chunk: int) -> int:
    """Chunks of one decode that are missing, failed their CRC or differ
    from the payload, and one more for a wrong name, total or size; every
    chunk and the metadata where the decode returned no file."""
    n_chunks = len(file) // chunk
    if getattr(result, "missing_chunks", None) is None:
        return n_chunks + 1
    missing = set(result.missing_chunks)
    bad = len(missing) + result.crc_errors
    bad += (result.file_name != name) + (result.total_chunks != n_chunks) + (len(result.data) != len(file))
    for i in range(n_chunks):
        if i not in missing and result.data[i * chunk : (i + 1) * chunk] != file[i * chunk : (i + 1) * chunk]:
            bad += 1
    return bad


def run(ctx: Context) -> Outcome:
    mode_name = ctx.param("mode")
    mode = MODES[mode_name]
    if ctx.param("feed") != "host":
        raise ValueError("api.decode_chunked takes host audio: feed must be host")
    t_pool = time.perf_counter()
    recs, files = make_pool(mode, ctx.param("pool"), ctx.param("file_bytes"), ctx.param("file_name"),
                            ctx.param("lead_in"), ctx.param("snr_db"), ctx.seed, ctx.device)
    recs = recs.cpu()
    feed = [r.numpy() for r in recs]
    if ctx.device != "cpu":  # the peak from here on: the program's, not the transmitter's scratch
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    api.decode_chunked(feed[0], mode_name, device=ctx.device)  # builds and loads the kernels
    t_ready = time.perf_counter()
    setup_s = t_ready - ctx.t_start
    print(f"setup split s: before the pool {t_pool - ctx.t_start:.3f}, pool {t_warm - t_pool:.3f}, "
          f"warm decode {t_ready - t_warm:.3f}", file=sys.stderr)

    recorder = spans._recorder() if ctx.trace else None
    lat, out = [], []
    with FrameTaps() as taps, trace.DeviceTrace(ctx.trace, ctx.device) as tr:
        taps.record_shapes = tr.active
        if recorder is not None:
            recorder.enable()
        t_w0 = time.perf_counter()
        while time.perf_counter() - t_w0 < ctx.seconds:
            k = len(out) % len(feed)
            t = time.perf_counter()
            result = api.decode_chunked(feed[k], mode_name, device=ctx.device)
            lat.append((time.perf_counter() - t) * 1e3)
            out.append((k, result, taps.take()))
            if tr.active and len(out) == TRACED_DECODES:
                if recorder is not None:
                    recorder.disable()
                taps.record_shapes = False
                t_read = time.perf_counter()
                tr.stop()
                print(f"device trace: {len(tr.events)} events, read in {time.perf_counter() - t_read:.3f} s",
                      file=sys.stderr)
        t_w1 = time.perf_counter()
        if recorder is not None:
            recorder.disable()
    peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0
    traced = min(len(out), TRACED_DECODES) if ctx.trace else 0
    print(f"decode_chunked ms: {' '.join(f'{x:.1f}' for x in lat)}", file=sys.stderr)

    t_cmp = time.perf_counter()
    name, chunk = ctx.param("file_name"), mode.chunk_size
    refs = {k: chunked.receive(recs[k], mode_name) for k in sorted({k for k, _, _ in out})}
    bad, gaps, failed = 0, {"start_gap": 0.0, "fine_gap": 0.0, "ce_gap": 0.0}, 0
    for k, result, taken in out:
        n_bad = bad_chunks(result, files[k], name, chunk)
        bad += n_bad
        failed += n_bad > 0
        for key, v in chunked.frame_gaps(*frame_numbers(*taken), refs[k].frames).items():
            gaps[key] = max(gaps[key], v)
    for k, ref in refs.items():
        if ref.file() != files[k] or ref.file_name != name:
            print(f"the reference did not receive recording {k} whole: missing {ref.missing}", file=sys.stderr)
    print(f"compared in {time.perf_counter() - t_cmp:.3f} s", file=sys.stderr)
    limits = ctx.config["limits"]
    found = {"bad_chunks": bad, **gaps}
    n_frames = sum(len(taken[0]) for _, _, taken in out[:traced])
    readings = Readings(
        mode=mode, counts={"decodes": traced, "frames": n_frames}, shapes={"stream_demod": taps.shapes},
        latencies_ms=lat, events=tr.events, window_s=tr.window_s,
        peaks=roofline.PEAKS.get(torch.cuda.get_device_name(0)) if ctx.device != "cpu" else None)

    def control(subject) -> dict:
        res = {"start_gap": 0.0, "fine_gap": 0.0, "ce_gap": 0.0, "bad_chunks": 0}
        for k, ref in refs.items():
            got = chunked.receive(recs[k], mode_name, subject)
            res["bad_chunks"] += len(got.missing) + got.crc_errors + (got.file() != files[k])
            for key, v in chunked.compare(got, ref).items():
                res[key] = max(res[key], v)
        return res

    return Outcome(
        metrics={"setup_s": setup_s, "decode_ms": (t_w1 - t_w0) / len(out) * 1e3},
        checks={k: (v, limits[k]) for k, v in found.items() if k in limits},
        attempted=len(out), failed=failed, readings=readings, memory_peak_bytes=peak,
        breakdown=trace.breakdown(tr.events) if tr.events is not None else None, control=control)
