"""The port's runtime/ingest.py against the JAX package's on the same bytes
(device="cpu"): PCM block reading, the level meter, the paced writer,
``play``'s PCM (within the TX tolerance 3e-5 in f32, 1 LSB in s16) and
``listen``'s result and stream counters over a pipe; then the paced lossy
duplex ARQ scenario of tests/test_ingest.py on the port."""

from __future__ import annotations

import dataclasses
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.runtime import ingest as jingest
from audio_modem_tpu_torch import arq, channel, framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.runtime import ingest

torch.set_num_threads(2)

TX_TOL = 3e-5  # TX waveform tolerance (COVERAGE.md #12)
SPEED = 200.0  # pacing faster than real time: same code path, scaled clock


def _pcm(samples: np.ndarray, fmt: str) -> bytes:
    buf = io.BytesIO()
    jingest.PacedWriter(buf, fmt=fmt, speed=0.0).write(samples)
    return buf.getvalue()


@pytest.fixture(scope="module")
def chunked_signal():
    """A 3-chunk QPSK transfer as the JAX package's TX synthesizes it."""
    data = np.random.default_rng(11).bytes(2 * 2048 + 700)
    sig = np.concatenate([np.asarray(f) for f in japi.encode_chunked(data, JMODES["QPSK"], "live.bin")])
    return data, sig


@pytest.mark.parametrize("fmt, torn", [("f32", 0), ("f32", 3), ("s16", 0), ("s16", 1)])
def test_read_pcm_blocks_matches(fmt, torn):
    rng = np.random.default_rng(3)
    raw = _pcm((rng.standard_normal(10_000) * 0.5).astype(np.float32), fmt) + bytes(torn)
    ours = list(ingest.read_pcm_blocks(io.BytesIO(raw), block=4096, fmt=fmt))
    ref = list(jingest.read_pcm_blocks(io.BytesIO(raw), block=4096, fmt=fmt))
    assert [len(b) for b in ours] == [len(b) for b in ref] == [4096, 4096, 1808]
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_level_meter_matches_with_inf_and_nan():
    rng = np.random.default_rng(4)
    blocks = [(rng.standard_normal(4096) * s).astype(np.float32) for s in (0.1, 1.5, 0.01)]
    blocks.insert(1, np.array([np.inf, -np.inf, np.nan, 0.5], np.float32))
    blocks.append(np.zeros(0, np.float32))
    ours, ref = ingest.LevelMeter(), jingest.LevelMeter()
    for b in blocks:
        ours.update(b)
        ref.update(b)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.clipping == ref.clipping and np.isfinite(ours.rms)


@pytest.mark.parametrize("fmt", ["f32", "s16"])
def test_paced_writer_bytes_identical(fmt):
    rng = np.random.default_rng(5)
    samples = (rng.standard_normal(9000) * 0.8).astype(np.float32)  # s16 clips the tails
    assert (np.abs(samples) > 1.0).any()
    ours, ref = io.BytesIO(), io.BytesIO()
    ingest.PacedWriter(ours, fmt=fmt, speed=0.0).write(samples, block=1000)
    jingest.PacedWriter(ref, fmt=fmt, speed=0.0).write(samples, block=1000)
    assert ours.getvalue() == ref.getvalue()


def _play_both(data: bytes, fmt: str, **kw):
    ours, ref = io.BytesIO(), io.BytesIO()
    frames_ours, frames_ref = [], []
    n = ingest.play(data, ours, "QPSK", "p.bin", fmt=fmt, speed=0.0, device="cpu",
                    on_frame=lambda s, t: frames_ours.append((s, t)), **kw)
    n_ref = jingest.play(data, ref, "QPSK", "p.bin", fmt=fmt, speed=0.0,
                         on_frame=lambda s, t: frames_ref.append((s, t)), **kw)
    assert n == n_ref and frames_ours == frames_ref
    return ours.getvalue(), ref.getvalue()


@pytest.mark.parametrize("fmt, chunked", [("f32", True), ("s16", True), ("f32", False)])
def test_play_pcm_matches(fmt, chunked):
    data = np.random.default_rng(6).bytes(2048 + 300)
    ours, ref = _play_both(data, fmt, chunked=chunked)
    assert len(ours) == len(ref)
    if fmt == "f32":
        a, b = np.frombuffer(ours, np.float32), np.frombuffer(ref, np.float32)
        assert np.abs(a - b).max() <= TX_TOL
    else:
        a, b = np.frombuffer(ours, np.int16).astype(np.int32), np.frombuffer(ref, np.int16).astype(np.int32)
        assert np.abs(a - b).max() <= 1


def _listen_over_pipe(module, pcm: bytes, mode, fmt: str, **kw):
    r_fd, w_fd = os.pipe()
    reader, writer = os.fdopen(r_fd, "rb"), os.fdopen(w_fd, "wb")

    def tx():
        for off in range(0, len(pcm), 50_000):
            writer.write(pcm[off : off + 50_000])
        writer.close()

    files = {}
    t = threading.Thread(target=tx, daemon=True)
    t.start()
    report = module.listen(reader, mode, fmt=fmt, on_file=lambda n, d: files.__setitem__(n, d), **kw)
    t.join(timeout=30)
    reader.close()
    return report, files


def _stats(report) -> dict:
    d = dataclasses.asdict(report.stats)
    d.pop("started_at")
    return d


def _same_listen(pcm: bytes, fmt: str):
    ours, files = _listen_over_pipe(ingest, pcm, "QPSK", fmt, device="cpu")
    ref, ref_files = _listen_over_pipe(jingest, pcm, JMODES["QPSK"], fmt)
    assert _stats(ours) == _stats(ref)
    assert (ours.blocks, ours.samples) == (ref.blocks, ref.samples)
    assert files == ref_files
    if isinstance(ref.result, jframing.FrameError):
        assert isinstance(ours.result, framing.FrameError) and ours.result.error == ref.result.error
    else:
        assert dataclasses.asdict(ours.result) == dataclasses.asdict(ref.result)
    return ours


@pytest.mark.parametrize("fmt", ["f32", "s16"])
def test_listen_chunked_over_a_pipe(chunked_signal, fmt):
    data, sig = chunked_signal
    ours = _same_listen(_pcm(sig, fmt), fmt)
    assert ours.result.complete and ours.result.data == data and ours.result.file_name == "live.bin"
    assert ours.realtime_factor > 0


def test_listen_legacy_frame_over_s16():
    """A legacy frame (play with chunked=False) is not a chunk frame: both
    receivers end without metadata, with the same counters."""
    buf = io.BytesIO()
    jingest.play(b"legacy payload" * 20, buf, JMODES["QPSK"], "l.bin", fmt="s16", speed=0.0, chunked=False)
    ours = _same_listen(buf.getvalue(), "s16")
    assert isinstance(ours.result, framing.FrameError)


def test_listen_eof_mid_frame(chunked_signal):
    """The writer stops inside the second data frame: both report the same
    partial transfer."""
    data, sig = chunked_signal
    cut = len(sig) * 2 // 3
    ours = _same_listen(_pcm(sig[:cut], "f32"), "f32")
    res = ours.result
    assert not res.complete and res.missing_chunks and res.received_chunks >= 1
    assert res.data[:2048] == data[:2048]


def test_arq_over_paced_lossy_duplex():
    """Selective repeat over channels with real link timing (the scenario
    of tests/test_ingest.py): each direction takes wall-clock time in
    proportion to the signal's length; the forward link loses a span on
    its first pass only."""
    mode = MODES["QPSK"]
    payload = np.random.default_rng(3).bytes(3 * mode.chunk_size)
    link_time = [0.0]

    def paced(spec):
        def ch(sig):
            dt = len(sig) / (44100 * SPEED)
            link_time[0] += dt
            time.sleep(dt)
            return channel.apply_channel_np(sig, spec, seed=7, device="cpu")
        return ch

    state = {"first": True}
    fwd_clean = paced(channel.ChannelSpec(snr_db=30.0))

    def fwd(sig):
        out = fwd_clean(sig)
        if state["first"]:
            state["first"] = False
            out = out.copy()
            third = len(out) // 3
            out[third : third + 44100 // 2] = 0.0
        return out

    t0 = time.perf_counter()
    report = arq.run_arq_session(payload, mode, "arq.bin", forward=fwd,
                                 backward=paced(channel.ChannelSpec(snr_db=30.0)), device="cpu")
    elapsed = time.perf_counter() - t0
    assert report.complete and report.data == payload
    assert report.rounds >= 2 and len(report.chunks_sent_per_round) >= 2
    assert elapsed >= 0.8 * link_time[0]


def test_play_raises_on_the_caller_when_synthesis_fails(monkeypatch):
    """A failure while the worker builds the next frame reaches the caller;
    the writer does not hang and nothing is retried elsewhere."""
    from audio_modem_tpu_torch import api

    real = api.encode_chunked

    def failing(*args, **kw):
        gen = real(*args, **kw)
        yield next(gen)
        raise RuntimeError("synthesis failed")

    monkeypatch.setattr(api, "encode_chunked", failing)
    out = io.BytesIO()
    with pytest.raises(RuntimeError, match="synthesis failed"):
        ingest.play(b"x" * 3000, out, "QPSK", speed=0.0, device="cpu")
    assert len(out.getvalue()) > 0  # the metadata frame was written first


def test_listen_and_play_default_to_the_card():
    import inspect

    for fn in (ingest.listen, ingest.play):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ingest.listen(io.BytesIO(b""), "QPSK")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ingest.play(b"abc", io.BytesIO(), "QPSK", speed=0.0)
