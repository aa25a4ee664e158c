"""The port's BatchReceiver against the JAX package's at scale, on the same
numpy blocks (device="cpu"): BASELINE config 5's 64 live streams through
the staged, turbo and device-ingest runtimes, the cadence-predicted rounds,
the speculative fetch pipeline, and a K-round window that wraps the device
ring. What is held equal is set out in tests/test_torch_multi_receiver.py,
whose helpers this file uses."""

import os

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import channel
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.parallel import multi_receiver as mr
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.parallel import multi_receiver as jmr
from test_torch_multi_receiver import assert_files, chunk_frames, chunked, feed, run_pair

torch.set_num_threads(2)


class TestBatchReceiverScale:
    """64 live streams through the batched runtime (host FSM + device),
    multi-frame files, lockstep blocks."""

    def _run(self, n_streams, per_stream_bytes, block, scan_bucket, seed=83, window_decode=False):
        rng = np.random.default_rng(seed)
        # distinct data across 8 signals, tiled across the streams
        n_sig = min(8, n_streams)
        files = [rng.bytes(per_stream_bytes) for _ in range(n_sig)]
        signals = [chunked(f, "QPSK", f"s{i}.bin", batch=32) for i, f in enumerate(files)]
        _, rx = run_pair(
            "QPSK", n_streams, [signals[i % n_sig] for i in range(n_streams)], block,
            scan_bucket=scan_bucket, window_decode=window_decode,
        )
        assert_files(rx, files)
        return rx

    def test_64_streams_multiframe_large_blocks(self):
        """64 streams x ~40 KB (20 data frames a stream), 32k-sample blocks,
        a widened scan bucket: the staged machine, kernel B's path."""
        self._run(64, 40_000, block=32768, scan_bucket=65536)

    @pytest.mark.skipif("AMT_SOAK" not in os.environ, reason="multi-minute soak; set AMT_SOAK=1")
    def test_soak_64_streams_50mb(self):
        """>= 50 MB aggregate over 64 streams through the batched runtime."""
        self._run(64, 820_000, block=65536, scan_bucket=65536)

    def test_64_streams_turbo_window_decode(self):
        """Turbo path: the full receive over each window; identical files."""
        self._run(64, 40_000, block=32768, scan_bucket=65536, window_decode=True)

    def test_turbo_staggered_and_tail(self):
        """Turbo with staggered starts and a tail frame shorter than the
        minimum window (drained by the staged machine in flush)."""
        mode = MODES["QPSK"]
        rng = np.random.default_rng(89)
        files = [rng.bytes(mode.chunk_size * 2 + 77) for _ in range(4)]
        signals = []
        for i, f in enumerate(files):
            lead = (rng.standard_normal(5000 * i) * 0.002).astype(np.float32)
            signals.append(np.concatenate([lead, chunked(f, "QPSK", f"t{i}")]))
        # stream 3's noise edge at 14,959 is detected in the last est_len
        # samples of its window: the JAX package stalls there until flush
        _, rx = run_pair("QPSK", 4, signals, 8192, stalled=(3,), window_decode=True)
        assert_files(rx, files)

    def test_turbo_predicted_slots_under_clock_drift(self):
        """K-frame rounds predict slot k's start from slot k-1's + the
        cadence; at +-100 ppm the prediction drifts ~3 samples a frame,
        which the refine's +-3 CP radius absorbs. 12 chunks a stream with
        frames_per_round=4: several multi-slot rounds through the drift.
        Drift and 30 dB of noise from the port's channel module."""
        mode = MODES["QPSK"]
        rng = np.random.default_rng(97)
        files = [rng.bytes(mode.chunk_size * 12) for _ in range(2)]
        signals = [
            channel.apply_channel_np(
                chunked(f, "QPSK", f"c{i}", batch=16), channel.ChannelSpec(clock_ppm=ppm, snr_db=30.0),
                seed=11 + i, device="cpu",
            )
            for i, (f, ppm) in enumerate(zip(files, (100.0, -100.0)))
        ]
        _, rx = run_pair("QPSK", 2, signals, 32768, scan_bucket=65536, window_decode=True, frames_per_round=4)
        assert_files(rx, files)
        assert rx.timer.report()["consume_classify"]["calls"] >= 2

    def test_64_streams_device_ingest(self):
        """Device-resident ring: the same files, blocks fed as tensors on
        the receiver's device (arrays on the JAX side's)."""
        rng = np.random.default_rng(91)
        files = [rng.bytes(8_000) for _ in range(4)]
        signals = [chunked(f, "QPSK", f"d{i}.bin", batch=8) for i, f in enumerate(files)]
        _, rx = run_pair(
            "QPSK", 16, [signals[i % 4] for i in range(16)], 16384, tensors=True,
            scan_bucket=65536, device_ingest=True,
        )
        assert_files(rx, files)

    def test_scan_free_predicted_rounds(self):
        """After the first scan-ful round seeds the cadence prediction,
        the K-frame rounds skip the slot-0 scan: pred rounds fire, carry
        most of the data, and the files are exact."""
        mode = MODES["QPSK"]
        rng = np.random.default_rng(103)
        files = [rng.bytes(mode.chunk_size * 16) for _ in range(2)]
        signals = [chunked(f, "QPSK", f"p{i}.bin", batch=16) for i, f in enumerate(files)]
        _, rx = run_pair("QPSK", 2, signals, 32768, scan_bucket=65536, device_ingest=True, frames_per_round=4)
        assert_files(rx, files)
        rep = rx.timer.report()
        assert rep.get("pred_dispatch", {}).get("samples", 0) > 0, rep
        assert rep["pred_dispatch"]["samples"] >= rep.get("multi_dispatch", {}).get("samples", 0), rep

    def test_predicted_round_survives_sender_pause(self):
        """A silence gap mid-transfer breaks the cadence: the predicted
        slot 0 misses, the receiver rescans from its last consumed
        position, and every chunk arrives."""
        mode = MODES["QPSK"]
        f = np.random.default_rng(107).bytes(mode.chunk_size * 10)
        frames = chunk_frames(f, "QPSK", "g.bin", batch=16)
        sig2 = np.concatenate(frames[:6] + [np.zeros(60_000, np.float32)] + frames[6:])
        _, rx = run_pair("QPSK", 2, [sig2, sig2], 32768, scan_bucket=65536, device_ingest=True, frames_per_round=4)
        assert_files(rx, [f])


class TestSpeculativePipeline:
    """Cadence-predicted rounds dispatched with their copy to the host under
    way and consumed up to pipeline_depth rounds later; consumption
    validates against the speculated positions and rolls a stream back on
    any deviation. The per-stream generations are held equal too."""

    def _transfer(self, n_chunks: int, pipeline_depth: int, seed: int = 211):
        mode = MODES["QPSK"]
        f = np.random.default_rng(seed).bytes(mode.chunk_size * n_chunks)
        sig = chunked(f, "QPSK", "s.bin", batch=16)
        _, rx = run_pair(
            "QPSK", 2, [sig, sig], 32768, scan_bucket=65536, device_ingest=True,
            frames_per_round=4, pipeline_depth=pipeline_depth,
        )
        return f, rx

    def test_pipelined_steady_state(self):
        """A long transfer with a deep pipeline: pipe_fetch rounds fire,
        predicted rounds dominate, every byte arrives."""
        f, rx = self._transfer(32, pipeline_depth=4)
        assert_files(rx, [f])
        rep = rx.timer.report()
        assert "pipe_fetch" in rep, rep
        assert rep["pred_dispatch"]["samples"] >= rep.get("multi_dispatch", {}).get("samples", 0), rep

    def test_depth_zero_disables(self):
        """pipeline_depth=0 keeps every fetch synchronous (no pipe_fetch
        stage) and decodes identically."""
        f, rx = self._transfer(12, pipeline_depth=0)
        assert_files(rx, [f])
        assert "pipe_fetch" not in rx.timer.report()

    def test_rollback_on_cadence_break(self):
        """A silence gap deviates from the speculated cadence while rounds
        are in flight: the stream rolls back (stale results discarded by
        generation), rescans from truth, and delivers every chunk."""
        mode = MODES["QPSK"]
        f = np.random.default_rng(223).bytes(mode.chunk_size * 20)
        frames = chunk_frames(f, "QPSK", "g.bin", batch=24)
        sig = np.concatenate(frames[:8] + [np.zeros(60_000, np.float32)] + frames[8:])
        _, rx = run_pair(
            "QPSK", 2, [sig, sig], 32768, scan_bucket=65536, device_ingest=True,
            frames_per_round=4, pipeline_depth=6,
        )
        assert_files(rx, [f])
        assert any(s.gen > 0 for s in rx.streams), "no speculative rollback occurred"


def test_k_round_window_wraps_the_ring(monkeypatch):
    """A transfer longer than the device ring: the write position wraps and
    at least one K-frame round's window crosses the end of the buffer
    (cut in two by _ring_gather). Files and state equal the JAX package's
    shift ring, which never wraps."""
    wrapped = []
    inner = mr._ring_gather

    def gather(ring, rows, rel_starts, length):
        pos = [(ring.total_written + int(r)) % ring.capacity for r in rel_starts]
        if length > 65536 and any(p + length > ring.capacity for p in pos):
            wrapped.append(length)
        return inner(ring, rows, rel_starts, length)

    monkeypatch.setattr(mr, "_ring_gather", gather)
    mode = MODES["QPSK"]
    rng = np.random.default_rng(229)
    files = [rng.bytes(mode.chunk_size * 32) for _ in range(2)]
    signals = [chunked(f, "QPSK", f"w{i}.bin", batch=16) for i, f in enumerate(files)]
    _, rx = run_pair(
        "QPSK", 2, signals, 32768, scan_bucket=65536, device_ingest=True, frames_per_round=4, pipeline_depth=2,
    )
    assert rx.dring.total_written > 1.3 * rx.dring.capacity
    assert wrapped, "no K-round window crossed the end of the ring"
    assert_files(rx, files)


@pytest.mark.parametrize("device_ingest", [False, True], ids=["host_fed", "device_ingest"])
def test_preamble_in_the_last_frame_length_of_a_window(device_ingest):
    """A stream behind 48,016 samples of noise: its metadata preamble lies
    in the last est_len samples of its first full 65,536-sample window, so
    the frame cannot end inside it. The JAX package defers the stream and
    retries from the same scan_pos on every block, receiving nothing of the
    file before flush; the port starts the next window just ahead of the
    preamble and has the whole file before flush. The lockstep stream is
    held equal to the JAX package's."""
    mode = MODES["QPSK"]
    rng = np.random.default_rng(181)
    data = rng.bytes(mode.chunk_size * 4)
    sig = chunked(data, "QPSK", "w.bin")
    lead = (rng.standard_normal(48_016) * 0.002).astype(np.float32)
    signals = [sig, np.concatenate([lead, sig])]
    kw = dict(scan_bucket=65536, window_decode=True, device_ingest=device_ingest)
    jrx = jmr.BatchReceiver(JMODES["QPSK"], 2, **kw)
    rx = mr.BatchReceiver(mode, 2, device="cpu", **kw)
    feed(jrx, signals, 65536, flush=False)
    feed(rx, signals, 65536, flush=False)
    assert jrx.streams[1].assembler.received_count == 0 and jrx.streams[1].defer_total >= 0
    live = rx.results()[1]
    assert live["complete"] and live["data"] == data
    jrx.flush()
    rx.flush()
    for a, b in zip(jrx.results(), rx.results()):
        assert (a["complete"], a["data"]) == (b["complete"], b["data"])
    assert_files(rx, [data])
