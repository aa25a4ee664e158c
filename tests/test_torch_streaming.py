"""The port's StreamingReceiver and api.decode_chunked against the JAX
package's on the same audio blocks (device="cpu"): chunked transfers clean,
behind noise, with dropouts and bursts, two files in a row, under clock
drift and with FEC. Noise and drift come from the JAX package's channel
module.

Equal: every frame's refined preamble position, kind and sequence number,
the stream counters, missing chunks, CRC errors and the file bytes. The
refine metric agrees within 1e-5. The coarse index is not compared: on a
noise-free plateau it may differ between the packages while the refined
start does not."""

import dataclasses

import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import channel
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.runtime import receiver as jreceiver
from audio_modem_tpu_torch import api, framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.runtime import receiver

torch.set_num_threads(2)

METRIC_TOL = 1e-5


def _recording(module, metrics: list):
    """``module._refine_window`` wrapped so that every refine metric lands
    in ``metrics``."""
    inner = module._refine_window

    def refine(*args):
        out = inner(*args)
        metrics.append(float(out[1]))
        return out

    return refine


def _run(module, monkeypatch, mode, signal: np.ndarray, block: int = 4096, **kw):
    """Feed ``signal`` in blocks to ``module.StreamingReceiver``; returns
    (receiver, events, refine metrics, delivered files). An event is
    (refined preamble position, frame kind, sequence number or chunk count)."""
    events, metrics, files = [], [], {}
    monkeypatch.setattr(module, "_refine_window", _recording(module, metrics))
    rx = module.StreamingReceiver(mode, on_file=lambda name, data: files.__setitem__(name, data), **kw)
    asm = rx.assembler
    on_meta, on_data = asm.handle_metadata, asm.handle_data_chunk

    def handle_metadata(meta):
        events.append((rx.preamble_pos, "meta", meta.total_chunks))
        return on_meta(meta)

    def handle_data_chunk(frame):
        events.append((rx.preamble_pos, "data" if frame.crc_valid else "data, bad CRC", frame.seq_num))
        return on_data(frame)

    asm.handle_metadata, asm.handle_data_chunk = handle_metadata, handle_data_chunk
    for off in range(0, len(signal), block):
        rx.process_audio_block(signal[off : off + block])
    rx.flush()
    return rx, events, metrics, files


def _stats(rx) -> dict:
    d = dataclasses.asdict(rx.stats)
    d.pop("started_at")
    return d


def _both(monkeypatch, name: str, signal: np.ndarray, **kw):
    """The same blocks through both receivers; everything listed in the
    module docstring is held equal. Returns the port's (receiver, events,
    files)."""
    signal = np.asarray(signal, np.float32)
    ref, ref_events, ref_metrics, ref_files = _run(jreceiver, monkeypatch, JMODES[name], signal, **kw)
    rx, events, metrics, files = _run(receiver, monkeypatch, MODES[name], signal, device="cpu", **kw)
    assert events == ref_events
    assert len(metrics) == len(ref_metrics)
    for a, b in zip(metrics, ref_metrics):
        assert a == b or abs(a - b) < METRIC_TOL, (a, b)
    assert _stats(rx) == _stats(ref)
    assert rx.meta_received == ref.meta_received
    assert rx.assembler.missing_chunks() == ref.assembler.missing_chunks()
    assert rx.assembler.crc_errors == ref.assembler.crc_errors
    assert rx.assembler.assemble() == ref.assembler.assemble()
    assert files == ref_files
    assert (rx.scan_pos, rx.state.name) == (ref.scan_pos, ref.state.name)
    return rx, events, files


def _frames(data: bytes, name: str, file_name: str, **kw) -> list[np.ndarray]:
    return [np.asarray(f) for f in japi.encode_chunked(data, JMODES[name], file_name, **kw)]


@pytest.mark.parametrize("name", ["QPSK", "BPSK-NARROW"])
def test_chunked_transfer(monkeypatch, name):
    mode = MODES[name]
    data = np.random.default_rng(31).bytes(mode.chunk_size * 2 + 123)  # 3 chunks
    frames = _frames(data, name, "big.bin")
    rx, events, files = _both(monkeypatch, name, np.concatenate(frames))
    assert rx.meta_received and rx.assembler.is_complete
    assert rx.assembler.assemble() == data and files == {"big.bin": data}
    assert rx.stats.frames_decoded == len(frames) and rx.stats.frame_errors == 0
    assert [e[1:] for e in events] == [("meta", 3), ("data", 0), ("data", 1), ("data", 2)]
    # the refined positions are the true frame starts
    p = mode.profile
    starts = np.cumsum([0] + [len(f) for f in frames[:-1]])
    pre = [p.silence_pre_chunk(True)] + [p.silence_pre_chunk(False)] * 3
    assert [e[0] for e in events] == [int(s + q) for s, q in zip(starts, pre)]


@pytest.mark.parametrize("name", ["QPSK", "BPSK-NARROW"])
def test_with_leading_noise_and_gap(monkeypatch, name):
    mode = MODES[name]
    rng = np.random.default_rng(37)
    data = rng.bytes(mode.chunk_size + 17)  # 2 chunks
    noise = (rng.standard_normal(9000) * 0.001).astype(np.float32)
    rx, _, _ = _both(monkeypatch, name, np.concatenate([noise] + _frames(data, name, "n.bin")))
    assert rx.assembler.is_complete and rx.assembler.assemble() == data


def test_two_files_one_receiver(monkeypatch):
    """A second metadata frame starts a fresh transfer; completed files are
    delivered through on_file before the reset."""
    mode = MODES["QPSK"]
    rng = np.random.default_rng(111)
    file_a = rng.bytes(mode.chunk_size + 5)
    file_b = rng.bytes(2 * mode.chunk_size + 11)
    sig = np.concatenate(_frames(file_a, "QPSK", "a.bin") + _frames(file_b, "QPSK", "b.bin"))
    _, _, files = _both(monkeypatch, "QPSK", sig)
    assert files == {"a.bin": file_a, "b.bin": file_b}


def test_dropout_burst_loses_only_affected_chunks(monkeypatch):
    mode = MODES["QPSK"]
    data = np.random.default_rng(89).bytes(mode.chunk_size * 3)
    frames = _frames(data, "QPSK", "drop.bin")
    start = sum(len(f) for f in frames[:2])
    spec = channel.ChannelSpec(dropout=((start, len(frames[2])),))  # chunk 1's frame
    damaged = channel.apply_channel_np(np.concatenate(frames), spec)
    rx, _, _ = _both(monkeypatch, "QPSK", damaged)
    assert rx.assembler.missing_chunks() == [1]
    out = rx.assembler.assemble()
    cs = mode.chunk_size
    assert out[:cs] == data[:cs] and out[2 * cs :] == data[2 * cs :] and out[cs : 2 * cs] == bytes(cs)


def test_many_frames_random_gaps_and_bursts(monkeypatch):
    """Random noise gaps between the frames and one frame destroyed by a
    burst; everything else arrives."""
    name = "BPSK-ACOUSTIC"
    mode = MODES[name]
    rng = np.random.default_rng(101)
    data = rng.bytes(mode.chunk_size * 5 + 37)  # 6 chunks
    frames = _frames(data, name, "stress.bin")
    parts = []
    for f in frames:
        parts.append((rng.standard_normal(int(rng.integers(0, 5000))) * 0.003).astype(np.float32))
        parts.append(f)
    signal = np.concatenate(parts)
    start = sum(len(x) for x in parts[: 2 * 3 + 1])  # data frame of chunk 2 (frames[0] is metadata)
    dead = len(frames[3])
    signal[start : start + dead] = (rng.standard_normal(dead) * 0.05).astype(np.float32)
    rx, _, _ = _both(monkeypatch, name, signal)
    assert rx.assembler.missing_chunks() == [2], rx.stats
    out = rx.assembler.assemble()
    cs = mode.chunk_size
    assert out[: 2 * cs] == data[: 2 * cs] and out[3 * cs :] == data[3 * cs :]


@pytest.mark.parametrize("ppm", [100.0, -100.0])
def test_chunked_transfer_under_clock_drift(monkeypatch, ppm):
    """Each frame re-syncs at its own preamble, and the chunk decoder's
    timing-tracked retry recovers the drift within a frame."""
    mode = MODES["QPSK"]
    data = np.random.default_rng(19).bytes(mode.chunk_size * 5 + 100)  # 6 data frames
    sig = np.concatenate(_frames(data, "QPSK", "d.bin", batch=8))
    drifted = channel.apply_channel_np(sig, channel.ChannelSpec(clock_ppm=ppm))
    rx, _, files = _both(monkeypatch, "QPSK", drifted)
    assert rx.assembler.is_complete and files == {"d.bin": data}


def test_fec_transfer_with_a_burst(monkeypatch):
    """RS(255,223)-wrapped frames under 25 dB AWGN, one data frame hit by a
    burst of a few symbols that the code corrects."""
    name = "BPSK-ACOUSTIC"
    mode = MODES[name]
    sym = mode.profile.symbol_len
    rng = np.random.default_rng(7)
    data = rng.bytes(mode.chunk_size + 60)  # 2 chunks
    frames = _frames(data, name, "fec.bin", fec=True)
    sig = np.array(channel.apply_channel_np(np.concatenate(frames), channel.ChannelSpec(snr_db=25.0), seed=5))
    hit = len(frames[0]) + mode.profile.silence_pre_chunk(False) + 12 * sym
    sig[hit : hit + 2 * sym] = 0.0
    rx, events, files = _both(monkeypatch, name, sig, fec=True)
    assert rx.assembler.is_complete and files == {"fec.bin": data}
    assert rx.fec and [e[1:] for e in events] == [("meta", 2), ("data", 0), ("data", 1)]


def test_flush_decodes_a_partially_collected_frame(monkeypatch):
    """The recording ends inside the last frame's trailing silence, before
    the end the receiver expects for a full-size chunk: flush decodes it."""
    mode = MODES["QPSK"]
    data = np.random.default_rng(3).bytes(700)  # one short chunk
    sig = np.concatenate(_frames(data, "QPSK", "tail.bin"))
    cut = len(sig) - mode.profile.silence_post_chunk() // 2
    rx, _, files = _both(monkeypatch, "QPSK", sig[:cut])
    assert rx.ring.total_written == cut and files == {"tail.bin": data}


def test_decode_chunked_matches_jax_field_by_field():
    mode = MODES["QPSK"]
    data = np.random.default_rng(41).bytes(64 * 1024)
    signal = np.concatenate(_frames(data, "QPSK", "api.bin"))
    ref = japi.decode_chunked(signal, JMODES["QPSK"])
    ours = api.decode_chunked(signal, mode, device="cpu")
    assert isinstance(ours, api.ChunkedDecodeResult) and not isinstance(ref, jframing.FrameError)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.complete and ours.data == data and ours.file_name == "api.bin" and ours.total_chunks == 32
    # a tensor is taken as well, and a mode name
    again = api.decode_chunked(torch.from_numpy(signal), "qpsk", device="cpu")
    assert dataclasses.asdict(again) == dataclasses.asdict(ours)


def test_decode_chunked_on_noise_reports_no_metadata():
    noise = (np.random.default_rng(0).standard_normal(60000) * 0.01).astype(np.float32)
    ref = japi.decode_chunked(noise, JMODES["QPSK"])
    ours = api.decode_chunked(noise, "QPSK", device="cpu")
    assert isinstance(ours, framing.FrameError) and isinstance(ref, jframing.FrameError)
    assert ours.error == ref.error == "No metadata frame received"


def test_receiver_constants_and_defaults():
    for name in ("STREAM_MIN_ENERGY", "PRE_META_MAX_PAYLOAD", "SCAN_BUCKET"):
        assert getattr(receiver, name) == getattr(jreceiver, name)
    assert [s.name for s in receiver.RecvState] == [s.name for s in jreceiver.RecvState]
    rx, ref = receiver.StreamingReceiver(MODES["16-QAM"], device="cpu"), jreceiver.StreamingReceiver(JMODES["16-QAM"])
    assert rx.ring.capacity == ref.ring.capacity and rx.dc_alpha == ref.dc_alpha
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            receiver.StreamingReceiver(MODES["QPSK"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.decode_chunked(np.zeros(5000, np.float32), "QPSK")


@pytest.mark.parametrize("first, second", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_receiver_persist_and_resume_across_packages(tmp_path, first, second):
    """One receiver stores the first chunks in sqlite and stops; a receiver
    of the other package resumes the store (the sender replays the metadata
    frame and sends the rest) and completes the file."""
    makers = {
        "port": lambda **kw: receiver.StreamingReceiver(MODES["QPSK"], device="cpu", **kw),
        "jax": lambda **kw: jreceiver.StreamingReceiver(JMODES["QPSK"], **kw),
    }
    data = np.random.default_rng(73).bytes(MODES["QPSK"].chunk_size * 3 + 9)  # 4 chunks
    frames = _frames(data, "QPSK", "pr.bin")
    db = str(tmp_path / "chunks.db")

    def feed(rx, signal):
        for off in range(0, len(signal), 4096):
            rx.process_audio_block(signal[off : off + 4096])
        rx.flush()

    rx1 = makers[first](persist_path=db)
    feed(rx1, np.concatenate(frames[:3]))
    assert rx1.assembler.received_count == 2
    rx1.cleanup()
    rx2 = makers[second](persist_path=db, resume=True)
    assert rx2.assembler.received_count == 2 and rx2.assembler.missing_chunks() == [2, 3]
    feed(rx2, np.concatenate([frames[0]] + frames[3:]))
    assert rx2.assembler.is_complete and rx2.assembler.assemble() == data
    assert rx2.stats.chunks_received == 4
    rx2.cleanup()
