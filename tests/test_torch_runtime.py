"""The port's host runtime leaves against the JAX package's originals: the
ring buffer, logging, metrics, WAV I/O and StageTimer copies, the native
bridge (its own library path), phy.add_cp, and the chunk assembler with its
sqlite store, which either package must be able to resume from the other."""

import json
import logging
import os
import sqlite3
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import native as jnative
from audio_modem_tpu import phy as jphy
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.framing import DataFrame as JDataFrame, MetaFrame as JMetaFrame
from audio_modem_tpu.runtime import assembler as jassembler
from audio_modem_tpu.runtime.ring import RingBuffer as JRingBuffer
from audio_modem_tpu.utils import log as jlog, metrics as jmetrics, wav as jwav
from audio_modem_tpu.utils.trace import StageTimer as JStageTimer
from audio_modem_tpu_torch import api, framing, native, phy
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.framing import DataFrame, MetaFrame
from audio_modem_tpu_torch.runtime import assembler
from audio_modem_tpu_torch.runtime.ring import RingBuffer
from audio_modem_tpu_torch.utils import log, metrics, trace, wav

torch.set_num_threads(2)


# ---- copies ----


@pytest.mark.parametrize("capacity, blocks", [(100, (60, 60, 7)), (50, (130, 20)), (64, (64, 64, 1, 200, 3))])
def test_ring_buffer_matches_original(capacity, blocks):
    rng = np.random.default_rng(capacity)
    ours, ref = RingBuffer(capacity), JRingBuffer(capacity)
    for n in blocks:
        x = rng.standard_normal(n).astype(np.float32)
        ours.write(x)
        ref.write(x)
        assert ours.total_written == ref.total_written
        assert np.array_equal(ours.buffer, ref.buffer)
        for start in range(max(ours.total_written - capacity - 3, 0), ours.total_written + 2, 7):
            for length in (1, 10, capacity):
                a, b = ours.get_range(start, length), ref.get_range(start, length)
                assert (a is None) == (b is None)
                assert a is None or np.array_equal(a, b)
            assert ours.available_from(start) == ref.available_from(start)


def test_ring_buffer_global_addressing():
    rb = RingBuffer(100)
    rb.write(np.arange(60, dtype=np.float32))
    rb.write(np.arange(60, 120, dtype=np.float32))
    assert rb.get_range(0, 10) is None  # overwritten
    assert np.array_equal(rb.get_range(30, 50), np.arange(30, 80, dtype=np.float32))
    assert rb.get_range(100, 30) is None  # not yet written


def _records(mod, name: str) -> list[tuple]:
    got: list[logging.LogRecord] = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record)

    logger = logging.getLogger(name)
    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        mod.frame_decoded("meta", file="a.bin", chunks=3)
        mod.frame_error("metadata CRC", pos=17)
        mod.chunk_received(2, 5, crc_ok=True)
        mod.transfer_complete("a.bin", 1234)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return [(r.levelno, r.getMessage(), r.event, getattr(r, "seq", None), getattr(r, "pos", None)) for r in got]


def test_log_events_match_original():
    assert log.logger.name == "audio_modem_tpu_torch" and log.logger is not jlog.logger
    ours, ref = _records(log, "audio_modem_tpu_torch"), _records(jlog, "audio_modem_tpu")
    assert len(ours) == 4 and ours == ref


def test_metrics_match_original():
    kw = dict(preamble_metric=0.9, fine_metric=0.8, snr_db=12.0, samples_processed=441000, wall_seconds=0.5)
    ours, ref = metrics.DecodeMetrics(**kw), jmetrics.DecodeMetrics(**kw)
    assert ours.msamples_per_sec == ref.msamples_per_sec and ours.realtime_factor == ref.realtime_factor
    assert metrics.DecodeMetrics().msamples_per_sec == 0.0
    s, r = metrics.StreamStats(started_at=0.0), jmetrics.StreamStats(started_at=0.0)
    assert s.eta_seconds is None and r.eta_seconds is None
    for st in (s, r):
        st.chunks_received, st.total_chunks = 3, 12
    assert s.eta_seconds == pytest.approx(r.eta_seconds, rel=1e-3)
    assert [f.name for f in metrics.dataclasses.fields(s)] == [f.name for f in jmetrics.dataclasses.fields(r)]


@pytest.mark.parametrize("width", [1, 2, 4])
def test_wav_matches_original(tmp_path, width):
    import wave

    rng = np.random.default_rng(width)
    sig = np.clip(rng.standard_normal(3000) * 0.4, -1.2, 1.2).astype(np.float32)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    if width == 2:
        wav.write_wav(a, sig)
        jwav.write_wav(b, sig)
        assert open(a, "rb").read() == open(b, "rb").read()
    else:
        dtype, scale = (np.uint8, 100) if width == 1 else (np.int32, 2**30)
        pcm = (sig.clip(-1, 1) * scale + (128 if width == 1 else 0)).astype(dtype)
        with wave.open(a, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(22050)
            w.writeframes(np.stack([pcm, pcm[::-1]], axis=1).tobytes())
    for kw in ({}, {"max_seconds": 0.01}):
        (x, rate), (y, jrate) = wav.read_wav(a, **kw), jwav.read_wav(a, **kw)
        assert rate == jrate and x.dtype == np.float32 and np.array_equal(x, y)
    assert wav.SAMPLE_RATE == jwav.SAMPLE_RATE


def test_stage_timer_matches_original():
    ours, ref = trace.StageTimer(), JStageTimer()
    for t in (ours, ref):
        with t.stage("demod", samples=44100):
            pass
        with t.stage("demod", samples=100):
            pass
        with pytest.raises(RuntimeError):
            with t.stage("scan"):
                raise RuntimeError("still counted")
    a, b = ours.report(), ref.report()
    assert a.keys() == b.keys() == {"demod", "scan"}
    for name in a:
        assert a[name].keys() == b[name].keys()
        assert (a[name]["calls"], a[name]["samples"]) == (b[name]["calls"], b[name]["samples"])
    assert a["demod"]["samples"] == 44200 and a["scan"]["calls"] == 1


def test_device_trace_writes_a_profile(tmp_path):
    """The Chrome trace holds the program's spans, on the profile's clock,
    beside the operations run inside them."""
    mode = MODES["QPSK"]
    sig = framing.build_transmit_signal(b"traced", mode, "t.bin", device="cpu").numpy()
    with trace.device_trace(str(tmp_path)):
        torch.ones(64).sum().item()
        api.decode(sig, mode, device="cpu")
    assert not trace.enabled()
    [path] = list(tmp_path.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    [decode] = [e for e in events if e.get("cat") == "program" and e["name"] == "decode"]
    assert decode["args"]["decode"] == decode["args"]["id"] and decode["args"]["mode"] == "QPSK"
    inside = [e for e in events if e.get("cat") == "program" and e["args"]["decode"] == decode["args"]["id"]]
    assert {"decode.try", "decode.kernel_a", "decode.sync", "decode.parse"} <= {e["name"] for e in inside}
    ops = [e for e in events if e.get("cat") == "cpu_op" and decode["ts"] <= e["ts"] <= decode["ts"] + decode["dur"]]
    assert ops, "no operation of the decode lies inside its span on the profile's clock"
    assert trace.drain() == ([], {})


def test_add_cp_matches_jax():
    p, jp = MODES["BPSK-ACOUSTIC"].profile, JMODES["BPSK-ACOUSTIC"].profile
    body = np.random.default_rng(0).standard_normal((3, 2, p.fft_size)).astype(np.float32)
    ours = phy.add_cp(torch.from_numpy(body), p)
    assert ours.shape[-1] == p.symbol_len
    assert np.array_equal(ours.numpy(), np.asarray(jphy.add_cp(jnp.asarray(body), jp)))
    assert torch.equal(phy.strip_cp(ours, p), torch.from_numpy(body))


# ---- the native bridge (the scenarios of tests/test_native.py) ----


def test_native_library_compiles_to_its_own_path():
    assert native.available(), "the native library must build (g++ is needed, as for tests/test_native.py)"
    assert native._SO != jnative._SO and native._SO.parent.name == "torch_native"
    assert native._SO.exists() and native._SRC == jnative._SRC
    assert not native._SO.with_suffix(f".{os.getpid()}.tmp").exists()  # built under this name, then moved


def test_native_crc32_matches_zlib():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 255, 4096, 70001):
        data = rng.bytes(n)
        assert native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF == jnative.crc32(data)


def test_native_ema_matches_scalar_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(10000).astype(np.float32) + 0.05  # with DC
    dc, ref = 0.0, np.empty_like(x)
    a = 0.999
    for i, v in enumerate(x.astype(np.float64)):
        dc = a * dc + (1 - a) * v
        ref[i] = v - dc
    got, state = native.ema_dc_removal(x, a, 0.0)
    assert np.abs(got - ref).max() < 1e-6
    assert abs(state - dc) < 1e-12
    # continuation across blocks must equal one long run
    g1, s1 = native.ema_dc_removal(x[:3000], a, 0.0)
    g2, s2 = native.ema_dc_removal(x[3000:], a, s1)
    assert np.abs(np.concatenate([g1, g2]) - got).max() < 1e-6
    # the same bits as the JAX package's bridge, single and batched
    jgot, jstate = jnative.ema_dc_removal(x, a, 0.0)
    assert np.array_equal(got, jgot) and state == jstate
    xb = x[:8000].reshape(4, 2000)
    st, jst = np.linspace(0, 0.1, 4), np.linspace(0, 0.1, 4)
    assert np.array_equal(native.ema_dc_removal_batch(xb, a, st), jnative.ema_dc_removal_batch(xb, a, jst))
    assert np.array_equal(st, jst)


def test_native_majority_vote_tie_rule():
    bits = np.array([1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int8)
    assert list(native.majority_vote(bits, 2)) == [1, 1, 0, 1]


def test_native_fallback_paths_match():
    """Force the numpy fallbacks and compare with native outputs."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(5000).astype(np.float32)
    assert native.available()
    lib = native._lib
    try:
        native._lib, native._tried = None, True
        fb, fb_state = native.ema_dc_removal(x, 0.999, 0.1)
        fb_crc = native.crc32(b"hello world")
        fb_mv = native.majority_vote(np.array([1, 1, 0, 0, 0, 1], np.int8), 3)
        states = np.array([0.1, 0.0])
        fb_b = native.ema_dc_removal_batch(np.stack([x, x]), 0.999, states)
    finally:
        native._lib = lib
    nt, nt_state = native.ema_dc_removal(x, 0.999, 0.1)
    assert np.abs(fb - nt).max() < 1e-5
    assert abs(fb_state - nt_state) < 1e-9
    assert np.array_equal(fb_b[0], fb) and abs(states[0] - fb_state) < 1e-12
    assert fb_crc == native.crc32(b"hello world")
    assert np.array_equal(fb_mv, native.majority_vote(np.array([1, 1, 0, 0, 0, 1], np.int8), 3))


# ---- ChunkAssembler (the scenarios of tests/test_streaming.py::TestAssembler) ----


def _meta(n=4, size=100, csize=32, cls=MetaFrame):
    return cls(n, size, csize, "f.bin", True)


def test_assembler_in_memory():
    asm = assembler.ChunkAssembler()
    asm.handle_metadata(_meta())
    asm.handle_data_chunk(DataFrame(0, b"a" * 32, True))
    asm.handle_data_chunk(DataFrame(0, b"b" * 32, True))  # duplicate ignored
    asm.handle_data_chunk(DataFrame(2, b"c" * 32, False))  # CRC fail not stored
    assert asm.received_count == 1
    assert asm.crc_errors == 1
    assert asm.missing_chunks() == [1, 2, 3]
    assert not asm.is_complete and asm.is_received(0) and not asm.is_received(2)


def test_assembler_assemble_partial_and_to_file(tmp_path):
    asm = assembler.ChunkAssembler()
    asm.handle_metadata(_meta(n=3, size=70, csize=32))
    asm.handle_data_chunk(DataFrame(0, b"a" * 32, True))
    asm.handle_data_chunk(DataFrame(2, b"c" * 6, True))  # final short chunk
    data = asm.assemble()
    assert data == b"a" * 32 + bytes(32) + b"c" * 6
    out = tmp_path / "out.bin"
    assert asm.assemble_to_file(str(out)) == 70 and out.read_bytes() == data


def test_assembler_persistence_and_resume(tmp_path):
    db = str(tmp_path / "chunks.db")
    asm = assembler.ChunkAssembler(db)
    asm.handle_metadata(_meta(n=3, size=96, csize=32))
    asm.handle_data_chunk(DataFrame(0, b"x" * 32, True))
    asm.cleanup()
    asm2 = assembler.ChunkAssembler(db, resume=True)
    assert asm2.received_count == 1
    asm2.handle_metadata(_meta(n=3, size=96, csize=32))
    assert asm2.received_count == 1
    assert asm2.missing_chunks() == [1, 2]
    asm2.handle_data_chunk(DataFrame(1, b"y" * 32, True))
    asm2.handle_data_chunk(DataFrame(2, b"w" * 32, True))
    assert asm2.is_complete
    assert asm2.assemble() == b"x" * 32 + b"y" * 32 + b"w" * 32
    asm2.cleanup()


def test_assembler_fast_path_store_deferred_commit(tmp_path):
    db = str(tmp_path / "c3.db")
    asm = assembler.ChunkAssembler(db)
    asm.handle_metadata(_meta(n=3, size=96, csize=32))
    assert asm.store_valid_chunk(0, np.frombuffer(b"x" * 32, np.uint8))
    assert not asm.store_valid_chunk(0, b"y" * 32)  # duplicate suppressed
    assert not asm.store_valid_chunk(9, b"y" * 32)  # out of range
    assert asm.received_count == 1
    assert asm.missing_chunks() == [1, 2]  # uncommitted row still visible
    assert asm.assemble()[:32] == b"x" * 32  # reads flush the buffer first
    asm.commit()
    assert asm.store_valid_chunk(1, b"y" * 32)
    asm.cleanup()  # commits the tail store
    asm2 = assembler.ChunkAssembler(db, resume=True)
    assert asm2.received_count == 2
    assert asm2.assemble()[:64] == b"x" * 32 + b"y" * 32
    asm2.cleanup()


def test_assembler_batch_store_and_async_writer(tmp_path):
    db = str(tmp_path / "c4.db")
    w = assembler.AsyncBatchWriter()
    asm = assembler.ChunkAssembler(db, writer=w)
    asm.handle_metadata(_meta(n=6, size=192, csize=32))
    rows = np.arange(4 * 40, dtype=np.uint8).reshape(4, 40)
    assert asm.store_valid_chunks(np.array([0, 1, 1, 9]), rows, 7, 32) == 2
    assert asm.received_count == 2  # dup seq 1 + overrun 9 suppressed
    got = asm.assemble()  # flushes the buffer AND drains the writer queue
    assert got[:32] == rows[0, 7:39].tobytes()
    assert got[32:64] == rows[1, 7:39].tobytes()
    asm.handle_data_chunk(DataFrame(2, b"z" * 32, True))  # deferred through the same buffer
    asm.cleanup()
    asm2 = assembler.ChunkAssembler(db, resume=True)
    assert asm2.received_count == 3
    assert asm2.assemble()[64:96] == b"z" * 32
    asm2.cleanup()
    # a writer-side failure surfaces at the next barrier, not silently
    dead = sqlite3.connect(":memory:", check_same_thread=False)
    dead.close()
    w.submit(dead, [(0, b"x")])
    with pytest.raises(sqlite3.ProgrammingError):
        w.barrier()
    w.close()
    assert not w._t.is_alive()


def test_assembler_new_metadata_clears(tmp_path):
    db = str(tmp_path / "c2.db")
    asm = assembler.ChunkAssembler(db)
    asm.handle_metadata(_meta(n=2, size=64, csize=32))
    asm.handle_data_chunk(DataFrame(0, b"x" * 32, True))
    asm.handle_metadata(_meta(n=5, size=160, csize=32))  # different transfer
    assert asm.received_count == 0
    assert asm.missing_chunks() == [0, 1, 2, 3, 4]
    asm.cleanup()


PACKAGES = {
    "port": (assembler, MetaFrame, DataFrame),
    "jax": (jassembler, JMetaFrame, JDataFrame),
}


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_database_written_by_one_package_resumes_in_the_other(tmp_path, writer, reader):
    wmod, wmeta, wdata = PACKAGES[writer]
    rmod, rmeta, rdata = PACKAGES[reader]
    db = str(tmp_path / "shared.db")
    rng = np.random.default_rng(5)
    chunks = [rng.bytes(32) for _ in range(5)]
    asm = wmod.ChunkAssembler(db)
    asm.handle_metadata(_meta(n=5, size=150, csize=32, cls=wmeta))
    asm.handle_data_chunk(wdata(0, chunks[0], True))
    asm.store_valid_chunk(3, np.frombuffer(chunks[3], np.uint8))
    want_bitmap, want_bytes = asm.bitmap(), asm.assemble()
    asm.cleanup()
    with sqlite3.connect(db) as conn:
        schema = sorted(row[0] for row in conn.execute("SELECT sql FROM sqlite_master WHERE type = 'table'"))
    assert schema == [
        "CREATE TABLE chunks (seq INTEGER PRIMARY KEY, data BLOB)",
        "CREATE TABLE meta (k TEXT PRIMARY KEY, v TEXT)",
    ]
    asm2 = rmod.ChunkAssembler(db, resume=True)
    assert (asm2.total_chunks, asm2.total_file_size, asm2.chunk_size, asm2.file_name) == (5, 150, 32, "f.bin")
    assert np.array_equal(asm2.bitmap(), want_bitmap) and asm2.missing_chunks() == [1, 2, 4]
    asm2.handle_metadata(_meta(n=5, size=150, csize=32, cls=rmeta))  # the same transfer: chunks kept
    assert asm2.received_count == 2 and asm2.assemble() == want_bytes
    for seq in (1, 2, 4):
        asm2.handle_data_chunk(rdata(seq, chunks[seq][: 150 - 32 * seq], True))
    assert asm2.is_complete and asm2.assemble() == b"".join(chunks)[:150]
    asm2.cleanup()
