"""The port's BatchReceiver against the JAX package's on the same numpy
blocks (device="cpu"): the scenarios of tests/test_multi_receiver.py at
their stream counts, seeds, blocks and arguments, plus persistence across
the two packages. tests/test_torch_multi_receiver_scale.py holds the
64-stream, turbo and speculative-pipeline scenarios.

Equal for every stream: ``results()`` (complete, data, file name, missing
chunks), the StreamStats counters, and after ``flush`` the scan position,
FSM state, speculation generation and assembler bitmap; equal for the
receiver: the stage names, call and sample counts of ``timer.report()``.
Each scenario also keeps the reference test's own assertions on the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.parallel import multi_receiver as jmr
from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.parallel import multi_receiver as mr

torch.set_num_threads(2)


def feed(rx, signals: "list[np.ndarray]", block: int = 4096, as_tensor=None, flush: bool = True) -> None:
    """Lockstep blocks of ``signals`` into ``rx`` (zeros past a signal's
    end), then ``flush``; ``as_tensor`` turns each numpy block into the
    package's own array type first."""
    t = max(len(s) for s in signals)
    for off in range(0, t, block):
        blocks = np.zeros((len(signals), block), np.float32)
        for i, s in enumerate(signals):
            seg = s[off : off + block]
            blocks[i, : len(seg)] = seg
        rx.process_blocks(blocks if as_tensor is None else as_tensor(blocks))
    if flush:
        rx.flush()


def _stats(stats) -> dict:
    d = dataclasses.asdict(stats)
    d.pop("started_at")
    return d


def _state(rx) -> list:
    return [
        (s.scan_pos, s.state.name, s.gen, s.meta_received, s.assembler.received_count, s.assembler.bitmap().tolist())
        for s in rx.streams
    ]


def _stages(rx) -> dict:
    return {name: (v["calls"], v["samples"]) for name, v in rx.timer.report().items()}


def assert_same(jrx, rx, stalled: "tuple[int, ...]" = ()) -> None:
    """Results, counters, final FSM state and stage counts equal.

    ``stalled`` streams meet the JAX package's endless deferral: a preamble
    in the last est_len samples of a full-width single window, which the
    JAX package retries from the same scan_pos until flush. The port starts
    the next window ahead of the preamble and decodes them live, so their
    counters and the stage counts may differ (the port runs fewer single
    rounds); their results and final state may not."""
    for i, (a, b) in enumerate(zip(jrx.results(), rx.results(), strict=True)):
        for key in ("complete", "data", "file_name", "missing"):
            assert a[key] == b[key], (i, key)
        if i not in stalled:
            assert _stats(a["stats"]) == _stats(b["stats"]), i
    assert _state(jrx) == _state(rx)
    if stalled:
        assert _stages(rx)["single_fetch"][0] < _stages(jrx)["single_fetch"][0]
    else:
        assert _stages(jrx) == _stages(rx)


def run_pair(mode_name: str, n: int, signals, block: int, tensors: bool = False, stalled=(), **kw):
    """The same blocks through the JAX package's BatchReceiver and the
    port's (device="cpu"); returns both after asserting them equal
    (``assert_same``, with ``stalled``)."""
    jrx = jmr.BatchReceiver(JMODES[mode_name], n, **kw)
    feed(jrx, signals, block, jnp.asarray if tensors else None)
    rx = mr.BatchReceiver(MODES[mode_name], n, device="cpu", **kw)
    feed(rx, signals, block, torch.from_numpy if tensors else None)
    assert_same(jrx, rx, stalled)
    return jrx, rx


def assert_files(rx, files) -> None:
    """The reference test's own check: every stream complete and exact."""
    for i, r in enumerate(rx.results()):
        assert r["complete"], (i, r["missing"], r["stats"])
        assert r["data"] == files[i % len(files)]


def chunk_frames(data: bytes, mode_name: str, name: str, **kw) -> "list[np.ndarray]":
    """The frames of a chunked transmission, from the JAX package's TX."""
    return list(japi.encode_chunked(data, JMODES[mode_name], name, **kw))


def chunked(data: bytes, mode_name: str, name: str, **kw) -> np.ndarray:
    return np.concatenate(chunk_frames(data, mode_name, name, **kw))


class TestBatchReceiver:
    def test_eight_streams_eight_files(self):
        mode = MODES["QPSK"]
        rng = np.random.default_rng(61)
        files = [rng.bytes(mode.chunk_size + 100 * i) for i in range(8)]
        signals = [chunked(f, "QPSK", f"f{i}.bin") for i, f in enumerate(files)]
        _, rx = run_pair("QPSK", 8, signals, 4096)
        assert_files(rx, files)
        for i, r in enumerate(rx.results()):
            assert r["file_name"] == f"f{i}.bin"

    def test_staggered_starts_and_noise(self):
        rng = np.random.default_rng(67)
        files = [rng.bytes(200 + 64 * i) for i in range(4)]
        signals = []
        for i, f in enumerate(files):
            sig = chunked(f, "BPSK-ACOUSTIC", f"s{i}")
            lead = (rng.standard_normal(3000 * i) * 0.002).astype(np.float32)
            signals.append(np.concatenate([lead, sig]))
        _, rx = run_pair("BPSK-ACOUSTIC", 4, signals, 4096)
        assert_files(rx, files)

    def test_precompile_covers_buckets_and_decodes(self):
        """The bucket count equals the JAX package's for the same arguments
        (device-ingest and host-fed), and the transfer after it decodes."""
        jmode, mode = JMODES["QPSK"], MODES["QPSK"]
        rng = np.random.default_rng(73)
        data = rng.bytes(mode.chunk_size * 20)
        sig = chunked(data, "QPSK", "p.bin")
        jrx = jmr.BatchReceiver(jmode, 2, device_ingest=True)
        rx = mr.BatchReceiver(mode, 2, device_ingest=True, device="cpu")
        n_prog = rx.precompile(mode.chunk_size)
        assert n_prog == jrx.precompile(jmode.chunk_size)
        assert n_prog >= 3  # k=8 multi+pred at minimum, plus the scan program
        feed(jrx, [sig, sig])
        feed(rx, [sig, sig])
        assert_same(jrx, rx)
        assert_files(rx, [data])
        jhost = jmr.BatchReceiver(jmode, 2, scan_bucket=65536, window_decode=True)
        host = mr.BatchReceiver(mode, 2, scan_bucket=65536, window_decode=True, device="cpu")
        assert host.precompile() == jhost.precompile() >= 2
        for chunk in (256, 4096):
            assert mr.BatchReceiver(mode, 2, device="cpu").precompile(chunk) == jmr.BatchReceiver(
                jmode, 2).precompile(chunk)
        feed(jhost, [sig, sig], block=32768)
        feed(host, [sig, sig], block=32768)
        assert_same(jhost, host)
        assert_files(host, [data])

    def test_matches_single_stream_receiver(self):
        from audio_modem_tpu_torch.runtime.receiver import StreamingReceiver

        mode = MODES["QPSK"]
        rng = np.random.default_rng(71)
        data = rng.bytes(mode.chunk_size * 2 + 7)
        sig = chunked(data, "QPSK", "x")
        single = StreamingReceiver(mode, device="cpu")
        for off in range(0, len(sig), 4096):
            single.process_audio_block(sig[off : off + 4096])
        single.flush()
        _, rx = run_pair("QPSK", 2, [sig, sig], 4096)
        r = rx.results()
        assert single.assembler.assemble() == data
        assert r[0]["data"] == data and r[1]["data"] == data


def _persist_session(package, mode_name: str, path, signal: np.ndarray, resume: bool):
    rx = package.BatchReceiver(
        (JMODES if package is jmr else MODES)[mode_name], 1, persist_dir=str(path), resume=resume,
        **({} if package is jmr else {"device": "cpu"}),
    )
    feed(rx, [signal])
    return rx


class TestBatchReceiverPersistence:
    def _frames(self):
        mode = MODES["QPSK"]
        data = np.random.default_rng(73).bytes(mode.chunk_size * 2 + 9)  # 3 chunks
        frames = chunk_frames(data, "QPSK", "pr.bin")
        return data, frames, len(frames[0]) + len(frames[1])

    def test_persist_dir_and_resume(self, tmp_path):
        """The reference scenario in each package, side by side: a session
        stores metadata + one chunk, a resumed session completes the file."""
        data, frames, cut = self._frames()
        full = np.concatenate(frames)
        replay = np.concatenate([frames[0]] + frames[2:])
        done = []
        for package in (jmr, mr):
            root = tmp_path / package.__name__.split(".")[0]
            root.mkdir()
            rx1 = _persist_session(package, "QPSK", root, full[:cut], resume=False)
            assert rx1.streams[0].assembler.received_count == 1
            rx1.cleanup()
            rx2 = _persist_session(package, "QPSK", root, replay, resume=True)
            done.append(rx2)
        assert_same(*done)
        r = done[1].results()[0]
        assert r["complete"], r["missing"]
        assert r["data"] == data
        for rx in done:
            rx.cleanup()

    @pytest.mark.parametrize("first, second", [(jmr, mr), (mr, jmr)], ids=["jax_then_port", "port_then_jax"])
    def test_resume_across_packages(self, tmp_path, first, second):
        """stream{i}.db files written by one package's BatchReceiver resume
        in the other's with resume=True, and the file comes back exact."""
        data, frames, cut = self._frames()
        rx1 = _persist_session(first, "QPSK", tmp_path, np.concatenate(frames)[:cut], resume=False)
        assert rx1.streams[0].assembler.received_count == 1
        rx1.cleanup()
        assert (tmp_path / "stream0.db").is_file()
        rx2 = _persist_session(second, "QPSK", tmp_path, np.concatenate([frames[0]] + frames[2:]), resume=True)
        r = rx2.results()[0]
        assert r["complete"], r["missing"]
        assert r["data"] == data and r["file_name"] == "pr.bin"
        rx2.cleanup()


class TestBatchFlushMidRefinement:
    def test_flush_decodes_frame_detected_but_unrefined(self):
        """Input ends right after the second frame's preamble is detected
        but before its refinement window is satisfied: flush() salvages the
        frame in both packages, from the same parked state."""
        mode, jmode = MODES["QPSK"], JMODES["QPSK"]
        rng = np.random.default_rng(77)
        payload = rng.bytes(mode.chunk_size)
        meta = jframing.build_metadata_frame(1, len(payload), mode.chunk_size, "x.bin", jmode)
        data = jframing.build_data_chunk_frame(payload, 0, jmode)
        sig = np.concatenate([meta, data])
        p = mode.profile
        sym = p.symbol_len
        n_sym = framing.num_symbols_for_payload(len(payload) + 11, mode)
        frame_end = len(meta) + p.silence_pre_chunk(False) + (3 + n_sym) * sym
        sig = sig[:frame_end]  # no post-silence, no refine slack
        jrx = jmr.BatchReceiver(jmode, 1)
        rx = mr.BatchReceiver(mode, 1, device="cpu")
        feed(jrx, [sig], block=1024, flush=False)
        feed(rx, [sig], block=1024, flush=False)
        state_before = rx.streams[0].state
        assert _state(jrx) == _state(rx)
        jrx.flush()
        rx.flush()
        assert_same(jrx, rx)
        res = rx.results()[0]
        assert res["complete"], (state_before, res["missing"], res["stats"])
        assert res["data"] == payload


class TestWholeRoundFastPath:
    """The O(streams) whole-round consume fast path must leave the receiver
    in exactly the state the per-slot path would, in the port and in the
    JAX package alike."""

    def _transfer(self, monkeypatch, disable_classify: bool):
        if disable_classify:
            monkeypatch.setattr(jmr, "_classify_round", lambda *a, **k: None)
            monkeypatch.setattr(mr, "_classify_round", lambda *a, **k: None)
        mode = MODES["QPSK"]
        rng = np.random.default_rng(977)
        f = rng.bytes(mode.chunk_size * 24)
        frames = chunk_frames(f, "QPSK", "e.bin", batch=12)
        sig = np.concatenate(frames)
        # stream 1 sees a stale duplicate burst mid-transfer (re-sent frames)
        dup = np.concatenate(frames[:3] + frames[1:])
        jrx, rx = run_pair(
            "QPSK", 2, [sig, dup], 32768, scan_bucket=65536, device_ingest=True,
            frames_per_round=4, pipeline_depth=4,
        )
        state = [
            (s.assembler.received_count, s.assembler.bitmap().tolist(), s.stats.frames_decoded, s.state)
            for s in rx.streams
        ]
        out = [r["data"] for r in rx.results()]
        ok = all(r["complete"] for r in rx.results())
        jrx.cleanup()
        rx.cleanup()
        monkeypatch.undo()
        return f, out, state, ok

    def test_state_equivalence_vs_per_slot_path(self, monkeypatch):
        f, out_fast, st_fast, ok_fast = self._transfer(monkeypatch, False)
        f2, out_slow, st_slow, ok_slow = self._transfer(monkeypatch, True)
        assert f == f2
        assert ok_fast and ok_slow
        assert out_fast == out_slow == [f, f]
        assert st_fast == st_slow
