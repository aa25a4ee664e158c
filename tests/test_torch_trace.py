"""The port's span recorder (``audio_modem_tpu_torch.utils.trace``) on the
CPU, through the plain versions: off it records nothing; on, a decode
gives its tree of ``decode.*`` spans under one decode id, with the
counters beside them, and the same result as with the recorder off; a
decode that torch.profiler sees records with the recorder off;
``StageTimer`` stages become spans; and a span maps onto torch.profiler's
clock around the operations run inside it."""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_modem_tpu_torch import api, channel, decoder, diag, framing, kernels
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.runtime import receiver as runtime_receiver
from audio_modem_tpu_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _awgn(x: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    power = float(np.mean(x.astype(np.float64) ** 2))
    return (x + rng.standard_normal(x.shape) * np.sqrt(power / 10 ** (snr_db / 10))).astype(np.float32)


def _case(case: str) -> tuple[np.ndarray, str]:
    """A recording and its mode: a clean QPSK frame; the decoy of
    test_torch_decoder_route.py (a tone at inactive bin 4 that the scan
    commits in and the refine rejects, twice); a BPSK-REPEAT frame whose
    data region is at -2 dB (the hard vote fails, the soft rung rescues
    it); the same frame at 3 dB (the Schmidl-Cox scan misses, the xcorr
    rung re-acquires it); an FEC frame with three symbols dropped (the
    erasure rung)."""
    if case == "clean":
        payload = np.random.default_rng(3).bytes(200)
        return framing.build_transmit_signal(payload, MODES["QPSK"], "c.bin", device="cpu").numpy(), "QPSK"
    if case == "decoy":
        p = MODES["QPSK"].profile
        payload = np.random.default_rng(11).bytes(400)
        tx = framing.build_transmit_signal(payload, MODES["QPSK"], "d.bin", device="cpu").numpy()
        t = np.arange(2 * p.fft_size)
        decoy = (0.4 * np.sin(2 * np.pi * 4 * t / p.fft_size)).astype(np.float32)
        return np.concatenate([decoy, np.zeros(2 * p.fft_size, np.float32), tx]), "QPSK"
    if case == "fec":
        mode = MODES["BPSK-ACOUSTIC"]
        sym = mode.profile.symbol_len
        payload = np.random.default_rng(41).bytes(150)
        sig = _awgn(framing.build_transmit_signal(payload, mode, "e.bin", fec=True, device="cpu").numpy(), 30.0, 4)
        s0 = mode.profile.silence_pre_legacy() + 8 * sym
        sig[s0 : s0 + 3 * sym] = 0.0
        return sig, "BPSK-ACOUSTIC"
    mode = MODES["BPSK-REPEAT"]
    p = mode.profile
    sig = framing.build_transmit_signal(np.random.default_rng(42).bytes(96), mode, "f.bin", device="cpu").numpy()
    if case == "soft":
        d0 = p.silence_pre_legacy() + 3 * p.symbol_len
        sig[d0:] = _awgn(sig[d0:], -2.0, 4)
        return sig, "BPSK-REPEAT"
    return _awgn(sig, 3.0, 2), "BPSK-REPEAT"  # "xcorr"


def _decode_traced(sig: np.ndarray, mode: str):
    trace.enable()
    try:
        out = api.decode(sig, mode, device="cpu")
    finally:
        trace.disable()
    spans, counters = trace.drain()
    return out, spans, counters


def _tree(spans) -> list:
    """(name, parent's name) of each span in start order."""
    by_id = {s.id: s for s in spans}
    return [(s.name, by_id[s.parent].name if s.parent else None) for s in sorted(spans, key=lambda s: s.start_ns)]


def test_off_records_and_counts_nothing(recorder):
    assert not trace.enabled()
    a, b = trace.span("decode", mode="QPSK"), trace.span("decode.sync")
    assert a is b
    with a as inner:
        inner.set(samples=3)
        trace.count("host_syncs")
    sig, mode = _case("clean")
    api.decode(sig, mode, device="cpu")
    assert trace.drain() == ([], {})


def test_a_clean_decode_gives_the_span_tree(recorder, monkeypatch):
    reads = []
    real = decoder.read_back

    def counted(what, t, cast=None):
        reads.append(what)
        return real(what, t, cast)

    monkeypatch.setattr(decoder, "read_back", counted)
    sig, mode = _case("clean")
    (result, _), spans, counters = _decode_traced(sig, mode)
    assert result.crc_valid
    assert _tree(spans) == [
        ("decode", None),
        ("decode.upload", "decode"),  # the host copy and its transfer
        ("decode.upload", "decode"),  # decode_raw's dtype and reshape of the tensor
        ("decode.pad", "decode"),
        ("decode.try", "decode"),
        ("decode.kernel_a", "decode.try"),
        ("decode.tail", "decode.try"),  # the vote, pack and |H| in one row
        ("decode.sync", "decode.try"),  # the row's one read
        ("decode.parse", "decode"),
    ]
    root = spans[0]
    assert root.name == "decode" and root.parent == 0 and root.decode == root.id
    assert root.attrs == {"mode": "QPSK", "feed": "host", "samples": len(sig)}
    assert {s.decode for s in spans} == {root.id} and len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    syncs = [s.attrs["what"] for s in sorted(spans, key=lambda s: s.start_ns) if s.name == "decode.sync"]
    assert syncs == reads == ["row"]
    assert counters == {"tries": 1, "tail_rows": 1, "host_syncs": len(reads)}


def test_a_decode_records_while_a_profiler_records(recorder):
    sig, mode = _case("clean")
    with profile(activities=[ProfilerActivity.CPU]):
        api.decode(sig, mode, device="cpu")
    assert not trace.enabled()
    spans, counters = trace.drain()
    assert [s.name for s in spans if not s.parent] == ["decode"] and len(spans) == 9
    assert counters["host_syncs"] == 1
    api.decode(sig, mode, device="cpu")
    assert trace.drain() == ([], {})
    trace.enable()  # on already: the profiler leaves it on
    with profile(activities=[ProfilerActivity.CPU]):
        api.decode(sig, mode, device="cpu")
    assert trace.enabled() and len(trace.drain()[0]) == 9


def test_the_decoy_takes_three_tries(recorder):
    sig, mode = _case("decoy")
    (result, info), spans, counters = _decode_traced(sig, mode)
    assert result.crc_valid
    tries = sorted((s for s in spans if s.name == "decode.try"), key=lambda s: s.start_ns)
    assert [s.attrs["index"] for s in tries] == [0, 1, 2]
    assert counters["tries"] == counters["tail_rows"] == counters["host_syncs"] == 3
    assert sum(s.name == "decode.kernel_a" for s in spans) == sum(s.name == "decode.tail" for s in spans) == 3


@pytest.mark.parametrize("case, rung", [("soft", "soft"), ("xcorr", "xcorr"), ("fec", "fec_erasures")])
def test_a_failed_parse_enters_its_rung(recorder, case, rung):
    sig, mode = _case(case)
    (result, _), spans, counters = _decode_traced(sig, mode)
    assert result.crc_valid
    entered = [s for s in spans if s.name.startswith("decode.rung.")]
    assert f"decode.rung.{rung}" in {s.name for s in entered}
    assert counters["rungs"] == len(entered)
    assert counters["tail_rows"] == counters["tries"]
    root = next(s for s in spans if s.name == "decode")
    assert all(s.decode == root.id for s in spans)


@pytest.mark.parametrize("case", ["clean", "decoy", "soft", "xcorr", "fec"])
def test_decodes_are_bit_identical_with_the_recorder_on(recorder, case):
    sig, mode = _case(case)
    off, off_info = api.decode(sig, mode, device="cpu")
    (on, on_info), spans, _ = _decode_traced(sig, mode)
    assert spans
    assert type(on) is type(off) and dataclasses.asdict(on) == dataclasses.asdict(off)
    assert (on_info.preamble_idx, on_info.coarse_idx, on_info.fine_metric) == (
        off_info.preamble_idx, off_info.coarse_idx, off_info.fine_metric)
    assert (on_info.channel_mag is None) == (off_info.channel_mag is None)
    if on_info.channel_mag is not None:
        assert np.array_equal(on_info.channel_mag, off_info.channel_mag)


def test_stage_timer_stages_are_spans(recorder):
    def run() -> dict:
        timer = trace.StageTimer()
        with timer.stage("scan", samples=10):
            with timer.stage("demod", samples=5):
                pass
        with pytest.raises(RuntimeError):
            with timer.stage("scan"):
                raise RuntimeError("still counted")
        return {k: (v["calls"], v["samples"]) for k, v in timer.report().items()}

    off = run()
    assert trace.drain() == ([], {})
    trace.enable()
    on = run()
    trace.disable()
    spans, _ = trace.drain()
    assert on == off == {"scan": (2, 10), "demod": (1, 5)}
    assert _tree(spans) == [("scan", None), ("demod", "scan"), ("scan", None)]


def test_setup_spans_are_kept_with_the_recorder_off(recorder):
    with trace.setup_span("setup.kernel_load") as sp:
        sp.set(built=True)
        with trace.setup_span("setup.kernel_build"):
            pass
    spans, counters = trace.drain()
    assert _tree(spans) == [("setup.kernel_load", None), ("setup.kernel_build", "setup.kernel_load")]
    assert spans[0].attrs == {"built": True} and counters == {}


def test_spans_past_the_cap_are_dropped_and_counted(recorder, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    for i in range(5):
        with trace.span("decode.sync", what=str(i)):
            pass
    with trace.setup_span("setup.kernel_load"):
        pass
    trace.disable()
    spans, counters = trace.drain()
    assert [s.attrs["what"] for s in spans] == ["0", "1", "2"] and counters == {"spans_dropped": 3}
    with trace.setup_span("setup.kernel_load"):
        pass
    assert [s.name for s in trace.drain()[0]] == ["setup.kernel_load"]  # the drain made room


def test_following_the_profiler_ends_with_the_last_block_open(recorder, monkeypatch):
    """Two threads decode while a profiler records on both: the recorder
    stays on until both have left, so neither's span tree is cut short."""
    import threading

    monkeypatch.setattr(trace, "_profiling", lambda: True)
    inside, leave = threading.Barrier(2, timeout=10), threading.Event()
    seen = []

    def decode_like(wait: bool) -> None:
        with trace.follow_profiler(), trace.span("decode"):
            inside.wait()
            if wait:
                assert leave.wait(10)
            with trace.span("decode.sync"):
                seen.append(trace.enabled())

    slow = threading.Thread(target=decode_like, args=(True,), daemon=True)
    slow.start()
    try:
        decode_like(False)  # leaves first
        assert trace.enabled()
    finally:
        leave.set()
        slow.join(10)
    assert not trace.enabled()
    spans, _ = trace.drain()
    assert seen == [True, True]
    assert sorted(_tree(spans)) == sorted([("decode", None), ("decode.sync", "decode")] * 2)


def test_a_span_maps_onto_the_profile_clock_around_its_ops(recorder):
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pair = trace.clock_pair()
        trace.enable()
        time.sleep(0.002)
        with trace.span("outer"):
            time.sleep(0.002)
            (x * 3).sum()
            time.sleep(0.002)
        time.sleep(0.002)
        trace.disable()
    spans, _ = trace.drain()
    [mapped] = trace.on_profile_clock(spans, pair, prof.profiler.kineto_results.trace_start_ns())
    name, t0, t1 = mapped.name, mapped.start_ns / 1e3, mapped.end_ns / 1e3
    ops = [ev for ev in prof.events() if ev.name in ("aten::mul", "aten::sum")]
    assert name == "outer" and len(ops) == 2 and mapped._replace(start_ns=0, end_ns=0) == spans[0]._replace(
        start_ns=0, end_ns=0)
    for ev in ops:
        assert t0 <= ev.time_range.start <= ev.time_range.end <= t1, (t0, ev.time_range, t1)
    assert abs((t1 - t0) - (spans[0].end_ns - spans[0].start_ns) / 1e3) < 1e-3


def _chunked_transfer() -> np.ndarray:
    """Three QPSK chunks as the port sends them, behind 3,000 samples of
    noise, at 30 dB."""
    data = np.random.default_rng(21).bytes(3 * 2048)
    frames = [f.numpy() for f in api.encode_chunked(data, "QPSK", "k.bin", device="cpu")]
    sig = np.concatenate([np.zeros(3000, np.float32), *frames, np.zeros(4096, np.float32)])
    return _awgn(sig, 30.0, 5)


def test_a_chunked_decode_counts_what_its_spans_show(recorder):
    sig = _chunked_transfer()
    off = api.decode_chunked(sig, "QPSK", device="cpu")
    assert trace.drain() == ([], {})
    trace.enable()
    try:
        on = api.decode_chunked(sig, "QPSK", device="cpu")
    finally:
        trace.disable()
    spans, counters = trace.drain()
    assert on == off and on.complete and on.crc_errors == 0
    names = [s.name for s in spans]
    [root] = [s for s in spans if s.parent == 0 and s.name.startswith("rx.")]
    assert root.name == "rx.decode_chunked" and root.attrs == {"samples": len(sig), "mode": "QPSK"}
    assert all(s.id == root.id or root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in spans)
    assert counters["frames"] == names.count("rx.frame") == 4
    assert counters["refines"] == names.count("rx.refine") == 4 + counters.get("false_peaks", 0)
    assert counters["host_syncs"] == names.count("decode.sync")
    assert counters["rx_blocks"] == names.count("rx.ingest") == -(-len(sig) // 4096)
    assert counters["scan_windows"] == sum(s.attrs["windows"] for s in spans if s.name == "rx.scan")
    assert counters["chunks"] == 3 and "frame_errors" not in counters
    by_id = {s.id: s for s in spans}
    reads = [s.attrs["what"] for s in spans if s.name == "decode.sync"]
    assert reads.count("scan") == counters["scan_windows"] and reads.count("refine") == counters["refines"]
    assert reads.count("bits") == counters["frames"]
    for s in spans:
        if s.name == "decode.sync" and s.attrs["what"] == "bits":
            assert by_id[by_id[s.parent].parent].name == "rx.frame"  # inside decode.vote_pack
    assert sorted(s.attrs["kind"] for s in spans if s.name == "rx.frame") == ["data"] * 3 + ["meta"]
    assert [s.attrs["accepted"] for s in spans if s.name == "rx.refine"].count(True) == 4


def test_a_chunked_decode_records_nothing_with_the_recorder_off(recorder):
    api.decode_chunked(_chunked_transfer(), "QPSK", device="cpu")
    assert trace.drain() == ([], {})


def test_a_loopback_analysis_counts_its_pair_read(recorder, monkeypatch):
    """``diag.analyze_loopback`` reads its refine's index and metric back in
    one copy through ``kernels.read_pair``, the helper the chunked
    receiver's refine reads through: with the recorder on that read is one
    ``host_syncs`` and one ``decode.sync`` span (``what`` "refine"), and the
    report is the one made with the recorder off."""
    assert diag.read_pair is kernels.read_pair is runtime_receiver.read_pair
    pairs = []

    def counted(what, index, metric):
        pairs.append((what, kernels.read_pair(what, index, metric)))
        return pairs[-1][1]

    monkeypatch.setattr(diag, "read_pair", counted)
    sig, _ = diag.generate_test_signal(MODES["QPSK"], device="cpu")
    rec = _awgn(np.concatenate([np.zeros(5000, np.float32), sig.numpy(), np.zeros(3000, np.float32)]), 25.0, 8)
    off = diag.analyze_loopback(rec, MODES["QPSK"], device="cpu")
    assert trace.drain() == ([], {})
    trace.enable()
    try:
        on = diag.analyze_loopback(rec, MODES["QPSK"], device="cpu")
    finally:
        trace.disable()
    spans, counters = trace.drain()
    assert counters == {"host_syncs": 1}
    assert [s.attrs for s in spans if s.name == "decode.sync"] == [{"what": "refine"}]
    assert [what for what, _ in pairs] == ["refine", "refine"] and pairs[0] == pairs[1]
    start, metric = pairs[0][1]
    assert isinstance(start, int) and start == 5000 + MODES["QPSK"].profile.silence_pre_legacy()
    assert on.detected and on.correlation == max(0.0, metric) > 0.5
    for field in dataclasses.fields(off):
        assert np.array_equal(getattr(on, field.name), getattr(off, field.name)), field.name


def test_a_tracked_decode_counts_its_blocks(recorder):
    """``api.decode(track_timing=True)`` of a drifted BPSK-ACOUSTIC frame:
    one ``decode.track`` span (attrs ``n_sym``, ``blocks``, ``passes``) with
    its three ``decode.track.pass`` spans inside it, ``track_blocks`` three
    times the blocks, ``tracked`` one a ``decode.track`` span, the tracked
    bits' read one ``decode.sync`` span among ``host_syncs``; the same
    result with the recorder off."""
    mode = MODES["BPSK-ACOUSTIC"]
    data = np.random.default_rng(12).bytes(1200)
    tx = framing.build_transmit_signal(data, mode, "t.bin", device="cpu").numpy()
    sig = channel.apply_channel_np(tx, channel.ChannelSpec(clock_ppm=150.0, snr_db=25.0), seed=4, device="cpu")
    off, _ = api.decode(sig, mode, track_timing=True, device="cpu")
    trace.enable()
    try:
        on, _ = api.decode(sig, mode, track_timing=True, device="cpu")
    finally:
        trace.disable()
    spans, counters = trace.drain()
    assert on.crc_valid and on.data == data and dataclasses.asdict(on) == dataclasses.asdict(off)
    by_id = {s.id: s for s in spans}
    [track] = [s for s in spans if s.name == "decode.track"]
    passes = sorted((s for s in spans if s.name == "decode.track.pass"), key=lambda s: s.start_ns)
    assert by_id[track.parent].name == "decode" and track.attrs["passes"] == 3
    assert track.attrs["blocks"] == -(-track.attrs["n_sym"] // 64) > 1
    assert [s.attrs["index"] for s in passes] == [0, 1, 2] and all(s.parent == track.id for s in passes)
    assert counters["track_blocks"] == 3 * track.attrs["blocks"]
    assert counters["tracked"] == 1
    syncs = [s.attrs["what"] for s in spans if s.name == "decode.sync"]
    assert counters["host_syncs"] == len(syncs) and syncs == ["row", "bits"]
