"""The program's spans and counters in the benchmark: the readers of the
per-layer metrics that read them (``benchmark/spans.py``), the idle time
split among the spans open over it (``spans.idle_by_span``), the spans that
carry the slow decodes, the spans put on a profile's clock, a traced run
whose decodes a profiler sees, and a program without the recorder."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from benchmark import harness, spans, trace  # noqa: E402
from benchmark.spans import OUTSIDE, ProgramSpan as S  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NEW = ["host_syncs_per_decode.decode", "sync_wait_ms_per_decode.decode", "upload_ms_per_decode.decode",
       "dispatch_ms_per_decode.decode", "parse_ms_per_decode.decode", "kernel_load_s.setup"]
OLD = ["device_ms_per_decode.decode", "launches_per_decode.decode", "kernel_a_roofline.decode",
       "device_idle_pct.decode", "decode_p50_ms.decode", "decode_p95_ms.decode"]


@pytest.fixture(autouse=True)
def empty_recorder():
    """The program's recorder off and empty around each test."""
    from audio_modem_tpu_torch.utils import trace as program_trace

    program_trace.disable()
    program_trace.drain()
    yield
    program_trace.disable()
    program_trace.drain()


def _reader(name):
    return harness.load_metric(name)


def _decode(i: int, t0: float, sync_us: float = 100.0) -> list:
    """A decode of 1,000 us from ``t0`` (ids from 10 * i): an upload of 50,
    a try holding kernel A's launch (200) and a sync (``sync_us``), a
    vote-and-pack holding the bits' sync (30), a parse of 20."""
    d = 10 * i
    return [
        S("decode.upload", t0, t0 + 50, d + 1, d, d),
        S("decode.kernel_a", t0 + 60, t0 + 260, d + 3, d + 2, d),
        S("decode.sync", t0 + 260, t0 + 260 + sync_us, d + 4, d + 2, d),
        S("decode.try", t0 + 55, t0 + 400, d + 2, d, d, {"index": 0}),
        S("decode.sync", t0 + 500, t0 + 530, d + 6, d + 5, d, {"what": "bits"}),
        S("decode.vote_pack", t0 + 450, t0 + 600, d + 5, d, d),
        S("decode.parse", t0 + 900, t0 + 920, d + 7, d, d),
        S("decode", t0, t0 + 1000, d, 0, d, {"mode": "BPSK-REPEAT"}),
    ]


def _readings(found=None, counters=None, events=None):
    """Readings of a traced run; ``found`` and ``counters`` stand in for what
    the readers would drain from the program."""
    from benchmark.reference.profiles import MODES

    r = harness.Readings(mode=MODES["BPSK-REPEAT"], counts={"decodes": 2}, latencies_ms=[1.0, 2.0, 3.0],
                         events=events, window_s=0.01,
                         shapes={"decode_fused": [{"signals": (1, 65536), "max_syms": 10}]}, peaks=(3.35e12, 67e12))
    if found is not None:
        r.program = (list(found), counters or {})
    return r


def test_the_six_new_metrics_read_both_decode_cells():
    named = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = named[name]
        assert m["workloads"] == ["bpskrep32k.oncard", "narrow1k.decode"]
        assert m["source"] == ("program_counter" if name.startswith("host_syncs") else "program_span")
    assert [m["name"] for m in SPEC["per_layer"][-6:]] == NEW


def test_the_readers_on_hand_made_spans():
    found = _decode(1, 0.0) + _decode(2, 2000.0, sync_us=300.0)
    found.append(S("setup.kernel_load", -5e6, -3e6, 99, 0, 0, {"built": True}))
    found.append(S("setup.kernel_build", -4.9e6, -3.2e6, 100, 99, 0))  # nvcc, left out
    found.append(S("setup.kernel_load", -1e6, -0.5e6, 101, 0, 0, {"built": False}))
    r = _readings(found, {"host_syncs": 10, "tries": 2})
    got = {name: _reader(name).read(r) for name in NEW}
    assert got["host_syncs_per_decode.decode"] == 5.0
    assert got["sync_wait_ms_per_decode.decode"] == pytest.approx((130 + 330) / 2 / 1e3)
    assert got["upload_ms_per_decode.decode"] == pytest.approx(0.05)
    assert got["parse_ms_per_decode.decode"] == pytest.approx(0.02)
    # the root less the upload, both syncs and the parse; each decode's own
    assert spans.self_ms(found, spans.DISPATCH_LESS) == pytest.approx([(1000 - 50 - 130 - 20) / 1e3,
                                                                       (1000 - 50 - 330 - 20) / 1e3])
    assert got["dispatch_ms_per_decode.decode"] == pytest.approx((0.8 + 0.6) / 2)
    assert got["kernel_load_s.setup"] == pytest.approx(2.0 - 1.7 + 0.5)


def test_a_span_inside_another_of_the_left_out_is_taken_once():
    found = [S("decode.parse", 100, 400, 2, 1, 1), S("decode.sync", 150, 250, 3, 2, 1), S("decode", 0, 1000, 1, 0, 1)]
    assert spans.self_ms(found, spans.DISPATCH_LESS) == pytest.approx([0.7])


@pytest.mark.parametrize("name", NEW)
def test_the_readers_find_nothing_without_spans_or_counters(name):
    assert _reader(name).read(_readings()) is None  # drained from the program's empty recorder
    assert _reader(name).read(_readings([], {})) is None
    if name.startswith("host_syncs"):
        assert _reader(name).read(_readings(_decode(1, 0.0))) is None
        # spans past the recorder's cap left decodes out of the roots, not of the counter
        assert _reader(name).read(_readings(_decode(1, 0.0), {"host_syncs": 7, "spans_dropped": 4})) is None


@pytest.mark.parametrize("name", OLD)
def test_the_existing_readers_read_the_same_with_spans(name):
    events = [("pre_stats_kernel", 0.0, 10.0), ("receive_demod_kernel", 20.0, 60.0), ("Memcpy DtoH", 70.0, 75.0),
              ("scan_kernel", 2000.0, 2010.0)]
    bare = _reader(name).read(_readings(events=events))
    full = _reader(name).read(_readings(_decode(1, 0.0) + _decode(2, 2000.0), {"host_syncs": 10}, events))
    assert bare is not None and full == bare


def test_the_tail_names_the_span_that_slows_the_slow_decodes():
    found = [sp for i in range(1, 21) for sp in _decode(i, 2000.0 * i)]
    slow = _decode(21, 50000.0)
    slow[6] = slow[6]._replace(end_us=slow[6].end_us + 400)  # its parse 400 us longer
    slow[7] = slow[7]._replace(end_us=slow[7].end_us + 400)
    tail = spans.tail_by_span(found + slow)
    assert tail[0] == ("decode.parse", pytest.approx(0.4))  # the slowest 5 %: one decode of 21
    assert spans.tail_by_span(_decode(1, 0.0)) == []


def test_idle_is_split_among_the_innermost_spans():
    # busy 0-10, 100-110, 300-310, 1000-1010: idle 10-100, 110-300, 310-1000 (970 us)
    events = [("a_kernel", 0.0, 10.0), ("b_kernel", 100.0, 110.0), ("Memcpy", 300.0, 310.0), ("c_kernel", 1000.0, 1010.0)]
    found = [
        S("decode", 0.0, 900.0, 1, 0, 1),
        S("decode.kernel_a", 20.0, 60.0, 2, 1, 1),
        S("decode.sync", 200.0, 400.0, 3, 1, 1),
        S("decode.vote_pack", 350.0, 500.0, 4, 1, 1),  # opened inside the sync: the innermost over 350-400
        S("zero", 600.0, 600.0, 5, 1, 1),
    ]
    got = spans.idle_by_span(events, found)
    assert got == pytest.approx({
        "decode": ((20 - 10) + (100 - 60) + (200 - 110) + (900 - 500)) * 1e-6,
        "decode.kernel_a": 40e-6,
        "decode.sync": ((300 - 200) + (350 - 310)) * 1e-6,
        "decode.vote_pack": (500 - 350) * 1e-6,
        OUTSIDE: (1000 - 900) * 1e-6,
    })
    gaps = trace.breakdown(events)["idle_gaps"]
    assert abs(sum(got.values()) - sum(v for _, v in gaps)) < 1e-6
    assert spans.idle_by_span(events, []) == {OUTSIDE: pytest.approx(970e-6)}
    assert spans.idle_by_span([], found) == {}


def test_the_split_sums_to_the_idle_gaps_on_many_spans():
    import random

    rng = random.Random(7)
    events, found, t = [], [], 0.0
    for i in range(300):
        d = 10 * i + 1
        found.append(S("decode", t, t + 900.0, d, 0, d))
        for j in range(3):
            s0 = t + 50 + 280 * j + rng.uniform(0, 100)
            found.append(S(f"decode.step{j}", s0, s0 + rng.uniform(10, 170), d + 1 + j, d, d))
        for _ in range(4):
            s0 = t + rng.uniform(0, 1000)
            events.append(("k_kernel", s0, s0 + rng.uniform(1, 60)))
        t += 1000.0 + rng.uniform(0, 30)
    events.sort(key=lambda e: e[1])
    split = spans.idle_by_span(events, found)
    idle = sum(v for _, v in trace.breakdown(events, top=10**6)["idle_gaps"])
    assert abs(sum(split.values()) - idle) < 1e-6
    assert 0 < split[OUTSIDE] < idle


def test_spans_map_onto_the_profiles_clock():
    from audio_modem_tpu_torch.utils import trace as program_trace

    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pair = program_trace.clock_pair()
        with program_trace.setup_span("setup.window"):
            time.sleep(0.002)
            (x * 2).sum()
            time.sleep(0.002)
    found, _ = program_trace.drain()
    [sp] = spans.in_us(program_trace.on_profile_clock(found, pair, prof.profiler.kineto_results.trace_start_ns()))
    ops = [ev for ev in prof.events() if ev.name in ("aten::mul", "aten::sum")]
    assert len(ops) == 2
    assert all(sp.start_us <= ev.time_range.start <= ev.time_range.end <= sp.end_us for ev in ops)


def _traced_line(cell: str, seed: int) -> tuple[dict, harness.Outcome]:
    """A tiny traced CPU run of ``cell`` whose whole window a CPU profile
    sees, as the device trace sees the traced slice on the card."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = tiny.run(cell, seed=seed, trace=True)
    return harness.compose(SPEC, cell, True, out, {"platform": "cpu"}), out


@pytest.mark.parametrize("cell", ["bpskrep32k.oncard", "narrow1k.decode"])
def test_a_profiled_traced_run_prints_the_new_metrics(cell):
    line, out = _traced_line(cell, seed=4)
    assert line["correct"]
    # no kernel library loads on the CPU, so kernel_load_s.setup has nothing to read there
    assert set(NEW) - set(line["metrics"]) == {"kernel_load_s.setup"}
    assert line["metrics"]["host_syncs_per_decode.decode"]["value"] == 5
    found, counters = out.readings.program
    decodes = out.attempted + tiny.CELLS[cell]["pool"]  # the profile here holds the warm decodes too
    assert len(spans.decodes(found)) == counters["tries"] == decodes
    assert min(spans.self_ms(found, spans.DISPATCH_LESS)) > 0


def test_an_unprofiled_run_records_nothing():
    from audio_modem_tpu_torch.utils import trace as program_trace

    out = tiny.run("narrow1k.decode", seed=5, trace=True)  # the CPU run traces no device: no profiler
    line = harness.compose(SPEC, "narrow1k.decode", True, out, {"platform": "cpu"})
    assert not set(NEW) & set(line["metrics"]) and out.readings.program == ([], {})
    assert not program_trace.enabled()


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "_recorder", lambda: None)
    line, out = _traced_line("bpskrep32k.oncard", seed=3)
    assert not set(NEW) & set(line["metrics"]) and line["correct"]


def test_span_breakdown_runs_a_cell_and_splits_by_span(monkeypatch, capsys):
    """The script on the CPU at a tiny size, under a CPU profile in the
    device trace's place (it has no device events to split there)."""
    from benchmark import span_breakdown

    monkeypatch.setattr(span_breakdown, "DEVICE", "cpu")
    monkeypatch.setattr(span_breakdown, "OVERRIDES", {"pool": 2})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        assert span_breakdown.main(["--workload", "narrow1k.decode", "--seed", "2147499001", "--seconds", "0.2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["decodes"] == line["host_decodes"] > 0
    assert abs(line["root_mean_ms"] - line["host_mean_ms"]) < 0.05 * line["host_mean_ms"]
    assert line["counters"]["host_syncs"] == 5 * line["decodes"] and line["least_dispatch_ms"] > 0
    assert line["tail_by_span"] and line["idle_by_span"] == [] and line["idle_inside_spans_pct"] is None
