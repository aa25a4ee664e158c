"""The clock-offset cell, ``bpskrep32k.drift``, run by name at a tiny size
on the CPU through its loop driver (the port's plain versions): one ~2 KB
frame a recording, a pool of 2 at +100 and -100 ppm. Its result line is
correct, traced and untraced, and carries ``decode_ms`` and ``setup_s``,
and traced the tracker's span reader (the CPU has no device trace; the
three device readers are held on a made-up trace); the control goes over a
limit where the program passes; and a run whose start is one sample late,
whose tracker's final tau is moved past its limit, or whose tracker
measures one symbol past the frame, is not correct; and a program that
gets a recording wrong at set-up stops the run before its window."""

import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from audio_modem_tpu_torch import decoder  # noqa: E402
from benchmark import harness, spans  # noqa: E402
from benchmark.reference import oracle, roofline, roofline_track  # noqa: E402
from benchmark.reference.profiles import MODES  # noqa: E402

CELL = "bpskrep32k.drift"
TINY = {"file_bytes": 2000, "pool": 2, "ppm": [100, -100]}
HERE = Path(__file__).resolve().parent
READERS = {"track_ms_per_decode.drift", "launches_per_decode.drift", "device_idle_pct.drift",
           "track_roofline.drift"}


SPEC = harness.load_spec()


def _run(seed: int, trace: bool = False) -> harness.Outcome:
    wl, cfg = harness.load_cell(CELL)
    ctx = harness.Context(wl, cfg, seed, 0.05, trace, "cpu", time.perf_counter(), TINY)
    return harness.load_driver(wl["driver"]).run(ctx)


def _correct(out) -> bool:
    return all(v <= lim for v, lim in out.checks.values())


def test_the_entries_name_what_the_cell_reads():
    assert {m["name"] for m in SPEC["per_layer"] if CELL in m.get("workloads", [])} == READERS
    assert [m["name"] for m in harness.cell_metrics(SPEC, CELL, False)] == ["setup_s", "decode_ms"]
    assert {m["name"] for m in harness.cell_metrics(SPEC, CELL, True)} == READERS
    wl, cfg = harness.load_cell(CELL)
    entry = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1 and entry["traffic"] == "drift"
    assert wl["config"] == cfg["name"] == entry["config"] and cfg["reduced"] == {}
    assert next(c for c in SPEC["configs"] if c["name"] == cfg["name"])["reduced"] == []
    for name in READERS:
        assert (HERE.parent / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_by_name_and_is_correct(traced):
    out = _run(2**31 + 401, traced)
    line = json.loads(json.dumps(harness.compose(SPEC, CELL, traced, out, {"platform": "cpu"})))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0, line["checks"]
    assert set(line["checks"]) == {"bad_decodes", "start_gap", "fine_gap", "ce_gap", "tau_gap", "track_bit_gap",
                                   "track_len_gap"}
    if traced:  # the CPU has no device trace: the span reader alone
        assert set(line["metrics"]) == {"track_ms_per_decode.drift"}
        assert out.readings.counts == {"decodes": 1}
        assert len(out.readings.shapes["tracked_core"]) == 1  # the traced decode's one tracker call
    else:
        assert set(line["metrics"]) == {"setup_s", "decode_ms"}


def test_the_control_fails_where_the_program_passes():
    out = _run(2**31 + 101)
    assert _correct(out), out.checks
    control = out.control(oracle.CONTROL)
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    assert any(v > limits[k] for k, v in control.items() if k in limits), control
    assert control["tau_gap"] > limits["tau_gap"], control


def _start_late(monkeypatch):
    """Every refined start one sample late, where the decoder reads it."""
    inner = decoder._tail_read

    def tail_read(out, mode):
        coarse, start, *rest = inner(out, mode)
        return (coarse, start + 1, *rest)

    monkeypatch.setattr(decoder, "_tail_read", tail_read)


def _tau_moved(monkeypatch):
    """The tracker's final tau moved by twice its limit, where it returns it."""
    inner = decoder._tracked_core
    limit = harness.load_cell(CELL)[1]["limits"]["tau_gap"]

    def tracked_core(signal, n_valid, start, mode, n_sym, n_valid_sym):
        bits, tau = inner(signal, n_valid, start, mode, n_sym, n_valid_sym)
        return bits, tau + 2 * limit

    monkeypatch.setattr(decoder, "_tracked_core", tracked_core)


def _bound_moved(monkeypatch):
    """The header's bound on the tracker's measurement one symbol long."""
    inner = decoder._header_symbols
    monkeypatch.setattr(decoder, "_header_symbols", lambda by, mode, n_max, fb: inner(by, mode, n_max, fb) + 1)


@pytest.mark.parametrize("fault", [_start_late, _tau_moved, _bound_moved])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run(2**31 + 202)
    assert not _correct(out), (fault.__name__, out.checks)


def test_a_recording_lost_at_set_up_stops_the_run(monkeypatch):
    """A program that decodes a recording of the set-up wrong (here every
    tracked bit flipped, so no CRC holds) is refused before the window."""
    inner = decoder._tracked_core

    def tracked_core(*args):
        bits, tau = inner(*args)
        return 1 - bits, tau

    monkeypatch.setattr(decoder, "_tracked_core", tracked_core)
    with pytest.raises(harness.Refused, match="recording 0 \\(\\+100 ppm\\)"):
        _run(2**31 + 303)


def test_the_device_readers_on_a_made_up_trace():
    """Launches, idle and the roofline share from device events and
    ``decode.track`` spans put on the events' clock by the loop driver's shift."""
    mode = MODES["BPSK-REPEAT"]
    shift_ns = 5_000_000  # the span clock runs 5 ms behind the events'
    events = [("decode_fused_kernel", 0.0, 100.0), ("Memcpy HtoD", 100.0, 120.0),  # before the tracker
              ("k1", 1000.0, 1010.0), ("k2", 1005.0, 1030.0), ("k3", 1500.0, 1520.0),  # inside it: 50 us busy
              ("Memcpy DtoH", 2100.0, 2110.0)]
    r = harness.Readings(mode=mode, counts={"decodes": 1, "clock_shift_ns": shift_ns},
                         shapes={"tracked_core": [{"n_sym": 100}]}, events=events, window_s=4e-3,
                         peaks=roofline.PEAKS["NVIDIA H100 80GB HBM3"])
    track = spans.ProgramSpan("decode.track", 1000.0 - 5000.0, 2000.0 - 5000.0, 2, 1, 1)
    r.program = ([spans.ProgramSpan("decode", -5000.0, -2800.0, 1, 0, 1), track], {})
    got = {name: harness.load_metric(name).read(r) for name in READERS}
    assert got["launches_per_decode.drift"] == 4
    assert got["device_idle_pct.drift"] == pytest.approx(100 * (1 - 180e-6 / 4e-3))
    assert got["track_ms_per_decode.drift"] == pytest.approx(1.0)
    least = roofline.least_seconds(roofline_track.work_tracked(mode, 100), r.peaks)
    assert got["track_roofline.drift"] == pytest.approx(100 * least / 50e-6)
    r.counts.pop("clock_shift_ns")  # a program without the recorder's clock: nothing to read
    assert harness.load_metric("track_roofline.drift").read(r) is None
    r.program = (r.program[0][:1], {})  # a program without the tracker's span (the parent's): nothing either
    assert harness.load_metric("track_ms_per_decode.drift").read(r) is None
