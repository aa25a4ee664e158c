"""The harness is driven by data: BENCHMARK.json keeps the benchmark's
contract on names, units and entries; a configuration, a cell and a
per-layer metric added as files are found and run by name; and a tiny CPU
run of each loop gives a result line with the contract's keys."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for section, (need, may) in KEYS.items():
        for e in SPEC[section]:
            assert need <= set(e) <= need | may, (section, e)


def test_names_and_units():
    names = []
    for section in KEYS:
        for e in SPEC[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len(names) == len(set(names))


def test_command_paths_and_lines():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w
    for section in ("configs", "workloads"):
        assert all(_line(e["why"]) for e in SPEC[section])
    assert all(_line(c["source"]) for c in SPEC["configs"])
    assert all(_line(m["layer"]) for m in SPEC["per_layer"])


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    assert len({c["file"] for c in configs.values()}) == len(configs)
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"]) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    fours = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        wl, cfg = harness.load_cell(w["name"])
        assert wl["config"] == w["config"] and cfg["name"] == w["config"]
        assert (BENCH / "traffic" / f"{wl['driver']}.py").is_file()


def test_metrics_bounds_and_readers():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    for w in SPEC["workloads"]:
        shown = [m["name"] for m in harness.cell_metrics(SPEC, w["name"], False)]
        assert "setup_s" in shown and len(shown) >= 2, w["name"]
        assert harness.cell_metrics(SPEC, w["name"], True), w["name"]


def test_run_seconds_fits_a_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _copy_benchmark(dst: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    return dst / "benchmark"


def test_a_cell_config_and_metric_added_as_files_run_by_name(tmp_path):
    bench = _copy_benchmark(tmp_path)
    cfg = json.loads((bench / "configs" / "qpsk_64stream.json").read_text())
    (bench / "configs" / "tiny_qpsk.json").write_text(json.dumps({**cfg, "name": "tiny_qpsk", "streams": 3}))
    wl = json.loads((bench / "workloads" / "qpsk64.long.json").read_text())
    (bench / "workloads" / "tiny.rx.json").write_text(json.dumps(
        {**wl, "name": "tiny.rx", "config": "tiny_qpsk",
         "traffic": {**wl["traffic"], "chunks_per_stream": 5, "warm_chunks": 3, "lead_in": [0, 100]}}))
    (bench / "metrics" / "transfers_seen.rx.py").write_text(
        '"""Transfers a traced window completed."""\n\n\ndef read(r):\n    return r.counts["transfers"]\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_qpsk", "source": "a test's throw-away deployment",
                            "file": "benchmark/configs/tiny_qpsk.json", "reduced": ["streams"], "why": "a test"})
    spec["workloads"].append({"name": "tiny.rx", "config": "tiny_qpsk", "traffic": "tiny", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "rx_msps", "unit": "Msamples/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["tiny.rx"]})
    spec["per_layer"].append({"name": "transfers_seen.rx", "unit": "transfers", "better": "higher",
                              "source": "program_counter", "layer": "multi-stream entry", "moves": "rx_msps",
                              "workloads": ["tiny.rx"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = harness.load_spec(tmp_path)
    wl, cfg = harness.load_cell("tiny.rx", bench)
    assert cfg["streams"] == 3
    import time

    ctx = harness.Context(wl, cfg, 9, 0.05, True, "cpu", time.perf_counter(), {})
    out = harness.load_driver(wl["driver"]).run(ctx)
    line = harness.compose(spec, "tiny.rx", True, out, {"platform": "cpu"}, bench)
    assert line["metrics"]["transfers_seen.rx"]["value"] == out.readings.counts["transfers"] >= 1
    assert "rx_msps" in harness.compose(spec, "tiny.rx", False, out, {"platform": "cpu"}, bench)["metrics"]
    assert line["correct"] and out.attempted == out.readings.counts["transfers"] * 3 * 5


@pytest.mark.parametrize("cell", sorted(w["name"] for w in SPEC["workloads"]))
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(cell, traced):
    out = tiny.run(cell, seed=11, trace=traced)
    line = json.loads(json.dumps(harness.compose(SPEC, cell, traced, out, {"platform": "cpu"})))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], (int, float)), name
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_taps_wrap_an_entry_only_where_they_keep_or_record():
    from types import SimpleNamespace

    from benchmark import capture

    def entry(x):
        return x + 1

    owner = SimpleNamespace(entry=entry)
    with capture.Taps(1, 0, False, {"entry": (owner, "entry")}) as taps:
        assert owner.entry is entry and taps.shapes() == {}
    with capture.Taps(1, 0, True, {"entry": (owner, "entry")}) as taps:
        assert owner.entry is not entry and owner.entry(1) == 2
    assert owner.entry is entry and taps.shapes() == {"entry": [{"x": 1}]}


def test_decode_quantiles_leave_out_the_traced_slice(monkeypatch):
    from benchmark.traffic import decode_loop

    ticks = iter(range(10**6))  # a clock that moves 10 ms a reading, whatever a decode takes here
    monkeypatch.setattr(decode_loop.time, "perf_counter", lambda: next(ticks) * 0.01)
    monkeypatch.setattr(decode_loop, "TRACE_SLICE_S", 0.05)
    ctx = tiny.context("bpskrep32k.oncard", seed=5, trace=True)
    ctx.seconds = 0.2
    out = decode_loop.run(ctx)
    traced = out.readings.counts["decodes"]
    assert 0 < traced < out.attempted
    assert len(out.readings.latencies_ms) == out.attempted - traced
