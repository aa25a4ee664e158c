"""The benchmark's harness: finds a cell's files by name, checks the card,
runs the cell's loop driver, reads the per-layer metrics, decides
``correct`` and prints the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``workloads/<cell>.json`` (its ``driver`` names
``traffic/<driver>.py``) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "audio_modem_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_modem_tpu")


class Refused(Exception):
    """The run cannot measure (no card, the program missing, JAX loaded)."""


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: Path = BENCH) -> tuple[dict, dict]:
    """(workload, configuration) of the cell ``name``, from their own files."""
    wl = json.loads((bench / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((bench / "configs" / f"{wl['config']}.json").read_text())
    return wl, cfg


def load_driver(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.traffic.{name}")


def load_metric(name: str, bench: Path = BENCH) -> ModuleType:
    """The per-layer reader ``metrics/<name>.py`` (names hold dots, so it is
    loaded by path)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def use_checkout_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def require_program(root: Path = ROOT) -> None:
    """The program under test is the checkout's own copy, never another."""
    try:
        mod = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise Refused(f"the program {PROGRAM} is not in this checkout: {e}") from e
    if root.resolve() not in Path(mod.__file__).resolve().parents:
        raise Refused(f"{PROGRAM} was imported from {mod.__file__}, outside the checkout {root}")


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures on the card and never falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell asks for {n} cards, this machine has {torch.cuda.device_count()}")


@dataclasses.dataclass
class Readings:
    """What a run hands its per-layer readers."""

    mode: object  # benchmark.reference.profiles.Mode
    stages: dict = dataclasses.field(default_factory=dict)  # StageTimer: name -> {"seconds", "calls", ...}
    counts: dict = dataclasses.field(default_factory=dict)  # the driver's counts and host times
    shapes: dict = dataclasses.field(default_factory=dict)  # kernel entry -> [argument shapes of each call]
    latencies_ms: list = dataclasses.field(default_factory=list)  # per request or per chunk, host clock
    events: list | None = None  # device events of the traced window: (name, start_us, end_us)
    window_s: float = 0.0  # length of the traced window
    peaks: tuple | None = None  # (bytes/s, flop/s) of the card, None where unknown


@dataclasses.dataclass
class Outcome:
    """A driver's result: end-to-end values, the compared numbers beside
    their limits, the counts, and the readings for the per-layer metrics."""

    metrics: dict  # end-to-end name -> value
    checks: dict  # compared name -> (value, limit)
    attempted: int
    failed: int
    readings: Readings
    memory_peak_bytes: int = 0
    breakdown: dict | None = None
    # the same numbers for the reference computed in a given Precision on
    # the inputs the program was judged on (benchmark/control.py reads it)
    control: object = None


@dataclasses.dataclass
class Context:
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # the process's start, on time.perf_counter()
    overrides: dict = dataclasses.field(default_factory=dict)  # tests shrink a cell here

    def param(self, key: str):
        """A traffic parameter, or the configuration's, after the overrides."""
        if key in self.overrides:
            return self.overrides[key]
        traffic = self.workload.get("traffic", {})
        return traffic[key] if key in traffic else self.config[key]


def applies(metric: dict, cell: str, reports: set[str]) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else metric.get("moves") in reports


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if applies(m, cell, names)]


def compose(spec: dict, cell: str, trace: bool, out: Outcome, device: dict, bench: Path = BENCH) -> dict:
    """The result line's object, compared numbers last."""
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        value = load_metric(m["name"], bench).read(out.readings) if trace else out.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in out.checks.values())
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def device_record(count: int, memory_peak_bytes: int, readings: Readings | None) -> dict:
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": memory_peak_bytes}
    if readings is not None and readings.events is not None:
        from benchmark.trace import busy_seconds

        rec["busy_s"] = busy_seconds(readings.events)
        rec["window_s"] = readings.window_s
    return rec


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    try:
        use_checkout_caches()
        spec = load_spec()
        entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
        if entry is None:
            raise Refused(f"no cell {args.workload!r} in BENCHMARK.json")
        require_program()
        t_program = time.perf_counter()
        require_cards(entry["chips"])
        print(f"setup split s: the program imported {t_program - t_start:.3f}, "
              f"the cards counted {time.perf_counter() - t_program:.3f}", file=sys.stderr)
        wl, cfg = load_cell(args.workload)
        ctx = Context(wl, cfg, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
        out = load_driver(wl["driver"]).run(ctx)
        found = forbidden_modules()
        if found:
            raise Refused(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        line = compose(spec, args.workload, ctx.trace, out,
                       device_record(entry["chips"], out.memory_peak_bytes, out.readings if ctx.trace else None))
    except Refused as e:
        print(f"benchmark: refused: {e}", file=sys.stderr)
        return 2
    if ctx.trace:
        print("readings " + json.dumps({"counts": out.readings.counts, "stages": out.readings.stages}),
              file=sys.stderr)
    for name, (value, limit) in out.checks.items():
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line))
    return 0
