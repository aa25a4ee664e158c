"""The readings that the limits of ``correct`` are set from: on each seed, a
short run of the cell at its own size gives the program's compared numbers
(the lower reading), and the control, the reference computed in bfloat16
(``reference.oracle.CONTROL``) put in the program's place on the same
inputs, gives its numbers (the upper reading). One process for all seeds,
so the kernels build once.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 0.1] [--out FILE]

Prints one JSON line a seed. Not part of the benchmark's command: its runs
never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = str(Path(__file__).resolve().parent.parent)
if sys.path and sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = _ROOT
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device: str = "cuda", overrides: dict | None = None) -> dict:
    """One seed: the program's numbers and the control's, beside the limits."""
    from benchmark.reference import oracle

    wl, cfg = harness.load_cell(cell)
    ctx = harness.Context(wl, cfg, seed, seconds, False, device, time.perf_counter(), overrides or {})
    out = harness.load_driver(wl["driver"]).run(ctx)
    return {"seed": seed, "program": {k: v for k, (v, _) in out.checks.items()},
            "control": out.control(oracle.CONTROL), "limits": cfg["limits"],
            "attempted": out.attempted, "failed": out.failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    harness.require_program()
    harness.require_cards(1)
    lines = []
    for s in args.seeds.split(","):
        t = time.perf_counter()
        rec = readings(args.workload, int(s), args.seconds)
        rec["wall_s"] = time.perf_counter() - t
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
