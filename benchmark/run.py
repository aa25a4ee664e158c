"""Run one benchmark cell once and print its result line last:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without a CUDA card, outside a checkout
that holds the program, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = str(Path(__file__).resolve().parent.parent)
if sys.path and sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = _ROOT  # run as a script: import from the checkout's root
elif _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
