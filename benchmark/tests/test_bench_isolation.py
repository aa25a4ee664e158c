"""What the benchmark loads and refuses: each loop driver runs at a tiny
size on the CPU (the port's plain versions) without loading JAX or the JAX
package; the reference loads nothing of either package; the command
refuses to measure without a card, and in a directory that holds only the
benchmark."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark.tests import tiny  # noqa: E402


def _python(code: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_loop_drivers_load_no_jax():
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "for cell in tiny.CELLS:\n"
        "    out = tiny.run(cell, seed=3)\n"
        "    assert out.attempted > 0, cell\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'audio_modem_tpu_torch')[:3]))\n"
    )
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    found, program = (json.loads(x) for x in res.stdout.strip().splitlines()[-2:])
    assert found == []
    assert program, "the drivers ran without the port"


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_either_package():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(path) & {"audio_modem_tpu", "audio_modem_tpu_torch", "jax", "jaxlib", "flax"}, path
    res = _python("import sys\nimport benchmark.reference.oracle, benchmark.reference.roofline\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules} & "
                  "{'audio_modem_tpu', 'audio_modem_tpu_torch', 'jax', 'jaxlib', 'flax'}))")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        assert not _imports(path) & {"audio_modem_tpu", "jax", "jaxlib", "flax"}, path


def _command(cwd: Path) -> subprocess.CompletedProcess:
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *cmd[1:], "--workload", cell, "--seed", "2147483659", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command would measure")
    res = _command(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr


def test_command_refuses_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    res = _command(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
    assert "refused" in res.stderr


def test_tiny_cells_are_correct_on_the_cpu():
    for cell in tiny.CELLS:
        out = tiny.run(cell, seed=2**31 + 7)
        assert out.failed == 0, cell
        assert all(v <= lim for v, lim in out.checks.values()), (cell, out.checks)
