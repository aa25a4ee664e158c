"""The port's multi-process dry run (parallel/multihost.py, the counterpart
of tests/test_parallel.py::test_multihost_dryrun_two_processes): two real
``torch.distributed`` processes on gloo over the CPU, each with a 2-device
virtual mesh; a child that fails or hangs makes the parent raise."""

import sys
import time

import pytest
import torch

from audio_modem_tpu_torch.parallel import multihost

torch.set_num_threads(2)


def test_two_processes_on_gloo():
    reports = multihost.run_dryrun(2, 2, timeout=300.0, backend="gloo", device="cpu")
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["world"] == 2 and r["backend"] == "gloo" and r["devices"] == ["cpu", "cpu"]
        assert r["ber"] == 0.0 and r["ber_local"] == 0.0
        assert r["detected"] == [1] * 8  # 2 streams x 2 devices x 2 processes, all-gathered
        assert r["launches"] and not any(r["launches"].values())
        assert not r["jax_loaded"]


def _replace_child(monkeypatch, rank: int, code: str) -> None:
    real = multihost._child_command

    def command(r, *args):
        return [sys.executable, "-c", code] if r == rank else real(r, *args)

    monkeypatch.setattr(multihost, "_child_command", command)


def test_a_failing_child_makes_the_dryrun_raise(monkeypatch):
    _replace_child(monkeypatch, 1, "import sys; print('child 1 gives up'); sys.exit(3)")
    with pytest.raises(RuntimeError, match="(?s)a child failed.*rc=3.*child 1 gives up"):
        multihost.run_dryrun(2, 1, timeout=120.0, backend="gloo", device="cpu")


def test_each_child_has_a_timeout_of_its_own(monkeypatch):
    """A child that hangs is stopped at its timeout, with its partner that
    waits for it in the group, and the parent raises."""
    _replace_child(monkeypatch, 1, "import time; time.sleep(600)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ran past its 6.0 s"):
        multihost.run_dryrun(2, 1, timeout=6.0, backend="gloo", device="cpu")
    assert time.monotonic() - t0 < 60


def test_backend_rules(monkeypatch):
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        multihost.run_dryrun(2, 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="gloo or nccl"):
        multihost.run_dryrun(2, 1, backend="mpi", device="cpu")
    # nccl needs a card per rank's device: with one card, two ranks raise
    # before any child starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "_child_command", lambda *a: pytest.fail("a child was started"))
    with pytest.raises(RuntimeError, match="nccl: 2 ranks x 1 devices need that many cards, only 1"):
        multihost.run_dryrun(2, 1, backend="nccl", device="cuda")
