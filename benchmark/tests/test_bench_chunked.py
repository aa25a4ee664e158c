"""The chunked cell, ``qpsk1m.chunked``, run by name at a tiny size on the
CPU through its loop driver (the port's plain versions): its result line
is correct, traced and untraced, and carries the receiver's span metrics
when traced; the control goes over a limit where the program passes; and a
run whose timed path is broken underneath comes out not correct, once for
each fault the cell can have."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from audio_modem_tpu_torch import decoder  # noqa: E402
from audio_modem_tpu_torch.runtime import assembler, receiver  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.reference import oracle  # noqa: E402

CELL = "qpsk1m.chunked"
TINY = {"file_bytes": 4 * 2048, "pool": 2, "lead_in": [0, 3000]}
SPEC = harness.load_spec()


def _run(seed: int, trace: bool = False) -> harness.Outcome:
    wl, cfg = harness.load_cell(CELL)
    ctx = harness.Context(wl, cfg, seed, 0.05, trace, "cpu", time.perf_counter(), TINY)
    return harness.load_driver(wl["driver"]).run(ctx)


def _correct(out) -> bool:
    return all(v <= lim for v, lim in out.checks.values())


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_by_name_and_is_correct(traced):
    out = _run(2**31 + 301, traced)
    line = json.loads(json.dumps(harness.compose(SPEC, CELL, traced, out, {"platform": "cpu"})))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"bad_chunks", "start_gap", "fine_gap", "ce_gap"}
    if traced:  # the CPU has no device trace: the span and counter readers alone
        assert set(line["metrics"]) == {"scan_ms_per_frame.chunked", "refine_ms_per_frame.chunked",
                                        "frame_ms_per_frame.chunked", "host_syncs_per_frame.chunked"}
        assert line["metrics"]["host_syncs_per_frame.chunked"]["value"] >= 3
        assert out.readings.counts == {"decodes": 1, "frames": 5}
    else:
        assert set(line["metrics"]) == {"setup_s", "decode_ms"}


def test_the_control_fails_where_the_program_passes():
    out = _run(2**31 + 101)
    assert _correct(out), out.checks
    control = out.control(oracle.CONTROL)
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    assert any(v > limits[k] for k, v in control.items() if k in limits), control


def _chunk_flipped(monkeypatch):
    """A stored chunk's first byte flipped where the assembler takes it."""
    inner = assembler.ChunkAssembler.handle_data_chunk

    def handle(self, frame):
        if frame.seq_num == 1:
            frame.data = bytes([frame.data[0] ^ 0xFF]) + frame.data[1:]
        return inner(self, frame)

    monkeypatch.setattr(assembler.ChunkAssembler, "handle_data_chunk", handle)


def _blocks_dropped(monkeypatch):
    """A receiver that takes its blocks and drops them."""
    monkeypatch.setattr(receiver.StreamingReceiver, "process_audio_block", lambda self, samples: None)


def _start_late(monkeypatch):
    """Every refined start one sample late, where the refine produces it."""
    inner = receiver._refine_window

    def refine(*args):
        start, metric = inner(*args)
        return start + 1, metric

    monkeypatch.setattr(receiver, "_refine_window", refine)


def _channel_off(monkeypatch):
    """The channel a frame decode estimates altered where it is produced (by 1 %)."""
    inner = decoder._frame_channel

    def channel(*args, **kwargs):
        re, im = inner(*args, **kwargs)
        return re * 1.01, im * 1.01

    monkeypatch.setattr(decoder, "_frame_channel", channel)


def _metric_off(monkeypatch):
    """The refine's metric altered where it is produced (by 1e-4)."""
    inner = receiver._refine_window

    def refine(*args):
        start, metric = inner(*args)
        return start, metric + torch.tensor(1e-4, dtype=metric.dtype)

    monkeypatch.setattr(receiver, "_refine_window", refine)


@pytest.mark.parametrize("fault", [_chunk_flipped, _blocks_dropped, _start_late, _channel_off, _metric_off])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run(2**31 + 202)
    assert not _correct(out), (fault.__name__, out.checks)
