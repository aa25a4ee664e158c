"""``correct`` separates: on the CPU at a tiny size, the program's compared
numbers sit under their limits while the control (the reference computed
in bfloat16 on the same inputs) goes over one; and a run whose timed path
is broken underneath comes out not correct, once for each fault the cells
can have. The same control at the cells' own size runs on the card
(benchmark/control.py; PERF.md gives its readings)."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from audio_modem_tpu_torch import api  # noqa: E402
from audio_modem_tpu_torch.kernels import receive  # noqa: E402
from audio_modem_tpu_torch.parallel import multi_receiver  # noqa: E402
from audio_modem_tpu_torch.runtime import assembler  # noqa: E402
from benchmark.reference import oracle  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


def _correct(out) -> bool:
    return all(v <= lim for v, lim in out.checks.values())


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails_where_the_program_passes(cell):
    out = tiny.run(cell, seed=2**31 + 101)
    assert _correct(out), out.checks
    control = out.control(oracle.CONTROL)
    limits = {k: lim for k, (_, lim) in out.checks.items()}
    assert any(v > limits[k] for k, v in control.items() if k in limits), control


def _flip_stored(monkeypatch):
    """An answer altered where it is produced: the first byte of every
    chunk a round stores is flipped."""
    inner = assembler.ChunkAssembler.store_valid_chunks

    def store(self, seqs, rows, off, size):
        rows = rows.copy()
        rows[:, off] ^= 0xFF
        return inner(self, seqs, rows, off, size)

    monkeypatch.setattr(assembler.ChunkAssembler, "store_valid_chunks", store)


def _half_left_out(monkeypatch):
    """Half of the batch left out: the second half of the streams gets silence."""
    inner = multi_receiver.BatchReceiver.process_blocks

    def process(self, blocks):
        blocks = blocks.clone()
        blocks[blocks.shape[0] // 2 :] = 0
        return inner(self, blocks)

    monkeypatch.setattr(multi_receiver.BatchReceiver, "process_blocks", process)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: blocks are taken and dropped."""
    monkeypatch.setattr(multi_receiver.BatchReceiver, "process_blocks", lambda self, blocks: None)


def _channel_off(monkeypatch):
    """Kernel A's channel estimate altered where it is produced (by 1 %)."""
    inner = receive.decode_fused_reference

    def fused(*a, **kw):
        out = inner(*a, **kw)
        out["ch_re"] = out["ch_re"] * 1.01
        return out

    monkeypatch.setattr(receive, "decode_fused_reference", fused)


def _start_off(monkeypatch):
    """Kernel C's starts altered where they are produced (one sample late)."""
    inner = receive.decode_predicted_reference

    def predicted(*a, **kw):
        out = inner(*a, **kw)
        out["start"] = out["start"] + 1
        return out

    monkeypatch.setattr(receive, "decode_predicted_reference", predicted)


def _decode_altered(monkeypatch):
    """A decode's answer altered where it is produced: one byte of the file."""
    inner = api.decoder.decode_signal

    def decode(*a, **kw):
        result, info = inner(*a, **kw)
        data = bytearray(result.data)
        data[0] ^= 1
        return dataclasses.replace(result, data=bytes(data)), info

    monkeypatch.setattr(api.decoder, "decode_signal", decode)


@pytest.mark.parametrize("cell, fault", [
    ("qpsk64.long", _flip_stored),
    ("qpsk64.long", _half_left_out),
    ("qpsk64.long", _state_unchanged),
    ("qpsk64.long", _channel_off),
    ("qpsk64.long", _start_off),
    ("bpskrep32k.decode", _decode_altered),
    ("bpskrep32k.decode", _channel_off),
    ("bpskrep32k.oncard", _decode_altered),
    ("bpskrep32k.oncard", _channel_off),
    ("narrow1k.decode", _decode_altered),
    ("narrow1k.decode", _channel_off),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = tiny.run(cell, seed=2**31 + 202)
    assert not _correct(out), (fault.__name__, out.checks)


def test_the_reference_runs_in_the_precision_asked():
    x = torch.linspace(-1, 1, 1000, dtype=torch.float64)[None]
    nv = torch.tensor([1000])
    ref, ctl = oracle.preprocess(x, nv), oracle.preprocess(x, nv, oracle.CONTROL)
    assert torch.equal(ref, ref.float().double()) and torch.equal(ctl, ctl.bfloat16().double())
    assert not torch.equal(ref, ctl)
