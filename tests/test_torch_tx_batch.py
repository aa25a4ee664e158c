"""Batched TX synthesis held on the port, on the CPU (tests/test_tx_batch.py):
``framing.build_data_chunk_frames`` equals the per-frame path, with FEC
too; mixed lengths are refused; groups of ``_SYNTH_GROUP`` frames give the
ungrouped waveforms; ``api.encode_chunked`` batched equals serial and
round-trips. The same inputs through the JAX package give the same
waveforms within 3e-5 and the same decode."""

import dataclasses

import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu_torch import api, framing
from audio_modem_tpu_torch.configs import MODES

torch.set_num_threads(2)

CPU = "cpu"


def _near_jax(ours: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and np.abs(ours.numpy() - ref).max() < 3e-5


@pytest.mark.parametrize("name, fec, seed, n, size", [("QPSK", False, 0, 5, 96), ("BPSK-NARROW", False, 0, 5, 96),
                                                      ("QPSK", True, 1, 3, 64)])
def test_batched_matches_per_frame_synthesis(name, fec, seed, n, size):
    """One batched call gives the waveforms of n one-frame calls (same bits,
    same product, same norm)."""
    mode = MODES[name]
    rng = np.random.default_rng(seed)
    chunks = [rng.bytes(size) for _ in range(n)]
    first = 0 if fec else 7
    batched = framing.build_data_chunk_frames(chunks, first, mode, fec=fec, device=CPU)
    for i, c in enumerate(chunks):
        single = framing.build_data_chunk_frame(c, first + i, mode, fec=fec, device=CPU)
        assert batched.shape[1] == single.shape[0]
        np.testing.assert_allclose(batched[i].numpy(), single.numpy(), atol=2e-6, rtol=0)
    _near_jax(batched, jframing.build_data_chunk_frames(chunks, first, JMODES[name], fec=fec))


def test_synthesize_frames_rejects_mixed_lengths():
    with pytest.raises(ValueError):
        framing.synthesize_frames([b"aa", b"bbb"], MODES["QPSK"], 0, 0, device=CPU)


def test_grouped_synthesis_identical(monkeypatch):
    """Batches over ``_SYNTH_GROUP`` are synthesized group by group; the
    grouped call gives the ungrouped waveforms bit for bit, the short last
    group included."""
    rng = np.random.default_rng(11)
    mode = MODES["QPSK"]
    pls = [framing.build_data_chunk_payload(rng.bytes(64), s) for s in range(5)]
    n_sym = framing.num_symbols_for_payload(len(pls[0]), mode)
    u8 = torch.from_numpy(np.frombuffer(b"".join(pls), np.uint8).reshape(5, -1).copy())
    ungrouped = framing._synth_frames_core(u8, mode, n_sym, 100, 50)
    monkeypatch.setattr(framing, "_SYNTH_GROUP", 2)  # 5 -> groups of 2, 2, 1
    grouped = framing._synth_frames_core(u8, mode, n_sym, 100, 50)
    assert grouped.shape == ungrouped.shape
    assert torch.equal(grouped, ungrouped)
    _near_jax(ungrouped, jframing._synth_frames_core(u8.numpy(), JMODES["QPSK"], n_sym, 100, 50))


def test_encode_chunked_batched_equals_serial():
    """batch=4 gives the frames of batch=1, the short last chunk included."""
    rng = np.random.default_rng(2)
    mode = MODES["QPSK"]
    data = rng.bytes(mode.chunk_size * 5 + 123)  # 6 chunks, the last short
    serial = list(api.encode_chunked(data, mode, "f.bin", batch=1, device=CPU))
    batched = list(api.encode_chunked(data, mode, "f.bin", batch=4, device=CPU))
    assert len(serial) == len(batched) == 7  # metadata + 6 data frames
    for a, b in zip(serial, batched):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=0)
    ref = list(japi.encode_chunked(data, JMODES["QPSK"], "f.bin", batch=4))
    assert len(ref) == 7
    for a, r in zip(batched, ref):
        _near_jax(a, r)


def test_encode_chunked_batched_roundtrip():
    rng = np.random.default_rng(3)
    mode = MODES["QPSK"]
    data = rng.bytes(mode.chunk_size * 3 + 50)
    signal = np.concatenate([f.numpy() for f in api.encode_chunked(data, mode, "r.bin", batch=8, device=CPU)])
    result = api.decode_chunked(signal, mode, device=CPU)
    assert not isinstance(result, framing.FrameError)
    assert result.complete and result.data == data
    assert dataclasses.asdict(result) == dataclasses.asdict(japi.decode_chunked(signal, JMODES["QPSK"]))
