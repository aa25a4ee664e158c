"""Kernel A's and kernel B's plain versions against the JAX package: the
Pallas kernels in interpret mode and the XLA pipeline, on the same seeded
numpy inputs; and the golden WAVs through the port's receive path."""

import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.kernels import receive as jreceive
from audio_modem_tpu.parallel.batch import _batch_decode_chunk_frames_xla, _batch_decode_signals_xla
from audio_modem_tpu.utils.wav import read_wav
from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import receive
from audio_modem_tpu_torch.ops.bits import bits_to_bytes
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel import batch

torch.set_num_threads(2)

FIVE_MODES = ["QPSK", "16-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "64-QAM"]
GOLDEN = Path(__file__).parent / "golden"


def _signals(mode, n=2, size=48, noise=0.02, seed=7):
    rng = np.random.default_rng(seed)
    frames = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(n)], 0, mode, device="cpu").numpy()
    frames = frames + noise * rng.standard_normal(frames.shape).astype(np.float32)
    sym = mode.profile.symbol_len
    signals, n_valid = batch.pad_signals(list(frames), pad_len=frames.shape[1] + 2 * sym)
    return signals, n_valid, max((signals.shape[1] - 3 * sym) // sym, 1)


@pytest.mark.parametrize("name", FIVE_MODES)
def test_decode_fused_reference_matches_jax(name):
    mode, jmode = MODES[name], JMODES[name]
    sym = mode.profile.symbol_len
    signals, n_valid, max_syms = _signals(mode)
    zeros = np.zeros(len(n_valid), np.int32)
    xla = _batch_decode_signals_xla(
        jnp.asarray(signals), jnp.asarray(n_valid), jnp.asarray(zeros), jmode, max_syms
    )
    pallas = jreceive.decode_fused(
        jnp.asarray(signals), jnp.asarray(n_valid), jnp.asarray(zeros), jmode, max_syms, interpret=True
    )
    out = receive.decode_fused(
        torch.from_numpy(signals), torch.from_numpy(n_valid), torch.from_numpy(zeros), mode, max_syms
    )
    out = {k: v.numpy() for k, v in out.items()}
    assert out["detected"].all()
    for ref in (xla, pallas):
        assert np.array_equal(out["start"], np.asarray(ref["start"]))
        assert np.array_equal(out["detected"], np.asarray(ref["detected"]))
        assert np.abs(out["fine_metric"] - np.asarray(ref["fine_metric"])).max() < 1e-5
    assert np.array_equal(out["coarse"], np.asarray(xla["coarse"]))
    # the Pallas scan may commit an earlier sample of the same plateau
    pc = np.asarray(pallas["coarse"])
    assert ((pc <= out["coarse"]) & (out["coarse"] - pc <= mode.profile.cp_len)).all()
    for key in ("ch_re", "ch_im"):
        assert np.abs(out[key] - np.asarray(pallas[key])).max() < 1e-4
    bps_sym = bits_per_symbol(mode)
    for i, s in enumerate(out["start"]):
        n_in = (int(n_valid[i]) - (int(s) + 3 * sym)) // sym
        nb = n_in * bps_sym
        assert n_in > 0
        assert np.array_equal(out["bits"][i, :nb], np.asarray(xla["bits"])[i, :nb])
        assert np.array_equal(out["bits"][i, :nb], np.asarray(pallas["bits"])[i, :nb])


def test_decode_fused_reference_no_preamble():
    mode = MODES["QPSK"]
    rng = np.random.default_rng(3)
    signals = (rng.standard_normal((2, 8192)) * 0.05).astype(np.float32)
    n_valid = np.asarray([8192, 4000], np.int32)
    zeros = np.zeros(2, np.int32)
    ref = _batch_decode_signals_xla(jnp.asarray(signals), jnp.asarray(n_valid), jnp.asarray(zeros), JMODES["QPSK"], 4)
    out = receive.decode_fused(torch.from_numpy(signals), torch.from_numpy(n_valid), torch.from_numpy(zeros), mode, 4)
    assert not out["detected"].any()
    assert np.array_equal(out["coarse"].numpy(), np.asarray(ref["coarse"]))
    assert np.array_equal(out["start"].numpy(), np.asarray(ref["start"]))


@pytest.mark.parametrize("name", FIVE_MODES)
def test_decode_chunks_fused_reference_matches_jax(name):
    mode, jmode = MODES[name], JMODES[name]
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(11)
    size = 40
    n_sym = framing.num_symbols_for_payload(size + 11, mode)
    fr = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(3)], 0, mode, device="cpu").numpy()
    clean = fr[:, p.silence_pre_chunk(False) :][:, : (3 + n_sym) * sym]
    fr = clean + 0.02 * rng.standard_normal(clean.shape).astype(np.float32)
    pallas = np.asarray(jreceive.decode_chunks_fused(jnp.asarray(fr), jmode, n_sym, interpret=True))
    xla = np.asarray(_batch_decode_chunk_frames_xla(jnp.asarray(fr), jmode, n_sym))
    out = receive.decode_chunks_fused(torch.from_numpy(fr), mode, n_sym).numpy()
    assert np.array_equal(out, xla) and np.array_equal(out, pallas)
    packed = batch.batch_decode_chunk_frames_packed(torch.from_numpy(clean), mode, n_sym).numpy()
    for row in packed:
        parsed = framing.parse_payload_bytes(row.tobytes())
        assert isinstance(parsed, framing.DataFrame) and parsed.crc_valid


@pytest.mark.parametrize("name", ["QPSK", "16-QAM"])
def test_golden_wav_through_port(name):
    entry = json.loads((GOLDEN / "manifest.json").read_text())[name]
    mode = MODES[name]
    sym = mode.profile.symbol_len
    signal, rate = read_wav(str(GOLDEN / entry["wav"]))
    assert rate == 44100 and len(signal) == entry["samples"]
    signals, n_valid = batch.pad_signals([signal], pad_len=len(signal) + 2 * sym)
    max_syms = (signals.shape[1] - 3 * sym) // sym
    out = batch.batch_decode_signals(torch.from_numpy(signals), torch.from_numpy(n_valid), mode, max_syms)
    assert bool(out["detected"][0])
    n_sym = (int(n_valid[0]) - (int(out["start"][0]) + 3 * sym)) // sym
    by = bits_to_bytes(out["bits"][0, : n_sym * bits_per_symbol(mode)]).numpy().tobytes()
    result = framing.parse_payload_bytes(by)
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid
    assert result.file_name == entry["file_name"]
    assert hashlib.sha256(result.data).hexdigest() == entry["sha256"]
