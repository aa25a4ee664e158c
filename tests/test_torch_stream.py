"""The streaming demod's plain version and the paths built on it against the
JAX package: decode_chunks_fused_stream and decode_long_fused held to the
Pallas streaming kernels in interpret mode (flat route for the acoustic and
narrowband profiles, pair route for the standard one) and to the XLA
pipelines, on the same seeded numpy inputs. Bits must be equal; fine metric
within 1e-5 and channel within 1e-4 (tests/test_kernels.py:46,69)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.kernels import receive as jreceive
from audio_modem_tpu.parallel.batch import _batch_decode_chunk_frames_xla, _batch_decode_signals_xla
from audio_modem_tpu_torch import framing, phy
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import receive
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel import batch

torch.set_num_threads(2)

FIVE_MODES = ["QPSK", "16-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "64-QAM"]


def _aligned_frames(mode, n=3, seed=13, noise=0.02):
    """Noisy frame-aligned data frames [n, (3 + n_sym) * sym] and n_sym, as
    tests/test_kernels.py builds them for the JAX streaming kernel."""
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(seed)
    size = 128 if mode.constellation == "BPSK" else mode.chunk_size
    n_sym = framing.num_symbols_for_payload(size + 11, mode)
    fr = []
    for s in range(n):
        f = jframing.build_data_chunk_frame(rng.bytes(size), s, JMODES[mode.name])
        f = f[p.silence_pre_chunk(False) :][: (3 + n_sym) * sym]
        fr.append(f + noise * rng.standard_normal(len(f)).astype(np.float32))
    return np.stack(fr), n_sym


@pytest.mark.parametrize("name", FIVE_MODES)
def test_decode_chunks_fused_stream_matches_jax(name):
    mode, jmode = MODES[name], JMODES[name]
    frames, n_sym = _aligned_frames(mode)
    jax_stream = np.asarray(jreceive.decode_chunks_fused_stream(jnp.asarray(frames), jmode, n_sym, interpret=True))
    xla = np.asarray(_batch_decode_chunk_frames_xla(jnp.asarray(frames), jmode, n_sym))
    out = receive.decode_chunks_fused_stream(torch.from_numpy(frames), mode, n_sym).numpy()
    plain = receive.decode_chunks_fused_reference(torch.from_numpy(frames), mode, n_sym).numpy()
    assert out.shape == (len(frames), n_sym * bits_per_symbol(mode)) and out.dtype == np.int8
    assert np.array_equal(out, jax_stream)
    assert np.array_equal(out, xla)
    assert np.array_equal(out, plain)


@pytest.mark.parametrize("n_frames, n_sym", [(5, 15), (3, 41), (9, 8)])
def test_stream_pair_and_extract_routes_qpsk(n_frames, n_sym):
    """The standard profile's pair route and its body-extract route in the
    JAX package, at odd symbol counts and batches that are not a multiple
    of 8, against one streaming demod in the port."""
    mode = MODES["QPSK"]
    frames, _ = _aligned_frames(mode, n=n_frames, seed=31 + n_sym)
    frames = frames[:, : (3 + n_sym) * mode.profile.symbol_len]
    fr = jnp.asarray(frames)
    jmode = JMODES["QPSK"]
    pair = np.asarray(jreceive.decode_chunks_fused_stream(fr, jmode, n_sym, interpret=True))
    extract = np.asarray(jreceive.decode_chunks_fused_stream(fr, jmode, n_sym, interpret=True, force_extract=True))
    out = receive.decode_chunks_fused_stream(torch.from_numpy(frames), mode, n_sym).numpy()
    assert np.array_equal(out, pair) and np.array_equal(out, extract)


@pytest.mark.parametrize("name", ["QPSK", "BPSK-ACOUSTIC"])
def test_stream_demod_reference_scales_and_pads(name):
    """stream_demod's plain version is phy.demodulate of the scaled region,
    with zeros past a row's end."""
    mode = MODES[name]
    sym = mode.profile.symbol_len
    frames, n_sym = _aligned_frames(mode, n=2, seed=3)
    t = torch.from_numpy(frames)
    ch_re, ch_im = phy.estimate_channel(t[:, 2 * sym : 3 * sym], mode.profile)
    scale = torch.tensor([0.5, 3.0])
    short = t[:, 3 * sym : (2 + n_sym) * sym]  # one symbol short
    bits = receive.stream_demod(short, ch_re, ch_im, scale, mode, n_sym)
    padded = torch.nn.functional.pad(short, (0, sym)) * scale[:, None]
    ref = phy.demodulate(padded.reshape(2, n_sym, sym), ch_re, ch_im, mode)
    assert torch.equal(bits, ref)


def _signals(mode, n=2, size=48, noise=0.02, seed=7):
    rng = np.random.default_rng(seed)
    frames = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(n)], 0, mode, device="cpu").numpy()
    frames = frames + noise * rng.standard_normal(frames.shape).astype(np.float32)
    sym = mode.profile.symbol_len
    signals, n_valid = batch.pad_signals(list(frames), pad_len=frames.shape[1] + 2 * sym)
    return signals, n_valid, max((signals.shape[1] - 3 * sym) // sym, 1)


@pytest.mark.parametrize("name", FIVE_MODES)
def test_decode_long_fused_matches_jax(name):
    mode = MODES[name]
    sym = mode.profile.symbol_len
    signals, n_valid, max_syms = _signals(mode)
    zeros = np.zeros(len(n_valid), np.int32)
    args = (jnp.asarray(signals), jnp.asarray(n_valid), jnp.asarray(zeros), JMODES[name], max_syms)
    jlong = jreceive.decode_long_fused(*args, interpret=True)
    xla = _batch_decode_signals_xla(*args)
    out = receive.decode_long_fused(
        torch.from_numpy(signals), torch.from_numpy(n_valid), torch.from_numpy(zeros), mode, max_syms
    )
    out = {k: v.numpy() for k, v in out.items()}
    assert out["detected"].all()
    bps_sym = bits_per_symbol(mode)
    for ref in (jlong, xla):
        for key in ("start", "coarse", "detected"):
            assert np.array_equal(out[key], np.asarray(ref[key])), key
        assert np.abs(out["fine_metric"] - np.asarray(ref["fine_metric"])).max() < 1e-5
        for i, s in enumerate(out["start"]):
            nb = (int(n_valid[i]) - (int(s) + 3 * sym)) // sym * bps_sym
            assert nb > 0 and np.array_equal(out["bits"][i, :nb], np.asarray(ref["bits"])[i, :nb])
    for key in ("ch_re", "ch_im"):
        assert np.abs(out[key] - np.asarray(jlong[key])).max() < 1e-4


def test_decode_long_fused_no_preamble():
    mode = MODES["QPSK"]
    rng = np.random.default_rng(29)
    signals = (rng.standard_normal((2, 16384)) * 0.05).astype(np.float32)
    n_valid = np.asarray([16384, 9000], np.int32)
    zeros = np.zeros(2, np.int32)
    ref = jreceive.decode_long_fused(
        jnp.asarray(signals), jnp.asarray(n_valid), jnp.asarray(zeros), JMODES["QPSK"], 8, interpret=True
    )
    out = receive.decode_long_fused(torch.from_numpy(signals), torch.from_numpy(n_valid), torch.from_numpy(zeros), mode, 8)
    assert not out["detected"].any()
    assert np.array_equal(out["coarse"].numpy(), np.asarray(ref["coarse"]))
    assert np.array_equal(out["start"].numpy(), np.asarray(ref["start"]))
