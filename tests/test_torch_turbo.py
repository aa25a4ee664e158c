"""The turbo receive round (slot 0 full receive, cadence-predicted slots
after it) against the JAX package: packed result matrices byte-identical,
and every slot detected, CRC-valid and in sequence."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.parallel import multi_receiver as jmr
from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.parallel import multi_receiver as mr

torch.set_num_threads(2)

N_STREAMS, K, CHUNK = 4, 3, 256


def _round_inputs(noise: float):
    mode = MODES["QPSK"]
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(23)
    n_sym = framing.num_symbols_for_payload(CHUNK + 11, mode)
    cadence = framing.estimate_frame_samples(CHUNK + 11, mode) + p.silence_pre_chunk(False) + p.silence_post_chunk()
    payloads = [framing.build_data_chunk_payload(rng.bytes(CHUNK), s % K) for s in range(N_STREAMS * K)]
    u8 = np.frombuffer(b"".join(payloads), np.uint8).reshape(N_STREAMS * K, -1)
    frames = framing._synth_frames_core(
        torch.from_numpy(u8.copy()), mode, n_sym, p.silence_pre_chunk(False), p.silence_post_chunk()
    ).numpy()
    w = -(-(K * cadence + 4 * sym + p.fft_size + 2048) // 128) * 128
    windows = np.zeros((N_STREAMS, w), np.float32)
    windows[:, : K * cadence] = frames.reshape(N_STREAMS, K * cadence)
    windows += noise * rng.standard_normal(windows.shape).astype(np.float32)
    n_valid = np.full(N_STREAMS, K * cadence, np.int32)
    return mode, n_sym, cadence, windows, n_valid


def _check_classified(packed: np.ndarray):
    cls = mr._classify_round(packed, CHUNK)
    assert cls is not None
    det, _, full, seq = cls
    assert det.all() and full.all()
    assert (seq == np.arange(K)[None, :]).all()


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_turbo_round_matches_jax(noise):
    mode, n_sym, cadence, windows, n_valid = _round_inputs(noise)
    zeros = np.zeros(N_STREAMS, np.int32)
    ref = np.asarray(
        jmr._batch_window_decode_multi(
            jnp.asarray(windows), jnp.asarray(zeros), jnp.asarray(n_valid), JMODES["QPSK"], n_sym, K, cadence
        )
    )
    out = mr._batch_window_decode_multi(
        torch.from_numpy(windows), torch.from_numpy(zeros), torch.from_numpy(n_valid), mode, n_sym, K, cadence
    ).numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape == (N_STREAMS, K, 5 + n_sym * 410 // 8)
    assert np.array_equal(out, ref)
    _check_classified(out)
    det, starts, by = mr._unpack_round(out)
    jdet, jstarts, jby = jmr._unpack_round(ref)
    assert np.array_equal(starts, jstarts) and np.array_equal(by, jby) and np.array_equal(det, jdet)


def test_turbo_round_pred0_matches_jax():
    mode, n_sym, cadence, windows, n_valid = _round_inputs(0.01)
    zeros = np.zeros(N_STREAMS, np.int32)
    first = mr._batch_window_decode_multi(
        torch.from_numpy(windows), torch.from_numpy(zeros), torch.from_numpy(n_valid), mode, n_sym, 1, cadence
    ).numpy()
    _, starts, _ = mr._unpack_round(first)
    pred0 = (starts[:, 0] + 3).astype(np.int32)  # a few samples of drift off the true start
    core = jax.jit(
        partial(jmr._multi_decode_core, mode=JMODES["QPSK"], n_sym_frame=n_sym, k_frames=K, cadence=cadence)
    )
    ref = np.asarray(core(jnp.asarray(windows), jnp.asarray(n_valid), None, pred0=jnp.asarray(pred0)))
    out = mr._multi_decode_core(
        torch.from_numpy(windows), torch.from_numpy(n_valid), None, mode, n_sym, K, cadence,
        pred0=torch.from_numpy(pred0),
    ).numpy()
    assert np.array_equal(out, ref)
    _check_classified(out)
