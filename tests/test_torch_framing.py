"""The port's framing against the JAX package: host codecs byte-identical on
fuzzed payloads, device TX waveform within 3e-5 in every mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES

torch.set_num_threads(2)


def _same(a, b) -> bool:
    if type(a).__name__ != type(b).__name__:
        return False
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _corrupt(rng, by: bytes) -> bytes:
    arr = bytearray(by)
    for _ in range(int(rng.integers(0, 4))):
        arr[int(rng.integers(0, len(arr)))] ^= 1 << int(rng.integers(0, 8))
    return bytes(arr[: int(rng.integers(len(arr) // 2, len(arr) + 1))]) if rng.random() < 0.3 else bytes(arr)


@pytest.mark.parametrize("seed", range(4))
def test_codecs_byte_identical(seed):
    rng = np.random.default_rng(0xC0DE + seed)
    for _ in range(25):
        data = rng.bytes(int(rng.integers(1, 300)))
        name = "".join(chr(c) for c in rng.integers(97, 123, int(rng.integers(0, 40))))
        seq = int(rng.integers(0, 2**32))
        payloads = [
            (framing.build_legacy_payload(data, name), jframing.build_legacy_payload(data, name)),
            (
                framing.build_metadata_payload(seq % 5000, len(data), 2048, name),
                jframing.build_metadata_payload(seq % 5000, len(data), 2048, name),
            ),
            (framing.build_data_chunk_payload(data, seq), jframing.build_data_chunk_payload(data, seq)),
        ]
        for ours, ref in payloads:
            assert ours == ref
            for by in (ours, _corrupt(rng, ours), framing.wrap_fec(ours), _corrupt(rng, framing.wrap_fec(ours))):
                assert _same(framing.parse_payload_bytes(by), jframing.parse_payload_bytes(by))
            assert framing.wrap_fec(ours) == jframing.wrap_fec(ref)
        for name, mode in MODES.items():
            jmode = JMODES[name]
            n = len(data)
            assert np.array_equal(framing.payload_to_bits(data, mode), jframing.payload_to_bits(data, jmode))
            assert framing.num_symbols_for_payload(n, mode) == jframing.num_symbols_for_payload(n, jmode)
            assert framing.estimate_frame_samples(n, mode) == jframing.estimate_frame_samples(n, jmode)
            for first in (True, False):
                assert framing.estimate_frame_samples_with_silence(
                    n, mode, first
                ) == jframing.estimate_frame_samples_with_silence(n, jmode, first)
        assert framing.fec_wire_len(len(data)) == jframing.fec_wire_len(len(data))


@pytest.mark.parametrize("name", sorted(MODES))
def test_tx_waveform_matches_jax(name):
    mode, jmode = MODES[name], JMODES[name]
    p = mode.profile
    rng = np.random.default_rng(17)
    chunks = [rng.bytes(40) for _ in range(3)]
    ref = jframing.build_data_chunk_frames(chunks, 5, jmode)
    out = framing.build_data_chunk_frames(chunks, 5, mode, device="cpu").numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 3e-5
    u8 = np.frombuffer(b"".join(chunks), np.uint8).reshape(3, 40)
    n_sym = framing.num_symbols_for_payload(40, mode)
    core = framing._synth_frames_core(torch.from_numpy(u8.copy()), mode, n_sym, 7, 3).numpy()
    jcore = np.asarray(jframing._synth_frames_core(jnp.asarray(u8), jmode, n_sym, 7, 3))
    assert core.shape == jcore.shape and np.abs(core - jcore).max() < 3e-5
    assert p.silence_pre_chunk(False) > 0 and (out[:, : p.silence_pre_chunk(False)] == 0).all()
