"""The port's copies of the wire format's host modules (configs, ops.lcg,
ops.crc32, ops.rs) against the JAX package's originals: every profile and
mode field, every derived array, the LCG sequences, and CRC-32 and
Reed-Solomon on seeded random bytes. Equality is exact throughout."""

import dataclasses

import numpy as np
import pytest

from audio_modem_tpu import configs as jconfigs
from audio_modem_tpu.ops import crc32 as jcrc32
from audio_modem_tpu.ops import lcg as jlcg
from audio_modem_tpu.ops import rs as jrs
from audio_modem_tpu_torch import configs
from audio_modem_tpu_torch.ops import crc32, lcg, rs

PROFILE_ARRAYS = (
    "active_bins", "data_bins", "pilot_bins", "pilot_mask_active",
    "preamble1", "preamble2", "ce_symbol", "ce_known_signs",
)
PROFILE_SCALARS = ("symbol_len", "is_acoustic", "num_active_subs", "num_data_subs")
PROFILE_METHODS = ("header_samples", "silence_pre_legacy", "silence_post_legacy", "silence_post_chunk")


def _same_array(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_module_constants():
    for name in ("FFT_SIZE", "SAMPLE_RATE", "SEED_PREAMBLE1", "SEED_PREAMBLE2", "SEED_CE",
                 "FRAME_META", "FRAME_DATA", "FRAME_FEC", "CHUNK_THRESHOLD"):
        assert getattr(configs, name) == getattr(jconfigs, name), name
    assert sorted(configs.OFDM_PROFILES) == sorted(jconfigs.OFDM_PROFILES)
    assert sorted(configs.MODES) == sorted(jconfigs.MODES)
    for alias in ("qpsk", "QAM16", "16qam", "qam64", "bpsk", "bpsk_repeat", "BPSK-NARROW"):
        assert configs.get_mode(alias).name == jconfigs.get_mode(alias).name


@pytest.mark.parametrize("name", sorted(jconfigs.OFDM_PROFILES))
def test_profile_fields_and_derived_arrays(name):
    p, jp = configs.OFDM_PROFILES[name], jconfigs.OFDM_PROFILES[name]
    assert type(p) is not type(jp)  # the port's own class
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    for attr in PROFILE_SCALARS:
        assert getattr(p, attr) == getattr(jp, attr), attr
    for attr in PROFILE_METHODS:
        assert getattr(p, attr)() == getattr(jp, attr)(), attr
    for first in (True, False):
        assert p.silence_pre_chunk(first) == jp.silence_pre_chunk(first)
    for bps in (1, 2, 4, 6):
        assert p.bits_per_symbol(bps) == jp.bits_per_symbol(bps)
    for attr in PROFILE_ARRAYS:
        assert _same_array(getattr(p, attr), getattr(jp, attr)), attr


@pytest.mark.parametrize("name", sorted(jconfigs.MODES))
def test_mode_fields(name):
    m, jm = configs.MODES[name], jconfigs.MODES[name]
    assert type(m) is not type(jm)
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    assert dataclasses.asdict(m.profile) == dataclasses.asdict(jm.profile)
    assert (m.bps, m.bits_per_symbol) == (jm.bps, jm.bits_per_symbol)


@pytest.mark.parametrize("seed", [42, 43, 44, 0, 1, 12345, 2**31 - 2])
def test_lcg_sequences(seed):
    n = 400
    assert _same_array(lcg.js_lcg_states(seed, n), jlcg.js_lcg_states(seed, n))
    assert _same_array(lcg.js_lcg_uniforms(seed, n), jlcg.js_lcg_uniforms(seed, n))
    assert _same_array(lcg.js_lcg_signs(seed, n), jlcg.js_lcg_signs(seed, n))


@pytest.mark.parametrize("seed", range(3))
def test_crc32(seed):
    rng = np.random.default_rng(0xC3C + seed)
    for n in (0, 1, 7, 64, 1000, int(rng.integers(1, 5000))):
        data = rng.bytes(n)
        assert crc32.crc32(data) == jcrc32.crc32(data)
        assert crc32.crc32(np.frombuffer(data, np.uint8)) == jcrc32.crc32(np.frombuffer(data, np.uint8))
        if n <= 64:
            assert crc32.crc32_table_driven(data) == jcrc32.crc32_table_driven(data)


@pytest.mark.parametrize("seed", range(3))
def test_reed_solomon(seed):
    rng = np.random.default_rng(0x5EED + seed)
    for n in (1, 100, 223, 224, int(rng.integers(300, 700))):
        data = rng.bytes(n)
        coded = rs.rs_encode(data)
        assert coded == jrs.rs_encode(data)
        rows = rs.codeword_lengths(len(coded))
        assert rows == jrs.codeword_lengths(len(coded))
        inter = rs.interleave(coded, len(rows))
        assert inter == jrs.interleave(coded, len(rows))
        assert rs.deinterleave(inter, len(rows), rows) == jrs.deinterleave(inter, len(rows), rows)
        bad = bytearray(coded)
        for i in rng.choice(len(coded), size=min(8, len(coded)), replace=False):
            bad[int(i)] ^= int(rng.integers(1, 256))
        ers = np.zeros(len(coded), bool)
        ers[rng.choice(len(coded), size=min(4, len(coded)), replace=False)] = True
        for kw in ({}, {"erasures": ers}):
            ours, theirs = _decode_or_error(rs, bytes(bad), kw), _decode_or_error(jrs, bytes(bad), kw)
            assert ours == theirs
        assert rs.rs_decode(coded) == jrs.rs_decode(coded) == (data, 0)
    assert (rs.N, rs.K, rs.NSYM) == (jrs.N, jrs.K, jrs.NSYM)


def _decode_or_error(mod, coded: bytes, kw: dict):
    try:
        return mod.rs_decode(coded, **kw)
    except ValueError as e:
        return str(e)
