"""The JAX package's oracle contract held on the port, on the CPU: the
float64 JS oracle (tests/oracle/jsmodem.py) and the port must agree both
ways at the payload level in the five reference modes, and the port's TX
waveform must match the oracle's within 3e-5 (tests/test_roundtrip.py), and
the randomized (mode, size, name) cases of tests/test_differential_fuzz.py
must cross both ways, drawn from the same generator in the same order.

Each case is the JAX test's own input, asserted as the JAX test asserts it,
and cross-checked against the JAX package on the same samples: equal parse
results (every dataclass field), equal preamble_idx, fine_metric within
1e-5, and TX waveforms within 3e-5. The fuzz adds a third leg: the port's
TX decoded by the JAX package's ``api.decode``."""

import dataclasses

import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import decoder as jdecoder
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu_torch import api, decoder, framing
from audio_modem_tpu_torch.configs import MODES
from tests.oracle import jsmodem as oracle

torch.set_num_threads(2)

# the oracle models the reference, which has no 64-QAM
ALL_MODES = ["QPSK", "16-QAM", "BPSK-ACOUSTIC", "BPSK-REPEAT", "BPSK-NARROW"]
PAYLOAD_SIZES = {"QPSK": 1500, "16-QAM": 3000, "BPSK-ACOUSTIC": 300, "BPSK-REPEAT": 120, "BPSK-NARROW": 48}
CPU = "cpu"


def _payload(n: int, seed: int = 7) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def _same_result(ours, ref) -> None:
    assert type(ours).__name__ == type(ref).__name__, (ours, ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def _same_info(info, rinfo) -> None:
    assert (info is None) == (rinfo is None)
    if info is not None:
        assert info.preamble_idx == rinfo.preamble_idx
        assert abs(info.fine_metric - rinfo.fine_metric) < 1e-5


def _decode_signal(sig: np.ndarray, name: str):
    """decoder.decode_signal in the port, held to the JAX package's."""
    ours, info = decoder.decode_signal(sig, MODES[name], device=CPU)
    ref, rinfo = jdecoder.decode_signal(sig, JMODES[name])
    _same_result(ours, ref)
    _same_info(info, rinfo)
    return ours, info


def _near(ours: torch.Tensor, ref: np.ndarray, tol: float = 3e-5) -> None:
    assert ours.shape == ref.shape
    err = np.abs(ours.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max()
    assert err < tol, f"max abs waveform diff {err}"


@pytest.mark.parametrize("mode_name", ALL_MODES)
class TestLegacyFrame:
    def test_tx_waveform_matches_oracle(self, mode_name):
        data = _payload(PAYLOAD_SIZES[mode_name])
        ours = framing.build_transmit_signal(data, MODES[mode_name], "t.bin", device=CPU)
        _near(ours, oracle.build_transmit_signal(data, mode_name, "t.bin"))
        _near(ours, jframing.build_transmit_signal(data, JMODES[mode_name], "t.bin"))

    def test_port_decodes_oracle_signal(self, mode_name):
        data = _payload(PAYLOAD_SIZES[mode_name], seed=11)
        sig = oracle.build_transmit_signal(data, mode_name, "hello.bin")
        result, info = _decode_signal(sig, mode_name)
        assert isinstance(result, framing.LegacyFrame), getattr(result, "error", result)
        assert result.crc_valid and result.data == data and result.file_name == "hello.bin"
        assert info.fine_metric > 0.8

    def test_oracle_decodes_port_signal(self, mode_name):
        data = _payload(PAYLOAD_SIZES[mode_name], seed=13)
        sig = framing.build_transmit_signal(data, MODES[mode_name], "x.bin", device=CPU).numpy()
        res = oracle.decode_received_signal(sig, mode_name)
        assert res.get("error") is None, res
        assert res["crc_valid"] and res["data"] == data

    def test_port_self_roundtrip(self, mode_name):
        data = _payload(PAYLOAD_SIZES[mode_name], seed=17)
        sig = framing.build_transmit_signal(data, MODES[mode_name], "y.bin", device=CPU).numpy()
        result, _ = _decode_signal(sig, mode_name)
        assert isinstance(result, framing.LegacyFrame)
        assert result.crc_valid and result.data == data


@pytest.mark.parametrize("mode_name", ["QPSK", "BPSK-NARROW"])
class TestChunkFrames:
    def test_metadata_frame_cross(self, mode_name):
        mode = MODES[mode_name]
        sig = oracle.build_metadata_frame(42, 99999, mode.chunk_size, "file.zip", mode_name)
        result, _ = _decode_signal(sig, mode_name)
        assert isinstance(result, framing.MetaFrame), getattr(result, "error", result)
        assert result.crc_valid
        assert (result.total_chunks, result.total_file_size, result.chunk_size) == (42, 99999, mode.chunk_size)
        assert result.file_name == "file.zip"

    def test_data_frame_cross_both_ways(self, mode_name):
        mode = MODES[mode_name]
        chunk = _payload(min(mode.chunk_size, 256), seed=19)
        # oracle TX -> the port's full-signal decode
        result, _ = _decode_signal(oracle.build_data_chunk_frame(chunk, 7, mode_name), mode_name)
        assert isinstance(result, framing.DataFrame), getattr(result, "error", result)
        assert result.crc_valid and result.seq_num == 7 and result.data == chunk
        # the port's TX -> the oracle's chunk-frame decode (the streaming path's shape)
        sig2 = framing.build_data_chunk_frame(chunk, 9, mode, device=CPU)
        _near(sig2, jframing.build_data_chunk_frame(chunk, 9, JMODES[mode_name]))
        res = oracle.decode_chunk_frame(sig2.numpy()[mode.profile.silence_pre_chunk(False) :], mode_name)
        assert res.get("error") is None and res["crc_valid"] and res["seq"] == 9

    def test_port_chunk_frame_decode(self, mode_name):
        """decode_chunk_frame on a frame starting at preamble sample 0."""
        mode = MODES[mode_name]
        chunk = _payload(128, seed=23)
        sig = framing.build_data_chunk_frame(chunk, 3, mode, device=CPU).numpy()[mode.profile.silence_pre_chunk(False) :]
        result = decoder.decode_chunk_frame(sig, mode, device=CPU)
        _same_result(result, jdecoder.decode_chunk_frame(sig, JMODES[mode_name]))
        assert isinstance(result, framing.DataFrame), getattr(result, "error", result)
        assert result.crc_valid and result.seq_num == 3 and result.data == chunk


class TestErrorPaths:
    def test_no_preamble(self):
        sig = np.random.default_rng(0).standard_normal(40000).astype(np.float32) * 0.1
        result, info = _decode_signal(sig, "QPSK")
        assert isinstance(result, framing.FrameError) and info is None
        assert "Preamble not detected" in result.error

    def test_corrupted_payload_fails_crc(self):
        data = _payload(500, seed=29)
        sig = oracle.build_transmit_signal(data, "QPSK", "c.bin").copy()
        # a region inside the data symbols, smashed hard enough to flip bits
        p = MODES["QPSK"].profile
        start = p.silence_pre_legacy() + 4 * p.symbol_len
        sig[start : start + 3 * p.symbol_len] = 0.0
        mode = MODES["QPSK"]
        result, info = decoder.decode_signal(sig, mode, device=CPU)
        assert not (isinstance(result, framing.LegacyFrame) and result.crc_valid)
        # The JAX package fails the same way. Data symbols 1-3 now hold zeros, and
        # their decisions are ties that rounding breaks (junk), so the bytes they
        # carry are left out of the comparison.
        ref, rinfo = jdecoder.decode_signal(sig, JMODES["QPSK"])
        _same_info(info, rinfo)
        assert type(result).__name__ == type(ref).__name__ == "LegacyFrame" and not ref.crc_valid
        assert (result.file_name, result.expected_crc) == (ref.file_name, ref.expected_crc)
        head = 1 + len("c.bin") + 4  # name length, name, data length
        lo, hi = mode.bits_per_symbol // 8 - head, -(-4 * mode.bits_per_symbol // 8) - head
        assert len(result.data) == len(ref.data) == len(data)
        assert result.data[:lo] == ref.data[:lo] == data[:lo]
        assert result.data[hi:] == ref.data[hi:] == data[hi:]


def _fuzz_cases() -> list:
    """tests/test_differential_fuzz.py's cases with the inputs its module
    generator gives them when they run in order: (mode, size, data, name)."""
    rng = np.random.default_rng(0xA0D10)
    cases = []
    for mode_name, sizes in {
        "QPSK": (1, 13, 257, 1999),
        "16-QAM": (5, 300, 2500),
        "BPSK-ACOUSTIC": (1, 80, 333),
        "BPSK-REPEAT": (7, 120),
        "BPSK-NARROW": (3, 40),
    }.items():
        for size in sizes:
            data = rng.bytes(size)
            name_len = int(rng.integers(1, 40))
            name = "".join(chr(c) for c in rng.integers(97, 123, name_len))
            cases.append(pytest.param(mode_name, size, data, name, id=f"{mode_name}-{size}"))
    return cases


@pytest.mark.parametrize("mode_name, size, data, name", _fuzz_cases())
def test_differential_roundtrip(mode_name, size, data, name):
    assert len(data) == size
    # the port's TX -> oracle RX
    sig = api.encode_legacy(data, mode_name, name, device=CPU).numpy()
    _near(torch.from_numpy(sig), japi.encode_legacy(data, mode_name, name))
    res = oracle.decode_received_signal(sig, mode_name)
    assert res.get("error") is None, (mode_name, size, res)
    assert res["crc_valid"] and res["data"] == data and res["file_name"] == name

    # oracle TX -> the port's RX
    sig2 = oracle.build_transmit_signal(data, mode_name, name)
    result, _ = api.decode(sig2, mode_name, device=CPU)
    assert isinstance(result, framing.LegacyFrame), (mode_name, size, getattr(result, "error", None))
    assert result.crc_valid and result.data == data and result.file_name == name

    # the port's TX -> the JAX package's RX, beside the port's own RX
    ours, info = api.decode(sig, mode_name, device=CPU)
    ref, rinfo = japi.decode(sig, mode_name)
    _same_result(ours, ref)
    assert isinstance(ref, jframing.LegacyFrame) and ref.crc_valid and ref.data == data and ref.file_name == name
    _same_info(info, rinfo)
