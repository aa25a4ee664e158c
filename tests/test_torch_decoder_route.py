"""The single-signal decoder's device core: ``decoder._core_dispatch`` runs
kernel A (``kernels.receive.decode_fused``) as a batch of one at every
length, once per try of ``decode_raw``'s resume loop, and never
``decode_long_fused``. The JAX package routes a signal its VMEM gate
(``fused_receive_fits``) admits to its kernel A and a longer one to its
``decode_long_fused``; both are decision-identical, so on the CPU the
port's decode equals the JAX package's ``decode_raw`` on either side of
that gate, in each of the three profiles, and equals bit for bit what the
port gave through ``decode_long_fused``."""

import dataclasses

import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import decoder as jdecoder
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.kernels.receive import fused_receive_fits
from audio_modem_tpu_torch import api, decoder, framing, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import receive

torch.set_num_threads(2)

# (mode, payload bytes, whether the JAX package's kernel A admits the padded
# signal): one frame on each side of the gate in each profile (standard 576 /
# 64, acoustic 640 / 128, narrowband 768 / 256)
GATE_CASES = [
    ("16-QAM", 2000, True),
    ("QPSK", 20000, False),
    ("BPSK-ACOUSTIC", 1000, True),
    ("BPSK-ACOUSTIC", 2600, False),
    ("BPSK-NARROW", 100, True),
    ("BPSK-NARROW", 300, False),
]


def _awgn(x: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    power = float(np.mean(x.astype(np.float64) ** 2))
    return (x + rng.standard_normal(x.shape) * np.sqrt(power / 10 ** (snr_db / 10))).astype(np.float32)


def _frame(name: str, size: int, seed: int = 3) -> tuple[np.ndarray, bytes]:
    payload = np.random.default_rng(seed).bytes(size)
    tx = framing.build_transmit_signal(payload, MODES[name], "r.bin", device="cpu").numpy()
    return _awgn(tx, 20.0, seed), payload


def _decoy_frame() -> tuple[np.ndarray, bytes]:
    """A QPSK frame behind a lag-periodic decoy (a tone at inactive bin 4),
    as in test_torch_edge_cases.py: the scan commits in the decoy, the refine
    rejects it, and the resume loop scans again past it."""
    p = MODES["QPSK"].profile
    payload = np.random.default_rng(11).bytes(400)
    tx = framing.build_transmit_signal(payload, MODES["QPSK"], "d.bin", device="cpu").numpy()
    t = np.arange(2 * p.fft_size)
    decoy = (0.4 * np.sin(2 * np.pi * 4 * t / p.fft_size)).astype(np.float32)
    return np.concatenate([decoy, np.zeros(2 * p.fft_size, np.float32), tx]), payload


@pytest.fixture
def tries(monkeypatch) -> list:
    """Every call of kernel A from the decoder, as (shape, min_pos, coarse,
    fine_metric); ``decode_long_fused`` raises if anything calls it."""
    calls = []
    real = receive.decode_fused

    def spy(signals, n_valid, min_pos, mode, max_syms):
        out = real(signals, n_valid, min_pos, mode, max_syms)
        calls.append((tuple(signals.shape), int(min_pos[0]), int(out["coarse"][0]), float(out["fine_metric"][0])))
        return out

    def never(*args, **kw):
        raise AssertionError("decode_long_fused called on the decoder's path")

    monkeypatch.setattr(receive, "decode_fused", spy)
    monkeypatch.setattr(decoder, "decode_fused", spy)
    monkeypatch.setattr(receive, "decode_long_fused", never)
    return calls


def _check_tries(calls: list, mode, n_valid: int) -> None:
    """One call per try of decode_raw's loop, each on the padded signal as
    a batch of one: a try follows only a detected peak whose refine stays
    below threshold, and resumes one DFT length past it."""
    assert calls
    assert all(shape == (1, decoder._bucket_len(n_valid)) for shape, *_ in calls)
    assert calls[0][1] == 0
    for (_, _, coarse, fine), (_, min_pos, _, _) in zip(calls, calls[1:]):
        assert coarse >= 0 and fine < sync.XCORR_THRESHOLD
        assert min_pos == coarse + mode.profile.fft_size
    _, _, coarse, fine = calls[-1]
    assert len(calls) == 4 or coarse < 0 or fine >= sync.XCORR_THRESHOLD


@pytest.mark.parametrize("case", ["16-QAM 2000 B", "QPSK 20000 B", "xcorr", "decoy"])
def test_decoder_routes_every_try_through_kernel_a(tries, case):
    """16-QAM at 2,000 B lies below the JAX package's gate, QPSK at 20,000 B
    above it; at 3 dB ("xcorr") the Schmidl-Cox scan finds nothing on the
    one try and the xcorr re-acquisition decodes the frame as a chunk frame;
    the decoy takes more than one try, each later one with min_pos > 0."""
    if case == "xcorr":
        name = "BPSK-REPEAT"
        payload = np.random.default_rng(42).bytes(96)
        sig = _awgn(framing.build_transmit_signal(payload, MODES[name], "f.bin", device="cpu").numpy(), 3.0, 2)
        want_tries = 1
    elif case == "decoy":
        name = "QPSK"
        sig, payload = _decoy_frame()
        want_tries = None
    else:
        name, size = case.split(" ")[0], int(case.split(" ")[1])
        sig, payload = _frame(name, size)
        want_tries = 1
    mode = MODES[name]
    result, info = api.decode(sig, mode, device="cpu")
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid and result.data == payload
    _check_tries(tries, mode, len(sig))
    if case == "xcorr":
        assert tries[0][2] == -1 and info.coarse_idx == -1
    if case == "decoy":
        assert len(tries) >= 2 and tries[-1][3] >= sync.XCORR_THRESHOLD and info.coarse_idx == tries[-1][2]
        want_tries = len(tries)
    assert len(tries) == want_tries, tries
    tries.clear()
    raw, _ = decoder.decode_raw(sig, mode, device="cpu")
    assert len(tries) == want_tries
    if case == "xcorr":
        assert isinstance(raw, framing.FrameError) and raw.error == "Preamble not detected"
    else:
        assert isinstance(raw, bytes)


@pytest.mark.parametrize("name, size, fits", GATE_CASES)
def test_decode_matches_jax_on_both_sides_of_its_gate(monkeypatch, name, size, fits):
    """The port's decode on the CPU equals the JAX package's on the CPU:
    decode_raw's payload bytes, preamble_idx and coarse_idx equal,
    fine_metric within 1e-5, api.decode's frames equal; and the route
    through kernel A gives bit for bit what ``decode_long_fused`` gave. The
    raw bytes past the frame's payload demodulate the noise after it: junk
    that no caller reads, whose decisions rounding may break apart."""
    mode, jmode = MODES[name], JMODES[name]
    sig, payload = _frame(name, size)
    pad = decoder._bucket_len(len(sig))
    assert fused_receive_fits(pad, jmode, decoder._max_symbols(pad, mode)) == fits

    raw, info = decoder.decode_raw(sig, mode, device="cpu")
    jraw, jinfo = jdecoder.decode_raw(sig, jmode)
    wire = framing.build_legacy_payload(payload, "r.bin")
    assert isinstance(raw, bytes) and len(raw) == len(jraw) and raw[: len(wire)] == jraw[: len(wire)] == wire
    assert (info.preamble_idx, info.coarse_idx) == (jinfo.preamble_idx, jinfo.coarse_idx)
    assert abs(info.fine_metric - jinfo.fine_metric) < 1e-5

    result, rinfo = api.decode(sig, mode, device="cpu")
    jresult, _ = japi.decode(sig, jmode)
    assert type(result).__name__ == type(jresult).__name__
    assert dataclasses.asdict(result) == dataclasses.asdict(jresult)
    assert result.crc_valid and result.data == payload and rinfo.preamble_idx == info.preamble_idx

    monkeypatch.setattr(decoder, "decode_fused", receive.decode_long_fused)
    long_raw, long_info = decoder.decode_raw(sig, mode, device="cpu")
    assert long_raw == raw
    assert (long_info.preamble_idx, long_info.coarse_idx, long_info.fine_metric) == (
        info.preamble_idx, info.coarse_idx, info.fine_metric)
    assert np.array_equal(long_info.channel_mag, info.channel_mag)
