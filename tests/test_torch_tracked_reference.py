"""The port's timing tracker and clock-offset model against the benchmark's
plain float64 references (``benchmark/reference/tracked.py``,
``benchmark/reference/drift.py``) on the CPU.

A seeded ~2 KB BPSK-REPEAT frame from the port's transmitter, resampled by
the reference at +100 and -100 ppm, under 18 dB AWGN, through
``api.decode(track_timing=True)``: the decode is exact, and the tracker's
call (``decoder._tracked_core``, as ``decode_raw`` makes it) gives the
reference's bits on every symbol of the frame and its final tau within the
``bpsk_repeat_32k_drift`` configuration's ``tau_gap`` limit. The bfloat16
control through the same reference goes over one of the tracker's limits.
The reference's resampler equals the port's ``channel.clock_drift`` within
what the port's float32 sample positions allow."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from audio_modem_tpu_torch import api, channel, decoder, framing  # noqa: E402
from audio_modem_tpu_torch.configs import MODES  # noqa: E402
from benchmark.reference import drift, oracle, tracked  # noqa: E402

torch.set_num_threads(2)

LIMITS = json.loads((ROOT / "benchmark" / "configs" / "bpsk_repeat_32k_drift.json").read_text())["limits"]
MODE = "BPSK-REPEAT"
NAME = "t.bin"


def _recording(seed: int, ppm: float, n_bytes: int = 2048, snr_db: float | None = 18.0) -> tuple[np.ndarray, bytes]:
    rng = np.random.default_rng(seed)
    data = rng.bytes(n_bytes)
    x = framing.build_transmit_signal(data, MODES[MODE], NAME, device="cpu").to(torch.float64)
    y = drift.clock_drift(x[None], ppm)[0]
    if snr_db is None:
        return y.to(torch.float32).numpy(), data
    noise = torch.from_numpy(rng.standard_normal(y.shape[0])) * ((y * y).mean() / 10 ** (snr_db / 10)).sqrt()
    return (y + noise).to(torch.float32).numpy(), data


def _tracked_call(sig: np.ndarray, monkeypatch) -> tuple:
    """``api.decode`` of ``sig`` with the tracker on: the result, and the
    tracker's one call (its arguments by name, bits, final tau)."""
    calls = []
    real = decoder._tracked_core

    def tap(signal, n_valid, start, mode, n_sym, n_valid_sym):
        bits, tau = real(signal, n_valid, start, mode, n_sym, n_valid_sym)
        calls.append(({"x": signal.clone(), "n_valid": n_valid, "start": start, "n_sym": n_sym,
                       "n_valid_sym": n_valid_sym}, bits, float(tau)))
        return bits, tau

    monkeypatch.setattr(decoder, "_tracked_core", tap)
    result, _ = api.decode(sig, MODE, track_timing=True, device="cpu")
    assert len(calls) == 1
    return result, calls[0]


def _reference(call: dict, prec=oracle.REFERENCE) -> tuple[torch.Tensor, float]:
    bits, tau = tracked.demodulate(
        call["x"][None].to(torch.float64), torch.tensor([call["n_valid"]]), torch.tensor([call["start"]]),
        torch.tensor([call["n_sym"]]), MODE, prec, torch.tensor([call["n_valid_sym"]]))
    return bits[0], float(tau[0])


def _signal_bits(data: bytes) -> int:
    return tracked.signal_symbols(len(oracle.legacy_payload(data, NAME)), MODE) * MODES[MODE].bits_per_symbol


@pytest.mark.parametrize("ppm", [100.0, -100.0])
def test_the_tracker_matches_the_float64_reference(ppm, monkeypatch):
    sig, data = _recording(7 if ppm > 0 else 8, ppm)
    result, (call, bits, tau) = _tracked_call(sig, monkeypatch)
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid and result.data == data
    n = _signal_bits(data)
    assert call["n_valid_sym"] * MODES[MODE].bits_per_symbol == n  # the frame's own symbols, from its header
    ref_bits, ref_tau = _reference(call)
    assert torch.equal(bits[:n].to(torch.int64), ref_bits[:n])
    assert abs(tau - ref_tau) <= LIMITS["tau_gap"], (tau, ref_tau)
    assert abs(ref_tau) > 40  # ~0.5 M samples at 100 ppm: the loop followed the drift


def test_the_control_goes_over_a_tracker_limit(monkeypatch):
    sig, data = _recording(7, 100.0)
    _, (call, _, _) = _tracked_call(sig, monkeypatch)
    n = _signal_bits(data)
    ref_bits, ref_tau = _reference(call)
    ctl_bits, ctl_tau = _reference(call, oracle.CONTROL)
    bit_gap = float((ctl_bits[:n] != ref_bits[:n]).sum()) / n
    assert abs(ctl_tau - ref_tau) > LIMITS["tau_gap"] or bit_gap > LIMITS["track_bit_gap"], (ctl_tau, ref_tau)


def test_the_bound_is_the_frame_length_its_header_states():
    """``decode_raw`` and the chunk path's tracked rung bound the timing
    measurement by the untracked header: a legacy frame's and a data
    chunk's symbol count, never past ``n_max`` (the recording's, or the
    bucket's), and the caller's fallback where no header reads."""
    mode = MODES[MODE]
    legacy = oracle.legacy_payload(bytes(1000), NAME)
    assert decoder._header_symbols(legacy, mode, 10_000, 9) == framing.num_symbols_for_payload(len(legacy), mode)
    assert decoder._header_symbols(legacy, mode, 50, 9) == 50
    chunk = bytes([0xFF, 0, 0, 0, 3, 0x02, 0x00]) + bytes(512 + 4)
    assert decoder._header_symbols(chunk, mode, 10_000, 9) == framing.num_symbols_for_payload(11 + 512, mode)
    assert decoder._header_symbols(chunk, mode, 40, 9) == 40
    assert decoder._header_symbols(bytes([9, 1, 2]), mode, 77, 60) == 60
    assert decoder._header_symbols(b"", mode, 77, 60) == 60


@pytest.mark.parametrize("seed, ppm", [(2, -45.0), (16, -100.0)])
def test_an_8kb_frame_the_unbounded_loop_loses_decodes_exact(seed, ppm, monkeypatch):
    """An 8 KB frame (~2 M samples): the loop measured over the symbols
    past the frame as well, as it was before the header bound, loses it;
    bounded by the header it decodes exact, and the tracker's call gives
    the reference's bits on the frame's symbols and its tau within the
    cell's limit."""
    sig, data = _recording(seed, ppm, n_bytes=8192)
    result, (call, bits, tau) = _tracked_call(sig, monkeypatch)
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid and result.data == data
    n = _signal_bits(data)
    assert call["n_valid_sym"] * MODES[MODE].bits_per_symbol == n < call["n_sym"] * MODES[MODE].bits_per_symbol
    ref_bits, ref_tau = _reference(call)
    assert torch.equal(bits[:n].to(torch.int64), ref_bits[:n])
    assert abs(tau - ref_tau) <= LIMITS["tau_gap"], (tau, ref_tau)
    monkeypatch.setattr(decoder, "_header_symbols", lambda by, mode, n_max, fallback: None)
    lost, _ = api.decode(sig, MODE, track_timing=True, device="cpu")
    assert not (getattr(lost, "crc_valid", False) and getattr(lost, "data", None) == data)


@pytest.mark.parametrize("ppm", [100.0, -45.0])
def test_the_resampler_matches_the_port_clock_drift(ppm):
    """Equal within what the port's float32 sample positions allow: the
    port's position of output sample ``n`` is off by up to half a float32
    ulp of ``n (1 + ppm 1e-6)``, and a clean frame, bandlimited below a fifth
    of the sample rate, moves by less than pi max|x| a sample (Bernstein's
    inequality), so the gap at ``n`` is within pi max|x| ulp / 2, plus 1e-5
    for the float32 sum of 65 products."""
    sig, _ = _recording(3, 0.0, n_bytes=600, snr_db=None)
    x = torch.from_numpy(sig)
    want = drift.clock_drift(x[None].to(torch.float64), ppm)[0]
    got = channel.clock_drift(x, ppm).to(torch.float64)
    pos = np.arange(x.shape[0], dtype=np.float64) * (1 + ppm * 1e-6)
    bound = np.pi * float(x.abs().max()) * np.spacing(pos.astype(np.float32)).astype(np.float64) / 2 + 1e-5
    gap = (got - want).abs().numpy()
    assert (gap <= bound).all(), float((gap / bound).max())
    assert gap.max() > 1e-4  # the frame's far end: the port's float32 positions show
