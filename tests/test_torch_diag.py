"""The port's diag.py, parallel/batch.batch_loopback_step and utils/plots.py
against the JAX package's (device="cpu"), on the same numpy inputs.

Tolerances: test signal 3e-5 (the TX tolerance, COVERAGE.md #12); the
loopback report's detected, ber, quality and recommended mode equal,
correlation within 1e-5, |H| within 1e-4, the SNR estimate within 1e-3 dB,
EVM within 1e-4. The BER curves draw their noise from different RNGs, so
each point is held within a binomial band of the JAX curve (see
``_binomial_band``); the loopback step's deterministic part (the port's
drawn noise through the JAX package's phy pipeline) is held bit for bit."""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import diag as jdiag
from audio_modem_tpu import phy as jphy
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu_torch import channel, diag, phy
from audio_modem_tpu_torch.configs import MODES, OFDM_PROFILES
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.utils import plots

torch.set_num_threads(2)

TX_TOL = 3e-5


def test_sweep_tone_identical():
    for kw in ({}, {"duration": 0.5}, {"start_freq": 500.0, "end_freq": 3000.0, "duration": 0.3}):
        assert np.array_equal(diag.generate_sweep_tone(**kw), jdiag.generate_sweep_tone(**kw))


@pytest.mark.parametrize("name", ["QPSK", "BPSK-ACOUSTIC", "BPSK-NARROW"])
def test_test_signal_within_tx_tolerance(name):
    sig, payload = diag.generate_test_signal(MODES[name], device="cpu")
    ref, ref_payload = jdiag.generate_test_signal(JMODES[name])
    assert payload == ref_payload and sig.shape == ref.shape
    assert np.abs(sig.numpy() - ref).max() <= TX_TOL


def _same_report(ours, ref) -> None:
    assert (ours.detected, ours.ber, ours.quality, ours.recommended_mode) == (
        ref.detected, ref.ber, ref.quality, ref.recommended_mode)
    assert abs(ours.correlation - ref.correlation) <= 1e-5
    assert ours.channel_magnitude.shape == np.asarray(ref.channel_magnitude).shape
    if len(ref.channel_magnitude):
        assert np.abs(ours.channel_magnitude - np.asarray(ref.channel_magnitude)).max() <= 1e-4
    assert ours.snr_estimate_db == ref.snr_estimate_db or abs(ours.snr_estimate_db - ref.snr_estimate_db) <= 1e-3
    assert (ours.evm is None) == (ref.evm is None)
    if ref.evm is not None:
        assert abs(ours.evm - ref.evm) <= 1e-4


def _recording(name: str, kind: str) -> np.ndarray:
    sig, _ = jdiag.generate_test_signal(JMODES[name])
    sig = np.array(sig, np.float32)
    rng = np.random.default_rng(9)
    if kind == "noisy":
        return (0.4 * sig + rng.standard_normal(len(sig)).astype(np.float32) * 0.02).astype(np.float32)
    if kind == "garbage":
        return rng.standard_normal(30000).astype(np.float32) * 0.05
    return sig


@pytest.mark.parametrize("name, kind", [
    ("QPSK", "clean"), ("QPSK", "noisy"), ("QPSK", "garbage"), ("BPSK-REPEAT", "clean"),
])
def test_analyze_loopback_matches(name, kind):
    rec = _recording(name, kind)
    ours = diag.analyze_loopback(rec, MODES[name], device="cpu")
    ref = jdiag.analyze_loopback(rec, JMODES[name])
    _same_report(ours, ref)
    if kind == "clean":
        assert ours.quality == "excellent" and ours.ber == 0.0 and ours.evm < 0.02
    if kind == "garbage":
        assert ours.quality == "poor" and ours.recommended_mode == "BPSK-REPEAT"
    # a tensor on the device is taken as well
    again = diag.analyze_loopback(torch.from_numpy(rec), MODES[name], device="cpu")
    assert dataclasses.asdict(again).keys() == dataclasses.asdict(ours).keys() and again.ber == ours.ber


def test_analyze_loopback_too_short_for_ce():
    """A preamble with no room for the CE symbol after it."""
    sig = _recording("QPSK", "clean")
    p = MODES["QPSK"].profile
    cut = sig[: p.silence_pre_legacy() + 2 * p.symbol_len + 100]
    _same_report(diag.analyze_loopback(cut, MODES["QPSK"], device="cpu"), jdiag.analyze_loopback(cut, JMODES["QPSK"]))


def test_analyze_input_bitmap_and_rate_info_equal():
    rng = np.random.default_rng(2)
    for rec in (0.3 * np.sin(2 * np.pi * 1000 * np.arange(44100) / 44100), rng.standard_normal(1500) * 0.95,
                np.full(5000, 0.99)):
        ours, ref = diag.analyze_input(rec.astype(np.float32)), jdiag.analyze_input(rec.astype(np.float32))
        for f in dataclasses.fields(ours):
            assert np.array_equal(getattr(ours, f.name), getattr(ref, f.name)), f.name
    for bm in (np.zeros(100, bool), np.r_[np.ones(50, bool), np.zeros(50, bool)], rng.random(37) > 0.3,
               np.zeros(0, bool)):
        for width in (10, 64):
            assert diag.render_chunk_bitmap(bm, width) == jdiag.render_chunk_bitmap(bm, width)
    for name in MODES:
        for dur in (60.0, 120.0, 1.0):
            assert dataclasses.asdict(diag.rate_info(MODES[name], dur)) == dataclasses.asdict(
                jdiag.rate_info(JMODES[name], dur))


@pytest.mark.parametrize("spec", [None, channel.ChannelSpec(snr_db=20.0, gain=0.5, multipath=((50, 0.3),))],
                         ids=["clean", "channel"])
def test_live_loopback_diagnosis_matches(spec):
    """Both packages' duplex pre-test over a pipe; the injected channel is
    the port's apply_channel_np (CPU, seeded), the same callable for both,
    so both record the same noise."""
    fn = None if spec is None else (lambda s: channel.apply_channel_np(s, spec, seed=4, device="cpu"))
    levels = []
    ours = diag.live_loopback_diagnosis(MODES["QPSK"], fn, block=2048, on_level=lambda m, n: levels.append(n),
                                        device="cpu")
    ref = jdiag.live_loopback_diagnosis(JMODES["QPSK"], fn, block=2048)
    assert (ours.samples_played, ours.samples_recorded) == (ref.samples_played, ref.samples_recorded)
    assert ours.samples_recorded == ours.samples_played and levels[-1] == ours.samples_recorded
    _same_report(ours.loopback, ref.loopback)
    for f in ("rms", "peak", "noise_floor"):
        assert abs(getattr(ours.input, f) - getattr(ref.input, f)) <= 1e-4
    assert ours.input.clipping == ref.input.clipping
    assert ours.loopback.detected and ours.loopback.ber == 0.0


@pytest.mark.parametrize("name, snr", [("QPSK", 4.0), ("BPSK-ACOUSTIC", -2.0)])
def test_loopback_step_deterministic_part(name, snr):
    """The port's step, and the noise it drew (the same generator seed
    again) added to the port's TX, through the JAX package's estimate and
    demod: out_bits and BER equal."""
    mode = MODES[name]
    p = mode.profile
    n_sym = 4
    bits = np.random.default_rng(3).integers(0, 2, (4, n_sym * mode.bits_per_symbol), dtype=np.int8)
    gen = torch.Generator().manual_seed(11)
    ber, out = batch.batch_loopback_step(torch.from_numpy(bits), gen, mode, n_sym, snr)
    syms = phy.modulate(torch.from_numpy(bits), mode).reshape(4, -1)
    ce = torch.from_numpy(p.ce_symbol.astype(np.float32)).expand(4, p.symbol_len)
    rx = channel.awgn(torch.cat([ce, syms], -1), snr, torch.Generator().manual_seed(11)).numpy()
    jp = JMODES[name].profile
    ch_re, ch_im = jphy.estimate_channel(jnp.asarray(rx[:, : p.symbol_len]), jp)
    ref = np.asarray(jphy.demodulate(jnp.asarray(rx[:, p.symbol_len :].reshape(-1, n_sym, p.symbol_len)),
                                     ch_re, ch_im, JMODES[name]))
    assert np.array_equal(out.numpy(), ref)
    assert float(ber) == float(np.abs(ref.astype(np.float32) - bits).mean())
    assert 0.0 < float(ber) < 0.5


def _binomial_band(p_ref: float, n: int) -> float:
    """Half-width of the band two independent BER estimates stay within
    around the JAX curve's point: 5 standard deviations of the difference
    of two binomial estimates over ``n`` independent draws, plus 5 draws.
    The draws are the channel estimates, one per data bin of each stream
    (every symbol of a stream shares its bin's noisy estimate, so its bits
    err together), not the bits."""
    pq = max(p_ref * (1.0 - p_ref), 1.0 / n)
    return 5.0 * (2.0 * pq / n) ** 0.5 + 5.0 / n


def test_ber_vs_snr_within_a_binomial_band():
    snrs = (-5.0, 0.0, 5.0, 10.0, 30.0)
    kw = dict(n_streams=8, n_sym=8, seed=1)
    ours = diag.ber_vs_snr(MODES["QPSK"], snrs_db=snrs, device="cpu", **kw)
    ref = jdiag.ber_vs_snr(JMODES["QPSK"], snrs_db=snrs, **kw)
    assert list(ours) == list(ref) == list(snrs)
    n = 8 * MODES["QPSK"].profile.num_data_subs
    for s in snrs:
        assert abs(ours[s] - ref[s]) <= _binomial_band(ref[s], n), (s, ours[s], ref[s])
    assert ours[30.0] == ref[30.0] == 0.0 and ours[-5.0] > 0.05
    assert ours[-5.0] >= ours[5.0] >= ours[30.0]


def test_repetition_ber_vs_snr_within_a_binomial_band():
    snrs = (-4.0, 0.0, 8.0)
    kw = dict(n_streams=8, n_sym=12, seed=2)
    ours = diag.repetition_ber_vs_snr(MODES["BPSK-REPEAT"], snrs_db=snrs, device="cpu", **kw)
    ref = jdiag.repetition_ber_vs_snr(JMODES["BPSK-REPEAT"], snrs_db=snrs, **kw)
    assert list(ours) == list(ref) == list(snrs)
    n = 8 * MODES["BPSK-REPEAT"].profile.num_data_subs
    for s in snrs:
        for k in (0, 1):  # hard vote, soft combining
            assert abs(ours[s][k] - ref[s][k]) <= _binomial_band(ref[s][k], n), (s, k, ours[s], ref[s])
    assert ours[8.0] == (0.0, 0.0)
    assert ours[-4.0][1] <= ours[-4.0][0]  # soft combining never loses to the vote on average


def test_diag_defaults_to_the_card():
    import inspect

    for fn in (diag.generate_test_signal, diag.analyze_loopback, diag.ber_vs_snr, diag.repetition_ber_vs_snr,
               diag.live_loopback_diagnosis):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diag.analyze_loopback(np.zeros(4000, np.float32), MODES["QPSK"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            diag.ber_vs_snr(MODES["QPSK"], snrs_db=(10.0,))


def test_plots_write_pngs(tmp_path):
    p = OFDM_PROFILES["standard"]
    rng = np.random.default_rng(0)
    files = [
        plots.plot_spectrum(rng.uniform(-80, -20, 1024), np.linspace(0, 22050, 1024), str(tmp_path / "s.png"), p),
        plots.plot_spectrum(rng.uniform(-80, -20, 64), np.linspace(0, 22050, 64), str(tmp_path / "s2.png")),
        plots.plot_channel_response(rng.uniform(0, 1, p.num_active_subs), p, str(tmp_path / "c.png")),
        plots.plot_waveform(rng.standard_normal(20000).astype(np.float32), str(tmp_path / "w.png")),
        plots.plot_ber_curve({0.0: 0.1, 10.0: 0.01, 20.0: 0.0}, str(tmp_path / "b.png")),
    ]
    for f in files:
        assert os.path.getsize(f) > 1000
