"""The port's single-signal decode path against the JAX package on the same
numpy signals: api.decode / decoder.decode_signal through every rung of the
retry ladder (clean frames, soft repetition combining, FEC erasures from
EVM, xcorr re-acquisition, timing tracking), decode_chunk_frame, the
single-frame TX within 3e-5, and the phy / sync / bits tools the ladder
uses. Noise and clock drift come from the port's channel module, and
both packages decode the same samples.

Parse result type, crc_valid, bytes, preamble_idx and coarse_idx must be
equal; fine_metric within 1e-5."""

import dataclasses
import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import phy as jphy, sync as jsync
from audio_modem_tpu import decoder as jdecoder
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.ops import bits as jbits
from audio_modem_tpu_torch import api, channel, decoder, framing, phy, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.ops.bits import soft_combine
from audio_modem_tpu_torch.utils.wav import read_wav

torch.set_num_threads(2)


def _j(mode):
    """The JAX package's mode of the same name as the port's ``mode``."""
    return JMODES[mode.name]


def _same_result(ours, ref) -> None:
    assert type(ours).__name__ == type(ref).__name__, (ours, ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def _same_decode(signal: np.ndarray, mode, **kw) -> tuple:
    """Decode with both packages; hold results and sync info equal."""
    ref, rinfo = japi.decode(signal, _j(mode), **kw)
    ours, info = api.decode(signal, mode, device="cpu", **kw)
    _same_result(ours, ref)
    assert (info is None) == (rinfo is None)
    if info is not None:
        assert info.preamble_idx == rinfo.preamble_idx
        assert info.coarse_idx == rinfo.coarse_idx
        assert abs(info.fine_metric - rinfo.fine_metric) < 1e-5
        if rinfo.channel_mag is not None:
            assert np.abs(info.channel_mag - rinfo.channel_mag).max() < 1e-4
    return ours, info


@pytest.mark.parametrize("name", ["QPSK", "16-QAM"])
def test_clean_legacy_frame(name):
    mode = MODES[name]
    data = np.random.default_rng(12).bytes(2000)
    sig = japi.encode_legacy(data, _j(mode), "c.bin")
    ours_tx = api.encode(data, mode, "c.bin", device="cpu")
    assert len(ours_tx) == 1 and np.abs(ours_tx[0].numpy() - sig).max() < 3e-5
    result, _ = _same_decode(sig, mode)
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid and result.data == data


def test_soft_retry_rescues_bpsk_repeat():
    """AWGN at -1 dB on the data region (seed 17) breaks the hard
    majority vote; the soft combining retry recovers the frame."""
    mode = MODES["BPSK-REPEAT"]
    p = mode.profile
    payload = np.random.default_rng(42).bytes(96)
    sig = np.array(jframing.build_transmit_signal(payload, _j(mode), "f.bin"))
    d0 = p.silence_pre_legacy() + 3 * p.symbol_len
    sig[d0:] = channel.apply_channel_np(sig[d0:], channel.ChannelSpec(snr_db=-1.0), seed=17, device="cpu")
    raw, info = decoder.decode_raw(sig, mode, device="cpu")
    assert info is not None and decoder._parse_failed(framing.parse_payload_bytes(raw))
    result, info = _same_decode(sig, mode)
    assert isinstance(result, framing.LegacyFrame) and result.data == payload
    assert info.coarse_idx >= 0  # decoded at the autocorr sync, not re-acquired


def test_fec_frame_rescued_by_evm_erasures():
    """A 3-symbol dropout and a noise burst on an FEC-wrapped BPSK-ACOUSTIC
    frame (tests/test_fec.py:273) at 30 dB; 5 dropped symbols stay
    uncorrectable."""
    mode = MODES["BPSK-ACOUSTIC"]
    sym = mode.profile.symbol_len
    rng = np.random.default_rng(41)
    payload = rng.bytes(150)
    clean = np.asarray(jframing.build_transmit_signal(payload, _j(mode), "e.bin", fec=True))
    ours = framing.build_transmit_signal(payload, mode, "e.bin", fec=True, device="cpu")
    assert np.abs(ours.numpy() - clean).max() < 3e-5
    # 30 dB of noise gives the Schmidl-Cox plateau a definite peak
    sig = channel.apply_channel_np(clean, channel.ChannelSpec(snr_db=30.0), seed=4, device="cpu")
    _, info = _same_decode(sig, mode)
    s0 = info.preamble_idx + 8 * sym
    for burst in (np.zeros(3 * sym, np.float32), rng.normal(0, 0.3, 3 * sym).astype(np.float32)):
        bad = sig.copy()
        bad[s0 : s0 + 3 * sym] = burst
        result, _ = _same_decode(bad, mode)
        assert isinstance(result, framing.LegacyFrame) and result.data == payload and result.fec_corrected > 0
    bad = sig.copy()
    bad[s0 : s0 + 5 * sym] = 0.0
    result, _ = _same_decode(bad, mode)
    assert isinstance(result, framing.FrameError)


def test_xcorr_reacquisition():
    """At 3 dB (seed 0) the Schmidl-Cox metric stays below threshold; the
    dense xcorr detector re-acquires the frame (tests/test_soft.py:80)."""
    mode = MODES["BPSK-REPEAT"]
    payload = np.random.default_rng(42).bytes(96)
    sig = np.asarray(jframing.build_transmit_signal(payload, _j(mode), "f.bin"))
    noisy = channel.apply_channel_np(sig, channel.ChannelSpec(snr_db=3.0), seed=0, device="cpu")
    result, info = _same_decode(noisy, mode)
    assert isinstance(result, framing.LegacyFrame) and result.data == payload
    assert info.coarse_idx == -1 and info.preamble_idx > 10000


def test_tracked_decode_at_200ppm():
    """track_timing on the 5,200-byte acoustic frame under 200 ppm clock
    drift (tests/test_baseline_configs.py:93-103)."""
    mode = MODES["BPSK-ACOUSTIC"]
    data = np.random.default_rng(11).bytes(5200)
    sig = japi.encode_legacy(data, _j(mode), "d.bin")
    drifted = channel.apply_channel_np(sig, channel.ChannelSpec(clock_ppm=200.0, snr_db=25.0), seed=3, device="cpu")
    result, _ = _same_decode(drifted, mode, track_timing=True)
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid and result.data == data
    # the input needs the tracked rung: without it the frame fails its CRC
    untracked, _ = api.decode(drifted, mode, device="cpu")
    assert not (isinstance(untracked, framing.LegacyFrame) and untracked.crc_valid)


def test_decode_errors_match():
    mode = MODES["QPSK"]
    noise = (np.random.default_rng(5).standard_normal(40000) * 0.05).astype(np.float32)
    result, info = _same_decode(noise, mode)
    assert isinstance(result, framing.FrameError) and info is None
    sig = japi.encode_legacy(b"short", _j(mode), "s.bin")
    cut = sig[: mode.profile.silence_pre_legacy() + 3 * mode.profile.symbol_len + 100]
    _same_decode(cut, mode)


@pytest.mark.parametrize(
    "name, snr, seed",
    [("QPSK", None, 0), ("BPSK-NARROW", -4.0, 6), ("BPSK-NARROW", -3.5, 5)],
)
def test_decode_chunk_frame(name, snr, seed):
    """Aligned chunk frames: clean, and BPSK-NARROW at the noise levels of
    tests/test_soft.py:141 where the soft retry rescues the frame."""
    mode = MODES[name]
    payload = np.random.default_rng(7).bytes(64)
    frame = jframing.build_data_chunk_frame(payload, 3, _j(mode))[mode.profile.silence_pre_chunk(False) :]
    if snr is not None:
        frame = channel.apply_channel_np(np.asarray(frame), channel.ChannelSpec(snr_db=snr), seed=seed, device="cpu")
    ref = jdecoder.decode_chunk_frame(frame, _j(mode))
    ours = decoder.decode_chunk_frame(frame, mode, device="cpu")
    _same_result(ours, ref)
    assert isinstance(ours, framing.DataFrame) and ours.data == payload and ours.seq_num == 3
    _same_result(
        decoder.decode_chunk_frame(frame[:100], mode, device="cpu"), jdecoder.decode_chunk_frame(frame[:100], _j(mode))
    )


@pytest.mark.parametrize("name", sorted(MODES))
def test_single_frame_tx_matches_jax(name):
    mode = MODES[name]
    rng = np.random.default_rng(19)
    data = rng.bytes(300)
    jmode, cpu = _j(mode), "cpu"
    pairs = [
        (framing.build_transmit_signal(data, mode, "t.bin", device=cpu),
         jframing.build_transmit_signal(data, jmode, "t.bin")),
        (framing.build_transmit_signal(data, mode, "t.bin", fec=True, device=cpu),
         jframing.build_transmit_signal(data, jmode, "t.bin", fec=True)),
        (framing.build_metadata_frame(7, 9000, 2048, "m.bin", mode, device=cpu),
         jframing.build_metadata_frame(7, 9000, 2048, "m.bin", jmode)),
        (framing.build_data_chunk_frame(data[:40], 11, mode, device=cpu),
         jframing.build_data_chunk_frame(data[:40], 11, jmode)),
    ]
    for ours, ref in pairs:
        assert ours.shape == ref.shape and np.abs(ours.numpy() - ref).max() < 3e-5


def test_encode_chunked_matches_jax():
    mode = MODES["QPSK"]
    data = np.random.default_rng(23).bytes(2 * mode.chunk_size + 500)
    ref = list(japi.encode_chunked(data, _j(mode), "k.bin", batch=2))
    ours = list(api.encode_chunked(data, mode, "k.bin", batch=2, device="cpu"))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and np.abs(a.numpy() - b).max() < 3e-5


@pytest.mark.parametrize("name", ["QPSK", "16-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "64-QAM"])
def test_phy_retry_tools_match_jax(name):
    mode, jmode = MODES[name], JMODES[name]
    p, jp = mode.profile, jmode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(2)
    n_sym = min(6, framing.num_symbols_for_payload(300 + 11, mode))
    frames = np.stack([
        jframing.build_data_chunk_frame(rng.bytes(300), s, jmode)[p.silence_pre_chunk(False) :][: (3 + n_sym) * sym]
        for s in range(2)
    ])
    frames = frames + 0.005 * rng.standard_normal(frames.shape).astype(np.float32)
    ce = frames[:, 2 * sym : 3 * sym]
    syms = frames[:, 3 * sym :].reshape(2, n_sym, sym)
    jre, jim = jphy.estimate_channel(jnp.asarray(ce), jp)
    ch_re, ch_im = phy.estimate_channel(torch.from_numpy(ce), p)
    t = torch.from_numpy(syms)
    evm = phy.symbol_evm(t, ch_re, ch_im, mode).numpy()
    assert evm.shape == (2, n_sym)
    assert np.abs(evm - np.asarray(jphy.symbol_evm(jnp.asarray(syms), jre, jim, jmode))).max() < 1e-5
    total = phy.error_vector_magnitude(t, ch_re, ch_im, mode).numpy()
    assert np.abs(total - np.asarray(jphy.error_vector_magnitude(jnp.asarray(syms), jre, jim, jmode))).max() < 1e-5
    mag = phy.channel_magnitude(ch_re, ch_im).numpy()
    assert np.abs(mag - np.asarray(jphy.channel_magnitude(jre, jim))).max() < 1e-4
    eq_re, eq_im = phy.equalize(ch_re, ch_im, ch_re * 0.9, ch_im * 1.1)
    jeq = jphy.equalize(jre, jim, jre * 0.9, jim * 1.1)
    ph = phy.pilot_phase(eq_re, eq_im, p).numpy()
    assert np.abs(ph - np.asarray(jphy.pilot_phase(*jeq, jp))).max() < 1e-5
    if mode.constellation == "BPSK":
        soft = phy.demodulate_soft_bpsk(t, ch_re, ch_im, mode).numpy()
        jsoft = np.asarray(jphy.demodulate_soft_bpsk(jnp.asarray(syms), jre, jim, jmode))
        assert np.abs(soft - jsoft).max() < 1e-5 * max(1.0, np.abs(jsoft).max())
        hard = phy.demodulate(t, ch_re, ch_im, mode).numpy()
        assert np.array_equal(hard, (soft < 0).astype(np.int8))
        s = rng.standard_normal((2, 3 * 31)).astype(np.float32)
        assert np.array_equal(soft_combine(torch.from_numpy(s), 3).numpy()[1], jbits.soft_combine(s[1], 3))


def test_demodulate_tracked_matches_jax():
    """The tracking loop on a drifted acoustic frame's data region: same bits
    and final timing as the JAX scan."""
    mode, jmode = MODES["BPSK-ACOUSTIC"], JMODES["BPSK-ACOUSTIC"]
    p = mode.profile
    sym = p.symbol_len
    sig = japi.encode_legacy(np.random.default_rng(4).bytes(1500), jmode, "d.bin")
    drifted = channel.apply_channel_np(sig, channel.ChannelSpec(clock_ppm=150.0, snr_db=30.0), seed=1, device="cpu")
    start = p.silence_pre_legacy()
    n_sym = (len(drifted) - start - 3 * sym) // sym
    ext = np.pad(drifted, (0, 8192))
    jre, jim = jphy.estimate_channel(jnp.asarray(ext[start + 2 * sym : start + 3 * sym]), jmode.profile)
    jb, jtau = jphy.demodulate_tracked(jnp.asarray(ext), jnp.int32(start + 3 * sym), n_sym, jre, jim, jmode, block_syms=16)
    ch_re, ch_im = phy.estimate_channel(torch.from_numpy(ext[start + 2 * sym : start + 3 * sym]), p)
    b, tau = phy.demodulate_tracked(torch.from_numpy(ext), start + 3 * sym, n_sym, ch_re, ch_im, mode, block_syms=16)
    assert np.array_equal(b.numpy(), np.asarray(jb))
    assert abs(float(tau) - float(jtau)) < 1e-3


def test_detect_preamble_xcorr_matches_jax():
    mode = MODES["QPSK"]
    p = mode.profile
    sig = japi.encode_legacy(b"x" * 200, _j(mode), "x.bin")
    noisy = channel.apply_channel_np(sig, channel.ChannelSpec(snr_db=5.0), seed=2, device="cpu")
    n = len(noisy)
    pre = jsync.preprocess(jnp.asarray(noisy), jnp.int32(n))
    ji, jm = jsync.detect_preamble_xcorr(pre, _j(mode).profile, jnp.int32(n))
    ours_pre = sync.preprocess(torch.from_numpy(noisy.copy())[None], torch.tensor([n]))
    oi, om = sync.detect_preamble_xcorr(ours_pre, p, n)
    assert int(oi[0]) == int(ji) and abs(float(om[0]) - float(jm)) < 1e-5


def test_decoder_keeps_tensors_on_their_device():
    with pytest.raises(ValueError):
        api.decode(torch.zeros(40000, device="meta"), "QPSK", device="cpu")


GOLDEN = Path(__file__).resolve().parent / "golden"
GOLDEN_MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(GOLDEN_MANIFEST))
def test_golden_wav_through_api_decode(name):
    """Every golden WAV through the decoder: manifest file name and sha256,
    CRC valid, and the JAX package's preamble_idx and fine_metric."""
    entry = GOLDEN_MANIFEST[name]
    mode = MODES[name]
    signal, rate = read_wav(str(GOLDEN / entry["wav"]))
    assert rate == 44100 and len(signal) == entry["samples"]
    result, info = api.decode(signal, mode, device="cpu")
    assert isinstance(result, framing.LegacyFrame) and result.crc_valid
    assert result.file_name == entry["file_name"]
    assert hashlib.sha256(result.data).hexdigest() == entry["sha256"]
    ref, rinfo = japi.decode(signal, _j(mode))
    assert ref.crc_valid and ref.data == result.data
    assert info.preamble_idx == rinfo.preamble_idx
    assert abs(info.fine_metric - rinfo.fine_metric) < 1e-5


@pytest.mark.parametrize(
    "name, total, tail, error",
    [
        ("QPSK", 32768, 586, "Signal too short for CE"),
        ("QPSK", 32768, 768, "Signal too short for CE"),
        ("BPSK-NARROW", 49152, 778, "Signal too short for CE"),
    ],
)
def test_preamble_cut_off_at_the_end_of_the_padded_buffer(name, total, tail, error):
    """A frame whose preamble starts ``tail`` samples before the end of a
    signal that fills its padded bucket exactly: the refine region reaches
    past the buffer, where the port reads zeros. It must report the TRUE
    start. (The JAX package's dynamic_slice shifts the region back there and
    lands elsewhere, so this input is not held against it.)"""
    mode = MODES[name]
    p = mode.profile
    clean = framing.build_transmit_signal(b"cut" * 40, mode, "t.bin", device="cpu").numpy()
    pre = p.silence_pre_legacy()
    rng = np.random.default_rng(1)
    sig = (1e-3 * rng.standard_normal(total)).astype(np.float32)
    start = total - tail
    sig[start:] += clean[pre : pre + tail]
    assert decoder._bucket_len(total) == total
    result, info = api.decode(sig, mode, device="cpu")
    assert isinstance(result, framing.FrameError) and result.error == error
    assert info is not None and info.preamble_idx == start
    assert info.fine_metric > 0.99
