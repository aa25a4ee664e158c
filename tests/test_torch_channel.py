"""The port's channel simulator against the JAX package's on the same numpy
signals (device="cpu"): multipath, clock drift and dropout within 1e-6,
``apply_channel`` in the reference's physical order, and AWGN held by its
measured SNR (within 0.1 dB over 1e6 samples) and its reproducibility for
one generator seed; the two packages' noise draws differ by design."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import channel as jchannel
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu_torch import channel

torch.set_num_threads(2)

TOL = 1e-6


def _signal(n_bytes: int = 6000) -> np.ndarray:
    """A chunked QPSK transmission: the amplitudes the modem really sends."""
    data = np.random.default_rng(1).bytes(n_bytes)
    return np.concatenate(list(japi.encode_chunked(data, JMODES["QPSK"], "c.bin")))


def _jax_drift(x: np.ndarray, ppm: float) -> np.ndarray:
    """The JAX package's clock_drift, op by op: in one fused XLA program
    the multiply and subtract behind the fractional delay may contract into
    an FMA at some samples, by thread layout, and move those samples by
    ~1e-4 from run to run."""
    with jax.disable_jit():
        return np.asarray(jchannel.clock_drift(jnp.asarray(x), ppm))


def test_channel_spec_matches_jax():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(channel.ChannelSpec)] == [
        (f.name, f.default) for f in dataclasses.fields(jchannel.ChannelSpec)
    ]
    assert dataclasses.is_dataclass(channel.ChannelSpec) and channel.ChannelSpec.__dataclass_params__.frozen


@pytest.mark.parametrize("taps", [((5, 0.5),), ((3, 0.6), (41, -0.25), (700, 0.1))])
def test_multipath_matches_jax(taps):
    x = _signal()
    got = channel.multipath(torch.from_numpy(x), taps).numpy()
    want = np.asarray(jchannel.multipath(jnp.asarray(x), taps))
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("ppm", [100.0, -100.0])
def test_clock_drift_matches_jax(ppm):
    """A signal of 1.5 blocks of 65,536 samples, so the second block's
    sources reach past the first's, at both signs of the offset."""
    x = _signal()
    assert len(x) > 65536
    got = channel.clock_drift(torch.from_numpy(x), ppm).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    assert np.abs(got - _jax_drift(x, ppm)).max() <= TOL
    t = torch.from_numpy(x)
    assert channel.clock_drift(t, 0.0) is t


def test_clock_drift_batched_rows():
    """[2, T] rows resample independently, as each row alone does."""
    x = np.stack([_signal(), _signal()[::-1].copy()])
    got = channel.clock_drift(torch.from_numpy(x), 100.0).numpy()
    for row in range(2):
        alone = channel.clock_drift(torch.from_numpy(x[row]), 100.0).numpy()
        assert np.array_equal(got[row], alone)
        assert np.abs(got[row] - _jax_drift(x[row], 100.0)).max() <= TOL


def test_dropout_matches_jax():
    x = _signal()
    spans = ((0, 10), (5000, 576), (len(x) - 3, 50))
    got = channel.dropout(torch.from_numpy(x), spans).numpy()
    assert np.array_equal(got, np.asarray(jchannel.dropout(jnp.asarray(x), spans)))
    assert (got[5000:5576] == 0).all() and got[4999] == x[4999]


def test_apply_channel_in_the_reference_order():
    """gain and multipath, drift, DC offset, dropout: the deterministic
    stages of one spec equal the JAX package's apply_channel, and equal the
    stages applied one by one in that order."""
    x = _signal()
    spec = channel.ChannelSpec(multipath=((7, 0.4),), gain=0.8, dc_offset=0.01, clock_ppm=-100.0,
                               dropout=((20000, 900),))
    jspec = jchannel.ChannelSpec(multipath=((7, 0.4),), gain=0.8, dc_offset=0.01, clock_ppm=-100.0,
                                 dropout=((20000, 900),))
    got = channel.apply_channel(torch.from_numpy(x), spec).numpy()
    with jax.disable_jit():
        want = np.asarray(jchannel.apply_channel(jnp.asarray(x), jspec))
    assert np.abs(got - want).max() <= TOL
    t = torch.from_numpy(x) * 0.8
    by_hand = channel.dropout(channel.clock_drift(channel.multipath(t, ((7, 0.4),)), -100.0) + 0.01, ((20000, 900),))
    assert torch.equal(channel.apply_channel(torch.from_numpy(x), spec), by_hand)
    assert np.array_equal(channel.apply_channel_np(x, spec, device="cpu"), got)


def test_awgn_snr_and_reproducibility():
    """1e6 samples at 10 dB: the added noise's power is the signal power
    over 10^(snr/10) within 0.1 dB; the same seed gives the same bits, and
    AWGN comes last, after the deterministic stages."""
    x = (np.random.default_rng(3).standard_normal(1_000_000) * 0.2).astype(np.float32)
    for snr in (10.0, -2.0):
        spec = channel.ChannelSpec(snr_db=snr)
        noisy = channel.apply_channel_np(x, spec, seed=7, device="cpu")
        noise = noisy.astype(np.float64) - x
        measured = 10 * np.log10(np.mean(x.astype(np.float64) ** 2) / np.mean(noise**2))
        assert abs(measured - snr) < 0.1, measured
        assert np.array_equal(noisy, channel.apply_channel_np(x, spec, seed=7, device="cpu"))
        assert not np.array_equal(noisy, channel.apply_channel_np(x, spec, seed=8, device="cpu"))
    gen = torch.Generator().manual_seed(5)
    a = channel.awgn(torch.from_numpy(x[:1000]), 20.0, gen)
    gen.manual_seed(5)
    assert torch.equal(a, channel.awgn(torch.from_numpy(x[:1000]), 20.0, gen))
    spec = channel.ChannelSpec(gain=0.5, dropout=((0, 100),), snr_db=30.0)
    out = channel.apply_channel(torch.from_numpy(x[:5000]), spec, torch.Generator().manual_seed(1))
    assert (out[:100] != 0).all()  # noise after the dropout


def test_apply_channel_needs_a_generator_for_awgn():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="Generator"):
        channel.apply_channel(x, channel.ChannelSpec(snr_db=10.0))
    assert torch.equal(channel.apply_channel(x, channel.ChannelSpec()), x)
