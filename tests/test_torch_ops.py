"""The port's tables, ops, sync and phy against the JAX package on the same
seeded numpy inputs (tolerances as the JAX package holds its own kernels
to: decisions equal, fine metric 1e-5, channel 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import phy as jphy
from audio_modem_tpu import sync as jsync
from audio_modem_tpu.configs import MODES as JMODES, OFDM_PROFILES as JPROFILES
from audio_modem_tpu.ops import bits as jbits
from audio_modem_tpu.ops import constellations as jcon
from audio_modem_tpu.ops import dft as jdft
import audio_modem_tpu as jpkg
import audio_modem_tpu_torch as tpkg
from audio_modem_tpu.parallel import mesh as jmesh
from audio_modem_tpu_torch import framing, phy, sync, tables
from audio_modem_tpu_torch.parallel import mesh
from audio_modem_tpu_torch.configs import MODES, OFDM_PROFILES
from audio_modem_tpu_torch.ops import bits, constellations

torch.set_num_threads(2)

ALL_MODES = sorted(MODES)


def _t(a):
    return torch.from_numpy(np.array(a))


def _noisy_frames(mode, n=2, size=64, noise=0.02, seed=7, pad_syms=2):
    rng = np.random.default_rng(seed)
    # the port's TX (held to the JAX TX in test_torch_framing.py) skips a JAX compile
    frames = list(framing.build_data_chunk_frames([rng.bytes(size) for _ in range(n)], 0, mode, device="cpu").numpy())
    frames = [f + noise * rng.standard_normal(len(f)).astype(np.float32) for f in frames]
    t = len(frames[0]) + pad_syms * mode.profile.symbol_len
    t = -(-t // 128) * 128
    out = np.zeros((n, t), np.float32)
    for i, f in enumerate(frames):
        out[i, : len(f)] = f
    return out, np.asarray([len(f) for f in frames], np.int32)


@pytest.mark.parametrize("name", sorted(OFDM_PROFILES))
def test_tables_from_jax_arrays_equal_profile_tables(name):
    p, jp = OFDM_PROFILES[name], JPROFILES[name]
    tx_data, tx_pilot = jdft.tx_data_tables(jp)
    pre1, t_energy = jsync._template(jp)
    bt = jphy._bin_tables(jp)
    arrays = {
        "rx_active": jdft._rx_matrix(jp),
        "rx_data": jdft._rx_matrix_for_bins(jp, tuple(int(b) for b in jp.data_bins)),
        "rx_pilot": jdft._rx_matrix_for_bins(jp, tuple(int(b) for b in jp.pilot_bins)),
        "tx_data": tx_data,
        "tx_pilot": tx_pilot,
        "ce_known": bt["ce_known"],
        "pre1": pre1,
        "t_energy": t_energy,
        "header": np.concatenate([jp.preamble1, jp.preamble2, jp.ce_symbol]),
        "data_pos": bt["data_pos"],
        "pilot_pos": bt["pilot_pos"],
    }
    a = tables.tables_from_numpy(arrays, "cpu")
    b = tables.profile_tables(p, "cpu")
    assert a.t_energy == b.t_energy
    for field in ("rx_active", "rx_data", "rx_pilot", "tx_data", "tx_pilot", "ce_known", "pre1",
                  "header", "data_pos", "pilot_pos"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and torch.equal(x, y), field


@pytest.mark.parametrize("name", ALL_MODES)
def test_map_bits_and_demap(name):
    mode = MODES[name]
    c = mode.constellation
    bps = constellations.CONSTELLATIONS[c].bps
    assert bps == mode.bps == JMODES[name].bps
    assert constellations.bits_per_symbol(mode) == mode.bits_per_symbol == JMODES[name].bits_per_symbol
    rng = np.random.default_rng(3)
    b = rng.integers(0, 2, (3, 40 * bps)).astype(np.int8)
    jre, jim = jcon.map_bits(c, jnp.asarray(b))
    re, im = constellations.map_bits(c, _t(b))
    assert np.array_equal(np.asarray(jre), re.numpy()) and np.array_equal(np.asarray(jim), im.numpy())
    nre = np.asarray(jre) + 0.08 * rng.standard_normal(np.shape(jre)).astype(np.float32)
    nim = np.asarray(jim) + 0.08 * rng.standard_normal(np.shape(jim)).astype(np.float32)
    jd = np.asarray(jcon.demap(c, jnp.asarray(nre), jnp.asarray(nim)))
    assert np.array_equal(jd, constellations.demap(c, _t(nre), _t(nim)).numpy())
    assert np.array_equal(constellations.demap(c, re, im).numpy(), b)


def test_package_version_and_profiles():
    assert tpkg.__version__ == jpkg.__version__
    assert sorted(tpkg.OFDM_PROFILES) == sorted(jpkg.OFDM_PROFILES)
    for name, p in tpkg.OFDM_PROFILES.items():
        assert (p.name, p.cp_len, p.sub_start, p.sub_end, p.pilots) == (
            jpkg.OFDM_PROFILES[name].name, jpkg.OFDM_PROFILES[name].cp_len, jpkg.OFDM_PROFILES[name].sub_start,
            jpkg.OFDM_PROFILES[name].sub_end, jpkg.OFDM_PROFILES[name].pilots)
    assert set(tpkg.__all__) == set(jpkg.__all__) | {"assert_full_fp32"}


@pytest.mark.parametrize("name", sorted(jcon.CONSTELLATIONS))
def test_constellation_tables(name):
    """Equal point tables, bits per point and sizes; the demap's level
    spacing is the JAX package's (the max level of the table over top)."""
    ours, ref = constellations.CONSTELLATIONS[name], jcon.CONSTELLATIONS[name]
    assert (ours.name, ours.bps, ours.n_points) == (ref.name, ref.bps, ref.n_points)
    assert ours.points == ref.points
    assert np.array_equal(ours.points_np(), ref.points_np())
    if ours.bps > 2:
        top = (1 << (ours.bps // 2)) - 1
        assert constellations.qam_scale(name) == float(ref.points_np()[:, 0].max() / top)
    assert sorted(constellations.CONSTELLATIONS) == sorted(jcon.CONSTELLATIONS)


@pytest.mark.parametrize("rep", [1, 2, 3])
def test_repeat_bits(rep):
    rng = np.random.default_rng(rep)
    b = rng.integers(0, 2, 37).astype(np.int8)
    assert np.array_equal(bits.repeat_bits(_t(b), rep).numpy(), jbits.repeat_bits(b, rep))
    rows = rng.integers(0, 2, (3, 11)).astype(np.int8)
    assert np.array_equal(bits.repeat_bits(_t(rows), rep).numpy(), np.stack([jbits.repeat_bits(r, rep) for r in rows]))
    assert np.array_equal(bits.majority_vote(bits.repeat_bits(_t(b), rep), rep).numpy(), b)


@pytest.mark.parametrize("n_dev, n", [(8, 64), (2, 6), (1, 5)])
def test_batch_sharding_matches_jax(n_dev, n):
    """Each mesh device holds the rows that the JAX package's leading-axis
    sharding gives the device of the same shard index."""
    jm = jmesh.make_mesh(n_dev)
    jidx = jmesh.batch_sharding(jm).devices_indices_map((n, 3))
    ours = mesh.batch_sharding(mesh.make_mesh(devices=["cpu"] * n_dev), n)
    assert len(ours) == n_dev
    for (dev, rows), jdev in zip(ours, jm.devices.flat):
        jrows = jidx[jdev][0]
        assert dev == torch.device("cpu")
        assert (rows.start, rows.stop) == (jrows.start or 0, n if jrows.stop is None else jrows.stop)
    x = torch.arange(n * 3).reshape(n, 3)
    sharded = mesh.shard_batch(x, mesh.make_mesh(devices=["cpu"] * n_dev))
    assert all(torch.equal(s, x[rows]) for s, (_, rows) in zip(sharded.shards, ours))


@pytest.mark.parametrize("rep", [1, 2, 3])
def test_bits_vote_and_pack(rep):
    rng = np.random.default_rng(rep)
    b = rng.integers(0, 2, (4, 8 * 9 * rep + 5)).astype(np.int8)
    voted = bits.majority_vote(_t(b), rep)
    assert np.array_equal(np.asarray(jbits.jnp_majority_vote(jnp.asarray(b), rep)), voted.numpy())
    assert np.array_equal(np.asarray(jbits.jnp_bits_to_bytes(jnp.asarray(b))), bits.bits_to_bytes(_t(b)).numpy())
    by = rng.integers(0, 256, (2, 11)).astype(np.uint8)
    assert np.array_equal(bits.bytes_to_bits(_t(by)).numpy(), np.stack([jbits.bytes_to_bits(r) for r in by]))


@pytest.mark.parametrize("window", [1, 7, 16, 100, 256, 576])
def test_windowed_sum(window):
    rng = np.random.default_rng(window)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    ref = np.asarray(jsync.windowed_sum(jnp.asarray(x), window))
    out = sync.windowed_sum(_t(x), window).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_pairwise_row_sum_and_preprocess():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 5000)) * 0.3 + 0.2).astype(np.float32)
    s = sync.pairwise_row_sum(_t(x)).numpy()[:, 0]
    np.testing.assert_allclose(s, x.astype(np.float64).sum(-1), rtol=1e-5)
    nv = np.asarray([5000, 4000, 123], np.int32)
    ref = np.asarray(jsync.preprocess(jnp.asarray(x), jnp.asarray(nv)))
    out = sync.preprocess(_t(x), _t(nv)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert (out[1, 4000:] == 0).all() and np.abs(out[1]).max() == 1.0


@pytest.mark.parametrize("min_pos", [0, 3000])
def test_detect_preamble(min_pos):
    mode, jmode = MODES["QPSK"], JMODES["QPSK"]
    sig, nv = _noisy_frames(mode, n=3, seed=11)
    pre = np.asarray(jax.jit(jsync.preprocess)(jnp.asarray(sig), jnp.asarray(nv)))
    mp = np.full(3, min_pos, np.int32)
    jc, jm = jax.jit(lambda x, n, m: jsync.detect_preamble(x, jmode.profile, n, min_pos=m, stride=16))(
        jnp.asarray(pre), jnp.asarray(nv), jnp.asarray(mp)
    )
    c, m = sync.detect_preamble(_t(pre), mode.profile, _t(nv), min_pos=_t(mp), stride=16)
    assert np.array_equal(np.asarray(jc), c.numpy())
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
    if min_pos:  # the preamble starts near sample 2205, before min_pos
        assert ((c.numpy() == -1) | (c.numpy() >= min_pos)).all()
    else:
        assert (c.numpy() >= 0).all()
    jc1, _ = jax.jit(lambda x, n: jsync.detect_preamble(x, jmode.profile, n))(jnp.asarray(pre[:1]), jnp.asarray(nv[:1]))
    c1, _ = sync.detect_preamble(_t(pre[:1]), mode.profile, _t(nv[:1]))
    assert np.array_equal(np.asarray(jc1), c1.numpy())


@pytest.mark.parametrize("name", ["QPSK", "BPSK-ACOUSTIC", "BPSK-NARROW"])
def test_refine_estimate_and_demodulate(name):
    mode, jmode = MODES[name], JMODES[name]
    p, jp = mode.profile, jmode.profile
    sym = p.symbol_len
    sig, nv = _noisy_frames(mode, n=2, seed=13)
    pre = np.asarray(jax.jit(jsync.preprocess)(jnp.asarray(sig), jnp.asarray(nv)))
    ext = np.pad(pre, ((0, 0), (0, 8 * sym)))
    coarse = np.asarray(jax.jit(lambda x, n: jsync.detect_preamble(x, jp, n, stride=16)[0])(jnp.asarray(pre), jnp.asarray(nv)))
    coarse = np.maximum(coarse + 37, 0).astype(np.int32)  # off the plateau, inside the radius
    js, jm = jax.jit(jax.vmap(lambda s, c, n: jsync.refine_xcorr(s, c, jp, n)))(
        jnp.asarray(ext), jnp.asarray(coarse), jnp.asarray(nv)
    )
    st, m = sync.refine_xcorr(_t(ext), _t(coarse), p, _t(nv))
    assert np.array_equal(np.asarray(js), st.numpy())
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)

    n_sym = 4
    ce = np.stack([ext[i, s + 2 * sym : s + 3 * sym] for i, s in enumerate(np.asarray(js))])
    data = np.stack(
        [ext[i, s + 3 * sym : s + (3 + n_sym) * sym].reshape(n_sym, sym) for i, s in enumerate(np.asarray(js))]
    )
    jre, jim = jax.jit(lambda x: jphy.estimate_channel(x, jp))(jnp.asarray(ce))
    re, im = phy.estimate_channel(_t(ce), p)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-4)
    jb = np.asarray(jax.jit(lambda x, a, b: jphy.demodulate(x, a, b, jmode))(jnp.asarray(data), jre, jim))
    assert np.array_equal(jb, phy.demodulate(_t(data), re, im, mode).numpy())


def test_sliding_correlate():
    p = OFDM_PROFILES["standard"]
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    ref = np.asarray(jsync.sliding_correlate(jnp.asarray(x), JPROFILES["standard"]))
    np.testing.assert_allclose(sync.sliding_correlate(_t(x), p).numpy(), ref, atol=1e-4)
