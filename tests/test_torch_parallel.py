"""The port's mesh, sharded batch functions and driver entry points against
the JAX package's (tests/test_parallel.py), on the CPU: the port's virtual
mesh names its devices (``["cpu"] * 8``), the JAX package's is the
8-virtual-device CPU mesh of tests/conftest.py."""

import jax
import numpy as np
import pytest
import torch

from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.parallel import batch_decode_signals as jbatch_decode_signals
from audio_modem_tpu.parallel import make_mesh as jmake_mesh
from audio_modem_tpu.parallel import shard_batch as jshard_batch
from audio_modem_tpu.parallel.batch import pad_signals
from audio_modem_tpu_torch import entry as tentry
from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.parallel import (
    batch_decode_chunk_frames,
    batch_decode_signals,
    batch_loopback_step,
    make_mesh,
    shard_batch,
)
from audio_modem_tpu_torch.parallel.batch import shard_generators, shardmap_loopback_ber
from audio_modem_tpu_torch.parallel.mesh import STREAM_AXIS, Sharded, replicated

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card-count checks run on the card")


def test_make_mesh_raises_without_enough_cards():
    _no_card()
    for n in (None, 1, 2):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh(n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 2)


@pytest.mark.parametrize("devices, size", [(CPU8, 8), (["cpu"], 1), (["cpu", "cpu"], 2)])
def test_virtual_mesh_names_its_devices(devices, size):
    mesh = make_mesh(devices=devices)
    assert mesh.size == size and mesh.devices == tuple(torch.device("cpu") for _ in devices)
    assert make_mesh(size, devices=devices) == mesh
    assert STREAM_AXIS == "streams"
    with pytest.raises(ValueError):
        make_mesh(size + 1, devices=devices)


def test_shard_batch_slabs_gather_and_divisibility():
    mesh = make_mesh(devices=CPU8)
    x = torch.arange(16 * 3).reshape(16, 3)
    sh = shard_batch(x, mesh)
    assert isinstance(sh, Sharded) and len(sh.shards) == 8
    assert all(torch.equal(s, x[2 * k : 2 * k + 2]) for k, s in enumerate(sh.shards))
    assert torch.equal(sh.gather(), x) and np.array_equal(sh.numpy(), x.numpy())
    assert all(torch.equal(r, x) for r in replicated(x, mesh))
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(np.zeros((12, 3)), mesh)


def _bpsk_frames():
    """tests/test_parallel.py::test_batch_decode_signals_sharded's input:
    8 BPSK-ACOUSTIC chunk frames of 64 seeded bytes (seed 6), from the JAX
    package's TX."""
    mode = JMODES["BPSK-ACOUSTIC"]
    rng = np.random.default_rng(6)
    sigs = [jframing.build_data_chunk_frame(rng.bytes(64), seq, mode) for seq in range(8)]
    return pad_signals(sigs, pad_len=len(sigs[0]) + mode.profile.symbol_len)


def test_batch_decode_signals_sharded_matches_jax_and_unsharded():
    signals, n_valid = _bpsk_frames()
    max_syms = 16
    jmesh = jmake_mesh()
    assert jmesh.size == 8
    jout = jbatch_decode_signals(jshard_batch(jax.numpy.asarray(signals), jmesh),
                                 jshard_batch(jax.numpy.asarray(n_valid), jmesh), JMODES["BPSK-ACOUSTIC"], max_syms)
    mesh = make_mesh(devices=CPU8)
    mode = MODES["BPSK-ACOUSTIC"]
    out = batch_decode_signals(shard_batch(signals, mesh), shard_batch(n_valid, mesh), mode, max_syms)
    assert {k: len(v.shards) for k, v in out.items()} == {k: 8 for k in out}
    plain = batch_decode_signals(torch.from_numpy(signals), torch.from_numpy(n_valid), mode, max_syms)
    assert bool(out["detected"].numpy().all())
    for key in ("start", "detected", "bits"):
        assert np.array_equal(out[key].numpy(), plain[key].numpy()), key
    for key in ("start", "detected"):
        assert np.array_equal(out[key].numpy(), np.asarray(jout[key])), key
    # the frame's symbols; past them lies the silence after the frame, whose
    # bits are junk that no caller reads
    n_bits = framing.num_symbols_for_payload(64 + 11, mode) * mode.bits_per_symbol
    bits = out["bits"].numpy()[:, :n_bits]
    assert np.array_equal(bits, np.asarray(jout["bits"])[:, :n_bits])
    for seq in range(8):
        parsed = framing.parse_payload_bytes(np.packbits(bits[seq]).tobytes(), min_len=6)
        assert isinstance(parsed, framing.DataFrame) and parsed.crc_valid and parsed.seq_num == seq


def test_batch_decode_chunk_frames_sharded_equals_unsharded():
    fn, (frames,) = tentry.entry(device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    sharded = batch_decode_chunk_frames(shard_batch(frames, mesh), MODES["QPSK"], 4)
    assert len(sharded.shards) == 4 and torch.equal(sharded.gather(), fn(frames))


def test_loopback_step_sharded_ber_zero():
    mode = MODES["QPSK"]
    mesh = make_mesh(devices=CPU8)
    n_sym = 3
    bits = np.random.default_rng(7).integers(0, 2, (16, n_sym * mode.bits_per_symbol), dtype=np.int8)
    ber, out_bits = batch_loopback_step(shard_batch(bits, mesh), shard_generators(1, mesh), mode, n_sym, 30.0)
    assert float(ber) == 0.0
    assert np.array_equal(out_bits.numpy(), bits)
    with pytest.raises(ValueError, match="one generator per shard"):
        batch_loopback_step(shard_batch(bits, mesh), shard_generators(1, make_mesh(devices=["cpu"])), mode, n_sym)


def test_shardmap_explicit_collective_ber():
    """Each shard's local step with its own generator seeded 3, and the mean
    across shards as the one collective: 0 at 30 dB, noisy at -5 dB, and
    exactly the mean of the per-shard ``batch_loopback_step`` BERs."""
    mode = MODES["QPSK"]
    mesh = make_mesh(devices=CPU8)
    n_sym = 2
    bits = np.random.default_rng(9).integers(0, 2, (16, n_sym * mode.bits_per_symbol), dtype=np.int8)
    sh = shard_batch(bits, mesh)
    assert float(shardmap_loopback_ber(sh, 3, mode, n_sym, 30.0)) == 0.0
    noisy = shardmap_loopback_ber(sh, 3, mode, n_sym, -5.0)
    assert 0.05 < float(noisy) < 0.6
    local = [batch_loopback_step(s, torch.Generator().manual_seed(3), mode, n_sym, -5.0)[0] for s in sh.shards]
    assert torch.equal(noisy, torch.stack(local).mean())


def test_entry_bits_equal_the_jax_entry():
    import __graft_entry__ as ge

    jfn, (jframes,) = ge.entry()
    fn, (frames,) = tentry.entry(device="cpu")
    assert np.array_equal(frames.numpy(), np.asarray(jframes))
    bits = fn(frames)
    assert bits.shape == (8, 4 * MODES["QPSK"].bits_per_symbol) and bits.dtype == torch.int8
    assert np.array_equal(bits.numpy(), np.asarray(jax.jit(jfn)(jframes)))


def test_dryrun_multichip_on_a_named_virtual_mesh():
    tentry.dryrun_multichip(8, devices=CPU8)
    tentry.dryrun_multichip(2, devices=["cpu", "cpu"])


def test_dryrun_multichip_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA device"):
        tentry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
