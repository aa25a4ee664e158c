"""The port's DeviceRing and the device-ring round dispatch against the JAX
package's (device="cpu"): ring writes shorter than, equal to and longer
than the capacity, rel / get_range / gather_ranges / the per-stream view,
the staged batch scan and refine, and the three ``*_dev`` dispatch
functions at 4 streams and K = 3 in both branches (slot 0 scanned, slot 0
predicted). Packed result bytes must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.parallel import multi_receiver as jmr
from audio_modem_tpu_torch import framing
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.parallel import multi_receiver as mr

torch.set_num_threads(2)

N_STREAMS, K, CHUNK = 4, 3, 256


def _logical(ring: mr.DeviceRing) -> np.ndarray:
    """The ring's content oldest sample first, as the JAX ring stores it."""
    n = ring.buf.shape[0]
    return mr._ring_gather(ring, range(n), [0] * n, ring.capacity).numpy()


@pytest.mark.parametrize(
    "capacity, blocks",
    [(256, (100, 100, 100, 56)), (200, (256, 256)), (128, (300, 5, 700)), (384, (1, 383, 384, 385, 64))],
    ids=["shorter", "equal", "longer", "mixed"],
)
def test_device_ring_matches_jax(capacity, blocks):
    rng = np.random.default_rng(capacity)
    ring, ref = mr.DeviceRing(3, capacity, device="cpu"), jmr.DeviceRing(3, capacity)
    assert ring.capacity == ref.capacity == -(-capacity // 128) * 128
    cap = ring.capacity
    views = [mr._DeviceRingView(ring, i) for i in range(3)]
    jviews = [jmr._DeviceRingView(ref, i) for i in range(3)]
    for l in blocks:
        x = rng.standard_normal((3, l)).astype(np.float32)
        ring.write(x if l % 2 else torch.from_numpy(x))
        ref.write(x)
        total = ring.total_written
        assert total == ref.total_written
        assert np.array_equal(_logical(ring), np.asarray(ref.buf))
        for g in (total - cap - 1, total - cap, total - cap + 17, total - 60, total - 1, total):
            assert ring.rel(g) == ref.rel(g)
            for length in (1, 40, cap):
                for row in (0, 2):
                    a, b = ring.get_range(row, g, length), ref.get_range(row, g, length)
                    assert (a is None) == (b is None), (g, length)
                    assert a is None or (a.dtype == np.float32 and np.array_equal(a, b))
                a, b = views[1].get_range(g, length), jviews[1].get_range(g, length)
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
            assert views[2].available_from(g) == jviews[2].available_from(g)
        starts = [total - cap, total - 50, total - cap + 9]
        got = ring.gather_ranges([2, 0, 1], starts, 50)
        assert isinstance(got, np.ndarray) and np.array_equal(got, ref.gather_ranges([2, 0, 1], starts, 50))
        # rows 0 and 1 in lockstep (one strided copy), row 2 elsewhere
        runs = [total - 70, total - 70, total - cap]
        assert np.array_equal(ring.gather_ranges([0, 1, 2], runs, 70), ref.gather_ranges([0, 1, 2], runs, 70))
        assert (views[0].capacity, views[0].total_written) == (jviews[0].capacity, jviews[0].total_written)
    with pytest.raises(NotImplementedError):
        views[0].write(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="leaves the ring"):
        mr._ring_gather(ring, [0], [cap - 10], 11)
    with pytest.raises(ValueError, match="leaves the ring"):
        mr._ring_gather(ring, [0], [-1], 4)


def test_device_ring_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mr.DeviceRing(2, 256)


def _stream_signals(noise: float):
    """4 QPSK streams of K data frames each on one cadence, stream i delayed
    by 48 * i samples: (mode, n_sym, cadence, signals [4, K * cadence + 144],
    leads)."""
    mode = MODES["QPSK"]
    p = mode.profile
    rng = np.random.default_rng(23)
    n_sym = framing.num_symbols_for_payload(CHUNK + 11, mode)
    cadence = framing.estimate_frame_samples(CHUNK + 11, mode) + p.silence_pre_chunk(False) + p.silence_post_chunk()
    payloads = [framing.build_data_chunk_payload(rng.bytes(CHUNK), s % K) for s in range(N_STREAMS * K)]
    u8 = np.frombuffer(b"".join(payloads), np.uint8).reshape(N_STREAMS * K, -1)
    frames = framing._synth_frames_core(
        torch.from_numpy(u8.copy()), mode, n_sym, p.silence_pre_chunk(False), p.silence_post_chunk()
    ).numpy().reshape(N_STREAMS, K * cadence)
    leads = [48 * i for i in range(N_STREAMS)]
    signals = np.zeros((N_STREAMS, K * cadence + leads[-1]), np.float32)
    for i, lead in enumerate(leads):
        signals[i, lead : lead + K * cadence] = frames[i]
    signals += noise * rng.standard_normal(signals.shape).astype(np.float32)
    return mode, n_sym, cadence, signals, leads


def _filled_rings(signals: np.ndarray, capacity: int, block: int):
    ring, ref = mr.DeviceRing(N_STREAMS, capacity, device="cpu"), jmr.DeviceRing(N_STREAMS, capacity)
    for off in range(0, signals.shape[1], block):
        ring.write(signals[:, off : off + block])
        ref.write(signals[:, off : off + block])
    return ring, ref


def _check_classified(packed: np.ndarray):
    det, _, full, seq = mr._classify_round(packed, CHUNK)
    assert det.all() and full.all()
    assert (seq == np.arange(K)[None, :]).all()


@pytest.mark.parametrize("wrapped", [False, True], ids=["contiguous", "wrapped"])
def test_round_dispatch_from_the_ring_matches_jax(wrapped):
    """Round 1 scans slot 0 (``_batch_window_decode_multi_dev``), round 2
    predicts every slot from round 1's starts
    (``_batch_window_decode_pred_dev``); ``_batch_window_decode_dev`` decodes
    one frame per window. In the wrapped case the windows cross the end of
    the port's ring buffer, which is a true ring."""
    mode, n_sym, cadence, signals, leads = _stream_signals(0.01)
    jmode = JMODES["QPSK"]
    p = mode.profile
    w = -(-(K * cadence + 4 * p.symbol_len + p.fft_size + 2048) // 128) * 128
    # a quiet lead-in longer than the ring's slack makes the write position wrap
    lead_in = 20000 if wrapped else 0
    stream = np.pad(signals, ((0, 0), (lead_in, 0)))
    total = stream.shape[1]
    ring, ref = _filled_rings(stream, w + 256, 5000)
    assert ring.total_written == ref.total_written == total
    assert (total > ring.capacity) == wrapped
    base = total - w  # global position of every window's first sample; before the stream's start if negative
    start_rel = np.full(N_STREAMS, ring.rel(base), np.int32)
    n_valid = np.full(N_STREAMS, w, np.int32)
    first = [lead_in + lead - base for lead in leads]  # window-relative start of each stream's first frame
    min_pos = np.array(first, np.int32)
    params = np.stack([start_rel, min_pos, n_valid])

    want = np.asarray(jmr._batch_window_decode_multi_dev(ref.buf, jnp.asarray(params), jmode, n_sym, K, cadence, w))
    got = mr._batch_window_decode_multi_dev(ring, params, mode, n_sym, K, cadence, w).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (N_STREAMS, K, 5 + n_sym * 410 // 8)
    assert np.array_equal(got, want)
    _check_classified(got)
    _, starts, _ = mr._unpack_round(got)
    assert [int(s) for s in starts[:, 0]] == [f + p.silence_pre_chunk(False) for f in first]
    # the same windows through the entry that takes them directly
    windows = np.pad(stream, ((0, 0), (max(-base, 0), 0)))[:, max(base, 0) :]
    assert windows.shape == (N_STREAMS, w)
    direct = mr._batch_window_decode_multi(
        torch.from_numpy(windows.copy()), torch.from_numpy(min_pos), torch.from_numpy(n_valid), mode, n_sym, K, cadence
    ).numpy()
    assert np.array_equal(got, direct)

    # one frame per window
    want1 = np.asarray(jmr._batch_window_decode_dev(ref.buf, jnp.asarray(params), jmode, n_sym, w))
    got1 = mr._batch_window_decode_dev(ring, torch.from_numpy(params), mode, n_sym, w).numpy()
    assert got1.shape == (N_STREAMS, 5 + n_sym * 410 // 8) and np.array_equal(got1, want1)
    assert np.array_equal(got1, got[:, 0])

    # the predicted round, slot 0 a few samples of drift off the true start
    pred0 = (starts[:, 0] + 3).astype(np.int32)
    pparams = np.stack([start_rel, pred0, n_valid])
    wantp = np.asarray(jmr._batch_window_decode_pred_dev(ref.buf, jnp.asarray(pparams), jmode, n_sym, K, cadence, w))
    gotp = mr._batch_window_decode_pred_dev(ring, pparams, mode, n_sym, K, cadence, w).numpy()
    assert np.array_equal(gotp, wantp)
    _check_classified(gotp)
    assert np.array_equal(gotp, got)  # the prediction lands on the same starts and bytes


def test_round_params_are_checked():
    ring = mr.DeviceRing(N_STREAMS, 4096, device="cpu")
    mode = MODES["QPSK"]
    for bad in (np.zeros((3, N_STREAMS), np.int64), np.zeros((2, N_STREAMS), np.int32), np.zeros((3, 5), np.int32)):
        with pytest.raises(ValueError, match="params"):
            mr._batch_window_decode_dev(ring, bad, mode, 4, 2048)


def test_batch_window_decode_matches_jax():
    mode, n_sym, cadence, signals, leads = _stream_signals(0.01)
    win = np.ascontiguousarray(signals[:, : -(-(cadence + 2048) // 128) * 128])
    n_valid = np.full(N_STREAMS, win.shape[1], np.int32)
    want = np.asarray(jmr._batch_window_decode(jnp.asarray(win), jnp.asarray(n_valid), JMODES["QPSK"], n_sym))
    got = mr._batch_window_decode(torch.from_numpy(win), torch.from_numpy(n_valid), mode, n_sym).numpy()
    assert np.array_equal(got, want)
    det, starts, _ = mr._unpack_round(got)
    assert det.all() and [int(s) for s in starts] == [lead + mode.profile.silence_pre_chunk(False) for lead in leads]


def test_staged_scan_and_refine_match_jax():
    """``_batch_scan`` on [n, SCAN_BUCKET] windows (one masked by n_valid =
    0) and ``_batch_refine`` around its indices."""
    mode, _, _, signals, leads = _stream_signals(0.01)
    p, jp = mode.profile, JMODES["QPSK"].profile
    assert mr.SCAN_BUCKET == jmr.SCAN_BUCKET
    win = np.ascontiguousarray(signals[:, : mr.SCAN_BUCKET])
    n_valid = np.array([mr.SCAN_BUCKET, 6000, 0, mr.SCAN_BUCKET], np.int32)
    jidx, jbest = jmr._batch_scan(jnp.asarray(win), jnp.asarray(n_valid), jp)
    idx, best = mr._batch_scan(torch.from_numpy(win), torch.from_numpy(n_valid), p)
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy() >= 0, np.asarray(jidx) >= 0)
    assert (idx.numpy() >= 0).tolist() == [True, True, False, True]
    assert np.abs(best.numpy() - np.asarray(jbest)).max() < 1e-5
    plen, radius = p.symbol_len, 3 * p.cp_len
    region_len = 2 * radius + 2 * plen
    coarse = np.maximum(np.asarray(jidx), 0).astype(np.int32)
    lo = np.maximum(coarse - radius, 0)
    regions = np.zeros((N_STREAMS, region_len), np.float32)
    for i in range(N_STREAMS):
        regions[i, : region_len - plen] = signals[i, lo[i] : lo[i] + region_len - plen]
    lens = np.array([region_len - plen] * N_STREAMS, np.int32)
    jstart, jmetric = jmr._batch_refine(jnp.asarray(regions), jnp.asarray(coarse - lo), jnp.asarray(lens), jp)
    start, metric = mr._batch_refine(
        torch.from_numpy(regions), torch.from_numpy(coarse - lo), torch.from_numpy(lens), p
    )
    assert np.array_equal(start.numpy(), np.asarray(jstart))
    assert np.abs(metric.numpy() - np.asarray(jmetric)).max() < 1e-5
    pre = p.silence_pre_chunk(False)
    assert [int(s) + int(l) for s, l in zip(start[[0, 1, 3]], lo[[0, 1, 3]])] == [leads[i] + pre for i in (0, 1, 3)]
