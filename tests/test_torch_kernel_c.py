"""Kernel C (csrc/receive.cu, amtpu_decode_predicted): the cadence-predicted
slots of a turbo round, on the CPU.

* Its plain version, ``receive.decode_predicted_reference`` (the loop of
  ``receive.batch_decode_predicted``), and the whole round
  (``multi_receiver._multi_decode_core``) against the JAX package's
  ``_multi_decode_core`` and its lax.scan on the same numpy windows, in both
  branches (slot 0 from the full receive, or every slot predicted): packed
  matrices byte-identical. Cases: QPSK; BPSK-REPEAT (the vote); a slot in
  mid-round whose preamble is zeroed (its cumulative flag drops, the next
  slot still refines from its start); predicted positions clamped at
  0 and at w - 1; K = 1.
* A model of the kernel's decomposition in plain PyTorch, held to the plain
  loop: stages 1-2's normalized sample recomputed from the raw window
  (``PreSrc``), the chain's coarse clamp and refine region [lo, hi] a slot,
  the demod's FFT tiles a slot (row 0 the CE body, up to kFftRows - 1 data
  symbols; the spectrum from ``test_torch_fft_demod.fft_bins``, the model
  of the tile's FFT plan, the EQ tables from row 0, then the epilogue's
  pilot phase, ZF EQ, rotation and demap), and the pack's head and byte
  offsets in the [n, K, 5 + n_bytes] matrix. It records every sample each
  (stream, slot, tile) reads and checks that the plain loop reads the same
  values there.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from audio_modem_tpu.configs import MODES as JMODES
from test_torch_fft_demod import cu_constant, fft_bins, spectrum_columns
from audio_modem_tpu.parallel import multi_receiver as jmr
from audio_modem_tpu_torch import framing, phy, roofline, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.ops import constellations
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.parallel import multi_receiver as mr
from audio_modem_tpu_torch.tables import profile_tables

torch.set_num_threads(2)

N = 4
FFT_ROWS = cu_constant("kFftRows")  # rows of the demod's FFT tile: the CE row and FFT_ROWS - 1 data symbols


def _round(name: str, chunk: int, k: int = 3, noise: float = 0.01, zero: int | None = None, seed: int = 31,
           whole: bool = True, exact: bool = True):
    """N streams of k data frames of ``chunk`` payload bytes on the exact
    cadence, in windows padded as the runtime pads them, with AWGN of
    amplitude ``noise``. ``zero``: slot whose frame is zeroed on every
    stream, from twice the refine radius before its preamble to the next
    slot (``whole``), or from 200 samples before its preamble to the end of
    its CE symbol, in windows made ``exact`` (``chip_smoke.zeroed_exact``) or not
    (the stretch then becomes a small constant after the DC removal).
    Returns (mode, n_sym, cadence, windows [N, w], n_valid [N], silence
    before a frame)."""
    mode = MODES[name]
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(seed)
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    cadence = framing.estimate_frame_samples(chunk + 11, mode) + pre + post
    payloads = [framing.build_data_chunk_payload(rng.bytes(chunk), s % k) for s in range(N * k)]
    u8 = np.frombuffer(b"".join(payloads), np.uint8).reshape(N * k, -1)
    frames = framing._synth_frames_core(torch.from_numpy(u8.copy()), mode, n_sym, pre, post).numpy()
    w = -(-(k * cadence + 4 * sym + p.fft_size + 2048) // 128) * 128
    windows = np.zeros((N, w), np.float32)
    windows[:, : k * cadence] = frames.reshape(N, k * cadence)
    windows += noise * rng.standard_normal(windows.shape).astype(np.float32)
    nv = k * cadence
    if zero is not None:
        a = zero * cadence + pre
        lo, hi = (a - 6 * p.cp_len, (zero + 1) * cadence) if whole else (a - 200, a + 3 * sym)
        if exact:
            windows = chip_smoke.zeroed_exact(windows, nv, lo, hi)
        else:
            windows[:, lo:hi] = 0.0
    return mode, n_sym, cadence, windows, np.full(N, nv, np.int32), pre


def _jax_round(windows, n_valid, mode, n_sym, k, cadence, pred0=None) -> np.ndarray:
    jmode = JMODES[mode.name]
    if pred0 is None:
        zeros = jnp.zeros(windows.shape[0], jnp.int32)
        return np.asarray(jmr._batch_window_decode_multi(
            jnp.asarray(windows), zeros, jnp.asarray(n_valid), jmode, n_sym, k, cadence))
    core = jax.jit(partial(jmr._multi_decode_core, mode=jmode, n_sym_frame=n_sym, k_frames=k, cadence=cadence))
    return np.asarray(core(jnp.asarray(windows), jnp.asarray(n_valid), None, pred0=jnp.asarray(pred0)))


def _chain_start(windows, n_valid, mode, n_sym, cadence, pred0=None):
    """(start0, ok0, bits0) that ``_multi_decode_core`` hands kernel C: slot
    0 of the full receive's plain version, or the prediction."""
    x, nv = torch.from_numpy(windows), torch.from_numpy(n_valid)
    if pred0 is None:
        out0 = receive.decode_fused_reference(x, nv, torch.zeros(x.shape[0], dtype=torch.int32), mode, n_sym)
        return out0["start"], out0["detected"], out0["bits"]
    start0 = torch.from_numpy(pred0) - cadence
    return start0.to(torch.int32), torch.ones(x.shape[0], dtype=torch.bool), None


def _pred0(starts_true: np.ndarray, w: int, cadence: int, case: str) -> np.ndarray:
    if case == "drift":  # a few samples off the true start of slot 0
        return (starts_true + 3).astype(np.int32)
    # one stream each: on time, at w - 1, far past the window, far before it (a silent stream)
    return np.array([starts_true[0] + 3, w - 1, w + 10**6, -(10**6)], np.int32)


# (mode, payload bytes, K, noise, zeroed slot, branch, pred0 case)
PARITY = {
    "qpsk_scanned": ("QPSK", 256, 3, 0.01, None, "scanned", None),
    "qpsk_predicted": ("QPSK", 256, 3, 0.01, None, "predicted", "drift"),
    "repeat_scanned": ("BPSK-REPEAT", 48, 3, 0.01, None, "scanned", None),
    "repeat_predicted": ("BPSK-REPEAT", 48, 3, 0.01, None, "predicted", "drift"),
    "qpsk_zeroed_slot_scanned": ("QPSK", 256, 3, 0.01, 1, "scanned", None),
    "qpsk_zeroed_slot_predicted": ("QPSK", 256, 3, 0.01, 1, "predicted", "drift"),
    "repeat_zeroed_slot_predicted": ("BPSK-REPEAT", 48, 3, 0.01, 1, "predicted", "drift"),
    "qpsk_clamped": ("QPSK", 256, 3, 0.01, None, "predicted", "clamped"),
    "qpsk_k1_scanned": ("QPSK", 256, 1, 0.01, None, "scanned", None),
    "qpsk_k1_predicted": ("QPSK", 256, 1, 0.01, None, "predicted", "drift"),
}


def _case(name: str):
    mode_name, chunk, k, noise, zero, branch, pcase = PARITY[name]
    mode, n_sym, cadence, windows, n_valid, pre = _round(mode_name, chunk, k, noise, zero)
    pred0 = None if branch == "scanned" else _pred0(np.full(N, pre), windows.shape[1], cadence, pcase)
    if pcase == "clamped":
        windows[3] = 0.0
    return mode, n_sym, cadence, k, windows, n_valid, pred0, pre, zero


@pytest.mark.parametrize("name", list(PARITY))
def test_plain_kernel_c_matches_jax(name):
    mode, n_sym, cadence, k, windows, n_valid, pred0, pre, zero = _case(name)
    ref = _jax_round(windows, n_valid, mode, n_sym, k, cadence, pred0)
    start0, ok0, bits0 = _chain_start(windows, n_valid, mode, n_sym, cadence, pred0)
    reset_launch_counts()
    out = receive.decode_predicted_reference(
        torch.from_numpy(windows), torch.from_numpy(n_valid), start0, ok0, mode, n_sym, k, cadence, bits0)
    core = mr._multi_decode_core(
        torch.from_numpy(windows), torch.from_numpy(n_valid), None if pred0 is not None else torch.zeros(N, dtype=torch.int32),
        mode, n_sym, k, cadence, pred0=None if pred0 is None else torch.from_numpy(pred0)).numpy()
    assert launch_counts()["decode_predicted"] == 0  # the CPU runs the plain version
    n_bytes = n_sym * bits_per_symbol(mode) // mode.repetition // 8
    packed = out["packed"].numpy()
    assert packed.dtype == np.uint8 and packed.shape == ref.shape == (N, k, 5 + n_bytes)
    assert np.array_equal(packed, ref) and np.array_equal(core, ref)
    det, starts, _ = mr._unpack_round(packed)
    first = k - out["start"].shape[1]
    assert np.array_equal(out["start"].numpy(), starts[:, first:]) and np.array_equal(out["detected"].numpy(), det[:, first:])
    if pred0 is not None and name.endswith("clamped"):
        w = windows.shape[1]
        assert int(out["start"][1, 0]) == w - 1 == int(out["start"][2, 0])  # nothing to refine there: start = coarse
        assert not det[1:].any() and np.isneginf(out["fine_metric"][1:].numpy()).all()
        assert out["start"][3].tolist() == [0, cadence, 2 * cadence]  # clamped at 0, nothing to refine after
    elif zero is not None:
        assert det[:, :zero].all() and not det[:, zero:].any()
        # the slot after the miss is predicted from the missed slot's refined start, and finds its frame
        miss = zero - first
        coarse = np.asarray(starts[:, zero]) + cadence
        assert np.array_equal(starts[:, zero + 1], np.full(N, pre + (zero + 1) * cadence))
        assert (np.abs(starts[:, zero + 1] - coarse) <= 3 * mode.profile.cp_len).all()
        assert (out["fine_metric"][:, miss + 1].numpy() > 0.9).all()
    else:
        cls = mr._classify_round(packed, PARITY[name][1])
        assert cls is not None and cls[2].all()
        assert (cls[3] == np.arange(k)[None, :]).all()


def test_cpu_round_runs_the_plain_loop(monkeypatch):
    """On the CPU the round is the loop of batch_decode_predicted (kept beside
    kernel C's plain version in kernels/receive.py, re-exported by
    parallel/batch.py): one call a predicted slot, and no launch counted."""
    mode, n_sym, cadence, k, windows, n_valid, pred0, _, _ = _case("qpsk_predicted")
    assert batch.batch_decode_predicted is receive.batch_decode_predicted
    calls = []
    real = receive.batch_decode_predicted

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(receive, "batch_decode_predicted", counted)
    reset_launch_counts()
    mr._multi_decode_core(torch.from_numpy(windows), torch.from_numpy(n_valid), None, mode, n_sym, k, cadence,
                          pred0=torch.from_numpy(pred0))
    mr._multi_decode_core(torch.from_numpy(windows), torch.from_numpy(n_valid), torch.zeros(N, dtype=torch.int32),
                          mode, n_sym, k, cadence)
    assert len(calls) == k + (k - 1)
    assert not any(launch_counts().values())


def test_wrapper_refuses_a_mix_of_devices():
    mode, n_sym, cadence, k, windows, n_valid, pred0, _, _ = _case("qpsk_predicted")
    start0, ok0, _ = _chain_start(windows, n_valid, mode, n_sym, cadence, pred0)
    with pytest.raises(ValueError):
        receive.decode_predicted(torch.from_numpy(windows), torch.from_numpy(n_valid).to("meta"), start0, ok0, mode,
                                 n_sym, k, cadence)


# ---- the model of the kernel's decomposition ----


def _pre_src(x: torch.Tensor, nv: torch.Tensor):
    """Stages 1-2 and ``PreSrc``: sample i of row b is (x - mean) * scale for
    0 <= i < min(n_valid, T), else 0; mean from the pairwise row sum, scale
    from the extremes of the valid samples (tests/test_torch_kernel_a_tiling.py
    holds the tiled stages to these)."""
    t = x.shape[1]
    valid = torch.arange(t) < nv[:, None]
    mean = sync.pairwise_row_sum(torch.where(valid, x, 0.0)) / torch.clamp(nv[:, None].to(torch.float32), min=1.0)
    hi = torch.where(valid, x, -torch.inf).amax(-1, keepdim=True)
    lo = torch.where(valid, x, torch.inf).amin(-1, keepdim=True)
    amax = torch.where(torch.clamp(nv, max=t)[:, None] > 0, torch.maximum((hi - mean).abs(), (lo - mean).abs()), 0.0)
    scale = torch.where(amax > 1e-6, torch.reciprocal(torch.where(amax > 1e-6, amax, 1.0)), 1.0)

    def sample(b: int, idx: torch.Tensor) -> torch.Tensor:
        inside = (idx >= 0) & (idx < min(int(nv[b]), t))
        v = x[b, idx.clamp(0, t - 1)]
        return torch.where(inside, (v - mean[b]) * scale[b], 0.0)

    return sample


def _fft_tile(ce_body: torch.Tensor, bodies: torch.Tensor, mode) -> torch.Tensor:
    """The FFT tile on one CE body [fft] and g data bodies [g, fft]: the
    spectrum of every row (fft_bins), H = the CE row's spectrum x the known
    signs at the data and pilot bins, then the epilogue (pilot phase, ZF EQ,
    rotation, demap): bits [g * bits_per_symbol]."""
    p = mode.profile
    tabs = profile_tables(mode, "cpu")
    nd = p.num_data_subs
    rows = torch.cat([ce_body[None], bodies]).numpy()
    re, im = fft_bins(rows, tabs.fft_twiddle.numpy(), tabs.demod_bins.numpy())
    spec = torch.from_numpy(spectrum_columns(re, im, nd))
    npi = len(p.pilots)
    known = torch.cat([tabs.ce_known[tabs.data_pos], tabs.ce_known[tabs.pilot_pos]])
    h_re = torch.cat([spec[0, :nd], spec[0, 2 * nd : 2 * nd + npi]]) * known
    h_im = torch.cat([spec[0, nd : 2 * nd], spec[0, 2 * nd + npi :]]) * known
    d_re, d_im = spec[1:, :nd], spec[1:, nd : 2 * nd]
    p_re, p_im = spec[1:, 2 * nd : 2 * nd + npi], spec[1:, 2 * nd + npi :]
    pr, pi = phy.equalize(p_re, p_im, h_re[nd:], h_im[nd:])
    phi = phy._common_phase(pr, pi)[:, None]
    dr, di = phy.equalize(d_re, d_im, h_re[:nd], h_im[:nd])
    return constellations.demap(mode.constellation, dr + di * phi, di - dr * phi).reshape(-1)


def _model(windows, n_valid, start0, ok0, mode, n_sym, k, cadence, bits0=None):
    """Kernel C slot by slot as its launches index the data. Returns
    (packed [n, k, 5 + n_bytes], start, fine, flag [n, n_pred], reads:
    {(stream, slot): [(what, first sample, end)]})."""
    p = mode.profile
    sym, cp, fft = p.symbol_len, p.cp_len, p.fft_size
    tabs = profile_tables(mode, "cpu")
    n, t = windows.shape
    sample = _pre_src(windows, n_valid)
    n_pred = k - (bits0 is not None)
    radius = 3 * cp
    n_off = 2 * radius + 1
    bps_sym = bits_per_symbol(mode)
    slot_bits = n_sym * bps_sym
    mt = FFT_ROWS - 1  # data symbols a tile
    start = torch.zeros((n, n_pred), dtype=torch.int32)
    fine = torch.zeros((n, n_pred))
    flag = torch.zeros((n, n_pred), dtype=torch.bool)
    bits = torch.zeros((n, n_pred, slot_bits), dtype=torch.int8)
    reads: dict = {}
    for b in range(n):  # 3. the chain: one CTA a stream, the slots in order
        prev, ok = int(start0[b]), bool(ok0[b])
        for s in range(n_pred):
            c = min(max(prev + cadence, 0), t - 1)
            lo, hi = max(c - radius, 0), min(int(n_valid[b]) - sym, c + radius)
            region = sample(b, lo + torch.arange(n_off + sym - 1))
            corr = sync.sliding_correlate(region[None], p)[0]
            den = torch.sqrt(sync.windowed_sum(region[None] * region[None], sym)[0] * tabs.t_energy)
            metric = torch.where((den > sync.XCORR_MIN_DENOM) & (lo + torch.arange(n_off) <= hi),
                                 corr / torch.where(den > sync.XCORR_MIN_DENOM, den, 1.0), -torch.inf)
            best = metric.amax()
            st = lo + int(torch.argmax(metric)) if torch.isfinite(best) else c
            ok = ok and bool(best >= sync.XCORR_THRESHOLD)
            reads[(b, s)] = [("region", lo, lo + n_off + sym - 1)]
            start[b, s], fine[b, s], flag[b, s] = st, best, ok
            # 4. the demod: FFT tiles of the CE row and mt symbols of this slot, each its own CTA
            ce_at, base = st + 2 * sym + cp, st + 3 * sym
            for k0 in range(0, n_sym, mt):
                g = min(mt, n_sym - k0)
                idx = base + cp + (k0 + torch.arange(g))[:, None] * sym + torch.arange(fft)
                tile = _fft_tile(sample(b, ce_at + torch.arange(fft)), sample(b, idx), mode)
                bits[b, s, k0 * bps_sym : (k0 + g) * bps_sym] = tile
                reads[(b, s)] += [("ce", ce_at, ce_at + fft)]
                reads[(b, s)] += [("tile", base + (k0 + m) * sym + cp, base + (k0 + m + 1) * sym) for m in range(g)]
            prev = st
    # 5. the pack: one CTA a (slot, stream), rows at ((b * k) + slot) * (5 + n_bytes)
    rep = mode.repetition
    n_bytes = slot_bits // rep // 8
    flat = np.zeros(n * k * (5 + n_bytes), np.uint8)
    first = k - n_pred
    for b in range(n):
        for slot in range(k):
            if slot < first:
                src, st, f = bits0[b], int(start0[b]), bool(ok0[b])
            else:
                src, st, f = bits[b, slot - first], int(start[b, slot - first]), bool(flag[b, slot - first])
            row = (b * k + slot) * (5 + n_bytes)
            flat[row] = f
            flat[row + 1 : row + 5] = [(st >> sh) & 0xFF for sh in (24, 16, 8, 0)]
            voted = (src[: n_bytes * 8 * rep].reshape(-1, rep).to(torch.int32).sum(-1) * 2 >= rep).numpy()
            for j in range(n_bytes):
                flat[row + 5 + j] = int(sum(int(voted[8 * j + q]) << (7 - q) for q in range(8)))
    return flat.reshape(n, k, 5 + n_bytes), start, fine, flag, reads


MODEL = ["qpsk_scanned", "qpsk_predicted", "repeat_predicted", "qpsk_zeroed_slot_scanned",
         "repeat_zeroed_slot_predicted", "qpsk_clamped", "qpsk_k1_scanned", "qpsk_k1_predicted"]


@pytest.mark.parametrize("name", MODEL + ["narrow_predicted", "repeat_preamble_zeroed"])
def test_model_of_kernel_c_matches_the_plain_loop(name):
    if name == "narrow_predicted":  # 768-sample symbols, the narrow tile; nothing refines past the last frame
        mode, n_sym, cadence, windows, n_valid, pre = _round("BPSK-NARROW", 48)
        k, pred0 = 3, _pred0(np.full(N, pre), windows.shape[1], cadence, "drift")
    elif name == "repeat_preamble_zeroed":  # slot 1 keeps its data, without preamble; slot 2 finds its own
        mode, n_sym, cadence, windows, n_valid, pre = _round("BPSK-REPEAT", 48, noise=0.0, zero=1, whole=False,
                                                             exact=False)
        k, pred0 = 3, _pred0(np.full(N, pre), windows.shape[1], cadence, "drift")
    else:
        mode, n_sym, cadence, k, windows, n_valid, pred0, _, _ = _case(name)
    x, nv = torch.from_numpy(windows), torch.from_numpy(n_valid)
    start0, ok0, bits0 = _chain_start(windows, n_valid, mode, n_sym, cadence, pred0)
    plain = receive.decode_predicted_reference(x, nv, start0, ok0, mode, n_sym, k, cadence, bits0)
    packed, start, fine, flag, reads = _model(x, nv, start0, ok0, mode, n_sym, k, cadence, bits0)
    assert torch.equal(start, plain["start"]) and torch.equal(flag, plain["detected"])
    assert torch.equal(fine, plain["fine_metric"])
    assert np.array_equal(packed, plain["packed"].numpy())
    if name == "repeat_preamble_zeroed":
        assert not plain["detected"][:, 1:].any() and plain["detected"][:, 0].all()
        assert (plain["start"][:, 2] == pre + 2 * cadence).all() and (plain["fine_metric"][:, 2] > 0.9).all()
    # every sample the kernel reads is the plain loop's: inside the region, CE
    # symbol and data symbols it cuts out of the zero-extended windows
    p = mode.profile
    sym = p.symbol_len
    ext = batch.preprocess_extend(x, nv, mode, n_sym)
    sample = _pre_src(x, nv)
    n_pred = k - (bits0 is not None)
    assert sorted(reads) == [(b, s) for b in range(N) for s in range(n_pred)]
    for (b, s), spans in reads.items():
        st = int(plain["start"][b, s])
        lo = max(min(max((int(start0[b]) if s == 0 else int(plain["start"][b, s - 1])) + cadence, 0),
                     windows.shape[1] - 1) - 3 * p.cp_len, 0)
        allowed = {"region": (lo, lo + 6 * p.cp_len + sym), "ce": (st + 2 * sym, st + 3 * sym),
                   "tile": (st + 3 * sym, st + (3 + n_sym) * sym)}
        tiles = 0
        for what, a, e in spans:
            lo_ok, hi_ok = allowed[what]
            assert lo_ok <= a < e <= hi_ok, (what, a, e)
            idx = torch.arange(a, e)
            want = torch.where(idx < ext.shape[1], ext[b, idx.clamp(max=ext.shape[1] - 1)], 0.0)
            assert torch.equal(sample(b, idx), want)
            tiles += what == "tile"
        assert tiles == n_sym  # the tiles cover the slot's symbols once


def test_model_uses_the_kernels_tile_heights_and_pack_threads():
    """The model's tile is the kernel's: kFftRows rows (the CE row first),
    launched over (tiles of kFftRows - 1 symbols, slots, streams) with
    kThreadsFft threads, 16 a row; the chain one CTA a stream, the pack one
    a (slot, stream)."""
    src = (Path(receive.__file__).resolve().parent.parent / "csrc" / "receive.cu").read_text()
    assert FFT_ROWS == 42 and cu_constant("kThreadsFft") % 32 == 0
    assert "const int per = kFftRows - 1;" in src
    assert "predicted_demod_kernel<<<dim3((n_sym + per - 1) / per, n_pred, B), kThreadsFft, smem, stream>>>" in src
    assert "predicted_chain_kernel<<<B, chain_threads(cp), 0, stream>>>" in src
    assert "predicted_pack_kernel<<<dim3(k_slots, B), kThreadsPack, 0, stream>>>" in src
    assert re.search(r"fft_demod_tile\(pre, st \+ 2 \* sym \+ d\.cp, st \+ 3 \* sym \+ d\.cp \+ k0 \* sym", src)
    assert "AMTPU_LAUNCH_TILES(predicted_demod_kernel" not in src  # no path of C runs the product tile


def test_packed_sizes_are_what_the_host_reads():
    """n_bytes = n_sym * bits_per_symbol / repetition / 8 in every mode, and
    a 2048-byte QPSK chunk's row holds what _classify_round reads."""
    for mode in MODES.values():
        n_sym = framing.num_symbols_for_payload(mode.chunk_size + 11, mode)
        n_bytes = n_sym * bits_per_symbol(mode) // mode.repetition // 8
        assert n_bytes >= mode.chunk_size + 11
    q = MODES["QPSK"]
    n_sym = framing.num_symbols_for_payload(q.chunk_size + 11, q)
    assert n_sym == 41 and 7 + q.chunk_size + 4 <= n_sym * bits_per_symbol(q) // 8


def test_roofline_of_kernel_c_at_the_turbo_shape():
    """Kernel C's least time at the turbo round's shape: one read of the
    [64, 914,688] window over the H100's memory rate."""
    work = roofline.work_decode_predicted(MODES["QPSK"], 64, 914_688, 41, 32)
    ms, by = roofline.bound_ms(*work, roofline.card_peaks("NVIDIA H100 80GB HBM3"))
    assert by == "bytes" and 0.069 < ms < 0.073
    assert work[0] > 4 * 64 * 914_688 and work[1] > 4 * 64 * 32 * 385 * 576
