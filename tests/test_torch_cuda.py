"""Kernels A, B and C, the streaming demod and the chunked receiver's scan
on the card against their plain versions, at small shapes; kernel C in both branches of the turbo
round, on a zeroed slot, clamped predictions and K = 1, and the card's
round without a plain predicted slot; kernel A's pipeline also at B = 1, 3 and 64 on
windows that put its tiles' edges to the test; kernel B's pipeline and the
streaming demod at symbol counts around the demod tile's heights, on short,
all-zero and unaligned rows. Marked ``cuda``: on a
machine without a CUDA device each test skips with the reason (the CUDA
kernels have no CPU or interpret mode).

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

on a machine with an NVIDIA Hopper GPU and nvcc builds the kernels and runs
them."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from audio_modem_tpu_torch import MODES, api, bench, channel, decoder, framing, phy, sync
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.runtime.receiver import STREAM_MIN_ENERGY
from audio_modem_tpu_torch.tables import profile_tables
from test_torch_stream_scan import SCAN_CASES, scan_case
from test_torch_trace import _chunked_transfer

torch.set_num_threads(2)

FIVE_MODES = ["QPSK", "16-QAM", "BPSK-ACOUSTIC", "BPSK-NARROW", "64-QAM"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _windows(mode, n=3, size=64, noise=0.02, seed=5):
    rng = np.random.default_rng(seed)
    frames = framing.build_data_chunk_frames([rng.bytes(size) for _ in range(n)], 0, mode, device="cpu").numpy()
    frames = frames + noise * rng.standard_normal(frames.shape).astype(np.float32)
    sym = mode.profile.symbol_len
    signals, n_valid = batch.pad_signals(list(frames), pad_len=frames.shape[1] + 2 * sym)
    return signals, n_valid, (signals.shape[1] - 3 * sym) // sym


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE_MODES)
def test_kernel_a_matches_plain(cuda_device, name):
    mode = MODES[name]
    signals, n_valid, max_syms = _windows(mode)
    args = [torch.from_numpy(a).to(cuda_device) for a in (signals, n_valid, np.zeros(len(n_valid), np.int32))]
    reset_launch_counts()
    out = receive.decode_fused(*args, mode, max_syms)
    ref = receive.decode_fused_reference(*args, mode, max_syms)
    assert launch_counts()["decode_fused"] == 1
    for key in ("start", "coarse", "coarse_metric", "detected"):
        assert torch.equal(out[key], ref[key]), key
    assert out["detected"].all()
    assert (out["fine_metric"] - ref["fine_metric"]).abs().max().item() < 1e-5
    for key in ("ch_re", "ch_im"):
        assert (out[key] - ref[key]).abs().max().item() < 1e-4
    sym = mode.profile.symbol_len
    bps_sym = out["bits"].shape[1] // max_syms
    for i, s in enumerate(out["start"].tolist()):
        nb = (int(n_valid[i]) - (s + 3 * sym)) // sym * bps_sym
        assert torch.equal(out["bits"][i, :nb], ref["bits"][i, :nb])


PROFILE_MODES = ["QPSK", "BPSK-ACOUSTIC", "BPSK-NARROW"]  # the standard, acoustic and narrowband profiles
CASES = ["plain", "short", "min_pos", "noise", "straddle_scan_tile", "straddle_row_tile", "min_pos_past"]
FRAME_BYTES = 48
ROWS_PER_TILE, SCAN_TILE = 32, 512  # kernel A's tile sizes (csrc/receive.cu kRowsA, kScanTile)


def _kernel_a_windows(mode, b: int, first_case: int, seed: int = 17):
    """B windows of T samples (T a multiple of neither kernel A tile), stream
    i holding case CASES[(first_case + i) % 7]: a frame in the open; n_valid
    cutting the frame's last symbols; min_pos before the preamble; noise
    only; a preamble across a scan tile's or a row tile's boundary; min_pos
    past the frame. Returns numpy (signals, n_valid, min_pos, max_syms)."""
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(seed + first_case)
    frames = framing.build_data_chunk_frames([rng.bytes(FRAME_BYTES) for _ in range(4)], 0, mode, device="cpu")
    frames = frames.numpy()[:, p.silence_pre_chunk(False) - 200 :]
    flen = frames.shape[1]
    scan_span = SCAN_TILE * sync.COARSE_STRIDE
    row_span = ROWS_PER_TILE * sync.SUM_LANES
    t = 3 * row_span + flen + 1000
    assert t % scan_span and t % row_span
    signals = (0.02 * rng.standard_normal((b, t))).astype(np.float32)
    n_valid = np.full(b, t, np.int32)
    min_pos = np.zeros(b, np.int32)
    offsets = {"plain": 5000, "short": 20_000, "min_pos": 40_000, "noise": None,
               "straddle_scan_tile": 2 * scan_span - 200 - sym // 2,
               "straddle_row_tile": row_span - 200 - sym // 3, "min_pos_past": 7000}
    for i in range(b):
        case = CASES[(first_case + i) % len(CASES)]
        off = offsets[case]
        if off is not None:
            signals[i, off : off + flen] += frames[i % len(frames)]
        if case == "short":
            n_valid[i] = off + flen - 2 * sym
        if case == "min_pos":
            min_pos[i] = off - 3000
        if case == "min_pos_past":
            min_pos[i] = off + flen
    return signals, n_valid, min_pos, (t - 3 * sym) // sym


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILE_MODES)
@pytest.mark.parametrize("b, first_case", [(1, c) for c in range(len(CASES))] + [(3, 2), (64, 0)])
def test_kernel_a_pipeline_matches_plain(cuda_device, name, b, first_case):
    """Kernel A's six launches against decode_fused_reference: start, coarse,
    coarse metric and detected equal; fine metric within 1e-5, channel
    within 1e-4; every framed stream detected, and no flipped bit in its
    frame's symbols inside n_valid."""
    mode = MODES[name]
    sym = mode.profile.symbol_len
    signals, n_valid, min_pos, max_syms = _kernel_a_windows(mode, b, first_case)
    args = [torch.from_numpy(a).to(cuda_device) for a in (signals, n_valid, min_pos)]
    reset_launch_counts()
    out = receive.decode_fused(*args, mode, max_syms)
    ref = receive.decode_fused_reference(*args, mode, max_syms)
    torch.cuda.synchronize()
    assert launch_counts()["decode_fused"] == 1
    for key in ("start", "coarse", "coarse_metric", "detected"):
        assert torch.equal(out[key], ref[key]), (key, out[key][:8].tolist(), ref[key][:8].tolist())
    same = out["fine_metric"] == ref["fine_metric"]
    assert torch.where(same, 0.0, (out["fine_metric"] - ref["fine_metric"]).abs()).max().item() < 1e-5
    for key in ("ch_re", "ch_im"):
        assert (out[key] - ref[key]).abs().max().item() < 1e-4
    det = out["detected"].tolist()
    framed = [CASES[(first_case + i) % len(CASES)] not in ("noise", "min_pos_past") for i in range(b)]
    assert all(d for d, f in zip(det, framed) if f)
    bps_sym = out["bits"].shape[1] // max_syms
    n_sym_frame = framing.num_symbols_for_payload(FRAME_BYTES + 11, mode)
    for i, s in enumerate(out["start"].tolist()):
        if det[i]:  # the frame's own symbols inside n_valid (past them lies noise)
            nb = min(max((int(n_valid[i]) - (s + 3 * sym)) // sym, 0), n_sym_frame) * bps_sym
            assert nb > 0 and torch.equal(out["bits"][i, :nb], ref["bits"][i, :nb])


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE_MODES)
def test_kernel_b_matches_plain(cuda_device, name):
    mode = MODES[name]
    p = mode.profile
    rng = np.random.default_rng(9)
    n_sym = framing.num_symbols_for_payload(40 + 11, mode)
    fr = framing.build_data_chunk_frames([rng.bytes(40) for _ in range(4)], 0, mode, device=cuda_device)
    fr = fr[:, p.silence_pre_chunk(False) :].contiguous()
    reset_launch_counts()
    out = receive.decode_chunks_fused(fr, mode, n_sym)
    assert launch_counts()["decode_chunks_fused"] == 1
    assert torch.equal(out, receive.decode_chunks_fused_reference(fr, mode, n_sym))


def _chunk_frames(mode, b: int, n_sym: int, seed: int) -> np.ndarray:
    """[b, (3 + n_sym) * sym] frame-aligned frames: header, n_sym symbols of
    random bits, an echo inside the CP and a gain per frame. No noise: the
    plain version's matmul sums in another order than the kernel's fmaf
    chain, and a noisy 64-QAM point within 1e-6 of a decision boundary may
    then fall either way."""
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (min(b, 4), n_sym * bits_per_symbol(mode))).astype(np.int8))
    data = phy.modulate(bits, mode).reshape(bits.shape[0], -1)
    x = torch.cat([profile_tables(mode, "cpu").header.expand(bits.shape[0], -1), data], dim=1).numpy()
    x = x + 0.3 * np.roll(x, 5, axis=1)
    return (x[np.arange(b) % x.shape[0]] * rng.uniform(0.2, 3.0, (b, 1))).astype(np.float32)


KERNEL_B_CASES = [(name, b, n_sym) for name in FIVE_MODES for b in (1, 3, 64) for n_sym in (1, 8, 9, 41)]
KERNEL_B_CASES += [("BPSK-NARROW", 3, 598)]


@pytest.mark.cuda
@pytest.mark.parametrize("name, b, n_sym", KERNEL_B_CASES)
def test_kernel_b_pipeline_matches_plain(cuda_device, name, b, n_sym):
    """Kernel B's two launches against decode_chunks_fused_reference at
    symbol counts around its tile heights (23 and 31 symbols beside the CE
    row): every bit equal."""
    mode = MODES[name]
    fr = torch.from_numpy(_chunk_frames(mode, b, n_sym, seed=b + n_sym)).to(cuda_device)
    reset_launch_counts()
    out = receive.decode_chunks_fused(fr, mode, n_sym)
    torch.cuda.synchronize()
    assert launch_counts()["decode_chunks_fused"] == 1
    ref = receive.decode_chunks_fused_reference(fr, mode, n_sym)
    assert torch.equal(out, ref), f"{int((out != ref).sum())} of {out.numel()} bits differ"


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILE_MODES)
@pytest.mark.parametrize("case", ["short", "odd_length", "zero_frame"])
def test_kernel_b_edge_frames_match_plain(cuda_device, name, case):
    """A frame shorter than (3 + n_sym) * sym (samples past T read as zeros),
    a length that leaves the rows off 16-byte boundaries (the 4-byte staging
    path), and an all-zero frame beside live ones (peak <= 1e-6: samples pass
    through unscaled)."""
    mode = MODES[name]
    sym = mode.profile.symbol_len
    n_sym = 26
    fr = _chunk_frames(mode, 3, n_sym, seed=31)
    if case == "short":
        fr = fr[:, : fr.shape[1] - sym - sym // 3]
    elif case == "odd_length":
        fr = np.ascontiguousarray(fr[:, : fr.shape[1] - 3])
    else:
        fr[1] = 0.0
    t = torch.from_numpy(np.ascontiguousarray(fr)).to(cuda_device)
    out = receive.decode_chunks_fused(t, mode, n_sym)
    torch.cuda.synchronize()
    assert torch.equal(out, receive.decode_chunks_fused_reference(t, mode, n_sym))


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILE_MODES)
@pytest.mark.parametrize("case", ["wide_stride", "short_rows", "unaligned_rows"])
def test_stream_demod_edge_rows_match_plain(cuda_device, name, case):
    """The streaming demod on rows with a stride larger than L, on rows
    shorter than n_sym * sym (zeros past L), and on rows that start off a
    16-byte boundary."""
    mode = MODES[name]
    p = mode.profile
    sym = p.symbol_len
    n_sym = 37
    t = torch.from_numpy(_chunk_frames(mode, 3, n_sym, seed=13)).to(cuda_device)
    ch_re, ch_im = phy.estimate_channel(t[:, 2 * sym : 3 * sym], p)
    scale = torch.tensor([0.7, 1.0, 1.9], dtype=torch.float32, device=cuda_device)
    if case == "wide_stride":
        data = t[:, 3 * sym : 3 * sym + n_sym * sym - 100]  # L < n_sym * sym, row stride > L
    elif case == "short_rows":
        data = t[:, 3 * sym : (3 + n_sym - 2) * sym].contiguous()
    else:
        data = torch.nn.functional.pad(t, (1, 0))[:, 3 * sym + 1 :]
    assert data.stride(1) == 1
    out = receive.stream_demod(data, ch_re, ch_im, scale, mode, n_sym)
    torch.cuda.synchronize()
    assert torch.equal(out, receive.stream_demod_reference(data, ch_re, ch_im, scale, mode, n_sym))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE_MODES)
@pytest.mark.parametrize("b, n_sym", [(1, 13), (65, 9)])
def test_stream_demod_matches_plain(cuda_device, name, b, n_sym):
    """Symbol counts that are not a multiple of the kernel's group, one
    stream and 65 streams, per-stream scales other than 1, rows read through
    a strided view of the frames."""
    mode = MODES[name]
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(21)
    base = framing.build_data_chunk_frames([rng.bytes(400) for _ in range(min(b, 4))], 0, mode, device="cpu").numpy()
    frames = base[np.arange(b) % len(base), p.silence_pre_chunk(False) :]
    frames = frames + 0.02 * rng.standard_normal(frames.shape).astype(np.float32)
    t = torch.from_numpy(frames).to(cuda_device)
    ch_re, ch_im = phy.estimate_channel(t[:, 2 * sym : 3 * sym], p)
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(np.float32)).to(cuda_device)
    data = t[:, 3 * sym :]
    reset_launch_counts()
    out = receive.stream_demod(data, ch_re, ch_im, scale, mode, n_sym)
    assert launch_counts()["stream_demod"] == 1
    assert torch.equal(out, receive.stream_demod_reference(data, ch_re, ch_im, scale, mode, n_sym))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    mode = MODES["QPSK"]
    sig = torch.zeros(2, 8192, device=cuda_device)
    nv = torch.full((2,), 8192, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        receive.decode_fused(sig, nv, torch.zeros(2, dtype=torch.int32, device=cuda_device), mode, 2)
    with pytest.raises(ValueError):
        receive.decode_chunks_fused(sig[:, ::2], mode, 2)
    ch = torch.zeros(2, mode.profile.num_active_subs, device=cuda_device)
    with pytest.raises(ValueError):
        receive.stream_demod(sig[:, ::2], ch, ch, torch.ones(2, device=cuda_device), mode, 2)
    i32 = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # int64 heads
        receive.decode_tail(nv, nv, ch[:, 0].contiguous(), torch.zeros(2, 16, dtype=torch.int8, device=cuda_device),
                            ch, ch, 1)
    with pytest.raises(ValueError):  # a channel row short of the bits' batch
        receive.decode_tail(i32, i32, ch[:, 0].contiguous(), torch.zeros(2, 16, dtype=torch.int8, device=cuda_device),
                            ch[:1], ch[:1], 1)
    p = mode.profile
    row2 = torch.empty(2, 2, dtype=torch.int32, device=cuda_device)
    row1 = row2[:1]
    with pytest.raises(ValueError):  # float64 windows
        receive.stream_scan(sig.double(), 8192, p, STREAM_MIN_ENERGY, row2)
    with pytest.raises(ValueError):  # one row, not [B, W]
        receive.stream_scan(sig[0], 8192, p, STREAM_MIN_ENERGY, row1)
    with pytest.raises(ValueError):  # rows past the kernel's shared window
        receive.stream_scan(torch.zeros(1, 8208, device=cuda_device), 8208, p, STREAM_MIN_ENERGY, row1)
    with pytest.raises(ValueError):  # too short to hold a scan position
        receive.stream_scan(torch.zeros(1, 256, device=cuda_device), 256, p, STREAM_MIN_ENERGY, row1)
    with pytest.raises(ValueError):  # an out row of another shape
        receive.stream_scan(sig, 8192, p, STREAM_MIN_ENERGY, row1)
    with pytest.raises(ValueError):  # an out row of another dtype
        receive.stream_scan(sig, 8192, p, STREAM_MIN_ENERGY, row2.float())
    with pytest.raises(ValueError):  # an out row on the CPU
        receive.stream_scan(sig, 8192, p, STREAM_MIN_ENERGY, row2.cpu())


def _predicted_windows(name: str, chunk: int, n: int, k: int, noise: float = 0.01, zero: int | None = None,
                       seed: int = 31):
    """n streams of k data frames of ``chunk`` payload bytes on the exact
    cadence in the turbo round's padded windows, AWGN of amplitude
    ``noise``. ``zero``: slot whose frame is zeroed on every stream, from
    twice the refine radius before its preamble to the next slot
    (``chip_smoke.zeroed_exact``). Returns numpy (mode, n_sym,
    cadence, windows, n_valid, silence before a frame)."""
    mode = MODES[name]
    p = mode.profile
    sym = p.symbol_len
    rng = np.random.default_rng(seed)
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    pre = p.silence_pre_chunk(False)
    cadence = framing.estimate_frame_samples(chunk + 11, mode) + pre + p.silence_post_chunk()
    frames = framing.build_data_chunk_frames([rng.bytes(chunk) for _ in range(n * k)], 0, mode, device="cpu").numpy()
    w = -(-(k * cadence + 4 * sym + p.fft_size + 2048) // 128) * 128
    windows = np.zeros((n, w), np.float32)
    windows[:, : k * cadence] = frames.reshape(n, k * cadence)
    windows += noise * rng.standard_normal(windows.shape).astype(np.float32)
    nv = k * cadence
    if zero is not None:
        windows = chip_smoke.zeroed_exact(windows, nv, zero * cadence + pre - 6 * p.cp_len, (zero + 1) * cadence)
    return mode, n_sym, cadence, windows, np.full(n, nv, np.int32), pre


def _chain_inputs(x, nv, mode, n_sym, cadence, pred0=None):
    """(start0, ok0, bits0) as _multi_decode_core hands them to kernel C:
    slot 0 from kernel A, or the prediction."""
    if pred0 is None:
        out0 = receive.decode_fused(x, nv, torch.zeros_like(nv), mode, n_sym)
        return out0["start"], out0["detected"], out0["bits"]
    return (pred0 - cadence).to(torch.int32), torch.ones(x.shape[0], dtype=torch.bool, device=x.device), None


# (mode, payload bytes, streams, K, branch, case)
KERNEL_C_CASES = [
    ("QPSK", 256, 4, 3, "scanned", "plain"), ("QPSK", 256, 4, 3, "predicted", "plain"),
    ("16-QAM", 256, 4, 3, "predicted", "plain"), ("64-QAM", 256, 4, 3, "predicted", "plain"),
    ("BPSK-ACOUSTIC", 48, 4, 3, "predicted", "plain"), ("BPSK-REPEAT", 48, 4, 3, "scanned", "plain"),
    ("BPSK-REPEAT", 48, 4, 3, "predicted", "plain"), ("BPSK-NARROW", 48, 4, 3, "predicted", "plain"),
    ("QPSK", 256, 4, 3, "scanned", "zeroed"), ("QPSK", 256, 4, 3, "predicted", "zeroed"),
    ("BPSK-REPEAT", 48, 4, 3, "predicted", "zeroed"), ("QPSK", 256, 4, 3, "predicted", "clamped"),
    ("QPSK", 256, 4, 1, "scanned", "plain"), ("QPSK", 256, 4, 1, "predicted", "plain"),
    ("QPSK", 2048, 64, 8, "scanned", "plain"), ("QPSK", 2048, 64, 8, "predicted", "plain"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name, chunk, n, k, branch, case", KERNEL_C_CASES)
def test_kernel_c_matches_plain(cuda_device, name, chunk, n, k, branch, case):
    """Kernel C (decode_predicted) against its plain version on the card, in
    both branches (slot 0 from kernel A, or every slot predicted): a slot
    whose frame is zeroed (its flag and every later one drop; the next
    slot still finds its frame from the missed slot's start), predictions
    clamped at w - 1 and at 0 (a silent stream), K = 1, and 64 streams x K
    = 8 of 2048-byte chunks."""
    mode, n_sym, cadence, windows, n_valid, pre = _predicted_windows(name, chunk, n, k,
                                                                     zero=1 if case == "zeroed" else None)
    w = windows.shape[1]
    pred0 = None
    if branch == "predicted":
        pred0 = np.full(n, pre + 3, np.int32)
        if case == "clamped":
            pred0[1:4] = [w - 1, w + 10**6, -(10**6)]
            windows[3] = 0.0
    x, nv = torch.from_numpy(windows).to(cuda_device), torch.from_numpy(n_valid).to(cuda_device)
    p0 = None if pred0 is None else torch.from_numpy(pred0).to(cuda_device)
    start0, ok0, bits0 = _chain_inputs(x, nv, mode, n_sym, cadence, p0)
    reset_launch_counts()
    out = receive.decode_predicted(x, nv, start0, ok0, mode, n_sym, k, cadence, bits0)
    assert launch_counts()["decode_predicted"] == 1
    ref = receive.decode_predicted_reference(x, nv, start0, ok0, mode, n_sym, k, cadence, bits0)
    chip_smoke.compare_predicted(f"kernel C, {name} {branch} {case}", out, ref)  # strict: fails the test
    det = out["packed"][..., 0].bool().cpu()
    if case == "zeroed":
        assert det[:, :1].all() and not det[:, 1:].any()
        first = k - out["start"].shape[1]
        assert (out["start"][:, 2 - first] == pre + 2 * cadence).all()
        assert (out["fine_metric"][:, 2 - first] > 0.9).all()
    elif case == "clamped":
        assert not det[1:].any() and out["start"][3].tolist() == [0, cadence, 2 * cadence]
    else:
        assert det.all()


@pytest.mark.cuda
def test_card_round_runs_no_plain_slot(cuda_device, monkeypatch):
    """The turbo round on the card, both branches, out of a ring and over a
    two-shard mesh: the plain slot's bodies (receive.batch_decode_predicted
    and receive.preprocess_extend), patched to raise, are never called; kernel C
    launches once a round (once a shard), and the packed rows equal the
    CPU round's."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr
    from audio_modem_tpu_torch.parallel.mesh import make_mesh

    mode, n_sym, cadence, windows, n_valid, pre = _predicted_windows("QPSK", 256, 4, 3)
    w = windows.shape[1]
    zeros = np.zeros(4, np.int32)
    pred0 = np.full(4, pre + 3, np.int32)
    host = [mr._multi_decode_core(torch.from_numpy(windows), torch.from_numpy(n_valid), torch.from_numpy(zeros),
                                  mode, n_sym, 3, cadence).numpy(),
            mr._multi_decode_core(torch.from_numpy(windows), torch.from_numpy(n_valid), None, mode, n_sym, 3, cadence,
                                  pred0=torch.from_numpy(pred0)).numpy()]

    def refuse(*args, **kw):
        raise AssertionError("a plain predicted slot ran on the card")

    monkeypatch.setattr(receive, "batch_decode_predicted", refuse)
    monkeypatch.setattr(receive, "preprocess_extend", refuse)
    x, nv = torch.from_numpy(windows).to(cuda_device), torch.from_numpy(n_valid).to(cuda_device)
    reset_launch_counts()
    got = [mr._multi_decode_core(x, nv, torch.zeros_like(nv), mode, n_sym, 3, cadence),
           mr._multi_decode_core(x, nv, None, mode, n_sym, 3, cadence, pred0=torch.from_numpy(pred0).to(cuda_device))]
    assert launch_counts()["decode_predicted"] == 2 and launch_counts()["decode_fused"] == 1
    for g, h in zip(got, host):
        assert np.array_equal(g.cpu().numpy(), h)
    params = np.stack([np.zeros(4, np.int32), pred0, n_valid])
    for mesh, shards in ((None, 1), (make_mesh(devices=[cuda_device] * 2), 2)):
        ring = mr.DeviceRing(4, w, device=cuda_device, mesh=mesh)
        ring.write(windows)
        pparams = params.copy()
        pparams[0] = ring.rel(0)
        reset_launch_counts()
        pred = mr._batch_window_decode_pred_dev(ring, pparams, mode, n_sym, 3, cadence, w)
        assert launch_counts()["decode_predicted"] == shards and launch_counts()["decode_fused"] == 0
        assert np.array_equal(mr._to_host(pred), host[1])


def _awgn(x: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    power = float(np.mean(x.astype(np.float64) ** 2))
    return (x + rng.standard_normal(x.shape) * np.sqrt(power / 10 ** (snr_db / 10))).astype(np.float32)


def _decode_case(case: str):
    """(signal, mode, keywords, payload) for one rung of the decoder's ladder,
    or for an input that decodes to an error (payload None): a preamble cut
    off at the end of a signal that fills its padded bucket ("cut" at the
    standard profile, "cut-narrow" at the narrowband one, as in
    test_torch_decoder.py), and silence."""
    if case.startswith("short "):  # one short frame in each mode
        mode = MODES[case[len("short "):]]
        payload = np.random.default_rng(13).bytes(64)
        return _awgn(framing.build_transmit_signal(payload, mode, "s.bin", device="cpu").numpy(), 25.0, 5), mode, {}, payload
    if case.startswith("cut"):
        name, total, tail = chip_smoke.CUT_PREAMBLES[case == "cut-narrow"]
        return chip_smoke.cut_preamble(name, total, tail), MODES[name], {}, None
    if case == "silence":
        return np.zeros(40000, np.float32), MODES["QPSK"], {}, None
    if case == "clean":
        mode = MODES["QPSK"]
        payload = np.random.default_rng(12).bytes(2000)
        return framing.build_transmit_signal(payload, mode, "c.bin", device="cpu").numpy(), mode, {}, payload
    if case.startswith("config4"):  # BASELINE config 4: 16-QAM through multipath, at 28 or 22 dB
        mode = MODES["16-QAM"]
        payload = np.random.default_rng(47).bytes(2000)
        sig = framing.build_transmit_signal(payload, mode, "mp.bin", device="cpu").numpy()
        spec = channel.ChannelSpec(snr_db=float(case[-2:]), multipath=((23, 0.25), (61, 0.12)), gain=0.7,
                                   dc_offset=0.01)
        return channel.apply_channel_np(sig, spec, seed=2, device="cpu"), mode, {}, payload
    if case == "tracked":  # without the tracker the CRC fails at this drift
        mode = MODES["BPSK-ACOUSTIC"]
        payload = np.random.default_rng(11).bytes(5200)
        sig = framing.build_transmit_signal(payload, mode, "d.bin", device="cpu").numpy()
        spec = channel.ChannelSpec(clock_ppm=200.0, snr_db=25.0)
        return channel.apply_channel_np(sig, spec, seed=3, device="cpu"), mode, {"track_timing": True}, payload
    if case == "fec":
        mode = MODES["BPSK-ACOUSTIC"]
        sym = mode.profile.symbol_len
        payload = np.random.default_rng(41).bytes(150)
        sig = _awgn(framing.build_transmit_signal(payload, mode, "e.bin", fec=True, device="cpu").numpy(), 30.0, 4)
        s0 = mode.profile.silence_pre_legacy() + 8 * sym
        sig[s0 : s0 + 3 * sym] = 0.0
        return sig, mode, {}, payload
    mode = MODES["BPSK-REPEAT"]
    p = mode.profile
    payload = np.random.default_rng(42).bytes(96)
    sig = framing.build_transmit_signal(payload, mode, "f.bin", device="cpu").numpy()
    if case == "soft":  # data region at -2 dB: the hard vote fails
        d0 = p.silence_pre_legacy() + 3 * p.symbol_len
        sig[d0:] = _awgn(sig[d0:], -2.0, 4)
        return sig, mode, {}, payload
    return _awgn(sig, 3.0, 2), mode, {}, payload  # "xcorr": Schmidl-Cox misses at 3 dB


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["clean", "soft", "xcorr", "fec", "tracked", "config4-28", "config4-22", "cut",
                                  "cut-narrow", "silence"] + [f"short {name}" for name in MODES])
def test_api_decode_on_card_matches_cpu(cuda_device, case):
    """Every rung of the decoder's retry ladder, the error cases and a short
    frame in each mode on the card give what the plain path gives on the
    CPU, through kernel A at B = 1."""
    sig, mode, kw, payload = _decode_case(case)
    ref, rinfo = api.decode(sig, mode, device="cpu", **kw)
    reset_launch_counts()
    out, info = api.decode(torch.from_numpy(sig.copy()).to(cuda_device), mode, device=cuda_device, **kw)
    counts = launch_counts()
    assert counts["decode_fused"] >= 1 and counts["decode_tail"] == counts["decode_fused"]
    assert type(out).__name__ == type(ref).__name__
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    if payload is None:
        assert isinstance(out, framing.FrameError)
    else:
        assert out.crc_valid and out.data == payload
    assert (info is None) == (rinfo is None)
    if info is not None:
        assert (info.preamble_idx, info.coarse_idx) == (rinfo.preamble_idx, rinfo.coarse_idx)
        assert abs(info.fine_metric - rinfo.fine_metric) < 1e-5
    if case == "silence":
        assert out.error == "Preamble not detected" and info is None
    if case.startswith("cut"):
        _, total, tail = chip_smoke.CUT_PREAMBLES[case == "cut-narrow"]
        assert out.error == "Signal too short for CE" and info.preamble_idx == total - tail


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES + ["three_rows"])
@pytest.mark.parametrize("name", PROFILE_MODES)
def test_stream_scan_matches_plain(cuda_device, name, case):
    """The chunked receiver's scan kernel bit for bit against
    ``sync.detect_preamble`` (the receiver's energy gate, COARSE_STRIDE), on
    the card's tensors and on the CPU: coarse index and best metric, in one
    launch, on the windows of tests/test_torch_stream_scan.py; ``three_rows``
    is B = 3 of them valid up to one n_valid."""
    p = MODES[name].profile
    if case == "three_rows":
        x = np.stack([scan_case(MODES[name], c)[0] for c in ("junk_past_n_valid", "last_valid", "rising_end")])
        nv = 5000
    else:
        x, nv = scan_case(MODES[name], case)
        x = x[None]
    win = torch.from_numpy(x).to(cuda_device)
    reset_launch_counts()
    rows = receive.stream_scan(win, nv, p, STREAM_MIN_ENERGY,
                               torch.empty((x.shape[0], 2), dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    assert launch_counts()["stream_scan"] == 1 and rows.shape == (x.shape[0], 2)
    got = rows.cpu()
    for xs in (win, win.cpu()):
        coarse, best = sync.detect_preamble(xs, p, nv, min_energy=STREAM_MIN_ENERGY, stride=sync.COARSE_STRIDE)
        assert torch.equal(got[:, 0], coarse.cpu().to(torch.int32)), (got[:, 0].tolist(), coarse.tolist())
        assert torch.equal(got[:, 1], best.cpu().view(torch.int32)), (got[:, 1].view(torch.float32).tolist(),
                                                                       best.tolist())


@pytest.mark.cuda
def test_chunked_decode_scans_every_window_on_the_kernel(cuda_device):
    """A short chunked transfer (tests/test_torch_trace.py: 3 QPSK chunks at
    30 dB) decoded on the card with the span recorder on: every scan window
    is one ``stream_scan`` launch and one read, and the result equals the
    CPU decode field by field."""
    from audio_modem_tpu_torch.utils import trace

    sig = _chunked_transfer()
    want = api.decode_chunked(sig, "QPSK", device="cpu")
    api.decode_chunked(sig, "QPSK", device=cuda_device)  # builds and loads the kernels
    trace.disable()
    trace.drain()
    reset_launch_counts()
    trace.enable()
    try:
        got = api.decode_chunked(sig, "QPSK", device=cuda_device)
    finally:
        trace.disable()
    spans, counters = trace.drain()
    assert counters["scan_windows"] > 0 and launch_counts()["stream_scan"] == counters["scan_windows"]
    reads = [s.attrs["what"] for s in spans if s.name == "decode.sync"]
    assert reads.count("scan") == counters["scan_windows"]
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.complete and got.crc_errors == 0


@pytest.mark.cuda
def test_decoder_raises_for_a_tensor_on_another_device(cuda_device):
    with pytest.raises(ValueError):
        decoder.decode_signal(torch.zeros(40000, device=cuda_device), MODES["QPSK"], device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIVE_MODES)
def test_decode_chunked_on_card_matches_cpu(cuda_device, name):
    """A 4-chunk file through api.decode_chunked on the card and on the CPU:
    the same result field by field, one stream_demod launch per frame."""
    mode = MODES[name]
    data = np.random.default_rng(61).bytes(3 * mode.chunk_size + 77)
    signal = torch.cat(list(api.encode_chunked(data, mode, "card.bin", device="cpu"))).numpy()
    want = api.decode_chunked(signal, mode, device="cpu")
    reset_launch_counts()
    got = api.decode_chunked(signal, mode, device=cuda_device)
    assert launch_counts()["stream_demod"] >= 5
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.complete and got.total_chunks == 4 and got.data == data
    # a tensor on the card is brought to the host as audio
    again = api.decode_chunked(torch.from_numpy(signal).to(cuda_device), mode, device=cuda_device)
    assert dataclasses.asdict(again) == dataclasses.asdict(want)


@pytest.mark.cuda
def test_device_ring_on_card_matches_cpu(cuda_device):
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    rng = np.random.default_rng(8)
    card, host = mr.DeviceRing(3, 384, device=cuda_device), mr.DeviceRing(3, 384, device="cpu")
    assert card.buf.device.type == "cuda"
    for l in (100, 384, 500, 7, 300):
        x = rng.standard_normal((3, l)).astype(np.float32)
        card.write(torch.from_numpy(x).to(cuda_device) if l % 2 else x)
        host.write(x)
        total = host.total_written
        assert card.total_written == total and torch.equal(card.buf.cpu(), host.buf)
        for g in (total - 384, total - 200, total - 1):
            for length in (1, 150, 384):
                a, b = card.get_range(1, g, length), host.get_range(1, g, length)
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
        starts = [total - 384, total - 90, total - 200]
        assert np.array_equal(card.gather_ranges([2, 0, 1], starts, 90), host.gather_ranges([2, 0, 1], starts, 90))


@pytest.mark.cuda
def test_ring_round_on_card_matches_cpu(cuda_device):
    """The three dispatch functions out of a ring on the card against the
    same ring on the CPU: starts and detected flags equal, payload bytes
    equal."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    mode = MODES["QPSK"]
    p = mode.profile
    n, k, chunk = 3, 2, 256
    rng = np.random.default_rng(9)
    n_sym = framing.num_symbols_for_payload(chunk + 11, mode)
    cadence = framing.estimate_frame_samples(chunk + 11, mode) + p.silence_pre_chunk(False) + p.silence_post_chunk()
    frames = framing.build_data_chunk_frames([rng.bytes(chunk) for _ in range(n * k)], 0, mode, device="cpu").numpy()
    stream = frames.reshape(n, k * cadence) + 0.01 * rng.standard_normal((n, k * cadence)).astype(np.float32)
    w = -(-(k * cadence + 4 * p.symbol_len + p.fft_size + 2048) // 128) * 128
    stream = np.pad(stream, ((0, 0), (9000, w - k * cadence))).astype(np.float32)
    card, host = mr.DeviceRing(n, w + 512, device=cuda_device), mr.DeviceRing(n, w + 512, device="cpu")
    for off in range(0, stream.shape[1], 4096):
        card.write(stream[:, off : off + 4096])
        host.write(stream[:, off : off + 4096])
    params = np.stack([np.full(n, host.rel(9000), np.int32), np.zeros(n, np.int32), np.full(n, w, np.int32)])
    reset_launch_counts()
    got = mr._batch_window_decode_multi_dev(card, params, mode, n_sym, k, cadence, w).cpu().numpy()
    assert launch_counts()["decode_fused"] == 1
    want = mr._batch_window_decode_multi_dev(host, params, mode, n_sym, k, cadence, w).numpy()
    assert np.array_equal(got, want)
    det, starts, full, _ = mr._classify_round(got, chunk)
    assert det.all() and full.all()
    one = mr._batch_window_decode_dev(card, params, mode, n_sym, w).cpu().numpy()
    assert np.array_equal(one, want[:, 0])
    pparams = np.stack([params[0], starts[:, 0].astype(np.int32), params[2]])
    reset_launch_counts()
    pred = mr._batch_window_decode_pred_dev(card, pparams, mode, n_sym, k, cadence, w).cpu().numpy()
    assert launch_counts()["decode_fused"] == 0
    assert np.array_equal(pred, mr._batch_window_decode_pred_dev(host, pparams, mode, n_sym, k, cadence, w).numpy())
    assert np.array_equal(pred, want)


def _feed_blocks(rx, signals, block: int, to=None) -> None:
    t = max(len(s) for s in signals)
    for off in range(0, t, block):
        blocks = np.zeros((len(signals), block), np.float32)
        for i, s in enumerate(signals):
            seg = s[off : off + block]
            blocks[i, : len(seg)] = seg
        rx.process_blocks(blocks if to is None else torch.from_numpy(blocks).to(to))
    rx.flush()


def _receiver_state(rx) -> list:
    out = []
    for s, r in zip(rx.streams, rx.results()):
        stats = dataclasses.asdict(r["stats"])
        stats.pop("started_at")
        out.append((r["complete"], r["data"], r["file_name"], r["missing"], stats, s.scan_pos, s.state.name, s.gen,
                    s.assembler.bitmap().tolist()))
    return out


def _chunked_signals(n_files: int, size, seed: int, **kw) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    files = [rng.bytes(size(i)) for i in range(n_files)]
    signals = [torch.cat(list(api.encode_chunked(f, "QPSK", f"f{i}.bin", device="cpu", **kw))).numpy()
               for i, f in enumerate(files)]
    return files, signals


@pytest.mark.cuda
@pytest.mark.parametrize("window_decode", [False, True], ids=["staged", "turbo"])
def test_batch_receiver_on_card_matches_cpu(cuda_device, window_decode):
    """Eight streams, eight files, host-fed: the staged machine (kernel B)
    or the turbo machine (kernel A) on the card ends in the CPU run's
    state, with every file exact."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    files, signals = _chunked_signals(8, lambda i: MODES["QPSK"].chunk_size + 100 * i, 61)
    runs = {}
    for dev in ("cpu", cuda_device):
        reset_launch_counts()
        rx = mr.BatchReceiver(MODES["QPSK"], 8, window_decode=window_decode, device=dev)
        _feed_blocks(rx, signals, 4096)
        runs[str(dev)] = (_receiver_state(rx), launch_counts(), {k: v["calls"] for k, v in rx.timer.report().items()})
    (cpu, cpu_launches, cpu_stages), (card, card_launches, card_stages) = runs.values()
    assert card == cpu and card_stages == cpu_stages
    assert not any(cpu_launches.values())
    assert card_launches["decode_fused" if window_decode else "decode_chunks_fused"] >= 1
    for (complete, data, *_), f in zip(card, files):
        assert complete and data == f


@pytest.mark.cuda
def test_batch_receiver_device_ingest_on_card(cuda_device):
    """Sixteen streams of four files through the device ring on the card,
    blocks as tensors on the card: the CPU run's state, exact files, kernel
    A launched."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    files, signals = _chunked_signals(4, lambda i: 8000, 91, batch=8)
    signals = [signals[i % 4] for i in range(16)]
    runs = []
    for dev in ("cpu", cuda_device):
        reset_launch_counts()
        rx = mr.BatchReceiver(MODES["QPSK"], 16, scan_bucket=65536, device_ingest=True, device=dev)
        _feed_blocks(rx, signals, 16384, to=dev)
        runs.append((_receiver_state(rx), launch_counts()))
    assert runs[1][0] == runs[0][0]
    assert runs[1][1]["decode_fused"] >= 1
    for i, (complete, data, *_) in enumerate(runs[1][0]):
        assert complete and data == files[i % 4]


@pytest.mark.cuda
def test_pinned_pipeline_matches_depth_zero(cuda_device):
    """The speculative pipeline on the card (pinned host buffers, one event
    per round) ends in the state of synchronous fetches (depth 0), and
    both equal the CPU run's; a cadence break forces a rollback."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    mode = MODES["QPSK"]
    f = np.random.default_rng(223).bytes(mode.chunk_size * 20)
    frames = [x.numpy() for x in api.encode_chunked(f, mode, "g.bin", batch=24, device="cpu")]
    sig = np.concatenate(frames[:8] + [np.zeros(60_000, np.float32)] + frames[8:])
    states = {}
    for dev, depth in ((cuda_device, 6), (cuda_device, 0), ("cpu", 6)):
        rx = mr.BatchReceiver(mode, 2, scan_bucket=65536, device_ingest=True, frames_per_round=4,
                              pipeline_depth=depth, device=dev)
        _feed_blocks(rx, [sig, sig], 32768, to=dev)
        rep = rx.timer.report()
        assert ("pipe_fetch" in rep) == (depth > 0)
        states[(str(dev), depth)] = _receiver_state(rx)
    card6, card0, cpu6 = states.values()
    assert card6 == cpu6
    assert [s[:7] + s[8:] for s in card6] == [s[:7] + s[8:] for s in card0]  # all but the generation
    assert all(complete and data == f for complete, data, *_ in card6)
    assert any(s[7] > 0 for s in card6), "no speculative rollback occurred"


@pytest.mark.cuda
def test_process_blocks_takes_a_card_tensor_without_a_host_copy(cuda_device, monkeypatch):
    """A block already on the card goes into the device ring in place: the
    ring's buffer keeps its storage, the block is never brought to the host
    (no .cpu() or .numpy() of a tensor as large as the block), and the ring
    holds the block."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr

    n, block = 4, 16384
    rx = mr.BatchReceiver(MODES["QPSK"], n, scan_bucket=65536, device_ingest=True, device=cuda_device)
    ptr = rx.dring.buf.data_ptr()
    big = []
    for name in ("cpu", "numpy"):
        inner = getattr(torch.Tensor, name)

        def watched(t, *a, _inner=inner, **k):
            if t.numel() >= n * block:
                big.append(tuple(t.shape))
            return _inner(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, watched)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    blocks = [torch.randn((n, block), generator=gen, device=cuda_device) * 1e-3 for _ in range(3)]
    for b in blocks:
        rx.process_blocks(b)
    assert big == []
    assert rx.dring.buf.data_ptr() == ptr and rx.dring.total_written == 3 * block
    monkeypatch.undo()
    got = mr._ring_gather(rx.dring, range(n), [rx.dring.rel(0)] * n, 3 * block)
    assert torch.equal(got, torch.cat(blocks, dim=1))


@pytest.mark.cuda
def test_cli_decode_and_listen_on_card(cuda_device, tmp_path, monkeypatch):
    """The CLI on the card (its default compute device): encode -> decode of
    a legacy frame, and play -> listen of a chunked PCM file in f32 and s16;
    exact bytes; kernel A launched by decode, the streaming demod by listen."""
    from audio_modem_tpu_torch import cli

    rng = np.random.default_rng(21)
    small, big = rng.bytes(2000), rng.bytes(40 * 1024)
    (tmp_path / "small.bin").write_bytes(small)
    (tmp_path / "big.bin").write_bytes(big)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["encode", "small.bin", "s.wav"]) == 0
    reset_launch_counts()
    assert cli.main(["decode", "s.wav", "-o", "out.bin"]) == 0
    assert (tmp_path / "out.bin").read_bytes() == small and launch_counts()["decode_fused"] >= 1
    for pcm in ("f32", "s16"):
        assert cli.main(["play", "big.bin", f"{pcm}.pcm", "--no-pace", "--pcm", pcm]) == 0
        reset_launch_counts()
        assert cli.main(["listen", f"{pcm}.pcm", "-o", f"{pcm}.bin", "--pcm", pcm]) == 0
        assert (tmp_path / f"{pcm}.bin").read_bytes() == big
        assert launch_counts()["stream_demod"] >= 1 + -(-len(big) // MODES["QPSK"].chunk_size)
    with pytest.raises(SystemExit):
        cli.main(["--torch-device", "tpu", "info"])


@pytest.mark.cuda
def test_arq_sessions_on_card_match_cpu(cuda_device):
    """Selective repeat on the card gives the CPU's reports: one stream with
    chunk 1's frame dropped once, and 4 streams of the batched runtime with
    a frame dropped on the even ones (kernel B launched)."""
    from audio_modem_tpu_torch import arq

    mode = MODES["QPSK"]
    cs = mode.chunk_size
    rng = np.random.default_rng(22)
    data = rng.bytes(3 * cs)
    meta_len = framing.build_metadata_frame(3, 3 * cs, cs, "a.bin", mode, device="cpu").shape[0]
    chunk_len = framing.build_data_chunk_frame(data[:cs], 0, mode, device="cpu").shape[0]

    def dropper(first_only):
        seen = {}

        def fwd(i, sig):
            seen[i] = seen.get(i, 0) + 1
            if seen[i] == 1 and first_only(i):
                sig = sig.copy()
                sig[meta_len + chunk_len : meta_len + 2 * chunk_len] = 0.0
            return sig

        return fwd

    reports = {}
    for dev in (cuda_device, "cpu"):
        one = dropper(lambda i: True)
        single = arq.run_arq_session(data, mode, "a.bin", lambda s: one(0, s), device=dev)
        reset_launch_counts()
        batch_reps = arq.run_batch_arq_session([data] * 4, mode, [f"s{i}.bin" for i in range(4)],
                                               dropper(lambda i: i % 2 == 0), device=dev)
        if dev != "cpu":
            assert launch_counts()["decode_chunks_fused"] >= 1
        reports[str(dev)] = [dataclasses.asdict(r) for r in [single, *batch_reps]]
    card, cpu = reports.values()
    assert card == cpu
    assert all(r["complete"] and r["data"] == data for r in card)
    assert card[0]["chunks_sent_per_round"] == [3, 1]
    assert [r["chunks_sent_per_round"] for r in card[1:]] == [[3, 1], [3], [3, 1], [3]]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["QPSK", "BPSK-NARROW"])
def test_kernels_on_a_card_that_is_not_current(two_cards, name):
    """Kernels A, B and C and the streaming demod on tensors of cuda:1 while
    cuda:0 is current: each launches on its tensors' card (with that card's
    shared-memory attribute) and equals its plain version there, and so does
    api.decode of a short frame; tensors of two cards are refused."""
    current, other = two_cards
    with torch.cuda.device(current):
        test_kernel_a_matches_plain(other, name)
        test_kernel_b_matches_plain(other, name)
        test_stream_demod_matches_plain(other, name, 65, 9)
        test_kernel_c_matches_plain(other, name, 48, 4, 3, "scanned", "plain")
        test_api_decode_on_card_matches_cpu(other, f"short {name}")
        assert torch.cuda.current_device() == current.index
        x = torch.zeros(2, 4096, device=other)
        with pytest.raises(ValueError, match="one card"):
            receive.decode_fused(x, torch.zeros(2, dtype=torch.int32, device=current),
                                 torch.zeros(2, dtype=torch.int32, device=other), MODES[name], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["virtual", "two_cards"])
def test_sharded_batch_receiver_matches_unsharded(cuda_device, cards):
    """Sixteen streams of four files, blocks on the card, through a receiver
    sharded over [cuda:0] * 2 (or over two cards) and an un-sharded one: the
    same state and stage counts, exact files, kernel A launched on every
    shard; the ring keeps one shard a mesh device."""
    from audio_modem_tpu_torch.parallel import multi_receiver as mr
    from audio_modem_tpu_torch.parallel.mesh import make_mesh

    if cards == "two_cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_mesh(devices=[cuda_device] * 2) if cards == "virtual" else make_mesh(2)
    files, signals = _chunked_signals(4, lambda i: 8000, 91, batch=8)
    signals = [signals[i % 4] for i in range(16)]
    runs = []
    for kw in ({"device": cuda_device, "device_ingest": True}, {"mesh": mesh}):
        reset_launch_counts()
        rx = mr.BatchReceiver(MODES["QPSK"], 16, scan_bucket=65536, **kw)
        _feed_blocks(rx, signals, 16384, to=cuda_device)
        runs.append((_receiver_state(rx), launch_counts(), {k: v["calls"] for k, v in rx.timer.report().items()}))
        if "mesh" in kw:
            assert [b.device for b in rx.dring.shards] == list(mesh.devices)
    (plain, plain_launches, plain_stages), (sharded, sharded_launches, sharded_stages) = runs
    assert sharded == plain and sharded_stages == plain_stages
    assert sharded_launches["decode_fused"] == 2 * plain_launches["decode_fused"] >= 2
    assert sharded_launches["decode_predicted"] == 2 * plain_launches["decode_predicted"]
    for i, (complete, data, *_) in enumerate(sharded):
        assert complete and data == files[i % 4]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["BPSK-REPEAT", "64-QAM"])
def test_kernel_a_at_the_benchs_per_mode_shape(cuda_device, name):
    """Kernel A on the bench's per-mode input: 512 rows of 8 clean frames at
    the bench's payload size. Start, coarse, coarse metric and detected
    equal to the plain version's, fine metric within 1e-5, channel within
    1e-4, bits equal on the data symbols (the silence after them is a
    constant whose bins hold rounding residue)."""
    mode = MODES[name]
    payload = bench.mode_payload(name)
    _, sig, nv, max_syms = bench.chunk_frame_signals(np.random.default_rng(3), mode, payload, 8, 512, cuda_device)
    min_pos = torch.zeros(512, dtype=torch.int32, device=cuda_device)
    reset_launch_counts()
    out = receive.decode_fused(sig, nv, min_pos, mode, max_syms)
    assert launch_counts()["decode_fused"] == 1
    ref = receive.decode_fused_reference(sig, nv, min_pos, mode, max_syms)
    for key in ("start", "coarse", "coarse_metric", "detected"):
        assert torch.equal(out[key], ref[key]), key
    assert out["detected"].all()
    assert (out["fine_metric"] - ref["fine_metric"]).abs().max().item() < 1e-5
    for key in ("ch_re", "ch_im"):
        assert (out[key] - ref[key]).abs().max().item() < 1e-4
    nb = framing.num_symbols_for_payload(payload + 11, mode) * bits_per_symbol(mode)
    assert torch.equal(out["bits"][:, :nb], ref["bits"][:, :nb])


@pytest.mark.cuda
def test_stream_demod_on_the_benchs_32kb_qpsk_frames(cuda_device):
    """The streaming demod on the bench's long_frame_standard input: 64 rows
    of 8 QPSK frames of a 32 KB payload (640 symbols of 576 samples) under
    AWGN of 0.02, bit for bit against its plain version and kernel B. (At
    that noise the 262,400 bits of a row carry a few errors in every
    version, so the rows are not CRC-valid; the bench reads only rates.)"""
    mode = MODES["QPSK"]
    p = mode.profile
    rng = np.random.default_rng(4)
    n_sym = framing.num_symbols_for_payload(32768 + 11, mode)
    one = framing.build_data_chunk_frame(rng.bytes(32768), 0, mode, device=cuda_device)
    one = one[p.silence_pre_chunk(False) :][: (3 + n_sym) * p.symbol_len].cpu().numpy()
    host = np.tile(one, (8, 1)) + bench.LONG_NOISE * rng.standard_normal((8, one.shape[0])).astype(np.float32)
    frames = torch.from_numpy(host).to(cuda_device)[torch.arange(64, device=cuda_device) % 8].contiguous()
    reset_launch_counts()
    ks = receive.decode_chunks_fused_stream(frames, mode, n_sym)
    assert launch_counts()["stream_demod"] == 1
    ps = receive.decode_chunks_fused_reference(frames, mode, n_sym)
    kb = receive.decode_chunks_fused(frames, mode, n_sym)
    assert n_sym == 640 and ks.shape == (64, n_sym * bits_per_symbol(mode))
    assert torch.equal(ks.to(torch.int32), ps.to(torch.int32)) and torch.equal(ks.to(torch.int32), kb.to(torch.int32))


@pytest.mark.cuda
def test_traced_decode_lines_up_with_the_device_trace(cuda_device):
    """The recorder's spans on torch.profiler's clock: a decode of a
    recording on the card under a profile of the card alone records its
    spans (the recorder follows the profiler), and kernel A's first device
    event starts after its ``decode.kernel_a`` span starts and before the
    first ``decode.sync`` span, the read that waits for it, ends."""
    from torch.profiler import ProfilerActivity, profile

    from audio_modem_tpu_torch.utils import trace

    mode = MODES["QPSK"]
    payload = np.random.default_rng(12).bytes(2000)
    sig = framing.build_transmit_signal(payload, mode, "c.bin", device=cuda_device)
    api.decode(sig, mode, device=cuda_device)  # builds and loads the kernels
    trace.disable()
    trace.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pair = trace.clock_pair()
        result, _ = api.decode(sig, mode, device=cuda_device)
        torch.cuda.synchronize()
    assert not trace.enabled()
    spans, counters = trace.drain()
    assert result.crc_valid and result.data == payload
    assert counters["host_syncs"] == counters["tries"] == counters["tail_rows"] == 1
    mapped = trace.on_profile_clock(spans, pair, prof.profiler.kineto_results.trace_start_ns())
    kernel_a = min(s.start_ns / 1e3 for s in mapped if s.name == "decode.kernel_a")
    first_sync_end = min(s.end_ns / 1e3 for s in mapped if s.name == "decode.sync")
    cuda = torch.autograd.DeviceType.CUDA
    first_a = min(ev.time_range.start for ev in prof.events()
                  if ev.device_type == cuda and "pre_stats_kernel" in ev.name)
    assert kernel_a < first_a < first_sync_end, (kernel_a, first_a, first_sync_end)


# (mode, samples): the benchmark's two profiles at their recordings' lengths
# (BASELINE config 2, BPSK-REPEAT; config 1, BPSK-NARROW) and a 32 KB QPSK frame
TAIL_PROFILES = [("BPSK-REPEAT", 7_906_500), ("BPSK-NARROW", 963_396), ("QPSK", 392_418)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name, samples", TAIL_PROFILES)
def test_decode_tail_matches_plain(cuda_device, name, samples, b):
    """The one-shot decoder's tail kernel bit for bit against its plain
    version on the card, over kernel A's output shapes at the decoder's
    bucket for ``samples``: random heads, channels and bits. The head and
    the bytes equal the plain version's on the CPU too; its |H| does not
    have to, since PyTorch's CPU square root is not always correctly
    rounded where the card's is."""
    mode = MODES[name]
    max_syms = decoder._max_symbols(decoder._bucket_len(samples), mode)
    n_active = mode.profile.num_active_subs
    g = torch.Generator(device=cuda_device).manual_seed(samples + b)
    f32 = dict(generator=g, device=cuda_device)
    args = (
        torch.randint(-1, samples, (b,), dtype=torch.int32, **f32),
        torch.randint(0, samples, (b,), dtype=torch.int32, **f32),
        torch.rand(b, **f32),
        torch.randint(0, 2, (b, max_syms * bits_per_symbol(mode)), dtype=torch.int8, **f32),
        torch.randn(b, n_active, **f32),
        torch.randn(b, n_active, **f32),
    )
    reset_launch_counts()
    rows = receive.decode_tail(*args, mode.repetition)
    assert launch_counts()["decode_tail"] == 1
    ref = receive.decode_tail_reference(*args, mode.repetition)
    assert rows.shape == ref.shape and torch.equal(rows, ref)
    on_cpu = receive.decode_tail_reference(*(t.cpu() for t in args), mode.repetition)
    mag = slice(receive.TAIL_HEAD, receive.TAIL_HEAD + 4 * n_active)
    assert torch.equal(rows.cpu()[:, : mag.start], on_cpu[:, : mag.start])
    assert torch.equal(rows.cpu()[:, mag.stop :], on_cpu[:, mag.stop :])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["BPSK-NARROW", "QPSK"])
def test_decode_tail_on_kernel_a_outputs(cuda_device, name):
    """The tail over kernel A's own outputs on a frame: bit for bit its plain
    version, and the decoder's bytes a prefix of the row's."""
    mode = MODES[name]
    payload = np.random.default_rng(8).bytes(1024)
    sig = framing.build_transmit_signal(payload, mode, "t.bin", device=cuda_device)
    padded = decoder.pad_to_bucket(sig)
    max_syms = decoder._max_symbols(padded.shape[0], mode)
    out = decoder._core_dispatch(padded, sig.shape[0], 0, mode, max_syms)
    keys = ("coarse", "start", "fine_metric", "bits", "ch_re", "ch_im")
    rows = receive.decode_tail(*(out[k] for k in keys), mode.repetition)
    assert torch.equal(rows, receive.decode_tail_reference(*(out[k] for k in keys), mode.repetition))
    raw, info = decoder.decode_raw(sig, mode, device=cuda_device)
    _, start, _, mag, packed = receive.split_tail_row(rows.cpu().numpy()[0], mode.profile.num_active_subs)
    assert start == info.preamble_idx and np.array_equal(mag, info.channel_mag)
    assert packed[: len(raw)].tobytes() == raw


@pytest.mark.cuda
@pytest.mark.parametrize("name, chunk", [("QPSK", 2048), ("BPSK-REPEAT", 512)])
def test_kernel_c_packs_slot_0_as_the_plain_vote_and_pack(cuda_device, name, chunk):
    """Kernel C's slot 0 with its bits given, which it votes and packs through
    the ``vote_pack`` body the tail shares, bit for bit the plain vote and
    pack (``receive.vote_pack``) of random bits, flags and starts,
    at the turbo round's chunk sizes (BPSK-REPEAT: the vote over three
    copies)."""
    mode, n_sym, cadence, windows, n_valid, _ = _predicted_windows(name, chunk, 8, 2)
    x, nv = torch.from_numpy(windows).to(cuda_device), torch.from_numpy(n_valid).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(chunk)
    n = x.shape[0]
    start0 = torch.randint(0, cadence, (n,), dtype=torch.int32, generator=g, device=cuda_device)
    ok0 = torch.rand(n, generator=g, device=cuda_device) < 0.75
    bits0 = torch.randint(0, 2, (n, n_sym * bits_per_symbol(mode)), dtype=torch.int8, generator=g,
                          device=cuda_device)
    out = receive.decode_predicted(x, nv, start0, ok0, mode, n_sym, 2, cadence, bits0)
    assert torch.equal(out["packed"][:, 0], receive.vote_pack(ok0, start0, bits0, mode))
