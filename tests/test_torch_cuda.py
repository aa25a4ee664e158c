"""Kernels A and B and the streaming demod on the card against their plain
versions, at small shapes; kernel A's pipeline also at B = 1, 3 and 64 on
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

from audio_modem_tpu_torch import MODES, api, channel, decoder, framing, phy, sync
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.tables import profile_tables

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


def _awgn(x: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    power = float(np.mean(x.astype(np.float64) ** 2))
    return (x + rng.standard_normal(x.shape) * np.sqrt(power / 10 ** (snr_db / 10))).astype(np.float32)


def _decode_case(case: str):
    """(signal, mode, keywords, payload) for one rung of the decoder's ladder."""
    if case == "clean":
        mode = MODES["QPSK"]
        payload = np.random.default_rng(12).bytes(2000)
        return framing.build_transmit_signal(payload, mode, "c.bin", device="cpu").numpy(), mode, {}, payload
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
@pytest.mark.parametrize("case", ["clean", "soft", "xcorr", "fec", "tracked"])
def test_api_decode_on_card_matches_cpu(cuda_device, case):
    """Every rung of the decoder's retry ladder on the card gives what the
    plain path gives on the CPU, through the streaming-demod kernel."""
    sig, mode, kw, payload = _decode_case(case)
    ref, rinfo = api.decode(sig, mode, device="cpu", **kw)
    reset_launch_counts()
    out, info = api.decode(torch.from_numpy(sig.copy()).to(cuda_device), mode, device=cuda_device, **kw)
    assert launch_counts()["stream_demod"] >= 1
    assert type(out).__name__ == type(ref).__name__
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.crc_valid and out.data == payload
    assert (info.preamble_idx, info.coarse_idx) == (rinfo.preamble_idx, rinfo.coarse_idx)
    assert abs(info.fine_metric - rinfo.fine_metric) < 1e-5


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
    assert cpu_launches == {"decode_fused": 0, "decode_chunks_fused": 0, "stream_demod": 0}
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
