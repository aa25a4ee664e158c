"""The chunked receiver's refine wrapper (``kernels/receive.py::stream_refine``)
on the CPU: given CPU tensors it returns ``sync.refine_xcorr`` of the
window zero-padded past its valid length, packed into one int32 row, and
launches nothing. The windows of ``REFINE_CASES`` are the ones the card
test (``tests/test_torch_cuda.py::test_stream_refine_matches_plain``) holds
the kernel to; here each is also checked to be the case it is named for.
Samples past a window's valid length change no result, which is what lets
the receiver refine in the scan's reused window without zeroing it; and a
CPU ``api.decode_chunked`` refines every frame exactly as the receiver did
when it cut each region into a zero-padded array of its own."""

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import api, framing, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.runtime import receiver
from audio_modem_tpu_torch.runtime.receiver import SCAN_BUCKET

torch.set_num_threads(2)

PROFILE_MODES = ["QPSK", "BPSK-ACOUSTIC", "BPSK-NARROW"]  # the standard, acoustic and narrowband profiles
REFINE_CASES = ["early_edge", "on_coarse", "late_edge", "lo_clamps", "cut_short", "junk_past_n_valid", "silence"]


def preamble_signal(mode, seed: int = 3, snr_db: float = 30.0) -> tuple[np.ndarray, int]:
    """A chunk frame from its preamble on, behind and in AWGN at ``snr_db``
    of the frame's power: (signal float32, the preamble's index). The
    preamble sits 2 * 3 cp samples in, and a full window follows it."""
    p = mode.profile
    rng = np.random.default_rng(seed)
    frame = framing.build_data_chunk_frames([rng.bytes(48)], 0, mode, device="cpu").numpy()[0]
    body = frame[p.silence_pre_chunk(False) :].astype(np.float64)
    at = 6 * p.cp_len
    x = np.zeros(at + SCAN_BUCKET + 6 * p.cp_len + 1)
    x[at : at + len(body)] = body[: len(x) - at]
    x += rng.standard_normal(len(x)) * np.sqrt(np.mean(body**2) / 10 ** (snr_db / 10))
    return x.astype(np.float32), at


def offset_window(mode, k: int, seed: int = 3) -> tuple[np.ndarray, int, int]:
    """The receiver's refine window with the preamble ``k`` samples past the
    coarse index (|k| <= 3 cp): (window [SCAN_BUCKET], coarse_rel, n_valid),
    as ``StreamingReceiver._refine`` stages it: the region of 6 cp + sym
    samples from 3 cp before the coarse index, and the signal that follows
    it past n_valid, as a reused window holds stale samples."""
    p = mode.profile
    x, at = preamble_signal(mode, seed)
    radius = 3 * p.cp_len
    s = at - radius - k
    return x[s : s + SCAN_BUCKET], radius, 2 * radius + p.symbol_len


def refine_case(mode, case: str, seed: int = 3) -> tuple[np.ndarray, int, int]:
    """One refine window of ``SCAN_BUCKET`` samples for ``case``: (window
    float32, coarse_rel, n_valid). R is 3 cp:

    - early_edge, on_coarse, late_edge: the preamble R before, at and R past
      the coarse index;
    - lo_clamps: the preamble at sample 5, the coarse index at 20, so the
      offsets start at 0, not at 20 - R;
    - cut_short: the preamble at the coarse index, n_valid R / 2 past its end,
      so the last offset is n_valid - sym, short of the coarse index + R;
    - junk_past_n_valid: the preamble 7 past the coarse index, loud noise
      past n_valid;
    - silence: all zeros.
    """
    p = mode.profile
    radius = 3 * p.cp_len
    if case in ("early_edge", "on_coarse", "late_edge"):
        return offset_window(mode, {"early_edge": -radius, "on_coarse": 0, "late_edge": radius}[case], seed)
    if case == "lo_clamps":
        x, at = preamble_signal(mode, seed)
        return x[at - 5 : at - 5 + SCAN_BUCKET], 20, 2 * radius + p.symbol_len
    if case == "cut_short":
        x, c, _ = offset_window(mode, 0, seed)
        return x, c, c + p.symbol_len + radius // 2
    if case == "junk_past_n_valid":
        x, c, nv = offset_window(mode, 7, seed)
        x = x.copy()
        x[nv:] = 10 * np.random.default_rng(seed + 1).standard_normal(len(x) - nv)
        return x, c, nv
    if case == "silence":
        return np.zeros(SCAN_BUCKET, np.float32), radius, 2 * radius + p.symbol_len
    raise ValueError(case)


def zero_padded(x: np.ndarray, n_valid: int) -> torch.Tensor:
    """The first ``n_valid`` samples of ``x``, zeros past them, at ``x``'s
    length; cut to 6 cp + 2 sym samples it is the array the receiver
    refined in before its kernel."""
    out = np.zeros(max(len(x), n_valid), np.float32)
    out[:n_valid] = x[:n_valid]
    return torch.from_numpy(out)


def plain_refine(x: torch.Tensor, coarse_rel: int, n_valid: int, profile) -> tuple[torch.Tensor, torch.Tensor]:
    """``sync.refine_xcorr`` of one row as the receiver called it before its
    refine kernel: int32 index and length tensors."""
    return sync.refine_xcorr(x[None], torch.tensor([coarse_rel], dtype=torch.int32, device=x.device), profile,
                             torch.tensor([n_valid], dtype=torch.int32, device=x.device))


@pytest.mark.parametrize("case", REFINE_CASES)
@pytest.mark.parametrize("name", PROFILE_MODES)
def test_stream_refine_on_cpu_is_the_plain_refine(name, case):
    p = MODES[name].profile
    radius = 3 * p.cp_len
    x, c, nv = refine_case(MODES[name], case)
    reset_launch_counts()
    row = receive.stream_refine(torch.from_numpy(x), c, nv, p)
    assert launch_counts()["stream_refine"] == 0
    start, best = plain_refine(zero_padded(x, nv)[: 2 * radius + 2 * p.symbol_len], c, nv, p)
    assert row.dtype == torch.int32 and row.shape == (2,)
    assert row[0].item() == start.item() and row[1].item() == best.view(torch.int32).item()

    # the window is the case it is named for
    s, m = row[0].item(), row[1:].view(torch.float32).item()
    if case in ("early_edge", "on_coarse", "late_edge"):
        k = {"early_edge": -radius, "on_coarse": 0, "late_edge": radius}[case]
        assert s == c + k and m > 0.9
    elif case == "lo_clamps":
        assert c - radius < 0 and s == 5 and m > 0.9
    elif case == "cut_short":
        assert nv - p.symbol_len < c + radius and s == c and m > 0.9
    elif case == "junk_past_n_valid":
        assert s == c + 7 and m > 0.9
        assert torch.equal(receive.stream_refine(zero_padded(x, nv), c, nv, p), row)
    elif case == "silence":
        assert s == c and m == float("-inf")


@pytest.mark.parametrize("name", PROFILE_MODES)
def test_stream_refine_ignores_what_lies_past_n_valid_on_cpu(name):
    """Loud noise, a copy of the preamble or zeros past n_valid: one result,
    on the preamble at every 17th offset of the +-3 cp reach and both edges."""
    mode = MODES[name]
    p = mode.profile
    radius = 3 * p.cp_len
    rng = np.random.default_rng(11)
    for k in sorted({*range(-radius, radius + 1, 17), radius}):
        x, c, nv = offset_window(mode, k)
        row = receive.stream_refine(torch.from_numpy(x), c, nv, p)
        assert row[0].item() == c + k
        for tail in (10 * rng.standard_normal(len(x) - nv), np.resize(x[c - k :], len(x) - nv), 0.0):
            y = x.copy()
            y[nv:] = tail
            assert torch.equal(receive.stream_refine(torch.from_numpy(y), c, nv, p), row), k


def _transfer(mode, n_chunks: int = 3, seed: int = 7) -> tuple[np.ndarray, bytes]:
    """A chunked transfer of ``n_chunks`` chunks at 30 dB behind a lead-in of
    noise, as host float32 audio, and its file."""
    rng = np.random.default_rng(seed)
    data = rng.bytes(n_chunks * mode.chunk_size - 100)
    sig = torch.cat(list(api.encode_chunked(data, mode, "refine.bin", device="cpu"))).numpy().astype(np.float64)
    sig = np.concatenate([np.zeros(3001), sig, np.zeros(4096)])
    power = np.mean(sig**2)
    sig += rng.standard_normal(len(sig)) * np.sqrt(power / 1e3)
    return sig.astype(np.float32), data


@pytest.mark.parametrize("name", ["QPSK", "BPSK-NARROW"])
def test_cpu_chunked_decode_refines_as_before(name, monkeypatch):
    """A CPU ``api.decode_chunked`` with ``_refine_window`` tapped as
    tests/test_torch_streaming.py taps it: every refine's start and metric
    equal, bit for bit, ``sync.refine_xcorr`` of the region cut into a
    zero-padded array of 6 cp + 2 sym samples with int32 index and length
    tensors, as the receiver refined before its kernel; and the file comes
    back whole."""
    mode = MODES[name]
    p = mode.profile
    inner = receiver._refine_window
    seen = []

    def refine(window, coarse_rel, n_valid, profile):
        region = zero_padded(window.numpy(), n_valid)[: 6 * p.cp_len + 2 * p.symbol_len]
        want = plain_refine(region, coarse_rel, n_valid, profile)
        start, metric = inner(window, coarse_rel, n_valid, profile)
        seen.append(((int(start), float(metric)), (int(want[0][0]), float(want[1][0]))))
        return start, metric

    monkeypatch.setattr(receiver, "_refine_window", refine)
    sig, data = _transfer(mode)
    result = api.decode_chunked(sig, mode, device="cpu")
    assert result.complete and result.data == data
    assert len(seen) >= 4 and all(got == want for got, want in seen), seen
    assert all(metric >= sync.XCORR_THRESHOLD for (_, metric), _ in seen)


def test_a_kept_metric_survives_the_next_refine():
    """Each refine's start and metric are views of a fresh row: a metric kept
    from one call keeps its value after a second call on the same window, and
    ``kernels.read_pair`` reads the pair in one copy of that row."""
    from audio_modem_tpu_torch.kernels import read_pair

    p = MODES["QPSK"].profile
    x, c, nv = refine_case(MODES["QPSK"], "junk_past_n_valid")
    win = torch.from_numpy(x.copy())
    start, metric = receiver._refine_window(win, c, nv, p)
    kept = metric.item()
    win.zero_()
    start2, metric2 = receiver._refine_window(win, c, nv, p)
    assert metric.item() == kept > 0.9 and metric2.item() == float("-inf") and start2.item() == c
    assert start.dtype == torch.int32 and metric.dtype == torch.float32 and metric.dim() == 0
    assert read_pair("refine", start, metric) == (c + 7, kept)
    assert read_pair("refine", start + 1, metric) == (c + 8, kept)  # a pair of two tensors: the float64 copy


def test_roofline_of_the_stream_refine_at_a_region():
    """One QPSK region (385 offsets of 576 taps) is bound by its operations:
    4 x 385 x 576 flops, ~13 ns at the H100's 67 TFLOP/s, against 6,152 bytes."""
    from audio_modem_tpu_torch import roofline

    n_bytes, n_flops = roofline.work_stream_refine(MODES["QPSK"].profile)
    assert n_bytes == 4 * (385 + 576 - 1) + 4 * 576 + 8 == 6152 and n_flops == 4 * 385 * 576
    ms, by = roofline.bound_ms(n_bytes, n_flops, roofline.card_peaks("NVIDIA H100 80GB HBM3"))
    assert by == "operations" and ms == pytest.approx(4 * 385 * 576 / 67e12 * 1e3)
    wide = roofline.work_stream_refine(MODES["BPSK-NARROW"].profile)
    assert wide == (4 * (1537 + 768 - 1) + 4 * 768 + 8, 4 * 1537 * 768)
