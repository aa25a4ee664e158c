"""The chunked receiver's scan wrapper (``kernels/receive.py::stream_scan``)
on the CPU: given CPU tensors it returns the plain scan,
``sync.detect_preamble`` at ``COARSE_STRIDE`` with the receiver's energy
gate, and launches nothing. The windows of ``SCAN_CASES`` are the ones the
card test (``tests/test_torch_cuda.py::test_stream_scan_matches_plain``)
holds the kernel to; here each is also checked to be the case it is named
for. And samples past a window's valid length change no result, which is
what lets the receiver reuse its staging block without zeroing it."""

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import framing, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.runtime.receiver import SCAN_BUCKET, STREAM_MIN_ENERGY

torch.set_num_threads(2)

PROFILE_MODES = ["QPSK", "BPSK-ACOUSTIC", "BPSK-NARROW"]  # the standard, acoustic and narrowband profiles
SCAN_CASES = ["silence", "noise_gate", "at_zero", "mid", "last_valid", "rising_end", "two_preambles",
              "one_valid_position", "junk_past_n_valid"]


def scan_case(mode, case: str, seed: int = 3) -> tuple[np.ndarray, int]:
    """One scan window of ``SCAN_BUCKET`` samples for ``case``: (window
    float32, n_valid). Frames sit behind ~46 dB of noise unless the
    case says otherwise:

    - silence: all zeros;
    - noise_gate: noise alone whose half-window energy crosses 0.001;
    - at_zero: a preamble at sample 0;
    - mid: a clean preamble at 3,000 (a plateau of equal metrics);
    - last_valid: a preamble at 5,000, n_valid ending two positions past it;
    - rising_end: a preamble at the last position, the metric still rising;
    - two_preambles: a noisier preamble at 1,000 before a cleaner one at 5,000;
    - one_valid_position: a preamble at sample 0, n_valid one fft long;
    - junk_past_n_valid: a preamble at 2,000, n_valid 5,000, loud noise past it.
    """
    p = mode.profile
    rng = np.random.default_rng(seed)
    frame = framing.build_data_chunk_frames([rng.bytes(48)], 0, mode, device="cpu").numpy()[0]
    body = frame[p.silence_pre_chunk(False) :]
    w = SCAN_BUCKET
    x = (0.005 * rng.standard_normal(w)).astype(np.float32)
    n_valid = w

    def put(off: int, n: int = w) -> None:
        seg = body[: min(w - off, n)]
        x[off : off + len(seg)] += seg

    if case == "silence":
        x[:] = 0
    elif case == "noise_gate":
        x = (0.002 * np.linspace(0.5, 1.7, w) * rng.standard_normal(w)).astype(np.float32)
    elif case == "at_zero":
        put(0)
    elif case == "mid":
        x[:] = 0
        put(3000)
    elif case == "last_valid":
        put(5000)
        n_valid = 5000 + p.fft_size + 2 * sync.COARSE_STRIDE
    elif case == "rising_end":
        put(w - p.fft_size)
    elif case == "two_preambles":
        put(1000, 2 * p.symbol_len)
        x[800:3000] += (0.02 * rng.standard_normal(2200)).astype(np.float32)
        put(5000)
    elif case == "one_valid_position":
        put(0)
        n_valid = p.fft_size
    elif case == "junk_past_n_valid":
        put(2000)
        n_valid = 5000
        x[n_valid:] = 10 * rng.standard_normal(w - n_valid)
    else:
        raise ValueError(case)
    return x.astype(np.float32), n_valid


def _plain(x: torch.Tensor, n_valid: int, profile):
    return sync.detect_preamble(x, profile, n_valid, min_energy=STREAM_MIN_ENERGY, stride=sync.COARSE_STRIDE)


def _scan(x: torch.Tensor, n_valid: int, profile) -> torch.Tensor:
    return receive.stream_scan(x, n_valid, profile, STREAM_MIN_ENERGY, torch.empty((x.shape[0], 2), dtype=torch.int32))


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("name", PROFILE_MODES)
def test_stream_scan_on_cpu_is_the_plain_scan(name, case):
    p = MODES[name].profile
    x, nv = scan_case(MODES[name], case)
    win = torch.from_numpy(x)[None]
    reset_launch_counts()
    out = torch.full((1, 2), 7, dtype=torch.int32)
    rows = receive.stream_scan(win, nv, p, STREAM_MIN_ENERGY, out)
    assert launch_counts()["stream_scan"] == 0
    coarse, best = _plain(win, nv, p)
    assert rows is out and rows.dtype == torch.int32 and rows.shape == (1, 2)
    assert rows[0, 0].item() == coarse.item() and rows[0, 1].item() == best.view(torch.int32).item()

    # the window is the case it is named for
    c = coarse.item()
    metric = sync.scan_metric(win, p, nv, min_energy=STREAM_MIN_ENERGY, stride=sync.COARSE_STRIDE)[0]
    n_pos, stride = metric.shape[0], sync.COARSE_STRIDE
    run = torch.cummax(metric, dim=0).values
    drops = ((run > sync.AUTOCORR_THRESHOLD) & (metric < 0.7 * run)).nonzero().flatten().tolist()
    if case == "silence":
        assert c == -1 and best.item() == 0.0
    elif case == "noise_gate":
        assert c == -1 and 0 < int((metric > 0).sum()) < n_pos
    elif case == "at_zero":
        assert 0 <= c < p.fft_size
    elif case == "mid":
        plateau = (metric == 1.0).nonzero().flatten().tolist()
        assert best.item() == 1.0 and len(plateau) > 1 and c == plateau[0] * stride
    elif case == "last_valid":
        last = (nv - p.fft_size) // stride
        assert drops[0] == last + 1 and 5000 <= c <= last * stride
    elif case == "rising_end":
        assert not drops and c == (n_pos - 1) * stride
    elif case == "two_preambles":
        assert 0 <= c < 3000 and int(metric.argmax()) * stride >= 5000
    elif case == "one_valid_position":
        assert c in (-1, 0) and int((metric > 0).sum()) <= 1 and metric[0] > 0
    elif case == "junk_past_n_valid":
        zeroed = torch.from_numpy(np.where(np.arange(len(x)) < nv, x, 0).astype(np.float32))[None]
        assert 2000 <= c < 2000 + p.fft_size
        assert torch.equal(_scan(zeroed, nv, p), rows)


@pytest.mark.parametrize("name", PROFILE_MODES)
def test_stream_scan_rows_of_one_n_valid_on_cpu(name):
    """B = 3 rows valid up to one n_valid equal the rows scanned one by one;
    an n_valid cut short equals the same window zero-padded past it."""
    mode = MODES[name]
    p = mode.profile
    made = [scan_case(mode, c)[0] for c in ("junk_past_n_valid", "last_valid", "two_preambles")]
    nv = 5000
    rows = _scan(torch.from_numpy(np.stack(made)), nv, p)
    for i, x in enumerate(made):
        one = _scan(torch.from_numpy(x)[None], nv, p)
        assert torch.equal(rows[i], one[0])
        padded = np.zeros_like(x)
        padded[:nv] = x[:nv]
        assert torch.equal(_scan(torch.from_numpy(padded)[None], nv, p), one)
    assert rows[0, 0] >= 0 and rows[2, 0] >= 0


def test_roofline_of_the_stream_scan_at_a_window():
    """One full window is bound by its bytes: 32 KB in and an 8-byte row out,
    ~9.8 ns at the H100's 3.35 TB/s."""
    from audio_modem_tpu_torch import roofline

    n_pos = receive._scan_positions(SCAN_BUCKET, MODES["QPSK"].profile)
    n_bytes, n_flops = roofline.work_stream_scan(1, SCAN_BUCKET, n_pos)
    assert n_pos == 481 and n_bytes == 4 * SCAN_BUCKET + 8
    ms, by = roofline.bound_ms(n_bytes, n_flops, roofline.card_peaks("NVIDIA H100 80GB HBM3"))
    assert by == "bytes" and ms == pytest.approx(32_776 / 3.35e12 * 1e3)
