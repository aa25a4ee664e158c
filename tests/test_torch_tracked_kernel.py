"""The timing tracker's wrapper (``kernels/receive.py::demodulate_tracked``)
on the CPU: given CPU tensors it is ``phy.demodulate_tracked`` bit for bit,
spans and counters included, and launches nothing; the one-shot decoder and
the chunk path's tracked rung reach the tracker through it, at their block
sizes; and its argument checks (``_check_tracked``), which guard the kernel
on the card, refuse what the kernel does not take. The kernel itself
(``csrc/receive.cu::track_kernel``) runs only on the card
(``tests/test_torch_cuda.py``)."""

import re

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import api, channel, decoder, framing, phy
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.kernels import _build, launch_counts, receive, reset_launch_counts
from audio_modem_tpu_torch.utils import trace
from test_torch_tracked_reference import _recording

torch.set_num_threads(2)


def chunk_case(mode_name: str = "QPSK", ppm: float = 300.0, seed: int = 21) -> tuple:
    """The chunk path's tracked rung's call on a drifted data chunk frame,
    as ``decoder._chunk_tracked_core`` makes it: (sig_ext, data_start,
    n_sym, ch_re, ch_im, mode, block_syms, n_valid_sym), the symbols past the
    chunk's payload (the bucket's tail) out of the measurement."""
    mode = MODES[mode_name]
    sym = mode.profile.symbol_len
    rng = np.random.default_rng(seed)
    tx = framing.build_data_chunk_frames([rng.bytes(mode.chunk_size)], 0, mode, device="cpu").numpy()[0]
    rx = channel.apply_channel_np(tx, channel.ChannelSpec(clock_ppm=ppm, snr_db=25.0), seed=seed, device="cpu")
    frame, _, n_bucket = decoder.pad_aligned_frame(rx[mode.profile.silence_pre_chunk(False) :], mode, device="cpu")
    eb = decoder.TRACK_EARLY_BIAS
    ch_re, ch_im = decoder._frame_channel(frame, mode, eb)
    ext = torch.nn.functional.pad(frame, (0, decoder.TRACK_BLOCK_SYMS * sym + 8192))
    n_valid = framing.num_symbols_for_payload(11 + mode.chunk_size, mode)
    assert n_valid < n_bucket
    return ext, 3 * sym - eb, n_bucket, ch_re, ch_im, mode, decoder.TRACK_BLOCK_SYMS, n_valid


def one_shot_case(monkeypatch) -> tuple:
    """The one-shot decoder's tracker call on a ~2 KB BPSK-REPEAT frame at
    +100 ppm and 18 dB, taken from ``api.decode(track_timing=True)``: its
    arguments as ``demodulate_tracked`` gets them, the block size the
    default (``phy.TRACK_BLOCK``)."""
    sig, data = _recording(7, 100.0)
    calls = []
    real = decoder.demodulate_tracked

    def tap(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(decoder, "demodulate_tracked", tap)
    result, _ = api.decode(sig, "BPSK-REPEAT", track_timing=True, device="cpu")
    assert result.crc_valid and result.data == data
    [(args, kwargs)] = calls
    assert set(kwargs) == {"n_valid_sym"}
    return (*args, phy.TRACK_BLOCK, kwargs["n_valid_sym"])


def _traced(fn, args) -> tuple:
    """``fn(*args)`` with the span recorder on: (bits, tau, the pass spans'
    indices, the counters)."""
    trace.drain()
    trace.enable()
    try:
        bits, tau = fn(*args)
    finally:
        trace.disable()
    spans, counters = trace.drain()
    return bits, tau, [s.attrs["index"] for s in spans if s.name == "decode.track.pass"], counters


@pytest.mark.parametrize("case", ["one_shot", "chunk"])
def test_cpu_tensors_take_the_plain_tracker(case, monkeypatch):
    """On CPU tensors the wrapper gives the plain loop's bits and tau bit for
    bit, records the same three pass spans and ``track_blocks``, and
    launches nothing."""
    args = one_shot_case(monkeypatch) if case == "one_shot" else chunk_case()
    reset_launch_counts()
    bits, tau, passes, counters = _traced(receive.demodulate_tracked, args)
    assert not any(launch_counts().values())
    pbits, ptau, ppasses, pcounters = _traced(phy.demodulate_tracked, args)
    assert bits.dtype == torch.int8 and tau.dtype == torch.float32 and tau.dim() == 0
    assert torch.equal(bits, pbits) and torch.equal(tau, ptau)
    n_blocks = -(-args[2] // args[6])
    assert passes == ppasses == [0, 1, 2] and counters == pcounters == {"track_blocks": 3 * n_blocks}


def test_the_chunk_rung_tracks_through_the_wrapper(monkeypatch):
    """``decoder._chunk_tracked_core`` (the chunk path's tracked rung and
    ``BatchReceiver``'s) hands the wrapper ``TRACK_BLOCK_SYMS``-symbol blocks
    and its bound, and returns its bits."""
    ext, _, n_bucket, _, _, mode, block, n_valid = chunk_case()
    frame = ext[: 3 * mode.profile.symbol_len + n_bucket * mode.profile.symbol_len]
    calls = []
    real = decoder.demodulate_tracked

    def tap(*args, **kwargs):
        calls.append(kwargs)
        out = real(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(decoder, "demodulate_tracked", tap)
    bits = decoder._chunk_tracked_core(frame, mode, n_bucket, n_valid)
    kwargs, (want, _) = calls
    assert kwargs == {"block_syms": block, "n_valid_sym": n_valid}
    assert torch.equal(bits, want)


def _bad(case: str) -> tuple:
    """``_check_tracked``'s arguments with one thing the kernel does not take."""
    mode = MODES["BPSK-REPEAT"]
    p = mode.profile
    x, ch = torch.zeros(20_000), torch.ones(p.num_active_subs)
    ok = [x, 0, 16, ch, ch, p, phy.TRACK_BLOCK]
    bad = {
        "float64 signal": (0, x.double()),
        "non-contiguous signal": (0, torch.zeros(40_000)[::2]),
        "[1, n] signal": (0, x[None]),
        "signal shorter than a DFT": (0, torch.zeros(p.fft_size - 1)),
        "negative data start": (1, -1),
        "no symbol": (2, 0),
        "short channel": (3, ch[:-1]),
        "float64 channel": (4, ch.double()),
        "block of 0": (6, 0),
        "block past the kernel's rows": (6, receive.TRACK_MAX_BLOCK + 1),
    }[case]
    ok[bad[0]] = bad[1]
    return tuple(ok)


BAD_CASES = ["float64 signal", "non-contiguous signal", "[1, n] signal", "signal shorter than a DFT",
             "negative data start", "no symbol", "short channel", "float64 channel", "block of 0",
             "block past the kernel's rows"]


@pytest.mark.parametrize("case", BAD_CASES)
def test_the_tracker_checks_refuse_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        receive._check_tracked(*_bad(case))


@pytest.mark.parametrize("block", [1, decoder.TRACK_BLOCK_SYMS, phy.TRACK_BLOCK])
def test_the_tracker_checks_take_the_decoders_calls(block):
    """The checks pass the shapes both decoders hand the tracker (and a
    block of one symbol), at the edges of the kernel's rows."""
    ext, start, n_sym, ch_re, ch_im, mode, _, _ = chunk_case()
    receive._check_tracked(ext, start, n_sym, ch_re, ch_im, mode.profile, block)


def test_the_kernel_rows_match_the_wrapper_limit():
    """The wrapper's block limit is the kernel's shared rows (kTrackRows), and
    both decoders' blocks fit it; the kernel's entry is in the table."""
    source = (_build.CSRC / "receive.cu").read_text()
    assert int(re.search(r"constexpr int kTrackRows = (\d+);", source).group(1)) == receive.TRACK_MAX_BLOCK
    assert 1 <= decoder.TRACK_BLOCK_SYMS <= phy.TRACK_BLOCK <= receive.TRACK_MAX_BLOCK
    assert "demodulate_tracked" in _build._SIGNATURES
