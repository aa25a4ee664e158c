"""The one-shot decoder's tail (``kernels.receive.decode_tail``) on the CPU,
through its plain version: a row holds kernel A's head, |H| as
``phy.channel_magnitude`` gives it and the voted, packed bytes of the whole
bits row, whose prefix is ``majority_vote`` and ``bits_to_bytes`` of a
frame's truncated bits; and ``decoder.decode_raw``, which reads each try
through that row, gives the bytes, ``DecodeInfo`` and error strings of the
formulation it replaced (the head, |H| and bits read one by one, then the
vote and pack of the truncated bits), on clean frames, the decoy, the rungs'
inputs and the failing cases."""

import dataclasses

import numpy as np
import pytest
import torch

from audio_modem_tpu_torch import api, decoder, framing, phy, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.framing import FrameError
from audio_modem_tpu_torch.kernels import launch_counts, receive, reset_launch_counts, upload
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol

torch.set_num_threads(2)


def _kernel_a_outputs(name: str, b: int, max_syms: int, seed: int) -> dict:
    """Random tensors of kernel A's output shapes for B rows of ``name``."""
    mode = MODES[name]
    g = torch.Generator().manual_seed(seed)
    n_active = mode.profile.num_active_subs
    return {
        "coarse": torch.randint(-1, 1 << 20, (b,), generator=g, dtype=torch.int32),
        "start": torch.randint(0, 1 << 20, (b,), generator=g, dtype=torch.int32),
        "fine_metric": torch.rand(b, generator=g),
        "bits": torch.randint(0, 2, (b, max_syms * bits_per_symbol(mode)), generator=g, dtype=torch.int8),
        "ch_re": torch.randn(b, n_active, generator=g),
        "ch_im": torch.randn(b, n_active, generator=g),
    }


# (mode, max_syms, n_sym): repetition 1 and 3, BPSK and QPSK; n_sym equal
# to max_syms and shorter; bit counts that are not whole bytes (BPSK-REPEAT
# has 64 bits a symbol, 21 1/3 votes; BPSK-NARROW 21 bits, 7 votes)
TAIL_CASES = [
    ("QPSK", 12, 12),
    ("QPSK", 12, 5),
    ("BPSK-ACOUSTIC", 9, 9),
    ("BPSK-ACOUSTIC", 9, 1),
    ("BPSK-REPEAT", 13, 13),
    ("BPSK-REPEAT", 13, 4),
    ("BPSK-NARROW", 11, 11),
    ("BPSK-NARROW", 11, 3),
    ("BPSK-NARROW", 11, 0),
    ("64-QAM", 3, 2),
]


@pytest.mark.parametrize("name, max_syms, n_sym", TAIL_CASES)
def test_tail_row_is_magnitude_vote_and_pack(name, max_syms, n_sym):
    mode = MODES[name]
    out = _kernel_a_outputs(name, 3, max_syms, seed=max_syms * 100 + n_sym)
    rows = receive.decode_tail_reference(*out.values(), mode.repetition)
    n_active, n_bits = out["ch_re"].shape[1], out["bits"].shape[1]
    assert rows.dtype == torch.uint8 and rows.shape == (3, receive.tail_row_bytes(n_bits, n_active, mode.repetition))
    assert rows.shape[1] % 4 == 0
    bps = bits_per_symbol(mode)
    n_bytes = n_sym * bps // mode.repetition // 8
    for i, row in enumerate(rows.numpy()):
        coarse, start, fine, mag, packed = receive.split_tail_row(row, n_active)
        assert (coarse, start) == (int(out["coarse"][i]), int(out["start"][i]))
        assert fine == float(out["fine_metric"][i])
        want_mag = phy.channel_magnitude(out["ch_re"][i], out["ch_im"][i]).numpy()
        assert mag.dtype == np.float32 and np.array_equal(mag.view(np.uint32), want_mag.view(np.uint32))
        b = out["bits"][i, : n_sym * bps]
        if mode.repetition > 1:
            b = majority_vote(b, mode.repetition)
        assert packed[:n_bytes].tobytes() == bits_to_bytes(b).numpy().tobytes()
        whole = n_bits // mode.repetition // 8
        assert not packed[whole:].any()  # the padding to a multiple of 4


def test_tail_on_cpu_tensors_runs_the_plain_version():
    mode = MODES["BPSK-REPEAT"]
    out = _kernel_a_outputs("BPSK-REPEAT", 2, 7, seed=1)
    reset_launch_counts()
    rows = receive.decode_tail(*out.values(), mode.repetition)
    assert launch_counts()["decode_tail"] == 0
    assert torch.equal(rows, receive.decode_tail_reference(*out.values(), mode.repetition))


def _parent_decode_raw(signal, mode, track_timing=False, device="cpu"):
    """``decoder.decode_raw`` as it read kernel A's outputs before the tail:
    coarse, start and the fine metric one by one, then |H|, then the vote and
    pack of the frame's truncated bits."""
    p = mode.profile
    sym = p.symbol_len
    sig = upload(signal, device)
    n_valid = sig.shape[0]
    sig_dev = decoder.pad_to_bucket(sig)
    max_syms = decoder._max_symbols(sig_dev.shape[0], mode)
    min_pos, coarse, start, fine_metric = 0, -1, -1, -np.inf
    out = None
    for _ in range(4):
        out = decoder._core_dispatch(sig_dev, n_valid, min_pos, mode, max_syms)
        coarse = int(out["coarse"][0])
        if coarse < 0:
            if fine_metric == -np.inf:
                return FrameError("Preamble not detected"), None
            break
        start, fine_metric = int(out["start"][0]), float(out["fine_metric"][0])
        if fine_metric >= sync.XCORR_THRESHOLD:
            break
        min_pos = coarse + p.fft_size
    if coarse < 0 or fine_metric < sync.XCORR_THRESHOLD:
        return FrameError("Preamble not detected (low correlation)"), None
    info = decoder.DecodeInfo(start, coarse, fine_metric, phy.channel_magnitude(out["ch_re"][0], out["ch_im"][0]).numpy())
    ce_start = start + 2 * sym
    if ce_start + sym > n_valid:
        return FrameError("Signal too short for CE"), info
    data_start = ce_start + sym
    if data_start >= n_valid:
        return FrameError("No data after CE"), info
    n_sym = (n_valid - data_start) // sym
    b = out["bits"][0, : n_sym * bits_per_symbol(mode)]
    if mode.repetition > 1:
        b = majority_vote(b, mode.repetition)
    raw = bits_to_bytes(b).numpy().tobytes()
    if track_timing and n_sym > 0:  # the loop measures the symbols the untracked header counts
        b, _ = decoder._tracked_core(sig_dev, n_valid, start, mode, n_sym, decoder._header_symbols(raw, mode, n_sym, n_sym))
        if mode.repetition > 1:
            b = majority_vote(b, mode.repetition)
        raw = bits_to_bytes(b).numpy().tobytes()
    return raw, info


def _awgn(x: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    power = float(np.mean(x.astype(np.float64) ** 2))
    return (x + rng.standard_normal(x.shape) * np.sqrt(power / 10 ** (snr_db / 10))).astype(np.float32)


def _signal(case: str) -> tuple[np.ndarray, str]:
    """A recording and its mode: clean frames in four modes; the decoy (a tone
    the scan commits in and the refine rejects, twice); a BPSK-REPEAT frame
    whose data is at -2 dB (the soft rung), the same at 3 dB (the xcorr rung),
    an FEC frame with three symbols dropped (the erasure rung); silence and
    noise; a frame cut inside its CE symbol, one cut at its first data
    symbol and one cut inside it (no whole data symbol)."""
    def tx(name, size, seed, **kw):
        payload = np.random.default_rng(seed).bytes(size)
        return framing.build_transmit_signal(payload, MODES[name], "t.bin", device="cpu", **kw).numpy()

    if case in ("QPSK", "16-QAM", "BPSK-NARROW", "BPSK-REPEAT"):
        return _awgn(tx(case, 300, 3), 25.0, 1), case
    if case == "decoy":
        p = MODES["QPSK"].profile
        t = np.arange(2 * p.fft_size)
        decoy = (0.4 * np.sin(2 * np.pi * 4 * t / p.fft_size)).astype(np.float32)
        return np.concatenate([decoy, np.zeros(2 * p.fft_size, np.float32), tx("QPSK", 400, 11)]), "QPSK"
    if case == "fec":
        mode = MODES["BPSK-ACOUSTIC"]
        sig = _awgn(tx("BPSK-ACOUSTIC", 150, 41, fec=True), 30.0, 4)
        s0 = mode.profile.silence_pre_legacy() + 8 * mode.profile.symbol_len
        sig[s0 : s0 + 3 * mode.profile.symbol_len] = 0.0
        return sig, "BPSK-ACOUSTIC"
    if case in ("soft", "xcorr"):
        p = MODES["BPSK-REPEAT"].profile
        sig = tx("BPSK-REPEAT", 96, 42)
        if case == "xcorr":
            return _awgn(sig, 3.0, 2), "BPSK-REPEAT"
        d0 = p.silence_pre_legacy() + 3 * p.symbol_len
        sig[d0:] = _awgn(sig[d0:], -2.0, 4)
        return sig, "BPSK-REPEAT"
    if case == "silence":
        return np.zeros(40000, np.float32), "QPSK"
    if case == "noise":
        return np.random.default_rng(9).standard_normal(60000).astype(np.float32) * 0.1, "QPSK"
    p = MODES["QPSK"].profile
    sig = tx("QPSK", 300, 5)
    s0 = p.silence_pre_legacy() + 2 * p.symbol_len  # the CE symbol's first sample
    return sig[: s0 + {"cut_in_ce": p.symbol_len // 2, "cut_at_data": p.symbol_len}.get(case, p.symbol_len + 10)], "QPSK"


RAW_CASES = ["QPSK", "16-QAM", "BPSK-NARROW", "BPSK-REPEAT", "decoy", "soft", "xcorr", "fec", "silence", "noise",
             "cut_in_ce", "cut_at_data", "cut_after_ce"]


def _same(got, want) -> None:
    (raw, info), (wraw, winfo) = got, want
    assert type(raw) is type(wraw) and (raw == wraw if isinstance(raw, bytes) else raw.error == wraw.error)
    assert (info is None) == (winfo is None)
    if info is not None:
        assert (info.preamble_idx, info.coarse_idx, info.fine_metric) == (
            winfo.preamble_idx, winfo.coarse_idx, winfo.fine_metric)
        assert type(info.fine_metric) is float
        assert info.channel_mag.dtype == winfo.channel_mag.dtype and info.channel_mag.flags.writeable
        assert np.array_equal(info.channel_mag, winfo.channel_mag)


@pytest.mark.parametrize("track_timing", [False, True], ids=["hard", "tracked"])
@pytest.mark.parametrize("case", RAW_CASES)
def test_decode_raw_matches_the_formulation_before_the_tail(case, track_timing):
    sig, name = _signal(case)
    mode = MODES[name]
    _same(decoder.decode_raw(sig, mode, track_timing=track_timing, device="cpu"),
          _parent_decode_raw(sig, mode, track_timing=track_timing))


@pytest.mark.parametrize("case", ["QPSK", "decoy", "soft", "xcorr", "fec", "silence", "cut_in_ce"])
def test_api_decode_matches_the_formulation_before_the_tail(monkeypatch, case):
    """The whole decode, rungs included, gives the same result and info with
    ``decode_raw`` in either formulation."""
    sig, name = _signal(case)
    got_result, got_info = api.decode(sig, name, device="cpu")
    monkeypatch.setattr(decoder, "decode_raw", _parent_decode_raw)
    want_result, want_info = api.decode(sig, name, device="cpu")
    assert type(got_result) is type(want_result)
    assert dataclasses.asdict(got_result) == dataclasses.asdict(want_result)
    if isinstance(got_info, decoder.DecodeInfo) and got_info.channel_mag is not None:
        _same((b"", got_info), (b"", want_info))
    else:
        assert got_info == want_info


@pytest.mark.parametrize("case", ["BPSK-REPEAT", "decoy"])
def test_chip_smoke_keeps_and_checks_the_tail_of_every_try(case):
    """``chip_smoke.path_inputs`` keeps the decoder's tail inputs under the
    tag of the kernel A try they follow ("resume" for a try past a rejected
    peak), and ``check_path_inputs`` holds each to its plain version."""
    import chip_smoke

    sig, name = _signal(case)
    mode = MODES[name]
    store: dict = {}
    with chip_smoke.path_inputs(store, "cpu"):
        decoder.decode_raw(sig, mode, device="cpu")
    assert decoder.decode_tail is receive.decode_tail
    tries = sorted(k[1] for k in store if k[0] == "decode_fused")
    tails = sorted(k[1] for k in store if k[0] == "decode_tail")
    assert tails == tries == (["cpu decoder", "cpu decoder resume"] if case == "decoy" else ["cpu decoder"])
    assert {k[3] for k in store if k[0] == "decode_tail"} == {mode.repetition}
    _, report = chip_smoke.check_path_inputs("cpu", store)
    assert report.count("bytes equal bit for bit") == len(tails)
