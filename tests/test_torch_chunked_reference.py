"""The port's ``api.decode_chunked`` against the benchmark's plain reference
of the chunked receiver (``benchmark/reference/chunked.py``, float64) on the
CPU: small chunked QPSK transfers at 30 dB behind a seeded lead-in of noise.

Equal: every frame's refined start, the file's bytes, name and chunk count,
the scan windows and the false peaks.
The refine metric agrees within 1e-5 and the channel's |H| that the frame
decode hands the streaming demod within 1e-4 of the largest reference bin.
A start planted one sample late shows as a gap of one sample."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audio_modem_tpu_torch import api, decoder  # noqa: E402
from audio_modem_tpu_torch.runtime import receiver  # noqa: E402
from audio_modem_tpu_torch.utils import trace  # noqa: E402
from benchmark.reference import chunked  # noqa: E402

torch.set_num_threads(2)

METRIC_TOL = 1e-5
MAG_TOL = 1e-4
CHUNKS = 8


def _transfer(seed: int) -> tuple[np.ndarray, bytes]:
    """A seeded file of CHUNKS QPSK chunks as the port's transmitter sends it,
    behind 0-20,000 samples of lead-in, under 30 dB AWGN."""
    rng = np.random.default_rng(seed)
    data = rng.bytes(CHUNKS * 2048)
    frames = [f.numpy() for f in api.encode_chunked(data, "QPSK", "t.bin", device="cpu")]
    sig = np.concatenate([np.zeros(int(rng.integers(0, 20_001)), np.float32), *frames,
                          np.zeros(4096, np.float32)])
    power = float(np.mean(sig.astype(np.float64) ** 2))
    noise = rng.standard_normal(sig.shape[0]) * np.sqrt(power / 10 ** 3.0)
    return (sig + noise).astype(np.float32), data


def _decode(sig: np.ndarray, monkeypatch, late: int = -1):
    """``api.decode_chunked`` of ``sig`` with the span recorder on: the
    result, the counters, and each frame's start, refine metric and |H|;
    ``late`` >= 0 plants that refine's start one sample late."""
    refines, channels, frames = [], [], []
    refine_window, stream_demod = receiver._refine_window, decoder.stream_demod
    demodulate_frame = receiver.StreamingReceiver._demodulate_frame

    def refine(*args):
        start, metric = refine_window(*args)
        if len(refines) == late:
            start = start + 1
        refines.append(float(metric))
        return start, metric

    def demod(data, ch_re, ch_im, scale, mode, n_sym):
        channels.append(torch.sqrt(ch_re[0].double() ** 2 + ch_im[0].double() ** 2).numpy())
        return stream_demod(data, ch_re, ch_im, scale, mode, n_sym)

    def frame(rx, *args, **kwargs):
        frames.append((rx.preamble_pos, refines[-1], len(channels)))
        return demodulate_frame(rx, *args, **kwargs)

    monkeypatch.setattr(receiver, "_refine_window", refine)
    monkeypatch.setattr(decoder, "stream_demod", demod)
    monkeypatch.setattr(receiver.StreamingReceiver, "_demodulate_frame", frame)
    trace.enable()
    try:
        result = api.decode_chunked(sig, "QPSK", device="cpu")
    finally:
        trace.disable()
        counters = trace.drain()[1]
    return result, counters, [s for s, _, _ in frames], [m for _, m, _ in frames], [channels[i] for _, _, i in frames]


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 17])
def test_decode_chunked_matches_the_reference(seed, monkeypatch):
    sig, data = _transfer(seed)
    result, counters, starts, fines, mags = _decode(sig, monkeypatch)
    ref = chunked.receive(torch.from_numpy(sig), "QPSK")
    assert counters["scan_windows"] == ref.scan_windows  # the same windows, cut where the blocks end
    assert counters.get("false_peaks", 0) == ref.false_peaks
    assert result.data == data == ref.file()
    assert (result.file_name, result.total_chunks, result.missing_chunks, result.crc_errors) == ("t.bin", CHUNKS, [], 0)
    assert (ref.file_name, ref.total_chunks, ref.missing, ref.crc_errors) == ("t.bin", CHUNKS, [], 0)
    assert [f.kind for f in ref.frames] == ["meta"] + ["data"] * CHUNKS
    assert starts == [f.start for f in ref.frames]
    for f, r in zip(fines, ref.frames):
        assert abs(f - r.fine) < METRIC_TOL, (f, r.fine)
    for m, r in zip(mags, ref.frames):
        assert np.abs(m - r.mag).max() / r.mag.max() < MAG_TOL
    gaps = chunked.frame_gaps(starts, fines, mags, ref.frames)
    assert gaps["start_gap"] == 0 and gaps["fine_gap"] < METRIC_TOL and gaps["ce_gap"] < MAG_TOL


def test_a_start_one_sample_late_fails_the_comparison(monkeypatch):
    sig, data = _transfer(4)
    result, _, starts, fines, mags = _decode(sig, monkeypatch, late=3)
    assert result.data == data  # one sample into the CP still decodes
    ref = chunked.receive(torch.from_numpy(sig), "QPSK")
    assert [s - f.start for s, f in zip(starts, ref.frames)] == [0, 0, 0, 1] + [0] * (CHUNKS - 3)
    assert chunked.frame_gaps(starts, fines, mags, ref.frames)["start_gap"] == 1


def test_the_reference_dc_removal_is_the_sequential_ema():
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(10_000).astype(np.float32) + 0.3)
    dc, want = 0.0, np.empty(10_000)
    for i, v in enumerate(x.double().numpy()):
        dc = chunked.DC_ALPHA * dc + (1 - chunked.DC_ALPHA) * v
        want[i] = v - dc
    assert np.abs(chunked.remove_dc(x, block=4096).numpy() - want).max() < 1e-12
