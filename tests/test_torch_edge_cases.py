"""The edge cases of tests/test_edge_cases.py and the retry buckets of
tests/test_retry_buckets.py held on the port, on the CPU: each case is the
JAX test's own input (same seeds and sizes) run through the port with
``device="cpu"``, asserted as the JAX test asserts it, and cross-checked
against the JAX package on the same samples: equal parse results (every
dataclass field, error strings included), equal preamble_idx, fine_metric
within 1e-5, TX waveforms within 3e-5.

Of tests/test_retry_buckets.py only the behavioural cases are here. Its
count of jit executables per bucket has no PyTorch meaning: the port
compiles nothing per shape on the CPU, and its CUDA kernels take the symbol
count as an argument."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_modem_tpu import api as japi
from audio_modem_tpu import decoder as jdecoder
from audio_modem_tpu import framing as jframing
from audio_modem_tpu import sync as jsync
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu.runtime.receiver import StreamingReceiver as JStreamingReceiver
from audio_modem_tpu_torch import api, decoder, framing, sync
from audio_modem_tpu_torch.configs import MODES
from audio_modem_tpu_torch.runtime.receiver import StreamingReceiver

torch.set_num_threads(2)

CPU = "cpu"


def _same_result(ours, ref) -> None:
    assert type(ours).__name__ == type(ref).__name__, (ours, ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def _legacy(data: bytes, name: str, file_name: str) -> np.ndarray:
    """The port's legacy TX, held to the JAX package's within 3e-5."""
    sig = api.encode_legacy(data, name, file_name, device=CPU).numpy()
    ref = japi.encode_legacy(data, name, file_name)
    assert sig.shape == ref.shape and np.abs(sig - ref).max() < 3e-5
    return sig


def _decode(sig: np.ndarray, name: str):
    """api.decode in the port, held to the JAX package's."""
    ours, info = api.decode(sig, name, device=CPU)
    ref, rinfo = japi.decode(sig, name)
    _same_result(ours, ref)
    assert (info is None) == (rinfo is None)
    if info is not None:
        assert info.preamble_idx == rinfo.preamble_idx
        assert abs(info.fine_metric - rinfo.fine_metric) < 1e-5
    return ours, info


class TestPayloadEdges:
    def test_one_byte_file(self):
        result, _ = _decode(_legacy(b"\x42", "QPSK", "a"), "QPSK")
        assert isinstance(result, framing.LegacyFrame)
        assert result.crc_valid and result.data == b"\x42"

    def test_empty_file_rejected_like_reference(self):
        # the reference's legacy parser rejects dataLen <= 0 (modem.js:634)
        result, _ = _decode(_legacy(b"", "QPSK", "empty"), "QPSK")
        assert isinstance(result, framing.FrameError)
        assert "Invalid data length" in result.error

    @pytest.mark.parametrize("total", [205, 410, 1025])
    def test_symbol_exact_payload(self, total):
        """A payload whose bits fill its QPSK symbols exactly (410 bits a
        symbol): no padding."""
        overhead = 1 + 4 + 4 + 4  # nameLen + 'abcd' + dataLen + CRC
        data = b"z" * (total - overhead)
        assert len(framing.build_legacy_payload(data, "abcd")) == total
        assert framing.build_legacy_payload(data, "abcd") == jframing.build_legacy_payload(data, "abcd")
        result, _ = _decode(_legacy(data, "QPSK", "abcd"), "QPSK")
        assert isinstance(result, framing.LegacyFrame) and result.crc_valid
        assert result.data == data

    @pytest.mark.parametrize("file_name, valid", [("п" * 100, True), ("n" * 253, True), ("n" * 300, False)])
    def test_max_filename_and_unicode(self, file_name, valid):
        """200 UTF-8 bytes of name, and 253 bytes (the longest safe name),
        decode. A name truncated to 254/255 bytes makes the legacy payload's
        first byte collide with the 0xFE/0xFF frame magics, and the
        dispatch misparses it as a chunk frame (modem.js:609-621)."""
        result, _ = _decode(_legacy(b"x" * 50, "QPSK", file_name), "QPSK")
        ok = isinstance(result, framing.LegacyFrame) and result.crc_valid
        assert ok == valid
        if valid:
            assert result.file_name == file_name

    def test_chunk_threshold_routing_boundary(self):
        for size, n_frames in ((32 * 1024, 1), (32 * 1024 + 1, 18)):  # <= threshold -> legacy (app.js:131)
            ours = api.encode(b"x" * size, "QPSK", device=CPU)
            ref = japi.encode(b"x" * size, "QPSK")
            assert len(ours) == len(ref) == n_frames
            assert [f.shape[0] for f in ours] == [len(f) for f in ref]

    def test_final_chunk_single_byte(self):
        mode = MODES["QPSK"]
        data = np.random.default_rng(3).bytes(mode.chunk_size + 1)
        sig = np.concatenate([f.numpy() for f in api.encode_chunked(data, mode, "t", device=CPU)])
        res = api.decode_chunked(sig, mode, device=CPU)
        assert res.complete and res.data == data
        assert dataclasses.asdict(res) == dataclasses.asdict(japi.decode_chunked(sig, JMODES["QPSK"]))


class TestFalsePeakResume:
    def test_decoy_periodic_segment_before_frame(self):
        """A lag-periodic decoy (a pure tone at inactive bin 4) ahead of the
        frame: the coarse scan commits inside the decoy, the xcorr refine
        rejects it, and decode_raw resumes the scan past it (min_pos), in
        both packages."""
        mode = MODES["QPSK"]
        p = mode.profile
        rng = np.random.default_rng(11)
        data = rng.bytes(400)
        sig = _legacy(data, "QPSK", "d.bin")
        t = np.arange(2 * p.fft_size)
        decoy = (0.4 * np.sin(2 * np.pi * 4 * t / p.fft_size)).astype(np.float32)
        gap = np.zeros(2 * p.fft_size, np.float32)
        composite = np.concatenate([decoy, gap, sig]).astype(np.float32)
        n = len(composite)

        # the trap, in the port: the scan commits inside the decoy, the refine rejects it
        pre = sync.preprocess(torch.from_numpy(composite)[None], torch.tensor([n]))
        c_idx, c_metric = sync.detect_preamble(pre, p, torch.tensor([n]))
        assert 0 <= int(c_idx[0]) <= len(decoy) - p.fft_size, int(c_idx[0])
        assert float(c_metric[0]) > sync.AUTOCORR_THRESHOLD
        pad = torch.nn.functional.pad(pre, (0, 4 * p.symbol_len))
        _, r_metric = sync.refine_xcorr(pad, c_idx, p, torch.tensor([n]))
        assert float(r_metric[0]) < sync.XCORR_THRESHOLD, float(r_metric[0])
        # and in the JAX package
        jpre = jsync.preprocess(jnp.asarray(composite), n)
        jc, jm = jsync.detect_preamble(jpre, JMODES["QPSK"].profile, n)
        assert 0 <= int(jc) <= len(decoy) - p.fft_size and float(jm) > jsync.AUTOCORR_THRESHOLD
        assert abs(float(c_metric[0]) - float(jm)) < 1e-5
        jpad = jnp.concatenate([jpre, jnp.zeros(4 * p.symbol_len, jnp.float32)])
        _, jr = jsync.refine_xcorr(jpad, jc, JMODES["QPSK"].profile, n)
        assert float(jr) < jsync.XCORR_THRESHOLD

        # the raw decoder succeeds by the min_pos resume alone (no xcorr fallback behind it)
        raw, info = decoder.decode_raw(composite, mode, device=CPU)
        jraw, jinfo = jdecoder.decode_raw(composite, JMODES["QPSK"])
        payload = framing.build_legacy_payload(data, "d.bin")
        # the bytes past the payload are the silence after the frame: junk, ties that rounding breaks
        assert isinstance(raw, bytes) and len(raw) == len(jraw)
        assert raw[: len(payload)] == jraw[: len(payload)] == payload
        assert info.preamble_idx >= len(decoy) and info.fine_metric >= sync.XCORR_THRESHOLD
        assert info.preamble_idx == jinfo.preamble_idx and abs(info.fine_metric - jinfo.fine_metric) < 1e-5

        full, _ = _decode(composite, "QPSK")
        assert isinstance(full, framing.LegacyFrame) and full.crc_valid and full.data == data


@pytest.mark.parametrize("mode_name", ["16-QAM", "BPSK-REPEAT", "64-QAM"])
def test_small_chunked_transfer(mode_name):
    """Two chunks through the streaming receiver in 4096-sample blocks; the
    JAX package's receiver on the same blocks ends in the same state."""
    mode = MODES[mode_name]
    data = np.random.default_rng(7).bytes(mode.chunk_size + 63)
    frames = list(api.encode_chunked(data, mode, "m.bin", device=CPU))
    ref_frames = list(japi.encode_chunked(data, JMODES[mode_name], "m.bin"))
    assert all(f.shape == r.shape and np.abs(f.numpy() - r).max() < 3e-5 for f, r in zip(frames, ref_frames))
    sig = np.concatenate([f.numpy() for f in frames])
    rx, jrx = StreamingReceiver(mode, device=CPU), JStreamingReceiver(JMODES[mode_name])
    for off in range(0, len(sig), 4096):
        rx.process_audio_block(sig[off : off + 4096])
        jrx.process_audio_block(sig[off : off + 4096])
    rx.flush()
    jrx.flush()
    assert rx.assembler.is_complete, rx.assembler.missing_chunks()
    assert rx.assembler.assemble() == data == jrx.assembler.assemble()
    assert (rx.assembler.received_count, rx.assembler.crc_errors) == (
        jrx.assembler.received_count, jrx.assembler.crc_errors)


def _aligned_frame(name: str, payload: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    chunk = rng.bytes(payload)
    mode = MODES[name]
    f = framing.build_data_chunk_frame(chunk, 0, mode, device=CPU).numpy()
    ref = jframing.build_data_chunk_frame(chunk, 0, JMODES[name])
    assert np.abs(f - ref).max() < 3e-5
    return f[mode.profile.silence_pre_chunk(False) :], rng


def test_decode_chunk_frame_per_bucket():
    """10 random tail lengths: each frame decodes, and pad_aligned_frame
    gives the JAX package's padded frame, symbol count and bucket."""
    mode = MODES["QPSK"]
    sym = mode.profile.symbol_len
    f0, rng = _aligned_frame("QPSK")
    for tail in rng.integers(0, 8 * sym, 10):
        frame = np.concatenate([f0, 0.01 * rng.standard_normal(int(tail)).astype(np.float32)])
        fdev, n_sym, n_bucket = decoder.pad_aligned_frame(frame, mode, device=CPU)
        jdev, jn_sym, jn_bucket = jdecoder.pad_aligned_frame(frame, JMODES["QPSK"])
        assert (n_sym, n_bucket) == (jn_sym, jn_bucket) == ((len(frame) - 3 * sym) // sym, n_bucket)
        assert n_bucket % decoder.SYM_BUCKET == 0 and n_bucket >= n_sym
        assert np.array_equal(fdev.numpy(), np.asarray(jdev))
        result = decoder.decode_chunk_frame(frame, mode, device=CPU)
        assert isinstance(result, framing.DataFrame) and result.crc_valid
        _same_result(result, jdecoder.decode_chunk_frame(frame, JMODES["QPSK"]))


@pytest.mark.parametrize("name", ["QPSK", "BPSK-NARROW"])
def test_bucketed_demod_bits_match_exact(name):
    """Zero padding to the bucket changes no decision: the first n_sym
    symbols' bits are the same at the exact and the bucketed count, and
    the JAX package's."""
    mode = MODES[name]
    sym = mode.profile.symbol_len
    f0, rng = _aligned_frame(name, payload=64, seed=3)
    noisy = f0 + 0.01 * rng.standard_normal(len(f0)).astype(np.float32)
    n_sym = (len(noisy) - 3 * sym) // sym
    exact = decoder._chunk_core(torch.from_numpy(noisy[: (3 + n_sym) * sym].copy()), mode, n_sym).numpy()
    fdev, n_sym_b, n_bucket = decoder.pad_aligned_frame(noisy, mode, device=CPU)
    assert n_sym_b == n_sym and n_bucket >= n_sym
    bucketed = decoder._chunk_core(fdev, mode, n_bucket).numpy()
    nb = n_sym * mode.bits_per_symbol
    assert np.array_equal(exact[:nb], bucketed[:nb])
    jexact = np.asarray(jdecoder._chunk_core(jnp.asarray(noisy[: (3 + n_sym) * sym]), JMODES[name], n_sym))
    assert np.array_equal(exact[:nb], jexact[:nb])


@pytest.mark.parametrize("n_syms, extra", [(2, 0), (3, 1)])
def test_pad_aligned_frame_short_inputs(n_syms, extra):
    mode = MODES["QPSK"]
    frame = np.zeros(n_syms * mode.profile.symbol_len + extra, np.float32)
    ours = decoder.pad_aligned_frame(frame, mode, device=CPU)
    assert isinstance(ours, framing.FrameError)
    _same_result(ours, jdecoder.pad_aligned_frame(frame, JMODES["QPSK"]))
