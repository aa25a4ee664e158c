"""The port's arq.py against the JAX package's (device="cpu"): request
frames byte for byte, the request decode over the air, and selective-repeat
sessions — single-stream and batched — on the same deterministic channel
callables, with equal completion, rounds, chunks sent per round, bytes and
file names (the scenarios of tests/test_arq.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from audio_modem_tpu import arq as jarq
from audio_modem_tpu import framing as jframing
from audio_modem_tpu.configs import MODES as JMODES
from audio_modem_tpu_torch import arq, framing
from audio_modem_tpu_torch.configs import MODES

torch.set_num_threads(2)


@pytest.mark.parametrize("missing", [[3, 7, 100000], [], list(range(300))])
def test_request_payload_and_parse_match(missing):
    pl = arq.build_request_payload(missing)
    assert pl == jarq.build_request_payload(missing)
    ours, ref = arq.parse_request(pl), jarq.parse_request(pl)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.crc_valid and ours.missing == missing[: arq.MAX_SEQS_PER_REQUEST]
    assert ours.is_ack == (missing == [])
    bad = pl[:-1] + bytes([pl[-1] ^ 1])
    assert not arq.parse_request(bad).crc_valid and not jarq.parse_request(bad).crc_valid
    for junk in (b"", b"\xfc\x00", bytes([0xFE]) + pl[1:], pl[:5]):
        e, je = arq.parse_request(junk), jarq.parse_request(junk)
        assert isinstance(e, framing.FrameError) and e.error == je.error


@pytest.mark.parametrize("name", ["QPSK", "BPSK-REPEAT"])
def test_request_over_the_air(name):
    """The port's request frame is the JAX package's within the TX
    tolerance, and each package's decoder reads the other's frame."""
    sig = arq.build_request_frame([1, 5, 9], MODES[name], device="cpu").numpy()
    ref = jarq.build_request_frame([1, 5, 9], JMODES[name])
    assert sig.shape == ref.shape and np.abs(sig - ref).max() <= 3e-5
    for frame in (sig, ref):
        req = arq._decode_request(frame, MODES[name], device="cpu")
        assert isinstance(req, arq.RequestFrame), req
        assert req.crc_valid and req.missing == [1, 5, 9]
    assert jarq._decode_request(sig, JMODES[name]).missing == [1, 5, 9]


def test_request_reacquired_after_a_lost_preamble():
    """A request whose first preamble is wiped fails the Schmidl-Cox pass;
    both packages fall back to the same xcorr re-acquisition outcome."""
    mode = MODES["QPSK"]
    sig = arq.build_request_frame([2, 4], mode, device="cpu").numpy().copy()
    p = mode.profile
    pre = p.silence_pre_chunk(True)
    sig[pre : pre + p.symbol_len // 2] = 0.0
    ours = arq._decode_request(sig, mode, device="cpu")
    ref = jarq._decode_request(sig, JMODES["QPSK"])
    assert type(ours).__name__ == type(ref).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def _both_sessions(data: bytes, name: str, file_name: str, make_channels, **kw):
    """One session in each package, each with its own fresh copies of the
    same deterministic channel callables. Returns the port's report."""
    ours = arq.run_arq_session(data, MODES[name], file_name, *make_channels(), device="cpu", **kw)
    ref = jarq.run_arq_session(data, JMODES[name], file_name, *make_channels(), **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    return ours


def test_clean_channel_single_round():
    data = np.random.default_rng(0).bytes(MODES["QPSK"].chunk_size * 3 + 10)
    rep = _both_sessions(data, "QPSK", "a.bin", lambda: (lambda s: s,))
    assert rep.complete and rep.data == data and rep.chunks_sent_per_round == [4] and rep.rounds == 1


def test_dropout_triggers_selective_repeat():
    mode = JMODES["QPSK"]
    data = np.random.default_rng(1).bytes(mode.chunk_size * 4)  # 4 chunks
    f0 = jframing.build_metadata_frame(4, len(data), mode.chunk_size, "b.bin", mode)
    f1 = jframing.build_data_chunk_frame(data[: mode.chunk_size], 0, mode)

    def channels():
        calls = {"n": 0}

        def lossy_forward(sig):
            calls["n"] += 1
            if calls["n"] == 1:  # kill chunk 2's frame on the first pass
                start = len(f0) + 2 * len(f1)
                out = sig.copy()
                out[start : start + len(f1)] = 0.0
                return out
            return sig

        return (lossy_forward,)

    rep = _both_sessions(data, "QPSK", "b.bin", channels, max_rounds=4)
    assert rep.complete and rep.data == data
    assert rep.chunks_sent_per_round == [4, 1]  # only the lost chunk resent


def test_noisy_back_link_retries():
    data = np.random.default_rng(2).bytes(MODES["QPSK"].chunk_size + 1)
    back_calls = []

    def channels():
        state = {"back": 0, "dropped": False}

        def forward(sig):
            if not state["dropped"]:
                state["dropped"] = True
                out = sig.copy()
                out[-len(sig) // 3 :] = 0.0  # lose the tail (chunk 1)
                return out
            return sig

        def backward(sig):
            state["back"] += 1
            back_calls.append(state["back"])
            return np.zeros_like(sig) if state["back"] == 1 else sig  # first request lost

        return forward, backward

    rep = _both_sessions(data, "QPSK", "c.bin", channels, max_rounds=5)
    assert rep.complete and rep.data == data and rep.rounds >= 3
    assert back_calls.count(2) == 2  # each package retried its request


def _batch_both(datas, names, make_forward, **kw):
    ours = arq.run_batch_arq_session(datas, MODES["QPSK"], names, make_forward(), device="cpu", **kw)
    ref = jarq.run_batch_arq_session(datas, JMODES["QPSK"], names, make_forward(), **kw)
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in ref]
    return ours


def test_batch_all_clean_single_round():
    rng = np.random.default_rng(8)
    datas = [rng.bytes(MODES["QPSK"].chunk_size * 2 + 5) for _ in range(4)]
    names = [f"c{i}.bin" for i in range(4)]
    reps = _batch_both(datas, names, lambda: (lambda i, s: s))
    assert all(r.complete for r in reps) and all(r.data == d for r, d in zip(reps, datas))
    assert all(r.chunks_sent_per_round == [3] for r in reps)


def test_batch_8_streams_with_per_stream_dropouts():
    """Round 1 kills chunk (i // 2) % 3's frame on every even stream (the
    pattern of tests/test_arq.py at 8 streams; the card runs 64)."""
    mode = JMODES["QPSK"]
    n, cs = 8, mode.chunk_size
    rng = np.random.default_rng(7)
    datas = [rng.bytes(cs * 3) for _ in range(n)]
    names = [f"f{i:02d}.bin" for i in range(n)]
    meta_len = len(jframing.build_metadata_frame(3, cs * 3, cs, names[0], mode))
    chunk_len = len(jframing.build_data_chunk_frame(datas[0][:cs], 0, mode))

    def make_forward():
        seen = [0] * n

        def forward(i, sig):
            seen[i] += 1
            if seen[i] == 1 and i % 2 == 0:
                start = meta_len + ((i // 2) % 3) * chunk_len
                out = sig.copy()
                out[start : start + chunk_len] = 0.0
                return out
            return sig

        return forward

    reps = _batch_both(datas, names, make_forward, max_rounds=4)
    for i, r in enumerate(reps):
        assert r.complete and r.data == datas[i] and r.file_name == names[i]
        assert r.chunks_sent_per_round == ([3, 1] if i % 2 == 0 else [3])


def test_synthesize_mixed_keeps_order_and_matches_single_frames():
    mode = MODES["QPSK"]
    p = mode.profile
    pre, post = p.silence_pre_chunk(False), p.silence_post_chunk()
    items = [(framing.build_data_chunk_payload(bytes([k]) * size, k), pre, post)
             for k, size in enumerate([40, 90, 40, 90, 17])]
    sigs = arq._synthesize_mixed(items, mode, "cpu")
    assert all(isinstance(s, np.ndarray) for s in sigs)
    for (pl, a, b), sig in zip(items, sigs):
        one = framing.synthesize_frame(pl, mode, a, b, device="cpu").numpy()
        # a batched product may round differently from a batch of one
        assert sig.shape == one.shape and np.abs(sig - one).max() <= 3e-5


def test_sessions_default_to_the_card():
    import inspect

    for fn in (arq.run_arq_session, arq.run_batch_arq_session, arq.build_request_frame, arq._decode_request):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arq.run_arq_session(b"abc", MODES["QPSK"], "x", lambda s: s)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arq.run_batch_arq_session([b"abc"], MODES["QPSK"], ["x"], lambda i, s: s)
