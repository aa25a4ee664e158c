"""The benchmark's reference and transmitter on the CPU: the transmitter
rebuilds the golden WAVs (written by the float64 oracle) sample for sample
at their 16-bit precision, and the reference decodes them to the
manifest's payloads."""

import json
import wave
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import oracle, profiles

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "golden"
MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())


def read_pcm16(name: str) -> np.ndarray:
    with wave.open(str(GOLDEN / name), "rb") as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (44100, 2, 1)
        return np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)


@pytest.mark.parametrize("mode", sorted(MANIFEST))
def test_transmitter_rebuilds_golden_wav(mode):
    entry = MANIFEST[mode]
    sig = oracle.transmit_signal(bytes.fromhex(entry["payload_hex"]), mode, entry["file_name"]).numpy()
    pcm = read_pcm16(entry["wav"])
    assert sig.dtype == np.float32 and sig.shape == pcm.shape == (entry["samples"],)
    # the WAV writer's quantization: clip, scale by 32767, truncate
    assert np.array_equal((np.clip(sig, -1.0, 1.0) * 32767.0).astype(np.int16), pcm)


@pytest.mark.parametrize("mode", sorted(MANIFEST))
def test_reference_decodes_golden_wav(mode):
    entry = MANIFEST[mode]
    x = torch.from_numpy(read_pcm16(entry["wav"]).astype(np.float32) / 32768.0)
    out = oracle.decode_signal(x, mode)
    parsed = out["parsed"]
    assert bool(out["detected"]) and parsed["type"] == "legacy" and parsed["crc_valid"]
    assert parsed["file_name"] == entry["file_name"]
    assert parsed["data"].hex() == entry["payload_hex"]


def test_crc_rows_is_the_table_crc():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 256, size=(7, 300), dtype=np.uint8)
    got = profiles.crc32_rows(torch.from_numpy(rows)).tolist()
    assert got == [profiles.crc32(r.tobytes()) for r in rows] == [zlib.crc32(r.tobytes()) for r in rows]


def test_chunk_frames_decode_to_their_payloads():
    """Data-chunk frames made in a batch decode one by one to their seq and bytes."""
    mode = profiles.MODES["QPSK"]
    p = mode.profile
    chunks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(3, 64), dtype=np.uint8))
    fr = oracle.frames(oracle.data_chunk_payloads(chunks, torch.tensor([5, 6, 7])), mode,
                       p.silence_pre_chunk(False), p.silence_post_chunk())
    assert fr.shape[1] == oracle.frame_len(75, mode, p.silence_pre_chunk(False), p.silence_post_chunk())
    for k in range(3):
        parsed = oracle.decode_signal(fr[k], "QPSK")["parsed"]
        assert parsed["type"] == "data" and parsed["crc_valid"] and parsed["seq"] == 5 + k
        assert parsed["data"] == chunks[k].numpy().tobytes()


def test_refine_finds_the_frame_start_under_noise():
    mode = profiles.MODES["QPSK"]
    p = mode.profile
    x = oracle.transmit_signal(bytes(range(200)), "QPSK", "n.bin")
    x = x + 0.01 * torch.randn(x.shape[0], generator=torch.Generator().manual_seed(1))
    out = oracle.receive(x[None], torch.tensor([x.shape[0]]), torch.tensor([0]), p)
    assert bool(out["detected"][0]) and int(out["start"][0]) == p.silence_pre_legacy()
