"""The port's audio-device backend (audio_modem_tpu_torch/runtime/audiodev.py,
a copy of the JAX package's): every scenario of tests/test_audiodev.py on
the copy, with the same fake sounddevice and subprocess mocks, the mocked
over-the-air round trip through the port's ``play`` and ``listen`` on the
CPU, and the copy's code held equal to the original's."""

import ast
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from audio_modem_tpu.runtime import audiodev as jaudiodev
from audio_modem_tpu_torch.runtime import audiodev

torch.set_num_threads(2)


class _FakeRawStream:
    """Stands in for sounddevice.RawInputStream/RawOutputStream: playback
    writes land in a shared byte buffer, capture reads drain it — a loopback
    'room' between the fake speaker and fake microphone."""

    room = bytearray()

    def __init__(self, samplerate, blocksize, device, channels, dtype, latency):
        assert samplerate == 44100 and channels == 1 and dtype == "float32"
        self.started = False
        self.closed = False

    def start(self):
        self.started = True

    def stop(self):
        pass

    def close(self):
        self.closed = True

    def write(self, buf):
        _FakeRawStream.room.extend(bytes(buf))

    def read(self, frames):
        n = min(frames * 4, len(_FakeRawStream.room))
        out = bytes(_FakeRawStream.room[:n])
        del _FakeRawStream.room[:n]
        return out, False


@pytest.fixture
def fake_sounddevice(monkeypatch):
    mod = types.ModuleType("sounddevice")
    mod.RawInputStream = _FakeRawStream
    mod.RawOutputStream = _FakeRawStream
    monkeypatch.setitem(sys.modules, "sounddevice", mod)
    _FakeRawStream.room = bytearray()
    return mod


def _code(module) -> str:
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(open(module.__file__).read())
    tree.body = tree.body[1:]
    return ast.dump(tree)


def test_the_copy_is_the_original():
    assert _code(audiodev) == _code(jaudiodev)
    assert (audiodev.RATE, audiodev.BLOCK) == (jaudiodev.RATE, jaudiodev.BLOCK)


class TestResolution:
    def test_no_backend_errors_with_guidance(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "sounddevice", None)  # import -> None -> fails
        monkeypatch.setattr(audiodev.shutil, "which", lambda _: None)
        with pytest.raises(RuntimeError, match="no audio capture backend"):
            audiodev.open_capture("auto")
        with pytest.raises(RuntimeError, match="no audio playback backend"):
            audiodev.open_playback("auto")
        with pytest.raises(RuntimeError, match="audio device not found"):
            audiodev.open_capture("no-such-device")

    def test_path_backend(self, tmp_path):
        p = tmp_path / "pcm.raw"
        out = audiodev.open_playback(str(p))
        out.write(np.arange(8, dtype=np.float32).tobytes())
        out.close()
        inp = audiodev.open_capture(str(p))
        got = np.frombuffer(inp.read(32), np.float32)
        inp.close()
        assert np.array_equal(got, np.arange(8, dtype=np.float32))

    def test_alsa_backend_spawns_subprocess(self, monkeypatch):
        calls = []

        class _P:
            stdout = open("/dev/null", "rb")
            stdin = open("/dev/null", "wb")

        def fake_popen(cmd, **kw):
            calls.append(cmd)
            return _P()

        monkeypatch.setattr(subprocess, "Popen", fake_popen)
        audiodev.open_capture("alsa:hw:1,0")
        audiodev.open_playback("alsa:")
        assert calls[0][:2] == ["arecord", "-q"] and "hw:1,0" in calls[0]
        assert calls[1][:2] == ["aplay", "-q"] and "-D" not in calls[1]
        # 44.1 kHz mono float32 raw — the protocol's fixed wire format
        for c in calls:
            assert {"-f", "FLOAT_LE", "-r", "44100", "-c", "1"} <= set(c)

    def test_sd_device_spec(self):
        for spec in ("", "default", "3", "-1", "USB Mic"):
            assert audiodev._sd_dev(spec) == jaudiodev._sd_dev(spec)
        assert audiodev._sd_dev("3") == 3 and audiodev._sd_dev("USB Mic") == "USB Mic"


class TestMockedOverTheAir:
    def test_play_to_speaker_listen_on_mic_roundtrip(self, fake_sounddevice):
        """Full e2e through the device interfaces: the port's play() into
        the fake speaker, the fake mic feeds the port's listen() — the
        two-laptops-over-the-air scenario with the air mocked as a loopback
        buffer; the JAX package's play() puts the same number of samples
        into the room."""
        from audio_modem_tpu.runtime.ingest import play as jplay
        from audio_modem_tpu_torch.runtime.ingest import listen, play

        rng = np.random.default_rng(5)
        data = rng.bytes(3000)

        spk = jaudiodev.open_playback("sd:default")
        n_ref = jplay(data, spk, "QPSK", "air.bin", speed=0.0)
        spk.close()
        _FakeRawStream.room = bytearray()

        spk = audiodev.open_playback("sd:default")
        n = play(data, spk, "QPSK", "air.bin", speed=0.0, device="cpu")
        spk.close()
        assert n == n_ref > 0 and len(_FakeRawStream.room) == n * 4

        mic = audiodev.open_capture("sd:default")
        report = listen(mic, "QPSK", device="cpu")
        mic.close()
        res = report.result
        assert not isinstance(res, Exception)
        assert res.complete and res.data == data and res.file_name == "air.bin"
        assert report.samples == n

    def test_capture_stream_read_contract(self, fake_sounddevice):
        _FakeRawStream.room.extend(np.ones(4096, np.float32).tobytes())
        mic = audiodev.open_capture("auto")
        blk = mic.read(4096 * 4)
        assert len(blk) == 4096 * 4
        assert np.frombuffer(blk, np.float32).max() == 1.0
        mic.close()

    def test_auto_playback_prefers_sounddevice(self, fake_sounddevice):
        spk = audiodev.open_playback("auto")
        assert isinstance(spk, audiodev._SdPlaybackStream)
        assert spk.write(np.zeros(16, np.float32).tobytes()) == 64
        spk.flush()
        spk.close()
        assert len(_FakeRawStream.room) == 64
