"""Real audio-device I/O: capture and playback streams behind the same
binary-stream interface the rest of L0 speaks (a copy of
audio_modem_tpu/runtime/audiodev.py; it touches no tensor).

The reference actually moves sound through speakers and microphones:
AudioContext playback (app.js:161-176, 305-316) and getUserMedia capture at
44.1 kHz with echoCancellation/noiseSuppression/autoGainControl disabled
(app.js:349-356, 1068-1075). This module closes that capability gap for
hosts that HAVE audio hardware, while staying import-guarded so the
CI image (which has none) never needs it.

Design: every backend presents as a plain binary PCM stream — ``.read(n)``
for capture, ``.write(bytes)``/``.flush()`` for playback — so
``ingest.read_pcm_blocks`` / ``ingest.PacedWriter`` / ``ingest.listen`` /
``ingest.play`` work unchanged on top (the platform boundary stays "any
byte stream", this module just knows how to open one that ends in a DAC).

Backend resolution order for ``--device auto``:

1. ``sounddevice`` (PortAudio) if importable — cross-platform, the
   getUserMedia/AudioContext equivalent. Latency hint and blocksize follow
   the reference's 4096-sample ScriptProcessorNode blocks.
2. ALSA CLI tools (``arecord``/``aplay``) if on PATH — zero-dependency
   Linux fallback; the subprocess's stdio IS the PCM stream.
3. A filesystem path (FIFO, character device, or file) — ``--device
   /path`` opens it directly; useful for OS loopback devices and bridges.

Capture matches the reference's constraints: mono, 44.1 kHz, float32, and
no host-side DSP (PortAudio applies none; for ALSA we read the raw PCM).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import BinaryIO

RATE = 44100  # the protocol's fixed sample rate (modem.js:1-20)
BLOCK = 4096  # ScriptProcessorNode block size (app.js:391)


# ---------------- sounddevice (PortAudio) backend ----------------


class _SdCaptureStream:
    """File-like .read(nbytes) over a sounddevice.RawInputStream."""

    def __init__(self, device, rate: int, block: int):
        import sounddevice  # noqa: F401  (import-guarded by caller)

        self._sd = sounddevice
        self._stream = sounddevice.RawInputStream(
            samplerate=rate,
            blocksize=block,
            device=device,
            channels=1,
            dtype="float32",
            latency="high",  # throughput over latency: the modem resyncs anyway
        )
        self._stream.start()

    def read(self, nbytes: int) -> bytes:
        frames = max(nbytes // 4, 1)
        data, _overflowed = self._stream.read(frames)
        # RawInputStream returns a buffer of float32 frames; overflow just
        # means dropped samples — the modem's preamble scan re-syncs.
        return bytes(data)

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _SdPlaybackStream:
    """File-like .write(bytes)/.flush() over a sounddevice.RawOutputStream.

    The device consumes samples at the audio rate, so writes block on the
    device's own clock — callers should disable PacedWriter's host-side
    pacing (speed<=0) to avoid double pacing."""

    def __init__(self, device, rate: int, block: int):
        import sounddevice  # noqa: F401

        self._stream = sounddevice.RawOutputStream(
            samplerate=rate,
            blocksize=block,
            device=device,
            channels=1,
            dtype="float32",
            latency="high",
        )
        self._stream.start()

    def write(self, buf: bytes) -> int:
        self._stream.write(buf)
        return len(buf)

    def flush(self) -> None:
        pass  # RawOutputStream.write blocks until buffered in the device

    def close(self) -> None:
        # drain before close so the tail of the last frame is audible
        self._stream.stop()
        self._stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------- ALSA CLI (arecord/aplay) backend ----------------


def _alsa_capture(device: str | None, rate: int) -> BinaryIO:
    dev = [] if device in (None, "default") else ["-D", str(device)]
    proc = subprocess.Popen(
        ["arecord", "-q", "-f", "FLOAT_LE", "-r", str(rate), "-c", "1", "-t", "raw", *dev],
        stdout=subprocess.PIPE,
    )
    stream = proc.stdout
    stream._amt_proc = proc  # keep the child alive as long as the stream
    return stream


def _alsa_playback(device: str | None, rate: int) -> BinaryIO:
    dev = [] if device in (None, "default") else ["-D", str(device)]
    proc = subprocess.Popen(
        ["aplay", "-q", "-f", "FLOAT_LE", "-r", str(rate), "-c", "1", "-t", "raw", *dev],
        stdin=subprocess.PIPE,
    )
    stream = proc.stdin
    stream._amt_proc = proc
    return stream


# ---------------- resolution ----------------


def _have_sounddevice() -> bool:
    try:
        import sounddevice  # noqa: F401

        return True
    except Exception:  # ImportError, or PortAudio missing at load time
        return False


def open_capture(device: str = "auto", rate: int = RATE, block: int = BLOCK):
    """Open an audio CAPTURE stream (mic -> float32 PCM bytes).

    ``device``: "auto" resolves sounddevice -> arecord -> error;
    "sd:<name-or-index>" forces sounddevice; "alsa:<dev>" forces arecord;
    any existing filesystem path is opened directly (FIFO/device/file).
    Returns an object with ``.read(nbytes)`` and ``.close()``."""
    if device.startswith("sd:"):
        return _SdCaptureStream(_sd_dev(device[3:]), rate, block)
    if device.startswith("alsa:"):
        return _alsa_capture(device[5:] or None, rate)
    if device != "auto" and os.path.exists(device):
        return open(device, "rb", buffering=0)
    if device == "auto":
        if _have_sounddevice():
            return _SdCaptureStream(None, rate, block)
        if shutil.which("arecord"):
            return _alsa_capture(None, rate)
        raise RuntimeError(
            "no audio capture backend: install the 'sounddevice' package or "
            "ALSA's arecord, or pass --device <path> for a FIFO/device file"
        )
    raise RuntimeError(f"audio device not found: {device!r}")


def open_playback(device: str = "auto", rate: int = RATE, block: int = BLOCK):
    """Open an audio PLAYBACK stream (float32 PCM bytes -> speaker).

    Same ``device`` grammar as open_capture. Returns an object with
    ``.write(bytes)``, ``.flush()`` and ``.close()``. The device clocks the
    writes itself — pair with PacedWriter(speed=0)."""
    if device.startswith("sd:"):
        return _SdPlaybackStream(_sd_dev(device[3:]), rate, block)
    if device.startswith("alsa:"):
        return _alsa_playback(device[5:] or None, rate)
    if device != "auto" and (os.path.exists(device) or device.startswith("/")):
        return open(device, "wb", buffering=0)
    if device == "auto":
        if _have_sounddevice():
            return _SdPlaybackStream(None, rate, block)
        if shutil.which("aplay"):
            return _alsa_playback(None, rate)
        raise RuntimeError(
            "no audio playback backend: install the 'sounddevice' package or "
            "ALSA's aplay, or pass --device <path> for a FIFO/device file"
        )
    raise RuntimeError(f"audio device not found: {device!r}")


def _sd_dev(spec: str):
    if not spec or spec == "default":
        return None
    return int(spec) if spec.lstrip("-").isdigit() else spec
