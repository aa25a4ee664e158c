"""WAV file I/O — the framework's audio boundary for offline use.

The reference's L0 is the Web Audio API (app.js:161-176, 305-316); here the
platform boundary is 16-bit or float32 PCM WAV files plus raw numpy blocks
(for the streaming runtime), via the stdlib ``wave`` module.
"""

from __future__ import annotations

import wave

import numpy as np

from audio_modem_tpu_torch.configs import SAMPLE_RATE


def write_wav(path: str, signal: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write float signal in [-1, 1] as 16-bit PCM WAV."""
    pcm = np.clip(signal, -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())


def read_wav(path: str, max_seconds: float | None = None) -> tuple[np.ndarray, int]:
    """Read mono (or first-channel) WAV -> (float32 signal in [-1,1], rate).

    ``max_seconds`` caps the READ, not just the result — the RAM-budget
    control of the reference's manual receive (index.html:140-144: the
    recording-duration selector exists because Float32 audio costs ~10 MB
    per minute; app.js:339-417 stops accumulating at the cutoff)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        if max_seconds is not None:
            n = min(n, int(max_seconds * rate))
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels)[:, 0]
    return data, rate
