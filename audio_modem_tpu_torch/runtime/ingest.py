"""L0 analog: real-time PCM ingest and paced playback over byte streams
(counterpart of audio_modem_tpu/runtime/ingest.py).

The reference's platform layer is Web Audio: getUserMedia capture feeding
4096-sample Float32 blocks to the streaming receiver (app.js:349-417,
app.js:1068-1114) and AudioContext playback with per-frame double buffering
(app.js:235-265, app.js:305-316). Here the platform boundary is any binary
STREAM — a pipe, socket, stdin, or file — carrying raw PCM: blocks arrive
over wall-clock time with backpressure, frames decode as they complete, and
the sender paces output at the audio rate while building the next frame
concurrently (the double-buffering that hides encode latency behind
playback, app.js:253-257).

The PCM and the pacing live on the host. ``listen`` decodes on ``device``
through the port's ``StreamingReceiver``; ``play`` synthesizes its frames on
``device`` and brings each to the host on the worker thread that builds it.
Both default to ``"cuda"`` and raise without a CUDA device unless given
``device="cpu"``.

PCM formats: 'f32' (native float32) and 's16' (int16 little-endian, scaled
by 1/32768 like Web Audio's capture path).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections.abc import Iterator
from typing import BinaryIO, Callable

import numpy as np

from audio_modem_tpu_torch.api import ChunkedDecodeResult, _resolve
from audio_modem_tpu_torch.configs import ModemMode
from audio_modem_tpu_torch.framing import FrameError
from audio_modem_tpu_torch.runtime.receiver import StreamingReceiver
from audio_modem_tpu_torch.utils.metrics import StreamStats

BLOCK = 4096  # ScriptProcessorNode block size (app.js:391)

_FMT = {
    "f32": (np.float32, 4, 1.0),
    "s16": (np.int16, 2, 1.0 / 32768.0),
}


def read_pcm_blocks(stream: BinaryIO, block: int = BLOCK, fmt: str = "f32") -> Iterator[np.ndarray]:
    """Yield float32 blocks of up to ``block`` samples from a binary stream
    until EOF. Blocks arrive as the stream delivers them — a slow (paced)
    writer naturally produces real-time behavior; no buffering beyond one
    block is added here (backpressure flows to the writer through the pipe)."""
    dtype, width, scale = _FMT[fmt]
    nbytes = block * width
    while True:
        buf = stream.read(nbytes)
        if not buf:
            return
        # partial trailing sample (torn write): keep whole samples only
        usable = len(buf) - len(buf) % width
        if not usable:
            return
        samples = np.frombuffer(buf[:usable], dtype=dtype).astype(np.float32)
        if scale != 1.0:
            samples = samples * np.float32(scale)
        yield samples


@dataclasses.dataclass
class LevelMeter:
    """Running input-level meter — the live RMS/peak/clipping readout the
    reference renders from an AnalyserNode (app.js:1198-1249). EMA-smoothed
    RMS like the canvas meter's visual decay; clipping = RMS > 0.9."""

    rms: float = 0.0
    peak: float = 0.0
    clipping: bool = False
    _alpha: float = 0.6

    def update(self, block: np.ndarray) -> None:
        if not len(block):
            return
        # float64 + finite-guard: arbitrary byte streams decode to inf/NaN
        # float32s, which must not poison (or warn in) the meter
        b = np.nan_to_num(block.astype(np.float64), posinf=1.0, neginf=-1.0)
        r = float(np.sqrt(np.mean(b * b)))
        self.rms = self._alpha * self.rms + (1.0 - self._alpha) * r
        self.peak = max(self.peak * 0.95, float(np.abs(b).max()))
        self.clipping = self.rms > 0.9


@dataclasses.dataclass
class ListenReport:
    result: ChunkedDecodeResult | FrameError
    stats: StreamStats
    blocks: int
    samples: int
    elapsed_s: float

    @property
    def realtime_factor(self) -> float:
        """Processed-samples/s over the audio rate; >1 = faster than live."""
        return (self.samples / 44100.0) / self.elapsed_s if self.elapsed_s > 0 else float("inf")


def listen(
    stream: BinaryIO,
    mode: str | ModemMode = "QPSK",
    block: int = BLOCK,
    fmt: str = "f32",
    persist_path: str | None = None,
    resume: bool = False,
    fec: bool = False,
    on_file: Callable[[str, bytes], None] | None = None,
    on_stats: Callable[[StreamStats, int, "LevelMeter"], None] | None = None,
    stats_every_blocks: int = 64,
    device="cuda",
) -> ListenReport:
    """Live receive: read PCM blocks from ``stream`` until EOF, feeding the
    StreamingReceiver on ``device`` as they arrive (startStreamingReceive,
    app.js:1059-1161).

    ``on_file(name, data)`` fires the moment a transfer completes (mid-stream,
    like the reference's auto-download); ``on_stats`` fires every
    ``stats_every_blocks`` blocks with live counters (the level-meter/progress
    analog). Returns a ListenReport with the assembled (possibly partial)
    result, like stopping the reference receiver."""
    m = _resolve(mode)
    rx = StreamingReceiver(m, persist_path=persist_path, resume=resume, on_file=on_file, fec=fec, device=device)
    meter = LevelMeter()
    t0 = time.perf_counter()
    blocks = 0
    samples = 0
    for blk in read_pcm_blocks(stream, block, fmt):
        meter.update(blk)
        rx.process_audio_block(blk)
        blocks += 1
        samples += len(blk)
        if on_stats is not None and blocks % stats_every_blocks == 0:
            on_stats(rx.stats, samples, meter)
    rx.flush()
    elapsed = time.perf_counter() - t0
    asm = rx.assembler
    if asm.total_chunks == 0:
        result: ChunkedDecodeResult | FrameError = FrameError("No metadata frame received")
    else:
        result = ChunkedDecodeResult(
            file_name=asm.file_name,
            data=asm.assemble(),
            total_chunks=asm.total_chunks,
            received_chunks=asm.received_count,
            missing_chunks=asm.missing_chunks(),
            crc_errors=asm.crc_errors,
        )
    report = ListenReport(result, rx.stats, blocks, samples, elapsed)
    rx.cleanup()
    return report


class PacedWriter:
    """Writes PCM to a stream at (a multiple of) the audio sample rate —
    the AudioContext playback analog. ``speed`` > 1 plays faster than real
    time (tests); ``speed`` <= 0 disables pacing (pure throughput)."""

    def __init__(self, stream: BinaryIO, fmt: str = "f32", speed: float = 1.0, rate: int = 44100):
        self.stream = stream
        self.fmt = fmt
        self.speed = speed
        self.rate = rate
        self._t0: float | None = None
        self._written = 0

    def write(self, samples: np.ndarray, block: int = BLOCK) -> None:
        """Write host samples (a numpy array) in ``block``-sample pieces."""
        if self.fmt == "s16":
            out = np.clip(samples, -1.0, 1.0)
            out = (out * 32767.0).astype(np.int16)
        else:
            out = np.asarray(samples, np.float32)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        for off in range(0, len(out), block):
            chunk = out[off : off + block]
            self.stream.write(chunk.tobytes())
            self._written += len(chunk)
            if self.speed > 0:
                due = self._t0 + self._written / (self.rate * self.speed)
                delay = due - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
        self.stream.flush()


def play(
    data: bytes,
    stream: BinaryIO,
    mode: str | ModemMode = "QPSK",
    file_name: str = "file",
    fmt: str = "f32",
    speed: float = 1.0,
    fec: bool = False,
    chunked: bool = True,
    on_frame: Callable[[int, int], None] | None = None,
    device="cuda",
) -> int:
    """Paced transmit: encode ``data`` on ``device`` and write PCM at the
    audio rate with per-frame double buffering — frame ``seq+1`` is built
    and brought to the host on a worker thread while frame ``seq`` is being
    written/paced (app.js:235-265), so the pacing loop never waits on the
    device. Returns the number of samples written.

    Defaults to CHUNKED framing for any size: play()'s live peer is
    listen(), whose streaming receiver — like the reference's
    (decodeChunkFrame, modem.js:770) — only speaks meta/data chunk frames.
    ``chunked=False`` restores the reference sender's 32 KB size routing
    (legacy single frame for small files; decode those with cli decode)."""
    from audio_modem_tpu_torch.api import encode_chunked, encode_legacy
    from audio_modem_tpu_torch.configs import CHUNK_THRESHOLD

    m = _resolve(mode)
    writer = PacedWriter(stream, fmt=fmt, speed=speed)

    # Lazy frame source keeps O(chunk) memory on the chunked path, mirroring
    # the reference's Blob.slice reads (app.js:297-303).
    if not chunked and len(data) <= CHUNK_THRESHOLD:
        it = iter([encode_legacy(data, m, file_name, fec=fec, device=device)])
        total = 1
    else:
        it = encode_chunked(data, m, file_name, fec=fec, device=device)
        total = 1 + -(-len(data) // m.chunk_size)

    def next_frame() -> np.ndarray | None:
        frame = next(it, None)
        return None if frame is None else frame.cpu().numpy()

    # Double buffering: build frame seq+1 (synthesis and its copy to the
    # host) on a worker thread while frame seq is being paced out
    # (app.js:253-257) — encode latency hides behind playback time.
    # A failure on the worker (synthesis on the device included) is handed
    # to this thread and raised here; nothing is retried elsewhere.
    slot: list[np.ndarray | BaseException | None] = [None]
    built = threading.Event()

    def prebuild() -> None:
        try:
            slot[0] = next_frame()
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            slot[0] = e
        finally:
            built.set()

    written = 0
    current: np.ndarray | BaseException | None = next_frame()
    seq = 0
    while current is not None:
        built.clear()
        threading.Thread(target=prebuild, daemon=True).start()
        writer.write(current)
        written += len(current)
        if on_frame is not None:
            on_frame(seq, total)
        seq += 1
        built.wait()
        current = slot[0]
        if isinstance(current, BaseException):
            raise current
    return written
