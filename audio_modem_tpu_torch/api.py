"""Public encode / decode surface (counterpart of audio_modem_tpu/api.py),
mirroring the reference app layer:

  encode()         <= 32 KB files as one legacy frame, larger ones chunked
                   (startSend, app.js:124-135)
  encode_legacy()  buildTransmitSignal (modem.js:498-555)
  encode_chunked() metadata frame + one data frame per chunk (app.js:201-303)
  decode()         decodeReceivedSignal (modem.js:557-654)
  decode_chunked() full receive of a chunked transmission from one recording

Same signatures as the JAX package plus a keyword ``device``: signals are
synthesized on it and decoded on it (see ``decoder``). It defaults to
``"cuda"``; without a CUDA device a call that does not pass
``device="cpu"`` raises. ``mode`` is a mode of this package's ``configs``
or a mode name.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np
import torch

from audio_modem_tpu_torch import decoder, framing
from audio_modem_tpu_torch.configs import CHUNK_THRESHOLD, ModemMode, get_mode
from audio_modem_tpu_torch.framing import FrameError, ParseResult
from audio_modem_tpu_torch.utils import trace


def _resolve(mode: str | ModemMode) -> ModemMode:
    return mode if isinstance(mode, ModemMode) else get_mode(mode)


def encode_legacy(
    data: bytes, mode: str | ModemMode = "QPSK", file_name: str = "file", fec: bool = False, device="cuda"
) -> torch.Tensor:
    """Single-frame TX signal (modem.js:498-555). ``fec=True`` wraps the
    payload in RS(255,223) (extension)."""
    return framing.build_transmit_signal(data, _resolve(mode), file_name, fec=fec, device=device)


def encode_chunked(
    data: bytes,
    mode: str | ModemMode = "QPSK",
    file_name: str = "file",
    fec: bool = False,
    batch: int = 16,
    device="cuda",
) -> Iterator[torch.Tensor]:
    """Chunked TX: yields the metadata frame, then one frame per chunk
    (playChunkedFrames, app.js:201-303). Data frames are synthesized in
    batches of up to ``batch`` equal-length chunks; a short last chunk forms
    its own batch."""
    m = _resolve(mode)
    chunk_size = m.chunk_size
    total_chunks = -(-len(data) // chunk_size)
    yield framing.build_metadata_frame(total_chunks, len(data), chunk_size, file_name, m, fec=fec, device=device)
    seq = 0
    while seq < total_chunks:
        group: list[bytes] = []
        while len(group) < batch and seq + len(group) < total_chunks:
            i = seq + len(group)
            chunk = data[i * chunk_size : (i + 1) * chunk_size]
            if group and len(chunk) != len(group[0]):
                break
            group.append(chunk)
        yield from framing.build_data_chunk_frames(group, seq, m, fec=fec, device=device)
        seq += len(group)


def encode(
    data: bytes, mode: str | ModemMode = "QPSK", file_name: str = "file", fec: bool = False, device="cuda"
) -> list[torch.Tensor]:
    """Size-routed encode (startSend, app.js:124-135): the list of frame
    signals (one for the legacy path)."""
    if len(data) <= CHUNK_THRESHOLD:
        return [encode_legacy(data, mode, file_name, fec=fec, device=device)]
    return list(encode_chunked(data, mode, file_name, fec=fec, device=device))


def decode(
    signal: "np.ndarray | torch.Tensor",
    mode: str | ModemMode = "QPSK",
    track_timing: bool = False,
    device="cuda",
) -> tuple[ParseResult, decoder.DecodeInfo | None]:
    """Full-signal decode of one frame (modem.js:557-654) on ``device``.
    ``track_timing`` turns on the clock-drift timing tracker (extension)."""
    return decoder.decode_signal(signal, _resolve(mode), track_timing=track_timing, device=device)


@dataclasses.dataclass
class ChunkedDecodeResult:
    file_name: str
    data: bytes
    total_chunks: int
    received_chunks: int
    missing_chunks: list[int]
    crc_errors: int

    @property
    def complete(self) -> bool:
        return not self.missing_chunks


def decode_chunked(
    signal: "np.ndarray | torch.Tensor", mode: str | ModemMode = "QPSK", fec: bool = False, device="cuda"
) -> ChunkedDecodeResult | FrameError:
    """Decode a full chunked transmission from one long recording by scanning
    frame-by-frame (offline analog of the streaming receiver). The recording
    is host audio: a tensor is brought to the host first, and the receiver
    uploads each window it scans, refines or decodes to ``device``. While the
    span recorder is on, the call is one ``rx.decode_chunked`` span (attrs
    ``samples`` and ``mode``) around the receiver's ``rx.*`` spans."""
    from audio_modem_tpu_torch.runtime.receiver import StreamingReceiver

    m = _resolve(mode)
    with trace.span("rx.decode_chunked") as root:
        rx = StreamingReceiver(m, fec=fec, device=device)
        if isinstance(signal, torch.Tensor):
            signal = signal.detach().cpu().numpy()
        signal = np.asarray(signal, dtype=np.float32).reshape(-1)
        root.set(samples=len(signal), mode=m.name)
        block = 4096
        for off in range(0, len(signal), block):
            rx.process_audio_block(signal[off : off + block])
        rx.flush()
        asm = rx.assembler
        if asm.total_chunks == 0:
            return FrameError("No metadata frame received")
        return ChunkedDecodeResult(
            file_name=asm.file_name,
            data=asm.assemble(),
            total_chunks=asm.total_chunks,
            received_chunks=asm.received_count,
            missing_chunks=asm.missing_chunks(),
            crc_errors=asm.crc_errors,
        )
