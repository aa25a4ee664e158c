"""Streaming receiver FSM (app.js:706-998; counterpart of
audio_modem_tpu/runtime/receiver.py), host control + device compute.

Per audio block: EMA DC removal -> ring write -> state dispatch:
  IDLE               incremental preamble scan over newly-covered positions
                     (strided Schmidl-Cox scan with first-peak commit on the
                     device: one ``stream_scan`` launch a window)
  PREAMBLE_DETECTED  fine xcorr refinement around the candidate (on the
                     device: one ``stream_refine`` launch a region);
                     false positive -> back to IDLE (app.js:879-884)
  COLLECTING_FRAME   wait until expectedFrameEnd worth of samples exist
  DEMODULATING       extract + per-frame peak normalization + decode, route
                     meta/data frames into the ChunkAssembler, resume the
                     scan at expectedFrameEnd (app.js:907-981)

The ring and the control flow (a few comparisons per block) stay on the
host; the scan, the refine and the frame decode run on ``device``. Each
device call costs one upload of its window and one copy of its result back,
read through ``kernels.read_back``.
``device`` defaults to ``"cuda"``; without a CUDA device a receiver that is
not given ``device="cpu"`` raises.

While the span recorder is on (``utils.trace``), a block's DC removal and
ring write record an ``rx.ingest`` span, a scan that evaluates windows an
``rx.scan`` span (attr ``windows``), a refine an ``rx.refine`` span (attr
``accepted``) and a frame's cut, normalization and decode an ``rx.frame``
span (attr ``kind``: meta, data, legacy or error), with the decoder's spans
inside it; the counters are ``rx_blocks``, ``scan_windows``, ``refines``,
``false_peaks``, ``frames``, ``frame_errors`` and ``chunks`` (data chunks
newly stored), beside the decoder's ``host_syncs``.
"""

from __future__ import annotations

import enum
from typing import Callable

import numpy as np
import torch

from audio_modem_tpu_torch import decoder, framing, native, sync
from audio_modem_tpu_torch.configs import ModemMode, OfdmProfile
from audio_modem_tpu_torch.kernels import read_back, read_pair, receive, resolve_device
from audio_modem_tpu_torch.runtime.assembler import ChunkAssembler
from audio_modem_tpu_torch.runtime.ring import RingBuffer
from audio_modem_tpu_torch.utils import log, trace
from audio_modem_tpu_torch.utils.metrics import StreamStats

# Streaming scan uses a lower energy gate than the offline path (app.js:796)
STREAM_MIN_ENERGY = 0.001
# Pre-meta frames are bounded by the metadata payload size (app.js:888-896)
PRE_META_MAX_PAYLOAD = 280
SCAN_BUCKET = 8192


class RecvState(enum.Enum):
    IDLE = 0
    PREAMBLE_DETECTED = 1
    COLLECTING_FRAME = 2
    DEMODULATING = 3


def _scan_window(window: torch.Tensor, n_valid: int, profile: OfdmProfile, out: torch.Tensor) -> torch.Tensor:
    """Coarse scan of one window [SCAN_BUCKET] whose first ``n_valid``
    samples count (what lies past them is never read as signal) into
    ``out``, its row int32 [1, 2] of ``receive.stream_scan``: the index or
    -1, and the best metric's float32 bits."""
    return receive.stream_scan(window[None], n_valid, profile, STREAM_MIN_ENERGY, out)


def _refine_window(window: torch.Tensor, coarse_rel: int, n_valid: int, profile: OfdmProfile):
    """Fine xcorr around ``coarse_rel`` in the first ``n_valid`` samples of
    ``window`` [SCAN_BUCKET] (what lies past them reads as 0): (start int32
    relative to the window, best metric float32), 0-dim tensors on the
    window's device. They are the two words of the fresh row of one
    ``receive.stream_refine``, so a metric kept from one refine keeps its
    value after the next, and ``kernels.read_pair`` reads both in one copy."""
    row = receive.stream_refine(window, coarse_rel, n_valid, profile)
    return row[0], row[1].view(torch.float32)


class StreamingReceiver:
    """One stream's receive pipeline."""

    def __init__(
        self,
        mode: ModemMode,
        persist_path: str | None = None,
        resume: bool = False,
        on_file: Callable[[str, bytes], None] | None = None,
        dc_alpha: float = 0.999,
        fec: bool = False,
        device="cuda",
    ):
        self.mode = mode
        self.fec = fec
        self.device = resolve_device(device)
        p = mode.profile
        max_payload = max(mode.chunk_size, 4096) + 16
        if fec:
            max_payload = framing.fec_wire_len(max_payload)
        max_frame = framing.estimate_frame_samples(max_payload, mode)
        self.ring = RingBuffer(max_frame * 3 + 8192)
        self.assembler = ChunkAssembler(persist_path, resume)
        self.stats = StreamStats()
        self.on_file = on_file

        self.state = RecvState.IDLE
        self.meta_received = False
        self.scan_pos = 0  # next global position to evaluate
        self.preamble_pos = -1
        self.expected_frame_end = -1

        self.dc_alpha = dc_alpha
        self.dc_mean = 0.0
        self._half = p.fft_size // 2

        # The scan's and the refine's buffers, reused call after call: a
        # staging block on the host (pinned where they run on a card, so the
        # upload does not wait), the window on the device and the scan's row
        # read back. A call overwrites only its first samples: neither kernel
        # reads a sample past its valid length, and each call's read back
        # waits for its upload, so the block is free for the next call.
        on_card = self.device.type == "cuda"
        self._stage_host = torch.zeros(SCAN_BUCKET, dtype=torch.float32, pin_memory=on_card)
        self._stage_dev = (
            torch.zeros(SCAN_BUCKET, dtype=torch.float32, device=self.device) if on_card else self._stage_host
        )
        self._scan_row = torch.empty((1, 2), dtype=torch.int32, device=self.device)

    # ---- ingest ----

    def process_audio_block(self, samples: np.ndarray) -> None:
        trace.count("rx_blocks")
        with trace.span("rx.ingest"):
            cleaned = self._remove_dc(np.asarray(samples, dtype=np.float32))
            self.ring.write(cleaned)
        self._step()

    def _remove_dc(self, x: np.ndarray) -> np.ndarray:
        """EMA DC tracker (app.js:750-755): native C++ sequential loop, with
        a closed-form numpy fallback inside ``native``."""
        cleaned, self.dc_mean = native.ema_dc_removal(x, self.dc_alpha, self.dc_mean)
        return cleaned

    def _step(self) -> None:
        progressed = True
        while progressed:
            progressed = False
            if self.state is RecvState.IDLE:
                progressed = self._scan()
            elif self.state is RecvState.PREAMBLE_DETECTED:
                progressed = self._refine()
            elif self.state is RecvState.COLLECTING_FRAME:
                progressed = self._check_complete()

    def _stage(self, samples: np.ndarray) -> torch.Tensor:
        """``samples`` (at most ``SCAN_BUCKET``) into the first samples of the
        reused device window, through the pinned staging block: one
        non-blocking upload. Returns the window."""
        n = len(samples)
        self._stage_host.numpy()[:n] = samples
        if self._stage_dev is not self._stage_host:
            self._stage_dev[:n].copy_(self._stage_host[:n], non_blocking=True)
        return self._stage_dev

    # ---- IDLE: incremental scan ----

    def _scan(self) -> bool:
        p = self.mode.profile
        total = self.ring.total_written
        oldest = total - self.ring.capacity
        self.scan_pos = max(self.scan_pos, oldest, 0)
        scan_end = total - 2 * self._half  # last evaluable position
        if self.scan_pos > scan_end:
            return False

        # evaluate positions [scan_pos, scan_end] in bucketed windows
        with trace.span("rx.scan") as sp:
            windows = 0
            while self.scan_pos <= scan_end:
                n_pos = min(scan_end - self.scan_pos + 1, SCAN_BUCKET - 2 * self._half)
                win_len = n_pos + 2 * self._half - 1
                window = self.ring.get_range(self.scan_pos, win_len)
                if window is None:
                    self.scan_pos = max(self.scan_pos, self.ring.total_written - self.ring.capacity)
                    continue
                windows += 1
                trace.count("scan_windows")
                row = _scan_window(self._stage(window), win_len, p, self._scan_row)
                # the scan's one copy back to the host; it also waits for the
                # upload, so the staging block is free for the next window
                idx = int(read_back("scan", row)[0, 0])
                if idx >= 0:
                    self.preamble_pos = self.scan_pos + idx
                    # Advance only past the committed peak (not the whole window)
                    # so a later true preamble in the same window is re-scanned
                    # after a refinement false-positive (app.js keeps acScanPos at
                    # the drop-commit point for the same reason).
                    self.scan_pos = self.preamble_pos + self._half
                    self.state = RecvState.PREAMBLE_DETECTED
                    break
                self.scan_pos += n_pos
            sp.set(windows=windows)
        return self.state is RecvState.PREAMBLE_DETECTED

    # ---- PREAMBLE_DETECTED: fine xcorr ----

    def _refine(self) -> bool:
        p = self.mode.profile
        plen = p.symbol_len
        radius = 3 * p.cp_len
        needed = self.preamble_pos + plen + radius
        if self.ring.total_written < needed:
            return False  # wait for more samples (app.js:860-862)

        with trace.span("rx.refine") as sp:
            trace.count("refines")
            lo = max(self.ring.total_written - self.ring.capacity, self.preamble_pos - radius, 0)
            region_len = 2 * radius + plen
            region = self.ring.get_range(lo, min(region_len, self.ring.available_from(lo)))
            if region is None:
                sp.set(accepted=False)
                self._reset_to_idle()
                return True
            best_rel, metric = read_pair(
                "refine", *_refine_window(self._stage(region), self.preamble_pos - lo, len(region), p))
            accepted = metric >= sync.XCORR_THRESHOLD
            sp.set(accepted=accepted)
            if not accepted:
                # false positive -> back to scanning (app.js:879-884)
                trace.count("false_peaks")
                self.state = RecvState.IDLE
                return True
        # the refine returns an index relative to its window
        self.preamble_pos = lo + best_rel
        max_payload = (
            (self.assembler.chunk_size or 4096) + 11 if self.meta_received else PRE_META_MAX_PAYLOAD
        )
        if self.fec:
            max_payload = framing.fec_wire_len(max_payload)
        frame_samples = framing.estimate_frame_samples(max_payload, self.mode)
        self.expected_frame_end = self.preamble_pos + frame_samples
        self.state = RecvState.COLLECTING_FRAME
        return True

    # ---- COLLECTING / DEMODULATING ----

    def _check_complete(self) -> bool:
        if self.ring.total_written < self.expected_frame_end:
            return False
        self.state = RecvState.DEMODULATING
        self._demodulate_frame()
        return True

    def _demodulate_frame(self, partial_ok: bool = False) -> None:
        trace.count("frames")
        with trace.span("rx.frame") as sp:
            sp.set(kind=self._decode_frame(partial_ok))

    def _decode_frame(self, partial_ok: bool) -> str:
        """Cut, normalize and decode the collected frame, route it, and resume
        the scan: the frame's kind (meta, data, legacy or error)."""
        frame_len = self.expected_frame_end - self.preamble_pos
        if partial_ok:
            frame_len = min(frame_len, self.ring.available_from(self.preamble_pos))
        frame = self.ring.get_range(self.preamble_pos, frame_len)
        if frame is None:
            self.stats.frame_errors += 1
            trace.count("frame_errors")
            self._reset_to_idle()
            return "error"
        # per-frame normalization (app.js:918-925), on the host in float32 so
        # the demod is fed the same bits as the JAX package's
        mx = np.abs(frame).max()
        if mx > 1e-6:
            frame = frame / mx
        result = decoder.decode_chunk_frame(frame, self.mode, device=self.device)
        resume_pos = None
        if isinstance(result, framing.FrameError):
            self.stats.frame_errors += 1
            trace.count("frame_errors")
            log.frame_error(result.error, pos=self.preamble_pos)
            # Unknown frame length: skip the header and rescan the region
            # (the xcorr refinement rejects data-region false peaks).
            resume_pos = self.preamble_pos + 4 * self.mode.profile.symbol_len
        else:
            self.stats.frames_decoded += 1
            if isinstance(result, framing.MetaFrame):
                if result.crc_valid:
                    self.assembler.handle_metadata(result)
                    self.meta_received = True
                    self.stats.total_chunks = result.total_chunks
                    log.frame_decoded("meta", file=result.file_name, chunks=result.total_chunks)
                else:
                    self.stats.frame_errors += 1
                    trace.count("frame_errors")
                    log.frame_error("metadata CRC", pos=self.preamble_pos)
            elif isinstance(result, framing.DataFrame):
                if self.assembler.handle_data_chunk(result):
                    trace.count("chunks")
                self.stats.crc_errors = self.assembler.crc_errors
                self.stats.chunks_received = self.assembler.received_count
                log.chunk_received(result.seq_num, self.assembler.total_chunks, crc_ok=result.crc_valid)
                if self.assembler.is_complete:
                    log.transfer_complete(self.assembler.file_name, self.assembler.total_file_size)
                    if self.on_file is not None:
                        self.on_file(self.assembler.file_name, self.assembler.assemble())
            # Resume at the frame's ACTUAL length, computed from the decoded
            # payload, instead of the reference's worst-case estimate
            # (app.js:888-896 + 974-981) which overshoots short frames and
            # loses the next frames entirely (e.g. every pre-meta narrowband
            # frame). Bounded by the collected window for CRC-garbage safety.
            payload_len = None
            if isinstance(result, framing.MetaFrame) and result.crc_valid:
                payload_len = 12 + len(result.file_name.encode("utf-8")) + 4
            elif isinstance(result, framing.DataFrame) and result.crc_valid:
                payload_len = 11 + len(result.data)
            if payload_len is not None:
                if self.fec:
                    payload_len = framing.fec_wire_len(payload_len)
                actual = framing.estimate_frame_samples(payload_len, self.mode)
                resume_pos = min(
                    self.preamble_pos + actual,
                    self.expected_frame_end if self.expected_frame_end > 0 else self.preamble_pos + actual,
                )
        self._reset_to_idle(resume_pos)
        for cls, kind in ((framing.FrameError, "error"), (framing.MetaFrame, "meta"), (framing.DataFrame, "data")):
            if isinstance(result, cls):
                return kind
        return "legacy"

    def _reset_to_idle(self, resume_pos: int | None = None) -> None:
        """Resume scanning after the current frame (app.js:974-981)."""
        if resume_pos is not None:
            self.scan_pos = resume_pos
        elif self.expected_frame_end > 0:
            self.scan_pos = self.expected_frame_end
        elif self.preamble_pos > 0:
            self.scan_pos = self.preamble_pos + self.mode.profile.symbol_len
        self.preamble_pos = -1
        self.expected_frame_end = -1
        self.state = RecvState.IDLE

    def flush(self) -> None:
        """End of input: try to decode a partially collected frame (stop with
        partial assembly, app.js:1142-1160)."""
        if self.state in (RecvState.PREAMBLE_DETECTED, RecvState.COLLECTING_FRAME) and self.preamble_pos >= 0:
            have = self.ring.available_from(self.preamble_pos)
            if have >= 4 * self.mode.profile.symbol_len:
                if self.expected_frame_end < 0:
                    self.expected_frame_end = self.preamble_pos + have
                self._demodulate_frame(partial_ok=True)

    def cleanup(self) -> None:
        self.assembler.cleanup()
