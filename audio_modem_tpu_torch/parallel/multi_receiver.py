"""The device half of the multi-stream turbo receive round (counterpart of
audio_modem_tpu/parallel/multi_receiver.py; BASELINE config 5: a 500 MB
file over 64 parallel batched streams).

In steady state a chunked sender emits equal-length data frames on an exact
sample cadence, so one round decodes K frames per stream: slot 0 runs the
full receive (kernel A), slots 1..K-1 refine + demodulate at the previous
start + cadence, and the results come back as one packed uint8 matrix that
the host classifies. ``BatchReceiver``, the device ring and the chunk
assembler are not ported yet.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from audio_modem_tpu_torch.configs import FRAME_DATA, ModemMode
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
from audio_modem_tpu_torch.parallel import batch


def _pack_round(detected: torch.Tensor, start: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """One round's results as ONE uint8 matrix [n, 5 + n_bytes]: col 0 the
    detected flag, cols 1-4 the start (big-endian), then the decoded bytes,
    so a round needs a single device-to-host copy."""
    s = start.to(torch.int32)
    head = torch.stack(
        [detected.to(torch.uint8)] + [((s >> sh) & 0xFF).to(torch.uint8) for sh in (24, 16, 8, 0)],
        dim=1,
    )
    return torch.cat([head, by], dim=1)


def _unpack_round(packed: np.ndarray):
    detected = packed[..., 0].astype(bool)
    starts = (
        (packed[..., 1].astype(np.int64) << 24)
        | (packed[..., 2].astype(np.int64) << 16)
        | (packed[..., 3].astype(np.int64) << 8)
        | packed[..., 4].astype(np.int64)
    )
    return detected, starts, packed[..., 5:]


def _classify_round(packed: np.ndarray, chunk_size: int):
    """Vectorized classification of a K-slot round [n, K, 5 + n_bytes]:
    marks the slots that are CRC-valid data frames of exactly ``chunk_size``
    payload bytes. Returns (detected, starts, full, seqs), each [n, K], or
    None when the rows cannot hold a full chunk."""
    detected, starts, by = _unpack_round(packed)
    crc_off = 7 + chunk_size
    if by.shape[-1] < crc_off + 4:
        return None
    dlen = (by[:, :, 5].astype(np.int32) << 8) | by[:, :, 6]
    cand = detected & (by[:, :, 0] == FRAME_DATA) & (dlen == chunk_size)

    def be32(col: int) -> np.ndarray:
        return (
            (by[:, :, col].astype(np.int64) << 24)
            | (by[:, :, col + 1].astype(np.int64) << 16)
            | (by[:, :, col + 2].astype(np.int64) << 8)
            | by[:, :, col + 3].astype(np.int64)
        )

    seqs = be32(1)
    expected = be32(crc_off)
    full = np.zeros(cand.shape, bool)
    for i, k in zip(*np.nonzero(cand)):
        full[i, k] = zlib.crc32(by[i, k, :crc_off]) == expected[i, k]
    return detected, starts, full, seqs


def _multi_decode_core(
    windows: torch.Tensor,
    n_valid: torch.Tensor,
    min_pos: torch.Tensor | None,
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    pred0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode up to ``k_frames`` successive frames of known symbol count and
    cadence per stream -> packed [n, K, 5 + n_bytes].

    Without ``pred0``, slot 0 runs the full receive and slots 1..K-1 refine
    around prev_start + cadence. With ``pred0`` (window-relative predicted
    start of slot 0) every slot is predicted and the scan is skipped. A slot
    counts as detected only if every slot before it was."""

    def pack(detected, start, bits):
        if mode.repetition > 1:
            bits = majority_vote(bits, mode.repetition)
        return _pack_round(detected, start, bits_to_bytes(bits))

    w = windows.shape[1]
    slots = []
    if pred0 is None:
        out0 = batch.batch_decode_signals(windows, n_valid, mode, n_sym_frame, min_pos=min_pos)
        slots.append(pack(out0["detected"], out0["start"], out0["bits"]))
        prev_start, prev_ok = out0["start"].to(torch.int32), out0["detected"]
        n_pred = k_frames - 1
    else:
        prev_start = (pred0 - cadence).to(torch.int32)
        prev_ok = torch.ones(windows.shape[0], dtype=torch.bool, device=windows.device)
        n_pred = k_frames
    if n_pred:
        ext = batch.preprocess_extend(windows, n_valid, mode, n_sym_frame)
        for _ in range(n_pred):
            coarse = torch.clamp(prev_start + cadence, 0, w - 1).to(torch.int32)
            out = batch.batch_decode_predicted(ext, coarse, n_valid, mode, n_sym_frame)
            prev_ok = out["detected"] & prev_ok
            prev_start = out["start"].to(torch.int32)
            slots.append(pack(prev_ok, prev_start, out["bits"]))
    return torch.stack(slots, dim=1)


def _batch_window_decode_multi(
    windows: torch.Tensor,
    min_pos: torch.Tensor,
    n_valid: torch.Tensor,
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
) -> torch.Tensor:
    """The steady-state turbo round over [n, w] stream windows -> packed
    [n, K, 5 + n_bytes] uint8."""
    return _multi_decode_core(windows, n_valid, min_pos, mode, n_sym_frame, k_frames, cadence)
