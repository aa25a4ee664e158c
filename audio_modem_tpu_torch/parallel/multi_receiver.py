"""The device half of the multi-stream receiver (counterpart of
audio_modem_tpu/parallel/multi_receiver.py; BASELINE config 5: a 500 MB
file over 64 parallel batched streams).

In steady state a chunked sender emits equal-length data frames on an exact
sample cadence, so one round decodes K frames per stream: slot 0 runs the
full receive (kernel A), slots 1..K-1 refine + demodulate at the previous
start + cadence, and the results come back as one packed uint8 matrix that
the host classifies. With a cadence prediction for slot 0 as well, the
round skips the scan altogether.

The samples of all streams live in a ``DeviceRing`` on the device; a round
(the ``*_dev`` functions) cuts each stream's window out of it, so per round
the host sends one [3, n] int32 parameter matrix and fetches one packed
result matrix. The staged stages (``_batch_scan``, ``_batch_refine``) serve
streams that are not in steady state. ``_Stream`` and ``BatchReceiver``,
the host half that drives all this, are not ported yet.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from audio_modem_tpu_torch import sync
from audio_modem_tpu_torch.configs import FRAME_DATA, ModemMode, OfdmProfile
from audio_modem_tpu_torch.kernels import resolve_device
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.runtime.receiver import SCAN_BUCKET, STREAM_MIN_ENERGY  # noqa: F401


def _batch_scan(windows: torch.Tensor, n_valid: torch.Tensor, profile: OfdmProfile):
    """Staged scan of [n, SCAN_BUCKET] windows: (coarse int32 [n], best
    metric [n]); a stream that is not scanning is masked by n_valid = 0."""
    return sync.detect_preamble(windows, profile, n_valid, min_energy=STREAM_MIN_ENERGY, stride=sync.COARSE_STRIDE)


def _batch_refine(regions: torch.Tensor, coarse_rel: torch.Tensor, n_valid: torch.Tensor, profile: OfdmProfile):
    """Staged xcorr refine of [n, region] windows around ``coarse_rel`` [n]:
    (start int32 [n], best metric [n])."""
    return sync.refine_xcorr(regions, coarse_rel, profile, n_valid)


def _ring_gather(ring: "DeviceRing", rows, rel_starts, length: int) -> torch.Tensor:
    """Ranges of ``length`` samples out of ``ring``: row ``rows[k]`` from
    ``rel_starts[k]`` samples after the oldest one -> [len(rows), length] on
    the ring's device. ``rows`` and ``rel_starts`` are host integers, so no
    index tensor is built: a run of consecutive rows that share a start
    (streams in lockstep) is one strided copy, or two where the range
    crosses the end of the buffer; rows that start elsewhere are cut one by
    one."""
    cap = ring.capacity
    rows, rel_starts = [int(r) for r in rows], [int(r) for r in rel_starts]
    out = torch.empty((len(rows), length), dtype=torch.float32, device=ring.buf.device)
    k = 0
    while k < len(rows):
        row, rel = rows[k], rel_starts[k]
        if rel < 0 or rel + length > cap:
            raise ValueError(f"range [{rel}, {rel + length}) leaves the ring of {cap} samples")
        end = k + 1
        while end < len(rows) and rows[end] == row + end - k and rel_starts[end] == rel:
            end += 1
        src = ring.buf[row : row + end - k]
        pos = (ring.total_written + rel) % cap
        first = min(length, cap - pos)
        out[k:end, :first].copy_(src[:, pos : pos + first])
        if first < length:
            out[k:end, first:].copy_(src[:, : length - first])
        k = end
    return out


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


def _vote_pack(detected: torch.Tensor, start: torch.Tensor, bits: torch.Tensor, mode: ModemMode) -> torch.Tensor:
    """Repetition vote, byte pack and ``_pack_round`` of one slot."""
    if mode.repetition > 1:
        bits = majority_vote(bits, mode.repetition)
    return _pack_round(detected, start, bits_to_bytes(bits))


class DeviceRing:
    """Device-resident lockstep ring for n streams: [n, capacity] float32 on
    ``device``, the multi-stream analog of ``RingBuffer`` whose samples stay
    on the device. All streams advance together, so one write position
    serves every row.

    It is a true ring: ``write`` stores a block at ``total_written %
    capacity`` in place (two slices where the block wraps) and touches
    nothing else, and a read that crosses the end of the buffer is cut in two
    (``_ring_gather``). ``rel`` gives a global position relative to the
    oldest sample held, the coordinate the round's parameters use.
    ``capacity`` is rounded up to a multiple of 128."""

    def __init__(self, n: int, capacity: int, device="cuda"):
        self.capacity = -(-capacity // 128) * 128
        self.buf = torch.zeros((n, self.capacity), dtype=torch.float32, device=resolve_device(device))
        self.total_written = 0

    def write(self, blocks: "np.ndarray | torch.Tensor") -> None:
        """Append [n, l] samples to every stream; with l > capacity only the
        last ``capacity`` samples are stored, global positions advance by l."""
        blocks = torch.as_tensor(blocks).to(device=self.buf.device, dtype=torch.float32)
        l = blocks.shape[1]
        keep = min(l, self.capacity)
        pos = (self.total_written + l - keep) % self.capacity
        first = min(keep, self.capacity - pos)
        self.buf[:, pos : pos + first] = blocks[:, l - keep : l - keep + first]
        if first < keep:
            self.buf[:, : keep - first] = blocks[:, l - keep + first :]
        self.total_written += l

    def rel(self, global_start: int) -> int:
        return global_start - (self.total_written - self.capacity)

    def get_range(self, row: int, global_start: int, length: int) -> np.ndarray | None:
        """Host fetch for the staged fallback paths (parse-failure retries,
        flush tails). One device-to-host copy per call."""
        r = self.rel(global_start)
        if r < 0 or global_start + length > self.total_written:
            return None
        return _ring_gather(self, [row], [r], length)[0].cpu().numpy()

    def gather_ranges(self, rows: "list[int]", global_starts: "list[int]", length: int) -> np.ndarray:
        """Batched host fetch: equal-length ranges for several streams in one
        device-to-host copy. Callers pre-check validity via rel() and
        total_written."""
        return _ring_gather(self, rows, [self.rel(s) for s in global_starts], length).cpu().numpy()


class _DeviceRingView:
    """Per-stream RingBuffer-API adapter over a shared DeviceRing row, so
    the staged FSM stages (refine/demod/flush) work unchanged when the
    samples live on the device."""

    def __init__(self, ring: DeviceRing, row: int):
        self._ring = ring
        self._row = row

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    @property
    def total_written(self) -> int:
        return self._ring.total_written

    def get_range(self, global_start: int, length: int) -> np.ndarray | None:
        return self._ring.get_range(self._row, global_start, length)

    def available_from(self, global_start: int) -> int:
        return self._ring.total_written - global_start

    def write(self, samples) -> None:  # writes go through the shared ring
        raise NotImplementedError("streams on the device share the DeviceRing")


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
    w = windows.shape[1]
    slots = []
    if pred0 is None:
        out0 = batch.batch_decode_signals(windows, n_valid, mode, n_sym_frame, min_pos=min_pos)
        slots.append(_vote_pack(out0["detected"], out0["start"], out0["bits"], mode))
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
            slots.append(_vote_pack(prev_ok, prev_start, out["bits"], mode))
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


def _batch_window_decode(windows: torch.Tensor, n_valid: torch.Tensor, mode: ModemMode, max_syms: int) -> torch.Tensor:
    """One full receive (kernel A) over every scanning stream's window with
    the repetition vote and byte pack behind it -> packed [n, 5 + n_bytes]."""
    out = batch.batch_decode_signals(windows, n_valid, mode, max_syms)
    return _vote_pack(out["detected"], out["start"], out["bits"], mode)


def _round_inputs(ring: DeviceRing, params: "np.ndarray | torch.Tensor", w: int):
    """A round's inputs from the ring and the host's [3, n] int32 ``params``
    (row 0 ``start_rel``): the [n, w] windows cut at ``start_rel``, and
    ``params`` on the ring's device, sent as ONE upload."""
    host = torch.as_tensor(params)
    n = ring.buf.shape[0]
    if host.device.type != "cpu" or host.dtype != torch.int32 or tuple(host.shape) != (3, n):
        raise ValueError(f"params: need host int32 [3, {n}], got {host.dtype} {tuple(host.shape)} on {host.device}")
    windows = _ring_gather(ring, range(n), host[0].tolist(), w)
    return windows, host.to(ring.buf.device)


def _batch_window_decode_dev(
    ring: DeviceRing, params: "np.ndarray | torch.Tensor", mode: ModemMode, max_syms: int, w: int
) -> torch.Tensor:
    """``_batch_window_decode`` on windows cut out of the resident ring: the
    samples never cross the host boundary. ``params`` is the host's [3, n]
    int32 matrix (start_rel, min_pos, n_valid)."""
    windows, dev = _round_inputs(ring, params, w)
    out = batch.batch_decode_signals(windows, dev[2], mode, max_syms, min_pos=dev[1])
    return _vote_pack(out["detected"], out["start"], out["bits"], mode)


def _batch_window_decode_multi_dev(
    ring: DeviceRing,
    params: "np.ndarray | torch.Tensor",
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    w: int,
) -> torch.Tensor:
    """The turbo round on windows cut out of the ring. ``params`` is the
    host's [3, n] int32 matrix (start_rel, min_pos, n_valid)."""
    windows, dev = _round_inputs(ring, params, w)
    return _multi_decode_core(windows, dev[2], dev[1], mode, n_sym_frame, k_frames, cadence)


def _batch_window_decode_pred_dev(
    ring: DeviceRing,
    params: "np.ndarray | torch.Tensor",
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    w: int,
) -> torch.Tensor:
    """Scan-free steady-state round: every slot, slot 0 included, decodes at
    a cadence-predicted position. ``params`` is the host's [3, n] int32
    matrix (start_rel, pred0 relative to the window, n_valid)."""
    windows, dev = _round_inputs(ring, params, w)
    return _multi_decode_core(windows, dev[2], None, mode, n_sym_frame, k_frames, cadence, pred0=dev[1])
