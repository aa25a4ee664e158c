"""Multi-stream streaming receiver (counterpart of
audio_modem_tpu/parallel/multi_receiver.py; BASELINE config 5: a 500 MB
file over 64 parallel batched streams).

``BatchReceiver`` runs N independent receive FSMs through shared batched
device calls, every block:

  1. ingest: batched native EMA DC removal into per-stream host rings, or
     (``device_ingest``) one write into a ``DeviceRing`` on the card
  2. staged machine: one [N, scan_bucket] scan, one [N, region] xcorr
     refine, and one frame-aligned demod (kernel B) per frame-length group
  3. turbo machine (``window_decode``): the full receive (kernel A) over
     every scanning stream's window, and in steady state K-frame rounds

In steady state a chunked sender emits equal-length data frames on an exact
sample cadence, so one round decodes K frames per stream: slot 0 runs the
full receive, slots 1..K-1 refine + demodulate at the previous start +
cadence, and the results come back as one packed uint8 matrix that the host
classifies. With a cadence prediction for slot 0 as well, the round skips
the scan altogether, and such rounds are dispatched speculatively: their
results are fetched up to ``pipeline_depth`` rounds later and a stream
rolls back on any deviation.

The samples of all streams live in a ``DeviceRing``; a round (the ``*_dev``
functions) cuts each stream's window out of it, so per round the host sends
one [3, n] int32 parameter matrix and fetches one packed result matrix. The
host keeps the per-stream FSM in numpy and Python integers.
"""

from __future__ import annotations

import zlib
from collections import deque

import numpy as np
import torch

from audio_modem_tpu_torch import decoder, framing, native, sync
from audio_modem_tpu_torch.configs import FRAME_DATA, ModemMode, OfdmProfile
from audio_modem_tpu_torch.kernels import resolve_device
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote, soft_combine
from audio_modem_tpu_torch.parallel import batch
from audio_modem_tpu_torch.parallel.batch import batch_decode_chunk_frames_packed
from audio_modem_tpu_torch.runtime.assembler import AsyncBatchWriter, ChunkAssembler
from audio_modem_tpu_torch.runtime.receiver import PRE_META_MAX_PAYLOAD, SCAN_BUCKET, STREAM_MIN_ENERGY, RecvState
from audio_modem_tpu_torch.runtime.ring import RingBuffer
from audio_modem_tpu_torch.utils.metrics import StreamStats
from audio_modem_tpu_torch.utils.trace import StageTimer


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


class _Stream:
    __slots__ = (
        "ring", "assembler", "stats", "state", "meta_received",
        "scan_pos", "preamble_pos", "expected_frame_end", "defer_total",
        "pred_start", "gen", "inflight",
    )

    def __init__(self, ring_capacity: int, persist_path: str | None, resume: bool, writer=None):
        # a RingBuffer, or a _DeviceRingView over the shared DeviceRing
        self.ring = RingBuffer(ring_capacity)
        self.assembler = ChunkAssembler(persist_path, resume, writer=writer)
        self.stats = StreamStats()
        self.state = RecvState.IDLE
        self.meta_received = False
        self.scan_pos = 0
        self.preamble_pos = -1
        self.expected_frame_end = -1
        # turbo deferral: a detected frame that will fit a FUTURE window
        # waits for samples instead of dropping to the staged machine;
        # re-scan once total_written exceeds this
        self.defer_total = -1
        # cadence prediction of the NEXT frame's absolute start (-1 unknown):
        # when every active stream carries one, the round skips even the
        # slot-0 scan (_batch_window_decode_pred_dev)
        self.pred_start = -1
        # speculation generation: bumped whenever the stream's truth state
        # deviates from a speculatively dispatched round's assumption, so
        # in-flight results for this stream are discarded on fetch
        self.gen = 0
        # frame slots dispatched speculatively but not yet consumed: the
        # remaining-chunks clamp counts these, or the last rounds of a
        # transfer overshoot and force an end-of-input rollback
        self.inflight = 0


class BatchReceiver:
    """N independent streams decoded with shared batched device calls.

    ``device`` (default ``"cuda"``) is where the scan, refine, demod and
    turbo rounds run and, with ``device_ingest``, where the ring lives;
    without a CUDA device a receiver that is not given ``device="cpu"``
    raises. The FSM, the host rings and the routing stay on the host.

    On CUDA a ``*_dispatch`` stage of ``timer`` times the launches alone
    and the matching ``*_fetch`` stage the wait for the result; a
    speculative round's wait is ``pipe_fetch``.

    ``pipeline_depth`` keeps the JAX package's decisions (its default of 8
    hid a slow host-device round trip). On an H100 no depth has measured
    faster than synchronous fetches (``pipeline_depth=0``): the rounds are
    bound by their host launches, and the fetch waits little.

    The JAX package's ``mesh`` argument (the stream axis sharded over
    several chips) is not part of this port yet.
    """

    def __init__(
        self,
        mode: ModemMode,
        n_streams: int,
        persist_dir: str | None = None,
        resume: bool = False,
        dc_alpha: float = 0.999,
        fec: bool = False,
        scan_bucket: int = SCAN_BUCKET,
        window_decode: bool = False,
        device_ingest: bool = False,
        frames_per_round: int = 8,
        pipeline_depth: int = 8,
        device="cuda",
    ):
        self.mode = mode
        self.fec = fec
        self.n = n_streams
        self.device = resolve_device(device)
        # Device-resident ingest: blocks (host numpy or a tensor on the
        # device) go into ONE shared [n, cap] DeviceRing; turbo windows are
        # cut on the device, so per round only scalars go up and decoded
        # bytes come down. Implies window_decode; host EMA DC removal is
        # skipped, since the window's own preprocess (mean-subtract + peak
        # norm) subsumes it.
        self.device_ingest = bool(device_ingest)
        window_decode = window_decode or self.device_ingest
        # turbo steady state: frames decoded per round
        self.frames_per_round = max(int(frames_per_round), 1)
        # Speculative fetch pipeline (device-ingest steady state): a fully
        # cadence-predicted round's SCHEDULING needs no decode results, so
        # predicted rounds are dispatched with an asynchronous copy to the
        # host and queued; their results are read up to pipeline_depth
        # rounds later. Consumption validates each round against its
        # speculated positions and rolls the stream back (per-stream
        # generation counter) on any deviation. 0 disables.
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self._pending: deque = deque()
        # Turbo path: the full receive over each scanning stream's window
        # yields detection, refined start and decoded bytes in one call.
        # Frames that don't fit the window or fail to parse fall back to
        # the staged machine and its retry ladder.
        self.window_decode = bool(window_decode)
        # positions per staged scan call: scan_bucket - fft per stream
        self.scan_bucket = int(scan_bucket)
        p = mode.profile
        max_payload = max(mode.chunk_size, 4096) + 16
        if fec:
            max_payload = framing.fec_wire_len(max_payload)
        max_frame = framing.estimate_frame_samples(max_payload, mode)
        # the ring must hold a whole K-frame turbo round plus scan margin
        cap = max_frame * max(3, self.frames_per_round + 1) + max(8192, self.scan_bucket)
        self._max_frame = max_frame
        if device_ingest and self.pipeline_depth > 0:
            # rollback safety: a deviation is found only when its
            # speculative round is consumed, up to pipeline_depth K-rounds
            # after dispatch, and the staged retry ladder then re-reads that
            # frame from the ring, so the ring keeps the in-flight span
            # (process_blocks also drains the oldest round whenever its
            # window nears eviction, so any capacity stays correct)
            cap += self.pipeline_depth * self.frames_per_round * max_frame
        # one shared background sqlite thread for every stream's assembler
        self._writer = AsyncBatchWriter() if persist_dir else None
        self.streams = [
            _Stream(
                cap if not self.device_ingest else 0,
                f"{persist_dir}/stream{i}.db" if persist_dir else None,
                resume,
                writer=self._writer,
            )
            for i in range(n_streams)
        ]
        if self.device_ingest:
            self.dring = DeviceRing(n_streams, cap, device=self.device)
            for i, s in enumerate(self.streams):
                s.ring = _DeviceRingView(self.dring, i)
        self.dc_alpha = dc_alpha
        self.dc_states = np.zeros(n_streams, dtype=np.float64)
        # per-stage wall-clock accounting (dispatch vs fetch vs host
        # consume), read via .timer.report() after a run
        self.timer = StageTimer()
        self._half = p.fft_size // 2
        plen = p.symbol_len
        radius = 3 * p.cp_len
        self._region_len = 2 * radius + plen
        self._refine_pad = self._region_len + plen
        self._win_max_syms = max((self.scan_bucket - 3 * plen) // plen, 1)
        # window margin kept ahead of a predicted slot 0 (refinement radius
        # + symbol context); must stay below _multi_params' window margin
        self._pred_pad = 4 * plen + 1024

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---- ingest ----

    def process_blocks(self, blocks: "np.ndarray | torch.Tensor") -> None:
        """blocks: [n_streams, block_len] float32, one audio block per
        stream, all streams in lockstep (zeros for silent ones). Under
        device ingest, blocks may be a tensor on the receiver's device:
        it is written into the ring with no copy through the host."""
        if blocks.shape[0] != self.n:
            raise ValueError(f"blocks: need one row per stream ({self.n}), got {tuple(blocks.shape)}")
        if self.device_ingest:
            self.dring.write(blocks)
        else:
            cleaned = native.ema_dc_removal_batch(np.asarray(blocks), self.dc_alpha, self.dc_states)
            for s, row in zip(self.streams, cleaned):
                s.ring.write(row)
        if self._pending:
            # rollback safety: settle any in-flight speculative round whose
            # window base is close to leaving the device ring
            self._drain_pending()
        # iterate state steps until no stream progresses (frames can
        # complete several states within one block)
        for _ in range(8):
            if not self._step_all():
                break

    def _step_all(self) -> bool:
        if self.window_decode:
            progressed = self._window_decode_all()
        else:
            progressed = self._scan_all()
        progressed |= self._refine_all()
        progressed |= self._demod_ready()
        return progressed

    # ---- turbo: the full receive over each window ----

    def _multi_params(self, active: "list[int]", w_cap: int) -> "tuple[int, int, int, int, int] | None":
        """(n_sym_frame, est_len, cadence, k, w) when every active stream
        expects the SAME data-frame shape (post-metadata steady state), the
        precondition for the K-frames-per-round program.

        k is the number of frame slots: frames_per_round, clamped by the
        fewest chunks any active stream still needs and by how many frame
        cadences fit ``w_cap``, then rounded down to a power of two (the
        JAX package's compile buckets; here they fix the round shapes). w
        is the window that holds k frames."""
        if self.frames_per_round <= 1:
            return None
        css = set()
        remaining = 1 << 30
        for i in active:
            s = self.streams[i]
            if not s.meta_received or not s.assembler.chunk_size:
                return None
            css.add(s.assembler.chunk_size)
            remaining = min(
                remaining,
                max(s.assembler.total_chunks - s.assembler.received_count - s.inflight, 1),
            )
        if len(css) != 1:
            return None
        mp_payload = css.pop() + 11
        if self.fec:
            mp_payload = framing.fec_wire_len(mp_payload)
        p = self.mode.profile
        est_len = framing.estimate_frame_samples(mp_payload, self.mode)
        cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
        margin = 4 * p.symbol_len + 2 * self._half + 2048
        k = min(self.frames_per_round, remaining, max((w_cap - margin) // cadence, 1))
        if k <= 1:
            return None
        k = 1 << (k.bit_length() - 1)
        w = -(-(k * cadence + margin) // 128) * 128
        return (framing.num_symbols_for_payload(mp_payload, self.mode), est_len, cadence, k, min(w, w_cap))

    def precompile(self, chunk_size: int | None = None) -> int:
        """The number of round programs the JAX package's receiver builds
        ahead of time for a transfer with the given steady-state chunk size
        (default: the mode's): one per power-of-two k (two under device
        ingest: scanned and predicted) plus the startup round.

        Nothing is compiled here and nothing runs: the kernels are built
        at their first launch and PyTorch has no per-shape programs. The
        method stays so that callers port unchanged."""
        cs = int(chunk_size) if chunk_size is not None else self.mode.chunk_size
        mp_payload = cs + 11
        if self.fec:
            mp_payload = framing.fec_wire_len(mp_payload)
        p = self.mode.profile
        est_len = framing.estimate_frame_samples(mp_payload, self.mode)
        cadence = est_len + p.silence_pre_chunk(False) + p.silence_post_chunk()
        margin = 4 * p.symbol_len + 2 * self._half + 2048
        w_cap = self.dring.capacity if self.device_ingest else self.scan_bucket
        k_max = min(self.frames_per_round, max((w_cap - margin) // cadence, 1))
        k = 1 << (k_max.bit_length() - 1) if k_max > 1 else 0
        n_built = 0
        while k >= 2:
            n_built += 2 if self.device_ingest else 1
            k //= 2
        return n_built + 1

    def _consume_multi(
        self, active, bases, lens, packed: np.ndarray, est_len: int, cadence: int, w: int,
        predicted: bool = False, spec_gens: "dict[int, int] | None" = None,
    ) -> bool:
        """Route up to K frame slots per stream, in order, stopping at the
        first undetected / deferred / short / failed slot.

        ``predicted``: the round was fully cadence-predicted (slot 0 had no
        scan), so a slot-0 miss says nothing about the window: coverage does
        not advance, the prediction is cleared and the rerun scans.

        Returns whether another round could make progress NOW: a stream
        whose last slot came back undetected or deferred contributes nothing
        until more samples arrive.

        ``spec_gens``: the round was dispatched speculatively, with these
        per-stream generations. Streams whose gen moved since are skipped.
        On full success the cursors advanced at dispatch time stay; on any
        deviation the gen is bumped (discarding the stream's later in-flight
        rounds) and the truth-state updates apply as usual."""
        rerun = False
        spec = spec_gens is not None
        # vectorized pre-pass: unpack + classify every slot in one numpy
        # sweep, so the per-slot loop reads precomputed scalars in steady
        # state instead of building bytes + parse + DataFrame per slot
        with self.timer.stage("consume_classify"):
            det_all, start_all, by_all = _unpack_round(packed)
            full_all = seq_all = None
            fast_ok = None
            cs0 = self.streams[active[0]].assembler.chunk_size if active else 0
            if not self.fec and cs0:
                cls = _classify_round(packed, cs0)
                if cls is not None:
                    _, _, full_all, seq_all = cls
                    # whole-round eligibility: a stream whose every slot is a
                    # CRC-valid full chunk ending inside the window takes
                    # none of the per-slot break branches below
                    ia = np.asarray(active, np.intp)
                    lens_a = np.asarray([int(lens[i]) for i in active])
                    fast_ok = full_all[ia].all(axis=1) & (start_all[ia] + est_len <= lens_a[:, None]).all(axis=1)
        for j_act, i in enumerate(active):
            s = self.streams[i]
            if spec and spec_gens[i] != s.gen:
                continue
            if spec:
                s.inflight = max(s.inflight - packed.shape[1], 0)
            base = bases[i]
            if not spec:
                s.defer_total = -1
                s.pred_start = -1
            saved_pred, saved_defer = s.pred_start, s.defer_total
            last_start = -1

            def k_next() -> int:
                return min(
                    self.frames_per_round,
                    max(s.assembler.total_chunks - s.assembler.received_count - s.inflight, 1),
                )

            det, start_v, by_row = det_all[i], start_all[i], by_all[i]
            if fast_ok is not None and fast_ok[j_act] and s.meta_received and s.assembler.chunk_size == cs0:
                # whole-round fast path: the same state updates the per-slot
                # loop would make, without K Python iterations
                kk = packed.shape[1]
                s.assembler.store_valid_chunks(seq_all[i], by_row, 7, cs0)
                s.stats.frames_decoded += kk
                s.stats.chunks_received = s.assembler.received_count
                last_start = base + int(start_v[kk - 1])
                s.scan_pos = last_start + est_len
                s.preamble_pos = -1
                s.expected_frame_end = -1
                s.state = RecvState.IDLE
                if spec:
                    # every slot routed as speculated: the cursors advanced
                    # at dispatch time stay the live truth
                    s.pred_start, s.defer_total = saved_pred, saved_defer
                    continue
                s.pred_start = last_start + cadence
                next_round_end = s.pred_start + (k_next() - 1) * cadence + est_len
                if next_round_end <= s.ring.total_written:
                    rerun = True
                else:
                    s.defer_total = next_round_end - 1
                continue
            for k in range(packed.shape[1]):
                if not bool(det[k]):
                    if k == 0 and not predicted:
                        # full-scan slot found nothing: positions up to the
                        # scan horizon are clean. If the window ended short
                        # of the write head there is more to cover now.
                        s.scan_pos = max(s.scan_pos, base + max(int(lens[i]) - 2 * self._half + 1, 1))
                        if base + int(lens[i]) < s.ring.total_written:
                            rerun = True
                    else:
                        # a failed PREDICTION says nothing about frames at
                        # other positions: rescan from the last consumed one
                        rerun = True
                        if spec:
                            s.gen += 1
                            s.inflight = 0
                            s.pred_start = -1
                            s.defer_total = -1
                    break
                abs_start = base + int(start_v[k])
                est_end = abs_start + est_len
                if est_end > base + int(lens[i]):
                    if spec:  # later in-flight rounds assumed this one fit
                        s.gen += 1
                        s.inflight = 0
                    if est_len <= w:
                        # wait until a whole round of frames can exist; the
                        # frame's start seeds the next round's prediction
                        s.defer_total = est_end - 1 + (k_next() - 1) * cadence
                        s.pred_start = abs_start
                    else:
                        s.preamble_pos = abs_start
                        s.scan_pos = abs_start + self._half
                        s.state = RecvState.PREAMBLE_DETECTED
                        rerun = True
                    break
                if full_all is not None and bool(full_all[i, k]) and s.meta_received and s.assembler.chunk_size == cs0:
                    # fast path: a CRC-valid full data chunk; the state
                    # updates _route_result would make for it
                    s.assembler.store_valid_chunk(int(seq_all[i, k]), by_row[k, 7 : 7 + cs0])
                    s.stats.frames_decoded += 1
                    s.stats.chunks_received = s.assembler.received_count
                    s.scan_pos = est_end
                    s.preamble_pos = -1
                    s.expected_frame_end = -1
                    s.state = RecvState.IDLE
                    s.pred_start = -1
                    last_start = abs_start
                    continue
                result = framing.parse_payload_bytes(by_row[k].tobytes(), min_len=6)
                s.preamble_pos = abs_start
                s.expected_frame_end = est_end
                if decoder._parse_failed(result):
                    s.state = RecvState.COLLECTING_FRAME  # staged retry ladder
                    rerun = True
                    if spec:
                        s.gen += 1
                        s.inflight = 0
                        s.pred_start = -1
                        s.defer_total = -1
                    break
                full = (
                    isinstance(result, framing.DataFrame)
                    and result.crc_valid
                    and len(result.data) == s.assembler.chunk_size
                )
                self._route_result(s, result)
                if not full:
                    rerun = True  # short/other frame: rescan from its true end
                    if spec:
                        s.gen += 1
                        s.inflight = 0
                        s.defer_total = -1  # pred cleared by _reset already
                    break
                last_start = abs_start
            else:
                if spec:
                    # every slot routed as speculated: restore the cursors
                    # over the clears _route_result's _reset performed
                    s.pred_start = saved_pred
                    s.defer_total = saved_defer
                    continue
                # every slot routed a full frame: rerun only once the ring
                # holds the whole NEXT K-round, the precondition of the
                # scan-free predicted round
                s.pred_start = last_start + cadence
                next_round_end = s.pred_start + (k_next() - 1) * cadence + est_len
                if next_round_end <= s.ring.total_written:
                    rerun = True
                else:
                    s.defer_total = next_round_end - 1
        with self.timer.stage("consume_commit"):
            for i in active:
                # round-boundary commit: the assembler lands its buffered
                # rows as one batch; no-op for in-memory assemblers
                self.streams[i].assembler.commit()
        return rerun

    def _fetch_later(self, dev: torch.Tensor) -> tuple:
        """Start the copy of a speculative round's packed result to the
        host: on CUDA into a pinned buffer, on the current stream (so after
        the round), with an event to wait on; on the CPU the round already
        is host memory. Returns (host tensor, event or None)."""
        if dev.device.type != "cuda":
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _drain_pending(self, drain_all: bool = False) -> None:
        """Consume queued speculative rounds, oldest first: down to
        pipeline_depth normally, all of them when ``drain_all`` (end of
        input, or a non-predicted dispatch is about to touch truth state),
        and any whose window nears eviction from the ring."""
        while self._pending and (
            drain_all
            or len(self._pending) > self.pipeline_depth
            or (
                self.device_ingest
                and self.dring.total_written - self._pending[0][-1] > self.dring.capacity - 2 * self._max_frame
            )
        ):
            _dev, host, done, active, bases, lens, est_len, cadence, w, gens, _base = self._pending.popleft()
            with self.timer.stage("pipe_fetch"):
                if done is not None:
                    done.synchronize()
                packed = host.numpy()
            with self.timer.stage("multi_consume"):
                self._consume_multi(
                    active, bases, lens, packed, est_len, cadence, w, predicted=True, spec_gens=gens,
                )

    def _window_decode_all(self) -> bool:
        p = self.mode.profile
        sym = p.symbol_len
        w = self.scan_bucket
        min_need = 4 * sym + 2 * self._half
        lens = np.zeros(self.n, np.int32)
        bases: dict[int, int] = {}
        active = []
        if self.device_ingest:
            total = self.dring.total_written
            cap = self.dring.capacity
            start_rel = np.zeros(self.n, np.int32)
            min_rel = np.zeros(self.n, np.int32)

            def fill(i: int, s: _Stream, w_eff: int) -> None:
                # window base: cover scan_pos..total, sliding left so the
                # slice stays inside the ring; min_pos keeps resume
                # semantics when the base precedes scan_pos. A live cadence
                # prediction anchors the window on the predicted span
                # instead: during pipelined rounds scan_pos (truth) lags the
                # dispatch frontier by up to pipeline_depth K-rounds.
                anchor = s.scan_pos
                if s.pred_start >= 0:
                    anchor = max(anchor, s.pred_start - self._pred_pad)
                eff = max(min(anchor, total - w_eff), total - cap)
                start_rel[i] = eff - (total - cap)
                min_rel[i] = max(s.scan_pos - eff, 0)
                lens[i] = min(total - eff, w_eff)
                bases[i] = eff

            for i, s in enumerate(self.streams):
                if s.state is not RecvState.IDLE:
                    continue
                if s.defer_total >= 0 and total <= s.defer_total:
                    continue  # deferred: waiting for more samples
                s.scan_pos = max(s.scan_pos, total - cap, 0)
                if total - s.scan_pos < min_need:
                    continue
                fill(i, s, w)
                active.append(i)
            if not active:
                return False
            multi = self._multi_params(active, cap)
            if multi:
                n_sym_frame, est_len, cadence, k, w_multi = multi
                for i in active:  # re-slice with the K-frame window
                    fill(i, self.streams[i], w_multi)
                # scan-free round: every active stream predicts its next
                # frame's start and all K frames fit the window
                pred_rel = np.zeros(self.n, np.int32)
                predicted = True
                for i in active:
                    pr = self.streams[i].pred_start - bases[i]
                    if pr < 0 or pr + (k - 1) * cadence + est_len > int(lens[i]):
                        predicted = False
                        break
                    pred_rel[i] = pr
                if self._pending and not predicted:
                    # speculation survives only unbroken predicted rounds:
                    # drain before any scanning dispatch
                    self._drain_pending(drain_all=True)
                    return True
                if predicted and self.pipeline_depth > 0:
                    # speculative dispatch: queue the round with its copy to
                    # the host under way and advance the cursors as if all
                    # K slots will route; consumption validates later
                    with self.timer.stage("pred_dispatch", k * cadence * len(active)):
                        dev = _batch_window_decode_pred_dev(
                            self.dring, np.stack([start_rel, pred_rel, lens]), self.mode,
                            n_sym_frame, k, cadence, w_multi,
                        )
                        host, done = self._fetch_later(dev)
                    self._pending.append((
                        dev, host, done, list(active), dict(bases), lens.copy(), est_len, cadence, w_multi,
                        {i: self.streams[i].gen for i in active}, min(bases[i] for i in active),
                    ))
                    for i in active:
                        s = self.streams[i]
                        s.pred_start += k * cadence
                        s.inflight += k
                        nre = s.pred_start + (k - 1) * cadence + est_len
                        s.defer_total = -1 if nre <= total else nre - 1
                    self._drain_pending()
                    return True
                stage = "pred" if predicted else "multi"
                with self.timer.stage(f"{stage}_dispatch", k * cadence * len(active)):
                    if predicted:
                        dev = _batch_window_decode_pred_dev(
                            self.dring, np.stack([start_rel, pred_rel, lens]), self.mode,
                            n_sym_frame, k, cadence, w_multi,
                        )
                    else:
                        dev = _batch_window_decode_multi_dev(
                            self.dring, np.stack([start_rel, min_rel, lens]), self.mode,
                            n_sym_frame, k, cadence, w_multi,
                        )
                with self.timer.stage(f"{stage}_fetch"):
                    packed = dev.cpu().numpy()
                with self.timer.stage("multi_consume"):
                    return self._consume_multi(
                        active, bases, lens, packed, est_len, cadence, w_multi, predicted=predicted,
                    )
            if self._pending:
                self._drain_pending(drain_all=True)
                return True
            with self.timer.stage("single_dispatch", int(lens.sum())):
                out = _batch_window_decode_dev(
                    self.dring, np.stack([start_rel, min_rel, lens]), self.mode, self._win_max_syms, w,
                )
        else:
            windows = np.zeros((self.n, w), np.float32)
            for i, s in enumerate(self.streams):
                if s.state is not RecvState.IDLE:
                    continue
                total = s.ring.total_written
                if s.defer_total >= 0 and total <= s.defer_total:
                    continue  # deferred: waiting for more samples
                s.scan_pos = max(s.scan_pos, total - s.ring.capacity, 0)
                avail = total - s.scan_pos
                if avail < min_need:
                    continue  # too short to host a frame; staged flush drains tails
                win = s.ring.get_range(s.scan_pos, min(avail, w))
                if win is None:
                    continue
                windows[i, : len(win)] = win
                lens[i] = len(win)
                bases[i] = s.scan_pos
                active.append(i)
            if not active:
                return False
            # host-fed windows stay at scan_bucket width (bigger windows
            # would multiply the per-round upload); K clamps to the frame
            # cadences that width can hold
            multi = self._multi_params(active, w)
            if multi:
                n_sym_frame, est_len, cadence, k, _ = multi
                packed = _batch_window_decode_multi(
                    self._to_device(windows), torch.zeros(self.n, dtype=torch.int32, device=self.device),
                    self._to_device(lens), self.mode, n_sym_frame, k, cadence,
                ).cpu().numpy()
                return self._consume_multi(active, bases, lens, packed, est_len, cadence, w)
            out = _batch_window_decode(self._to_device(windows), self._to_device(lens), self.mode, self._win_max_syms)
        with self.timer.stage("single_fetch"):
            detected, starts, by_rows = _unpack_round(out.cpu().numpy())
        progressed = False
        for i in active:
            s = self.streams[i]
            base = bases[i]
            s.defer_total = -1
            if not detected[i]:
                s.scan_pos = max(s.scan_pos, base + max(int(lens[i]) - 2 * self._half + 1, 1))
                progressed = True
                continue
            abs_start = base + int(starts[i])
            max_payload = (s.assembler.chunk_size or 4096) + 11 if s.meta_received else PRE_META_MAX_PAYLOAD
            if self.fec:
                max_payload = framing.fec_wire_len(max_payload)
            est_len = framing.estimate_frame_samples(max_payload, self.mode)
            est_end = abs_start + est_len
            if est_end > base + int(lens[i]):
                if est_len <= w:
                    # the frame will fit a FUTURE window once est_end samples
                    # exist: wait instead of dropping to the staged machine.
                    # Not progress: nothing changes until samples arrive.
                    s.defer_total = est_end - 1
                    if est_end > s.scan_pos + w:
                        # no window from scan_pos can hold the frame (its
                        # preamble lies in the last est_len samples of a full
                        # window): start the next one just ahead of it. The
                        # JAX package keeps scan_pos and defers for ever.
                        s.scan_pos = abs_start - min(self._pred_pad, w - est_len)
                    continue
                # frame longer than any window: stage it
                s.preamble_pos = abs_start
                s.scan_pos = abs_start + self._half
                s.state = RecvState.PREAMBLE_DETECTED
                progressed = True
                continue
            result = framing.parse_payload_bytes(by_rows[i].tobytes(), min_len=6)
            s.preamble_pos = abs_start
            s.expected_frame_end = est_end
            progressed = True
            if decoder._parse_failed(result):
                # hand the frame to the staged demod and its retry ladder
                s.state = RecvState.COLLECTING_FRAME
                continue
            self._route_result(s, result)
        return progressed

    # ---- staged machine: batched scan ----

    def _scan_all(self) -> bool:
        p = self.mode.profile
        windows = np.zeros((self.n, self.scan_bucket), np.float32)
        lens = np.zeros(self.n, np.int32)
        active = []
        for i, s in enumerate(self.streams):
            if s.state is not RecvState.IDLE:
                continue
            total = s.ring.total_written
            s.scan_pos = max(s.scan_pos, total - s.ring.capacity, 0)
            scan_end = total - 2 * self._half
            if s.scan_pos > scan_end:
                continue
            n_pos = min(scan_end - s.scan_pos + 1, self.scan_bucket - 2 * self._half)
            win_len = n_pos + 2 * self._half - 1
            w = s.ring.get_range(s.scan_pos, win_len)
            if w is None:
                continue
            windows[i, :win_len] = w
            lens[i] = win_len
            active.append((i, n_pos))
        if not active:
            return False
        idx, _ = _batch_scan(self._to_device(windows), self._to_device(lens), p)
        idx = idx.cpu().numpy()
        for i, n_pos in active:
            s = self.streams[i]
            if idx[i] >= 0:
                s.preamble_pos = s.scan_pos + int(idx[i])
                s.scan_pos = s.preamble_pos + self._half
                s.state = RecvState.PREAMBLE_DETECTED
            else:
                s.scan_pos += n_pos
        return True

    # ---- staged machine: batched refine ----

    def _refine_all(self) -> bool:
        p = self.mode.profile
        plen = p.symbol_len
        radius = 3 * p.cp_len
        regions = np.zeros((self.n, self._refine_pad), np.float32)
        coarse_rel = np.zeros(self.n, np.int32)
        lens = np.zeros(self.n, np.int32)
        active: list[tuple[int, int]] = []
        pending: list[tuple[int, int, int]] = []  # (i, lo, avail)
        for i, s in enumerate(self.streams):
            if s.state is not RecvState.PREAMBLE_DETECTED:
                continue
            if s.ring.total_written < s.preamble_pos + plen + radius:
                continue  # wait for samples
            lo = max(s.ring.total_written - s.ring.capacity, s.preamble_pos - radius, 0)
            avail = min(self._region_len, s.ring.available_from(lo))
            pending.append((i, lo, avail))
        if self.device_ingest and pending:
            # one gather for all regions (fixed length; lens masks each
            # stream's true extent)
            glen = self._region_len
            total, cap = self.dring.total_written, self.dring.capacity
            fetch = []
            for i, lo, avail in pending:
                end = min(lo + glen, total)
                if self.dring.rel(lo) < 0 or end <= lo:
                    self.streams[i].state = RecvState.IDLE
                    continue
                fetch.append((i, lo, avail))
            if fetch:
                # a fixed glen window; samples past total_written are stale
                # ring content, masked out by lens
                safe_starts = [min(lo, max(total - glen, total - cap)) for _, lo, _ in fetch]
                got = self.dring.gather_ranges([i for i, _, _ in fetch], safe_starts, glen)
                for k, (i, lo, avail) in enumerate(fetch):
                    off = lo - safe_starts[k]
                    regions[i, :avail] = got[k][off : off + avail]
                    coarse_rel[i] = self.streams[i].preamble_pos - lo
                    lens[i] = avail
                    active.append((i, lo))
        else:
            for i, lo, avail in pending:
                s = self.streams[i]
                region = s.ring.get_range(lo, avail)
                if region is None:
                    s.state = RecvState.IDLE
                    continue
                regions[i, : len(region)] = region
                coarse_rel[i] = s.preamble_pos - lo
                lens[i] = len(region)
                active.append((i, lo))
        if not active:
            return False
        best_rel, metric = _batch_refine(
            self._to_device(regions), self._to_device(coarse_rel), self._to_device(lens), p
        )
        best_rel, metric = best_rel.cpu().numpy(), metric.cpu().numpy()
        for i, lo in active:
            s = self.streams[i]
            if metric[i] < sync.XCORR_THRESHOLD:
                s.state = RecvState.IDLE  # false positive (app.js:879-884)
                continue
            s.preamble_pos = lo + int(best_rel[i])
            max_payload = (s.assembler.chunk_size or 4096) + 11 if s.meta_received else PRE_META_MAX_PAYLOAD
            if self.fec:
                max_payload = framing.fec_wire_len(max_payload)
            s.expected_frame_end = s.preamble_pos + framing.estimate_frame_samples(max_payload, self.mode)
            s.state = RecvState.COLLECTING_FRAME
        return True

    # ---- staged machine: batched demod (kernel B) ----

    def _demod_ready(self) -> bool:
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(self.streams):
            if s.state is not RecvState.COLLECTING_FRAME:
                continue
            if s.ring.total_written < s.expected_frame_end:
                continue
            groups.setdefault(s.expected_frame_end - s.preamble_pos, []).append(i)
        if not groups:
            return False
        sym = self.mode.profile.symbol_len
        for frame_len, members in groups.items():
            n_sym = (frame_len - 3 * sym) // sym
            usable = (3 + n_sym) * sym
            frames = np.zeros((len(members), usable), np.float32)
            ok_members = []
            if self.device_ingest:
                # one gather for the whole group
                fetch: list[tuple[int, int]] = []
                for row, i in enumerate(members):
                    s = self.streams[i]
                    if self.dring.rel(s.preamble_pos) < 0 or s.preamble_pos + usable > self.dring.total_written:
                        s.stats.frame_errors += 1
                        self._reset(s, None)
                        continue
                    fetch.append((row, i))
                if fetch:
                    got = self.dring.gather_ranges(
                        [i for _, i in fetch], [self.streams[i].preamble_pos for _, i in fetch], usable
                    )
                    for k, (row, i) in enumerate(fetch):
                        frames[row] = got[k]
                        ok_members.append((row, i))
            else:
                for row, i in enumerate(members):
                    s = self.streams[i]
                    f = s.ring.get_range(s.preamble_pos, usable)
                    if f is None:
                        s.stats.frame_errors += 1
                        self._reset(s, None)
                        continue
                    frames[row] = f
                    ok_members.append((row, i))
            if not ok_members:
                continue
            # one call per group: kernel B + vote + byte pack on the device,
            # one copy of the byte matrix back
            by_rows = batch_decode_chunk_frames_packed(self._to_device(frames), self.mode, n_sym).cpu().numpy()
            for row, i in ok_members:
                self._route(self.streams[i], by_rows[row].tobytes(), n_sym, frames[row])
        return True

    def _route(self, s: _Stream, by: bytes, n_sym: int, frame: np.ndarray | None = None) -> None:
        result = framing.parse_payload_bytes(by, min_len=6)
        if frame is None or not decoder._parse_failed(result):
            self._route_result(s, result)
            return
        # the retry ladder of decoder.decode_chunk_frame on the frame's samples
        frame_t = self._to_device(frame)
        if decoder._soft_retry_applicable(self.mode):
            # soft repetition combining
            soft = decoder._chunk_soft_core(frame_t, self.mode, n_sym)
            soft_by = bits_to_bytes(soft_combine(soft, self.mode.repetition)).cpu().numpy().tobytes()
            soft_result = framing.parse_payload_bytes(soft_by, min_len=6)
            if not decoder._parse_failed(soft_result):
                result = soft_result
        if isinstance(result, framing.FrameError) and result.error.startswith("FEC decode failed"):
            # errors and erasures
            evm = decoder._chunk_evm_core(frame_t, self.mode, n_sym).cpu().numpy()
            flags = decoder._byte_erasures(evm, self.mode, decoder._fec_region_bytes(by))
            if flags is not None:
                retry = framing.parse_payload_bytes(by, min_len=6, erasures=flags)
                if not isinstance(retry, framing.FrameError):
                    result = retry
        if decoder._parse_failed(result):
            # timing tracking
            tbits = decoder._chunk_tracked_core(frame_t, self.mode, n_sym)
            tresult = decoder._bits_to_parse(tbits, n_sym, self.mode, min_len=6)
            if not decoder._parse_failed(tresult):
                result = tresult
        self._route_result(s, result)

    def _route_result(self, s: _Stream, result: framing.ParseResult) -> None:
        """Post-parse routing: assembler/stats updates + FSM reset. Expects
        s.preamble_pos / s.expected_frame_end to describe the frame."""
        resume_pos = None
        if isinstance(result, framing.FrameError):
            s.stats.frame_errors += 1
            resume_pos = s.preamble_pos + 4 * self.mode.profile.symbol_len
        else:
            s.stats.frames_decoded += 1
            payload_len = None
            if isinstance(result, framing.MetaFrame):
                if result.crc_valid:
                    s.assembler.handle_metadata(result)
                    s.meta_received = True
                    s.stats.total_chunks = result.total_chunks
                    payload_len = 12 + len(result.file_name.encode("utf-8")) + 4
                else:
                    s.stats.frame_errors += 1
            elif isinstance(result, framing.DataFrame):
                s.assembler.handle_data_chunk(result)
                s.stats.crc_errors = s.assembler.crc_errors
                s.stats.chunks_received = s.assembler.received_count
                if result.crc_valid:
                    payload_len = 11 + len(result.data)
            if payload_len is not None:
                if self.fec:
                    payload_len = framing.fec_wire_len(payload_len)
                actual = framing.estimate_frame_samples(payload_len, self.mode)
                resume_pos = min(s.preamble_pos + actual, s.expected_frame_end)
        self._reset(s, resume_pos)

    def _reset(self, s: _Stream, resume_pos: int | None) -> None:
        if resume_pos is not None:
            s.scan_pos = resume_pos
        elif s.expected_frame_end > 0:
            s.scan_pos = s.expected_frame_end
        s.preamble_pos = -1
        s.expected_frame_end = -1
        s.state = RecvState.IDLE
        # any route invalidates a cadence prediction; _consume_multi re-seeds
        # its own predictions after routing a full round
        s.pred_start = -1

    # ---- results ----

    def flush(self) -> None:
        """Decode partially collected frames at end of input, for every
        stream state: a stream parked in PREAMBLE_DETECTED gets one final
        refinement on whatever samples exist, then demodulates from its
        best-known position; frame expectations are truncated to the
        samples available."""
        p = self.mode.profile
        # settle the speculative pipeline first: truth state must be
        # current before the tail logic
        self._drain_pending(drain_all=True)
        if self.window_decode:
            # deferrals wait for samples that will never arrive and
            # predictions point past the write head: clear both every
            # iteration and rerun the turbo machine until quiescent
            for _ in range(8 * max(self.pipeline_depth, 1)):
                for s in self.streams:
                    s.defer_total = -1
                    s.pred_start = -1
                if self._step_all():
                    continue
                if not self._pending:
                    break
                self._drain_pending(drain_all=True)  # may roll back, then retry
        # drain via the staged machine: the turbo path skips windows too
        # short to host a whole frame, so a tail frame can still be
        # undetected in the ring
        for _ in range(8):
            if not (self._scan_all() | self._refine_all() | self._demod_ready()):
                break
        # final refinement attempt with the samples we have
        self._refine_all()
        for s in self.streams:
            if s.state in (RecvState.PREAMBLE_DETECTED, RecvState.COLLECTING_FRAME) and s.preamble_pos >= 0:
                have = s.ring.available_from(s.preamble_pos)
                if have >= 4 * p.symbol_len:
                    end = s.preamble_pos + have
                    if s.expected_frame_end > 0:
                        end = min(end, s.expected_frame_end)
                    s.expected_frame_end = end
                    s.state = RecvState.COLLECTING_FRAME
        self._demod_ready()

    def results(self):
        return [
            {
                "complete": s.assembler.is_complete,
                "data": s.assembler.assemble() if s.assembler.total_chunks else b"",
                "file_name": s.assembler.file_name,
                "missing": s.assembler.missing_chunks(),
                "stats": s.stats,
            }
            for s in self.streams
        ]

    def cleanup(self) -> None:
        for s in self.streams:
            s.assembler.cleanup()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
