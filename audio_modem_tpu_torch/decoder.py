"""Full-signal and frame decoders (counterpart of audio_modem_tpu/decoder.py;
decodeReceivedSignal, modem.js:557-654, and decodeChunkFrame, modem.js:770-803).

The numeric work (preprocess, coarse scan, xcorr refine, CE, demod and the
retry tools) runs on ``device``; only the byte-level parse runs on the host.
A signal is zero-padded to a length bucket as in the JAX package, the demod
covers the bucket's maximum symbol count, and the host keeps the reference's
floor((n_valid - data_start) / symbol_len) symbols (modem.js:368), so both
packages cut the same junk tail.

Every entry point takes a ``device``, ``"cuda"`` unless the caller names the
CPU. A numpy signal is copied there; a tensor must already lie there.
Nothing moves to the CPU on its own, and nothing falls back to it: without a
CUDA device a call that does not pass ``device="cpu"`` raises, and on CUDA
the device core runs kernel A (``decode_fused``) or raises.

While the span recorder is on (``utils.trace``), and over every
``decode_signal`` made while torch.profiler records, a decode records a
``decode`` span with ``decode.*`` spans inside it: the upload, the bucket
pad, each try of kernel A and its launch, each blocking read back to the
host (``decode.sync``, through ``kernels.read_back``), each try's tail launch
(``decode.tail``), each call of the timing tracker (``decode.track``, a
``decode.track.pass`` span a pass inside it), a vote and pack on the host
(``decode.vote_pack``: the tracked rung and the chunk-frame paths), the
parse and each rung of the retry ladder; and the counters ``tries``,
``tail_rows``, ``host_syncs``, ``rungs``, ``tracked`` and ``track_blocks``.
With the recorder off every span is one shared no-op, and the root's and
the reads' attributes are not computed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_modem_tpu_torch import phy, sync
from audio_modem_tpu_torch.configs import FRAME_DATA, FRAME_FEC, FRAME_META, ModemMode
from audio_modem_tpu_torch.framing import (
    FrameError,
    ParseResult,
    num_symbols_for_payload,
    parse_payload_bytes,
)
from audio_modem_tpu_torch.kernels import pinned, read_back, upload
from audio_modem_tpu_torch.kernels.receive import (
    decode_fused,
    decode_tail,
    demodulate_tracked,
    split_tail_row,
    stream_demod,
)
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote, soft_combine
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.utils import trace

PAD_BUCKET = 16384
SYM_BUCKET = 16
TRACK_EARLY_BIAS = 2
TRACK_BLOCK_SYMS = 8


@dataclasses.dataclass
class DecodeInfo:
    """Sync and diagnostic metadata attached to every decode."""

    preamble_idx: int
    coarse_idx: int
    fine_metric: float
    channel_mag: np.ndarray | None = None


def _bucket_len(n: int) -> int:
    return -(-max(n, 2 * PAD_BUCKET) // PAD_BUCKET) * PAD_BUCKET


def _max_symbols(pad_len: int, mode: ModemMode) -> int:
    # Upper bound on demodulatable symbols for this bucket (start can be 0).
    return max((pad_len - 3 * mode.profile.symbol_len) // mode.profile.symbol_len, 1)


def pad_to_bucket(sig: torch.Tensor) -> torch.Tensor:
    """``sig`` zero-padded to its length bucket (``PAD_BUCKET`` steps, two at
    least), in a ``decode.pad`` span."""
    with trace.span("decode.pad"):
        return torch.nn.functional.pad(sig, (0, _bucket_len(sig.shape[0]) - sig.shape[0]))


def _to_bytes(bits: torch.Tensor) -> bytes:
    return read_back("bits", bits_to_bytes(bits)).tobytes()


def _parse(raw: bytes, min_len: int, erasures: np.ndarray | None = None) -> ParseResult:
    with trace.span("decode.parse"):
        return parse_payload_bytes(raw, min_len=min_len, erasures=erasures)


def _rung(name: str):
    """One rung of the retry ladder entered."""
    trace.count("rungs")
    return trace.span(f"decode.rung.{name}")


def _core_dispatch(signal: torch.Tensor, n_valid: int, min_pos: int, mode: ModemMode, max_syms: int) -> dict:
    """One padded signal -> kernel A's output dict at B = 1 (``decode_fused``),
    at every length.

    The JAX package sends every signal its VMEM gate admits to its kernel
    A; Hopper has no such gate, since kernel A grids its stages over row,
    scan and symbol tiles. On the CPU the same call runs kernel A's plain
    version, which is the JAX package's XLA formulation (its
    ``_decode_core``)."""
    with trace.span("decode.kernel_a"):
        dev = signal.device
        nv = torch.tensor([n_valid], dtype=torch.int32, device=dev)
        mp = torch.tensor([min_pos], dtype=torch.int32, device=dev)
        return decode_fused(signal[None], nv, mp, mode, max_syms)


def _tail_read(out: dict, mode: ModemMode) -> tuple:
    """Kernel A's row, voted and packed on the card by ``decode_tail``, read
    in one copy: (coarse, start, fine_metric, |H|, packed bytes)."""
    with trace.span("decode.tail"):
        rows = decode_tail(*(out[k] for k in ("coarse", "start", "fine_metric", "bits", "ch_re", "ch_im")),
                           mode.repetition)
    trace.count("tail_rows")
    return split_tail_row(read_back("row", rows, pinned)[0], mode.profile.num_active_subs)


def _aligned(signal: torch.Tensor, n_valid: int, start: int, mode: ModemMode, n_sym: int):
    """Preprocess, then the CE symbol and n_sym data symbols at ``start``:
    (ch_re, ch_im, symbols [n_sym, sym])."""
    sym = mode.profile.symbol_len
    sig = sync.preprocess(signal[None], torch.tensor([n_valid], device=signal.device))[0]
    ext = torch.nn.functional.pad(sig, (0, (3 + n_sym) * sym))
    ch_re, ch_im = phy.estimate_channel(ext[start + 2 * sym : start + 3 * sym], mode.profile)
    data = ext[start + 3 * sym : start + (3 + n_sym) * sym].reshape(n_sym, sym)
    return ch_re, ch_im, data


def _evm_core(signal: torch.Tensor, n_valid: int, start: int, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Per-symbol EVM of the data region: the confidence signal of the
    erasure-aware FEC retry."""
    ch_re, ch_im, data = _aligned(signal, n_valid, start, mode, n_sym)
    return phy.symbol_evm(data, ch_re, ch_im, mode)


def _xcorr_core(signal: torch.Tensor, n_valid: int, mode: ModemMode):
    """Dense normalized-xcorr preamble search on the preprocessed signal:
    the sync re-acquisition of decode_signal's retry."""
    sig = sync.preprocess(signal[None], torch.tensor([n_valid], device=signal.device))
    idx, best = sync.detect_preamble_xcorr(sig, mode.profile, n_valid)
    return idx[0], best[0]


def _soft_core(signal: torch.Tensor, n_valid: int, start: int, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """BPSK soft metrics of the data region: the input of the soft
    repetition-combining retry."""
    ch_re, ch_im, data = _aligned(signal, n_valid, start, mode, n_sym)
    return phy.demodulate_soft_bpsk(data, ch_re, ch_im, mode)


def _tracked_core(
    signal: torch.Tensor, n_valid: int, start: int, mode: ModemMode, n_sym: int, n_valid_sym: "int | None"
):
    """Timing-tracked demod of the data region (``demodulate_tracked``: the
    tracker's kernel on the card, phy.demodulate_tracked on the CPU), for
    long frames under clock drift. CE window and data timing both start
    TRACK_EARLY_BIAS samples into the CP: the refined start is exact only
    to +-1 sample, and a window that starts late leaks the next symbol's CP
    into the DFT; the constant offset cancels between CE and data.
    ``n_valid_sym`` keeps the symbols past the frame out of the timing
    measurement (None measures every block's symbols, the pad's too). The
    call is one ``decode.track`` span."""
    p = mode.profile
    sym = p.symbol_len
    eb = TRACK_EARLY_BIAS
    with _track_span(n_sym, phy.TRACK_BLOCK):
        sig = sync.preprocess(signal[None], torch.tensor([n_valid], device=signal.device))[0]
        ext = torch.nn.functional.pad(sig, (0, 8192))
        ce0 = min(max(start + 2 * sym - eb, 0), ext.shape[0] - sym)
        ch_re, ch_im = phy.estimate_channel(ext[ce0 : ce0 + sym], p)
        return demodulate_tracked(ext, max(start + 3 * sym - eb, 0), n_sym, ch_re, ch_im, mode, n_valid_sym=n_valid_sym)


def _track_span(n_sym: int, block_syms: int):
    """One call of the timing tracker: the ``tracked`` counter and a
    ``decode.track`` span over it (its ``decode.track.pass`` spans and the
    ``track_blocks`` counter are ``demodulate_tracked``'s)."""
    trace.count("tracked")
    return trace.span("decode.track", n_sym=n_sym, blocks=-(-n_sym // block_syms), passes=len(phy.TRACK_GAINS))


def _header_symbols(by: bytes, mode: ModemMode, n_max: int, fallback: int) -> int:
    """Data symbols of the frame whose untracked bytes are ``by``, as its
    header states them (a chunk frame's or a legacy frame's), at most
    ``n_max``; ``fallback`` where the header is unreadable. Drift barely
    moves the first symbols, so the untracked header holds under any offset
    the tracker follows."""
    wire = _wire_payload_len(by)
    if wire is None and by and len(by) >= 5 + by[0]:  # a legacy frame: [nameLen][name][dataLen:4][data][CRC:4]
        off = 1 + by[0]
        wire = off + 4 + int.from_bytes(by[off : off + 4], "big") + 4
    if wire is None:
        return fallback
    return min(max(num_symbols_for_payload(wire, mode), 1), n_max)


def _soft_retry_applicable(mode: ModemMode) -> bool:
    return mode.repetition > 1 and mode.constellation == "BPSK"


def _parse_failed(result) -> bool:
    return isinstance(result, FrameError) or not getattr(result, "crc_valid", True)


def _byte_erasures(evm: np.ndarray, mode: ModemMode, n_bytes: int) -> np.ndarray | None:
    """Per-symbol EVM -> per-payload-byte erasure flags (or None).

    A symbol is flagged when its EVM stands out against the median of the
    symbols that carry the first ``n_bytes`` decoded bytes (junk-tail symbols
    read ~1.0 and stay out of the statistics); the flag reaches every byte
    the symbol carries, through the repetition code when there is one (a
    voted bit is unreliable when at least half its copies are flagged)."""
    bps_sym = bits_per_symbol(mode)
    n_used_sym = min(len(evm), -(-n_bytes * 8 * mode.repetition // bps_sym))
    if n_used_sym <= 0:
        return None
    evm = np.asarray(evm[:n_used_sym])
    med = float(np.median(evm))
    bad_sym = evm > max(2.0 * med, 0.5)
    if not bad_sym.any() or bad_sym.all():
        return None
    wire_bad = np.repeat(bad_sym, bps_sym)
    rep = mode.repetition
    if rep > 1:
        n_dec = len(wire_bad) // rep
        dec_bad = wire_bad[: n_dec * rep].reshape(n_dec, rep).sum(axis=1) * 2 >= rep
    else:
        dec_bad = wire_bad
    n_fit = min(n_bytes, len(dec_bad) // 8)
    flags = np.zeros(n_bytes, bool)
    flags[:n_fit] = dec_bad[: n_fit * 8].reshape(n_fit, 8).any(axis=1)
    return flags if flags.any() else None


def _is_fec_failure(raw: bytes, result) -> bool:
    """Did an FEC-wrapped payload fail to yield a valid frame? Any failed
    parse of FEC-magic bytes counts, a Reed-Solomon mis-correction that
    fails the inner CRC included: all are worth the errors-and-erasures
    retry."""
    return len(raw) > 0 and raw[0] == FRAME_FEC and _parse_failed(result)


def _fec_region_bytes(by: bytes) -> int:
    """Bytes of the FEC header and coded region in a decoded payload (the
    part whose erasure flags matter; the rest is junk tail)."""
    if len(by) < 5:
        return len(by)
    return min(len(by), 5 + int.from_bytes(by[1:5], "big"))


def decode_raw(
    signal: "np.ndarray | torch.Tensor", mode: ModemMode, track_timing: bool = False, device="cuda"
) -> tuple[bytes | FrameError, DecodeInfo | None]:
    """Full-signal sync + demod -> raw payload bytes (repetition undone,
    packed), before any frame-type parse. A committed coarse peak whose
    xcorr refine stays below threshold is skipped and the scan resumes past
    it, up to four times (the one-shot analog of the streaming receiver's
    resume, app.js:879-884)."""
    p = mode.profile
    sym = p.symbol_len
    sig = upload(signal, device)
    n_valid = sig.shape[0]
    sig_dev = pad_to_bucket(sig)
    max_syms = _max_symbols(sig_dev.shape[0], mode)

    min_pos, coarse, start, fine_metric = 0, -1, -1, -np.inf
    for i in range(4):
        trace.count("tries")
        with trace.span("decode.try", index=i):
            out = _core_dispatch(sig_dev, n_valid, min_pos, mode, max_syms)
            coarse, row_start, row_fine, channel_mag, packed = _tail_read(out, mode)
            if coarse < 0:
                if fine_metric == -np.inf:
                    return FrameError("Preamble not detected"), None
                break
            start, fine_metric = row_start, row_fine
            if fine_metric >= sync.XCORR_THRESHOLD:
                break
            min_pos = coarse + p.fft_size  # skip past the false peak
    if coarse < 0 or fine_metric < sync.XCORR_THRESHOLD:
        return FrameError("Preamble not detected (low correlation)"), None

    info = DecodeInfo(
        preamble_idx=start,
        coarse_idx=coarse,
        fine_metric=fine_metric,
        channel_mag=channel_mag.copy(),
    )
    ce_start = start + 2 * sym
    if ce_start + sym > n_valid:
        return FrameError("Signal too short for CE"), info
    data_start = ce_start + sym
    if data_start >= n_valid:
        return FrameError("No data after CE"), info

    n_sym = (n_valid - data_start) // sym
    # the row's bytes of the frame's n_sym symbols: groups and bytes start at bit 0
    raw = packed[: n_sym * bits_per_symbol(mode) // mode.repetition // 8].tobytes()
    if not (track_timing and n_sym > 0):
        return raw, info
    # the junk past the frame (the sender's trailing silence, the rest of the
    # recording) would steer the timing loop: its measurement stops where the
    # header says the frame ends
    b, _tau = _tracked_core(sig_dev, n_valid, start, mode, n_sym, _header_symbols(raw, mode, n_sym, n_sym))
    with trace.span("decode.vote_pack"):
        if mode.repetition > 1:
            b = majority_vote(b, mode.repetition)
        return _to_bytes(b), info


def decode_signal(
    signal: "np.ndarray | torch.Tensor", mode: ModemMode, track_timing: bool = False, device="cuda"
) -> tuple[ParseResult, DecodeInfo | None]:
    """Decode a full recorded signal (modem.js:557-654).

    Returns (parse result | FrameError, DecodeInfo | None); error strings
    mirror the reference. ``track_timing`` turns on the timing tracker for
    long frames under clock offset (extension). When the Schmidl-Cox pass
    finds nothing or its frame fails, the signal is re-acquired with the
    dense xcorr detector (the reference's loopback fallback,
    modem.js:980-984) and decoded as a chunk frame aligned there, with the
    chunk decoder's retry ladder behind it."""
    with trace.follow_profiler(), trace.span("decode") as root:
        sig = upload(signal, device)
        if trace.enabled():
            feed = "card" if isinstance(signal, torch.Tensor) and signal.device.type == "cuda" else "host"
            root.set(mode=mode.name, feed=feed, samples=sig.shape[0])
        result, info = _decode_signal_once(sig, mode, track_timing)
        if not _parse_failed(result):
            return result, info
        with _rung("xcorr"):
            n_valid = sig.shape[0]
            xi, xm = _xcorr_core(pad_to_bucket(sig), n_valid, mode)
            xstart, xmetric = read_back("xcorr", xi, int), read_back("xcorr_metric", xm, float)
            if (
                xmetric >= sync.XCORR_THRESHOLD
                and xstart >= 0
                and (info is None or abs(xstart - info.preamble_idx) > mode.profile.symbol_len // 2)
            ):
                retry = decode_chunk_frame(sig[xstart:], mode, device=sig.device)
                if not _parse_failed(retry):
                    return retry, DecodeInfo(preamble_idx=xstart, coarse_idx=-1, fine_metric=xmetric)
        return result, info


def _decode_signal_once(
    sig: torch.Tensor, mode: ModemMode, track_timing: bool
) -> tuple[ParseResult, DecodeInfo | None]:
    raw, info = decode_raw(sig, mode, track_timing=track_timing, device=sig.device)
    if isinstance(raw, FrameError):
        return raw, info
    result = _parse(raw, min_len=10)
    sym = mode.profile.symbol_len
    n_valid = sig.shape[0]
    n_sym = (n_valid - (info.preamble_idx + 3 * sym)) // sym
    if _parse_failed(result) and _soft_retry_applicable(mode) and n_sym > 0:
        with _rung("soft"):
            # soft repetition combining: summing each copy's BPSK metric before
            # the sign decision keeps the confidence a hard vote throws away
            soft = _soft_core(pad_to_bucket(sig), n_valid, info.preamble_idx, mode, n_sym)
            soft_raw = _to_bytes(soft_combine(soft, mode.repetition))
            soft_result = _parse(soft_raw, min_len=10)
            if not _parse_failed(soft_result):
                return soft_result, info
            if _is_fec_failure(soft_raw, soft_result):
                raw, result = soft_raw, soft_result  # give FEC the better bits
    if _is_fec_failure(raw, result) and n_sym > 0:
        with _rung("fec_erasures"):
            # errors-and-erasures retry: flag burst-hit bytes from the per-symbol
            # EVM and decode again with known positions (2e + f <= 32)
            evm = read_back("evm", _evm_core(pad_to_bucket(sig), n_valid, info.preamble_idx, mode, n_sym))
            flags = _byte_erasures(evm, mode, _fec_region_bytes(raw))
            if flags is not None:
                retry = _parse(raw, min_len=10, erasures=flags)
                if not _parse_failed(retry):
                    return retry, info
    return result, info


def pad_aligned_frame(
    frame: "np.ndarray | torch.Tensor", mode: ModemMode, device="cuda"
) -> "tuple[torch.Tensor, int, int] | FrameError":
    """Zero-pad a sync-aligned frame to a whole number of SYM_BUCKET-symbol
    buckets: (frame [3*sym + n_bucket*sym], n_sym, n_bucket). Extra symbols
    demodulate to junk that the callers cut (modem.js:368)."""
    sym = mode.profile.symbol_len
    fr = upload(frame, device)
    if 3 * sym > fr.shape[0]:
        return FrameError("Frame too short for CE")
    n_sym = (fr.shape[0] - 3 * sym) // sym
    if n_sym <= 0:
        return FrameError("No data after CE")
    n_bucket = -(-n_sym // SYM_BUCKET) * SYM_BUCKET
    usable = 3 * sym + n_bucket * sym
    keep = min(fr.shape[0], usable)
    return torch.nn.functional.pad(fr[:keep], (0, usable - keep)), n_sym, n_bucket


def decode_chunk_frame(frame: "np.ndarray | torch.Tensor", mode: ModemMode, device="cuda") -> ParseResult:
    """Decode a frame whose sample 0 is the preamble-1 start
    (modem.js:770-803), with the retry ladder: soft combining, FEC erasures,
    timing tracking."""
    padded = pad_aligned_frame(frame, mode, device)
    if isinstance(padded, FrameError):
        return padded
    frame_dev, n_sym, n_bucket = padded
    bps_sym = bits_per_symbol(mode)
    bits = _chunk_core(frame_dev, mode, n_bucket)
    result = _bits_to_parse(bits, n_sym, mode, min_len=6)
    if _parse_failed(result) and _soft_retry_applicable(mode):
        with _rung("soft"):
            soft = _chunk_soft_core(frame_dev, mode, n_bucket)[: n_sym * bps_sym]
            soft_raw = _to_bytes(soft_combine(soft, mode.repetition))
            soft_result = _parse(soft_raw, min_len=6)
            if not _parse_failed(soft_result):
                return soft_result
    if _parse_failed(result):
        b = bits[: n_sym * bps_sym]
        with trace.span("decode.vote_pack"):
            if mode.repetition > 1:
                b = majority_vote(b, mode.repetition)
            raw_by = _to_bytes(b)
        if _is_fec_failure(raw_by, result):
            with _rung("fec_erasures"):
                evm = read_back("evm", _chunk_evm_core(frame_dev, mode, n_bucket)[:n_sym])
                flags = _byte_erasures(evm, mode, _fec_region_bytes(raw_by))
                if flags is not None:
                    retry = _bits_to_parse(bits, n_sym, mode, min_len=6, erasures=flags)
                    if not _parse_failed(retry):
                        return retry
        # timing-tracked retry for within-frame clock drift, last rung. The
        # payload's symbol count, read from the decoded header (drift barely
        # touches the first symbols), bounds the loop's measurement: a bucket
        # tail can reach the next frame's preamble.
        with _rung("tracked"):
            tbits = _chunk_tracked_core(frame_dev, mode, n_bucket, _header_symbols(raw_by, mode, n_bucket, n_sym))
            tresult = _bits_to_parse(tbits, n_sym, mode, min_len=6)
            if not _parse_failed(tresult):
                return tresult
    return result


def _wire_payload_len(by: bytes) -> int | None:
    """Wire payload length read from a decoded frame header, whatever its
    CRC; None when the type or length fields are unreadable."""
    if len(by) < 12:
        return None
    if by[0] == FRAME_DATA:
        return 11 + int.from_bytes(by[5:7], "big")
    if by[0] == FRAME_META:
        return 16 + by[11]
    if by[0] == FRAME_FEC:
        return 5 + int.from_bytes(by[1:5], "big")
    return None


def _frame_channel(frame: torch.Tensor, mode: ModemMode, offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    sym = mode.profile.symbol_len
    return phy.estimate_channel(frame[2 * sym - offset : 3 * sym - offset], mode.profile)


def _chunk_core(frame: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Hard bits of an aligned, unscaled frame: CE, then ``stream_demod`` at
    scale 1 (the kernel on CUDA, ``phy.demodulate`` on the CPU)."""
    sym = mode.profile.symbol_len
    ch_re, ch_im = _frame_channel(frame, mode)
    ones = torch.ones(1, dtype=torch.float32, device=frame.device)
    return stream_demod(frame[None, 3 * sym :], ch_re[None], ch_im[None], ones, mode, n_sym)[0]


def _chunk_soft_core(frame: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """BPSK soft metrics of an aligned frame (soft-combining retry)."""
    sym = mode.profile.symbol_len
    ch_re, ch_im = _frame_channel(frame, mode)
    return phy.demodulate_soft_bpsk(frame[3 * sym :].reshape(n_sym, sym), ch_re, ch_im, mode)


def _chunk_evm_core(frame: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Per-symbol EVM of an aligned frame (erasure-retry confidence)."""
    sym = mode.profile.symbol_len
    ch_re, ch_im = _frame_channel(frame, mode)
    return phy.symbol_evm(frame[3 * sym :].reshape(n_sym, sym), ch_re, ch_im, mode)


def _chunk_tracked_core(frame: torch.Tensor, mode: ModemMode, n_sym: int, n_valid_sym: "int | None" = None) -> torch.Tensor:
    """Timing-tracked demod of an aligned frame, the chunk-path analog of
    ``_tracked_core``, in blocks of TRACK_BLOCK_SYMS symbols so the loop
    acquires within a short chunk frame. ``n_valid_sym`` keeps symbols past
    the frame's payload out of the timing measurement."""
    sym = mode.profile.symbol_len
    eb = TRACK_EARLY_BIAS
    with _track_span(n_sym, TRACK_BLOCK_SYMS):
        ch_re, ch_im = _frame_channel(frame, mode, eb)
        ext = torch.nn.functional.pad(frame, (0, TRACK_BLOCK_SYMS * sym + 8192))
        bits, _tau = demodulate_tracked(
            ext, 3 * sym - eb, n_sym, ch_re, ch_im, mode, block_syms=TRACK_BLOCK_SYMS, n_valid_sym=n_valid_sym
        )
    return bits


def _bits_to_parse(
    bits: torch.Tensor, n_sym: int, mode: ModemMode, min_len: int, erasures: np.ndarray | None = None
) -> ParseResult:
    """Truncate to the valid symbol count, undo repetition, pack, parse."""
    bits = bits[: n_sym * bits_per_symbol(mode)]
    with trace.span("decode.vote_pack"):
        if mode.repetition > 1:
            bits = majority_vote(bits, mode.repetition)
        raw = _to_bytes(bits)
    return _parse(raw, min_len=min_len, erasures=erasures)
