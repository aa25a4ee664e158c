"""Receive kernels and their plain versions (counterpart of
audio_modem_tpu/kernels/receive.py).

``decode_fused`` (kernel A, csrc/receive.cu ``amtpu_decode_fused``) runs
the whole receive: preprocess, strided Schmidl-Cox scan with first-peak
commit, xcorr refine, CE, demod, as six launches gridded over (row tiles,
scan tiles or symbol tiles, streams). ``decode_predicted`` (kernel C,
``amtpu_decode_predicted``) runs a turbo round's cadence-predicted slots:
A's preprocess stages, a chain of refines a stream, one demod launch over
(symbol tiles, slots, streams) whose tiles take the CE from their own row 0
and the DFT as a 512-point real FFT in shared memory, then vote, byte pack
and the round's packed rows. ``decode_chunks_fused``
(kernel B, ``amtpu_decode_chunks_fused``) demodulates frame-aligned chunk
frames as two launches (peak; CE and demod) gridded over (chunks of the
frame or symbol tiles, frames). ``stream_demod`` (``stream_demod_kernel``)
demodulates a data region whose channel and amplitude scale are already
known, gridded over symbol tiles as well as streams;
``decode_chunks_fused_stream`` and ``decode_long_fused`` put a plain
PyTorch prologue in front of it. The single-signal decoder runs kernel A
at B = 1 (``decoder._core_dispatch``), as the JAX package runs its kernel
A on every signal its VMEM gate admits; ``decode_long_fused`` is the JAX
package's route past that gate, kept under its name and on no path of
the port. ``decode_tail`` (``decode_tail_kernel``) follows kernel A in the
single-signal decoder: one launch that votes and packs each row's bits and
gathers its head and |H| into one row the host reads in one copy; kernel C's
pack votes through the same device function. ``stream_scan``
(``stream_scan_kernel``) is the chunked receiver's coarse scan of a window,
one CTA a row, into one row of (coarse, best metric) the host reads in one
copy; ``stream_refine`` (``stream_refine_kernel``) its xcorr refine of one
region, one CTA, into one row of (start, best metric).
``demodulate_tracked`` (``track_kernel``) is the decoder's timing tracker,
one launch a pass of its loop. A, B and the streaming demod end in one
tiled, register-blocked product (``demod_tile``) against
``Tables.rx_demod``, C in the FFT tile (``fft_demod_tile``, with
``Tables.demod_bins`` and ``Tables.fft_twiddle``); all four share the
demod's epilogue. Each wrapper checks its inputs,
allocates outputs and scratch with ``torch.empty`` and launches through
``_build.launch`` on the current stream of its tensors' device; on CPU
tensors it runs the plain version beside it (``*_reference``), built from
sync, phy and ops.

Output contract of ``decode_fused`` and ``decode_long_fused`` (as the JAX
kernels'): start, coarse int32 [B]; coarse_metric, fine_metric float32 [B];
detected bool [B]; bits int8 [B, max_syms * bits_per_symbol]; ch_re, ch_im
float32 [B, n_active]. Bits of symbols past a frame's end are junk that
every consumer truncates.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from audio_modem_tpu_torch import phy, sync
from audio_modem_tpu_torch.configs import ModemMode, OfdmProfile
from audio_modem_tpu_torch.kernels import runs_on_kernel
from audio_modem_tpu_torch.kernels._build import launch, scratch_floats
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol, qam_scale
from audio_modem_tpu_torch.tables import profile_tables
from audio_modem_tpu_torch.utils import trace


def _front_end(
    signals: torch.Tensor, n_valid: torch.Tensor, min_pos: torch.Tensor, mode: ModemMode, max_syms: int
) -> tuple[dict, torch.Tensor]:
    """preprocess, strided scan, xcorr refine, CE at the refined start:
    (the output dict without bits, data region [B, max_syms * sym] from the
    first data symbol's CP)."""
    p = mode.profile
    sym = p.symbol_len
    nv = n_valid.to(torch.int32)
    pre = sync.preprocess(signals, nv)
    coarse, cmetric = sync.detect_preamble(pre, p, nv, min_pos=min_pos.to(torch.int32), stride=sync.COARSE_STRIDE)
    start, fine = sync.refine_xcorr(pre, torch.clamp(coarse, min=0), p, nv)
    ch_re, ch_im = phy.estimate_channel(sync.gather_windows(pre, start + 2 * sym, sym), p)
    out = {
        "start": start,
        "coarse": coarse,
        "coarse_metric": cmetric,
        "fine_metric": fine,
        "detected": (coarse >= 0) & (fine >= sync.XCORR_THRESHOLD),
        "ch_re": ch_re,
        "ch_im": ch_im,
    }
    return out, sync.gather_windows(pre, start + 3 * sym, max_syms * sym)


def decode_fused_reference(
    signals: torch.Tensor, n_valid: torch.Tensor, min_pos: torch.Tensor, mode: ModemMode, max_syms: int
) -> dict:
    """Plain version of ``decode_fused`` and ``decode_long_fused``: the
    batched receive pipeline of parallel/batch.py::_batch_decode_signals_xla
    in the JAX package."""
    out, data = _front_end(signals, n_valid, min_pos, mode, max_syms)
    sym = mode.profile.symbol_len
    out["bits"] = phy.demodulate(data.reshape(-1, max_syms, sym), out["ch_re"], out["ch_im"], mode)
    return out


def decode_chunks_fused_reference(frames: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Plain version of ``decode_chunks_fused``: per-frame peak
    normalization (app.js:918-925), CE at 2*sym, demod of n_sym symbols
    (modem.js:770-803)."""
    p = mode.profile
    sym = p.symbol_len
    frames = frames.to(torch.float32)
    mx = frames.abs().amax(dim=-1, keepdim=True)
    big = mx > 1e-6
    frames = torch.where(big, frames / torch.where(big, mx, 1.0), frames)
    need = (3 + n_sym) * sym
    if frames.shape[1] < need:
        frames = torch.nn.functional.pad(frames, (0, need - frames.shape[1]))
    ch_re, ch_im = phy.estimate_channel(frames[:, 2 * sym : 3 * sym], p)
    data = frames[:, 3 * sym : need].reshape(-1, n_sym, sym)
    return phy.demodulate(data, ch_re, ch_im, mode)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {shape}, got {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}"
        )


@lru_cache(maxsize=None)
def _table_args(mode: ModemMode, device: torch.device) -> tuple:
    """The C entries' table and profile arguments for ``mode`` on ``device``
    (the tables live as long as the process: ``profile_tables`` caches them)."""
    tabs = profile_tables(mode, device)
    p = mode.profile
    name = mode.constellation
    return (
        tabs.rx_active.data_ptr(), tabs.ce_known.data_ptr(), tabs.rx_demod.data_ptr(),
        tabs.data_pos.data_ptr(), tabs.pilot_pos.data_ptr(),
        p.fft_size, p.cp_len, p.num_active_subs, p.num_data_subs, len(p.pilots), tabs.rx_demod.shape[1],
        qam_scale(name) if mode.bps > 2 else 1.0, mode.bps,
    )


def _scan_positions(t: int, profile: OfdmProfile) -> int:
    """Positions of ``sync.scan_metric`` at stride 16 on a T-sample row."""
    half = profile.fft_size // 2
    stride = sync.COARSE_STRIDE
    if half // stride != 16:
        raise ValueError("the kernel's scan window is 16 blocks of 16 samples (fft 512)")
    hs = half // stride
    return min((t - half) // stride - hs + 1, t // stride - 2 * hs + 1)


def decode_fused(
    signals: torch.Tensor, n_valid: torch.Tensor, min_pos: torch.Tensor, mode: ModemMode, max_syms: int
) -> dict:
    """Batched full receive: [B, T] raw windows, [B] valid lengths and
    minimum preamble positions -> the dict of the module docstring. One
    call is one launch of kernel A's pipeline."""
    if not runs_on_kernel(signals, n_valid, min_pos):
        return decode_fused_reference(signals, n_valid, min_pos, mode, max_syms)
    p = mode.profile
    b, t = signals.shape
    _check(signals, "signals", torch.float32, (b, t))
    _check(n_valid, "n_valid", torch.int32, (b,))
    _check(min_pos, "min_pos", torch.int32, (b,))
    if p.symbol_len > 768 or p.cp_len > 256:
        raise ValueError("kernel A's shared refine buffers hold cp <= 256, sym <= 768")
    n_pos = _scan_positions(t, p)
    if n_pos < 1:
        raise ValueError(f"window of {t} samples is too short to scan")
    dev = signals.device
    tabs = profile_tables(mode, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_floats("decode_fused", b, t, n_pos), **f32)
    out = {
        "start": torch.empty(b, **i32),
        "coarse": torch.empty(b, **i32),
        "coarse_metric": torch.empty(b, **f32),
        "fine_metric": torch.empty(b, **f32),
        "detected": torch.empty(b, dtype=torch.bool, device=dev),
        "bits": torch.empty(b, max_syms * bits_per_symbol(mode), dtype=torch.int8, device=dev),
        "ch_re": torch.empty(b, p.num_active_subs, **f32),
        "ch_im": torch.empty(b, p.num_active_subs, **f32),
    }
    launch(
        "decode_fused", dev,
        signals.data_ptr(), n_valid.data_ptr(), min_pos.data_ptr(), b, t,
        tabs.pre1.data_ptr(), tabs.t_energy,
        *_table_args(mode, dev),
        max_syms, n_pos, scratch.data_ptr(),
        *(out[k].data_ptr() for k in ("start", "coarse", "coarse_metric", "fine_metric", "detected")),
        *(out[k].data_ptr() for k in ("bits", "ch_re", "ch_im")),
    )
    return out


TAIL_HEAD = 12  # a tail row's head: coarse, start int32; the fine metric's float32 bits


def tail_row_bytes(n_bits: int, n_active: int, repetition: int) -> int:
    """Bytes of one ``decode_tail`` row: the head, |H| float32 [n_active],
    the n_bits // repetition // 8 voted bytes, zeros to a multiple of 4."""
    return TAIL_HEAD + 4 * n_active + -(-(n_bits // repetition // 8) // 4) * 4


def split_tail_row(row: np.ndarray, n_active: int) -> tuple:
    """One ``decode_tail`` row (uint8 numpy [row_bytes]) -> (coarse, start,
    fine_metric, |H| float32 [n_active], the packed bytes and their zero
    padding), the last two views into the row."""
    coarse, start = (int(v) for v in row[:8].view(np.int32))
    fine = float(row[8:TAIL_HEAD].view(np.float32)[0])
    end = TAIL_HEAD + 4 * n_active
    return coarse, start, fine, row[TAIL_HEAD:end].view(np.float32), row[end:]


def decode_tail_reference(
    coarse: torch.Tensor, start: torch.Tensor, fine_metric: torch.Tensor, bits: torch.Tensor,
    ch_re: torch.Tensor, ch_im: torch.Tensor, repetition: int,
) -> torch.Tensor:
    """Plain version of ``decode_tail``: each row's head, then
    ``phy.channel_magnitude``, then ``majority_vote`` (repetition > 1) and
    ``bits_to_bytes`` of the whole bits row, then zeros."""
    b, n_bits = bits.shape
    n_active = ch_re.shape[1]
    v = bits if repetition == 1 else majority_vote(bits, repetition)
    parts = [
        torch.stack([coarse.to(torch.int32), start.to(torch.int32)], dim=1).view(torch.uint8),
        fine_metric.to(torch.float32)[:, None].view(torch.uint8),
        phy.channel_magnitude(ch_re, ch_im).view(torch.uint8),
        bits_to_bytes(v),
    ]
    row = torch.cat(parts, dim=1)
    pad = tail_row_bytes(n_bits, n_active, repetition) - row.shape[1]
    return torch.nn.functional.pad(row, (0, pad))


def decode_tail(
    coarse: torch.Tensor, start: torch.Tensor, fine_metric: torch.Tensor, bits: torch.Tensor,
    ch_re: torch.Tensor, ch_im: torch.Tensor, repetition: int,
) -> torch.Tensor:
    """The one-shot decoder's tail over kernel A's outputs for B rows
    (coarse, start int32 [B]; fine_metric float32 [B]; bits int8 [B, n_bits];
    ch_re, ch_im float32 [B, n_active]) -> uint8 [B, tail_row_bytes(n_bits,
    n_active, repetition)]: per row the head (``TAIL_HEAD``), |H| and the
    voted, MSB-first packed bytes of the whole bits row (``split_tail_row``
    reads it back). Groups and bytes start at bit 0, so the bytes of a
    frame's first bits are a prefix of the row's. One call is one launch."""
    if not runs_on_kernel(coarse, start, fine_metric, bits, ch_re, ch_im):
        return decode_tail_reference(coarse, start, fine_metric, bits, ch_re, ch_im, repetition)
    b, n_bits = bits.shape
    n_active = ch_re.shape[1]
    _check(coarse, "coarse", torch.int32, (b,))
    _check(start, "start", torch.int32, (b,))
    _check(fine_metric, "fine_metric", torch.float32, (b,))
    _check(bits, "bits", torch.int8, (b, n_bits))
    _check(ch_re, "ch_re", torch.float32, (b, n_active))
    _check(ch_im, "ch_im", torch.float32, (b, n_active))
    if b < 1 or repetition < 1:
        raise ValueError(f"need a row and a repetition of at least 1, got B={b}, repetition={repetition}")
    dev = bits.device
    row_bytes = tail_row_bytes(n_bits, n_active, repetition)
    rows = torch.empty((b, row_bytes), dtype=torch.uint8, device=dev)
    launch(
        "decode_tail", dev,
        coarse.data_ptr(), start.data_ptr(), fine_metric.data_ptr(), bits.data_ptr(), ch_re.data_ptr(),
        ch_im.data_ptr(), b, n_bits, n_active, repetition, row_bytes, rows.data_ptr(),
    )
    return rows


STREAM_SCAN_MAX = 8192  # samples a row of ``stream_scan`` may have (csrc/receive.cu kStreamScanMax)


def stream_scan_reference(windows: torch.Tensor, n_valid: int, profile: OfdmProfile, min_energy: float) -> torch.Tensor:
    """Plain version of ``stream_scan``: ``sync.detect_preamble`` at
    ``sync.COARSE_STRIDE``, its two outputs packed into one int32 row each."""
    coarse, best = sync.detect_preamble(windows, profile, n_valid, min_energy=min_energy, stride=sync.COARSE_STRIDE)
    return torch.stack([coarse, best.view(torch.int32)], dim=1)


def stream_scan(
    windows: torch.Tensor, n_valid: int, profile: OfdmProfile, min_energy: float, out: torch.Tensor
) -> torch.Tensor:
    """The chunked receiver's coarse scan: B rows [B, W] of raw samples (W at
    most ``STREAM_SCAN_MAX``), each valid up to ``n_valid`` -> ``out``,
    int32 [B, 2] on the windows' device: per row the coarse index of the
    strided Schmidl-Cox scan with first-peak commit (-1 when the best metric
    is <= 0.5) and the best metric's float32 bits, bit for bit
    ``sync.detect_preamble(..., min_energy=min_energy,
    stride=sync.COARSE_STRIDE)``. Samples at or past ``n_valid`` read as 0,
    which changes no result of the plain version: no valid position reaches
    them. The caller owns ``out``, so one that scans window after window
    allocates nothing. One call is one launch."""
    if not runs_on_kernel(windows, out):
        return out.copy_(stream_scan_reference(windows, n_valid, profile, min_energy))
    if windows.dim() != 2:
        raise ValueError(f"windows: need [B, W], got {tuple(windows.shape)}")
    b, w = windows.shape
    _check(windows, "windows", torch.float32, (b, w))
    _check(out, "out", torch.int32, (b, 2))
    n_pos = _scan_positions(w, profile)
    if b < 1 or w > STREAM_SCAN_MAX or n_pos < 1:
        raise ValueError(f"need 1 or more rows of {STREAM_SCAN_MAX} samples at most that hold a scan position, "
                         f"got [{b}, {w}]")
    launch(
        "stream_scan", windows.device,
        windows.data_ptr(), int(n_valid), b, w, float(min_energy), profile.fft_size // 2, n_pos, out.data_ptr(),
    )
    return out


def stream_refine_reference(window: torch.Tensor, coarse_rel: int, n_valid: int, profile: OfdmProfile) -> torch.Tensor:
    """Plain version of ``stream_refine``: ``sync.refine_xcorr`` of the
    window zero-padded past ``n_valid``, its two outputs packed into one
    int32 row."""
    dev = window.device
    x = torch.cat([window[:n_valid], window.new_zeros(window.shape[0] - n_valid)])
    start, best = sync.refine_xcorr(
        x[None], torch.tensor([coarse_rel], device=dev), profile, torch.tensor([n_valid], device=dev))
    return torch.stack([start[0], best[0].view(torch.int32)])


def stream_refine(window: torch.Tensor, coarse_rel: int, n_valid: int, profile: OfdmProfile) -> torch.Tensor:
    """The chunked receiver's xcorr refine: one window [W] of raw samples,
    valid up to ``n_valid``, around ``0 <= coarse_rel < W`` -> a fresh row,
    int32 [2] on the window's device: the refined start relative to the
    window and the best metric's float32 bits, as
    ``sync.refine_xcorr`` at one region gives them (ties take the first
    offset; the start is ``coarse_rel`` and the metric -inf where no offset
    is finite). Samples at or past ``n_valid`` read as 0, so what lies past
    them changes no result. The kernel sums each offset as 8 blocked
    partial chains, so its metric rounds apart from the plain matmul's at
    the 1e-7 level. One call is one launch and allocates only its row."""
    if not runs_on_kernel(window):
        return stream_refine_reference(window, coarse_rel, n_valid, profile)
    if window.dim() != 1:
        raise ValueError(f"window: need [W], got {tuple(window.shape)}")
    w = window.shape[0]
    _check(window, "window", torch.float32, (w,))
    if not (0 <= coarse_rel < w and 0 <= n_valid <= w):
        raise ValueError(f"need 0 <= coarse_rel < W and 0 <= n_valid <= W, got {coarse_rel}, {n_valid} of {w}")
    if profile.symbol_len > 768 or profile.cp_len > 256 or profile.symbol_len % 32:
        raise ValueError("the kernel's shared region holds cp <= 256 and sym <= 768, a multiple of 32")
    dev = window.device
    tabs = profile_tables(profile, dev)
    out = torch.empty(2, dtype=torch.int32, device=dev)
    launch(
        "stream_refine", dev,
        window.data_ptr(), w, int(n_valid), int(coarse_rel), tabs.pre1.data_ptr(), tabs.t_energy,
        profile.symbol_len, profile.cp_len, out.data_ptr(),
    )
    return out


TRACK_MAX_BLOCK = 64  # symbols a block of ``demodulate_tracked`` may have on the card (csrc/receive.cu kTrackRows)
_ALL_SYMBOLS = 2**31 - 1  # n_valid_sym of a call that measures every symbol


def _check_tracked(sig_ext: torch.Tensor, data_start: int, n_sym: int, ch_re: torch.Tensor, ch_im: torch.Tensor,
                   profile: OfdmProfile, block_syms: int) -> None:
    """Raise where the tracker's kernel does not take ``demodulate_tracked``'s
    arguments."""
    if sig_ext.dim() != 1:
        raise ValueError(f"sig_ext: need [n], got {tuple(sig_ext.shape)}")
    n = sig_ext.shape[0]
    _check(sig_ext, "sig_ext", torch.float32, (n,))
    _check(ch_re, "ch_re", torch.float32, (profile.num_active_subs,))
    _check(ch_im, "ch_im", torch.float32, (profile.num_active_subs,))
    if not 1 <= block_syms <= TRACK_MAX_BLOCK:
        raise ValueError(f"block_syms: the kernel takes 1 to {TRACK_MAX_BLOCK} symbols a block, got {block_syms}")
    if n_sym < 1 or data_start < 0 or not profile.fft_size <= n < 2**31:
        raise ValueError(f"need a symbol, data_start >= 0 and {profile.fft_size} <= n < 2**31, got n_sym={n_sym}, "
                         f"data_start={data_start}, n={n}")


def demodulate_tracked(
    sig_ext: torch.Tensor,
    data_start: int,
    n_sym: int,
    ch_re: torch.Tensor,
    ch_im: torch.Tensor,
    mode: ModemMode,
    block_syms: int = phy.TRACK_BLOCK,
    n_valid_sym: "int | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The timing-tracked demod: ``phy.demodulate_tracked``'s arguments and
    result (bits int8 [n_sym * bits_per_symbol], the final tau as a 0-dim
    float32), its plain version for CPU tensors. On the card the 1-D float32
    signal ``sig_ext`` and the active-bin channel (``ch_re``, ``ch_im``
    float32 [n_active]) go to ``track_kernel``: one launch a pass of the
    loop (``phy.TRACK_GAINS``), the loop's state kept on the card between
    them, so nothing is read back; blocks of 1 to ``TRACK_MAX_BLOCK``
    symbols. Each pass is a ``decode.track.pass`` span (attr ``index``) and
    counts its blocks in ``track_blocks``, as in the plain version; while the
    span recorder is on, each pass waits for the card before its span
    closes, so the spans cover the tracker's device work. The FFT
    rounds apart from the plain matmul at the 1e-7 level of the spectrum, so
    tau may differ from the plain version's by a few float32 ulps."""
    if not runs_on_kernel(sig_ext, ch_re, ch_im):
        return phy.demodulate_tracked(sig_ext, data_start, n_sym, ch_re, ch_im, mode, block_syms, n_valid_sym)
    _check_tracked(sig_ext, data_start, n_sym, ch_re, ch_im, mode.profile, block_syms)
    dev = sig_ext.device
    tabs = profile_tables(mode, dev)
    n_blocks = -(-n_sym // block_syms)
    state = torch.empty(2 + 2 * n_blocks, dtype=torch.float32, device=dev)
    bits = torch.empty(n_sym * bits_per_symbol(mode), dtype=torch.int8, device=dev)
    nv = _ALL_SYMBOLS if n_valid_sym is None else min(int(n_valid_sym), _ALL_SYMBOLS)
    for index, (g1, g2) in enumerate(phy.TRACK_GAINS):
        with trace.span("decode.track.pass", index=index):
            launch(
                "demodulate_tracked", dev,
                sig_ext.data_ptr(), sig_ext.shape[0], int(data_start), n_sym, block_syms, nv,
                ch_re.data_ptr(), ch_im.data_ptr(), tabs.demod_bins.data_ptr(), tabs.fft_twiddle.data_ptr(),
                *_table_args(mode, dev), index, g1, g2, state.data_ptr(), bits.data_ptr(),
            )
            if trace.enabled():  # the span ends once the pass has run on the card, not once it is queued
                torch.cuda.current_stream(dev).synchronize()
        trace.count("track_blocks", n_blocks)
    return bits, state[1]


def decode_chunks_fused(frames: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Frame-aligned decode: [B, >= (3 + n_sym) * sym] frames starting at
    their preamble -> hard bits int8 [B, n_sym * bits_per_symbol]. One call
    is one launch of kernel B's pipeline (peak; CE and demod)."""
    if not runs_on_kernel(frames):
        return decode_chunks_fused_reference(frames, mode, n_sym)
    b, t = frames.shape
    _check(frames, "frames", torch.float32, (b, t))
    dev = frames.device
    if n_sym < 1 or b < 1 or t < 1:
        raise ValueError(f"need at least one frame, one sample and one symbol, got B={b}, T={t}, n_sym={n_sym}")
    bits = torch.empty(b, n_sym * bits_per_symbol(mode), dtype=torch.int8, device=dev)
    scratch = torch.empty(scratch_floats("decode_chunks_fused", b), dtype=torch.float32, device=dev)
    launch(
        "decode_chunks_fused", dev,
        frames.data_ptr(), b, t, *_table_args(mode, dev), n_sym, scratch.data_ptr(), bits.data_ptr(),
    )
    return bits


def preprocess_extend(signals: torch.Tensor, n_valid: torch.Tensor, mode: ModemMode, max_syms: int) -> torch.Tensor:
    """preprocess + zero-extension by (3 + max_syms) symbols, done once per
    round for all predicted slots."""
    sig = sync.preprocess(signals, n_valid)
    return torch.nn.functional.pad(sig, (0, (3 + max_syms) * mode.profile.symbol_len))


def batch_decode_predicted(
    ext: torch.Tensor, coarse: torch.Tensor, n_valid: torch.Tensor, mode: ModemMode, max_syms: int
) -> dict:
    """Refine + CE + demod at predicted coarse positions [B] over a
    ``preprocess_extend``'ed batch: no detection scan. The sender's exact
    cadence puts frame k+1 at start_k + cadence up to clock drift, well
    inside the refine radius; detection rests on the xcorr metric alone."""
    p = mode.profile
    sym = p.symbol_len
    start, fine = sync.refine_xcorr(ext, coarse, p, n_valid)
    ch_re, ch_im = phy.estimate_channel(sync.gather_windows(ext, start + 2 * sym, sym), p)
    data = sync.gather_windows(ext, start + 3 * sym, max_syms * sym).reshape(-1, max_syms, sym)
    return {
        "start": start,
        "fine_metric": fine,
        "detected": fine >= sync.XCORR_THRESHOLD,
        "bits": phy.demodulate(data, ch_re, ch_im, mode),
    }


def pack_round(detected: torch.Tensor, start: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """One round's results as ONE uint8 matrix [n, 5 + n_bytes]: col 0 the
    detected flag, cols 1-4 the start (big-endian), then the decoded bytes,
    so a round needs a single device-to-host copy."""
    s = start.to(torch.int32)
    head = torch.stack(
        [detected.to(torch.uint8)] + [((s >> sh) & 0xFF).to(torch.uint8) for sh in (24, 16, 8, 0)],
        dim=1,
    )
    return torch.cat([head, by], dim=1)


def vote_pack(detected: torch.Tensor, start: torch.Tensor, bits: torch.Tensor, mode: ModemMode) -> torch.Tensor:
    """Repetition vote, byte pack and ``pack_round`` of one slot: the plain
    version of kernel C's pack."""
    if mode.repetition > 1:
        bits = majority_vote(bits, mode.repetition)
    return pack_round(detected, start, bits_to_bytes(bits))


def decode_predicted_reference(
    windows: torch.Tensor,
    n_valid: torch.Tensor,
    start0: torch.Tensor,
    ok0: torch.Tensor,
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    bits0: torch.Tensor | None = None,
) -> dict:
    """Plain version of ``decode_predicted``: the turbo round's loop of
    plain predicted slots (the JAX package's lax.scan of
    _predicted_signal_decode), one ``batch_decode_predicted`` a slot over
    the ``preprocess_extend``'ed windows."""
    w = windows.shape[1]
    slots = [] if bits0 is None else [vote_pack(ok0, start0, bits0, mode)]
    prev_start, prev_ok = start0.to(torch.int32), ok0
    starts, fines, oks = [], [], []
    n_pred = k_frames - len(slots)
    if n_pred:
        ext = preprocess_extend(windows, n_valid, mode, n_sym_frame)
        for _ in range(n_pred):
            coarse = torch.clamp(prev_start + cadence, 0, w - 1).to(torch.int32)
            out = batch_decode_predicted(ext, coarse, n_valid, mode, n_sym_frame)
            prev_ok = out["detected"] & prev_ok
            prev_start = out["start"].to(torch.int32)
            slots.append(vote_pack(prev_ok, prev_start, out["bits"], mode))
            starts.append(prev_start)
            fines.append(out["fine_metric"])
            oks.append(prev_ok)
    n = windows.shape[0]

    def cols(parts, dtype):
        return torch.stack(parts, dim=1) if parts else torch.empty((n, 0), dtype=dtype, device=windows.device)

    return {"packed": torch.stack(slots, dim=1), "start": cols(starts, torch.int32),
            "fine_metric": cols(fines, torch.float32), "detected": cols(oks, torch.bool)}


def decode_predicted(
    windows: torch.Tensor,
    n_valid: torch.Tensor,
    start0: torch.Tensor,
    ok0: torch.Tensor,
    mode: ModemMode,
    n_sym_frame: int,
    k_frames: int,
    cadence: int,
    bits0: torch.Tensor | None = None,
) -> dict:
    """The cadence-predicted slots of a turbo round over [n, w] raw windows
    with [n] valid lengths. The chain starts from ``start0`` int32 [n] and
    ``ok0`` bool [n]: slot 0's start and detected flag when kernel A decoded
    it (``bits0``, its bits int8 [n, n_sym_frame * bits_per_symbol]), else
    the predicted slot 0's start minus the cadence and all True. Each slot
    refines around the previous slot's start + cadence (clamped into the
    window), counts as detected if its fine metric reaches 0.1 and every
    earlier slot was detected, and is demodulated at its start.

    Returns "packed" uint8 [n, k_frames, 5 + n_bytes] (each slot's
    cumulative flag, start big-endian, voted and packed bytes; slot 0 from
    ``bits0`` when given), and the predicted slots' "start" int32,
    "fine_metric" float32 and cumulative "detected" bool, each [n, n_pred]
    (n_pred = k_frames, or k_frames - 1 with ``bits0``). One call is one
    launch of kernel C's pipeline."""
    given = [windows, n_valid, start0, ok0] + ([] if bits0 is None else [bits0])
    if not runs_on_kernel(*given):
        return decode_predicted_reference(windows, n_valid, start0, ok0, mode, n_sym_frame, k_frames, cadence, bits0)
    p = mode.profile
    n, w = windows.shape
    slot_bits = n_sym_frame * bits_per_symbol(mode)
    n_pred = k_frames - (bits0 is not None)
    _check(windows, "windows", torch.float32, (n, w))
    _check(n_valid, "n_valid", torch.int32, (n,))
    _check(start0, "start0", torch.int32, (n,))
    _check(ok0, "ok0", torch.bool, (n,))
    if bits0 is not None:
        _check(bits0, "bits0", torch.int8, (n, slot_bits))
    if p.symbol_len > 768 or p.cp_len > 256:
        raise ValueError("kernel C's shared refine buffers hold cp <= 256, sym <= 768")
    if n < 1 or n_sym_frame < 1 or n_pred < 0 or k_frames < 1:
        raise ValueError(f"need a stream, a symbol and a slot, got n={n}, n_sym_frame={n_sym_frame}, "
                         f"k_frames={k_frames}")
    n_bytes = slot_bits // mode.repetition // 8
    dev = windows.device
    tabs = profile_tables(mode, dev)
    scratch = torch.empty(scratch_floats("decode_predicted", n, w, n_pred, slot_bits), dtype=torch.float32, device=dev)
    out = {
        "packed": torch.empty((n, k_frames, 5 + n_bytes), dtype=torch.uint8, device=dev),
        "start": torch.empty((n, n_pred), dtype=torch.int32, device=dev),
        "fine_metric": torch.empty((n, n_pred), dtype=torch.float32, device=dev),
        "detected": torch.empty((n, n_pred), dtype=torch.bool, device=dev),
    }
    launch(
        "decode_predicted", dev,
        windows.data_ptr(), n_valid.data_ptr(), n, w, start0.data_ptr(), ok0.data_ptr(),
        None if bits0 is None else bits0.data_ptr(),
        tabs.pre1.data_ptr(), tabs.t_energy, tabs.demod_bins.data_ptr(), tabs.fft_twiddle.data_ptr(),
        *_table_args(mode, dev), n_sym_frame, n_pred, k_frames, cadence, mode.repetition, scratch.data_ptr(),
        *(out[k].data_ptr() for k in ("start", "fine_metric", "detected", "packed")),
    )
    return out


def stream_demod_reference(
    data: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, scale: torch.Tensor, mode: ModemMode, n_sym: int
) -> torch.Tensor:
    """Plain version of ``stream_demod``: scale, cut n_sym symbols (zeros
    past the row's end), ``phy.demodulate``."""
    sym = mode.profile.symbol_len
    need = n_sym * sym
    x = data.to(torch.float32)[:, :need]
    if x.shape[1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
    x = x * scale.to(torch.float32)[:, None]
    return phy.demodulate(x.reshape(-1, n_sym, sym), ch_re, ch_im, mode)


def stream_demod(
    data: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, scale: torch.Tensor, mode: ModemMode, n_sym: int
) -> torch.Tensor:
    """Demod of a data region with a known channel: [B, L] rows that start at
    the first data symbol's CP (any row stride, unit sample stride), channel
    (re, im) [B, n_active], per-row amplitude scale [B] -> hard bits int8
    [B, n_sym * bits_per_symbol]. Samples past L read as 0. Counterpart of
    the JAX package's _stream_demod_words, _stream_demod_words_pair and
    _words_to_bits, without their sectioned and word layouts."""
    if not runs_on_kernel(data, ch_re, ch_im, scale):
        return stream_demod_reference(data, ch_re, ch_im, scale, mode, n_sym)
    p = mode.profile
    if data.dim() != 2 or data.dtype != torch.float32 or data.stride(1) != 1:
        raise ValueError(f"data: need float32 [B, L] with unit sample stride, got {data.dtype} "
                         f"{tuple(data.shape)} strides {data.stride()}")
    b, length = data.shape
    _check(ch_re, "ch_re", torch.float32, (b, p.num_active_subs))
    _check(ch_im, "ch_im", torch.float32, (b, p.num_active_subs))
    _check(scale, "scale", torch.float32, (b,))
    if n_sym < 1 or b < 1:
        raise ValueError(f"need at least one stream and one symbol, got B={b}, n_sym={n_sym}")
    dev = data.device
    bits = torch.empty(b, n_sym * bits_per_symbol(mode), dtype=torch.int8, device=dev)
    launch(
        "stream_demod", dev,
        data.data_ptr(), b, data.stride(0), length, ch_re.data_ptr(), ch_im.data_ptr(), scale.data_ptr(),
        *_table_args(mode, dev), n_sym, bits.data_ptr(),
    )
    return bits


def decode_chunks_fused_stream(frames: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Frame-aligned decode through the streaming demod: [B, T] frames
    starting at their preamble -> hard bits int8 [B, n_sym * bits_per_symbol].
    Plain prologue: per-frame peak scale 1/max|x| (app.js:918-925), CE of
    the scaled CE body; then ``stream_demod``. Same contract as
    ``decode_chunks_fused``; its plain version is
    ``decode_chunks_fused_reference``, which divides by the peak where this
    multiplies by its reciprocal (the JAX streaming path's formulation)."""
    p = mode.profile
    sym = p.symbol_len
    frames = frames.to(torch.float32)
    if frames.shape[1] < 3 * sym:
        frames = torch.nn.functional.pad(frames, (0, 3 * sym - frames.shape[1]))
    mx = frames.abs().amax(dim=-1)
    big = mx > 1e-6
    scale = torch.where(big, torch.reciprocal(torch.where(big, mx, 1.0)), 1.0)
    ch_re, ch_im = phy.estimate_channel(frames[:, 2 * sym : 3 * sym] * scale[:, None], p)
    return stream_demod(frames[:, 3 * sym :], ch_re, ch_im, scale, mode, n_sym)


def decode_long_fused(
    signals: torch.Tensor, n_valid: torch.Tensor, min_pos: torch.Tensor, mode: ModemMode, max_syms: int
) -> dict:
    """Full receive with the demod gridded over symbols: the plain front
    end (preprocess, strided scan, xcorr refine, re-align, CE; the JAX
    package runs it in XLA too), then ``stream_demod`` at scale 1. Same
    output dict as ``decode_fused``; its plain version is
    ``decode_fused_reference``. The JAX package's decoder takes this route
    only for a signal past its kernel A's VMEM gate; the port's decoder
    runs kernel A at every length, so no path of the port calls this."""
    out, data = _front_end(signals, n_valid, min_pos, mode, max_syms)
    ones = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
    out["bits"] = stream_demod(data, out["ch_re"], out["ch_im"], ones, mode, max_syms)
    return out
