"""The benchmark's plain reference of the timing-tracked demod: the one-shot
decoder's demod of a long frame under sample-clock offset, in float64.

The published description (the repository's ``phy.demodulate_tracked``
docstring and its clock-offset tests): the reference modem corrects only
the pilots' common phase a symbol (modem.js:397-405), so under a clock
offset its windows walk off the cyclic prefix. The tracker runs a
second-order timing loop over blocks of ``BLOCK_SYMS`` symbols:

* each symbol's window starts at its predicted offset ``tau + rate * j``
  (``j`` the symbol's place in its block), rounded to a sample, half to
  even; the rest, a fraction of a sample, is taken out in frequency: a
  timing error ``d`` turns bin ``k`` by ``2 pi k d / N``;
* the block's timing error is read from the phase steps between adjacent
  equalized pilots: a symbol's error is the sum of the steps' angles over
  the sum of their ``2 pi dk / N``, over the steps whose two pilots both
  have ``|P|^2 > 1e-12``; the block's is the mean over the symbols that
  have one such step, clamped to +-8 samples;
* the loop: ``rate -= g2 * err / B``, ``tau += rate * B - g1 * err`` (the
  old rate), with ``g1`` 0.5 and ``g2`` 0.25;
* three passes over the frame: closed from ``tau = rate = 0`` (acquires a
  rate); frozen from the acquired rate (``g1 = g2 = 0``: each block's
  error, weighted by its count of measured symbols); closed again from the
  weighted least-squares line through the frozen pass's errors at the
  blocks' centres (``tau = -intercept``, ``rate = acquired - slope``),
  which gives the bits and the final ``tau``.

The channel comes from the CE symbol ``EARLY_BIAS`` samples into its
cyclic prefix, and the data windows start as early: the refined start is
exact to +-1 sample, and a window that starts late takes in the next
symbol; the constant offset cancels between the CE and the data. The bits
are the reference modem's: ZF equalization, the pilots' common phase
(the mean of Im/Re over pilots with |Re| > 1e-6) and the nearest point.

Departures, each to compare with the program on its own inputs: every
symbol of the last block is demodulated and measured, also those past the
frame's last symbol (the junk before the recording's end, and zeros past
it), as the program does; and a row is given as the program's input is,
the raw recording with its length, before DC removal and normalization.

``Precision`` (``oracle``) says how the samples, the channel and the
spectra are stored: ``oracle.CONTROL`` is the bfloat16 control. Plain
``torch``; imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import oracle
from benchmark.reference.oracle import F64, REFERENCE, Precision
from benchmark.reference.profiles import CONSTELLATIONS, MODES, Mode

BLOCK_SYMS = 64
EARLY_BIAS = 2
GAINS = (0.5, 0.25)
MAX_STEP = 8.0


def _spectrum(bodies: torch.Tensor, bins: torch.Tensor, prec: Precision) -> torch.Tensor:
    """DFT of windows [..., N] at ``bins``, stored as a product."""
    return prec.qp(torch.fft.fft(bodies)[..., bins])


def _equalize(y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One-tap ZF, passing the bin through where |H|^2 <= 1e-10."""
    mag = h.real ** 2 + h.imag ** 2
    ok = mag > 1e-10
    return torch.where(ok, y * h.conj() / torch.where(ok, mag, 1.0), y)


def _common_phase(pilots: torch.Tensor) -> torch.Tensor:
    usable = pilots.real.abs() > 1e-6
    ratio = torch.where(usable, pilots.imag / torch.where(usable, pilots.real, 1.0), 0.0)
    n = usable.sum(-1)
    return torch.where(n > 0, ratio.sum(-1) / n.clamp(min=1), 0.0)


def _demap(points: torch.Tensor, mode: Mode) -> torch.Tensor:
    """Nearest constellation point's bits, MSB first: int64 [..., n * bps]."""
    pts = torch.as_tensor(CONSTELLATIONS[mode.constellation], device=points.device)
    idx = ((points.real[..., None] - pts[:, 0]) ** 2 + (points.imag[..., None] - pts[:, 1]) ** 2).argmin(-1)
    shifts = torch.arange(mode.bps - 1, -1, -1, device=points.device)
    return ((idx[..., None] >> shifts) & 1).flatten(-2)


def demodulate(x: torch.Tensor, n_valid: torch.Tensor, start: torch.Tensor, n_sym: torch.Tensor,
               mode_name: str, prec: Precision = REFERENCE,
               n_measured: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows ``x`` [R, T] (recordings, zeros past each ``n_valid``), each
    row's refined frame start and data symbol count -> (bits int64
    [R, max n_sym * bits_per_symbol], the bits past a row's own count
    zero; final tau float64 [R], samples). ``n_measured`` (a row's count,
    or -1 for all) leaves the symbols from it on out of the timing
    measurement: a frame's own symbols, where its header says where it
    ends."""
    mode = MODES[mode_name]
    p = mode.profile
    dev = x.device
    r = x.shape[0]
    sym, n, cp, b_syms = p.symbol_len, p.fft_size, p.cp_len, BLOCK_SYMS
    rows = torch.arange(r, device=dev)
    start, n_sym = start.to(torch.int64).to(dev), n_sym.to(torch.int64).to(dev)
    sig = oracle.preprocess(x, n_valid.to(dev), prec)

    ce = oracle.gather(sig, rows, (start + 2 * sym - EARLY_BIAS).clamp(min=0), sym)[:, cp : cp + n]
    active = torch.arange(p.sub_start, p.sub_end + 1, device=dev)
    h = prec.qp(torch.fft.fft(ce)[:, active] * oracle.ce_known(p, dev))
    is_pilot = torch.as_tensor(np.isin(np.arange(p.sub_start, p.sub_end + 1), p.pilots), device=dev)
    kd, kp = active[~is_pilot], active[is_pilot]
    hd, hp = h[:, None, ~is_pilot], h[:, None, is_pilot]
    dk = (kp[1:] - kp[:-1]).to(F64)
    data_start = (start + 3 * sym - EARLY_BIAS).clamp(min=0)
    n_blocks = -(-n_sym // b_syms)
    total = int(n_blocks.max())
    j = torch.arange(b_syms, device=dev)
    limit = (torch.full((r,), -1, dtype=torch.int64) if n_measured is None else n_measured.to(torch.int64)).to(dev)
    limit = torch.where(limit < 0, torch.iinfo(torch.int64).max, limit)

    def step(tau, rate, b, g1, g2):
        off = tau[:, None] + rate[:, None] * j.to(F64)  # [R, B]
        shift = torch.round(off)
        frac = off - shift
        first = data_start[:, None] + (b * b_syms + j) * sym + cp + shift.to(torch.int64)
        bodies = oracle.gather(sig, rows.repeat_interleave(b_syms), first.reshape(-1), n).reshape(r, b_syms, n)
        yd = _spectrum(bodies, kd, prec) * torch.exp(1j * (2 * math.pi / n) * frac[..., None] * kd)
        yp = _spectrum(bodies, kp, prec) * torch.exp(1j * (2 * math.pi / n) * frac[..., None] * kp)
        d, pl = _equalize(yd, hd), _equalize(yp, hp)
        ok = ((pl[..., 1:].abs() ** 2 > 1e-12) & (pl[..., :-1].abs() ** 2 > 1e-12)
              & ((b * b_syms + j)[None, :] < limit[:, None])[..., None])
        ang = torch.where(ok, torch.angle(pl[..., 1:] * pl[..., :-1].conj()), 0.0)
        coef = torch.where(ok, 2 * math.pi / n * dk, 0.0)
        measured = ok.any(-1)
        err_sym = torch.where(measured, ang.sum(-1) / coef.sum(-1).clamp(min=1e-6), 0.0)
        count = measured.sum(-1)
        err = (err_sym.sum(-1) / count.clamp(min=1)).clamp(-MAX_STEP, MAX_STEP)
        phase = _common_phase(pl)[..., None]
        bits = _demap(torch.complex(d.real + d.imag * phase, d.imag - d.real * phase), mode)
        inside = b < n_blocks  # a row's blocks past its own frame change nothing
        new_tau = torch.where(inside, tau + rate * b_syms - g1 * err, tau)
        new_rate = torch.where(inside, rate - g2 * err / b_syms, rate)
        return new_tau, new_rate, bits, err, torch.where(inside, count, 0)

    def run(tau, rate, g1, g2):
        bits, errs, counts = [], [], []
        for b in range(total):
            tau, rate, bb, e, c = step(tau, rate, b, g1, g2)
            bits.append(bb)
            errs.append(e)
            counts.append(c)
        return tau, rate, torch.stack(bits, 1), torch.stack(errs, 1), torch.stack(counts, 1).to(F64)

    zero = torch.zeros(r, dtype=F64, device=dev)
    _, rate_acq, _, _, _ = run(zero, zero, *GAINS)
    _, _, _, err, w = run(zero, rate_acq, 0.0, 0.0)
    centre = torch.arange(total, device=dev, dtype=F64) * b_syms + (b_syms - 1) / 2.0
    wsum = w.sum(1).clamp(min=1e-6)
    cm = (w * centre).sum(1) / wsum
    em = (w * err).sum(1) / wsum
    dc, de = centre - cm[:, None], err - em[:, None]
    den = (w * dc * dc).sum(1)
    slope = torch.where(den > 1e-6, (w * dc * de).sum(1) / den.clamp(min=1e-6), 0.0)
    tau, _, bits, _, _ = run(-(em - slope * cm), rate_acq - slope, *GAINS)
    per_sym = mode.bits_per_symbol
    bits = bits.reshape(r, -1)[:, : int(n_sym.max()) * per_sym]
    keep = torch.arange(bits.shape[1], device=dev) < (n_sym * per_sym)[:, None]
    return torch.where(keep, bits, 0), tau


def signal_symbols(n_payload_bytes: int, mode_name: str) -> int:
    """Data symbols that carry a frame of ``n_payload_bytes`` (the rest of a
    recording's symbols are junk)."""
    mode = MODES[mode_name]
    return -(-8 * n_payload_bytes * mode.repetition // mode.bits_per_symbol)
