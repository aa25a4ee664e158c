"""L2 OFDM PHY on tensors (counterpart of audio_modem_tpu/phy.py;
modem.js:322-440): modulate, channel estimate, one-tap ZF equalization,
pilot common-phase correction and hard demap, batched over leading axes;
the decoder's retry tools (BPSK soft metrics, timing-tracked demod,
per-symbol EVM)."""

from __future__ import annotations

import math

import torch

from audio_modem_tpu_torch.configs import ModemMode, OfdmProfile
from audio_modem_tpu_torch.ops import constellations as con
from audio_modem_tpu_torch.ops.dft import synthesize_data_symbols, time_to_spec, time_to_spec_bins
from audio_modem_tpu_torch.tables import profile_tables
from audio_modem_tpu_torch.utils import trace

TRACK_BLOCK = 64  # symbols a block of the tracking loop, unless a caller says otherwise
# the loop's (g1, g2) gains of its passes, in order: acquire, frozen, from the fit
TRACK_GAINS = ((0.5, 0.25), (0.0, 0.0), (0.5, 0.25))


def add_cp(body: torch.Tensor, profile: OfdmProfile) -> torch.Tensor:
    """[..., fft_size] -> [..., symbol_len] (modem.js:202-208)."""
    return torch.cat([body[..., -profile.cp_len :], body], dim=-1)


def strip_cp(symbols: torch.Tensor, profile: OfdmProfile) -> torch.Tensor:
    """[..., symbol_len] -> [..., fft_size] (modem.js:374-378)."""
    return symbols[..., profile.cp_len : profile.cp_len + profile.fft_size]


def modulate(bits: torch.Tensor, mode: ModemMode) -> torch.Tensor:
    """Bits [..., n_sym * bits_per_symbol] -> samples [..., n_sym, symbol_len]:
    pilots 1+0j, data bins mapped MSB-first, Hermitian IFFT, cyclic prefix
    (modem.js:322-362). Bits must be padded to a whole symbol."""
    *lead, nb = bits.shape
    bps_sym = con.bits_per_symbol(mode)
    grouped = bits.reshape(*lead, nb // bps_sym, bps_sym)
    data_re, data_im = con.map_bits(mode.constellation, grouped)
    return synthesize_data_symbols(data_re, data_im, profile_tables(mode, bits.device))


def estimate_channel(ce_samples: torch.Tensor, profile: OfdmProfile) -> tuple[torch.Tensor, torch.Tensor]:
    """CE symbol [..., symbol_len] -> channel (re, im) on the active bins:
    H = Y * X with the known X = +-1 (modem.js:421-440)."""
    tabs = profile_tables(profile, ce_samples.device)
    y_re, y_im = time_to_spec(strip_cp(ce_samples, profile), tabs)
    return y_re * tabs.ce_known, y_im * tabs.ce_known


def equalize(
    spec_re: torch.Tensor, spec_im: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-tap ZF EQ, passing the sample through where |H|^2 <= 1e-10
    (modem.js:384-394)."""
    h_mag = ch_re * ch_re + ch_im * ch_im
    ok = h_mag > 1e-10
    denom = torch.where(ok, h_mag, 1.0)
    eq_re = torch.where(ok, (spec_re * ch_re + spec_im * ch_im) / denom, spec_re)
    eq_im = torch.where(ok, (spec_im * ch_re - spec_re * ch_im) / denom, spec_im)
    return eq_re, eq_im


def _pick(ch: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Active-bin channel [..., n_active] at ``pos``, broadcast over symbols."""
    return ch.index_select(-1, pos)[..., None, :]


def _common_phase(pr: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Small-angle common phase over the last (pilot) axis: the mean of
    Im/Re over pilots with |Re| > 1e-6, 0 when there are none
    (modem.js:397-405)."""
    usable = pr.abs() > 1e-6
    ratio = torch.where(usable, pi / torch.where(usable, pr, 1.0), 0.0)
    cnt = usable.sum(dim=-1)
    return torch.where(cnt > 0, ratio.sum(dim=-1) / torch.clamp(cnt, min=1), 0.0)


def pilot_phase(eq_re: torch.Tensor, eq_im: torch.Tensor, profile: OfdmProfile) -> torch.Tensor:
    """Common phase of equalized active-bin spectra [..., n_active] -> [...]."""
    pos = profile_tables(profile, eq_re.device).pilot_pos
    return _common_phase(eq_re.index_select(-1, pos), eq_im.index_select(-1, pos))


def _data_spectrum_and_phase(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, profile: OfdmProfile
) -> tuple[torch.Tensor, ...]:
    """Strip CP, DFT at data and pilot bins, pilot EQ and common phase:
    (data spectrum re, im; data-bin channel re, im; phase [..., n_sym, 1])."""
    tabs = profile_tables(profile, symbols.device)
    body = strip_cp(symbols, profile)
    d_re, d_im = time_to_spec_bins(body, tabs.rx_data)
    p_re, p_im = time_to_spec_bins(body, tabs.rx_pilot)
    pr, pi = equalize(p_re, p_im, _pick(ch_re, tabs.pilot_pos), _pick(ch_im, tabs.pilot_pos))
    phi = _common_phase(pr, pi)[..., None]
    return d_re, d_im, _pick(ch_re, tabs.data_pos), _pick(ch_im, tabs.data_pos), phi


def _corrected_data(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, profile: OfdmProfile
) -> tuple[torch.Tensor, torch.Tensor]:
    """ZF-equalized, phase-rotated data points [..., n_sym, nd]: (re + im*phi,
    im - re*phi)."""
    d_re, d_im, hr, hi, phi = _data_spectrum_and_phase(symbols, ch_re, ch_im, profile)
    dr, di = equalize(d_re, d_im, hr, hi)
    return dr + di * phi, di - dr * phi


def demodulate(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, mode: ModemMode
) -> torch.Tensor:
    """Symbols [..., n_sym, symbol_len] -> hard bits [..., n_sym * bits_per_symbol]
    (modem.js:365-418): strip CP, DFT at data and pilot bins, ZF EQ, pilot
    phase phi = mean(Im/Re) over pilots with |Re| > 1e-6, rotation
    (re + im*phi, im - re*phi), demap. ``ch_*`` are active-bin channels
    [..., n_active], broadcast over the symbol axis."""
    cr, ci = _corrected_data(symbols, ch_re, ch_im, mode.profile)
    bits = con.demap(mode.constellation, cr, ci)
    *lead, n_sym, per = bits.shape
    return bits.reshape(*lead, n_sym * per)


def demodulate_soft_bpsk(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, mode: ModemMode
) -> torch.Tensor:
    """BPSK soft metrics [..., n_sym * nd] in ``demodulate``'s bit order: the
    matched-filter (Y * conj(H)), phase-corrected real part of each data bin;
    the hard bit is metric < 0. Matched filtering weights each copy by
    |H|^2, so summing a repetition's metrics is maximum-ratio combining
    (the input of ``ops.bits.soft_combine``)."""
    if mode.constellation != "BPSK":
        raise ValueError("soft metrics exist for BPSK (the repetition modes) only")
    d_re, d_im, hr, hi, phi = _data_spectrum_and_phase(symbols, ch_re, ch_im, mode.profile)
    ok = hr * hr + hi * hi > 1e-10
    mr = torch.where(ok, d_re * hr + d_im * hi, d_re)
    mi = torch.where(ok, d_im * hr - d_re * hi, d_im)
    cr = mr + mi * phi
    *lead, n_sym, nd = cr.shape
    return cr.reshape(*lead, n_sym * nd)


def _clamped_windows(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """Windows of the 1-D ``x`` at ``starts`` [n] -> [n, length], each start
    clamped into [0, len(x) - length] as ``lax.dynamic_slice`` does."""
    s = torch.clamp(starts.to(torch.int64), 0, x.shape[-1] - length)
    return x[s[:, None] + torch.arange(length, device=x.device)]


def demodulate_tracked(
    sig_ext: torch.Tensor,
    data_start: int,
    n_sym: int,
    ch_re: torch.Tensor,
    ch_im: torch.Tensor,
    mode: ModemMode,
    block_syms: int = TRACK_BLOCK,
    n_valid_sym: "int | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Demodulate ``n_sym`` symbols of the 1-D ``sig_ext`` from ``data_start``
    with sample-timing tracking for TX/RX clock offset (extension; see the
    JAX package's phy.demodulate_tracked for the derivation).

    A second-order loop runs over blocks of ``block_syms`` symbols: each
    window starts at its predicted offset tau + rate*j rounded to samples,
    the sub-sample rest is de-rotated in frequency, and the residual timing
    error read from the phase steps between adjacent pilots feeds back into
    tau and rate. Three passes, as in the reference: closed loop from zero
    (acquires a rate), frozen loop (per-block residuals, fitted by weighted
    least squares to a rate and head offset), closed loop from the fit (the
    bits). Symbols at or past ``n_valid_sym`` are left out of the timing
    measurement. Returns (bits [n_sym * bits_per_symbol], final tau).
    While the span recorder is on, each pass is a ``decode.track.pass``
    span (attr ``index``) and each block step counts in ``track_blocks``."""
    p = mode.profile
    dev = sig_ext.device
    tabs = profile_tables(p, dev)
    sym, fft, cp = p.symbol_len, p.fft_size, p.cp_len
    kd = torch.as_tensor(p.data_bins, dtype=torch.float32, device=dev)
    kp = torch.as_tensor(p.pilot_bins, dtype=torch.float32, device=dev)
    chd_re, chd_im = ch_re[tabs.data_pos][None, :], ch_im[tabs.data_pos][None, :]
    chp_re, chp_im = ch_re[tabs.pilot_pos][None, :], ch_im[tabs.pilot_pos][None, :]
    n_blocks = -(-n_sym // block_syms)
    jloc = torch.arange(block_syms, dtype=torch.float32, device=dev)
    jint = torch.arange(block_syms, device=dev)
    two_pi = 2.0 * math.pi
    dks = kp[1:] - kp[:-1]

    def derot(re, im, k, frac):
        ang = two_pi * k[None, :] * frac[:, None] / fft
        c, s = torch.cos(ang), torch.sin(ang)
        return re * c - im * s, im * c + re * s

    def step(tau, rate, b, g1, g2):
        off = tau + rate * jloc
        shift = torch.round(off)
        frac = off - shift
        starts = data_start + (b * block_syms + jint) * sym + cp + shift.to(torch.int64)
        bodies = _clamped_windows(sig_ext, starts, fft)
        d_re, d_im = derot(*time_to_spec_bins(bodies, tabs.rx_data), kd, frac)
        p_re, p_im = derot(*time_to_spec_bins(bodies, tabs.rx_pilot), kp, frac)
        dr, di = equalize(d_re, d_im, chd_re, chd_im)
        pr, pi = equalize(p_re, p_im, chp_re, chp_im)
        u_re = pr[:, 1:] * pr[:, :-1] + pi[:, 1:] * pi[:, :-1]
        u_im = pi[:, 1:] * pr[:, :-1] - pr[:, 1:] * pi[:, :-1]
        mag_ok = (pr[:, 1:] ** 2 + pi[:, 1:] ** 2 > 1e-12) & (pr[:, :-1] ** 2 + pi[:, :-1] ** 2 > 1e-12)
        if n_valid_sym is not None:
            mag_ok = mag_ok & ((b * block_syms + jint) < n_valid_sym)[:, None]
        ang = torch.where(mag_ok, torch.atan2(u_im, u_re), 0.0)
        coef = torch.where(mag_ok, (two_pi / fft) * dks[None, :], 0.0)
        delta = ang.sum(-1) / torch.clamp(coef.sum(-1), min=1e-6)
        n_ok = mag_ok.sum(-1)
        delta = torch.where(n_ok >= 1, delta, 0.0)
        measured = (n_ok >= 1).sum()
        delta_blk = torch.clamp(delta.sum() / torch.clamp(measured, min=1), -8.0, 8.0)
        phi = _common_phase(pr, pi)[:, None]
        bits = con.demap(mode.constellation, dr + di * phi, di - dr * phi)
        new_rate = rate - g2 * delta_blk / block_syms
        new_tau = tau + rate * block_syms - g1 * delta_blk
        return new_tau, new_rate, bits, delta_blk, measured

    def run(index, tau, rate):
        g1, g2 = TRACK_GAINS[index]
        bits, deltas, weights = [], [], []
        with trace.span("decode.track.pass", index=index):
            for b in range(n_blocks):
                tau, rate, bb, dlt, w = step(tau, rate, b, g1, g2)
                bits.append(bb)
                deltas.append(dlt)
                weights.append(w)
        trace.count("track_blocks", n_blocks)
        return tau, rate, bits, torch.stack(deltas), torch.stack(weights)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    _, rate_acq, _, _, _ = run(0, zero, zero)
    _, _, _, deltas_m, ws = run(1, zero, rate_acq)
    x = torch.arange(n_blocks, dtype=torch.float32, device=dev) * block_syms + (block_syms - 1) / 2.0
    w = ws.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1e-6)
    xm = (w * x).sum() / wsum
    dm = (w * deltas_m).sum() / wsum
    den = (w * (x - xm) ** 2).sum()
    slope = torch.where(den > 1e-6, (w * (x - xm) * (deltas_m - dm)).sum() / torch.clamp(den, min=1e-6), 0.0)
    intercept = dm - slope * xm
    tau_f, _, bits, _, _ = run(2, -intercept, rate_acq - slope)
    bits = torch.cat(bits).reshape(n_blocks * block_syms, -1)[:n_sym]
    return bits.reshape(-1), tau_f


def channel_magnitude(ch_re: torch.Tensor, ch_im: torch.Tensor) -> torch.Tensor:
    """|H| per active bin (modem.js:1025-1029)."""
    return torch.sqrt(ch_re * ch_re + ch_im * ch_im)


def symbol_evm(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, mode: ModemMode
) -> torch.Tensor:
    """Per-symbol error-vector magnitude [..., n_sym]: RMS distance of the
    equalized data points from their hard decisions, at unit reference
    power. A symbol hit by a dropout reads ~1.0 where clean symbols read
    the noise level; the decoder's erasure flags come from it."""
    cr, ci = _corrected_data(symbols, ch_re, ch_im, mode.profile)
    dec_re, dec_im = con.map_bits(mode.constellation, con.demap(mode.constellation, cr, ci))
    err = (cr - dec_re) ** 2 + (ci - dec_im) ** 2
    return torch.sqrt(err.mean(dim=-1))


def error_vector_magnitude(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, mode: ModemMode
) -> torch.Tensor:
    """RMS error-vector magnitude over all data symbols."""
    per_sym = symbol_evm(symbols, ch_re, ch_im, mode)
    return torch.sqrt((per_sym * per_sym).mean(dim=-1))
