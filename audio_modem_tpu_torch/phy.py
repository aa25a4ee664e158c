"""L2 OFDM PHY on tensors (counterpart of audio_modem_tpu/phy.py;
modem.js:322-440): modulate, channel estimate, one-tap ZF equalization,
pilot common-phase correction and hard demap, batched over leading axes."""

from __future__ import annotations

import torch

from audio_modem_tpu.configs import ModemMode, OfdmProfile
from audio_modem_tpu_torch.ops import constellations as con
from audio_modem_tpu_torch.ops.dft import synthesize_data_symbols, time_to_spec, time_to_spec_bins
from audio_modem_tpu_torch.tables import profile_tables


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


def demodulate(
    symbols: torch.Tensor, ch_re: torch.Tensor, ch_im: torch.Tensor, mode: ModemMode
) -> torch.Tensor:
    """Symbols [..., n_sym, symbol_len] -> hard bits [..., n_sym * bits_per_symbol]
    (modem.js:365-418): strip CP, DFT at data and pilot bins, ZF EQ, pilot
    phase phi = mean(Im/Re) over pilots with |Re| > 1e-6, rotation
    (re + im*phi, im - re*phi), demap. ``ch_*`` are active-bin channels
    [..., n_active], broadcast over the symbol axis."""
    p = mode.profile
    tabs = profile_tables(p, symbols.device)
    body = strip_cp(symbols, p)
    d_re, d_im = time_to_spec_bins(body, tabs.rx_data)
    p_re, p_im = time_to_spec_bins(body, tabs.rx_pilot)

    def pick(ch: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return ch.index_select(-1, pos)[..., None, :]

    dr, di = equalize(d_re, d_im, pick(ch_re, tabs.data_pos), pick(ch_im, tabs.data_pos))
    pr, pi = equalize(p_re, p_im, pick(ch_re, tabs.pilot_pos), pick(ch_im, tabs.pilot_pos))

    usable = pr.abs() > 1e-6
    ratio = torch.where(usable, pi / torch.where(usable, pr, 1.0), 0.0)
    cnt = usable.sum(dim=-1)
    phi = torch.where(cnt > 0, ratio.sum(dim=-1) / torch.clamp(cnt, min=1), 0.0)[..., None]

    bits = con.demap(mode.constellation, dr + di * phi, di - dr * phi)
    *lead, n_sym, per = bits.shape
    return bits.reshape(*lead, n_sym * per)
