"""Active-bin DFT as float32 matrix products (counterpart of
audio_modem_tpu/ops/dft.py).

Only the active bins carry information, so the receive DFT is a product
against the table restricted to those bins, and transmit (data scatter,
pilots, Hermitian IFFT and CP) is one product plus a constant row. Every
product runs in full float32 (TF32 is off, see the package docstring).
"""

from __future__ import annotations

import torch

from audio_modem_tpu_torch.tables import Tables


def time_to_spec_bins(body: torch.Tensor, rx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Real time domain [..., fft] -> spectrum (re, im) at the bins of the
    RX table ``rx`` [fft, 2*n_bins] (one of ``Tables.rx_*``)."""
    out = torch.matmul(body.to(torch.float32), rx)
    n = rx.shape[1] // 2
    return out[..., :n], out[..., n:]


def time_to_spec(body: torch.Tensor, tables: Tables) -> tuple[torch.Tensor, torch.Tensor]:
    """Real time domain [..., fft] -> active-bin spectrum (re, im)."""
    return time_to_spec_bins(body, tables.rx_active)


def synthesize_data_symbols(
    data_re: torch.Tensor, data_im: torch.Tensor, tables: Tables
) -> torch.Tensor:
    """Mapped data points [..., nd] -> CP-prefixed symbols [..., sym]."""
    stacked = torch.cat([data_re, data_im], dim=-1).to(torch.float32)
    return torch.matmul(stacked, tables.tx_data) + tables.tx_pilot
