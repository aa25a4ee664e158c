"""Per-profile constant tables: the receiver's only state.

The modem has no learned parameters. What a model would call its weights
are these tables, all derived from ``configs`` (the JS-LCG defines the
preamble and CE waveforms):

  rx_active  [fft, 2*n_active]  RX DFT (cos | -sin) at the active bins
  rx_data    [fft, 2*nd]        RX DFT at the data bins
  rx_pilot   [fft, 2*npi]       RX DFT at the pilot bins
  rx_demod   [fft, ncol_pad]    rx_data | rx_pilot | zero columns up to a multiple
                                of 16, so rows are whole 16-byte pieces: the
                                table the demod kernels stage (``demod_table``)
  demod_bins [nd + npi]         the DFT bin of each data, then pilot, column of
                                rx_demod: the bins kernel C's FFT tile keeps
  fft_twiddle [fft, 2]          cos | -sin of 2 pi k / fft, k = 0 .. fft-1, in
                                float64 rounded once: the FFT tile's twiddles
                                (``fft_twiddles``)
  tx_data    [2*nd, sym]        TX data matrix: (cos | -sin) * 2/N rows of the
                                data bins, columns cyclically extended by CP
  tx_pilot   [sym]              time-domain pilot row (pilots are 1+0j)
  ce_known   [n_active]         known CE BPSK signs
  pre1       [sym]              preamble-1 template; ``t_energy`` its float64 energy
  header     [3*sym]            pre1 | pre2 | CE
  data_pos   [nd], pilot_pos [npi]  data / pilot positions on the active-bin axis

``profile_tables`` builds them from ``configs`` alone; ``tables_from_numpy``
turns the JAX package's numpy arrays into the same tensors (the tests hold
the two bit-identical) and derives ``rx_demod`` and ``demod_bins`` from
``rx_data`` and ``rx_pilot``, and ``fft_twiddle`` from the DFT size.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from audio_modem_tpu_torch.configs import ModemMode, OfdmProfile

_FLOAT_KEYS = ("rx_active", "rx_data", "rx_pilot", "tx_data", "tx_pilot", "ce_known", "pre1", "header")
_INDEX_KEYS = ("data_pos", "pilot_pos")
DEMOD_COLUMN_MULTIPLE = 16  # rx_demod's width is padded to a multiple of this many floats


@dataclasses.dataclass(frozen=True)
class Tables:
    rx_active: torch.Tensor
    rx_data: torch.Tensor
    rx_pilot: torch.Tensor
    rx_demod: torch.Tensor
    demod_bins: torch.Tensor
    fft_twiddle: torch.Tensor
    tx_data: torch.Tensor
    tx_pilot: torch.Tensor
    ce_known: torch.Tensor
    pre1: torch.Tensor
    t_energy: float
    header: torch.Tensor
    data_pos: torch.Tensor
    pilot_pos: torch.Tensor


def _rx_matrix_for_bins(fft: int, bins) -> np.ndarray:
    k = np.asarray(bins)[None, :].astype(np.float64)
    t = np.arange(fft)[:, None].astype(np.float64)
    ang = 2.0 * np.pi * k * t / fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def _tx_tables(profile: OfdmProfile) -> tuple[np.ndarray, np.ndarray]:
    n = profile.fft_size
    cp = profile.cp_len
    k = profile.active_bins[:, None].astype(np.float64)
    t = np.arange(n)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * t / n
    cos = (2.0 / n) * np.cos(ang)
    msin = -(2.0 / n) * np.sin(ang)
    pilot_mask = profile.pilot_mask_active
    pilot_body = cos[pilot_mask].sum(axis=0)  # float64, like the reference

    def extend(m: np.ndarray) -> np.ndarray:
        return np.concatenate([m[..., n - cp :], m], axis=-1)

    data = np.concatenate([cos[~pilot_mask], msin[~pilot_mask]], axis=0)
    return extend(data).astype(np.float32), extend(pilot_body).astype(np.float32)


def demod_table(rx_data: np.ndarray, rx_pilot: np.ndarray) -> np.ndarray:
    """[fft, 2*nd] and [fft, 2*npi] -> [fft, ncol_pad]: the two tables side by
    side, then zero columns up to a multiple of ``DEMOD_COLUMN_MULTIPLE``."""
    both = np.concatenate([np.asarray(rx_data, np.float32), np.asarray(rx_pilot, np.float32)], axis=1)
    pad = -both.shape[1] % DEMOD_COLUMN_MULTIPLE
    return np.ascontiguousarray(np.pad(both, ((0, 0), (0, pad))))


def demod_bins(rx_data: np.ndarray, rx_pilot: np.ndarray) -> np.ndarray:
    """The DFT bin of each column of ``demod_table(rx_data, rx_pilot)`` but the
    padding, int32 [nd + npi]: the angle 2 pi k / fft of its row t = 1 (cos at
    column j, -sin at column j + n), rounded to the nearest bin."""
    out = []
    for m in (np.asarray(rx_data, np.float64), np.asarray(rx_pilot, np.float64)):
        n = m.shape[1] // 2
        ang = np.arctan2(-m[1, n:], m[1, :n]) % (2 * np.pi)
        out.append(np.rint(ang * m.shape[0] / (2 * np.pi)).astype(np.int64) % m.shape[0])
    return np.concatenate(out).astype(np.int32)


def fft_twiddles(fft: int) -> np.ndarray:
    """float32 [fft, 2]: cos and -sin of 2 pi k / fft, computed in float64 and
    rounded once (the forward sign, as the RX tables' columns)."""
    ang = 2.0 * np.pi * np.arange(fft, dtype=np.float64) / fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def numpy_tables(profile: OfdmProfile) -> dict:
    """The tables as numpy arrays, built from ``configs`` alone."""
    fft = profile.fft_size
    pilot_mask = profile.pilot_mask_active
    tx_data, tx_pilot = _tx_tables(profile)
    pre1 = profile.preamble1
    return {
        "rx_active": _rx_matrix_for_bins(fft, profile.active_bins),
        "rx_data": _rx_matrix_for_bins(fft, profile.data_bins),
        "rx_pilot": _rx_matrix_for_bins(fft, profile.pilot_bins),
        "tx_data": tx_data,
        "tx_pilot": tx_pilot,
        "ce_known": profile.ce_known_signs.astype(np.float32),
        "pre1": pre1,
        "t_energy": float((pre1.astype(np.float64) ** 2).sum()),
        "header": np.concatenate([pre1, profile.preamble2, profile.ce_symbol]),
        "data_pos": np.nonzero(~pilot_mask)[0],
        "pilot_pos": np.nonzero(pilot_mask)[0],
    }


def tables_from_numpy(arrays: dict, device) -> Tables:
    """numpy arrays (keys as in ``numpy_tables``) -> float32 / int32 tensors
    on ``device``, ``rx_demod`` and ``demod_bins`` derived from ``rx_data``
    and ``rx_pilot``, ``fft_twiddle`` from the DFT size."""
    dev = torch.device(device)
    out = {k: torch.as_tensor(np.asarray(arrays[k], np.float32)).contiguous().to(dev) for k in _FLOAT_KEYS}
    out["rx_demod"] = torch.as_tensor(demod_table(arrays["rx_data"], arrays["rx_pilot"])).to(dev)
    out["demod_bins"] = torch.as_tensor(demod_bins(arrays["rx_data"], arrays["rx_pilot"])).to(dev)
    out["fft_twiddle"] = torch.as_tensor(fft_twiddles(np.asarray(arrays["rx_active"]).shape[0])).to(dev)
    out.update(
        {k: torch.as_tensor(np.asarray(arrays[k], np.int32)).contiguous().to(dev) for k in _INDEX_KEYS}
    )
    return Tables(t_energy=float(arrays["t_energy"]), **out)


@lru_cache(maxsize=None)
def _cached(profile: OfdmProfile, device: str) -> Tables:
    return tables_from_numpy(numpy_tables(profile), device)


def profile_tables(mode: "ModemMode | OfdmProfile", device) -> Tables:
    """The tables of a mode's (or a profile's) OFDM profile on ``device``,
    built once per pair."""
    profile = mode.profile if isinstance(mode, ModemMode) else mode
    return _cached(profile, str(torch.device(device)))
