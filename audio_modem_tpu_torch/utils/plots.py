"""Optional matplotlib plots — the L6 canvas analogs (app.js:1631-1722; a
copy of audio_modem_tpu/utils/plots.py).

All functions save a PNG and return the path; matplotlib is imported lazily
and everything degrades to a no-op message if it is unavailable.
"""

from __future__ import annotations

import numpy as np

from audio_modem_tpu_torch.configs import OfdmProfile, SAMPLE_RATE


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_spectrum(spectrum_db: np.ndarray, freqs: np.ndarray, path: str, profile: OfdmProfile | None = None) -> str:
    """dB spectrum with the OFDM band highlighted (app.js:1631-1676)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 3.2))
    ax.plot(freqs, spectrum_db, lw=0.8)
    if profile is not None:
        bin_hz = profile.sample_rate / profile.fft_size
        ax.axvspan(profile.sub_start * bin_hz, profile.sub_end * bin_hz, alpha=0.15, label="OFDM band")
        ax.legend(loc="upper right")
    ax.set_xlabel("Hz")
    ax.set_ylabel("dB")
    ax.set_title("input spectrum")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_channel_response(channel_mag: np.ndarray, profile: OfdmProfile, path: str) -> str:
    """Per-subcarrier |H| bars; red below peak - 20 dB (app.js:1678-1722)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 3.2))
    bins = profile.active_bins
    peak = channel_mag.max() if len(channel_mag) else 1.0
    weak = channel_mag < peak * 10 ** (-20 / 20)
    colors = np.where(weak, "tab:red", "tab:blue")
    ax.bar(bins, channel_mag, color=colors, width=1.0)
    ax.set_xlabel("subcarrier")
    ax.set_ylabel("|H|")
    ax.set_title(f"channel response ({profile.name})")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_waveform(signal: np.ndarray, path: str, sample_rate: int = SAMPLE_RATE) -> str:
    """Min/max-envelope waveform (trimmer display, app.js:1252-1306)."""
    plt = _plt()
    n = len(signal)
    cols = min(2000, n)
    edges = np.linspace(0, n, cols + 1).astype(int)
    mins = np.array([signal[a:b].min() if b > a else 0 for a, b in zip(edges[:-1], edges[1:])])
    maxs = np.array([signal[a:b].max() if b > a else 0 for a, b in zip(edges[:-1], edges[1:])])
    t = edges[:-1] / sample_rate
    fig, ax = plt.subplots(figsize=(9, 2.6))
    ax.fill_between(t, mins, maxs, lw=0)
    ax.set_xlabel("s")
    ax.set_title("waveform")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_ber_curve(curve: dict[float, float], path: str, title: str = "BER vs SNR") -> str:
    plt = _plt()
    snrs = sorted(curve)
    bers = [max(curve[s], 1e-7) for s in snrs]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(snrs, bers, marker="o")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
