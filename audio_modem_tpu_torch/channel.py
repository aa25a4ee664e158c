"""Channel simulator (counterpart of audio_modem_tpu/channel.py): AWGN,
multipath FIR echoes, gain, DC offset, sample-clock drift (resampling) and
dropout, on tensors of any leading shape.

Declarative (``ChannelSpec``), so tests and benchmarks state a channel
precisely. The deterministic stages compute what the JAX package computes
in float32; the noise comes from an explicit ``torch.Generator``, so it is
reproducible for one seed but not equal to the JAX package's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_modem_tpu_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Declarative channel description, applied in physical order:
    gain/multipath -> clock drift -> DC offset -> dropout -> AWGN."""

    snr_db: float | None = None  # AWGN SNR relative to signal power
    multipath: tuple[tuple[int, float], ...] = ()  # (delay_samples, amplitude) echoes
    gain: float = 1.0
    dc_offset: float = 0.0
    clock_ppm: float = 0.0  # sample-clock offset in parts-per-million
    dropout: tuple[tuple[int, int], ...] = ()  # (start, length) zeroed spans


def awgn(signal: torch.Tensor, snr_db: float, generator: torch.Generator) -> torch.Tensor:
    """Add white Gaussian noise at ``snr_db`` relative to the mean signal
    power of each row, drawn from ``generator`` (on the signal's device)."""
    x = signal.to(torch.float32)
    power = (x * x).mean(dim=-1, keepdim=True)
    noise_power = power / (10.0 ** (snr_db / 10.0))
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return x + noise * torch.sqrt(noise_power)


def multipath(signal: torch.Tensor, taps: tuple[tuple[int, float], ...]) -> torch.Tensor:
    """Direct path + delayed attenuated echoes (sparse FIR)."""
    x = signal.to(torch.float32)
    out = x
    idx = torch.arange(x.shape[-1], device=x.device)
    for delay, amp in taps:
        echo = torch.roll(x, delay, dims=-1)
        # zero the wrapped head so the echo is causal
        echo = torch.where(idx >= delay, echo, 0.0)
        out = out + amp * echo
    return out


def clock_drift(signal: torch.Tensor, ppm: float, taps: int = 65) -> torch.Tensor:
    """Resample by (1 + ppm*1e-6) with a Kaiser-windowed-sinc interpolator:
    the TX/RX sample-clock mismatch of two real sound cards.

    A clock offset is a pure time shift of a bandlimited waveform, so the
    interpolator must be near-ideal through the band: linear interpolation
    would itself destroy the band-edge bins. A 65-tap Kaiser (beta 8) sinc
    kernel keeps the polyphase responses near-flat. Output length equals
    input length; computed in 65,536-sample blocks so peak memory stays
    O(block * taps)."""
    if ppm == 0.0:
        return signal
    x = signal.to(torch.float32)
    t = x.shape[-1]
    half = taps // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    beta = 8.0
    i0_beta = torch.special.i0(torch.tensor(beta, dtype=torch.float32, device=x.device))
    block = 65536
    out = torch.empty((*x.shape[:-1], -(-t // block) * block), dtype=torch.float32, device=x.device)
    for b0 in range(0, out.shape[-1], block):
        dst = torch.arange(b0, b0 + block, dtype=torch.float32, device=x.device)
        src = dst * (1.0 + ppm * 1e-6)
        base = torch.floor(src)
        mu = src - base
        idx = torch.clamp(base.to(torch.int32)[:, None] + offs.to(torch.int32)[None, :], 0, t - 1).long()
        u = offs[None, :] - mu[:, None]
        r = u / (half + 1)
        win = torch.special.i0(beta * torch.sqrt(torch.clamp(1.0 - r * r, 0.0, 1.0))) / i0_beta
        k = torch.sinc(u) * win
        k = k / k.sum(-1, keepdim=True)
        out[..., b0 : b0 + block] = (x[..., idx] * k).sum(-1)
    return out[..., :t]


def dropout(signal: torch.Tensor, spans: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """Zero out sample spans (buffer underruns, interference bursts)."""
    idx = torch.arange(signal.shape[-1], device=signal.device)
    out = signal
    for start, length in spans:
        out = torch.where((idx >= start) & (idx < start + length), 0.0, out)
    return out


def apply_channel(signal: torch.Tensor, spec: ChannelSpec, generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply a ChannelSpec. ``generator`` is required iff spec.snr_db is set."""
    out = signal.to(torch.float32) * spec.gain
    if spec.multipath:
        out = multipath(out, spec.multipath)
    if spec.clock_ppm:
        out = clock_drift(out, spec.clock_ppm)
    if spec.dc_offset:
        out = out + spec.dc_offset
    if spec.dropout:
        out = dropout(out, spec.dropout)
    if spec.snr_db is not None:
        if generator is None:
            raise ValueError("AWGN requires a torch.Generator")
        out = awgn(out, spec.snr_db, generator)
    return out


def apply_channel_np(signal: np.ndarray, spec: ChannelSpec, seed: int = 0, device="cuda") -> np.ndarray:
    """Host convenience wrapper: numpy in, the channel applied on ``device``
    with a generator seeded by ``seed``, numpy float32 out. Asking for CUDA
    where there is no CUDA device raises."""
    dev = resolve_device(device)
    gen = None
    if spec.snr_db is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    x = torch.from_numpy(np.array(signal, dtype=np.float32)).to(dev)
    return apply_channel(x, spec, gen).cpu().numpy().astype(np.float32, copy=False)
