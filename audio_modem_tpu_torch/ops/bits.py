"""MSB-first bit/byte packing, repetition coding, voting and soft combining
on tensors (modem.js:460-495; counterpart of audio_modem_tpu/ops/bits.py)."""

from __future__ import annotations

import torch

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """[..., k] uint8 -> [..., 8k] int8 bits, MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).to(torch.int8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] bits -> [..., n // 8] uint8, MSB first; a trailing partial
    byte is dropped."""
    *lead, nb = bits.shape
    k = nb // 8
    b = bits[..., : k * 8].reshape(*lead, k, 8).to(torch.int32)
    w = torch.tensor(_WEIGHTS, dtype=torch.int32, device=bits.device)
    return (b * w).sum(dim=-1).to(torch.uint8)


def repeat_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Repetition code over the last axis: each bit n times in a row
    (modem.js:479-485)."""
    return torch.repeat_interleave(bits, n, dim=-1)


def majority_vote(bits: torch.Tensor, n: int) -> torch.Tensor:
    """Majority decode of an n-fold repetition code over the last axis; ties
    go to 1 (sum * 2 >= n, modem.js:487-495). A trailing partial group is
    dropped."""
    *lead, nb = bits.shape
    m = nb // n
    groups = bits[..., : m * n].reshape(*lead, m, n).to(torch.int32)
    return (groups.sum(dim=-1) * 2 >= n).to(torch.int8)


def soft_combine(soft: torch.Tensor, n: int) -> torch.Tensor:
    """Soft repetition decode over the last axis: sum each transmitted bit's
    n BPSK soft metrics in float64 and decide by sign (metric < 0 -> 1), the
    maximum-ratio counterpart of ``majority_vote``. A trailing partial group
    is dropped."""
    *lead, nb = soft.shape
    m = nb // n
    groups = soft[..., : m * n].reshape(*lead, m, n).to(torch.float64)
    return (groups.sum(dim=-1) < 0).to(torch.int8)
