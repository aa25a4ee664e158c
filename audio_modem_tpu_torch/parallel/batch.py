"""Batched multi-stream decode (counterpart of
audio_modem_tpu/parallel/batch.py; BASELINE config 5).

The batched full receive goes through kernel A
(``kernels.receive.decode_fused``) at every window length: Hopper has no
VMEM gate, and kernel A grids its stages over tiles and streams. The
single-signal decoder runs the same kernel at B = 1 (see
``decoder._core_dispatch``). The frame-aligned demod goes through
kernel B. ``batch_decode_predicted`` (refine + CE + demod of one
cadence-predicted slot) and ``preprocess_extend`` are plain PyTorch, kept
in kernels/receive.py beside the turbo round's plain version
(``decode_predicted_reference``), which runs them slot by slot; the card
runs kernel C instead. The AWGN loopback step
(``batch_loopback_step``) is plain PyTorch.

``batch_decode_signals``, ``batch_decode_chunk_frames`` and
``batch_loopback_step`` also take a batch sharded over a mesh
(``mesh.Sharded``): each shard runs on its own device, every shard's work
is issued before any result is read, and the results stay sharded; only
the loopback's BER crosses devices, one scalar a shard.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_modem_tpu_torch import phy
from audio_modem_tpu_torch.channel import awgn
from audio_modem_tpu_torch.configs import ModemMode
from audio_modem_tpu_torch.kernels.receive import decode_chunks_fused, decode_fused
# The plain receive pipeline (counterpart of _batch_decode_signals_xla) and
# the predicted slot's plain bodies are kernel A's and kernel C's plain
# versions, kept beside the kernels in kernels/receive.py.
from audio_modem_tpu_torch.kernels.receive import batch_decode_predicted, preprocess_extend  # noqa: F401
from audio_modem_tpu_torch.kernels.receive import decode_fused_reference as _batch_decode_signals_plain  # noqa: F401
from audio_modem_tpu_torch.ops.bits import bits_to_bytes, majority_vote
from audio_modem_tpu_torch.ops.constellations import bits_per_symbol
from audio_modem_tpu_torch.parallel.mesh import Sharded, StreamMesh
from audio_modem_tpu_torch.tables import profile_tables


def map_shards(fn, *args, **kw) -> list:
    """``fn`` once per shard, in shard order: each ``Sharded`` argument
    gives its shard, every other argument goes to every shard as it is.
    ``fn`` must not wait on the device, so every shard's launches are
    issued before any result is read."""
    meshes = {a.mesh for a in args if isinstance(a, Sharded)}
    if len(meshes) != 1:
        raise ValueError(f"need arguments sharded over one mesh, got {len(meshes)} meshes")
    mesh = meshes.pop()
    return [fn(*(a.shards[k] if isinstance(a, Sharded) else a for a in args), **kw) for k in range(mesh.size)]


def shard_generators(seed: int, mesh: StreamMesh) -> tuple[torch.Generator, ...]:
    """One generator per mesh device, each seeded with ``seed`` (the JAX
    package hands every shard the same replicated key)."""
    return tuple(torch.Generator(device=dev).manual_seed(seed) for dev in mesh.devices)


def batch_decode_chunk_frames(frames: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Frame-aligned batch decode: [B, >= (3 + n_sym) * sym] -> bits [B, n_bits]
    (batched decodeChunkFrame, modem.js:770-803); sharded in, sharded out."""
    if isinstance(frames, Sharded):
        return Sharded(frames.mesh, tuple(map_shards(decode_chunks_fused, frames, mode, n_sym)))
    return decode_chunks_fused(frames, mode, n_sym)


def batch_decode_chunk_frames_packed(frames: torch.Tensor, mode: ModemMode, n_sym: int) -> torch.Tensor:
    """Frame-aligned batch decode to packed bytes [B, n_bytes] uint8, with
    the repetition vote and MSB-first packing on the device."""
    b = batch_decode_chunk_frames(frames, mode, n_sym)[:, : n_sym * bits_per_symbol(mode)]
    if mode.repetition > 1:
        b = majority_vote(b, mode.repetition)
    return bits_to_bytes(b)


def batch_decode_signals(
    signals: torch.Tensor,
    n_valid: torch.Tensor,
    mode: ModemMode,
    max_syms: int,
    min_pos: torch.Tensor | None = None,
) -> dict:
    """Full receive over [B, T] padded windows with [B] valid lengths;
    ``min_pos`` ignores detections before a per-stream position (the
    streaming runtime's resume). Returns the ``decode_fused`` dict; over a
    sharded batch, a dict of ``Sharded`` results."""
    if isinstance(signals, Sharded):
        outs = map_shards(batch_decode_signals, signals, n_valid, mode, max_syms, min_pos)
        return {k: Sharded(signals.mesh, tuple(o[k] for o in outs)) for k in outs[0]}
    if min_pos is None:
        min_pos = torch.zeros(signals.shape[0], dtype=torch.int32, device=signals.device)
    return decode_fused(signals, n_valid.to(torch.int32), min_pos.to(torch.int32), mode, max_syms)


def batch_loopback_step(
    bits: torch.Tensor, generator: torch.Generator, mode: ModemMode, n_sym: int, snr_db: float = 20.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full TX -> AWGN -> RX loopback over a stream batch, reduced to a
    scalar BER, on the device of ``bits``: modulate, prepend the CE symbol,
    add noise drawn from ``generator`` (``channel.awgn``), estimate the
    channel, demodulate. Plain PyTorch, as the JAX package runs it in XLA.

    bits: [B, n_sym * bits_per_symbol] in {0,1}. Returns (BER, out_bits).
    Over a sharded batch, ``generator`` is one generator per shard
    (``shard_generators``); the BER is the mean of the shards' BERs on the
    mesh's first device and out_bits stays sharded."""
    if isinstance(bits, Sharded):
        if len(generator) != bits.mesh.size:
            raise ValueError(f"need one generator per shard ({bits.mesh.size}), got {len(generator)}")
        outs = [batch_loopback_step(b, g, mode, n_sym, snr_db) for b, g in zip(bits.shards, generator)]
        ber = torch.stack([o[0].to(bits.mesh.devices[0]) for o in outs]).mean()
        return ber, Sharded(bits.mesh, tuple(o[1] for o in outs))
    p = mode.profile
    syms = phy.modulate(bits, mode)  # [B, n_sym, sym_len]
    sig = syms.reshape(syms.shape[0], -1)
    ce = profile_tables(p, bits.device).header[2 * p.symbol_len :].expand(sig.shape[0], p.symbol_len)
    rx = awgn(torch.cat([ce, sig], dim=-1), snr_db, generator)
    ch_re, ch_im = phy.estimate_channel(rx[:, : p.symbol_len], p)
    out_bits = phy.demodulate(rx[:, p.symbol_len :].reshape(-1, n_sym, p.symbol_len), ch_re, ch_im, mode)
    ber = (out_bits.to(torch.float32) - bits.to(torch.float32)).abs().mean()
    return ber, out_bits


def pad_signals(signals: "list[np.ndarray]", pad_len: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Ragged signal list -> ([B, pad_len] float32, [B] int32 valid lengths);
    the padded length is rounded up to a multiple of 128, as in the JAX
    package, so both receive the same shapes."""
    n_valid = np.asarray([len(s) for s in signals], dtype=np.int32)
    t = int(pad_len or int(n_valid.max()))
    t = -(-t // 128) * 128
    out = np.zeros((len(signals), t), dtype=np.float32)
    for i, s in enumerate(signals):
        out[i, : len(s)] = s[:t]
    return out, n_valid


def shardmap_loopback_ber(bits: Sharded, seed: int, mode: ModemMode, n_sym: int, snr_db: float) -> torch.Tensor:
    """The loopback with its one collective written out: each shard runs
    TX -> AWGN -> RX -> local BER on its own device, with noise from its
    own generator seeded ``seed``, and the mean of the shards' BERs, taken
    on the mesh's first device, is the only cross-device traffic (the JAX
    package's shard_map with a pmean over the stream axis)."""
    return batch_loopback_step(bits, shard_generators(seed, bits.mesh), mode, n_sym, snr_db)[0]
