"""Batched multi-stream decode, the turbo receive round, and their
sharding over a mesh of devices along the stream axis (counterpart of
audio_modem_tpu/parallel).

Streams are independent, so the stream batch is the one parallel axis:
each device owns a contiguous slab of streams end to end and the only
cross-device traffic is the result (the packed rows a receiver fetches,
a loopback's BER). ``multihost`` runs the same sharded step across
processes on ``torch.distributed``.
"""

from audio_modem_tpu_torch.parallel.mesh import make_mesh, shard_batch
from audio_modem_tpu_torch.parallel.batch import (
    batch_decode_chunk_frames,
    batch_decode_signals,
    batch_loopback_step,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "batch_decode_chunk_frames",
    "batch_decode_signals",
    "batch_loopback_step",
]
