"""Structured logging (SURVEY §5 observability gap-fill).

The reference logs to a capped DOM list (addLog, app.js:1176-1185). Here a
standard :mod:`logging` logger named ``audio_modem_tpu_torch`` carries the same
events (frame decoded, chunk received, CRC error, transfer complete) with
structured ``extra`` fields; applications configure handlers as usual.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("audio_modem_tpu_torch")


def frame_decoded(kind: str, **fields) -> None:
    logger.info("frame decoded: %s %s", kind, fields, extra={"event": "frame", "kind": kind, **fields})


def frame_error(reason: str, **fields) -> None:
    logger.warning("frame error: %s %s", reason, fields, extra={"event": "frame_error", **fields})


def chunk_received(seq: int, total: int, **fields) -> None:
    logger.info("chunk %d/%d %s", seq + 1, total, fields, extra={"event": "chunk", "seq": seq, **fields})


def transfer_complete(file_name: str, size: int) -> None:
    logger.info("transfer complete: %s (%d bytes)", file_name, size, extra={"event": "complete"})
