"""Chunk assembler: bitmap + chunk store + file assembly (app.js:597-704;
counterpart of audio_modem_tpu/runtime/assembler.py, same sqlite schema, so a
database written by either package resumes in the other).

The reference persists chunks in IndexedDB but keeps the bitmap in memory and
clears the store on every new metadata frame, so a resume across restarts is
not actually supported (SURVEY §5). Here the store is sqlite (stdlib), the
bitmap is derivable from the store, and ``resume=True`` continues a transfer
across process restarts — a true checkpoint/resume upgrade. In-memory mode
(persist_path=None) matches the reference's lifetime semantics.
"""

from __future__ import annotations

import queue
import sqlite3
import threading

import numpy as np

from audio_modem_tpu_torch.framing import DataFrame, MetaFrame


class AsyncBatchWriter:
    """Background sqlite landing thread shared by many assemblers.

    executemany+commit is disk IO that would otherwise serialize onto the
    decode thread. sqlite3 releases the GIL during sqlite3_step, so moving the batch
    landings to one daemon thread overlaps them with host-side consume
    bookkeeping; a single FIFO queue + single thread preserves per-
    connection batch order. Durability is unchanged (same WAL +
    synchronous=NORMAL commits, just asynchronous); ``barrier()`` drains
    the queue and re-raises any writer-side error — every read, DDL, or
    main-thread use of a served connection calls it first, so
    read-your-writes holds exactly as before.

    The queue is bounded (default 256 batches of pinned row views):
    if the disk falls behind the decode, submit() blocks and the runtime
    degrades gracefully to disk speed instead of growing host memory with
    pinned packed-round matrices."""

    _SQL = "INSERT OR REPLACE INTO chunks VALUES (?, ?)"

    def __init__(self, max_batches: int = 256) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max_batches)
        self._err: BaseException | None = None
        self._t = threading.Thread(
            target=self._run, name="amt-sqlite-writer", daemon=True
        )
        self._t.start()

    def submit(self, conn: sqlite3.Connection, rows: list) -> None:
        self._q.put((conn, rows))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                conn, rows = item
                conn.executemany(self._SQL, rows)
                conn.commit()
            except BaseException as e:  # surfaced at the next barrier()
                self._err = e
            finally:
                self._q.task_done()

    def barrier(self) -> None:
        """Wait for every submitted batch to land; raise any writer error."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


class ChunkAssembler:
    def __init__(
        self,
        persist_path: str | None = None,
        resume: bool = False,
        writer: AsyncBatchWriter | None = None,
    ):
        self.total_chunks = 0
        self.total_file_size = 0
        self.chunk_size = 0
        self.file_name = ""
        self.received_count = 0
        self.crc_errors = 0
        self._bitmap: np.ndarray | None = None
        self._mem: dict[int, bytes] = {}
        self._db: sqlite3.Connection | None = None
        self._pending: list[tuple[int, bytes]] = []
        self._resume = resume
        self._writer = writer
        if persist_path is not None:
            # check_same_thread=False only when an AsyncBatchWriter serves
            # this connection; the barrier discipline (below) guarantees the
            # main thread never touches it while a batch is in flight
            self._db = sqlite3.connect(
                persist_path, check_same_thread=writer is None
            )
            # WAL + synchronous=NORMAL: group commits become O(memcpy) —
            # crash-consistent (WAL replays or truncates atomically; NORMAL
            # can only lose the tail commit on power loss, never corrupt).
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            # No mid-stream checkpoints: with the default autocheckpoint,
            # every ~4 MB of stored chunks forces a WAL->db copy INSIDE the
            # streaming loop. Checkpoints instead run at transfer boundaries
            # (handle_metadata) and cleanup(), so the WAL holds at most one
            # transfer's volume of pages — the same disk the chunks occupy.
            self._db.execute("PRAGMA wal_autocheckpoint=0")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS chunks (seq INTEGER PRIMARY KEY, data BLOB)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v TEXT)"
            )
            self._db.commit()
            if resume:
                self._load_meta()

    def _barrier(self) -> None:
        """Drain any in-flight async batches before the main thread reads,
        runs DDL, or otherwise touches the connection."""
        if self._writer is not None:
            self._writer.barrier()

    # ---- metadata ----

    def handle_metadata(self, meta: MetaFrame) -> None:
        """New transfer begins (app.js:610-626). With resume=True and matching
        metadata, previously stored chunks are kept."""
        same = (
            self._resume
            and self.total_chunks == meta.total_chunks
            and self.total_file_size == meta.total_file_size
            and self.chunk_size == meta.chunk_size
            and self.file_name == meta.file_name
        )
        self.total_chunks = meta.total_chunks
        self.total_file_size = meta.total_file_size
        self.chunk_size = meta.chunk_size
        self.file_name = meta.file_name
        if same and self._bitmap is not None:
            return
        self._bitmap = np.zeros(meta.total_chunks, dtype=bool)
        self.received_count = 0
        self.crc_errors = 0
        if self._db is not None:
            self._barrier()
            if same:
                self._rebuild_bitmap_from_db()
            else:
                self._pending.clear()  # buffered rows belong to the old transfer
                self._db.execute("DELETE FROM chunks")
            self._save_meta()
            # transfer boundary: fold the previous transfer's WAL back into
            # the db while the stream is idle (autocheckpoint is off)
            self._db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        else:
            self._mem.clear()

    def _save_meta(self) -> None:
        rows = [
            ("total_chunks", str(self.total_chunks)),
            ("total_file_size", str(self.total_file_size)),
            ("chunk_size", str(self.chunk_size)),
            ("file_name", self.file_name),
        ]
        self._db.executemany("INSERT OR REPLACE INTO meta VALUES (?, ?)", rows)
        self._db.commit()

    def _load_meta(self) -> None:
        rows = dict(self._db.execute("SELECT k, v FROM meta").fetchall())
        if "total_chunks" in rows:
            self.total_chunks = int(rows["total_chunks"])
            self.total_file_size = int(rows["total_file_size"])
            self.chunk_size = int(rows["chunk_size"])
            self.file_name = rows["file_name"]
            self._bitmap = np.zeros(self.total_chunks, dtype=bool)
            self._rebuild_bitmap_from_db()

    def _rebuild_bitmap_from_db(self) -> None:
        for (seq,) in self._db.execute("SELECT seq FROM chunks"):
            if 0 <= seq < self.total_chunks and not self._bitmap[seq]:
                self._bitmap[seq] = True
        self.received_count = int(self._bitmap.sum())

    # ---- chunks ----

    def handle_data_chunk(self, frame: DataFrame) -> bool:
        """Store a chunk (app.js:628-650). Returns True if newly stored.
        CRC failures are counted and NOT stored; duplicates suppressed."""
        if self._bitmap is None or frame.seq_num >= self.total_chunks:
            return False
        if not frame.crc_valid:
            self.crc_errors += 1
            return False
        if self._bitmap[frame.seq_num]:
            return False
        self._bitmap[frame.seq_num] = True
        self.received_count += 1
        if self._db is not None:
            if self._writer is not None:
                # never touch the connection inline while an async batch may
                # be in flight — defer through the same buffered-row path
                self._pending.append((frame.seq_num, frame.data))
            else:
                self._db.execute(
                    "INSERT OR REPLACE INTO chunks VALUES (?, ?)",
                    (frame.seq_num, frame.data),
                )
                self._db.commit()
        else:
            self._mem[frame.seq_num] = frame.data
        return True

    def store_valid_chunk(self, seq: int, data: "np.ndarray | bytes") -> bool:
        """Fast-path store of an already-CRC-validated chunk (BatchReceiver's
        vectorized consume): same routing as handle_data_chunk minus the
        DataFrame object. ``data`` may be a numpy row view — bytes only
        materialize when the chunk is newly stored (duplicates/overruns skip
        the copy).

        Durability is deferred: rows buffer on the host and land in sqlite
        as one executemany + commit per _FLUSH_ROWS batch (the per-round
        ``commit()`` is a no-op until the buffer fills), at the same
        synchronous=NORMAL durability as per-chunk commits. Reads
        flush the buffer first, so assemble()/_iter_chunks stay exact; a
        crash loses at most _FLUSH_ROWS chunks per stream, which resume
        re-reports as missing (same recovery story as the previous
        one-round deferral, just a wider window)."""
        if self._bitmap is None or seq >= self.total_chunks or self._bitmap[seq]:
            return False
        self._bitmap[seq] = True
        self.received_count += 1
        blob = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        if self._db is not None:
            self._pending.append((seq, blob))
        else:
            self._mem[seq] = blob
        return True

    def store_valid_chunks(self, seqs, rows, off: int, size: int) -> int:
        """Whole-round batch store (BatchReceiver's O(streams) consume fast
        path): ``rows`` is the uint8 [K, n_bytes] decoded-byte matrix of one
        turbo round, chunk k's payload at rows[k, off:off+size], all already
        CRC-validated by the vectorized classify pre-pass. In sqlite mode the
        buffered rows stay ZERO-COPY numpy views (sqlite binds any
        C-contiguous buffer as a BLOB), pinning at most
        _FLUSH_ROWS x row_bytes of packed round matrices per stream until
        the async writer lands them; in-memory mode copies (views would pin
        every round for the transfer's lifetime). Returns newly stored count."""
        bm = self._bitmap
        if bm is None:
            return 0
        total, stored = self.total_chunks, 0
        db = self._db is not None
        pend = self._pending
        for k in range(len(seqs)):
            q = int(seqs[k])
            if q >= total or bm[q]:
                continue
            bm[q] = True
            stored += 1
            if db:
                pend.append((q, rows[k, off : off + size]))
            else:
                self._mem[q] = rows[k, off : off + size].tobytes()
        self.received_count += stored
        return stored

    _FLUSH_ROWS = 256  # pending fast-path rows per executemany+commit batch

    def commit(self, force: bool = False) -> None:
        """Flush deferred fast-path stores once enough buffered (or forced).
        With an AsyncBatchWriter the executemany+commit runs on the writer
        thread (off the consume critical path); otherwise inline."""
        if self._db is not None and self._pending and (
            force or len(self._pending) >= self._FLUSH_ROWS
        ):
            if self._writer is not None:
                self._writer.submit(self._db, self._pending)
                self._pending = []
            else:
                self._db.executemany(
                    "INSERT OR REPLACE INTO chunks VALUES (?, ?)", self._pending
                )
                self._pending.clear()
                self._db.commit()

    def is_received(self, seq: int) -> bool:
        return self._bitmap is not None and bool(self._bitmap[seq])

    @property
    def is_complete(self) -> bool:
        return self.total_chunks > 0 and self.received_count == self.total_chunks

    def missing_chunks(self) -> list[int]:
        """Missing-chunk report for out-of-band retransmission requests
        (app.js:659-665)."""
        if self._bitmap is None:
            return list(range(self.total_chunks))
        return [int(i) for i in np.nonzero(~self._bitmap)[0]]

    def bitmap(self) -> np.ndarray:
        """Copy of the received bitmap (chunk-bitmap UI analog)."""
        return self._bitmap.copy() if self._bitmap is not None else np.zeros(0, bool)

    def assemble(self) -> bytes:
        """Assemble whatever has been received into the file-sized buffer
        (missing chunks stay zero), like assembleFile (app.js:667-687)."""
        out = bytearray(self.total_file_size)
        for seq, data in self._iter_chunks():
            off = seq * self.chunk_size
            out[off : off + len(data)] = data
        return bytes(out[: self.total_file_size])

    def assemble_to_file(self, path: str) -> int:
        """Stream-assemble to disk in O(chunk) memory — the reference claims
        O(chunkSize) on both sides (README_en.md:61) but its assembleFile
        materializes the whole file; this delivers it for 500MB-class
        transfers. Missing chunks stay zero-filled. Returns bytes written."""
        with open(path, "wb") as f:
            f.truncate(self.total_file_size)
            for seq, data in self._iter_chunks():
                off = seq * self.chunk_size
                if off >= self.total_file_size:
                    continue
                f.seek(off)
                f.write(data[: self.total_file_size - off])
        return self.total_file_size

    def _iter_chunks(self):
        if self._db is not None:
            self.commit(force=True)  # buffered fast-path rows must be visible
            self._barrier()
            yield from self._db.execute("SELECT seq, data FROM chunks ORDER BY seq")
        else:
            yield from sorted(self._mem.items())

    def cleanup(self) -> None:
        if self._db is not None:
            self.commit(force=True)
            self._barrier()
            self._db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            self._db.close()
            self._db = None
