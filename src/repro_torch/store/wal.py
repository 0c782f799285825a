"""Write-ahead block log for streaming index appends.

Every record block appended to a store-attached ``StreamingIndexer`` is
logged here *before* it is spliced into the in-memory packed index, so a
crash between appends loses nothing: recovery re-indexes the logged blocks
deterministically (the engine backends are pure functions of their inputs)
and splices them onto the last durable segment, reproducing the in-memory
index bit for bit.

The log is generation-numbered (``wal-<gen>.log``).  When a segment flush
makes a prefix of the stream durable, the manifest commit switches to the
next generation and the old log becomes garbage — entries are never
rewritten in place.  Each entry carries the absolute record offset of its
block (``start``), so replay can also skip any block a committed segment
already covers (the crash-between-flush-and-rotate window).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.fault import seam
from repro_torch.obs import metrics as obs_metrics
from repro_torch.store import format as fmt

# WAL traffic meters live in the process-wide registry (logs are opened
# and handed across rotations; per-handle registries would lose counts)
_APPENDS = obs_metrics.GLOBAL.counter(
    "wal_appends_total", "framed block appends acked durable")
_BYTES = obs_metrics.GLOBAL.counter(
    "wal_bytes_total", "record payload bytes appended")
_ROTATIONS = obs_metrics.GLOBAL.counter(
    "wal_rotations_total", "fresh generations created by rotation")


def wal_path(root: str, generation: int) -> str:
    return os.path.join(root, f"wal-{generation:08d}.log")


class WriteAheadLog:
    """Append-only block log, one open generation at a time."""

    def __init__(self, path: str):
        self.path = path
        intact = fmt.intact_log_length(path)
        if intact == 0:
            self._f = open(path, "wb")       # fresh (or headerless) log
            fmt.write_log_header(self._f)
            # make the directory entry durable too: without this a crash
            # could drop the whole file, silently erasing every
            # acknowledged block logged since the last segment
            fmt.fsync_dir(os.path.dirname(path) or ".")
            return
        # drop any torn/corrupt tail BEFORE appending — entries written
        # after a torn frame would be unreachable to every reader
        self._f = open(path, "r+b")
        if os.path.getsize(path) > intact:
            self._f.truncate(intact)
        self._f.seek(intact)

    @classmethod
    def create(cls, path: str) -> "WriteAheadLog":
        """Open ``path`` as a FRESH generation, truncating any leftover
        bytes.  Rotation uses this instead of ``__init__``: a crash after
        a rotation pre-wrote the next generation but before its manifest
        swap leaves a stale file whose intact entries must NOT survive
        into the generation's real lifetime."""
        wal = cls.__new__(cls)
        wal.path = path
        wal._f = open(path, "wb")
        fmt.write_log_header(wal._f)
        fmt.fsync_dir(os.path.dirname(path) or ".")
        _ROTATIONS.inc()
        return wal

    def append_block(self, records: np.ndarray, start: int,
                     tick: int | None = None) -> None:
        """Durably log a record block whose first record has absolute
        offset ``start`` in the stream.  ``tick`` optionally stamps the
        workload tick that produced the block (the replay-idempotence
        watermark — see ``MulticoreRuntime.run_tick(tick_id=)``).

        On ANY append failure (full disk, torn frame, failed fsync) the
        handle rewinds to the last intact frame boundary before the
        error propagates: the failed entry is not durable and the caller
        knows it, but the NEXT append lands reachable — without the
        rewind, bytes written after a torn frame would be silently lost
        to every reader even though their appends "succeeded"."""
        records = np.ascontiguousarray(records)
        seam.fire("wal.append", path=self.path, start=int(start),
                  size=records.nbytes)
        meta = {"start": int(start), "dtype": str(records.dtype),
                "shape": list(records.shape)}
        if tick is not None:
            meta["tick"] = int(tick)
        pos = self._f.tell()
        try:
            fmt.append_log_entry(self._f, meta, records.tobytes())
        except BaseException:
            try:
                self._f.truncate(pos)
                self._f.seek(pos)
            except OSError:
                pass            # reopen-time truncation still covers it
            raise
        _APPENDS.inc()
        _BYTES.add(records.nbytes)

    def close(self) -> None:
        self._f.close()


def replay(path: str) -> list[tuple[int, np.ndarray, int | None]]:
    """All intact (start, records, tick) entries of a log, in append
    order.  Torn/corrupt tails (crash mid-append) are dropped, not
    raised."""
    return replay_from(path, 8)[0]


def replay_from(path: str, offset: int
                ) -> tuple[list[tuple[int, np.ndarray, int | None]], int]:
    """Intact (start, records, tick) entries from byte ``offset``
    onward, plus the byte offset one past the last intact frame — so a
    rotation can bulk-copy a live log outside the store lock and then
    catch only the raced tail under it."""
    out = []
    end = offset
    for meta, payload, end in fmt.read_log_entries_from(path, offset):
        arr = np.frombuffer(payload, dtype=np.dtype(meta["dtype"]))
        out.append((meta["start"], arr.reshape(meta["shape"]),
                    meta.get("tick")))
    return out, end
