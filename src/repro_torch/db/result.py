"""Lazy query-result handles (the port's twin of ``repro.db.result``).

``BitmapDB.query`` / ``query_many`` return :class:`Result` handles instead
of raw tensors: nothing executes until the first ``.rows`` / ``.count`` /
``.ids`` access, and every result of one ``query_many`` batch shares a
single :class:`LazyBatch` — the first materialization runs the WHOLE batch
through the engine's bucketed executors.  Rows are int32 tensors on the
session's device carrying the reference's uint32 bits; ``.ids`` copies one
row to the host.
"""
from __future__ import annotations

from collections.abc import Sequence
from typing import Callable

import numpy as np


def unpack_ids(row_bits: np.ndarray, num_records: int) -> np.ndarray:
    """Matching record ordinals (sorted) of ONE packed result row (numpy
    32-bit words)."""
    if row_bits.size == 0:
        return np.empty((0,), np.int64)
    ids = np.flatnonzero(
        np.unpackbits(np.ascontiguousarray(row_bits).view(np.uint8),
                      bitorder="little"))
    # tail bits are masked zero by the engine, but guard anyway
    return ids[ids < num_records]


class LazyBatch:
    """One deferred batched execution shared by a set of results."""

    def __init__(self, run: Callable[[], tuple]):
        self._run = run
        self._out: tuple | None = None

    @property
    def executed(self) -> bool:
        return self._out is not None

    def materialize(self) -> tuple:
        """(rows (Q, Nw) int32, counts (Q,) int32) — runs once, then serves
        the cached device tensors."""
        if self._out is None:
            self._out = self._run()
        return self._out


class Result:
    """Handle to one query's slice of a (lazily executed) batch.

    * ``.rows``  — the packed int32 result bitmap (``ceil(N/32)`` words,
      one bit per record, tail bits zero);
    * ``.count`` — matching-record count (int);
    * ``.ids``   — matching record ordinals as a sorted ``np.ndarray``.
    """

    __slots__ = ("_batch", "_qi", "_num_records", "_query")

    def __init__(self, batch: LazyBatch, qi: int, num_records: int,
                 query=None):
        self._batch = batch
        self._qi = qi
        self._num_records = num_records
        self._query = query

    @property
    def rows(self):
        return self._batch.materialize()[0][self._qi]

    @property
    def count(self) -> int:
        return int(self._batch.materialize()[1][self._qi])

    @property
    def raw(self) -> tuple:
        """(packed row, count) as the engine's tensors."""
        rows, counts = self._batch.materialize()
        return rows[self._qi], counts[self._qi]

    @property
    def ids(self) -> np.ndarray:
        return unpack_ids(self.rows.cpu().numpy(), self._num_records)

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    def __repr__(self) -> str:
        state = (f"count={self.count}" if self._batch.executed
                 else "pending")
        label = repr(self._query) if self._query is not None else ""
        if len(label) > 60:
            label = label[:57] + "..."
        q = f" {label}" if label else ""
        return f"<Result{q} {state} of {self._num_records} records>"


class ResultBatch(Sequence):
    """The sequence ``query_many`` returns: one shared :class:`LazyBatch`,
    with :class:`Result` handles constructed lazily per index."""

    __slots__ = ("_batch", "_num_records", "_queries")

    def __init__(self, batch: LazyBatch, num_records: int, queries):
        self._batch = batch
        self._num_records = num_records
        self._queries = queries

    def __len__(self) -> int:
        return len(self._queries)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if not -len(self._queries) <= i < len(self._queries):
            raise IndexError(i)
        i = i % len(self._queries)
        return Result(self._batch, i, self._num_records,
                      query=self._queries[i])

    def materialize(self) -> tuple:
        """Force execution; returns the raw (rows (Q, Nw), counts (Q,))."""
        return self._batch.materialize()

    def all_ids(self) -> list[np.ndarray]:
        """Matching record ordinals for EVERY query, in ONE device-to-host
        transfer of the whole (Q, Nw) rows tensor."""
        rows, _ = self._batch.materialize()
        bits = rows.cpu().numpy()              # one bulk transfer
        n = self._num_records
        if bits.size == 0:
            return [np.empty((0,), np.int64) for _ in self._queries]
        # iterate the queries, not the rows — a pad_output batch carries
        # extra unspecified rows past the real query count
        return [unpack_ids(bits[qi], n) for qi in range(len(self._queries))]

    def __repr__(self) -> str:
        state = "executed" if self._batch.executed else "pending"
        return (f"<ResultBatch of {len(self)} queries ({state}) over "
                f"{self._num_records} records>")
