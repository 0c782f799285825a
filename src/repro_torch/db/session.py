"""`BitmapDB` — the schema-aware session object over the engine (the port's
twin of ``repro.db.session``, in-memory half).

One object owns:

  * **ingest** — :meth:`ingest` / :meth:`append` encode structured rows
    through the :class:`repro_torch.db.Schema` and stream them into a
    :class:`repro_torch.engine.runtime.StreamingIndexer`;
    :meth:`append_encoded` takes pre-encoded key-word records directly.
  * **query** — :meth:`query` / :meth:`query_many` accept DSL expressions
    (``col("city") == "SF"``), raw engine predicates (``key(3) & ~key(5)``)
    or pre-built plans; planning caches per expression, plans order their
    DNF clauses by the session's live per-key selectivity stats, and
    execution runs through the engine's bucketed batch executors.  Results
    come back as lazy :class:`repro_torch.db.Result` handles.
  * **serving** — :meth:`serve_step` wraps the bucketed batch executor as
    a raw ``(rows, counts)`` step function.

The session lives on ``device`` (default ``"cuda"``; it raises when no GPU
is present unless the caller asks for ``"cpu"``), and ``backend="auto"``
resolves by that device.  Durability (``path=``, :meth:`open`,
:meth:`snapshot`), :meth:`explain` and :meth:`serve` wait for later slices
and raise :class:`NotImplementedError` naming the ROADMAP item.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.db import expr as expr_mod
from repro_torch.db.result import LazyBatch, Result, ResultBatch
from repro_torch.db.schema import Schema
from repro_torch.engine import backends, batch as engine_batch, planner, policy
from repro_torch.engine.runtime import StreamingIndexer


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def include_exclude_pred(include: Sequence[int] = (),
                         exclude: Sequence[int] = ()) -> planner.Pred:
    """Deprecation shim for the legacy ``include=``/``exclude=`` call
    surface: AND of positive/negated key-row literals."""
    if include or exclude:
        warnings.warn(
            "include=/exclude= key lists are deprecated; use a repro_torch.db "
            "expression (col(...) == value) or an engine predicate "
            "(key(i) & ~key(j))", DeprecationWarning, stacklevel=3)
    return planner.from_include_exclude(include, exclude)


def _popcounts(packed: torch.Tensor) -> np.ndarray:
    """Exact per-key set-bit counts of a packed (M, W) tensor, counted on
    its device; only the (M,) counts come to the host."""
    return (policy.popcount(packed).sum(dim=1, dtype=torch.int64)
            .cpu().numpy())


class BitmapDB:
    """One in-memory bitmap-index database session (see module docstring)."""

    def __init__(self, schema: Schema | None = None, *,
                 num_keys: int | None = None, path: str | None = None,
                 backend: str = "auto", capacity_words: int = 16,
                 device="cuda"):
        if path is not None:
            _later("BitmapDB(path=...) durability", "A4")
        if schema is None and num_keys is None:
            raise ValueError("BitmapDB needs a Schema (or num_keys= for a "
                             "raw key-addressed session)")
        if schema is not None and num_keys is not None \
                and num_keys != schema.num_keys:
            raise ValueError(f"num_keys={num_keys} contradicts the schema "
                             f"({schema.num_keys} keys)")
        self.schema = schema
        self.device = policy.resolve_device(device)
        self.backend = backends.resolve_backend(backend, self.device)
        m = schema.num_keys if schema is not None else int(num_keys)
        self._keys = torch.arange(m, dtype=torch.int32, device=self.device)
        self._index = None                     # read-only sessions only
        self._counts = np.zeros((m,), np.int64)
        self._plans: dict = {}
        self._plans_by_id: dict = {}       # id(expr) fast path (see _plan_for)
        self._cache_counters = dict.fromkeys(
            ("id_hits", "value_hits", "misses", "id_evictions",
             "value_evictions"), 0)
        self._stats_cache: tuple[int, planner.KeyStats] | None = None
        self._view_cache = None            # (buf, n, BitmapIndex) snapshot
        self._si = StreamingIndexer(self._keys, backend=self.backend,
                                    capacity_words=capacity_words,
                                    device=self.device)

    # ------------------------------------------------------------ open/wrap
    @classmethod
    def open(cls, path: str, *args, **kwargs) -> "BitmapDB":
        _later("BitmapDB.open", "A4")

    @classmethod
    def from_index(cls, index: policy.BitmapIndex,
                   schema: Schema | None = None, *,
                   backend: str = "auto") -> "BitmapDB":
        """Wrap an in-memory :class:`repro_torch.engine.policy.BitmapIndex`
        as a READ-ONLY query session on the index's device.  Appends raise;
        stats come from exact popcounts on first use."""
        m = int(index.num_keys)
        if schema is not None and schema.num_keys != m:
            raise ValueError(f"index has {m} key rows but the schema "
                             f"defines {schema.num_keys}")
        db = cls(schema, num_keys=m if schema is None else None,
                 backend=backend, device=index.device)
        db._si = None
        db._index = index
        db._counts = None                  # lazily popcounted
        return db

    # ----------------------------------------------------------- properties
    @property
    def num_keys(self) -> int:
        return int(self._keys.shape[0])

    @property
    def num_records(self) -> int:
        if self._si is not None:
            return self._si.num_records
        return int(self._index.num_records)

    @property
    def index(self) -> policy.BitmapIndex:
        """The live contiguous index (a view of the capacity buffer)."""
        if self._si is not None:
            return self._si.index
        return self._index

    @property
    def indexer(self) -> StreamingIndexer | None:
        """The live streaming indexer (None for read-only sessions)."""
        return self._si

    @property
    def stats(self) -> planner.KeyStats:
        """Live per-key set-bit counts (exact) as planner cardinality
        estimates."""
        if self._counts is None:           # read-only: popcount on demand
            self._counts = _popcounts(self._index.packed)
        n = self.num_records
        if self._stats_cache is None or self._stats_cache[0] != n:
            self._stats_cache = (n, planner.KeyStats(
                tuple(int(c) for c in self._counts), n))
        return self._stats_cache[1]

    # --------------------------------------------------------------- ingest
    def ingest(self, rows) -> int:
        """Bulk-load structured rows (see :meth:`Schema.encode` for accepted
        shapes); returns the new total record count."""
        return self.append(rows)

    def append(self, rows) -> int:
        """Stream structured rows into the live index."""
        if self.schema is None:
            raise ValueError("this session has no Schema; use "
                             "append_encoded with raw key-word records")
        return self.append_encoded(self.schema.encode(rows))

    def append_encoded(self, records) -> int:
        """Stream pre-encoded key-word records (N, W) (a tensor or numpy
        array of any integer dtype; it moves to the session's device first
        and is cast to int32 there): each word is a global key id (words
        outside [0, num_keys) match no key)."""
        if self._si is None:
            raise RuntimeError("read-only session (from_index) — open a "
                               "BitmapDB with a schema/num_keys to ingest")
        records = torch.as_tensor(records).to(self.device).to(torch.int32)
        if records.ndim != 2:
            raise ValueError(f"records must be (N, W), got "
                             f"{tuple(records.shape)}")
        if records.shape[0]:
            block = backends.get_backend(self.backend).create_index(
                records, self._keys)
            self._si.append_indexed(records, block)
            self._counts += _popcounts(block)
        return self.num_records

    def snapshot(self) -> None:
        _later("BitmapDB.snapshot", "A4")

    # ---------------------------------------------------------------- query
    #: cache entries above this are dropped wholesale
    _ID_CACHE_LIMIT = 65536
    _VALUE_CACHE_LIMIT = 65536

    def _plan_for(self, q):
        # an identity hit skips even the value-hash of a nested tree;
        # entries keep a strong reference to the query, so a cached id can
        # never be a recycled object's
        c = self._cache_counters
        hit = self._plans_by_id.get(id(q))
        if hit is not None:
            c["id_hits"] += 1
            return hit[1]
        if isinstance(q, (planner.QueryPlan, planner.FactoredPlan,
                          planner.CompositePlan)):
            return q
        pl = self._plans.get(q)
        if pl is None:
            c["misses"] += 1
            pred = expr_mod.lower(q, self.schema)
            planner.check_key_range(planner.key_indices(pred),
                                    self.num_keys)
            stats = self.stats if self._counts is not None else None
            pl = planner.plan(pred, stats=stats)
            if len(self._plans) >= self._VALUE_CACHE_LIMIT:
                c["value_evictions"] += len(self._plans)
                self._plans.clear()
            self._plans[q] = pl
        else:
            c["value_hits"] += 1
        if len(self._plans_by_id) >= self._ID_CACHE_LIMIT:
            c["id_evictions"] += len(self._plans_by_id)
            self._plans_by_id.clear()
        self._plans_by_id[id(q)] = (q, pl)
        return pl

    def cache_stats(self) -> dict:
        """Plan-cache health: hit/miss/eviction counters plus the live sizes
        of the identity-keyed and value-keyed caches."""
        out = dict(self._cache_counters)
        out["id_size"] = len(self._plans_by_id)
        out["value_size"] = len(self._plans)
        return out

    def replan(self) -> None:
        """Drop the per-expression plan cache so future queries re-order
        their clauses against the CURRENT selectivity stats."""
        self._plans.clear()
        self._plans_by_id.clear()
        self._stats_cache = None

    def _view(self) -> policy.BitmapIndex:
        """Immutable snapshot the lazy batch executes against — a query
        sees the db as of query() time even if materialized after later
        appends (splices are functional, so the captured buffer never
        changes).  Cached per (buffer, record count)."""
        if self._si is None:
            return self._index
        buf, n = self._si.view()           # consistent under appends
        c = self._view_cache
        if c is not None and c[0] is buf and c[1] == n:
            return c[2]
        idx = policy.BitmapIndex(buf[:, :policy.num_words(n)], n)
        self._view_cache = (buf, n, idx)
        return idx

    def query(self, q) -> Result:
        """One expression / predicate / plan -> a lazy :class:`Result`."""
        return self.query_many([q])[0]

    def explain(self, q) -> dict:
        _later("BitmapDB.explain (needs the cost model)", "A5")

    def query_many(self, queries: Sequence, *, pad_output: bool = False,
                   backend: str | None = None) -> ResultBatch:
        """A batch of expressions in ONE lazily executed bucketed dispatch
        set; returns a :class:`ResultBatch` in input order.
        ``pad_output=True`` pads the materialized tensors' query axis to a
        power of two; ``backend=`` overrides the session backend for this
        one batch."""
        if not isinstance(queries, (list, tuple)):
            queries = list(queries)
        byid = self._plans_by_id
        plans = []
        fast_hits = 0
        for q in queries:
            hit = byid.get(id(q))
            if hit is not None:
                fast_hits += 1
                plans.append(hit[1])
            else:
                plans.append(self._plan_for(q))
        self._cache_counters["id_hits"] += fast_hits
        view = self._view()
        be = self.backend if backend is None else backend
        batch_run = LazyBatch(lambda: engine_batch.execute_many(
            view.packed, plans, num_records=view.num_records, backend=be,
            pad_output=pad_output))
        return ResultBatch(batch_run, view.num_records, queries)

    def serve_step(self):
        """The bucketed batch executor as a serving-loop step function:
        ``step(queries) -> (rows (Q, Nw) int32, counts (Q,) int32)``,
        eager, in request order."""
        def query_step(queries: Sequence):
            return self.query_many(queries).materialize()
        return query_step

    def serve(self, **config):
        _later("BitmapDB.serve (the async service)", "A6")

    def __repr__(self) -> str:
        mode = "live" if self._si is not None else "read-only"
        sch = self.schema or f"{self.num_keys} raw keys"
        return (f"<BitmapDB {mode} {sch} records={self.num_records} "
                f"backend={self.backend} device={self.device}>")
