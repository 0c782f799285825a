"""`BitmapDB` — the schema-aware session object over engine + store (the
port's twin of ``repro.db.session``).

One object owns:

  * **ingest** — :meth:`ingest` / :meth:`append` encode structured rows
    through the :class:`repro_torch.db.Schema` and stream them into a
    :class:`repro_torch.engine.runtime.StreamingIndexer`;
    :meth:`append_encoded` takes pre-encoded key-word records directly.
  * **durability** — opened with ``path=``, every append is WAL-logged
    (int32, cast from the caller's host array) before the in-memory splice
    and the tail auto-spills as immutable segments past ``spill_records``
    (:mod:`repro_torch.store`); :meth:`snapshot` force-spills, and
    :func:`BitmapDB.open` recovers a crashed session bit-identically from
    manifest + WAL (the schema persists as ``SCHEMA.json`` next to the
    segments).  The on-disk formats are the reference's: a store written
    by either package opens in the other.
  * **query** — :meth:`query` / :meth:`query_many` accept DSL expressions
    (``col("city") == "SF"``), raw engine predicates (``key(3) & ~key(5)``)
    or pre-built plans; planning caches per expression, plans order their
    DNF clauses by the session's live per-key selectivity stats, and
    execution runs through the engine's bucketed batch executors.  Results
    come back as lazy :class:`repro_torch.db.Result` handles.
  * **serving** — :meth:`serve_step` wraps the bucketed batch executor as
    a raw ``(rows, counts)`` step function.

Read-only sessions wrap an existing index: :meth:`BitmapDB.from_index`
accepts an in-memory :class:`repro_torch.engine.policy.BitmapIndex` or a
segment-backed :class:`repro_torch.store.StoredIndex` (served
segment-parallel, stacked into one launch per bucket when word counts are
uniform).

The session lives on ``device`` (default ``"cuda"``; it raises when no GPU
is present unless the caller asks for ``"cpu"``), and ``backend="auto"``
resolves by that device.  :meth:`explain` and :meth:`serve` wait for later
slices and raise :class:`NotImplementedError` naming the ROADMAP item.
"""
from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.db import expr as expr_mod
from repro_torch.db.result import LazyBatch, Result, ResultBatch
from repro_torch.db.schema import Schema
from repro_torch.engine import backends, batch as engine_batch, planner, policy
from repro_torch.engine.runtime import StreamingIndexer
from repro_torch.obs import metrics as obs_metrics

SCHEMA_FILE = "SCHEMA.json"


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
    """One bitmap-index database session (see module docstring)."""

    def __init__(self, schema: Schema | None = None, *,
                 num_keys: int | None = None, path: str | None = None,
                 backend: str = "auto", spill_records: int | None = 4096,
                 capacity_words: int = 16, device="cuda",
                 _restore: bool = False):
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
        self.path = path
        m = schema.num_keys if schema is not None else int(num_keys)
        self._keys = torch.arange(m, dtype=torch.int32, device=self.device)
        self._index = None                     # read-only sessions only
        self._counts = np.zeros((m,), np.int64)
        self._plans: dict = {}
        self._plans_by_id: dict = {}       # id(expr) fast path (see _plan_for)
        # typed counters in a per-session registry; cache_stats() is a
        # view over these
        self.registry = obs_metrics.Registry()
        self._cache_counters = {
            k: self.registry.counter(f"plan_cache_{k}_total")
            for k in ("id_hits", "value_hits", "misses",
                      "id_evictions", "value_evictions")}
        self._stats_cache: tuple[int, planner.KeyStats] | None = None
        self._view_cache = None            # (buf, n, BitmapIndex) snapshot
        if path is None:
            self._si = StreamingIndexer(self._keys, backend=self.backend,
                                        capacity_words=capacity_words,
                                        device=self.device)
            return
        from repro_torch.store import SegmentStore
        store = SegmentStore(path)
        self._persist_schema(path)
        if _restore:
            self._si = StreamingIndexer.restore(
                store, self._keys, backend=self.backend,
                capacity_words=capacity_words, flush_records=spill_records,
                device=self.device)
            self._counts = _popcounts(self._si.index.packed)
            return
        self._si = StreamingIndexer(self._keys, backend=self.backend,
                                    capacity_words=capacity_words,
                                    device=self.device)
        try:
            self._si.attach_store(store, flush_records=spill_records)
        except ValueError as e:
            raise ValueError(
                f"{path} already holds a durable index; resume it with "
                f"repro_torch.db.open({path!r}) instead of "
                "BitmapDB(path=...)") from e

    # ------------------------------------------------------------ open/wrap
    @classmethod
    def open(cls, path: str, schema: Schema | None = None, *,
             num_keys: int | None = None, backend: str = "auto",
             spill_records: int | None = 4096,
             capacity_words: int = 16, device="cuda") -> "BitmapDB":
        """Recover a durable session from ``path`` on ``device``: committed
        segments + surviving WAL blocks (re-indexed there) replay into a
        live index bit-identical to the pre-crash one, with per-key stats
        recounted exactly from the recovered packed rows.  The schema is
        loaded from the persisted ``SCHEMA.json`` when not given (and
        verified against it when it is); ``num_keys=`` opens a raw
        key-addressed store that never had one."""
        sf = os.path.join(path, SCHEMA_FILE)
        if schema is None and os.path.exists(sf):
            with open(sf) as f:           # noqa: PLW1514 (ascii json)
                schema = Schema.from_json(f.read())
        if schema is None and num_keys is None:
            raise FileNotFoundError(
                f"{sf} not found — pass schema= or num_keys= to open a "
                "store created without a persisted schema")
        return cls(schema, num_keys=None if schema is not None else num_keys,
                   path=path, backend=backend, spill_records=spill_records,
                   capacity_words=capacity_words, device=device,
                   _restore=True)

    @classmethod
    def from_index(cls, index, schema: Schema | None = None, *,
                   backend: str = "auto") -> "BitmapDB":
        """Wrap an existing index as a READ-ONLY query session on the
        index's device: an in-memory
        :class:`repro_torch.engine.policy.BitmapIndex` or a segment-backed
        :class:`repro_torch.store.StoredIndex` (served segment-parallel).
        Appends raise; stats come from exact popcounts on first use."""
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
        """The live contiguous index (a view of the capacity buffer;
        read-only StoredIndex sessions stay segment-parallel — materialize
        explicitly if you must)."""
        if self._si is not None:
            return self._si.index
        if isinstance(self._index, policy.BitmapIndex):
            return self._index
        raise TypeError(
            "this session serves a segment-backed StoredIndex; use "
            "query()/query_many(), or index.to_bitmap_index() to "
            "materialize")

    @property
    def store(self):
        """The attached :class:`repro_torch.store.SegmentStore` (None for
        in-memory and read-only sessions)."""
        return self._si.store if self._si is not None else None

    @property
    def indexer(self) -> StreamingIndexer | None:
        """The live streaming indexer (None for read-only sessions) — the
        hook point a maintenance executor uses to move spills off the
        append path (``set_spill_hook``)."""
        return self._si

    @property
    def stats(self) -> planner.KeyStats:
        """Live per-key set-bit counts (exact) as planner cardinality
        estimates."""
        if self._counts is None:           # read-only: popcount on demand
            idx = self._index
            if hasattr(idx, "parts"):      # StoredIndex
                c = np.zeros((self.num_keys,), np.int64)
                for part, _ in idx.parts:
                    c += _popcounts(part)
                self._counts = c
            else:
                self._counts = _popcounts(idx.packed)
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
        """Stream structured rows into the live index (auto-spilling past
        the ``spill_records`` threshold when opened with ``path=``)."""
        if self.schema is None:
            raise ValueError("this session has no Schema; use "
                             "append_encoded with raw key-word records")
        return self.append_encoded(self.schema.encode(rows))

    def append_encoded(self, records) -> int:
        """Stream pre-encoded key-word records (N, W) (a tensor or numpy
        array of any integer dtype; it moves to the session's device first
        and is cast to int32 there): each word is a global key id (words
        outside [0, num_keys) match no key).  A durable session WAL-logs the
        caller's array as given (cast to int32 on the host when it lives
        there)."""
        if self._si is None:
            raise RuntimeError("read-only session (from_index) — open a "
                               "BitmapDB with a schema/path to ingest")
        if not isinstance(records, torch.Tensor):
            records = np.asarray(records)
        if records.ndim != 2:
            raise ValueError(f"records must be (N, W), got "
                             f"{tuple(records.shape)}")
        if records.shape[0]:
            on_card = torch.as_tensor(records).to(self.device).to(torch.int32)
            block = backends.get_backend(self.backend).create_index(
                on_card, self._keys)
            self._si.append_indexed(records, block)
            self._counts += _popcounts(block)
        return self.num_records

    # ----------------------------------------------------------- durability
    def snapshot(self) -> None:
        """Force-spill the in-memory tail as an immutable segment (atomic
        manifest commit); a no-op when nothing new arrived."""
        if self._si is None or self._si.store is None:
            raise RuntimeError("no store attached — open the BitmapDB "
                               "with path= to make it durable")
        self._si.spill()

    def _persist_schema(self, path: str) -> None:
        if self.schema is None:
            return
        from repro_torch.store import format as fmt
        os.makedirs(path, exist_ok=True)
        sf = os.path.join(path, SCHEMA_FILE)
        if os.path.exists(sf):
            with open(sf) as f:
                stored = Schema.from_json(f.read())
            if stored != self.schema:
                raise ValueError(
                    f"{path} was created with a different schema "
                    f"({stored!r}); one store persists ONE schema")
        else:
            fmt.write_bytes_atomic(sf, self.schema.to_json().encode())

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
            c["id_hits"].inc()
            return hit[1]
        if isinstance(q, (planner.QueryPlan, planner.FactoredPlan,
                          planner.CompositePlan)):
            return q
        pl = self._plans.get(q)
        if pl is None:
            c["misses"].inc()
            pred = expr_mod.lower(q, self.schema)
            planner.check_key_range(planner.key_indices(pred),
                                    self.num_keys)
            stats = self.stats if self._counts is not None else None
            pl = planner.plan(pred, stats=stats)
            if len(self._plans) >= self._VALUE_CACHE_LIMIT:
                c["value_evictions"].add(len(self._plans))
                self._plans.clear()
            self._plans[q] = pl
        else:
            c["value_hits"].inc()
        if len(self._plans_by_id) >= self._ID_CACHE_LIMIT:
            c["id_evictions"].add(len(self._plans_by_id))
            self._plans_by_id.clear()
        self._plans_by_id[id(q)] = (q, pl)
        return pl

    def cache_stats(self) -> dict:
        """Plan-cache health: hit/miss/eviction counters plus the live sizes
        of the identity-keyed and value-keyed caches."""
        out = {k: c.value for k, c in self._cache_counters.items()}
        out["id_size"] = len(self._plans_by_id)
        out["value_size"] = len(self._plans)
        return out

    def replan(self) -> None:
        """Drop the per-expression plan cache so future queries re-order
        their clauses against the CURRENT selectivity stats."""
        self._plans.clear()
        self._plans_by_id.clear()
        self._stats_cache = None

    @staticmethod
    def _execute(plans: Sequence, view, pad_output: bool, backend: str
                 ) -> tuple:
        if hasattr(view, "parts"):              # StoredIndex
            return engine_batch.execute_many_segments(
                view.parts, plans, backend=backend, device=view.device)
        return engine_batch.execute_many(
            view.packed, plans, num_records=view.num_records,
            backend=backend, pad_output=pad_output)

    def _view(self):
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
        if fast_hits:
            self._cache_counters["id_hits"].add(fast_hits)
        view = self._view()
        be = self.backend if backend is None else backend
        batch_run = LazyBatch(lambda: self._execute(plans, view, pad_output,
                                                    be))
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
        mode = ("live" if self._si is not None and self.store is None
                else "durable" if self._si is not None else "read-only")
        sch = self.schema or f"{self.num_keys} raw keys"
        return (f"<BitmapDB {mode} {sch} records={self.num_records} "
                f"backend={self.backend} device={self.device}>")


def open_db(path: str, schema: Schema | None = None, *,
            num_keys: int | None = None, backend: str = "auto",
            spill_records: int | None = 4096, capacity_words: int = 16,
            device="cuda") -> BitmapDB:
    """Functional alias of :meth:`BitmapDB.open` — exported as
    ``repro_torch.db.open`` / ``repro_torch.open``; named ``open_db`` here
    so this module keeps the ``open`` builtin."""
    return BitmapDB.open(path, schema, num_keys=num_keys, backend=backend,
                         spill_records=spill_records,
                         capacity_words=capacity_words, device=device)
