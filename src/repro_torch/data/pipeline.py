"""Bitmap-indexed data pipeline — the paper's technique as a first-class
feature of the training stack, served through the :mod:`repro_torch.db`
facade (the port's twin of ``repro.data.pipeline``).

Documents carry attributes (domain, language, quality bucket, tags ...).
At ingest, each corpus shard streams into a per-shard
:class:`repro_torch.db.BitmapDB`: every attribute value is one schema key,
every document one record.  Data selection for training ("code documents, high
quality, not flagged") is then a declarative query — either the typed DSL
(``col("domain").isin([0, 1]) & (col("quality") == 2)``) or a raw engine
predicate tree — executed as streaming bitwise passes, the exact economics
the paper builds silicon for, applied to the data plane of an LM training
run.

The corpus itself is synthetic (the assignment ships no data), but the
pipeline is real: sharded ingest, BIC indexing, query-driven sampling,
deterministic restart (the sampler state is part of the checkpoint), and
``store_dir=`` durability (per-shard ``BitmapDB`` stores reload
CRC-verified instead of re-indexing the corpus).  The shard sessions and
the batches live on the dataset's ``device`` (default the card).

The one query plane over every shard (:meth:`BitmapIndexedDataset.fabric`,
:meth:`~BitmapIndexedDataset.select_global`) needs the shard fabric, which
is not ported yet: both raise :class:`NotImplementedError` naming ROADMAP
A7.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence, Union

import numpy as np
import torch

from repro_torch.core.bic import BICCore, BICConfig, BitmapIndex
from repro_torch.db.expr import Expr
from repro_torch.db.schema import Column, Schema
from repro_torch.engine.planner import Pred

ATTR_WORDS = 8        # attribute words per document "record"

#: a selection query: a typed repro_torch.db expression or a raw predicate
#: tree
Query = Union[Expr, Pred]


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    docs_per_shard: int = 2048
    num_shards: int = 4
    num_attributes: int = 64        # distinct attribute values (BIC keys)
    seed: int = 0


def attribute_schema(cfg: DataConfig) -> Schema | None:
    """The corpus attribute layout as a :class:`repro_torch.db.Schema`: domains
    own keys 0-7, languages 8-15, quality buckets 16-23, and free-form
    tags the remaining rows — matching the raw key-id words
    :class:`SyntheticCorpus` emits, so encoded shards ingest directly.
    Returns None when ``num_attributes`` leaves no room for the tag rows
    (the dataset then runs a raw key-addressed session; the legacy
    integer-key queries keep working either way)."""
    if cfg.num_attributes <= 24:
        return None
    return Schema([
        Column.categorical("domain", range(8)),
        Column.categorical("lang", range(8)),
        Column.categorical("quality", range(8)),
        Column.categorical("tag", range(24, cfg.num_attributes)),
    ])


class SyntheticCorpus:
    """Deterministic synthetic corpus: documents of tokens + attribute words.

    Attribute words are drawn so that structured queries have non-trivial
    selectivity (mixtures of domains / quality buckets)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def shard(self, shard_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (D, seq_len+1) int32, attrs (D, ATTR_WORDS))."""
        c = self.cfg
        rng = np.random.default_rng(c.seed * 1000 + shard_id)
        tokens = rng.integers(0, c.vocab_size,
                              size=(c.docs_per_shard, c.seq_len + 1),
                              dtype=np.int32)
        # attributes: word 0 = domain (0..7), word 1 = lang (8..15),
        # word 2 = quality (16..23), rest random tags
        attrs = np.zeros((c.docs_per_shard, ATTR_WORDS), np.int32)
        attrs[:, 0] = rng.integers(0, 8, c.docs_per_shard)
        attrs[:, 1] = 8 + rng.integers(0, 8, c.docs_per_shard)
        attrs[:, 2] = 16 + rng.integers(0, 8, c.docs_per_shard)
        tag_lo = min(24, max(c.num_attributes - 1, 1))
        attrs[:, 3:] = rng.integers(tag_lo, c.num_attributes,
                                    size=(c.docs_per_shard, ATTR_WORDS - 3))
        return tokens, attrs


class BitmapIndexedDataset:
    """Corpus shards + per-shard :class:`repro_torch.db.BitmapDB` sessions
    + query-driven batching, on ``device``.

    ``store_dir`` makes the per-shard indexes durable: each shard's index
    persists as a segment store under ``<store_dir>/shard-<id>``, so a
    restarted pipeline reopens (CRC-verified) through
    ``repro_torch.db.open`` instead of re-running the BIC build over the
    corpus."""

    def __init__(self, cfg: DataConfig, bic: BICCore | None = None, *,
                 store_dir: str | None = None, device="cuda"):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.bic = bic or BICCore(BICConfig(
            num_keys=cfg.num_attributes,
            num_records=cfg.docs_per_shard,
            words_per_record=ATTR_WORDS), device=device)
        self.device = self.bic.device
        self.schema = attribute_schema(cfg)
        self.store_dir = store_dir
        self._shards: dict[int, tuple[np.ndarray, "object"]] = {}
        self._services: dict[int, "object"] = {}

    def _shard_path(self, shard_id: int) -> str:
        return os.path.join(self.store_dir, f"shard-{shard_id:04d}")

    def _open_or_ingest(self, attrs: np.ndarray, shard_id: int):
        """One durable (or in-memory) BitmapDB per shard."""
        from repro_torch import db as _db
        kw = dict(backend=self.bic.config.backend, device=self.device)
        if self.schema is None:
            kw["num_keys"] = self.cfg.num_attributes
        if self.store_dir is None:
            db = _db.BitmapDB(self.schema, **kw)
            db.append_encoded(attrs)
            return db
        from repro_torch.store import SegmentStore
        path = self._shard_path(shard_id)
        st = SegmentStore(path)
        try:
            populated = bool(st.durable_records or st.replay_wal())
            if populated and st.num_keys is not None \
                    and st.num_keys != self.cfg.num_attributes:
                raise ValueError(
                    f"store shard-{shard_id:04d} holds {st.num_keys}-key "
                    f"segments but the config says "
                    f"{self.cfg.num_attributes} attributes — stale "
                    "store_dir?")
        finally:
            st.close()
        if populated:
            db = _db.BitmapDB.open(path, self.schema, **kw)
            if db.num_records != self.cfg.docs_per_shard:
                raise ValueError(
                    f"store shard-{shard_id:04d} holds {db.num_records} "
                    f"records but the config says "
                    f"{self.cfg.docs_per_shard} — stale store_dir?")
            return db
        db = _db.BitmapDB(self.schema, path=path, spill_records=None, **kw)
        db.append_encoded(attrs)
        db.snapshot()                     # one committed segment per shard
        return db

    def _ensure_db(self, shard_id: int):
        if shard_id not in self._shards:
            tokens, attrs = self.corpus.shard(shard_id)
            self._shards[shard_id] = (tokens,
                                      self._open_or_ingest(attrs, shard_id))
        return self._shards[shard_id]

    def _ensure_shard(self, shard_id: int) -> tuple[np.ndarray, BitmapIndex]:
        """(tokens, live BitmapIndex) — the legacy accessor shape."""
        tokens, db = self._ensure_db(shard_id)
        return tokens, db.index

    def db(self, shard_id: int):
        """The shard's :class:`repro_torch.db.BitmapDB` session (for direct DSL
        queries, stats, or serving)."""
        return self._ensure_db(shard_id)[1]

    def select(self, shard_id: int, include: Sequence[int] = (),
               exclude: Sequence[int] = (), *,
               where: Query | None = None) -> np.ndarray:
        """Document ids in ``shard_id`` matching the attribute query.

        ``where`` accepts a typed expression over :func:`attribute_schema`
        (``col("domain").isin([0, 1]) & (col("quality") == 2) &
        ~(col("tag") == 30)``) or a raw predicate tree over integer key
        rows; ``include``/``exclude`` express the legacy AND-of-literals
        (kept working through the :mod:`repro_torch.db` deprecation shim)."""
        from repro_torch import db as _db
        if where is None:
            where = _db.include_exclude_pred(include, exclude)
        elif include or exclude:
            raise ValueError("pass either include/exclude or where=, "
                             "not both")
        return self.select_many(shard_id, [where])[0]

    def select_many(self, shard_id: int,
                    wheres: Sequence[Query]) -> list[np.ndarray]:
        """Serve a burst of selections against one shard in a handful of
        bucketed dispatches (one lazily shared ``query_many`` batch, one
        bulk device-to-host transfer) instead of one planner dispatch —
        and one device sync — per query.  Returns the matching
        document-id array per query, in input order."""
        db = self.db(shard_id)
        return db.query_many(list(wheres)).all_ids()

    # -------------------------------------------------------- async prefetch
    def service(self, shard_id: int, **config):
        """The shard's :class:`repro_torch.serve.service.BitmapService` (opened
        lazily; ``config`` keywords apply on first open).  Selections
        submitted through it execute on the service's scheduler thread,
        coalesced with any other caller's — the prefetch path.  Shard
        stores spill synchronously at ingest (``snapshot()``), so
        background maintenance stays off by default here."""
        if shard_id not in self._services:
            config.setdefault("max_delay_ms", 1.0)
            config.setdefault("maintenance", False)
            self._services[shard_id] = self.db(shard_id).serve(**config)
        return self._services[shard_id]

    def select_many_async(self, shard_id: int, wheres: Sequence[Query]
                          ) -> list:
        """Non-blocking :meth:`select_many`: submit the burst to the
        shard's service and return its
        :class:`repro_torch.serve.service.QueryFuture` list immediately —
        ``.ids`` on each future blocks only for ITS micro-batch, so
        submission overlaps with consumption (and with ingest of the
        next shard in :meth:`batches`).  Ids are bit-identical to the
        synchronous path."""
        return self.service(shard_id).submit_many(list(wheres))

    # ------------------------------------------------------- fabric plane
    def fabric(self, **kw):
        """ONE query plane over every corpus shard (the reference's
        loopback ``FabricClient`` over the per-shard sessions, document
        gid = ``shard_id * docs_per_shard + local_id``): needs the shard
        fabric, which is not ported yet."""
        _later("BitmapIndexedDataset.fabric (the shard fabric)", "A7")

    def select_global(self, wheres: Sequence[Query]) -> list[np.ndarray]:
        """GLOBAL document ids across the whole corpus through
        :meth:`fabric` (not ported yet)."""
        _later("BitmapIndexedDataset.select_global (the shard fabric)",
               "A7")

    def close(self) -> None:
        """Close every shard service (drains in-flight selections)."""
        for svc in self._services.values():
            svc.close()
        self._services.clear()

    def batches(self, batch_size: int, include: Sequence[int] = (),
                exclude: Sequence[int] = (), *, where: Query | None = None,
                seed: int = 0, start_step: int = 0,
                prefetch: bool = False) -> Iterator[dict]:
        """Infinite deterministic batch stream over the selected subset;
        each batch holds int32 ``tokens`` and ``labels`` tensors on the
        dataset's device.

        ``start_step`` resumes mid-stream after a restart (the training
        loop checkpoints its step counter — see train/loop.py).

        ``prefetch=True`` pipelines shard selection: each shard's query
        is submitted to its service the moment the shard is ingested and
        executes on the scheduler thread while the NEXT shard ingests;
        futures are consumed afterwards.  Ids — and therefore the batch
        stream — are bit-identical to the synchronous path.  Opt-in: it
        opens one service (scheduler thread) per shard, which lives
        until :meth:`close`."""
        from repro_torch import db as _db
        if where is None:
            query: Query = _db.include_exclude_pred(include, exclude)
        elif include or exclude:
            raise ValueError("pass either include/exclude or where=, "
                             "not both")
        else:
            query = where
        rng = np.random.default_rng(seed)
        pools = []
        if prefetch:
            futs = []
            for s in range(self.cfg.num_shards):
                self._ensure_db(s)
                futs.append(self.select_many_async(s, [query])[0])
            for s, fut in enumerate(futs):
                ids = fut.ids
                tokens, _ = self._shards[s]
                if len(ids):
                    pools.append(tokens[ids])
        else:
            for s in range(self.cfg.num_shards):
                ids = self.select(s, where=query)
                tokens, _ = self._ensure_db(s)
                if len(ids):
                    pools.append(tokens[ids])
        if not pools:
            raise ValueError("query selected zero documents")
        pool = np.concatenate(pools, axis=0)
        order = rng.permutation(len(pool))
        step = 0
        while True:
            take = [(order[(step * batch_size + i) % len(pool)])
                    for i in range(batch_size)]
            if step >= start_step:
                seqs = torch.from_numpy(pool[take]).to(self.device)
                yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
            step += 1
