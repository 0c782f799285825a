"""Shard map: which store owns which records, and which shards a
predicate can touch (the port's twin of ``repro.fabric.shardmap``: the
same splitmix64 routing in numpy, so both packages place every record on
the same shard; predicates are the port's planner classes).

Two partitioning strategies over the encoded record space (records are
``(N, num_columns)`` int32 key-word rows — see
:meth:`repro_torch.db.Schema.encode`):

  * ``hash`` — records route by a seeded splitmix64 hash of ONE
    column's key word.  Every record with the same value of that column
    lands on the same shard, so a ``Key`` predicate on the sharded
    column prunes the scatter to exactly one shard (``And`` intersects
    its children's owner sets, ``Or`` unions them, ``Not`` and keys of
    other columns fan out to everyone).  Shard-local record blocks are
    interleaved in the global order, so the merge is the OR-splice path.
  * ``block`` — contiguous slabs of ``block_size`` records: shard ``i``
    owns global ordinals ``[i*block_size, (i+1)*block_size)`` (the last
    shard unbounded).  No predicate pruning, but per-shard results are
    contiguous runs of the global bitmap — the concatenation merge.

Either way the map is pure arithmetic on (key word, global ordinal):
deterministic, JSON-serializable (it lives inside the cluster
manifest), and identical in every process that loads the same manifest.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.engine import planner

__all__ = ["ShardMap"]

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out).  The
    sharded column's key ids are small dense integers; without a strong
    mix, ``% num_shards`` would stripe them pathologically."""
    with np.errstate(over="ignore"):   # mod-2^64 wrap is the algorithm
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
        x ^= x >> np.uint64(30)
        x = (x * np.uint64(0xBF58476D1CE4E5B9)) & _M64
        x ^= x >> np.uint64(27)
        x = (x * np.uint64(0x94D049BB133111EB)) & _M64
        x ^= x >> np.uint64(31)
    return x


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """See module docstring.  Build with :meth:`hashed` or
    :meth:`blocked`; the raw constructor exists for deserialization."""
    num_shards: int
    strategy: str = "hash"              # "hash" | "block"
    column: str | None = None           # hash: the sharded column
    column_index: int = 0               # its word position in records
    base: int = 0                       # its first global key id
    cardinality: int = 0                # key ids it owns
    block_size: int = 0                 # block: records per slab
    seed: int = 0                       # hash salt

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.strategy not in ("hash", "block"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.strategy == "block" and self.block_size < 1:
            raise ValueError("block strategy needs block_size >= 1")

    # ---------------------------------------------------------- constructors
    @classmethod
    def hashed(cls, schema, column: str, num_shards: int, *,
               seed: int = 0) -> "ShardMap":
        """Hash-partition on ``column`` of ``schema``."""
        col = schema[column]
        idx = [c.name for c in schema.columns].index(column)
        return cls(num_shards=num_shards, strategy="hash", column=column,
                   column_index=idx, base=col.base,
                   cardinality=col.cardinality, seed=seed)

    @classmethod
    def blocked(cls, num_shards: int, *, total_records: int = 0,
                block_size: int = 0) -> "ShardMap":
        """Contiguous slabs; pass the build-time ``total_records`` to
        split evenly, or pin ``block_size`` directly."""
        if block_size < 1:
            block_size = max(1, -(-max(total_records, 1) // num_shards))
        return cls(num_shards=num_shards, strategy="block",
                   block_size=block_size)

    # --------------------------------------------------------------- routing
    def shard_of_key(self, key_id: int) -> int:
        """The shard owning every record whose sharded-column word is
        ``key_id`` (hash strategy only)."""
        if self.strategy != "hash":
            raise ValueError("shard_of_key is a hash-strategy notion")
        h = _mix64(np.uint64(int(key_id)) ^ np.uint64(self.seed))
        return int(h % np.uint64(self.num_shards))

    def route(self, records, *, start_gid: int = 0) -> np.ndarray:
        """Per-record owning shard for an encoded batch appended at
        global ordinal ``start_gid``."""
        records = np.asarray(records)
        n = records.shape[0]
        if self.strategy == "hash":
            words = records[:, self.column_index].astype(np.uint64)
            return (_mix64(words ^ np.uint64(self.seed))
                    % np.uint64(self.num_shards)).astype(np.int64)
        gids = start_gid + np.arange(n, dtype=np.int64)
        return np.minimum(gids // self.block_size, self.num_shards - 1)

    def partition(self, records, *, start_gid: int = 0
                  ) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Split a batch into ``(shard_id, local_records, gids)`` parts
        (shards with no records are omitted).  ``gids`` are the global
        ordinals of each shard's records, in local append order — the
        client's merge tables."""
        records = np.asarray(records)
        shard = self.route(records, start_gid=start_gid)
        out = []
        for s in range(self.num_shards):
            ix = np.flatnonzero(shard == s)
            if ix.size:
                out.append((s, records[ix], (start_gid + ix)
                            .astype(np.int64)))
        return out

    # --------------------------------------------------------------- pruning
    def owners(self, pred) -> frozenset | None:
        """The set of shards a lowered predicate can match on, or None
        when every shard must be consulted.  An EMPTY set is a real
        answer: the predicate contradicts itself on the sharded column
        and matches nothing anywhere."""
        if self.strategy != "hash":
            return None
        return self._walk(pred)

    def _walk(self, p) -> frozenset | None:
        if isinstance(p, planner.Key):
            if self.base <= p.index < self.base + self.cardinality:
                return frozenset((self.shard_of_key(p.index),))
            return None
        if isinstance(p, planner.And):
            known = [k for k in (self._walk(c) for c in p.children)
                     if k is not None]
            if not known:
                return None
            out = known[0]
            for k in known[1:]:
                out = out & k
            return out
        if isinstance(p, planner.Or):
            parts = [self._walk(c) for c in p.children]
            if any(k is None for k in parts) or not parts:
                return None
            return frozenset().union(*parts)
        return None                     # Not / anything else: no pruning

    # ----------------------------------------------------------------- wire
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ShardMap":
        return cls(**json.loads(text))
