"""Cluster manifest: membership, replica groups, and segment handoff —
on the same atomic-swap substrate as :mod:`repro_torch.store.manifest`
(the port's twin of ``repro.fabric.cluster``: its files are the
reference's, so a cluster root written by either package loads in the
other).

One cluster root directory holds ``CLUSTER-<v>.json`` versions and a
``CURRENT`` pointer; a commit writes the new version file first and then
atomically repoints ``CURRENT``, so every reader (and every crash
recovery) sees one complete, internally consistent view of the fabric:
the :class:`~repro_torch.fabric.shardmap.ShardMap`, each shard's replica
stores, and each shard's global-id table (the merge table mapping
shard-local record ordinals back to global bitmap positions).

Gid tables are content files referenced BY the manifest (CRC'd array
files, written before the swap), mirroring how segments relate to a
store manifest: the pointer swap is the only mutation, everything it
names is immutable once named.

**Rebalance is segment handoff**: shard stores are append-only sets of
immutable, CRC-verified segment files, so moving a shard to a new store
(or bringing a fresh replica into its group) is
:func:`sync_store` — copy the missing segment files, verify their
checksums, swap the destination's store manifest — followed by one
cluster-manifest commit that edits the replica tuple.  A crash between
the two leaves only an orphaned (never-referenced) copy, never a
half-moved shard.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from repro_torch.fabric.shardmap import ShardMap
from repro_torch.store import format as fmt
from repro_torch.store import manifest as store_manifest

__all__ = ["ShardEntry", "ClusterManifest", "load", "commit",
           "save_gids", "load_gids", "sync_store", "rebalance"]

CURRENT = "CURRENT"


@dataclasses.dataclass(frozen=True)
class ShardEntry:
    """One shard's place in the fabric: its replica stores (first entry
    is the preferred primary; reads may hedge across all of them) and
    its gid table."""
    shard_id: int
    replicas: tuple[str, ...]          # store roots (or socket addrs)
    num_records: int = 0
    gids_file: str | None = None       # CRC'd array file in cluster root

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["replicas"] = list(self.replicas)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ShardEntry":
        d = dict(d)
        d["replicas"] = tuple(d["replicas"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ClusterManifest:
    version: int
    shardmap: ShardMap
    shards: tuple[ShardEntry, ...]

    @property
    def num_records(self) -> int:
        return sum(s.num_records for s in self.shards)

    def shard(self, shard_id: int) -> ShardEntry:
        for s in self.shards:
            if s.shard_id == shard_id:
                return s
        raise KeyError(f"no shard {shard_id} in cluster "
                       f"v{self.version}")

    def validate(self) -> None:
        ids = [s.shard_id for s in self.shards]
        if ids != list(range(self.shardmap.num_shards)):
            raise fmt.CorruptFileError(
                f"cluster v{self.version}: shards {ids} != "
                f"0..{self.shardmap.num_shards - 1}")
        for s in self.shards:
            if not s.replicas:
                raise fmt.CorruptFileError(
                    f"cluster v{self.version}: shard {s.shard_id} "
                    f"has no replicas")

    def to_json(self) -> dict:
        return {"version": self.version,
                "shardmap": json.loads(self.shardmap.to_json()),
                "shards": [s.to_json() for s in self.shards]}

    @classmethod
    def from_json(cls, obj: dict) -> "ClusterManifest":
        m = cls(version=obj["version"],
                shardmap=ShardMap(**obj["shardmap"]),
                shards=tuple(ShardEntry.from_json(s)
                             for s in obj["shards"]))
        m.validate()
        return m

    # ------------------------------------------------------------- updates
    def with_shard(self, entry: ShardEntry) -> "ClusterManifest":
        """Next version with one shard entry replaced (commit it to make
        it real)."""
        shards = tuple(entry if s.shard_id == entry.shard_id else s
                       for s in self.shards)
        return dataclasses.replace(self, version=self.version + 1,
                                   shards=shards)


def _path(root: str, version: int) -> str:
    return os.path.join(root, f"CLUSTER-{version:08d}.json")


def load(root: str) -> ClusterManifest | None:
    """The committed cluster manifest, or None for an empty root."""
    try:
        with open(os.path.join(root, CURRENT)) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    with open(os.path.join(root, name)) as f:
        return ClusterManifest.from_json(json.load(f))


def commit(root: str, m: ClusterManifest) -> None:
    """Write CLUSTER-<v>, then atomically repoint CURRENT at it."""
    m.validate()
    os.makedirs(root, exist_ok=True)
    fmt.write_json_atomic(_path(root, m.version), m.to_json())
    fmt.write_bytes_atomic(os.path.join(root, CURRENT),
                           os.path.basename(_path(root, m.version))
                           .encode())


# ------------------------------------------------------------- gid tables
def save_gids(root: str, shard_id: int, version: int,
              gids: np.ndarray) -> str:
    """Write one shard's gid table as a versioned CRC'd array file;
    returns the file name to put in its :class:`ShardEntry` (call
    BEFORE committing the manifest that references it)."""
    name = f"gids-{shard_id:04d}-{version:08d}.arr"
    os.makedirs(root, exist_ok=True)
    fmt.write_array_file(os.path.join(root, name),
                         {"gids": np.asarray(gids, np.int64)})
    return name


def load_gids(root: str, entry: ShardEntry) -> np.ndarray:
    if entry.gids_file is None:
        return np.zeros(0, np.int64)
    arrays, _ = fmt.read_array_file(os.path.join(root, entry.gids_file))
    return np.asarray(arrays["gids"], np.int64)


# -------------------------------------------------------- segment handoff
def sync_store(src_root: str, dst_root: str) -> int:
    """Bring ``dst_root`` up to ``src_root``'s committed segment set:
    copy every missing segment file, re-verify each copy's CRC, copy the
    schema, then swap in a copy of the source's committed manifest.
    Returns the number of segments shipped.  Idempotent (re-running
    ships nothing) — this is both replica bring-up and rebalance
    handoff."""
    if os.path.normpath(src_root) == os.path.normpath(dst_root):
        return 0                       # self-sync: trivially up to date
    src_m = store_manifest.load(src_root)
    if src_m is None:
        raise FileNotFoundError(f"{src_root}: no committed manifest "
                                "(snapshot the shard first)")
    os.makedirs(dst_root, exist_ok=True)
    shipped = 0
    for seg in src_m.segments:
        dst_file = os.path.join(dst_root, seg.file)
        if os.path.exists(dst_file):
            continue
        shutil.copyfile(os.path.join(src_root, seg.file),
                        dst_file + ".part")
        os.replace(dst_file + ".part", dst_file)
        fmt.read_array_file(dst_file)          # CRC gate before commit
        shipped += 1
    schema = os.path.join(src_root, "SCHEMA.json")
    if os.path.exists(schema):
        shutil.copyfile(schema, os.path.join(dst_root, "SCHEMA.json"))
    # fresh replica starts a WAL generation of its own; the manifest's
    # segment set is what replication promises, and only that
    store_manifest.commit(dst_root, src_m)
    return shipped


def rebalance(root: str, m: ClusterManifest, shard_id: int,
              new_store: str, *, drop: str | None = None
              ) -> ClusterManifest:
    """Move/extend shard ``shard_id``'s replica group onto
    ``new_store``: ship its segments, then commit ONE manifest version
    adding the new replica (and optionally dropping an old one).
    Returns the committed manifest."""
    entry = m.shard(shard_id)
    sync_store(entry.replicas[0], new_store)
    replicas = tuple(r for r in entry.replicas if r != drop)
    if new_store not in replicas:
        replicas = replicas + (new_store,)
    if not replicas:
        raise ValueError(f"shard {shard_id}: rebalance would leave "
                         "no replicas")
    m2 = m.with_shard(dataclasses.replace(entry, replicas=replicas))
    commit(root, m2)
    return m2
