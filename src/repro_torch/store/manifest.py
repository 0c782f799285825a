"""Manifest: the atomically swapped source of truth for the live segment
set.

A manifest version is one JSON file (``MANIFEST-<v>.json``) listing the
ordered live segments, the open WAL generation, and the id counters.  The
``CURRENT`` pointer file names the committed version; commits write the new
manifest first, then atomically replace ``CURRENT`` — so a reader (or a
recovery after a crash at any point inside a commit) always sees one
complete, internally consistent segment set.  Files not reachable from
``CURRENT`` (orphan segments from a crashed flush, superseded manifests,
rotated WALs) are garbage, removed opportunistically by
:meth:`repro_torch.store.store.SegmentStore.gc`.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.store import format as fmt

CURRENT = "CURRENT"


@dataclasses.dataclass(frozen=True)
class SegmentMeta:
    """Directory entry for one immutable segment file."""
    segment_id: int
    file: str                  # name relative to the store root
    start_record: int          # absolute offset of the segment's first record
    num_records: int
    num_keys: int

    @property
    def end_record(self) -> int:
        return self.start_record + self.num_records


@dataclasses.dataclass(frozen=True)
class Manifest:
    version: int
    segments: tuple[SegmentMeta, ...]      # ordered by start_record
    wal_generation: int
    next_segment_id: int
    # replay-idempotence watermark: highest workload tick covered by the
    # committed segments, and how many blocks of that tick they absorbed
    last_tick: int = -1
    last_tick_blocks: int = 0

    @property
    def durable_records(self) -> int:
        """Records covered by committed segments (the WAL replay floor)."""
        return self.segments[-1].end_record if self.segments else 0

    def to_json(self) -> dict:
        return {"version": self.version,
                "segments": [dataclasses.asdict(s) for s in self.segments],
                "wal_generation": self.wal_generation,
                "next_segment_id": self.next_segment_id,
                "last_tick": self.last_tick,
                "last_tick_blocks": self.last_tick_blocks}

    @classmethod
    def from_json(cls, obj: dict) -> "Manifest":
        segs = tuple(SegmentMeta(**s) for s in obj["segments"])
        m = cls(version=obj["version"], segments=segs,
                wal_generation=obj["wal_generation"],
                next_segment_id=obj["next_segment_id"],
                last_tick=obj.get("last_tick", -1),
                last_tick_blocks=obj.get("last_tick_blocks", 0))
        m.validate()
        return m

    def validate(self) -> None:
        at = 0
        for s in self.segments:
            if s.start_record != at or s.num_records <= 0:
                raise fmt.CorruptFileError(
                    f"manifest v{self.version}: segment {s.segment_id} "
                    f"covers [{s.start_record}, {s.end_record}) but the "
                    f"stream position is {at}")
            at = s.end_record


def manifest_path(root: str, version: int) -> str:
    return os.path.join(root, f"MANIFEST-{version:08d}.json")


def load(root: str) -> Manifest | None:
    """The committed manifest, or None for an empty/uninitialized store."""
    cur = os.path.join(root, CURRENT)
    try:
        with open(cur) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    with open(os.path.join(root, name)) as f:
        return Manifest.from_json(json.load(f))


def commit(root: str, m: Manifest) -> None:
    """Write MANIFEST-<v>, then atomically repoint CURRENT at it."""
    m.validate()
    fmt.write_json_atomic(manifest_path(root, m.version), m.to_json())
    fmt.write_bytes_atomic(os.path.join(root, CURRENT),
                           os.path.basename(
                               manifest_path(root, m.version)).encode())
