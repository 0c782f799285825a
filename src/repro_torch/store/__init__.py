"""Durable segment store for packed bitmap indexes.

Public surface:

  * :class:`SegmentStore` — directory of immutable checksummed segments +
    atomic manifest + write-ahead block log + tiered compaction.
  * :class:`StoredIndex` / :func:`open_index` — segment-parallel queryable
    view (serves through :func:`repro_torch.engine.batch.execute_many_segments`).
  * :func:`recover_index` — manifest + WAL crash recovery to a bit-identical
    :class:`repro_torch.engine.policy.BitmapIndex`.
  * :mod:`repro_torch.store.format` — the checksummed serialization substrate.

On-disk formats are byte-compatible with ``repro.store``: a directory
written by either package opens and recovers in the other.  Packed words
go to disk as ``uint32`` (the port's int32 tensors, bits reinterpreted) and
the WAL logs int32 records.
"""
from repro_torch.store.format import CorruptFileError  # noqa: F401
from repro_torch.store.manifest import Manifest, SegmentMeta  # noqa: F401
from repro_torch.store.store import (CompactionStats, GCStats,  # noqa: F401
                                     ScrubStats, SegmentStore, StoredIndex,
                                     np_splice, open_index,
                                     recover_index)
