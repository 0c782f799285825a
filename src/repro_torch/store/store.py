"""`SegmentStore` — the durable, LSM-flavored home of a packed bitmap index.

Layout of one store directory::

    CURRENT                 -> name of the committed manifest
    MANIFEST-<v>.json       -> ordered live segment set + open WAL generation
    seg-<id>.seg            -> immutable packed segment (checksummed array file)
    wal-<gen>.log           -> write-ahead block log for the open tail

A **segment** is an immutable packed slice of the record stream: the
key-major ``(M, ceil(n/32))`` uint32 words for records
``[start_record, start_record + n)``, serialized with a versioned header and
per-array CRCs (:mod:`repro_torch.store.format`).  The **manifest** names the live
segments in record order and is swapped atomically (write new manifest,
repoint ``CURRENT``), so every commit is all-or-nothing.  The **WAL** logs
raw record blocks before they are spliced into the in-memory index; a flush
writes the in-memory tail as a new segment, commits it, and rotates to a
fresh WAL generation.  Crash anywhere: recovery loads the committed
segments, re-indexes the surviving WAL blocks (the backends are pure
functions), and splices them on — reproducing the never-crashed in-memory
index word for word.

**Tiered compaction** keeps the segment count logarithmic: segments bucket
into size tiers (powers of ``compact_fanout`` records) and any run of
``compact_fanout`` adjacent same-tier segments merges into one via the same
shift/carry splice the streaming path uses.  Merges write the new segment
first and commit via the manifest, so compaction is crash-safe too.

**Concurrency** — one writer stream, one maintenance thread: the append
path only ever touches the WAL (:meth:`SegmentStore.log_block`), while
flushes/compaction/gc mutate the manifest.  A store-internal lock guards
the WAL handle and every manifest swap; the slow work (segment file
writes, merge splices) runs OUTSIDE the lock via the two-phase
:meth:`SegmentStore.prepare_segment` / :meth:`SegmentStore.commit_segment`
protocol, so appends never wait on a flush.  Blocks logged to the
outgoing WAL generation while a background flush was preparing are
carried into the fresh generation *before* the manifest swap — no crash
instant can lose an acknowledged block.  Files being prepared register as
in-flight so :meth:`SegmentStore.gc` (which may run concurrently from the
maintenance executor) never deletes a segment about to be committed.

Because segments partition the *record axis*, query serving never needs the
whole index resident: :class:`StoredIndex` runs a query batch against each
segment and OR-splices the per-segment result rows at their record offsets
(:func:`repro_torch.engine.batch.execute_many_segments`).
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.engine import policy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import maybe_span
from repro_torch.store import format as fmt
from repro_torch.store import wal as wal_mod
from repro_torch.store.manifest import Manifest, SegmentMeta, commit, load

PACK = 32
KEYS_FILE = "KEYS.arr"         # persisted key set (see ensure_keys)


def _num_words(n: int) -> int:
    return -(-n // PACK)


def np_splice(dst: np.ndarray, start_bit: int, block: np.ndarray,
              block_records: int) -> None:
    """OR packed ``block`` rows into ``dst`` at ``start_bit`` in place
    (numpy shift/carry; host-side twin of the engine's splice)."""
    off = start_bit % PACK
    w0 = start_bit // PACK
    bw = _num_words(block_records)
    block = block[:, :bw].astype(np.uint32, copy=False)
    if off == 0:
        dst[:, w0:w0 + bw] |= block
        return
    # words sliding past the destination tail are provably zero (block bits
    # past block_records are zero), so clipping them drops nothing
    hi = (block << np.uint32(off)).astype(np.uint32)
    carry = (block >> np.uint32(PACK - off)).astype(np.uint32)
    end = min(w0 + bw, dst.shape[1])
    dst[:, w0:end] |= hi[:, :end - w0]
    cend = min(w0 + 1 + bw, dst.shape[1])
    dst[:, w0 + 1:cend] |= carry[:, :cend - (w0 + 1)]


@dataclasses.dataclass
class CompactionStats:
    """What a :meth:`SegmentStore.compact` pass did (or, with
    ``dry_run=True``, would do).  ``bytes_reclaimed`` counts superseded
    segment files turned into garbage (actually deleted later by
    :meth:`SegmentStore.gc`); comparisons against numbers compare the
    merge count, so ``store.compact() > 0`` keeps reading naturally."""
    merges: int = 0
    segments_merged: int = 0
    bytes_written: int = 0
    bytes_reclaimed: int = 0
    dry_run: bool = False

    def __int__(self) -> int:
        return self.merges

    def __bool__(self) -> bool:
        return self.merges > 0

    def __eq__(self, other):
        if isinstance(other, (int, float)):
            return self.merges == other
        return super().__eq__(other)

    def __lt__(self, other):
        return self.merges < other

    def __le__(self, other):
        return self.merges <= other

    def __gt__(self, other):
        return self.merges > other

    def __ge__(self, other):
        return self.merges >= other


@dataclasses.dataclass(frozen=True)
class ScrubStats:
    """What a :meth:`SegmentStore.scrub` pass found and did.  ``corrupt``
    names every segment whose read failed CRC/meta validation this pass;
    each such segment lands in exactly one of ``repaired`` (a supplied
    replica rewrote it, or a clean re-read proved the corruption was
    read-side) or ``quarantined`` (no replica — served around until one
    appears).  Truthy iff corruption was found."""
    checked: int = 0
    corrupt: tuple[str, ...] = ()
    repaired: tuple[str, ...] = ()
    quarantined: tuple[str, ...] = ()
    dry_run: bool = False

    def __bool__(self) -> bool:
        return bool(self.corrupt)


@dataclasses.dataclass(frozen=True)
class GCStats:
    """What a :meth:`SegmentStore.gc` pass removed (or, with
    ``dry_run=True``, would remove).  Iterates / contains like the plain
    filename list it used to be."""
    removed: tuple[str, ...] = ()
    bytes_reclaimed: int = 0
    skipped_inflight: tuple[str, ...] = ()
    dry_run: bool = False

    def __contains__(self, name) -> bool:
        return name in self.removed

    def __iter__(self):
        return iter(self.removed)

    def __len__(self) -> int:
        return len(self.removed)

    def __bool__(self) -> bool:
        return bool(self.removed)


class SegmentStore:
    """One durable index = one store directory.  All mutation goes through
    ``log_block`` (WAL append) and ``write_segment`` (flush + manifest
    commit); both leave the directory recoverable at every instant.  An
    internal lock guards the WAL handle and manifest swaps so one append
    stream and one maintenance thread can share the store (see the module
    docstring's concurrency section)."""

    def __init__(self, root: str, *, compact_fanout: int = 4,
                 auto_compact: bool = True):
        if compact_fanout < 2:
            raise ValueError("compact_fanout must be >= 2")
        self.root = root
        self.compact_fanout = compact_fanout
        self.auto_compact = auto_compact
        os.makedirs(root, exist_ok=True)
        self._manifest = load(root) or Manifest(
            version=0, segments=(), wal_generation=0, next_segment_id=0)
        self._wal: wal_mod.WriteAheadLog | None = None
        self._wal_gen: int | None = None   # generation of the open handle
        # guards the WAL handle + manifest mutations (never held across a
        # segment-file write or merge splice — appends must not wait on
        # maintenance)
        self._lock = threading.RLock()
        # serializes segment CREATION (a two-phase flush holds it from
        # prepare to commit/abort, a merge for its whole body): segment
        # ids stay unique and every commit runs against a manifest no
        # other segment writer has moved.  Appends never touch it.
        self._flush_lock = threading.Lock()
        # filenames a two-phase flush/merge is writing right now: gc must
        # treat them (and their .tmp twins) as live, not garbage
        self._inflight: set[str] = set()
        # segments whose last read failed validation: file -> reason.
        # Quarantined segments stay in the manifest (their records are
        # still the stream's records) but compaction refuses to merge
        # them and the serving layer substitutes a replica / serves
        # around until scrub() repairs or clears them.
        self._quarantined: dict[str, str] = {}
        # durability counters live in a typed registry (health() is a
        # view over it; services attach it as their "store" subtree).
        # The old attribute names stay readable via properties below.
        self.registry = obs_metrics.Registry()
        self._quarantine_events_c = self.registry.counter(
            "quarantine_events_total", "lifetime quarantine entries")
        self._repairs_c = self.registry.counter(
            "repairs_total", "lifetime un-quarantines")
        self._read_retries_c = self.registry.counter(
            "read_retries_total", "transient read errors retried away")
        self._segments_g = self.registry.gauge(
            "segments", "live committed segments")
        self._quarantined_g = self.registry.gauge(
            "quarantined", "segments currently quarantined")
        self._segments_g.set(len(self._manifest.segments))

    # ------------------------------------------------- counter compat views
    @property
    def quarantine_events(self) -> int:
        return self._quarantine_events_c.value

    @property
    def repairs(self) -> int:
        return self._repairs_c.value

    @property
    def read_retries(self) -> int:
        return self._read_retries_c.value

    # ------------------------------------------------------------- accessors
    @property
    def manifest(self) -> Manifest:
        return self._manifest

    @property
    def segments(self) -> tuple[SegmentMeta, ...]:
        return self._manifest.segments

    @property
    def durable_records(self) -> int:
        """Records covered by committed segments (WAL tail excluded)."""
        return self._manifest.durable_records

    @property
    def num_keys(self) -> int | None:
        segs = self._manifest.segments
        return segs[0].num_keys if segs else None

    def wal_path(self) -> str:
        return wal_mod.wal_path(self.root, self._manifest.wal_generation)

    # ---------------------------------------------------------- key identity
    def ensure_keys(self, keys: np.ndarray) -> None:
        """Persist the key set on first use; afterwards reject ANY
        different key set (even one of the same length) — segments and
        WAL re-indexing are only meaningful under one key set, and a
        same-shape mismatch would recover a silently corrupt index."""
        keys = np.ascontiguousarray(keys, dtype=np.int32)
        path = os.path.join(self.root, KEYS_FILE)
        if os.path.exists(path):
            stored, _ = fmt.read_array_file(path)
            if not np.array_equal(stored["keys"], keys):
                raise ValueError(
                    f"store {self.root} was built with a different key "
                    "set; one store persists ONE index")
        else:
            fmt.write_array_file(path, {"keys": keys})

    # ------------------------------------------------------------------- WAL
    def log_block(self, records: np.ndarray, start: int,
                  tick: int | None = None) -> None:
        """Durably log a raw record block BEFORE it is spliced in memory.
        Holds the store lock only for the framed append itself, so this —
        the whole append-path footprint on the store — never waits on a
        segment write or a compaction merge."""
        with self._lock:
            if self._wal is None:
                self._wal = wal_mod.WriteAheadLog(self.wal_path())
                self._wal_gen = self._manifest.wal_generation
            self._wal.append_block(np.asarray(records), start, tick)

    def replay_wal(self) -> list[tuple[int, np.ndarray, int | None]]:
        """Intact WAL (start, records, tick) blocks not yet covered by a
        committed segment, in stream order — exactly what recovery must
        re-index.

        Reads the committed generation AND the next one: a rotation
        installs the fresh generation's handle (appends switch over)
        *before* the manifest swap, so a crash in that window leaves
        live blocks in generation g+1 while ``CURRENT`` still names g.
        Blocks are deduplicated by stream position (carried copies in
        the fresh generation are byte-identical to their originals), so
        every rotation crash window replays exactly once."""
        gen = self._manifest.wal_generation
        out = []
        pos = self.durable_records
        for path in (wal_mod.wal_path(self.root, gen),
                     wal_mod.wal_path(self.root, gen + 1)):
            for start, rec, tick in wal_mod.replay(path):
                if start < pos:
                    continue        # segment-covered, or a carried dup
                out.append((start, rec, tick))
                pos = start + rec.shape[0]
        return out

    # -------------------------------------------------------------- segments
    def segment_path(self, meta: SegmentMeta) -> str:
        return os.path.join(self.root, meta.file)

    def read_segment(self, meta: SegmentMeta, *,
                     retries: int = 2) -> np.ndarray:
        """Load + verify one segment's packed words.  Transient I/O
        errors (EIO blips — real or injected) retry up to ``retries``
        times with a short linear backoff; validation failures
        (:class:`~repro_torch.store.format.CorruptFileError`) never retry —
        corruption is persistent until repaired, and the caller's move
        is :meth:`quarantine` + :meth:`scrub`, not another read."""
        attempt = 0
        while True:
            try:
                arrays, fmeta = fmt.read_array_file(self.segment_path(meta))
                break
            except fmt.CorruptFileError:
                raise
            except OSError:
                attempt += 1
                if attempt > retries:
                    raise
                self._read_retries_c.inc()
                time.sleep(0.001 * attempt)
        packed = arrays["packed"]
        if (fmeta.get("num_records") != meta.num_records
                or fmeta.get("segment_id") != meta.segment_id
                or packed.shape != (meta.num_keys,
                                    _num_words(meta.num_records))):
            raise fmt.CorruptFileError(
                f"{meta.file}: segment meta mismatch (manifest says "
                f"{meta}, file says {fmeta} / {packed.shape})")
        return packed

    # ------------------------------------------------------- quarantine/scrub
    @property
    def quarantined(self) -> dict[str, str]:
        """Snapshot of quarantined segment files -> reason."""
        with self._lock:
            return dict(self._quarantined)

    def quarantine(self, meta: SegmentMeta, reason: str) -> None:
        """Mark a live segment as corrupt-on-disk: compaction will not
        merge it and the serving layer serves around it until
        :meth:`repair_segment` (or a clean :meth:`scrub` re-read)
        clears it.  Idempotent per file."""
        with self._lock:
            if meta.file not in {s.file for s in self._manifest.segments}:
                return                 # superseded while we looked at it
            if meta.file not in self._quarantined:
                self._quarantined[meta.file] = str(reason)
                self._quarantine_events_c.inc()
                self._quarantined_g.set(len(self._quarantined))

    def repair_segment(self, meta: SegmentMeta, packed: np.ndarray) -> None:
        """Rewrite a (quarantined) segment's file from a known-good
        replica of its packed words — e.g. re-extracted from the live
        in-memory index — then verify the round trip and lift the
        quarantine.  Runs under the flush lock so no compaction merge or
        two-phase flush can move the manifest mid-repair."""
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        want = (meta.num_keys, _num_words(meta.num_records))
        if packed.shape != want:
            raise ValueError(f"replica shape {packed.shape} does not match "
                             f"segment {meta.file} ({want})")
        with self._flush_lock:
            with self._lock:
                if meta.file not in {s.file
                                     for s in self._manifest.segments}:
                    raise ValueError(f"{meta.file} is not a live segment")
                # gc guard for the .tmp twin during the atomic rewrite
                self._inflight.add(meta.file)
            try:
                with maybe_span("store.repair", file=meta.file):
                    fmt.write_array_file(
                        self.segment_path(meta), {"packed": packed},
                        meta={"segment_id": meta.segment_id,
                              "start_record": meta.start_record,
                              "num_records": meta.num_records})
            finally:
                with self._lock:
                    self._inflight.discard(meta.file)
        self.read_segment(meta)        # verify before lifting quarantine
        with self._lock:
            self._quarantined.pop(meta.file, None)
            self._quarantined_g.set(len(self._quarantined))
        self._repairs_c.inc()          # every successful rewrite counts

    def scrub(self, *,
              repair: Callable[[SegmentMeta], np.ndarray | None] | None
              = None,
              dry_run: bool = False) -> ScrubStats:
        """CRC-verify every committed segment (the background scrubber's
        body).  A segment that fails validation is repaired from
        ``repair(meta)``'s replica when one is available, otherwise
        quarantined; a quarantined segment whose re-read comes back
        clean (the corruption was read-side, not on disk) is released.
        In-flight segments are skipped — their writer owns them.
        ``dry_run=True`` only reports."""
        with maybe_span("store.scrub", dry_run=dry_run):
            return self._scrub_sweep(repair=repair, dry_run=dry_run)

    def _scrub_sweep(self, *, repair, dry_run) -> ScrubStats:
        checked = 0
        corrupt: list[str] = []
        repaired: list[str] = []
        quarantined: list[str] = []
        for meta in self._manifest.segments:      # immutable snapshot
            with self._lock:
                if meta.file in self._inflight:
                    continue
            checked += 1
            try:
                self.read_segment(meta)
            except (fmt.CorruptFileError, OSError) as e:
                corrupt.append(meta.file)
                if dry_run:
                    continue
                replica = repair(meta) if repair is not None else None
                if replica is not None:
                    try:
                        self.repair_segment(meta, replica)
                        repaired.append(meta.file)
                        continue
                    except (ValueError, OSError, fmt.CorruptFileError):
                        pass           # fall through to quarantine
                self.quarantine(meta, f"{type(e).__name__}: {e}")
                quarantined.append(meta.file)
            else:
                if dry_run:
                    continue
                lifted = False
                with self._lock:       # clean read-back lifts quarantine
                    if self._quarantined.pop(meta.file, None) is not None:
                        self._quarantined_g.set(len(self._quarantined))
                        lifted = True
                if lifted:
                    self._repairs_c.inc()
                    repaired.append(meta.file)
        return ScrubStats(checked, tuple(corrupt), tuple(repaired),
                          tuple(quarantined), dry_run)

    def write_segment(self, packed: np.ndarray, num_records: int,
                      start_record: int, *,
                      tick_watermark: tuple[int, int] | None = None
                      ) -> SegmentMeta:
        """Flush a packed tail slice as a new immutable segment and commit:
        segment file first, then an atomic manifest swap that also rotates
        the WAL generation (the flushed records no longer need the log).
        ``tick_watermark`` carries the (tick, blocks) watermark of the
        flushed records into the manifest (it must survive the WAL
        rotation)."""
        meta = self.prepare_segment(packed, num_records, start_record)
        try:
            self.commit_segment(meta, tick_watermark=tick_watermark)
        except BaseException:
            self.abort_segment(meta)    # completes the two-phase op
            raise
        return meta

    def prepare_segment(self, packed: np.ndarray, num_records: int,
                        start_record: int) -> SegmentMeta:
        """Phase one of a (possibly background) flush: validate and write
        the immutable segment FILE without touching the manifest — the
        slow part, safe to run off the append path because appends only
        ever touch the WAL.  The segment becomes live only at
        :meth:`commit_segment`; until then gc treats the file as
        in-flight, not garbage.  Holds the store's flush lock until
        :meth:`commit_segment` / :meth:`abort_segment` releases it, so
        no other segment writer (an explicit ``snapshot()`` spill, a
        compaction merge) can move the manifest — or claim the same
        segment id — underneath the two-phase flush."""
        packed = np.ascontiguousarray(packed, dtype=np.uint32)
        if num_records <= 0:
            raise ValueError("segment needs at least one record")
        if packed.shape[1] != _num_words(num_records):
            raise ValueError(f"packed shape {packed.shape} does not match "
                             f"{num_records} records")
        self._flush_lock.acquire()
        try:
            with self._lock:
                m = self._manifest
                if start_record != m.durable_records:
                    raise ValueError(
                        f"segment must extend the stream: "
                        f"start={start_record}, "
                        f"durable={m.durable_records}")
                if self.num_keys is not None \
                        and packed.shape[0] != self.num_keys:
                    raise ValueError(
                        f"segment has {packed.shape[0]} key rows, "
                        f"store has {self.num_keys}")
                meta = SegmentMeta(segment_id=m.next_segment_id,
                                   file=f"seg-{m.next_segment_id:08d}.seg",
                                   start_record=start_record,
                                   num_records=num_records,
                                   num_keys=packed.shape[0])
                self._inflight.add(meta.file)
            try:
                with maybe_span("store.prepare", file=meta.file,
                                records=num_records):
                    fmt.write_array_file(
                        os.path.join(self.root, meta.file),
                        {"packed": packed},
                        meta={"segment_id": meta.segment_id,
                              "start_record": meta.start_record,
                              "num_records": meta.num_records})
            except BaseException:
                with self._lock:
                    self._inflight.discard(meta.file)
                raise
        except BaseException:
            self._flush_lock.release()
            raise
        return meta

    def commit_segment(self, meta: SegmentMeta, *,
                       tick_watermark: tuple[int, int] | None = None
                       ) -> None:
        """Phase two: atomic manifest swap making a prepared segment live
        (and rotating the WAL generation — blocks logged while the
        prepare was running are carried into the fresh generation, see
        :meth:`_commit`).  A crash anywhere before this call leaves only
        an orphan file; recovery still replays every logged block.

        On FAILURE the flush lock stays held and the segment stays
        in-flight: the two-phase op is still open, and the caller
        finishes it with :meth:`abort_segment` (exactly one release —
        releasing here too would let a second release free some OTHER
        writer's critical section).

        The store lock is held only for the handle swap plus the tail of
        the WAL carry-over (normally zero blocks): the bulk copy of the
        outgoing generation, the fresh generation's creation, and the
        manifest's fsync-heavy file writes all run outside it, so
        appends stall for at most one WAL frame.  Crash windows are
        covered by :meth:`replay_wal`'s two-generation deduplicating
        read."""
        m = self._manifest                 # stable: flush lock held
        if meta.start_record != m.durable_records:
            raise ValueError(
                f"segment must extend the stream: "
                f"start={meta.start_record}, "
                f"durable={m.durable_records}")
        # phase A (unlocked): fresh generation file (truncating a stale
        # one from a crashed prior rotation) + bulk carry-over of blocks
        # the new manifest will not cover, while appends keep logging to
        # the outgoing generation.  If a prior commit attempt already
        # switched the handle to the target generation (its manifest
        # swap failed), every block at or past this flush's floor is
        # already there — truncating it would lose them, so both phases
        # are skipped.
        target_gen = m.wal_generation + 1
        if self._wal_gen != target_gen:
            old_path = wal_mod.wal_path(self.root, m.wal_generation)
            fresh = wal_mod.WriteAheadLog.create(
                wal_mod.wal_path(self.root, target_gen))
            floor = meta.start_record + meta.num_records
            copied_to = floor
            entries, read_off = wal_mod.replay_from(old_path, 8)
            for start, rec, tick in entries:
                if start >= copied_to:
                    fresh.append_block(rec, start, tick)
                    copied_to = start + rec.shape[0]
            # phase B (locked, brief): catch blocks that raced the bulk
            # copy, then switch the append stream to the fresh generation
            with self._lock:
                if self._wal is not None:
                    self._wal.close()      # flush the outgoing handle
                    self._wal = None
                entries, _ = wal_mod.replay_from(old_path, read_off)
                for start, rec, tick in entries:
                    if start >= copied_to:
                        fresh.append_block(rec, start, tick)
                        copied_to = start + rec.shape[0]
                self._wal = fresh
                self._wal_gen = target_gen
        # phase C (unlocked): the atomic manifest swap — a crash before
        # it leaves CURRENT at the old generation, whose blocks replay
        # (the fresh file's copies dedup away); after it, the fresh
        # generation is simply current
        tick, blocks = (tick_watermark if tick_watermark is not None
                        else (m.last_tick, m.last_tick_blocks))
        with maybe_span("store.commit", file=meta.file,
                        records=meta.num_records):
            self._commit(dataclasses.replace(
                m, version=m.version + 1,
                segments=m.segments + (meta,),
                wal_generation=m.wal_generation + 1,
                next_segment_id=max(m.next_segment_id,
                                    meta.segment_id + 1),
                last_tick=tick, last_tick_blocks=blocks))
        with self._lock:
            self._inflight.discard(meta.file)
        self._flush_lock.release()
        if self.auto_compact:
            self.compact()

    def abort_segment(self, meta: SegmentMeta) -> None:
        """Drop a prepared-but-never-committed segment's in-flight marker
        (its orphan file becomes ordinary gc fodder) and release the
        flush lock."""
        with self._lock:
            self._inflight.discard(meta.file)
        self._flush_lock.release()

    def _write_segment_file(self, packed: np.ndarray, num_records: int,
                            start_record: int) -> SegmentMeta:
        """Write the next segment id's immutable file (flush and merge
        share this); the segment becomes live only at the manifest commit."""
        m = self._manifest
        meta = SegmentMeta(segment_id=m.next_segment_id,
                           file=f"seg-{m.next_segment_id:08d}.seg",
                           start_record=start_record,
                           num_records=num_records,
                           num_keys=packed.shape[0])
        fmt.write_array_file(
            os.path.join(self.root, meta.file), {"packed": packed},
            meta={"segment_id": meta.segment_id,
                  "start_record": meta.start_record,
                  "num_records": meta.num_records})
        return meta

    def _commit(self, new: Manifest) -> None:
        """Atomic manifest swap.  The fsync-heavy file writes run
        without the store lock (appends never wait on them); only the
        in-memory manifest pointer flips under it.  WAL rotation is NOT
        handled here — :meth:`commit_segment` owns the three-phase
        rotation protocol; non-rotating commits (compaction merges)
        leave the WAL handle untouched."""
        commit(self.root, new)
        with self._lock:
            self._manifest = new
        self._segments_g.set(len(new.segments))

    # ------------------------------------------------------------ compaction
    def _tier(self, num_records: int) -> int:
        # integer arithmetic: float log truncates exact fanout powers
        # (int(math.log(243, 3)) == 4) and would mis-bucket them
        tier, bound = 0, self.compact_fanout
        while num_records >= bound:
            tier += 1
            bound *= self.compact_fanout
        return tier

    def compact(self, *, dry_run: bool = False) -> CompactionStats:
        """Tiered merge: while any ``compact_fanout``-long run of adjacent
        same-tier segments exists, splice it into one segment (write new
        file, atomic manifest swap).  Returns :class:`CompactionStats`
        (int-comparable as the merge count).  ``dry_run=True`` simulates
        the cascade without writing anything — ``bytes_written`` is then
        the merged payload estimate, not a measured file size."""
        stats = CompactionStats(dry_run=dry_run)
        if dry_run:
            segs = list(self._manifest.segments)
            while True:
                run = self._find_run(segs)
                if run is None:
                    return stats
                lo, hi = run
                total = sum(s.num_records for s in segs[lo:hi])
                stats.merges += 1
                stats.segments_merged += hi - lo
                stats.bytes_reclaimed += sum(
                    self._file_size(s.file) for s in segs[lo:hi])
                stats.bytes_written += (
                    segs[lo].num_keys * _num_words(total) * 4)
                segs[lo:hi] = [dataclasses.replace(
                    segs[lo], num_records=total)]
        while True:
            # each merge recomputes its run under the flush lock, so a
            # spill committed (or another compact pass run) between
            # iterations can never be merged against stale positions
            with self._flush_lock:
                run = self._find_run(self._manifest.segments)
                if run is None:
                    return stats
                with maybe_span("store.merge", lo=run[0], hi=run[1]):
                    self._merge(*run, stats=stats)

    def _file_size(self, name: str) -> int:
        try:
            return os.path.getsize(os.path.join(self.root, name))
        except OSError:
            return 0

    def _find_run(self, segs: Sequence[SegmentMeta]
                  ) -> tuple[int, int] | None:
        # a quarantined segment's bits are unreadable until repaired —
        # it can never join a merge run, and it breaks runs that would
        # otherwise span it (compaction serves around corruption)
        with self._lock:
            bad = set(self._quarantined)
        i = 0
        while i < len(segs):
            if segs[i].file in bad:
                i += 1
                continue
            j = i
            t = self._tier(segs[i].num_records)
            while (j < len(segs) and segs[j].file not in bad
                   and self._tier(segs[j].num_records) == t):
                j += 1
            if j - i >= self.compact_fanout:
                return i, i + self.compact_fanout
            i += 1
        return None

    def _merge(self, lo: int, hi: int, *,
               stats: CompactionStats | None = None) -> None:
        """Merge segments[lo:hi] (caller holds the flush lock, so the
        manifest's segment set cannot move under the slow splice — only
        WAL appends proceed concurrently)."""
        m = self._manifest
        run = m.segments[lo:hi]
        total = sum(s.num_records for s in run)
        merged = np.zeros((run[0].num_keys, _num_words(total)), np.uint32)
        at = 0
        for s in run:
            np_splice(merged, at, self.read_segment(s), s.num_records)
            at += s.num_records
        with self._lock:       # a concurrent gc must not eat the new file
            self._inflight.add(f"seg-{m.next_segment_id:08d}.seg")
        try:
            meta = self._write_segment_file(merged, total,
                                            run[0].start_record)
            self._commit(dataclasses.replace(
                m, version=m.version + 1,
                segments=m.segments[:lo] + (meta,) + m.segments[hi:],
                next_segment_id=m.next_segment_id + 1))
        finally:
            with self._lock:
                self._inflight.discard(f"seg-{m.next_segment_id:08d}.seg")
        if stats is not None:
            stats.merges += 1
            stats.segments_merged += hi - lo
            stats.bytes_written += self._file_size(meta.file)
            stats.bytes_reclaimed += sum(self._file_size(s.file)
                                         for s in run)

    # ------------------------------------------------------------- bulk read
    def load_packed(self) -> tuple[np.ndarray, int]:
        """Materialize the committed segments as one packed array
        ``(M, ceil(n/32))`` (WAL tail excluded).  Segments are contiguous
        and start 32-aligned relative to nothing — the host splice handles
        arbitrary offsets."""
        segs = self._manifest.segments
        n = self.durable_records
        if not segs:
            return np.zeros((0, 0), np.uint32), 0
        out = np.zeros((segs[0].num_keys, _num_words(n)), np.uint32)
        for s in segs:
            np_splice(out, s.start_record, self.read_segment(s),
                      s.num_records)
        return out, n

    # -------------------------------------------------------------------- gc
    def gc(self, *, dry_run: bool = False) -> GCStats:
        """Delete files unreachable from CURRENT (orphan segments from
        crashed flushes, superseded manifests, rotated WALs).  Safe to run
        concurrently with a background flush: files registered in-flight
        by :meth:`prepare_segment` / a compaction merge (and their
        ``.tmp`` twins, which an atomic write is about to replace) are
        skipped, not collected — without the guard a gc racing a spill
        could delete the very segment the next manifest swap commits.
        ``dry_run=True`` only reports.  Returns :class:`GCStats`
        (iterable/containment-compatible with the old filename list)."""
        with maybe_span("store.gc", dry_run=dry_run):
            return self._gc_sweep(dry_run=dry_run)

    def _gc_sweep(self, *, dry_run) -> GCStats:
        names = sorted(os.listdir(self.root))
        removed, skipped = [], []
        reclaimed = 0
        for name in names:
            # includes stale .tmp files (crash mid-atomic-write): the
            # atomic writers finish their replace before returning, so
            # an unreferenced, not-in-flight .tmp is never about to
            # become live
            if not (name.startswith(("seg-", "wal-", "MANIFEST-"))
                    or name.endswith(".tmp")):
                continue
            # the lock is taken PER FILE, with liveness re-checked under
            # it right before the unlink: an append (log_block) waits at
            # most one unlink, never the whole sweep — and a segment id
            # reused after an abort can't be deleted just as a new
            # prepare re-writes its file
            with self._lock:
                m = self._manifest
                # gen+1 stays live too: a rotation in flight (or crashed
                # pre-swap) may hold the stream's tail there (see
                # replay_wal)
                keep = {"CURRENT", f"MANIFEST-{m.version:08d}.json",
                        os.path.basename(self.wal_path()),
                        os.path.basename(wal_mod.wal_path(
                            self.root, m.wal_generation + 1))}
                keep |= {s.file for s in m.segments}
                if name in keep:
                    continue
                if name in self._inflight \
                        or name.removesuffix(".tmp") in self._inflight:
                    skipped.append(name)
                    continue
                reclaimed += self._file_size(name)
                if not dry_run:
                    try:
                        os.remove(os.path.join(self.root, name))
                    except FileNotFoundError:
                        pass            # someone else collected it
                removed.append(name)
        return GCStats(tuple(removed), reclaimed, tuple(skipped), dry_run)

    def health(self) -> dict:
        """Durability-side health snapshot (folded into
        ``BitmapService.health()``)."""
        with self._lock:
            quarantined = dict(self._quarantined)
            segments = len(self._manifest.segments)
        return {"quarantined": quarantined,
                "quarantine_events": self._quarantine_events_c.value,
                "repairs": self._repairs_c.value,
                "read_retries": self._read_retries_c.value,
                "segments": segments}

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None
                self._wal_gen = None


# --------------------------------------------------------- queryable handle
def _words(packed: np.ndarray, device) -> torch.Tensor:
    """A store's numpy ``uint32`` words as the port's int32 tensor on
    ``device`` (the bits reinterpreted, never cast)."""
    arr = np.ascontiguousarray(packed, dtype=np.uint32)
    if not arr.flags.writeable:          # a read-only file buffer
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


@dataclasses.dataclass
class StoredIndex:
    """Segment-parallel queryable view of a (possibly spilled) index: an
    ordered list of per-segment packed int32 tensors covering disjoint
    record ranges, plus the total record count.  ``query_many`` serves a
    batch of predicate trees with one bucketed dispatch per segment (or
    one stacked dispatch over all of them) and OR-splices the per-segment
    rows at their record offsets — no materialized full-index buffer (see
    :func:`repro_torch.engine.batch.execute_many_segments`).  ``device`` is
    where the parts live (needed only when there are none)."""
    parts: tuple            # of (packed (M, w_i) int32 tensor, n_i records)
    num_records: int
    device: torch.device | None = None

    def __post_init__(self):
        if self.device is None:
            self.device = (self.parts[0][0].device if self.parts
                           else policy.resolve_device("cuda"))

    @property
    def num_keys(self) -> int:
        return int(self.parts[0][0].shape[0]) if self.parts else 0

    @property
    def num_segments(self) -> int:
        return len(self.parts)

    def query_many(self, predicates: Sequence, *, backend: str = "auto"):
        from repro_torch.engine import batch as engine_batch
        return engine_batch.execute_many_segments(
            self.parts, predicates, backend=backend, device=self.device)

    def to_bitmap_index(self):
        """Materialize one contiguous :class:`repro_torch.engine.policy.BitmapIndex`
        (tests / small indexes only — serving should stay segment-parallel)."""
        from repro_torch.engine.runtime import append_packed
        packed = torch.zeros((self.num_keys, 0), dtype=torch.int32,
                             device=self.device)
        n = 0
        for part, cnt in self.parts:
            packed = append_packed(packed, n, part, cnt)
            n += cnt
        return policy.BitmapIndex(packed, n)


def open_index(store: SegmentStore, *, tail=None,
               device="cuda") -> StoredIndex:
    """Open the committed segment set as a :class:`StoredIndex` whose parts
    live on ``device``.  ``tail`` optionally appends an in-memory packed
    suffix ``(packed, num_records)`` — e.g. a recovered WAL tail not yet
    flushed (a tensor, or the store's numpy ``uint32`` words)."""
    dev = policy.resolve_device(device)
    parts = [(_words(store.read_segment(s), dev), s.num_records)
             for s in store.segments]
    n = store.durable_records
    if tail is not None:
        tpacked, tcount = tail
        if tcount:
            tpacked = (tpacked.to(dev) if isinstance(tpacked, torch.Tensor)
                       else _words(tpacked, dev))
            parts.append((tpacked, int(tcount)))
            n += int(tcount)
    return StoredIndex(tuple(parts), n, dev)


def recover_index(store: SegmentStore, keys, *, backend: str = "auto",
                  device="cuda"):
    """Full crash recovery: committed segments + re-indexed WAL tail ->
    a :class:`repro_torch.engine.policy.BitmapIndex` on ``device``,
    bit-identical to the never-crashed in-memory index (see
    ``StreamingIndexer.restore`` for recovery into a live appendable
    indexer)."""
    from repro_torch.engine.runtime import StreamingIndexer
    return StreamingIndexer.restore(store, keys, backend=backend,
                                    device=device).index
