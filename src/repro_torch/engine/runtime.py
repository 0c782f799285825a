"""Streaming multi-core runtime: per-device index builds fused with the
elastic energy model, and incremental, durable append into packed indexes.

The port's twin of ``repro.engine.runtime``.  The paper's Fig. 4 deployment
feeds Z independent BIC cores from external memory and powers idle cores
down; this module fuses that execution side with the energy side:

  * :func:`multicore_create_index` — the full BIC pipeline over a list of
    devices (one H100 is one core), blocks assigned round-robin, no
    cross-core communication during indexing.  ``core/elastic.py`` keeps a
    thin compatibility wrapper.
  * :func:`append_packed` — bit-splice one freshly indexed block onto a
    packed index.
  * :class:`StreamingIndexer` — grow one key-major index record-block by
    record-block with NO full rebuild: each block is indexed alone and
    bit-spliced onto the packed tail (a shift/carry merge when the current
    record count is not 32-aligned), into a geometrically grown capacity
    buffer.
  * :func:`fold_block_indexes` — fold per-block indexes of uniform blocks
    into one packed index.
  * :class:`MulticoreRuntime` — drives ticks of a workload stream through
    the per-device build AND integrates active/standby energy with the
    calibrated silicon model.  ``run_tick(queries=...)`` additionally serves
    a batch of predicate trees against the freshly built tick index through
    :mod:`repro_torch.engine.batch`.  Every tick's dispatch is timed (the
    devices synchronized before the clock is read) and folded into a
    throughput EWMA; with ``calibrate_energy=True`` the elastic model
    charges active energy over the *measured* busy time.  Those joules are
    still the paper's 65-nm SOTB silicon model, charged over busy time
    measured on the GPU — not the GPU's own energy.  With ``store_dir=...``
    the runtime also keeps one durable per-core index
    (``repro_torch.store.SegmentStore`` per core).
  * ``StreamingIndexer.attach_store`` / ``spill`` / ``restore`` — the
    durability hooks: raw blocks are WAL-logged (int32, from the caller's
    host array) *before* the in-memory splice, the tail past the durable
    prefix flushes as an immutable segment (extracted at its unaligned
    offset by :func:`repro_torch.engine.policy.extract_packed`), and
    recovery replays committed segments + surviving WAL blocks into a
    bit-identical index.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.bic import BICConfig, PaperConfig
from repro_torch.core.elastic import ElasticScheduler, EnergyReport, PowerState
from repro_torch.engine import backends, batch as engine_batch, policy
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.obs.energy import EnergyLedger

_RECORDS_INDEXED = _obs_metrics.GLOBAL.counter(
    "engine_records_indexed_total",
    "records appended through streaming indexers")


def _host_i32(records) -> np.ndarray:
    """The caller's record block as a host int32 array for the WAL: cast
    on the host when it lives there (no trip to the card and back), one
    device-to-host copy when the caller handed a CUDA tensor."""
    if isinstance(records, torch.Tensor):
        return records.detach().to("cpu").to(torch.int32).numpy()
    return np.ascontiguousarray(records, dtype=np.int32)


def _sync(devices) -> None:
    """Wait for every CUDA device among ``devices`` (the clock of a timed
    dispatch is read only after the card has finished it)."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ------------------------------------------------------------ per-device build
def _devices(devices) -> list[torch.device]:
    """Resolve a device list; ``None`` means every visible CUDA device
    (raising without one — pass ``["cpu"]`` for the plain path)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)] or ["cuda"]
    out = [policy.resolve_device(d) for d in devices]
    if not out:
        raise ValueError("need at least one device")
    return out


def multicore_create_index(records, keys, devices=None, *,
                           backend: str = "auto") -> torch.Tensor:
    """records (Z*B, N, W), keys (M,) -> (Z*B, M, ceil(N/32)) int32.

    Block ``b`` is built on ``devices[b % Z]`` (round-robin, as the
    reference's per-core batches are assigned), each block by itself: one
    ``create_index`` (``cam_match`` + ``bit_transpose`` on the ``cuda``
    backend) per block, so a block whose N is not a multiple of 32 keeps
    its own tail padding.  Results gather on ``devices[0]``.  ``backend``
    resolves by ``devices[0]``."""
    devs = _devices(devices)
    be = backends.get_backend(backend, devs[0])
    records = torch.as_tensor(records)
    keys_on = {d: torch.as_tensor(keys).to(d, torch.int32) for d in devs}
    zb, n = int(records.shape[0]), int(records.shape[1])
    out = torch.empty((zb, int(keys_on[devs[0]].shape[0]),
                       policy.num_words(n)), dtype=torch.int32,
                      device=devs[0])
    for b in range(zb):
        d = devs[b % len(devs)]
        rec = records[b].to(d).to(torch.int32)
        out[b] = be.create_index(rec, keys_on[d]).to(devs[0])
    return out


# ---------------------------------------------------------- incremental append
def append_packed(packed: torch.Tensor, num_records: int,
                  block: torch.Tensor, block_records: int) -> torch.Tensor:
    """Bit-splice a freshly indexed ``block`` (M, ceil(n'/32)) onto a packed
    index (M, ceil(n/32)) holding ``num_records`` records.  Pad bits past
    each logical record count must be zero (every backend guarantees it)."""
    total_words = policy.num_words(num_records + block_records)
    m = packed.shape[0]
    buf = packed.new_zeros((m, packed.shape[1] + block.shape[1] + 1))
    buf[:, :packed.shape[1]] = packed
    policy.splice_into(buf, num_records, block)     # buf is fresh
    return buf[:, :total_words]


class StreamingIndexer:
    """Grow one key-major index record-block by record-block.

    ``append`` indexes only the incoming block and splices it in; the live
    index is always available via ``.index`` (bit-identical to a
    from-scratch rebuild over all records seen so far).  The packed words
    live in a geometrically doubled capacity buffer.

    The splice is functional, as in the reference: every append writes a
    fresh buffer (one device copy of the capacity buffer), so a
    ``(buffer, count)`` pair from :meth:`view` — the snapshot
    :mod:`repro_torch.db` results execute against, and the one a background
    spill extracts its tail from outside the mutex — stays a bit-exact
    point-in-time view forever.  An in-place splice would tear it.

    With a :class:`repro_torch.store.SegmentStore` attached the index
    outlives the process: every incoming block is WAL-logged *before* the
    in-memory splice, the tail past the store's durable prefix flushes as
    an immutable segment once ``flush_records`` accumulate (or on an
    explicit :meth:`spill`), and :meth:`restore` rebuilds a bit-identical
    live indexer from manifest + WAL after a crash.
    """

    def __init__(self, keys, *, backend: str = "auto",
                 capacity_words: int = 16, device="cuda"):
        self.device = policy.resolve_device(device)
        self.keys = torch.as_tensor(keys).to(self.device, torch.int32)
        self.backend = backends.resolve_backend(backend, self.device)
        self._cap = max(int(capacity_words), 2)
        self._buf = torch.zeros((self.keys.shape[0], self._cap),
                                dtype=torch.int32, device=self.device)
        self._num_records = 0
        self._store = None
        self._flush_records: int | None = None
        self._last_tick = -1
        self._last_tick_blocks = 0
        # guards the (WAL log, buf, num_records, tick) commit point of an
        # append against concurrent snapshot readers (background spill /
        # serving view); held for the log and the splice, never for the
        # index build, segment writes or merges
        self._mu = threading.RLock()
        # background-maintenance tap: when set, a reached flush threshold
        # calls the hook (enqueue work) instead of spilling synchronously
        # on the append path
        self._spill_hook: Callable[[], None] | None = None

    @property
    def num_records(self) -> int:
        return self._num_records

    @property
    def store(self):
        return self._store

    @property
    def last_tick(self) -> int:
        """Highest ``tick`` stamp this index has absorbed (-1 when ticks
        are untracked).  Survives spill/crash/restore."""
        return self._last_tick

    def absorbed_blocks(self, tick: int) -> int:
        """How many blocks of (monotone) workload tick ``tick`` this index
        has already absorbed — the replay-idempotence watermark.  Returns
        -1 when ``tick`` is below the watermark entirely."""
        if tick == self._last_tick:
            return self._last_tick_blocks
        return 0 if tick > self._last_tick else -1

    def _stamp_tick(self, tick: int | None) -> None:
        if tick is None:
            return
        if tick > self._last_tick:
            self._last_tick, self._last_tick_blocks = tick, 1
        elif tick == self._last_tick:
            self._last_tick_blocks += 1

    def _grow(self, need_words: int) -> None:
        if need_words > self._cap:
            new = self._cap
            while new < need_words:
                new *= 2
            buf = self._buf.new_zeros((self._buf.shape[0], new))
            buf[:, :self._cap] = self._buf
            self._buf, self._cap = buf, new

    def _records(self, records) -> torch.Tensor:
        return torch.as_tensor(records).to(self.device).to(torch.int32)

    # ----------------------------------------------------------- durability
    def attach_store(self, store, *, flush_records: int | None = 4096
                     ) -> None:
        """Make this index durable: WAL-log every future append into
        ``store`` and auto-:meth:`spill` a segment whenever the in-memory
        tail reaches ``flush_records`` records (None = manual spills only).
        The store must not be ahead of the indexer — to resume from a
        non-empty store, use :meth:`restore` instead."""
        store.ensure_keys(self.keys.cpu().numpy())
        wal_tail = store.replay_wal()
        if store.durable_records > self._num_records or wal_tail:
            raise ValueError(
                f"store already holds {store.durable_records} durable "
                f"records and {len(wal_tail)} WAL tail blocks; "
                "use StreamingIndexer.restore to resume from a store")
        self._store = store
        self._flush_records = flush_records
        if self._num_records > store.durable_records:
            # records indexed before the attach were never WAL-logged
            self.spill()

    def _flush_snapshot(self):
        """Consistent (tail, count, start, tick watermark) snapshot of the
        flushable suffix — the mutex pins (buf, count, watermark) together;
        the extraction runs outside it (the captured buffer is never
        written again: splices are functional)."""
        with self._mu:
            start = self._store.durable_records
            count = self._num_records - start
            if count <= 0:
                return None
            buf = self._buf
            wm = (self._last_tick, self._last_tick_blocks)
        tail = policy.extract_packed(buf, start, count)
        return tail.cpu().numpy().view(np.uint32), count, start, wm

    def spill(self) -> None:
        """Flush the in-memory tail past the store's durable prefix as one
        immutable segment (atomic manifest commit + WAL rotation).  A
        no-op when nothing new has arrived since the last spill."""
        if self._store is None:
            raise RuntimeError("no store attached (see attach_store)")
        snap = self._flush_snapshot()
        if snap is None:
            return
        tail, count, start, wm = snap
        with _obs_trace.maybe_span("spill", records=count):
            self._store.write_segment(tail, count, start, tick_watermark=wm)

    def set_spill_hook(self, hook: Callable[[], None] | None) -> None:
        """Route threshold-triggered flushes through ``hook()`` (e.g. a
        maintenance executor's enqueue) instead of spilling synchronously
        on the append path; ``None`` restores synchronous spills.  The
        hook runs on the appending thread and must only enqueue."""
        self._spill_hook = hook

    def pending_flush_records(self) -> int:
        """Records in memory past the store's durable prefix (0 when no
        store is attached) — what a background flush would spill."""
        with self._mu:
            if self._store is None:
                return 0
            return self._num_records - self._store.durable_records

    def prepare_spill(self):
        """Background-flush phase one: snapshot the flushable tail and
        write its segment FILE.  Returns an opaque token for
        :meth:`commit_spill`, or None when nothing needs flushing.  Crash
        before the commit: the file is an orphan, the WAL still holds every
        block — recovery is unaffected."""
        if self._store is None:
            raise RuntimeError("no store attached (see attach_store)")
        snap = self._flush_snapshot()
        if snap is None:
            return None
        tail, count, start, wm = snap
        with _obs_trace.maybe_span("spill.prepare", records=count):
            meta = self._store.prepare_segment(tail, count, start)
        return meta, wm

    def commit_spill(self, token) -> None:
        """Background-flush phase two: atomic manifest swap making the
        prepared segment live."""
        meta, wm = token
        with _obs_trace.maybe_span("spill.commit", file=meta.file):
            self._store.commit_segment(meta, tick_watermark=wm)

    def abort_spill(self, token) -> None:
        """Abandon a prepared spill (its orphan file becomes gc fodder)."""
        self._store.abort_segment(token[0])

    def _maybe_spill(self) -> None:
        if (self._store is not None and self._flush_records is not None
                and (self._num_records - self._store.durable_records
                     >= self._flush_records)):
            if self._spill_hook is not None:
                self._spill_hook()
            else:
                self.spill()

    def _log_block(self, records, start: int, tick: int | None = None
                   ) -> None:
        if self._store is not None:
            self._store.log_block(_host_i32(records), start, tick)

    @classmethod
    def restore(cls, store, keys, *, backend: str = "auto",
                capacity_words: int = 16,
                flush_records: int | None = 4096,
                device="cuda") -> "StreamingIndexer":
        """Crash recovery: load the committed segments, re-index the
        surviving WAL blocks on ``device`` (backends are pure functions of
        their inputs), and splice them on — the result is bit-identical to
        the pre-crash in-memory index, with the store re-attached for
        further appends."""
        si = cls(keys, backend=backend, capacity_words=capacity_words,
                 device=device)
        store.ensure_keys(si.keys.cpu().numpy())
        m = store.manifest
        si._last_tick = m.last_tick
        si._last_tick_blocks = m.last_tick_blocks
        packed, n = store.load_packed()
        if n:
            si._grow(packed.shape[1] + 1)
            si._buf[:, :packed.shape[1]] = torch.from_numpy(
                np.ascontiguousarray(packed).view(np.int32)).to(si.device)
            si._num_records = n
        be = backends.get_backend(si.backend)
        for start, rec, tick in store.replay_wal():
            if start != si._num_records:
                raise ValueError(
                    f"WAL block starts at record {start} but the recovered "
                    f"stream position is {si._num_records}")
            block = be.create_index(
                torch.from_numpy(rec.astype(np.int32)).to(si.device), si.keys)
            si._grow(start // policy.PACK + block.shape[1] + 1)
            # no snapshot of the buffer exists yet: splice in place
            policy.splice_into(si._buf, start, block)
            si._num_records += rec.shape[0]
            si._stamp_tick(tick)
        # attach AFTER replay: replayed blocks are already in the WAL
        si._store = store
        si._flush_records = flush_records
        return si

    # --------------------------------------------------------------- append
    def append(self, records) -> policy.BitmapIndex:
        """Index a (N', W) record block and splice it in; returns the
        updated live index.  An empty block is a no-op (no dispatch).  The
        WAL (when a store is attached) logs ``records`` as given, from the
        host when they live there."""
        if int(records.shape[0]) == 0:
            return self.index
        block = backends.get_backend(self.backend).create_index(
            self._records(records), self.keys)
        return self.append_indexed(records, block)

    def append_indexed(self, records, block: torch.Tensor, *,
                       tick: int | None = None) -> policy.BitmapIndex:
        """Splice in a block whose (M, ceil(N'/32)) index ``block`` was
        already built elsewhere (e.g. by a per-device tick dispatch) — the
        raw ``records`` (a host array or a tensor) are still WAL-logged so
        recovery can re-index them.  ``tick`` stamps the block for replay
        idempotence (see :attr:`last_tick`)."""
        n_new = int(records.shape[0])
        if n_new == 0:
            return self.index
        with self._mu:     # log + splice + count + tick commit atomically
            self._log_block(records, self._num_records, tick)
            self._grow(self._num_records // policy.PACK + block.shape[1] + 1)
            self._buf = policy.splice_packed(self._buf, self._num_records,
                                             block)
            self._num_records += n_new
            self._stamp_tick(tick)
        _RECORDS_INDEXED.add(n_new)
        self._maybe_spill()
        return self.index

    def append_many(self, records) -> policy.BitmapIndex:
        """Append a batch of uniform blocks (B, N', W), block by block (each
        WAL-logged at its own offset, as the reference logs them)."""
        for blk in records:
            self.append(blk)
        return self.index

    def view(self) -> tuple[torch.Tensor, int]:
        """A consistent (capacity buffer, record count) pair even under a
        concurrent append."""
        with self._mu:
            return self._buf, self._num_records

    @property
    def index(self) -> policy.BitmapIndex:
        buf, n = self.view()
        return policy.BitmapIndex(buf[:, :policy.num_words(n)], n)


def fold_block_indexes(blocks: torch.Tensor,
                       block_records: int) -> policy.BitmapIndex:
    """Fold per-block indexes (B, M, BW) of uniform ``block_records``-record
    blocks into ONE packed index over the concatenated records — e.g. the
    output of :func:`multicore_create_index` becoming a servable tick
    index."""
    b, m, bw = blocks.shape
    total = b * block_records
    buf = blocks.new_zeros((m, total // policy.PACK + bw + 1))
    for i in range(b):
        policy.splice_into(buf, i * block_records, blocks[i])
    return policy.BitmapIndex(buf[:, :policy.num_words(total)], total)


# ------------------------------------------------- fused execution + energy
@dataclasses.dataclass
class TickResult:
    indexes: torch.Tensor | None   # (B_t, M, ceil(N/32)); None when idle
    active_cores: int
    report: EnergyReport
    query_rows: torch.Tensor | None = None     # (Q, ceil(B_t*N/32)) int32
    query_counts: torch.Tensor | None = None   # (Q,) int32
    measured_seconds: float = 0.0              # the tick dispatch, synced
    # record MB/s of THIS dispatch, in PAPER units: one 8-bit record word
    # = one byte, regardless of the int32 container the words travel in
    measured_mbps: float = 0.0


class MulticoreRuntime:
    """Per-device indexing with elastic energy accounting in one place.

    Each call to :meth:`run_tick` dispatches one tick's record batches over
    the devices (:func:`multicore_create_index`; one device is one core)
    and charges the elastic scheduler's calibrated power model for the
    cores the *policy* would activate (``cores_needed``); idle cores accrue
    standby energy (CG / CG+RBB).

    Every dispatch is timed with the devices synchronized before the clock
    is read, and folded into a throughput EWMA (``measured_mbps``).  By
    default joules follow the paper-clock model; with
    ``calibrate_energy=True`` the measured busy time replaces the model's
    busy time for active energy AND the scheduler's per-core batch time is
    re-derived from the measured MB/s.  Either way the joules are the
    paper's 65-nm SOTB silicon model, not the GPU's energy.

    With ``store_dir=...`` the runtime keeps one durable index per core:
    tick batches are assigned round-robin to per-core
    :class:`StreamingIndexer`\\ s (splicing the already-built per-batch
    block indexes), each backed by its own
    ``repro_torch.store.SegmentStore`` under ``<store_dir>/core-<z>``.  A
    restarted runtime pointed at the same directory recovers every
    per-core index bit-identically (manifest + WAL replay).
    """

    def __init__(self, devices=None, cfg: BICConfig = PaperConfig,
                 state: PowerState = PowerState(), *,
                 backend: str = "auto", calibrate_energy: bool = False,
                 store_dir: str | None = None, flush_records: int = 4096,
                 throughput_ewma: float = 0.5):
        self.devices = _devices(devices)
        self.backend = backends.resolve_backend(backend, self.devices[0])
        self.num_cores = len(self.devices)
        self.scheduler = ElasticScheduler(self.num_cores, cfg, state)
        self.report = EnergyReport()
        # joule ledger on the same operating points: tick reports feed it
        # so ingest energy rolls up to pJ-per-indexed-bit
        self.ledger = EnergyLedger(self.scheduler)
        self.calibrate_energy = calibrate_energy
        self.store_dir = store_dir
        self.flush_records = flush_records
        self.throughput_ewma = throughput_ewma
        self.measured_mbps = 0.0            # EWMA over non-idle ticks
        self._core_si: list[StreamingIndexer] | None = None

    def bind_ledger(self, ledger: EnergyLedger) -> None:
        """Rebind tick charging to a shared ledger: indexing and serving
        then roll up into ONE energy report, and the shared ledger's
        attributed+unattributed invariant still holds because every tick's
        joules enter through its ``charge_report``."""
        self.ledger = ledger

    # ---------------------------------------------------- per-core indexes
    def core_indexers(self, keys) -> list[StreamingIndexer]:
        """The per-core durable indexers (created, or recovered from the
        store, on first use), indexer ``z`` on ``devices[z]``.  Requires
        ``store_dir``; every call must use the SAME keys."""
        if self.store_dir is None:
            raise RuntimeError("MulticoreRuntime has no store_dir")
        if self._core_si is not None:
            cached = self._core_si[0].keys.cpu()
            keys32 = torch.as_tensor(keys).to("cpu", torch.int32)
            if cached.shape != keys32.shape or not torch.equal(cached,
                                                               keys32):
                raise ValueError(
                    "per-core indexers were created with a different key "
                    "set; a runtime persists ONE key set per store_dir")
        if self._core_si is None:
            from repro_torch.store import SegmentStore
            sis = []
            for z, dev in enumerate(self.devices):
                st = SegmentStore(os.path.join(self.store_dir, f"core-{z}"))
                if st.durable_records or st.replay_wal():
                    si = StreamingIndexer.restore(
                        st, keys, backend=self.backend,
                        flush_records=self.flush_records, device=dev)
                else:
                    si = StreamingIndexer(keys, backend=self.backend,
                                          device=dev)
                    si.attach_store(st, flush_records=self.flush_records)
                sis.append(si)
            self._core_si = sis
        return self._core_si

    def core_indexes(self, keys) -> list[policy.BitmapIndex]:
        """The live per-core cumulative indexes (recovering from the store
        first if this runtime has not ticked yet)."""
        return [si.index for si in self.core_indexers(keys)]

    def checkpoint(self) -> None:
        """Force-spill every per-core in-memory tail to its segment store
        (e.g. before a planned shutdown)."""
        for si in self._core_si or ():
            si.spill()

    def run_tick(self, records, keys, tick_seconds: float, *,
                 queries: Sequence | None = None,
                 tick_id: int | None = None) -> TickResult:
        """records (B_t, N, W) for this tick (None = idle tick): a tensor
        on any device, or a host array.

        ``queries`` — an optional batch of predicate trees (or plans)
        served against the index of THIS tick's records: the per-block
        indexes fold into one packed tick index and the batch executes
        through :func:`repro_torch.engine.batch.execute_many`.  Results land
        in ``TickResult.query_rows/query_counts`` in query order.

        ``tick_id`` (monotone) makes the durable per-core appends
        **idempotent under replay**: the id is WAL-stamped with every
        block and survives spill/crash/restore, so re-feeding the tick
        that was in flight at crash time appends only to the cores that
        had not absorbed it yet."""
        wl = 0 if records is None else int(records.shape[0])
        if wl == 0:
            tick = self.scheduler.account(0, tick_seconds)
            self.report.merge(tick)
            self.ledger.charge_report(tick)
            return TickResult(None, 0, tick)
        _sync(self.devices)
        t0 = time.perf_counter()
        out = multicore_create_index(records, keys, self.devices,
                                     backend=self.backend)
        _sync(self.devices)
        elapsed = max(time.perf_counter() - t0, 1e-9)
        n_rec, n_words = int(records.shape[1]), int(records.shape[2])
        # paper units: one 8-bit record word = one byte (see TickResult)
        mbps = wl * n_rec * n_words / 1e6 / elapsed
        a = self.throughput_ewma
        self.measured_mbps = (mbps if self.measured_mbps == 0.0
                              else a * mbps + (1 - a) * self.measured_mbps)
        if self.calibrate_energy:
            self.scheduler.calibrate(self.measured_mbps / self.num_cores)
            tick = self.scheduler.account(
                wl, tick_seconds, busy_seconds=min(elapsed, tick_seconds))
        else:
            tick = self.scheduler.account(wl, tick_seconds)
        self.report.merge(tick)
        self.ledger.charge_report(tick)
        # one indexed bit per (record, key) pair this tick produced
        self.ledger.attribute_bits(wl * n_rec * len(keys))
        z = self.scheduler.cores_needed(wl, tick_seconds)
        if self.store_dir is not None:
            sis = self.core_indexers(keys)
            # crash-replayed tick: each core skips the blocks it already
            # absorbed (the watermark is (tick, blocks), not just the id)
            todo: list[tuple[StreamingIndexer, list[int]]] = []
            for core in range(self.num_cores):
                done = (sis[core].absorbed_blocks(tick_id)
                        if tick_id is not None else 0)
                if done < 0:
                    continue
                blocks = list(range(core, wl, self.num_cores))[done:]
                if blocks:
                    todo.append((sis[core], blocks))
            if todo:                     # one host copy, skipped when
                host = _host_i32(records)          # fully replayed
                for si, blocks in todo:
                    for b in blocks:
                        si.append_indexed(host[b], out[b].to(si.device),
                                          tick=tick_id)
        qrows = qcounts = None
        if queries is not None and len(queries):
            idx = fold_block_indexes(out, n_rec)
            qrows, qcounts = engine_batch.execute_many(
                idx.packed, queries, num_records=idx.num_records,
                backend=self.backend)
        return TickResult(out, z, tick, qrows, qcounts,
                          measured_seconds=elapsed, measured_mbps=mbps)

    def index_stream(self, ticks: Iterable, keys, tick_seconds: float
                     ) -> tuple[list[torch.Tensor], EnergyReport]:
        """Run a whole workload stream; returns per-tick index tensors and
        the energy report for THIS stream (the runtime-lifetime total stays
        available as ``self.report``)."""
        outputs = []
        stream_report = EnergyReport()
        for records in ticks:
            res = self.run_tick(records, keys, tick_seconds)
            stream_report.merge(res.report)
            if res.indexes is not None:
                outputs.append(res.indexes)
        return outputs, stream_report
