"""Background store maintenance: spill, compaction, gc, and scrub off the
append path (the port's twin of ``repro.serve.maintenance``).

The paper's duty cycle only pays off if the ingest path stays on its fast
track during peak load: a synchronous segment spill (device readback +
checksummed file write + manifest swap) or a compaction cascade in the
middle of ``append()`` is exactly the stall the silicon avoids by
double-buffering its transpose flush.  This module is the software
analogue:

  * :class:`MaintenanceExecutor` — one daemon worker thread draining a
    deduplicated task queue.  ``submit(kind, fn)`` enqueues unless a task
    of that ``kind`` is already pending, so an append storm that crosses
    the flush threshold a thousand times schedules ONE spill.  Task
    bodies run under a :class:`repro_torch.serve.resilience.RetryPolicy`:
    transient failures (an EIO blip, an injected hiccup) back off and
    retry on the worker; only the final failure of a task lands in the
    per-kind failure counters and ``last_failure`` record that
    ``stats()`` (and through it ``service.metrics()``) surfaces.
  * :class:`IndexMaintenance` — wires a durable
    :class:`repro_torch.engine.runtime.StreamingIndexer` onto an executor: the
    indexer's threshold spill becomes an enqueue (appends return
    immediately), the spill itself runs the two-phase
    ``prepare_spill`` / ``commit_spill`` protocol on the worker (crash
    between the phases loses nothing — the WAL still covers every
    block), and a committed spill chains a compaction pass, which chains
    a gc sweep.  A ``scrub`` task CRC-verifies every committed segment
    and repairs corruption from the live in-memory index (the replica
    that is, by construction, bit-identical to what the segment held) —
    the service schedules one on every standby entry, turning idle time
    into integrity checking.  Each task reports stats into the
    executor's log.

Serving stays consistent throughout: queries snapshot the in-memory
packed view (a buffer no later splice writes — splices are functional —
pinned with its record count by the indexer mutex), so a spill, merge, or
segment repair mid-flight never changes a result bit.  The worker issues
its device work (the spill's card-to-host tail copy, a scrub replica's
extraction) on the same default stream as the appends and serving waves,
so the allocator reuses memory in stream order across threads.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable

import numpy as np

from repro_torch.fault import seam
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.resilience import RetryPolicy, is_transient

__all__ = ["MaintenanceExecutor", "IndexMaintenance"]


class MaintenanceExecutor:
    """One background worker, a deduplicated task queue, and a bounded
    log of what ran.  Tasks are ``fn() -> dict`` (the dict is the task's
    stats line); transient exceptions retry under ``retry_policy``, and
    a task's FINAL exception is captured into :attr:`errors` /
    :attr:`failures` / :attr:`last_failure`, never propagated into the
    worker loop."""

    def __init__(self, *, name: str = "repro-maintenance",
                 log_limit: int = 256,
                 retry_policy: RetryPolicy | None = None):
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._pending: set[str] = set()
        self._running: str | None = None
        self._open = True
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        self.counts: collections.Counter = collections.Counter()
        self.log: collections.deque = collections.deque(maxlen=log_limit)
        self.errors: list[tuple[str, BaseException]] = []
        self.failures: collections.Counter = collections.Counter()
        self.retries: collections.Counter = collections.Counter()
        #: kind -> repr of its most recent final failure
        self.last_failure: dict[str, str] = {}
        self._task_seq = 0             # retry-jitter seed (deterministic)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, kind: str, fn: Callable[[], dict | None]) -> bool:
        """Enqueue ``fn`` under ``kind`` unless one is already pending;
        returns whether it was enqueued.  Never blocks (the whole point:
        this is what the append path calls)."""
        with self._cv:
            if not self._open:
                raise RuntimeError("maintenance executor is closed")
            if kind in self._pending:
                return False
            self._pending.add(kind)
            # capture the submitter's span context NOW: the worker's
            # maintenance.<kind> span parents to the operation that
            # scheduled the task (e.g. the wave whose append crossed the
            # spill threshold), not to wherever the worker happens to be
            self._queue.append((kind, fn, obs_trace.current_context()))
            self._cv.notify_all()
            return True

    def flush(self, timeout: float | None = None) -> bool:
        """Block until the queue is empty and no task is running (tasks
        enqueued by running tasks included); returns False on timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._queue and self._running is None,
                timeout=timeout)

    def close(self, *, timeout: float | None = None) -> None:
        """Drain outstanding tasks, then stop the worker.  Idempotent."""
        with self._cv:
            if not self._open:
                return
            self.flush(timeout=timeout)
            self._open = False
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def kill(self) -> None:
        """Crash simulation: stop the worker WITHOUT draining — queued
        tasks are dropped on the floor, exactly like the process dying
        between maintenance passes.  The chaos harness uses this to
        place crash instants; everything dropped must be recoverable
        from WAL + manifest alone."""
        with self._cv:
            self._open = False
            self._queue.clear()
            self._pending.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        """Completed-task counters, per-kind failure/retry accounting,
        and the most recent stats line per kind.  ``errors`` stays an
        int (total final failures) for drop-in assertion compatibility;
        ``failures``/``retries`` break it down per kind and
        ``last_failure`` carries each kind's most recent exception."""
        with self._cv:
            last: dict[str, dict] = {}
            for kind, info in self.log:
                last[kind] = info
            return {"completed": dict(self.counts),
                    "pending": len(self._queue),
                    "errors": len(self.errors),
                    "failures": dict(self.failures),
                    "retries": dict(self.retries),
                    "last_failure": dict(self.last_failure),
                    "last": last}

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cv:
                while self._open and not self._queue:
                    self._cv.wait()
                if not self._queue:
                    return                      # closed/killed and drained
                kind, fn, ctx = self._queue.popleft()
                self._pending.discard(kind)
                self._running = kind
                self._task_seq += 1
                seed = self._task_seq

            def body(kind=kind, fn=fn):
                # the seam fires per ATTEMPT: a scheduled task_error on
                # occurrence k is transient by construction — the retry
                # advances past it
                seam.fire("maintenance.task", kind=kind)
                return fn()

            def on_retry(attempt, exc, kind=kind):
                with self._cv:
                    self.retries[kind] += 1

            try:
                with obs_trace.maybe_span(f"maintenance.{kind}",
                                          parent=ctx):
                    info = self.retry_policy.call(
                        body, seed=seed, retryable=is_transient,
                        on_retry=on_retry)
            except BaseException as e:          # noqa: BLE001 — logged
                info = {"error": repr(e)}
                with self._cv:
                    self.errors.append((kind, e))
                    self.failures[kind] += 1
                    self.last_failure[kind] = repr(e)
            with self._cv:
                self.counts[kind] += 1
                self.log.append((kind, info or {}))
                self._running = None
                self._cv.notify_all()


class IndexMaintenance:
    """Moves a durable session's spill/compaction/gc/scrub onto a
    :class:`MaintenanceExecutor` (see module docstring).  ``detach()``
    restores synchronous threshold spills and the store's auto
    compaction."""

    def __init__(self, indexer: "StreamingIndexer",
                 executor: MaintenanceExecutor):
        if indexer is None or indexer.store is None:
            raise ValueError("IndexMaintenance needs a store-attached "
                             "StreamingIndexer")
        self.si = indexer
        self.store = indexer.store
        self.ex = executor
        self._auto_compact_prev = self.store.auto_compact
        self.store.auto_compact = False        # compaction is OUR task now
        self.si.set_spill_hook(self.schedule_spill)

    def schedule_spill(self) -> None:
        """The indexer's threshold hook: runs on the appending thread,
        only enqueues (deduplicated)."""
        self.ex.submit("spill", self._spill)

    def schedule_compact(self) -> None:
        self.ex.submit("compact", self._compact)

    def schedule_gc(self) -> None:
        self.ex.submit("gc", self._gc)

    def schedule_scrub(self) -> None:
        """CRC-verify + self-heal the committed segments in the
        background (the service enqueues this on standby entry)."""
        self.ex.submit("scrub", self._scrub)

    def detach(self) -> None:
        self.si.set_spill_hook(None)
        self.store.auto_compact = self._auto_compact_prev

    # -------------------------------------------------------------- tasks
    def _spill(self) -> dict:
        token = self.si.prepare_spill()        # slow: readback + file write
        if token is None:
            return {"flushed_records": 0}
        try:
            self.si.commit_spill(token)        # fast: manifest swap
        except BaseException:
            self.si.abort_spill(token)
            raise
        self.schedule_compact()
        self.schedule_gc()                     # rotated WALs are garbage now
        meta = token[0]
        return {"flushed_records": meta.num_records, "segment": meta.file}

    def _compact(self) -> dict:
        st = self.store.compact()
        if st.merges:
            self.schedule_gc()                 # merges created garbage
        return {"merges": st.merges, "segments_merged": st.segments_merged,
                "bytes_written": st.bytes_written,
                "bytes_reclaimed": st.bytes_reclaimed}

    def _gc(self) -> dict:
        st = self.store.gc()
        return {"removed": len(st.removed),
                "bytes_reclaimed": st.bytes_reclaimed,
                "skipped_inflight": len(st.skipped_inflight)}

    def _replica(self, meta) -> np.ndarray | None:
        """A known-good copy of a segment's packed words, re-extracted
        from the live in-memory index (which covers every record the
        store does — appends splice in memory first).  None when the
        view doesn't cover the segment (shouldn't happen on a live
        session; scrub then quarantines instead of repairing)."""
        from repro_torch.engine import policy
        buf, n = self.si.view()
        if meta.start_record + meta.num_records > n:
            return None
        return (policy.extract_packed(buf, meta.start_record,
                                      meta.num_records)
                .cpu().numpy().view(np.uint32))

    def _scrub(self) -> dict:
        st = self.store.scrub(repair=self._replica)
        if st.repaired:
            self.schedule_gc()                 # repairs may leave .tmp debris
        return {"checked": st.checked, "corrupt": len(st.corrupt),
                "repaired": len(st.repaired),
                "quarantined": len(st.quarantined)}
