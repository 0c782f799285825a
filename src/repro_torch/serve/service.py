"""`BitmapService` — the async serving port over a `BitmapDB` session (the
port's twin of ``repro.serve.service``).

The paper's core is duty-cycled silicon: full-throughput bitwise passes
while work is queued, clock-gated near-zero-power standby the moment it
is not.  The serving surface this module replaces (`serve_step`'s bare
function) could not express that cycle — every caller hand-assembled its
own batches, and concurrent callers never coalesced into the wide
dispatches that make the engine's bucketed executors pay off.  The
service is the missing lifecycle port:

  * **submit/drain/close** — ``submit(query)`` returns a
    :class:`QueryFuture` immediately; a deadline-driven micro-batch
    scheduler coalesces everything submitted within ``max_delay_ms`` (or
    up to ``max_batch``) from ANY number of threads into ONE
    ``query_many`` batch — plan-shape bucketing then serves the whole
    coalesced batch in a handful of vmapped dispatches.  Results are
    bit-identical to sequential ``serve_step`` calls, resolved in
    submission order (a caller's futures never complete out of order).
  * **admission control** — a bounded queue (``max_queue``):
    ``admission="block"`` applies backpressure to submitters,
    ``admission="reject"`` raises :class:`ServiceOverloaded` (load-shed).
  * **standby** — idle past ``idle_after_ms``, the scheduler quiesces
    into a standby state; the energy meter switches from active to
    standby power (the calibrated silicon model via
    :class:`repro_torch.core.elastic.ElasticScheduler` — CG+RBB by default),
    and the next submission wakes it.  ``metrics()`` reports the
    active/standby joule split, latency percentiles, throughput, energy
    per query, coalesced batch sizes, and the session's plan-cache
    health.
  * **background maintenance** — durable sessions detach segment spill,
    compaction, and gc from the append path onto a
    :class:`repro_torch.serve.maintenance.MaintenanceExecutor`: ``append()``
    only logs to the WAL and splices in memory; the flush threshold
    enqueues a two-phase background spill (crash between file write and
    manifest swap loses nothing).  Serving reads a snapshot-consistent
    packed view throughout.

``background=False`` gives a one-shot synchronous service (no threads):
submissions queue, ``drain()``/``flush()`` executes everything on the
calling thread in coalesced batches — what
:func:`repro_torch.serve.step.make_bitmap_query_step` wraps.

On the card, submitters, appends, the scheduler thread and the maintenance
thread all issue their work on the same default stream.  Appends splice
functionally (every append writes a fresh buffer), so a snapshot one
thread holds is never torn by another, and the caching allocator reuses
memory in stream order.  Each wave ends with a synchronize of the stream
it ran on, so a kernel fault surfaces inside the wave that caused it.
The fallback ladder's ``ref`` backend and per-query isolation are the
reference's semantics; ``health()`` counts every wave they serve.  On a
CUDA device a plain fallback (``ref``, ``bulk``) is no fallback: it would
serve around a failing kernel and hide it, so there a wave the kernels
cannot serve goes to per-query isolation, which rejects each future with
the kernel's error.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core.bic import BICConfig, PaperConfig
from repro_torch.core.elastic import ElasticScheduler, EnergyReport, PowerState
from repro_torch.engine.policy import stream_sync
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.energy import EnergyLedger
from repro_torch.serve.resilience import CircuitBreaker, RetryPolicy, is_transient

__all__ = ["BitmapService", "ServiceConfig", "ServiceMetrics",
           "QueryFuture", "ServiceOverloaded", "ServiceClosed",
           "DeadlineExceeded"]


#: the plain-torch backends: references on the card, never its fallback
_PLAIN_BACKENDS = ("ref", "bulk")


class ServiceOverloaded(RuntimeError):
    """Admission control rejected (or timed out) a submission.  Carries
    the admission decision's inputs as fields (and in the message), so a
    load-shedding caller can adapt instead of parse."""

    def __init__(self, reason: str, *, queue_depth: int | None = None,
                 limit: int | None = None, admission: str | None = None):
        detail = [reason]
        if queue_depth is not None:
            detail.append(f"queue_depth={queue_depth}")
        if limit is not None:
            detail.append(f"limit={limit}")
        if admission is not None:
            detail.append(f"admission={admission!r}")
        super().__init__(" ".join([detail[0]]
                                  + ([f"({', '.join(detail[1:])})"]
                                     if len(detail) > 1 else [])))
        self.queue_depth = queue_depth
        self.limit = limit
        self.admission = admission


class ServiceClosed(RuntimeError):
    """submit() after close()."""


class DeadlineExceeded(RuntimeError):
    """A query's per-request deadline budget expired before its wave
    dispatched; the future rejects instead of serving stale-late."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of one :class:`BitmapService` (see module docstring)."""
    max_batch: int = 256          # widest coalesced dispatch
    max_delay_ms: float = 2.0     # oldest request waits at most this long
    max_queue: int = 8192         # admission bound (queued, not in-flight)
    admission: str = "block"      # "block" (backpressure) | "reject"
    idle_after_ms: float = 100.0  # awake-idle this long -> standby
    background: bool = True       # False: one-shot synchronous mode
    maintenance: bool = True      # background spill/compact/gc (durable)
    #: serve batches with power-of-two padded result arrays (futures
    #: index their real slice) — the reference's knob, which saves it jit
    #: retraces; here it only keeps the result shapes to a closed set
    pad_output: bool = True
    latency_window: int = 8192    # per-request latency samples kept
    # --- self-healing knobs (see ARCHITECTURE.md, "Fault fabric")
    #: every submission's default deadline budget (None = no deadline);
    #: ``submit(deadline_ms=)`` overrides per query
    default_deadline_ms: float | None = None
    wave_retries: int = 2         # transient wave failures retried
    retry_base_ms: float = 5.0    # first retry backoff (grows, jittered)
    breaker_threshold: int = 3    # confirmed backend failures to trip
    breaker_cooldown_s: float = 2.0
    #: backend degraded waves fall back to (the reference executor:
    #: slowest, simplest, last to break); None = no fallback.  A plain
    #: backend is no fallback on a CUDA device (see the module docstring)
    fallback_backend: str | None = "ref"
    #: enqueue a background CRC scrub of the committed segments on every
    #: standby entry (durable sessions) — idle time buys integrity
    scrub_on_standby: bool = True
    bic_config: BICConfig = PaperConfig
    power_state: PowerState = PowerState()

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', "
                             f"got {self.admission!r}")
        if self.wave_retries < 0:
            raise ValueError("wave_retries must be >= 0")
        if self.default_deadline_ms is not None \
                and self.default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be positive")


class QueryFuture:
    """Handle to one submitted query.  Resolves to its slice of the
    coalesced batch; ``.rows``/``.count``/``.ids`` block until then
    (mirroring :class:`repro_torch.db.Result`)."""

    __slots__ = ("query", "_ev", "_rows", "_counts", "_qi", "_n", "_err",
                 "resolve_seq", "trace_id")

    def __init__(self, query):
        self.query = query
        self._ev = threading.Event()
        self._rows = None
        self._counts = None
        self._qi = 0
        self._n = 0
        self._err: BaseException | None = None
        #: global resolution sequence number (set when served) — lets a
        #: caller verify its futures completed in submission order
        self.resolve_seq: int = -1
        #: the query's trace id when a tracer was installed at submit
        #: (joins this future to its admission/queue/serve spans)
        self.trace_id: int | None = None

    def _resolve(self, rows, counts, qi: int, n: int) -> None:
        self._rows, self._counts, self._qi, self._n = rows, counts, qi, n
        self._ev.set()

    def _reject(self, err: BaseException) -> None:
        self._err = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def _ready(self, timeout: float | None = None) -> None:
        if not self._ev.wait(timeout):
            raise TimeoutError(f"query not served within {timeout}s")
        if self._err is not None:
            raise self._err

    def result(self, timeout: float | None = None):
        """(packed row (Nw,) int32, count) — the engine tensors, exactly
        what a sequential ``serve_step([q])`` call would return for this
        query.  Blocks until served; raises what the query raised."""
        self._ready(timeout)
        return self._rows[self._qi], self._counts[self._qi]

    def exception(self, timeout: float | None = None):
        self._ev.wait(timeout)
        return self._err

    @property
    def rows(self):
        return self.result()[0]

    @property
    def count(self) -> int:
        self._ready()
        return int(self._counts[self._qi])

    @property
    def ids(self) -> np.ndarray:
        """Matching record ordinals (sorted)."""
        from repro_torch.db.result import unpack_ids
        return unpack_ids(self.rows.cpu().numpy(), self._n)

    def __repr__(self) -> str:
        state = ("failed" if self._err is not None
                 else "done" if self.done() else "pending")
        return f"<QueryFuture {state} {self.query!r:.60}>"


@dataclasses.dataclass
class ServiceMetrics:
    """One consistent snapshot of a service's meters (see
    :meth:`BitmapService.metrics`)."""
    served: int
    batches: int
    rejected: int
    inflight: int
    state: str
    uptime_seconds: float
    queries_per_sec: float
    latency_p50_ms: float
    latency_p99_ms: float
    latency_mean_ms: float
    batch_mean: float
    batch_max: int
    busy_seconds: float
    awake_idle_seconds: float
    standby_seconds: float
    standby_entries: int
    wakes: int
    active_joules: float
    standby_joules: float
    energy_per_query_j: float
    plan_cache: dict
    maintenance: dict | None
    health: dict
    #: energy-ledger snapshot: per-phase joules, pJ-per-query,
    #: pJ-per-indexed-bit, operating points (see repro_torch.obs.energy)
    energy: dict | None = None

    def to_dict(self) -> dict:
        """Plain-dict form (what the fabric protocol puts on the wire
        and what artifact writers serialize)."""
        return dataclasses.asdict(self)


class _Item:
    __slots__ = ("query", "future", "t", "deadline", "aspan", "qspan")

    def __init__(self, query, future, t, deadline=None):
        self.query, self.future, self.t = query, future, t
        self.deadline = deadline       # absolute perf_counter, or None
        # traced submits carry their admission + live queue spans here;
        # both are recorded in ONE batch at wave pickup, so submitter
        # threads never contend on the tracer ring lock
        self.aspan = None
        self.qspan = None


class BitmapService:
    """The lifecycle port (use :meth:`open`, or
    :meth:`repro_torch.db.BitmapDB.serve`); also a context manager."""

    def __init__(self, db: "BitmapDB", config: ServiceConfig):
        self._db = db
        self.config = config
        self._cv = threading.Condition()
        self._pending: collections.deque[_Item] = collections.deque()
        self._inflight = 0             # accepted, not yet resolved
        self._openflag = True
        self._state = "active"
        self._close_lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._runtime = None           # attach_runtime (shared duty cycle)
        # --- energy meter: calibrated silicon powers, one virtual core.
        # The ledger OWNS the service's EnergyReport: every joule enters
        # through its charge(), so per-query attribution reconciles with
        # the scheduler totals by construction.
        self._sched = ElasticScheduler(1, config.bic_config,
                                       config.power_state)
        self._ledger = EnergyLedger(self._sched)
        self._energy = self._ledger.report
        self._elock = threading.Lock()
        self._mark = time.perf_counter()
        self._t_open = self._mark
        # --- meters: one typed registry; metrics()/health() are views.
        # Metric locks are leaves (never held while taking another lock),
        # so updates are safe under the cv AND reads never deadlock.
        self.registry = obs_metrics.Registry()
        reg = self.registry
        self._resolve_seq = 0
        self._wave_ids = itertools.count(1)
        # bounded lifetime-uniform reservoir: p50/p99 stay stable (and
        # memory flat) over multi-hour runs, unlike a sliding window
        self._lat = reg.reservoir("latency_ms",
                                  capacity=config.latency_window, seed=21)
        self._lat_hist = reg.histogram("latency_ms_hist",
                                       obs_metrics.LATENCY_BUCKETS_MS)
        self._batch_sizes = collections.deque(maxlen=4096)
        self._served_c = reg.counter("served_total")
        self._batches_c = reg.counter("batches_total")
        self._rejected_c = reg.counter("rejected_total")
        self._standby_entries_c = reg.counter("standby_entries_total")
        self._wakes_c = reg.counter("wakes_total")
        self._inflight_g = reg.gauge("inflight")
        self._queue_g = reg.gauge("queue_depth")
        # --- self-healing state (see _execute)
        self._retry = RetryPolicy(max_attempts=config.wave_retries + 1,
                                  base_delay_s=config.retry_base_ms / 1e3)
        self._breaker = CircuitBreaker(
            failure_threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_s)
        fb = config.fallback_backend
        if fb in _PLAIN_BACKENDS and db.device.type == "cuda":
            fb = None                  # never serve around the kernels
        self._fallback = None if fb == db.backend else fb
        self._wave_retries_c = reg.counter(
            "wave_retries_total", "transient wave failures retried")
        self._degraded_waves_c = reg.counter(
            "degraded_waves_total", "waves served by the fallback")
        self._fallback_queries_c = reg.counter(
            "fallback_queries_total", "queries those waves carried")
        self._deadline_rejected_c = reg.counter(
            "deadline_rejected_total", "futures rejected past-deadline")
        self._isolated_failures_c = reg.counter(
            "isolated_failures_total", "per-query failures isolated")
        # graft the lower layers' registries: ONE exportable metric tree
        sub = getattr(db, "registry", None)
        if sub is not None:
            reg.attach("db", sub)
        store = getattr(db, "store", None)
        if store is not None and getattr(store, "registry", None) is not None:
            reg.attach("store", store.registry)
        reg.attach("engine", obs_metrics.GLOBAL)
        # --- background maintenance (durable sessions only)
        self._maint = None
        self._maint_ex = None
        si = getattr(db, "indexer", None)
        if config.maintenance and si is not None and si.store is not None:
            from repro_torch.serve.maintenance import (IndexMaintenance,
                                                 MaintenanceExecutor)
            self._maint_ex = MaintenanceExecutor()
            self._maint = IndexMaintenance(si, self._maint_ex)
        # --- scheduler thread
        self._thread = None
        if config.background:
            self._thread = threading.Thread(
                target=self._run, name="repro-bitmap-service", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def open(cls, index, *, config: ServiceConfig | None = None,
             backend: str = "auto", **kw) -> "BitmapService":
        """Open a service over a :class:`repro_torch.db.BitmapDB` session (or
        anything :func:`repro_torch.serve.step.make_bitmap_query_step` accepts:
        a raw ``BitmapIndex`` / ``StoredIndex`` is wrapped read-only).
        Extra keywords construct the :class:`ServiceConfig`."""
        if config is not None and kw:
            raise ValueError("pass config= or individual keywords, "
                             "not both")
        from repro_torch import db as _db
        if not isinstance(index, _db.BitmapDB):
            index = _db.BitmapDB.from_index(index, backend=backend)
        return cls(index, config or ServiceConfig(**kw))

    def __enter__(self) -> "BitmapService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def db(self) -> "BitmapDB":
        return self._db

    @property
    def state(self) -> str:
        """"active" | "standby" | "closed"."""
        with self._cv:
            if not self._openflag and self._inflight == 0:
                return "closed"
            return self._state

    # --------------------------------------------------------------- submit
    def submit(self, query, *, timeout: float | None = None,
               deadline_ms: float | None = None) -> QueryFuture:
        """Enqueue one query (expression / predicate / pre-built plan —
        anything the session's ``query_many`` accepts); returns its
        :class:`QueryFuture` immediately.  Admission control applies:
        with a full queue, ``block`` waits (``timeout`` bounds it),
        ``reject`` raises :class:`ServiceOverloaded`.

        ``deadline_ms`` (default ``config.default_deadline_ms``) is the
        query's end-to-end latency budget: if its wave has not
        dispatched by then — retries, degraded-mode fallbacks, and
        queue time all count against it — the future rejects with
        :class:`DeadlineExceeded` instead of serving arbitrarily late."""
        cfg = self.config
        if deadline_ms is None:
            deadline_ms = cfg.default_deadline_ms
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        tr = obs_trace.TRACER
        t_sub = time.perf_counter() if tr is not None else 0.0
        while True:
            flush_first = False
            with self._cv:
                if not self._openflag:
                    raise ServiceClosed(
                        "submit() on a closed BitmapService")
                if len(self._pending) >= cfg.max_queue:
                    if not cfg.background:
                        # one-shot mode has no consumer thread: the
                        # submitter IS the executor, so a full queue
                        # flushes here instead of deadlocking
                        flush_first = True
                    elif cfg.admission == "reject":
                        self._rejected_c.inc()
                        raise ServiceOverloaded(
                            "queue full",
                            queue_depth=len(self._pending),
                            limit=cfg.max_queue, admission=cfg.admission)
                    else:
                        left = (None if deadline is None
                                else deadline - time.perf_counter())
                        if (left is not None and left <= 0) \
                                or not self._cv.wait(timeout=left):
                            self._rejected_c.inc()
                            raise ServiceOverloaded(
                                f"queue full after {timeout}s "
                                "backpressure",
                                queue_depth=len(self._pending),
                                limit=cfg.max_queue,
                                admission=cfg.admission)
                        continue              # re-check queue + openflag
                else:
                    now = time.perf_counter()
                    fut = QueryFuture(query)
                    depth = len(self._pending)
                    it = _Item(query, fut, now,
                               None if deadline_ms is None
                               else now + deadline_ms / 1e3)
                    if tr is not None:
                        # per-query trace: admission (submit -> accept)
                        # then a live queue span ended at wave pickup
                        tid = tr.new_trace()
                        fut.trace_id = tid
                        it.aspan = tr.make("admission", trace_id=tid,
                                           t0=t_sub, t1=now,
                                           queue_depth=depth)
                        it.qspan = tr.make("queue", trace_id=tid,
                                           parent_id=it.aspan.span_id,
                                           t0=now)
                    self._pending.append(it)
                    self._inflight += 1
                    self._cv.notify_all()
                    break
            if flush_first:
                self._flush_inline()
        if not cfg.background and len(self._pending) >= cfg.max_batch:
            self._flush_inline()
        return fut

    def submit_many(self, queries: Sequence, *,
                    timeout: float | None = None) -> list[QueryFuture]:
        return [self.submit(q, timeout=timeout) for q in queries]

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every accepted submission has resolved (exactly
        once — nothing dropped, nothing duplicated); returns False on
        timeout.  In one-shot mode this is also what executes."""
        if not self.config.background:
            self._flush_inline()
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=timeout)

    def close(self, timeout: float | None = None) -> None:
        """Drain, stop the scheduler, flush + detach background
        maintenance.  Idempotent AND safe to call concurrently — with
        another ``close()`` (the loser waits, then no-ops) and with
        in-flight ``submit()`` (a racing submit either wins admission
        and resolves before the scheduler exits, or raises
        :class:`ServiceClosed`)."""
        with self._close_lock:
            with self._cv:
                already = not self._openflag
                self._openflag = False
                self._cv.notify_all()
            if not self.config.background:
                self._flush_inline()
            if self._thread is not None:
                self._thread.join(timeout=timeout)
                self._thread = None
            if not already and self._maint is not None:
                # detach FIRST (restores synchronous spills) so an
                # append racing this close can never hit a closed
                # executor
                self._maint.detach()
                self._maint_ex.close(timeout=timeout)
            with self._elock:
                self._charge_locked(time.perf_counter())

    def warmup(self, queries: Sequence, *, max_batch: int | None = None
               ) -> int:
        """Warm every bucketed executor the scheduler can hit for this
        query population BEFORE traffic arrives: for each distinct plan
        shape among ``queries``, run one dispatch at every power-of-two
        bucket size up to ``max_batch`` — on EVERY backend the cost model
        might route a wave to (``costmodel.candidates()`` of the session's
        device type for an ``auto`` session, the pinned backend and the
        fallback otherwise).  The reference pre-compiles its jit traces
        here; on the card the same dispatches build the kernels (once per
        process), fill the backend-keyed executor caches and grow the
        caching allocator's pools to the wave sizes, so neither a
        cost-model backend switch nor a first-sight batch size stalls a
        wave mid-serving.  Returns the number of warm dispatches (the
        reference's count for the same plans)."""
        from repro_torch.engine import batch as engine_batch
        from repro_torch.engine import costmodel, planner

        db = self._db
        reps: dict = {}
        for q in queries:
            pl = db._plan_for(q)
            if isinstance(pl, planner.CompositePlan):
                continue                # served out-of-band, no executor
            _, shape, _, _ = engine_batch._lowered(pl)
            if shape is not None and shape not in reps:
                reps[shape] = pl
        cap = max(1, max_batch if max_batch is not None
                  else self.config.max_batch)
        # pinned sessions also warm the breaker's fallback backend: a
        # degraded wave must not pay a first-sight compile on top of the
        # failure that degraded it (CPU auto candidates already include ref)
        names = (costmodel.candidates(device=db.device)
                 if db.backend == "auto"
                 else tuple(n for n in (db.backend, self._fallback)
                            if n is not None))
        view = db._view()
        segmented = hasattr(view, "parts")
        dispatches = 0
        pad = self.config.pad_output
        for pl in reps.values():
            s = 1
            while s <= cap:
                for name in names:
                    if segmented:
                        engine_batch.execute_many_segments(
                            view.parts, [pl] * s, backend=name)
                    else:
                        engine_batch.execute_many(
                            view.packed, [pl] * s,
                            num_records=view.num_records, backend=name,
                            pad_output=pad)
                    dispatches += 1
                if s == cap:
                    break
                s = min(s * 2, cap)
        return dispatches

    # -------------------------------------------------- shared duty cycle
    def attach_runtime(self, runtime) -> "BitmapService":
        """Share ONE active⇄standby duty cycle and ONE
        :class:`~repro_torch.obs.energy.EnergyLedger` between indexing and
        serving: the :class:`~repro_torch.engine.runtime.MulticoreRuntime`'s
        tick reports charge into THIS service's ledger (so the energy
        snapshot/pJ-per-indexed-bit roll-ups cover both), and
        :meth:`run_tick` drives the service's power state alongside the
        indexing tick — wake at tick start, drop back to standby when a
        tick ends with nothing queued."""
        with self._cv:
            self._runtime = runtime
        runtime.bind_ledger(self._ledger)
        return self

    def run_tick(self, records, keys, tick_seconds: float, **kw):
        """One indexing tick through the attached runtime, synchronized
        with the serving duty cycle (see :meth:`attach_runtime`).
        Accepts exactly :meth:`repro_torch.engine.runtime.MulticoreRuntime.
        run_tick`'s arguments and returns its ``TickResult``."""
        rt = self._runtime
        if rt is None:
            raise RuntimeError("no runtime attached — call "
                               "attach_runtime(MulticoreRuntime) first")
        wl = 0 if records is None else records.shape[0]
        if wl:
            with self._cv:
                if self._state == "standby":
                    with self._elock:
                        self._charge_locked(time.perf_counter())
                    self._state = "active"
                    self._wakes_c.inc()
        out = rt.run_tick(records, keys, tick_seconds, **kw)
        if wl:
            with self._cv:
                idle = not self._pending and self._inflight == 0
            if idle:
                self.standby()
        return out

    def standby(self) -> None:
        """Explicitly drop into standby now (the idle timer does this on
        its own after ``idle_after_ms``); the next submission wakes."""
        with self._cv:
            if self._state == "active":
                with self._elock:
                    self._charge_locked(time.perf_counter())
                self._state = "standby"
                self._standby_entries_c.inc()
        self._schedule_standby_scrub()

    def _schedule_standby_scrub(self) -> None:
        """Standby entry enqueues one background CRC scrub (deduplicated
        by the executor): the duty cycle's idle phase doubles as the
        integrity-checking window."""
        if not self.config.scrub_on_standby or self._maint is None:
            return
        try:
            self._maint.schedule_scrub()
        except RuntimeError:
            pass                       # executor already closed (shutdown)

    # ------------------------------------------------------------ scheduler
    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:      # noqa: BLE001 — never hang callers
            with self._cv:
                self._openflag = False
                while self._pending:
                    it = self._pending.popleft()
                    it.future._reject(e)
                    self._inflight -= 1
                self._cv.notify_all()
            raise

    def _run_loop(self) -> None:
        cfg = self.config
        idle_after = cfg.idle_after_ms / 1e3
        max_delay = cfg.max_delay_ms / 1e3
        cv = self._cv
        while True:
            entered_standby = False
            with cv:
                # wait for work; a long-enough lull clock-gates us
                idle_t0 = time.perf_counter()
                while self._openflag and not self._pending:
                    if self._state == "active":
                        if not cv.wait(timeout=idle_after) \
                                and not self._pending \
                                and time.perf_counter() - idle_t0 \
                                >= idle_after:
                            with self._elock:
                                self._charge_locked(time.perf_counter())
                            self._state = "standby"
                            self._standby_entries_c.inc()
                            entered_standby = True
                            break
                    else:
                        cv.wait()
            if entered_standby:
                # outside the cv: the scrub enqueue takes the executor's
                # lock, and submissions must not wait on it
                self._schedule_standby_scrub()
            with cv:
                while self._openflag and not self._pending:
                    cv.wait()                   # standby: wait for a wake
                if not self._pending:
                    break                       # closed and drained
                if self._state == "standby":
                    with self._elock:
                        self._charge_locked(time.perf_counter())
                    self._state = "active"
                    self._wakes_c.inc()
                # batch window: the OLDEST request's deadline drives it
                deadline = self._pending[0].t + max_delay
                while (len(self._pending) < cfg.max_batch
                       and self._openflag):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    cv.wait(timeout=left)
                take = min(len(self._pending), cfg.max_batch)
                batch = [self._pending.popleft() for _ in range(take)]
                cv.notify_all()                 # queue space freed
            self._execute(batch)

    def _flush_inline(self) -> None:
        """One-shot mode: run everything queued, on the calling thread,
        in coalesced batches.  Serialized: concurrent one-shot
        submitters (or a racing ``close()``) must not interleave
        ``_execute`` — the resolve-sequence counter and the energy marks
        assume one executor at a time."""
        with self._flush_lock:
            while True:
                with self._cv:
                    if not self._pending:
                        return
                    take = min(len(self._pending), self.config.max_batch)
                    batch = [self._pending.popleft()
                             for _ in range(take)]
                    self._cv.notify_all()
                self._execute(batch)

    def _wave(self, queries: list, backend: str | None) -> tuple:
        """One coalesced dispatch: (rows, counts, n).  ``backend=None``
        serves on the session's preferred backend; a name routes the
        whole wave there (the breaker's degraded path)."""
        rb = self._db.query_many(queries, pad_output=self.config.pad_output,
                                 backend=backend)
        # read the record count AFTER query_many snapshots its view:
        # rows past the view are masked zero, so an at-most-newer n
        # can only be a harmless over-bound for .ids — the stale
        # ordering would silently drop freshly appended matches
        n = self._db.num_records
        tr = obs_trace.TRACER
        if tr is None:
            rows, counts = rb.materialize()
            stream_sync(rows.device)
        else:
            with tr.span("device.execute", queries=len(queries),
                         backend=backend or self._db.backend):
                rows, counts = rb.materialize()
                stream_sync(rows.device)
        return rows, counts, n

    def _serve_wave(self, queries: list) -> tuple[tuple | None, str]:
        """The self-healing dispatch ladder for one wave of queries.

        1. **retry** — transient failures (I/O blips, injected faults)
           on the preferred backend back off and retry, with
           deterministic jitter seeded by the wave number.
        2. **breaker + fallback** — when retries exhaust AND the same
           wave succeeds on ``fallback_backend``, the failure is
           confirmed backend-specific: the breaker records it (tripping
           after ``breaker_threshold``) and the wave is served degraded
           — slower, never wrong.  An open breaker skips the preferred
           backend entirely until a cooldown probe closes it.
        3. **give up the wave** — both paths failed; the caller
           falls through to per-query isolation (a poisoned QUERY, not
           a broken backend, so the breaker records nothing).

        Returns ``(result | None, mode)`` with mode one of
        ``"preferred"``/``"fallback"``/``"failed"``."""
        fallback = self._fallback
        have_fallback = fallback is not None

        def preferred():
            return self._wave(queries, None)

        def on_retry(attempt, exc):
            self._wave_retries_c.inc()

        if self._breaker.allow():
            try:
                out = self._retry.call(preferred,
                                       seed=self._batches_c.value,
                                       retryable=is_transient,
                                       on_retry=on_retry)
            except BaseException:               # noqa: BLE001 — ladder
                if not have_fallback:
                    # no second opinion available: cannot distinguish a
                    # broken backend from a poisoned query, so the
                    # breaker learns nothing
                    return None, "failed"
                try:
                    out = self._wave(queries, fallback)
                except BaseException:           # noqa: BLE001 — ladder
                    # both backends failed -> the queries are the
                    # problem; the breaker learns nothing from them
                    return None, "failed"
                # fallback succeeded where the preferred backend kept
                # failing: THAT is a confirmed backend failure
                self._breaker.record_failure()
                return out, "fallback"
            self._breaker.record_success()
            return out, "preferred"
        if not have_fallback:
            return None, "failed"
        try:
            return self._wave(queries, fallback), "fallback"
        except BaseException:                   # noqa: BLE001 — ladder
            return None, "failed"

    def _execute(self, batch: list[_Item]) -> None:
        tr = obs_trace.TRACER
        if tr is None:
            self._execute_impl(batch, None, 0)
            return
        # the coalesce span roots its OWN per-wave trace; each query's
        # queue span ends here carrying wave=wid, which joins the
        # per-query traces to the wave's coalesce/dispatch/reassembly
        # subtree (and its serve spans carry it back)
        wid = next(self._wave_ids)
        t_pick = tr.clock()
        ended = []
        for it in batch:
            sp = it.qspan
            if sp is not None:
                sp.t1 = t_pick
                sp.attrs["wave"] = wid
                ended.append(it.aspan)
                ended.append(sp)
        tr.record_batch(ended)
        with tr.span("coalesce", wave=wid, size=len(batch)):
            self._execute_impl(batch, tr, wid)

    def _execute_impl(self, batch: list[_Item], tr, wid: int) -> None:
        with self._elock:                       # waiting span was "awake"
            self._charge_locked(time.perf_counter())
        lats: list[float] = []
        # deadline budgets: queries whose budget expired in the queue are
        # excluded from the dispatch (their rejection is sequenced with
        # the wave's resolutions below, preserving per-caller order)
        now = time.perf_counter()
        live = [it for it in batch
                if it.deadline is None or now <= it.deadline]
        expired = len(batch) - len(live)
        out, mode = (self._serve_wave([it.query for it in live])
                     if live else ((None, None, 0), "preferred"))
        if mode == "failed":
            # wave-level failure survived retry AND fallback (e.g. one
            # bad key id poisons planning): isolate per query so one
            # caller's typo cannot fail another caller's future
            for it in batch:
                self._resolve_seq += 1
                it.future.resolve_seq = self._resolve_seq
                if it.deadline is not None and it.deadline < now:
                    it.future._reject(DeadlineExceeded(
                        f"deadline budget exhausted before dispatch "
                        f"({(now - it.t) * 1e3:.1f}ms in queue)"))
                    continue
                try:
                    r, c = self._db.query_many([it.query]).materialize()
                    stream_sync(r.device)
                    it.future._resolve(r, c, 0, self._db.num_records)
                except BaseException as e:      # noqa: BLE001 — to future
                    self._isolated_failures_c.inc()
                    it.future._reject(e)
            done = time.perf_counter()
        else:
            rows, counts, n = out
            done = time.perf_counter()
            if tr is None:
                qi = 0
                for it in batch:
                    self._resolve_seq += 1
                    it.future.resolve_seq = self._resolve_seq
                    if it.deadline is not None and it.deadline < now:
                        it.future._reject(DeadlineExceeded(
                            f"deadline budget exhausted before dispatch "
                            f"({(now - it.t) * 1e3:.1f}ms in queue)"))
                        continue
                    lats.append(done - it.t)
                    it.future._resolve(rows, counts, qi, n)
                    qi += 1
            else:
                with tr.span("reassembly", wave=wid, size=len(batch),
                             expired=expired):
                    qi = 0
                    for it in batch:
                        self._resolve_seq += 1
                        it.future.resolve_seq = self._resolve_seq
                        if it.deadline is not None and it.deadline < now:
                            it.future._reject(DeadlineExceeded(
                                f"deadline budget exhausted before "
                                f"dispatch ({(now - it.t) * 1e3:.1f}ms "
                                f"in queue)"))
                            continue
                        lats.append(done - it.t)
                        it.future._resolve(rows, counts, qi, n)
                        qi += 1
        with self._elock:                       # execution span was "busy"
            self._charge_locked(time.perf_counter(), busy=True)
        # attribute THIS wave's accumulated joules across its queries
        # (always, traced or not, so the unattributed pool drains per
        # wave and reconcile() holds at any quiescent point)
        served = ([it for it in batch if it.future._err is None]
                  if mode == "failed" else live)
        pjs = (self._ledger.attribute(
            [it.future.trace_id or 0 for it in served])
            if served else [])
        if tr is not None:
            # per-query serve span in the QUERY's trace: parented under
            # its queue span, carrying wave/mode/pJ attribution
            serves = []
            for it, pj in zip(served, pjs):
                if it.future.trace_id is None or it.qspan is None:
                    continue        # tracer installed mid-flight
                serves.append(tr.make(
                    "serve", trace_id=it.future.trace_id,
                    parent_id=it.qspan.span_id, t0=now, t1=done,
                    wave=wid, mode=mode, pj=pj))
            tr.record_batch(serves)
        for v in lats:
            self._lat.observe(v * 1e3)
            self._lat_hist.observe(v * 1e3)
        self._served_c.add(len(batch))
        self._batches_c.inc()
        self._deadline_rejected_c.add(expired)
        if mode == "fallback":
            self._degraded_waves_c.inc()
            self._fallback_queries_c.add(len(live))
        with self._cv:          # inflight gates drain(); cv-guarded
            self._batch_sizes.append(len(batch))
            self._inflight -= len(batch)
            self._cv.notify_all()               # drain()ers

    # --------------------------------------------------------------- energy
    def _charge_locked(self, now: float, *, busy: bool = False) -> None:
        """Charge the span since the last mark at the CURRENT mode's
        power: executing -> active power over busy time; awake-idle ->
        active power too (the clock is not gated — exactly why standby
        exists); standby -> the calibrated CG+RBB standby power."""
        dt = now - self._mark
        self._mark = now
        if dt <= 0:
            return
        phase = ("busy" if busy
                 else "awake_idle" if self._state == "active"
                 else "standby")
        self._ledger.charge(phase, dt)

    @property
    def energy(self) -> EnergyReport:
        """The live energy report (charged through the last state
        change/dispatch; ``metrics()`` charges up to now first)."""
        return self._energy

    # -------------------------------------------------------------- metrics
    def health(self) -> dict:
        """The self-healing surface in one dict: circuit-breaker state,
        store quarantines/repairs, retry and degraded-mode counters, and
        per-kind maintenance failure accounting.  ``degraded`` is True
        whenever the service is currently serving around a failure
        (breaker not closed, or a segment quarantined) — correct but
        slower, repair in progress."""
        breaker = self._breaker.snapshot()
        store = getattr(self._db, "store", None)
        store_health = store.health() if store is not None else None
        maint = (self._maint_ex.stats() if self._maint_ex is not None
                 else None)
        counters = {
            "wave_retries": self._wave_retries_c.value,
            "degraded_waves": self._degraded_waves_c.value,
            "fallback_queries": self._fallback_queries_c.value,
            "deadline_rejected": self._deadline_rejected_c.value,
            "isolated_failures": self._isolated_failures_c.value,
        }
        degraded = breaker["state"] != "closed" or bool(
            store_health and store_health["quarantined"])
        return {"degraded": degraded,
                "breaker": breaker,
                "fallback_backend": self._fallback,
                "store": store_health,
                "maintenance_failures": (
                    {"failures": maint["failures"],
                     "retries": maint["retries"],
                     "last_failure": maint["last_failure"]}
                    if maint is not None else None),
                **counters}

    @property
    def ledger(self):
        """The service's :class:`repro_torch.obs.energy.EnergyLedger` (owns
        :attr:`energy`; exposes per-query pJ and ``reconcile()``)."""
        return self._ledger

    def metrics(self) -> ServiceMetrics:
        with self._elock:
            self._charge_locked(time.perf_counter())
        with self._cv:          # consistent snapshot vs a live scheduler
            sizes = np.asarray(self._batch_sizes, np.int64)
            inflight = self._inflight
            queued = len(self._pending)
        self._inflight_g.set(inflight)
        self._queue_g.set(queued)
        served = self._served_c.value
        now = time.perf_counter()
        total_j = self._energy.total_joules
        maint = self._maint_ex.stats() if self._maint_ex is not None \
            else None
        phase_s = self._ledger.phase_seconds
        db = self._db
        nrec = getattr(db, "num_records", 0)
        nkeys = getattr(db, "num_keys", 0)
        return ServiceMetrics(
            served=served, batches=self._batches_c.value,
            rejected=self._rejected_c.value,
            inflight=inflight, state=self.state,
            uptime_seconds=now - self._t_open,
            queries_per_sec=served / max(now - self._t_open, 1e-9),
            latency_p50_ms=self._lat.percentile(50),
            latency_p99_ms=self._lat.percentile(99),
            latency_mean_ms=self._lat.mean,
            batch_mean=float(sizes.mean()) if sizes.size else 0.0,
            batch_max=int(sizes.max()) if sizes.size else 0,
            busy_seconds=phase_s["busy"],
            awake_idle_seconds=phase_s["awake_idle"],
            standby_seconds=phase_s["standby"],
            standby_entries=self._standby_entries_c.value,
            wakes=self._wakes_c.value,
            active_joules=self._energy.active_joules,
            standby_joules=self._energy.standby_joules,
            energy_per_query_j=total_j / served if served else 0.0,
            plan_cache=self._db.cache_stats()
            if hasattr(self._db, "cache_stats") else {},
            maintenance=maint,
            health=self.health(),
            energy=self._ledger.snapshot(num_records=nrec,
                                         num_keys=nkeys))

    def __repr__(self) -> str:
        return (f"<BitmapService {self.state} "
                f"served={self._served_c.value} "
                f"pending={len(self._pending)} over {self._db!r}>")
