"""Span-based tracing with the fault-seam cost model: off = one check.

The serving stack is asynchronous end to end — a query crosses the
submitting thread (admission), the scheduler thread (queue wait, wave
coalescing, bucketed dispatch, reassembly), and possibly the maintenance
worker (a spill its wave triggered) — so a latency number alone cannot
say *where* a slow query spent its time.  This module is the span
substrate the whole stack shares:

  * :class:`Tracer` — explicit-clock (inject a fake clock in tests),
    thread-safe, bounded: finished spans land in a ring buffer
    (overflow counts into :attr:`Tracer.dropped`, never grows).
  * **per-thread span stack** — ``with tracer.span("name"):`` parents
    nested spans automatically on one thread; cross-thread handoffs pass
    an explicit ``parent=`` (a :class:`Span` or its ``(trace, span)``
    context tuple), which is how a maintenance task or a coalesced wave
    chains to the query that caused it.
  * **module-level install** — exactly like :mod:`repro_torch.fault.seam`:
    instrumented sites read one module global (:data:`TRACER`) and take
    a ``None`` branch when tracing is off.  That single attribute check
    is the entire disabled-path cost.

Span taxonomy (the contract ARCHITECTURE.md documents)::

    admission            submit() entry -> enqueued          (per query)
    queue                enqueued -> wave picked it up       (per query)
    serve                dispatch start -> future resolved   (per query,
                         attrs: wave, mode, pj)
    coalesce             one wave end to end                 (per wave)
    device.execute       materialize + block_until_ready     (per wave)
    bucket.dispatch      one bucketed executor call          (per bucket)
    reassembly           result slicing + future resolution  (per wave)
    maintenance.<kind>   one spill/compact/gc/scrub task
    store.*              segment prepare/commit/merge/scrub/gc/repair
    spill.*              indexer-side two-phase spill
    fault.<kind>         zero-duration event where an injected fault hit

Stdlib-only: importable from the very bottom of the stack (the fault
injector and the WAL both hook in) without cycles or heavy imports.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable

__all__ = ["Span", "Tracer", "TRACER", "install", "uninstall",
           "current_context", "maybe_span"]


class Span:
    """One timed operation.  ``t1 is None`` while live; ``attrs`` carry
    the site's structured context (wave id, backend, pJ, ...)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "attrs")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: int, t0: float, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: float | None = None
        self.attrs = attrs

    @property
    def context(self) -> tuple[int, int]:
        """The ``(trace_id, span_id)`` handle a cross-thread child
        passes as ``parent=``."""
        return (self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "t0": self.t0, "t1": self.t1,
                "dur_ms": self.duration_s * 1e3, "attrs": self.attrs}

    def __repr__(self) -> str:
        state = "live" if self.t1 is None else f"{self.duration_s*1e3:.3f}ms"
        return (f"<Span {self.name} trace={self.trace_id} "
                f"span={self.span_id} {state}>")


def _ctx_of(parent) -> tuple[int, int] | None:
    if parent is None:
        return None
    if isinstance(parent, Span):
        return parent.context
    return (int(parent[0]), int(parent[1]))      # (trace, span) tuple


class Tracer:
    """Explicit-clock span recorder (see module docstring).

    ``clock`` is any ``() -> float``; the default is
    ``time.perf_counter`` so span times line up with the service's
    latency meters.  ``capacity`` bounds the finished-span ring;
    ``sink`` optionally receives every finished span's dict (e.g. a
    line-buffered JSONL writer) in addition to the ring.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 *, capacity: int = 65536,
                 sink: Callable[[dict], None] | None = None):
        self.clock = clock
        self.capacity = capacity
        self.sink = sink
        self.dropped = 0
        self._lock = threading.Lock()
        self._done: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._tls = threading.local()

    # ------------------------------------------------------------- identity
    def new_trace(self) -> int:
        return next(self._trace_ids)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def current(self) -> Span | None:
        """The innermost live span on THIS thread (ambient parent)."""
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    # ------------------------------------------------------------ recording
    def start(self, name: str, *, trace_id: int | None = None,
              parent=None, t0: float | None = None, **attrs) -> Span:
        """Open a live span.  Parent resolution: explicit ``parent=``
        (Span or ``(trace, span)`` tuple) wins, else the thread's current
        span, else the span is a root of ``trace_id`` (fresh trace when
        that is None too).  Does NOT push onto the thread stack — use
        :meth:`span` for ambient nesting."""
        ctx = _ctx_of(parent)
        if ctx is None:
            cur = self.current()
            if cur is not None:
                ctx = cur.context
        if ctx is not None:
            tid = trace_id if trace_id is not None else ctx[0]
            pid = ctx[1]
        else:
            tid = trace_id if trace_id is not None else self.new_trace()
            pid = 0
        return Span(name, tid, next(self._span_ids), pid,
                    self.clock() if t0 is None else t0, attrs)

    def end(self, span: Span, t1: float | None = None, **attrs) -> Span:
        """Close a live span and record it (idempotence is the caller's
        business; spans are recorded exactly when ended)."""
        span.t1 = self.clock() if t1 is None else t1
        if attrs:
            span.attrs.update(attrs)
        self._record(span)
        return span

    def record(self, name: str, *, trace_id: int | None = None,
               parent=None, t0: float, t1: float, **attrs) -> Span:
        """Record a pre-timed span in one call (sites that measured the
        interval themselves, e.g. admission)."""
        span = self.start(name, trace_id=trace_id, parent=parent, t0=t0,
                          **attrs)
        return self.end(span, t1=t1)

    def event(self, name: str, *, parent=None, **attrs) -> Span:
        """A zero-duration point event (injected faults use this): lands
        in the trace parented to the current/explicit span, so the trace
        shows exactly which operation the event interrupted."""
        t = self.clock()
        return self.record(name, parent=parent, t0=t, t1=t, **attrs)

    def make(self, name: str, *, trace_id: int, parent_id: int = 0,
             t0: float, t1: float | None = None, **attrs) -> Span:
        """Build a span WITHOUT recording it — the wave-path fast lane:
        sites that already hold explicit ids/times construct spans
        directly and hand them to :meth:`record_batch` in bulk."""
        sp = Span(name, trace_id, next(self._span_ids), parent_id, t0,
                  attrs)
        sp.t1 = t1
        return sp

    def span(self, name: str, *, trace_id: int | None = None,
             parent=None, **attrs) -> "_SpanScope":
        """Context-managed span, pushed as the thread's ambient parent
        for its body (nested ``span()``/``start()`` calls chain under
        it).  Exceptions mark ``attrs["error"]`` and re-raise."""
        sp = self.start(name, trace_id=trace_id, parent=parent, **attrs)
        return _SpanScope(self, sp, self._stack())

    def record_batch(self, spans) -> None:
        """Record many finished spans under ONE ring lock — the wave
        path ends a whole batch's queue/serve spans per dispatch, and
        per-span locking there is measurable against the p50 gate."""
        sink = self.sink
        with self._lock:
            done = self._done
            cap = done.maxlen
            for sp in spans:
                if len(done) == cap:
                    self.dropped += 1
                done.append(sp)
        if sink is not None:
            for sp in spans:
                sink(sp.to_dict())

    def _record(self, span: Span) -> None:
        sink = self.sink
        with self._lock:
            if len(self._done) == self._done.maxlen:
                self.dropped += 1
            self._done.append(span)
        if sink is not None:
            sink(span.to_dict())

    # ------------------------------------------------------------- reading
    def spans(self) -> list[Span]:
        """Snapshot of the finished-span ring, oldest first."""
        with self._lock:
            return list(self._done)

    def drain(self) -> list[Span]:
        """Pop and return everything recorded so far."""
        with self._lock:
            out = list(self._done)
            self._done.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)


class _SpanScope:
    """Plain-class span context manager (a generator-based
    ``@contextmanager`` costs several µs per use — too hot for the
    per-bucket dispatch path)."""

    __slots__ = ("_tracer", "_span", "_stack")

    def __init__(self, tracer: Tracer, span: Span, stack: list):
        self._tracer = tracer
        self._span = span
        self._stack = stack

    def __enter__(self) -> Span:
        self._stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._stack.pop()
        if exc is not None:
            self._span.attrs["error"] = repr(exc)
        self._tracer.end(self._span)
        return False


# ------------------------------------------------------- module-level seam
#: the installed tracer (None = tracing disabled).  Hot paths read this
#: ONCE into a local and branch on ``is None`` — the seam idiom.
TRACER: Tracer | None = None


def install(tracer: Tracer) -> Tracer:
    """Enable tracing process-wide.  Mirrors ``fault.seam`` ownership:
    installing over a DIFFERENT live tracer raises (two harnesses must
    not silently interleave their spans)."""
    global TRACER
    if TRACER is not None and TRACER is not tracer:
        raise RuntimeError("a tracer is already installed")
    TRACER = tracer
    return tracer


def uninstall(tracer: Tracer | None = None) -> None:
    """Disable tracing (idempotent; passing the tracer asserts
    ownership, like ``seam.uninstall``)."""
    global TRACER
    if tracer is not None and TRACER is not None and TRACER is not tracer:
        raise RuntimeError("refusing to uninstall another tracer")
    TRACER = None


def current_context() -> tuple[int, int] | None:
    """The calling thread's ambient span context, or None when tracing
    is off / no span is live — what a cross-thread handoff captures at
    enqueue time (the maintenance executor does exactly this)."""
    tr = TRACER
    if tr is None:
        return None
    cur = tr.current()
    return None if cur is None else cur.context


class _NullSpan:
    """Reentrant no-op context manager: ``maybe_span`` returns this one
    shared instance when tracing is off (stateless, so sharing is safe)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def maybe_span(name: str, *, parent=None, **attrs):
    """One-call guarded span for non-hot sites (store maintenance, spill
    phases): the disabled path is this function's single global check
    plus returning a shared no-op object."""
    tr = TRACER
    if tr is None:
        return _NULL
    return tr.span(name, parent=parent, **attrs)
