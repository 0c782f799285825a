"""Deterministic fault injection: seeded schedules over named sites.

The store/serve stack claims to survive torn writes, full disks, flaky
reads, and backend hiccups; this module is how those claims get tested
instead of asserted.  A :class:`FaultPlan` is a reproducible *schedule*
— "on the 3rd WAL append, fail the fsync; on the 2nd segment read, flip
bit 12345" — and a :class:`FaultInjector` installs it behind the
zero-cost seam (:mod:`repro_torch.fault.seam`) that the hooked modules fire
through.  Determinism contract: given the same plan, the same site
occurrence always draws the same fault, regardless of wall-clock or
thread interleaving (which occurrence a given thread's call lands on can
still vary with scheduling — the schedule is deterministic, the
workload's interleaving is the workload's business).

Fault kinds and where they may fire:

=================  =================================  ======================
kind               effect                              sites
=================  =================================  ======================
``enospc``         ``OSError(ENOSPC)`` before write   format.write,
                                                      log.append, wal.append
``eio``            ``OSError(EIO)``                   format.write,
                                                      format.read
``torn``           prefix of the bytes reaches disk,  format.write,
                   then ``OSError(EIO)`` — the        log.append
                   crash-mid-write debris state
``fsync_error``    payload written, fsync raises      log.append
                   ``OSError(EIO)`` (a "dropped"
                   fsync surfaced as failure — the
                   writer must treat the entry as
                   not durable)
``bitflip``        one seeded bit of the read bytes   format.read
                   flips (CRC catches it downstream)
``stall``          ``stall_s`` sleep (slow I/O /       every site
                   slow dispatch)
``dispatch_error`` ``InjectedFault`` from a batched   engine.dispatch
                   wave (transient backend failure)
``task_error``     ``InjectedFault`` from a           maintenance.task
                   maintenance task body
``drop``           the message vanishes (the seam     rpc.send, rpc.recv
                   returns ``{"drop": True}`` and
                   the transport discards the frame)
``duplicate``      the message is delivered twice     rpc.send, rpc.recv
``reorder``        the message is held back and      rpc.send, rpc.recv
                   delivered after the next one
                   (``{"hold": True}``)
=================  =================================  ======================

Only stdlib: this module sits below everything (the seam is fired from
``repro_torch.store.format``).
"""
from __future__ import annotations

import dataclasses
import errno
import json
import random
import threading
import time

from repro_torch.obs import trace as _obs_trace

__all__ = ["FaultSpec", "FaultPlan", "FaultInjector", "InjectedFault",
           "InjectedOSError", "SITE_KINDS"]


class InjectedFault(RuntimeError):
    """A transient, injected non-I/O failure (dispatch/task errors)."""


class InjectedOSError(OSError):
    """An injected I/O failure — a real ``OSError`` (errno and all) so it
    travels the exact handling path the genuine article would, but
    type-distinguishable in assertions."""


#: which fault kinds are meaningful at which seam site
SITE_KINDS: dict[str, tuple[str, ...]] = {
    "format.write": ("enospc", "eio", "torn", "stall"),
    "format.read": ("eio", "bitflip", "stall"),
    "log.append": ("enospc", "torn", "fsync_error", "stall"),
    "wal.append": ("enospc", "stall"),
    "engine.dispatch": ("dispatch_error", "stall"),
    "maintenance.task": ("task_error", "stall"),
    "rpc.send": ("drop", "duplicate", "reorder", "stall"),
    "rpc.recv": ("drop", "duplicate", "reorder", "stall"),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` on occurrences
    ``[occurrence, occurrence + count)`` of ``site`` calls whose context
    matches ``path_substr`` / ``match`` (each spec keeps its own
    occurrence counter over its *matching* calls, so "the 2nd write of a
    seg- file" means exactly that)."""
    site: str
    kind: str
    occurrence: int = 1          # 1-based, over matching calls
    count: int = 1               # consecutive matching occurrences
    path_substr: str | None = None
    match: tuple[tuple[str, str], ...] = ()   # ctx key -> str(value) equals
    stall_s: float = 0.0
    torn_frac: float = 0.5       # fraction of the payload that lands
    bit: int = 0                 # bitflip position seed (mod payload bits)

    def __post_init__(self):
        if self.site not in SITE_KINDS:
            raise ValueError(f"unknown site {self.site!r} "
                             f"(known: {sorted(SITE_KINDS)})")
        if self.kind not in SITE_KINDS[self.site]:
            raise ValueError(f"kind {self.kind!r} cannot fire at "
                             f"{self.site!r} (allowed: "
                             f"{SITE_KINDS[self.site]})")
        if self.occurrence < 1 or self.count < 1:
            raise ValueError("occurrence and count are 1-based positives")

    def matches(self, ctx: dict) -> bool:
        if self.path_substr is not None \
                and self.path_substr not in str(ctx.get("path", "")):
            return False
        return all(str(ctx.get(k)) == v for k, v in self.match)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["match"] = [list(kv) for kv in self.match]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        d = dict(d)
        d["match"] = tuple((k, v) for k, v in d.get("match", ()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, JSON-serializable fault schedule (the chaos-harness
    artifact: a failing run uploads exactly this)."""
    specs: tuple[FaultSpec, ...] = ()
    seed: int | None = None      # provenance when drawn by :meth:`random`

    #: site pools per profile for :meth:`random`
    PROFILES = {
        "storage": ("format.write", "format.read", "log.append",
                    "wal.append"),
        "serve": ("engine.dispatch", "maintenance.task", "format.read"),
        "all": ("format.write", "format.read", "log.append", "wal.append",
                "engine.dispatch", "maintenance.task"),
        # NOTE: rpc sites live in their own profile — folding them into
        # "all" would shift every existing seeded schedule.
        "network": ("rpc.send", "rpc.recv"),
    }

    @classmethod
    def random(cls, seed: int, *, profile: str = "all", n_faults: int = 12,
               max_occurrence: int = 24, max_stall_s: float = 0.005
               ) -> "FaultPlan":
        """Draw a reproducible schedule: ``n_faults`` specs over the
        profile's sites, occurrences in ``[1, max_occurrence]``, stalls
        bounded by ``max_stall_s``.  Same seed -> same schedule, always
        (``random.Random``, not the global RNG)."""
        if profile not in cls.PROFILES:
            raise ValueError(f"unknown profile {profile!r}")
        rng = random.Random(seed)
        specs = []
        for _ in range(n_faults):
            site = rng.choice(cls.PROFILES[profile])
            kind = rng.choice(SITE_KINDS[site])
            specs.append(FaultSpec(
                site=site, kind=kind,
                occurrence=rng.randint(1, max_occurrence),
                count=rng.randint(1, 2),
                stall_s=(rng.uniform(0.0005, max_stall_s)
                         if kind == "stall" else 0.0),
                torn_frac=rng.uniform(0.05, 0.95),
                bit=rng.randrange(1 << 30)))
        return cls(tuple(specs), seed=seed)

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "specs": [s.to_dict() for s in self.specs]},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(tuple(FaultSpec.from_dict(s) for s in d["specs"]),
                   seed=d.get("seed"))


class FaultInjector:
    """Installs a :class:`FaultPlan` behind the seam and executes it.

    Context manager::

        with FaultInjector(plan) as inj:
            ... workload ...
        inj.events            # every fault that actually fired

    Thread-safe: sites fire from append threads, the maintenance worker,
    and the service scheduler concurrently; per-spec occurrence counters
    and the event log are lock-protected.  The decision (which fault, if
    any) happens under the lock; the *effect* (sleep, raise, mutate)
    happens outside it, so a stall never serializes unrelated sites.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._seen = [0] * len(plan.specs)      # matching calls per spec
        self.events: list[dict] = []            # faults that fired
        self._installed = False
        # one stable bound-method object: seam ownership checks use
        # identity, and ``self._fire`` makes a fresh wrapper per access
        self._hook = self._fire

    # ------------------------------------------------------------ lifecycle
    def install(self) -> "FaultInjector":
        from repro_torch.fault import seam
        seam.install(self._hook)
        self._installed = True
        return self

    def uninstall(self) -> None:
        from repro_torch.fault import seam
        if self._installed:
            seam.uninstall(self._hook)
            self._installed = False

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------ reporting
    def fired(self, site: str | None = None) -> list[dict]:
        with self._lock:
            return [e for e in self.events
                    if site is None or e["site"] == site]

    def report_json(self) -> str:
        """Schedule + what actually fired — the debugging artifact a
        failing chaos run uploads."""
        with self._lock:
            events = list(self.events)
        return json.dumps({"seed": self.plan.seed,
                           "specs": [s.to_dict() for s in self.plan.specs],
                           "fired": events}, indent=2, sort_keys=True)

    # ------------------------------------------------------------ execution
    def _fire(self, site: str, ctx: dict):
        hit: FaultSpec | None = None
        ev: dict | None = None
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if spec.site != site or not spec.matches(ctx):
                    continue
                self._seen[i] += 1
                if hit is None and (spec.occurrence <= self._seen[i]
                                    < spec.occurrence + spec.count):
                    hit = spec
                    ev = {"site": site, "kind": spec.kind,
                          "occurrence": self._seen[i],
                          "path": str(ctx.get("path", "")),
                          "t": time.monotonic()}
                    self.events.append(ev)
        if hit is None:
            return None
        # land the fired fault in the trace (outside the lock): a chaos
        # run's span tree then shows exactly which operation each fault
        # interrupted, and the event record carries the join keys back
        tracer = _obs_trace.TRACER
        if tracer is not None:
            sp = tracer.event(f"fault.{hit.kind}", site=site,
                              occurrence=ev["occurrence"], path=ev["path"])
            ev["trace"] = sp.trace_id
            ev["span"] = sp.parent_id       # the span the fault landed in
        return self._execute(hit, ctx)

    def _execute(self, spec: FaultSpec, ctx: dict):
        kind = spec.kind
        if kind == "stall":
            time.sleep(spec.stall_s)
            return None
        if kind == "enospc":
            raise InjectedOSError(errno.ENOSPC,
                                  f"injected ENOSPC at {spec.site}")
        if kind == "eio":
            raise InjectedOSError(errno.EIO,
                                  f"injected EIO at {spec.site}")
        if kind == "torn":
            size = int(ctx.get("size", 0))
            return {"torn_bytes": max(0, min(size - 1,
                                             int(size * spec.torn_frac)))}
        if kind == "fsync_error":
            return {"fail_fsync": True}
        if kind == "bitflip":
            data = ctx.get("data", b"")
            if not data:
                return None
            pos = spec.bit % (len(data) * 8)
            out = bytearray(data)
            out[pos // 8] ^= 1 << (pos % 8)
            return {"data": bytes(out)}
        if kind in ("dispatch_error", "task_error"):
            raise InjectedFault(f"injected {kind} at {spec.site} "
                                f"({dict(ctx, data=None)})")
        if kind == "drop":
            return {"drop": True}
        if kind == "duplicate":
            return {"duplicate": True}
        if kind == "reorder":
            return {"hold": True}
        raise AssertionError(f"unhandled fault kind {kind!r}")
