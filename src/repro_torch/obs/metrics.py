"""Typed metric registry: counters, gauges, histograms, reservoirs.

Before this module the stack had three hand-rolled telemetry dicts —
``BitmapService.metrics()`` ad-hoc ints under the scheduler condvar,
``SegmentStore.health()`` plain attributes under the store lock, and
``BitmapDB.cache_stats()`` a mutable dict — each with its own locking
story and none exportable.  Now every layer registers *typed* metrics in
a :class:`Registry` and the old surfaces are views over it; one
``snapshot()``/``collect()`` walk feeds the Prometheus/JSONL exporters
(:mod:`repro_torch.obs.export`).

Types:

  * :class:`Counter` — monotonic; ``inc``/``add`` under a leaf lock (a
    metric lock is never held while taking any other lock, so metric
    updates can happen under ANY caller lock without ordering issues).
  * :class:`Gauge` — last-write-wins level (queue depth, inflight).
  * :class:`Histogram` — fixed upper-bound buckets, cumulative on
    export (Prometheus ``le`` semantics), with quantile interpolation.
  * :class:`Reservoir` — bounded uniform sample over the metric's whole
    lifetime (Vitter's Algorithm R, deterministic seed): unlike a
    sliding window, p50/p99 computed from it stay stable over
    multi-hour runs because every sample ever observed had an equal
    chance to be in the pool; memory stays O(capacity) forever.

Registries compose: ``service.registry.attach("store", store.registry)``
grafts the store's metrics under a ``store_`` prefix so the service
exposes ONE tree.  :data:`GLOBAL` holds process-wide engine counters
(executor builds, wave dispatches, cost-model decisions, WAL
appends) — the engine's caches are process-global, so their meters are
too.

Stdlib-only.
"""
from __future__ import annotations

import bisect
import math
import random
import threading
from typing import Iterator, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Reservoir", "Registry",
           "GLOBAL", "LATENCY_BUCKETS_MS"]

#: default latency histogram edges (ms): log-spaced 0.05ms .. ~60s
LATENCY_BUCKETS_MS: tuple[float, ...] = tuple(
    round(0.05 * (1.5 ** i), 4) for i in range(35))


class Counter:
    """Monotonic counter.  ``.value`` is exact (lock-consistent), which
    is what lets the telemetry tests reconcile counters against futures
    actually resolved instead of asserting 'roughly'."""

    __slots__ = ("name", "help", "_v", "_lock")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    add = inc

    @property
    def value(self) -> int:
        with self._lock:
            return self._v

    def snapshot(self):
        return self.value

    def __repr__(self) -> str:
        return f"<Counter {self.name}={self.value}>"


class Gauge:
    """Last-write-wins level meter."""

    __slots__ = ("name", "help", "_v", "_lock")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def snapshot(self):
        return self.value

    def __repr__(self) -> str:
        return f"<Gauge {self.name}={self.value}>"


class Histogram:
    """Fixed-bucket histogram (upper-bound edges, +Inf implicit).
    ``quantile(q)`` linearly interpolates inside the bucket the q-th
    observation falls in — O(buckets) memory at any observation count."""

    __slots__ = ("name", "help", "buckets", "_counts", "_count", "_sum",
                 "_lock")
    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = ""):
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.name = name
        self.help = help
        self.buckets = edges
        self._counts = [0] * (len(edges) + 1)     # last = overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if cum + c >= rank and c:
                lo = self.buckets[i - 1] if i else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])     # overflow: clamp to edge
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            return {"buckets": list(zip(self.buckets, counts[:-1])),
                    "overflow": counts[-1], "count": self._count,
                    "sum": self._sum}

    def __repr__(self) -> str:
        return f"<Histogram {self.name} n={self.count}>"


class Reservoir:
    """Bounded uniform lifetime sample (Algorithm R, seeded —
    deterministic given the observation sequence).  Until ``capacity``
    observations it holds *every* sample, so short benchmark phases get
    exact percentiles; past it, each of the N lifetime samples has
    capacity/N probability of being in the pool — percentiles track the
    whole run, not the last window."""

    __slots__ = ("name", "help", "capacity", "_pool", "_count", "_sum",
                 "_rng", "_lock")
    kind = "reservoir"

    def __init__(self, name: str, capacity: int = 8192, *, seed: int = 0,
                 help: str = ""):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.name = name
        self.help = help
        self.capacity = capacity
        self._pool: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._pool) < self.capacity:
                self._pool.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.capacity:
                    self._pool[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def values(self) -> list[float]:
        with self._lock:
            return list(self._pool)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; exact over the pool (exact over the lifetime
        while count <= capacity)."""
        pool = sorted(self.values())
        if not pool:
            return 0.0
        if len(pool) == 1:
            return pool[0]
        rank = (q / 100.0) * (len(pool) - 1)
        lo = math.floor(rank)
        hi = min(lo + 1, len(pool) - 1)
        return pool[lo] + (pool[hi] - pool[lo]) * (rank - lo)

    def snapshot(self) -> dict:
        with self._lock:
            n = self._count
            s = self._sum
        return {"count": n, "sum": s,
                "mean": s / n if n else 0.0,
                "p50": self.percentile(50), "p99": self.percentile(99)}

    def __repr__(self) -> str:
        return f"<Reservoir {self.name} n={self.count}>"


class Registry:
    """Get-or-create registry of typed metrics plus attached child
    registries (exposed under a prefix).  Creation is idempotent per
    (name, type); asking for an existing name with a different type
    raises — one name, one meaning."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._children: dict[str, "Registry"] = {}

    # -------------------------------------------------------- constructors
    def _get_or_create(self, name: str, cls, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(f"metric {name!r} already registered "
                                    f"as {type(m).__name__}")
                return m
            m = cls(name, *args, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, buckets, help=help)

    def reservoir(self, name: str, capacity: int = 8192, *, seed: int = 0,
                  help: str = "") -> Reservoir:
        return self._get_or_create(name, Reservoir, capacity, seed=seed,
                                   help=help)

    # ----------------------------------------------------------- structure
    def attach(self, prefix: str, child: "Registry") -> "Registry":
        """Graft ``child`` under ``prefix`` (its metrics export as
        ``<prefix>_<name>``).  Re-attaching the same registry under the
        same prefix is a no-op; a different one under a taken prefix
        raises."""
        with self._lock:
            have = self._children.get(prefix)
            if have is not None and have is not child:
                raise ValueError(f"prefix {prefix!r} already attached")
            self._children[prefix] = child
        return child

    def collect(self, prefix: str = "") -> Iterator[tuple[str, object]]:
        """Every (full_name, metric) in this registry and its children,
        depth-first.  Attachment cycles would loop — don't build them."""
        with self._lock:
            metrics = list(self._metrics.items())
            children = list(self._children.items())
        for name, m in metrics:
            yield (f"{prefix}_{name}" if prefix else name), m
        for sub, child in children:
            full = f"{prefix}_{sub}" if prefix else sub
            yield from child.collect(full)

    def snapshot(self) -> dict:
        """Flat ``{full_name: value}`` dict (histograms/reservoirs nest
        their own snapshot dicts) — the JSONL/bench artifact payload."""
        return {name: m.snapshot() for name, m in self.collect()}

    def __repr__(self) -> str:
        with self._lock:
            return (f"<Registry {len(self._metrics)} metrics, "
                    f"{len(self._children)} children>")


#: process-wide registry for the engine's global caches and counters
#: (executor builds, wave dispatches, cost-model decisions, WAL traffic).
#: Services attach it as the "engine" subtree of their own registry.
GLOBAL = Registry()
