"""Retry and circuit-breaker primitives for the self-healing serving path
(the port's twin of ``repro.serve.resilience``).

The serving stack distinguishes three failure shapes and answers each
with a different mechanism (see :mod:`repro_torch.serve.service` for the
wiring):

  * **transient** (an EIO blip, a full disk about to be freed, an
    injected hiccup) — retried with exponential backoff and
    *deterministic* jitter (:class:`RetryPolicy`: the jitter stream is a
    seeded PRNG, so a chaos run replays byte-for-byte);
  * **backend-specific** (the bulk/cuda executor keeps failing while
    ``ref`` serves fine) — a :class:`CircuitBreaker` per preferred
    backend trips after ``failure_threshold`` confirmed failures and
    routes whole waves to the fallback backend until a cooldown probe
    succeeds (degraded mode: slower, never wrong);
  * **persistent data corruption** — not handled here at all: that is
    the store's quarantine/scrub/repair machinery
    (:meth:`repro_torch.store.SegmentStore.scrub`).

Stdlib-only; usable from the maintenance executor and the service alike.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Iterator

__all__ = ["RetryPolicy", "CircuitBreaker", "is_transient"]


def is_transient(exc: BaseException) -> bool:
    """Failure-shape classifier the retry paths share: I/O errors (every
    injected fault of that family is a real ``OSError``) and explicitly
    transient faults retry; corruption and programming errors do not —
    corruption goes to quarantine/scrub, bugs go to the caller."""
    from repro_torch.store.format import CorruptFileError
    if isinstance(exc, CorruptFileError):
        return False
    if isinstance(exc, OSError):
        return True
    # injected transient faults, without a hard dependency on the fabric
    return type(exc).__name__ == "InjectedFault"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    ``delays(seed)`` yields ``max_attempts - 1`` sleep durations (attempt
    k retries after ``base * growth**k``, jittered by up to ``jitter`` of
    itself, capped at ``max_delay_s``).  The jitter stream is a
    ``random.Random(seed)`` — two runs with the same seed back off
    identically, which is what makes chaos schedules reproducible."""
    max_attempts: int = 4          # 1 initial try + 3 retries
    base_delay_s: float = 0.005
    growth: float = 2.0
    max_delay_s: float = 0.25
    jitter: float = 0.5            # fraction of the delay, added

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def delays(self, seed: int = 0) -> Iterator[float]:
        rng = random.Random(seed)
        d = self.base_delay_s
        for _ in range(self.max_attempts - 1):
            yield min(self.max_delay_s, d * (1 + self.jitter * rng.random()))
            d *= self.growth

    def call(self, fn: Callable, *, seed: int = 0,
             retryable: Callable[[BaseException], bool] = is_transient,
             on_retry: Callable[[int, BaseException], None] | None = None,
             sleep: Callable[[float], None] = time.sleep):
        """Run ``fn()`` under this policy.  ``on_retry(attempt, exc)``
        observes each retry (metrics hooks); the final failure (or a
        non-retryable one) propagates unchanged."""
        delays = self.delays(seed)
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:          # noqa: BLE001 — classified
                attempt += 1
                delay = next(delays, None)
                if delay is None or not retryable(e):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)


class CircuitBreaker:
    """Minimal three-state breaker (closed -> open -> half-open).

    ``allow()`` answers "may the protected path be tried right now?":
    closed -> yes; open -> no until ``cooldown_s`` elapsed, then ONE
    caller wins the half-open probe slot; half-open -> no (a probe is in
    flight).  ``record_success``/``record_failure`` move the state:
    ``failure_threshold`` consecutive failures trip it, a probe success
    closes it, a probe failure re-opens (and restarts the cooldown).

    The clock is injectable for tests (``clock=fake``); all transitions
    are lock-protected — the service scheduler and one-shot submitters
    may consult the same breaker concurrently."""

    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self.trips = 0                 # lifetime open transitions
        self.failures = 0              # lifetime recorded failures

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open" \
                    and self._clock() - self._opened_at >= self.cooldown_s:
                self._state = "half-open"      # this caller is the probe
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._consecutive += 1
            if self._state == "half-open" \
                    or (self._state == "closed"
                        and self._consecutive >= self.failure_threshold):
                self._state = "open"
                self._opened_at = self._clock()
                self.trips += 1

    def snapshot(self) -> dict:
        """One consistent view for ``service.health()``."""
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "failures": self.failures, "trips": self.trips,
                    "cooldown_s": self.cooldown_s,
                    "failure_threshold": self.failure_threshold}

    def __repr__(self) -> str:
        return f"<CircuitBreaker {self.state} trips={self.trips}>"
