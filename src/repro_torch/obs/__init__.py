"""Unified observability: span tracing, typed metrics, energy ledger.

One substrate replaces three hand-rolled telemetry dicts:

  * :mod:`repro_torch.obs.trace` — explicit-clock span tracer behind a
    ``fault.seam``-style module global (off = one attribute check);
  * :mod:`repro_torch.obs.metrics` — counters / gauges / histograms /
    reservoirs in composable registries (``BitmapService.metrics()``,
    ``SegmentStore.health()`` and ``BitmapDB.cache_stats()`` are views
    over these);
  * :mod:`repro_torch.obs.energy` — per-phase joule ledger on the paper's
    operating points, attributing pJ to individual queries and indexed
    bits while reconciling exactly with ``ElasticScheduler`` totals;
  * :mod:`repro_torch.obs.export` — JSONL traces, Prometheus text, one-call
    bench snapshots.

Symbols resolve lazily (the :mod:`repro_torch` idiom): ``trace`` and
``metrics`` are stdlib-only and importable from the very bottom of the
stack (the fault injector, the WAL); ``energy`` pulls the power
model and the BIC geometry (torch) and must not ride along with them.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("trace", "metrics", "energy", "export")

_EXPORTS = {
    "Tracer": "trace", "Span": "trace", "install": "trace",
    "uninstall": "trace", "current_context": "trace",
    "maybe_span": "trace",
    "Registry": "metrics", "Counter": "metrics", "Gauge": "metrics",
    "Histogram": "metrics", "Reservoir": "metrics", "GLOBAL": "metrics",
    "EnergyLedger": "energy",
}

__all__ = sorted(_SUBMODULES) + sorted(_EXPORTS)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _EXPORTS:
        mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
