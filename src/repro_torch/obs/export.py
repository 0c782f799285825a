"""Exporters: JSONL traces, Prometheus text exposition, bench snapshots.

Three consumers, three formats:

  * **CI artifacts** want line-delimited JSON — :func:`write_jsonl`
    dumps a tracer's finished spans one object per line, so a failed
    chaos run's artifact can be grepped or loaded incrementally.
  * **Scrapers** want Prometheus text exposition — :func:`prometheus_text`
    walks a :class:`~repro_torch.obs.metrics.Registry` tree (counters/gauges as
    single samples, histograms as cumulative ``_bucket``/``_sum``/
    ``_count`` series, reservoirs as quantile gauges).
  * **Benchmarks** want one call — :func:`bench_snapshot` writes a
    service's trace + metrics + energy ledger to ``results/obs/`` and
    returns the paths, which is all ``benchmarks/run.py`` needs to turn
    a traced phase into uploadable artifacts.
"""
from __future__ import annotations

import json
import os
import re
from typing import Iterable

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                               Reservoir)

__all__ = ["write_jsonl", "prometheus_text", "bench_snapshot"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def write_jsonl(spans: Iterable, path: str | os.PathLike) -> int:
    """Write spans (Span objects or pre-rendered dicts) as JSONL;
    returns the line count.  Creates parent directories."""
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for sp in spans:
            d = sp.to_dict() if isinstance(sp, _trace.Span) else sp
            f.write(json.dumps(d, default=str) + "\n")
            n += 1
    return n


def _fmt(v: float) -> str:
    return repr(float(v))


def prometheus_text(registry: Registry, *, prefix: str = "repro") -> str:
    """Render a registry tree (children included) in Prometheus text
    exposition format, every name prefixed with ``<prefix>_``."""
    lines: list[str] = []
    for full, m in registry.collect(prefix):
        name = _sanitize(full)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {m.value}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            snap = m.snapshot()
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for edge, c in snap["buckets"]:
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt(edge)}"}} {cum}')
            cum += snap["overflow"]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {_fmt(snap['sum'])}")
            lines.append(f"{name}_count {snap['count']}")
        elif isinstance(m, Reservoir):
            snap = m.snapshot()
            lines.append(f"# TYPE {name} summary")
            lines.append(f'{name}{{quantile="0.5"}} {_fmt(snap["p50"])}')
            lines.append(f'{name}{{quantile="0.99"}} {_fmt(snap["p99"])}')
            lines.append(f"{name}_sum {_fmt(snap['sum'])}")
            lines.append(f"{name}_count {snap['count']}")
    return "\n".join(lines) + "\n"


def bench_snapshot(service, out_dir: str | os.PathLike,
                   name: str) -> dict:
    """One-call bench artifact drop: the installed tracer's spans to
    ``<name>.trace.jsonl``, the service's registry to ``<name>.prom``,
    and its energy-ledger snapshot + reconciliation to
    ``<name>.energy.json``.  Returns {kind: path} for what was written
    (trace omitted when no tracer is installed)."""
    out_dir = os.fspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    written: dict[str, str] = {}

    tr = _trace.TRACER
    if tr is not None:
        tp = os.path.join(out_dir, f"{name}.trace.jsonl")
        write_jsonl(tr.spans(), tp)
        written["trace"] = tp

    reg = getattr(service, "registry", None)
    if reg is not None:
        pp = os.path.join(out_dir, f"{name}.prom")
        with open(pp, "w", encoding="utf-8") as f:
            f.write(prometheus_text(reg))
        written["prom"] = pp

    ledger = getattr(service, "ledger", None)
    if ledger is not None:
        ep = os.path.join(out_dir, f"{name}.energy.json")
        payload = {"snapshot": ledger.snapshot(),
                   "reconcile": ledger.reconcile()}
        with open(ep, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        written["energy"] = ep

    return written
