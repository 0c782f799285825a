"""Measured cost model: ``auto`` backend dispatch as a calibrated decision
(the port's twin of ``repro.engine.costmodel``).

Bulk-bitwise filtering is bandwidth-bound, so the right backend for a
query wave is a *measured* property of the device, not a static
preference.  This module owns that measurement and the per-wave decision:

  * :class:`Calibration` — per-backend roofline coefficients (sustained
    streamed words/sec on the fused-pass path + fixed per-dispatch
    overhead) plus the device's STREAM-class copy bandwidth.  Measured by
    :func:`measure_calibration`, persisted as JSON by
    :func:`save_calibration` (the reference's format and version), and
    loaded lazily by :func:`get_calibration` (path:
    ``$REPRO_TORCH_BITMAP_CALIBRATION`` or
    ``results/bitmap_calibration_torch.json``; per-device-type priors
    apply until a measurement exists).  The platform is the torch device
    type (``"cpu"``, ``"cuda"``): a process that holds CPU and card
    sessions reads the calibration of each session's device type.
  * :func:`decide` — given the wave's lowered plans, the packed word
    count, the segment count, and optional
    :class:`~repro_torch.engine.planner.KeyStats`, estimate each candidate
    backend's wall time

        t(b) = dispatches x overhead(b) + streamed_words / words_per_sec(b)

    over the canonically *padded* bucket shapes (what actually executes),
    and pick the cheapest — together with whether common-clause factoring
    shrinks the streamed words and whether a uniform segment chain should
    stack into one dispatch per bucket (stacking buys
    ``(S - 1) x dispatches`` overheads for one extra stack-copy of the
    chain at copy bandwidth).  Selectivity estimates enter the decision's
    ``terms`` (and ``BitmapDB.explain``).

On a CUDA device the hand-written kernels (``cuda``) are the only
candidate: ``ref`` and ``bulk`` are the plain versions the kernels are held
against, never a route ``auto`` serves on there, so on the card the model
decides factoring and stacking only.  On the CPU every calibrated backend
within :data:`CANDIDATE_CUTOFF` competes, as in the reference.

Decisions never change a result bit — every candidate is bit-identical;
the model only chooses which executor a wave lands on.  Decisions hold
host numbers only (no tensor enters a :class:`Decision` or its memo key).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Iterable, Mapping, Sequence

import torch

from repro_torch.engine import backends, planner, policy
from repro_torch.obs import metrics as _obs_metrics

# cost-model observability: calls vs computed = memo hit rate (the
# decision memo is process-global, so its meters are too)
_DECIDE_CALLS = _obs_metrics.GLOBAL.counter(
    "costmodel_decide_calls_total", "auto-dispatch decisions requested")
_DECIDE_COMPUTED = _obs_metrics.GLOBAL.counter(
    "costmodel_decisions_computed_total",
    "decisions actually derived (memo misses + uncacheable)")

ENV_PATH = "REPRO_TORCH_BITMAP_CALIBRATION"
DEFAULT_PATH = os.path.join("results", "bitmap_calibration_torch.json")
CALIBRATION_VERSION = 1

#: Candidates are backends within this factor of the fastest calibrated
#: words/sec — a backend orders of magnitude off (the ``cuda`` kernels'
#: plain versions on CPU tensors) is never worth warming or considering.
CANDIDATE_CUTOFF = 32.0


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """Roofline coefficients of one backend on one device type."""
    words_per_sec: float          # sustained streamed 32-bit words/sec
    dispatch_overhead_s: float    # fixed cost per executor call


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One device type's measured (or default) bitmap-path roofline."""
    profiles: tuple[tuple[str, BackendProfile], ...]
    copy_bytes_per_sec: float     # STREAM-class copy bandwidth (r+w bytes)
    platform: str                 # torch device type at measurement
    source: str = "default"       # "default" | "measured"

    def profile(self, name: str) -> BackendProfile | None:
        for n, p in self.profiles:
            if n == name:
                return p
        return None

    def to_json(self) -> str:
        return json.dumps({
            "version": CALIBRATION_VERSION,
            "platform": self.platform,
            "source": self.source,
            "copy_bytes_per_sec": self.copy_bytes_per_sec,
            "backends": {n: {"words_per_sec": p.words_per_sec,
                             "dispatch_overhead_s": p.dispatch_overhead_s}
                         for n, p in self.profiles},
        }, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "Calibration":
        d = json.loads(text)
        if d.get("version") != CALIBRATION_VERSION:
            raise ValueError(f"calibration version {d.get('version')!r} "
                             f"!= {CALIBRATION_VERSION}")
        profs = tuple(sorted(
            (n, BackendProfile(float(p["words_per_sec"]),
                               float(p["dispatch_overhead_s"])))
            for n, p in d["backends"].items()))
        return cls(profs, float(d["copy_bytes_per_sec"]),
                   str(d.get("platform", "cpu")),
                   str(d.get("source", "measured")))


# Priors, used only until a measurement exists.  "cpu" carries the
# reference's CPU numbers, with its interpreted "pallas" row as "cuda" (the
# kernels' plain versions on CPU tensors): orders of magnitude off, never a
# candidate.  "cuda" is measure_calibration(device="cuda",
# num_records=2**25, num_keys=256) from chip_smoke.py's phase 10 on an
# NVIDIA H100 80GB HBM3, 700.00 W card, rounded to two digits.  Only its
# "cuda" row prices a decision (see candidates()); the plain rows are kept
# as measured, the same JSON as a measurement writes.
_DEFAULTS = {
    "cpu": (
        ("bulk", BackendProfile(3.0e9, 6e-5)),
        ("cuda", BackendProfile(5.0e5, 2e-3)),
        ("ref", BackendProfile(2.0e9, 4e-5)),
    ),
    "cuda": (
        ("bulk", BackendProfile(3.6e10, 4.9e-4)),
        ("cuda", BackendProfile(4.5e10, 5.3e-4)),
        ("ref", BackendProfile(6.9e9, 7.2e-4)),
    ),
}
_DEFAULT_COPY = {"cpu": 1.0e10, "cuda": 2.9e12}


def _platform(device) -> str:
    """The torch device type a calibration is keyed by (the card when no
    device is named, like every entry point of the port)."""
    return torch.device("cuda" if device is None else device).type


def _platform_default(platform: str) -> Calibration:
    key = platform if platform in _DEFAULTS else "cpu"
    return Calibration(_DEFAULTS[key], _DEFAULT_COPY[key], platform,
                       "default")


def calibration_path() -> str:
    return os.environ.get(ENV_PATH, DEFAULT_PATH)


#: platform -> installed calibration (set_calibration or a loaded file)
_active: dict[str, Calibration] = {}


def get_calibration(device=None) -> Calibration:
    """The process-wide calibration of ``device``'s type: an explicit
    :func:`set_calibration` override, else the persisted measurement at
    :func:`calibration_path` when it was taken on that device type, else
    that device type's priors."""
    plat = _platform(device)
    cal = _active.get(plat)
    if cal is None:
        cal = _platform_default(plat)
        path = calibration_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    loaded = Calibration.from_json(f.read())
                if loaded.platform == plat:
                    cal = loaded
            except (ValueError, KeyError, OSError):
                pass
        _active[plat] = cal
    return cal


def set_calibration(cal: Calibration | None) -> None:
    """Install ``cal`` for its platform (or with ``None`` reset every
    platform to file / priors on next use)."""
    if cal is None:
        _active.clear()
    else:
        _active[cal.platform] = cal


def load_calibration(path: str) -> Calibration:
    with open(path) as f:
        return Calibration.from_json(f.read())


def save_calibration(cal: Calibration, path: str | None = None) -> str:
    """Persist a calibration as JSON (atomic tmp+replace); returns the
    path written."""
    path = path or calibration_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(cal.to_json())
    os.replace(tmp, path)
    return path


def candidates(cal: Calibration | None = None, device=None
               ) -> tuple[str, ...]:
    """Backends worth considering (and pre-warming) on ``device``'s type.
    On a CUDA device, the kernel backend alone: the plain backends are
    references there.  Elsewhere: registered, calibrated, and within
    :data:`CANDIDATE_CUTOFF` of the fastest calibrated words/sec.  With
    nothing usable, the device-based ``auto`` answer."""
    if cal is None:
        cal = get_calibration(device)
    plat = cal.platform if device is None else _platform(device)
    if plat == "cuda":
        return (backends.resolve_backend("auto", plat),)
    regs = set(backends.available_backends()) - {"auto"}
    profs = [(n, p) for n, p in cal.profiles if n in regs]
    if not profs:
        return (backends.resolve_backend("auto", plat),)
    best = max(p.words_per_sec for _, p in profs)
    out = tuple(sorted(n for n, p in profs
                       if p.words_per_sec * CANDIDATE_CUTOFF >= best))
    return out or (backends.resolve_backend("auto", plat),)


# ------------------------------------------------------------------ decision
@dataclasses.dataclass(frozen=True)
class Decision:
    """One wave's cost-model choice (never affects result bits)."""
    backend: str
    factor: bool                  # apply common-clause factoring first
    stack_uniform: bool           # stack a uniform segment chain
    estimates: tuple[tuple[str, float], ...]   # per-candidate seconds
    terms: Mapping[str, float]    # the model's inputs, for explain()

    @property
    def est_seconds(self) -> float:
        return dict(self.estimates)[self.backend]


def _bucket_shapes(plans: Sequence) -> tuple[dict, int, int]:
    """Canonical padded bucket histogram of a wave: {(g, p, l): count},
    plus composite-fallback and contradiction counts.  Uses the batch
    layer's lowering cache, so a steady-state wave costs dict probes."""
    from repro_torch.engine import batch  # deferred: batch imports us
    shapes: dict[tuple[int, int, int], int] = {}
    composite = zeros = 0
    for pl in plans:
        if isinstance(pl, planner.CompositePlan):
            composite += 1
            continue
        _, shape, _, _ = batch._lowered(pl)
        if shape is None:
            zeros += 1
        else:
            shapes[shape] = shapes.get(shape, 0) + 1
    return shapes, composite, zeros


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _streamed_words(shapes: dict, nw: int) -> float:
    """Words the padded bucket dispatches move: every literal slot reads
    ``nw`` operand words per query of the (pow2-padded) bucket, plus one
    result-row write per query."""
    return float(sum(_pow2(q) * (g * p * l + 1) * nw
                     for (g, p, l), q in shapes.items()))


def _maybe_factored(plans: Sequence) -> list | None:
    """Factored twins of a wave's plans, or None when no plan has more
    than one clause (factoring can't help)."""
    if not any(isinstance(pl, planner.QueryPlan) and len(pl.clauses) > 1
               for pl in plans):
        return None
    return [planner.factor(pl)
            if isinstance(pl, planner.QueryPlan) and pl.clauses else pl
            for pl in plans]


def estimate_matches(plans: Sequence, stats: planner.KeyStats | None
                     ) -> float | None:
    """Expected matching records across a wave (union bound per plan):
    the result-materialization term, and what ``explain`` reports."""
    if stats is None:
        return None
    total = 0.0
    for pl in plans:
        if isinstance(pl, planner.QueryPlan):
            est = sum(stats.clause_estimate(c) for c in pl.clauses)
        elif isinstance(pl, planner.FactoredPlan):
            est = sum(stats.clause_estimate(c) if c else stats.num_records
                      for c, _ in pl.groups)
        else:                     # composite: no cheap bound
            est = stats.num_records
        total += min(float(est), float(stats.num_records))
    return total


def decide(plans: Sequence, *, num_words: int, num_segments: int = 1,
           num_keys: int | None = None,
           stats: planner.KeyStats | None = None,
           cal: Calibration | None = None,
           allow_factor: bool = True, device=None) -> Decision:
    """Choose (backend, factoring, segment stacking) for one wave of
    lowered plans over an index of ``num_words`` packed words per segment
    (``num_segments`` uniform segments) on ``device`` (whose type selects
    the calibration when ``cal`` is None).  Pure host arithmetic — no
    device work; the whole decision memoizes on the wave's plan tuple (a
    re-registered backend set or new calibration is part of the key, so
    neither ever serves a stale choice)."""
    _DECIDE_CALLS.inc()
    if cal is None:
        cal = get_calibration(device)
    plat = cal.platform if device is None else _platform(device)
    try:
        return _decide_cached(tuple(plans), num_words, num_segments,
                              num_keys, stats, cal, allow_factor, plat,
                              backends.available_backends())
    except TypeError:            # unhashable plan object: decide uncached
        return _decide_impl(plans, num_words, num_segments, num_keys,
                            stats, cal, allow_factor, plat)


@functools.lru_cache(maxsize=512)
def _decide_cached(plans, num_words, num_segments, num_keys, stats, cal,
                   allow_factor, plat, _registered):
    return _decide_impl(plans, num_words, num_segments, num_keys, stats,
                        cal, allow_factor, plat)


def _decide_impl(plans, num_words, num_segments, num_keys, stats, cal,
                 allow_factor, plat) -> Decision:
    _DECIDE_COMPUTED.inc()
    cands = candidates(cal, plat)
    shapes, composite, zeros = _bucket_shapes(plans)
    words_plain = _streamed_words(shapes, num_words)

    factored = _maybe_factored(plans) if allow_factor else None
    use_factor = False
    shapes_used = shapes
    words = words_plain
    if factored is not None:
        shapes_f, _, _ = _bucket_shapes(factored)
        words_f = _streamed_words(shapes_f, num_words)
        # factoring trades fewer streamed words for (usually) deeper
        # 2-pass buckets; adopt it only on a real word reduction
        if words_f < words_plain * 0.95:
            use_factor = True
            shapes_used = shapes_f
            words = words_f

    n_buckets = max(len(shapes_used), 1) if shapes_used else 0
    n_buckets += composite            # composites dispatch out-of-band
    s = max(int(num_segments), 1)
    total_words = words * s
    # stacking a uniform chain: one stack-copy of the whole chain
    # (S x M x Nw words read + written) buys (S-1) x buckets dispatches
    stack_bytes = 0.0
    if s > 1 and num_keys is not None:
        stack_bytes = 2.0 * s * num_keys * num_words * 4.0

    est: list[tuple[str, float]] = []
    est_stacked: dict[str, float] = {}
    for name in cands:
        prof = cal.profile(name)
        if prof is None:
            continue
        t_work = total_words / max(prof.words_per_sec, 1.0)
        t_flat = n_buckets * s * prof.dispatch_overhead_s + t_work
        if s > 1:
            t_stk = (n_buckets * prof.dispatch_overhead_s + t_work
                     + stack_bytes / max(cal.copy_bytes_per_sec, 1.0))
            est_stacked[name] = t_stk
            est.append((name, min(t_flat, t_stk)))
        else:
            est.append((name, t_flat))
    if not est:                       # calibration names nothing usable
        name = backends.resolve_backend("auto", plat)
        return Decision(name, False, True, ((name, 0.0),),
                        {"streamed_words": total_words})
    best, t_best = min(est, key=lambda kv: (kv[1], kv[0]))
    stack = s > 1 and est_stacked.get(best, float("inf")) <= t_best + 1e-12

    terms: dict[str, float] = {
        "streamed_words": total_words,
        "streamed_bytes": total_words * 4.0,
        "buckets": float(n_buckets),
        "segments": float(s),
        "queries": float(len(plans)),
        "contradictions": float(zeros),
        "composites": float(composite),
        "words_plain": words_plain * s,
        "copy_bytes_per_sec": cal.copy_bytes_per_sec,
    }
    em = estimate_matches(plans, stats)
    if em is not None:
        terms["est_matches"] = em
        terms["est_selectivity"] = (em / (len(plans) * stats.num_records)
                                    if plans and stats.num_records else 0.0)
    return Decision(best, use_factor, stack, tuple(est), terms)


# -------------------------------------------------------------- measurement
def measure_calibration(*, num_records: int = 1 << 20, num_keys: int = 256,
                        num_queries: int = 64, reps: int = 3,
                        backend_names: Iterable[str] | None = None,
                        probe_seconds: float = 0.5,
                        seed: int = 0, device="cuda") -> Calibration:
    """Measure ``device``'s bitmap-path roofline: STREAM-class copy
    bandwidth plus, per backend, sustained streamed words/sec on a
    representative fused-pass bucket and the fixed per-dispatch overhead.

    Backends whose small probe already exceeds ``probe_seconds`` (the
    ``cuda`` backend's plain versions on CPU tensors) keep the probe-sized
    estimate instead of paying a full-size run.  Import-time free; runs
    device work.  The index is random words from ``seed`` (a torch
    generator on the device)."""
    import time

    from repro_torch.engine import batch
    from repro_torch.engine.planner import QueryPlan

    dev = policy.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nw = max(num_records // 32, 1)
    packed = torch.randint(-(1 << 31), 1 << 31, (num_keys, nw),
                           dtype=torch.int32, device=dev, generator=gen)
    pick = torch.Generator().manual_seed(seed)

    def timed(fn, r=reps):
        fn()
        policy.stream_sync(dev)
        best = float("inf")
        for _ in range(r):
            t0 = time.perf_counter()
            fn()
            policy.stream_sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best

    def copy(a):
        """STREAM-class copy: one read + one write of the whole index (a
        device body of the analysis tables)."""
        return torch.bitwise_or(a, 0)

    t_copy = timed(lambda: copy(packed))
    copy_bps = 2.0 * packed.numel() * 4 / t_copy

    def two_lit_plans(m):
        ks = torch.randint(0, m, (num_queries, 2), generator=pick).tolist()
        return [QueryPlan((((a, False), (b, True)),)) for a, b in ks]

    names = tuple(backend_names) if backend_names is not None else tuple(
        sorted(set(backends.available_backends()) - {"auto"}))
    small_nw = min(2048, nw)
    small = packed[:, :small_nw]
    tiny = packed[:, :min(16, nw)]
    profiles = []
    for name in names:
        plans = two_lit_plans(num_keys)
        words_small = _streamed_words({(1, 1, 2): num_queries}, small_nw)
        t_small = timed(lambda: batch.execute_many(
            small, plans, num_records=small_nw * 32, backend=name), r=1)
        if t_small > probe_seconds:
            wps = words_small / t_small
            t_tiny = t_small * tiny.shape[1] / small_nw  # don't re-run
        else:
            words = _streamed_words({(1, 1, 2): num_queries}, nw)
            t_full = timed(lambda: batch.execute_many(
                packed, plans, num_records=num_records, backend=name))
            wps = words / t_full
            t_tiny = timed(lambda: batch.execute_many(
                tiny, plans[:1], num_records=tiny.shape[1] * 32,
                backend=name))
        profiles.append((name, BackendProfile(wps, max(t_tiny, 1e-7))))
    batch._AUG_CACHE.clear()          # drop the measurement's index copies
    return Calibration(tuple(sorted(profiles)), copy_bps, dev.type,
                       "measured")

