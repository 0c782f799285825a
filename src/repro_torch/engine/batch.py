"""Batched query serving: many predicate trees per dispatch.

The port's twin of ``repro.engine.batch``:

  1. **Lower** every plan to a uniform *pass program*: a tuple of groups,
     each group a tuple of fused AND-passes ``(literals, post_invert)``.
     A plain DNF clause is a one-pass group; a factored group is a common
     AND pass plus a De-Morgan OR pass (``post_invert`` folds the final
     negation into an xor mask).  Query result = OR over groups of the
     AND over each group's passes.
  2. **Bucket** programs by canonical padded shape ``(G groups, P passes,
     L literals)`` — G and L round up to powers of two.
  3. **Pad with identity rows**: the packed index is augmented with one
     virtual all-ones row at index M.  Padded literal slots select it
     non-inverted (AND-identity); padded group slots xor-mask their pass to
     all-zeros (OR-identity).  Padding never changes a result bit.
  4. **Execute each bucket as ONE executor call** over ``(Q, G, P, L)``
     literal-selector arrays, the query axis padded to a power of two.
     Executors are cached on ``(backend, G, P, L)``, the reference's jit
     cache key; ``engine_executor_builds_total`` counts cache misses.

Composite plans (the DNF size-guard fallback) are served out-of-band
through ``planner.execute`` (which reaches ``Backend.query``: the
``bitmap_query`` kernel on the ``cuda`` backend), contradictions as constant
zeros, and both are spliced back into input order.

:func:`execute_many_segments` extends the same machinery to indexes that
live as a chain of packed **segments** over disjoint record ranges (the
durable layout of :mod:`repro_torch.store`): plans lower and bucket ONCE,
the bucketed dispatch runs per segment — or, when every segment has the
same word count, once over the whole stack (the ``cuda`` backend's stacked
``bulk_program`` launch) — and the per-segment result rows OR-splice
together at their record offsets.

Every wave fires the ``engine.dispatch`` fault seam and, with a tracer
installed, records one ``bucket.dispatch`` span per bucket.  On a CUDA
device that span measures host dispatch (the launch is asynchronous), not
the card's time — as the reference's span around a JAX dispatch does.
"""
from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.engine import backends, costmodel, planner, policy
from repro_torch.fault import seam as _fault_seam
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

# waves / bucket dispatches / executor builds in the process-wide registry
# (the executor caches below are process-global); the names are the
# reference's.  builds == cache misses; hits are dispatches - builds.
_WAVES = _obs_metrics.GLOBAL.counter(
    "engine_waves_total", "batched _serve invocations")
_QUERIES = _obs_metrics.GLOBAL.counter(
    "engine_queries_total", "queries served through batched waves")
_DISPATCHES = _obs_metrics.GLOBAL.counter(
    "engine_bucket_dispatches_total", "bucket executor calls")
_BUILDS = _obs_metrics.GLOBAL.counter(
    "engine_executor_builds_total",
    "bucket executors built (cache misses)")
#: backend name -> its waves counter (``engine_waves_<name>_total``)
_BACKEND_WAVES: dict[str, _obs_metrics.Counter] = {}


def waves_by_backend() -> dict[str, int]:
    """Waves served so far in this process, per resolved backend name: on
    the card, a wave on anything but ``cuda`` ran the plain version."""
    return {n: c.value for n, c in sorted(_BACKEND_WAVES.items())}

#: One pass: (literals tuple[(key, inverted)], post_invert).  Program:
#: tuple of groups, each a tuple of passes.
PassProgram = tuple


def lower(pl: Union[planner.QueryPlan, planner.FactoredPlan]) -> PassProgram:
    """Lower a plan to the uniform group/pass form the batched executor
    runs.  ``OR(lits) == ~AND(~lits)``: factored OR sides enter with
    flipped literal inversions and ``post_invert=True``."""
    if isinstance(pl, planner.QueryPlan):
        return tuple(((c, False),) for c in pl.clauses)
    groups = []
    for common, ored in pl.groups:
        passes = []
        if common:
            passes.append((common, False))
        if ored:
            passes.append((tuple((i, not v) for i, v in ored), True))
        groups.append(tuple(passes))
    return tuple(groups)


def _pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def canonical_shape(prog: PassProgram) -> tuple[int, int, int]:
    """(G, P, L) bucket key: groups and literals round up to powers of two
    (padding is identity-exact), pass depth stays exact (1 or 2)."""
    g = _pow2_ceil(len(prog))
    p = max(len(passes) for passes in prog)
    l = _pow2_ceil(max(len(lits) for passes in prog for lits, _ in passes))
    return g, p, l


def _bucket_body(backend, p: int, g: int):
    """The per-pass bucket-executor body: per query, OR over groups of
    [AND over passes of [fused ``backend.query`` pass ^ post]], then one
    tail mask + popcount.  ``aug`` is (M+1, Nw) with the all-ones row at M;
    sels/invs (Q, g, p, l); post (Q, g, p) int32 xor masks (0 or -1)."""

    def run(aug, num_records, sels, invs, post):
        q = sels.shape[0]
        rows = torch.empty((q, aug.shape[1]), dtype=torch.int32,
                           device=aug.device)
        for qi in range(q):
            acc = None
            for gi in range(g):
                grp = None
                for pi in range(p):
                    row, _ = backend.query(aug[sels[qi, gi, pi]],
                                           invs[qi, gi, pi])
                    row = row ^ post[qi, gi, pi]
                    grp = row if grp is None else grp & row
                acc = grp if acc is None else acc | grp
            rows[qi] = acc
        return policy.mask_tail(rows, num_records)

    return run


def _body_for(backend, g: int, p: int):
    """A backend's bucket executor body: its whole-bucket ``run_program``
    when it has one, else the per-pass body composed around ``query``."""
    if backend.run_program is not None:
        return backend.run_program
    return _bucket_body(backend, p, g)


@functools.lru_cache(maxsize=64)
def _executor(backend_name: str, g: int, p: int, l: int):
    """One batched executor per (backend, canonical shape)."""
    _BUILDS.inc()                      # body runs only on a cache miss
    return _body_for(backends.get_backend(backend_name), g, p)


@functools.lru_cache(maxsize=64)
def _stacked_executor(backend_name: str, g: int, p: int, l: int):
    """Segment-stacked twin of :func:`_executor`: ``aug`` (S, M+1, Nw),
    ``nrecs`` S record counts, the selector arrays shared by every segment
    -> (rows (S, Q, Nw), counts (S, Q)).  The backend's
    ``run_program_stacked`` when it has one (the ``cuda`` backend: one
    stacked ``bulk_program`` launch per bucket), else the bucket body run
    segment by segment (the reference vmaps it)."""
    _BUILDS.inc()
    backend = backends.get_backend(backend_name)
    if backend.run_program_stacked is not None:
        return backend.run_program_stacked
    body = _body_for(backend, g, p)

    def run(aug, nrecs, sels, invs, post):
        outs = [body(aug[si], int(n), sels, invs, post)
                for si, n in enumerate(nrecs)]
        return (torch.stack([r for r, _ in outs]),
                torch.stack([c for _, c in outs]))

    return run


def batched_executor_cache_info():
    """Exposed for tests/benchmarks: the bucket-executor cache statistics."""
    return _executor.cache_info()


@functools.lru_cache(maxsize=4096)
def _lowered(pl) -> tuple[PassProgram, tuple[int, int, int] | None, int, int]:
    """Per-plan lowering cache: (program, canonical shape, min/max key id)."""
    prog = lower(pl)
    if not prog:
        return prog, None, 0, -1
    ids = [i for grp in prog for lits, _ in grp for i, _ in lits]
    return prog, canonical_shape(prog), min(ids), max(ids)


def _bucket_arrays(progs: Sequence[PassProgram], shape: tuple[int, int, int],
                   ones_idx: int):
    """Pack a bucket's programs into dense (Q, G, P, L) selector arrays.

    Defaults are the identities: literal slots select the virtual all-ones
    row non-inverted; pad groups xor-mask pass 0 to all-zeros.  The query
    axis rounds up to a power of two (pad queries are all-pad-groups —
    provable all-zero rows, sliced off by the caller)."""
    g, p, l = shape
    q = len(progs)
    qp = _pow2_ceil(max(q, 1))
    sels = np.full((qp, g, p, l), ones_idx, np.int32)
    invs = np.zeros((qp, g, p, l), np.int32)
    post = np.zeros((qp, g, p), np.int32)
    post[q:, :, 0] = -1                   # pad queries -> all-zero rows
    for qi, prog in enumerate(progs):
        for gi in range(g):
            if gi >= len(prog):
                post[qi, gi, 0] = -1              # pad group -> all-zeros
                continue
            for pi, (lits, pinv) in enumerate(prog[gi]):
                for li, (kidx, linv) in enumerate(lits):
                    sels[qi, gi, pi, li] = kidx
                    invs[qi, gi, pi, li] = int(linv)
                if pinv:
                    post[qi, gi, pi] = -1
    return sels, invs, post


def _to_plans(predicates: Sequence, m: int,
              max_clauses: int | None, factor: bool) -> list:
    """Plan every predicate (validating raw trees against ``m`` key rows)
    and optionally factor the DNF plans."""
    plans = []
    for pred in predicates:
        if isinstance(pred, (planner.QueryPlan, planner.FactoredPlan,
                             planner.CompositePlan)):
            pl = pred
        else:
            planner.check_key_range(planner.key_indices(pred), m)
            pl = planner.plan(pred, max_clauses=max_clauses)
        if factor and isinstance(pl, planner.QueryPlan) and pl.clauses:
            pl = planner.factor(pl)
        plans.append(pl)
    return plans


def _factored(plans: Sequence) -> list:
    """The cost model's factoring choice applied to a wave's DNF plans."""
    return [planner.factor(pl)
            if isinstance(pl, planner.QueryPlan) and pl.clauses else pl
            for pl in plans]


def _partition(plans: Sequence, m: int, device):
    """Bucket lowered plans by canonical shape and pack the per-bucket
    selector arrays ONCE, on ``device``.

    Returns (bucket list [(shape, idxs, sels, invs, post)], zero-result
    query indexes, composite-fallback query indexes)."""
    buckets: dict[tuple[int, int, int], tuple[list, list]] = {}
    composite: list[int] = []
    zeros: list[int] = []
    for qi, pl in enumerate(plans):
        if isinstance(pl, planner.CompositePlan):
            composite.append(qi)       # planner.execute validates key range
            continue
        prog, shape, lo, hi = _lowered(pl)
        if not prog:
            zeros.append(qi)           # contradiction: constant all-zero
            continue
        if lo < 0 or hi >= m:
            planner.check_key_range(planner.plan_key_indices(pl), m)
        idxs, progs = buckets.setdefault(shape, ([], []))
        idxs.append(qi)
        progs.append(prog)
    packed_buckets = []
    for shape, (idxs, progs) in buckets.items():
        arrays = _bucket_arrays(progs, shape, ones_idx=m)
        packed_buckets.append((shape, idxs) + tuple(
            torch.from_numpy(a).to(device) for a in arrays))
    return packed_buckets, zeros, composite


#: id(packed) -> (packed, augmented): a serving loop re-dispatches against
#: the SAME packed view every wave, and re-materializing the augmented copy
#: (one identity row appended) costs a full index copy.  Entries hold a
#: strong reference to the source tensor, so a cached id can never belong
#: to a recycled object; packed views are never written in place (splices
#: are functional), so a hit is always current.  Bounded by wholesale drop
#: at a small limit: an entry pins a whole capacity buffer plus its copy
#: on the card (3 GiB at 2^25 records x 256 keys).
_AUG_CACHE: dict = {}
_AUG_CACHE_LIMIT = 2


def _augmented(packed: torch.Tensor) -> torch.Tensor:
    """(M+1, Nw) contiguous copy of ``packed`` with the all-ones row at M
    (the copy is also what makes a strided capacity-buffer view contiguous
    for the kernels)."""
    ent = _AUG_CACHE.get(id(packed))
    if ent is not None and ent[0] is packed:
        return ent[1]
    m, nw = packed.shape
    aug = torch.empty((m + 1, nw), dtype=torch.int32, device=packed.device)
    aug[:m] = packed
    aug[m] = -1
    if len(_AUG_CACHE) >= _AUG_CACHE_LIMIT:
        _AUG_CACHE.clear()
    _AUG_CACHE[id(packed)] = (packed, aug)
    return aug


def _wave(name: str, plans: Sequence, part, run, composite, lead: tuple,
          nw: int, dev, pad_output: bool = False, **span
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The wave shared by :func:`_serve` and :func:`_serve_stacked`: the
    ``engine.dispatch`` seam and the counters, ``run(shape, sels, invs,
    post)`` once per bucket inside a ``bucket.dispatch`` span, the
    contradiction zeros, ``composite(qi)`` per size-guard fallback query,
    and the reorder to input order.  Every piece is ``lead + (q, ...)``:
    ``lead`` is ``()`` for one buffer, ``(S,)`` for a stack."""
    # fault seam: an injected dispatch error aborts the whole wave here
    _fault_seam.fire("engine.dispatch", backend=name, queries=len(plans))
    _WAVES.inc()
    waves = _BACKEND_WAVES.get(name)
    if waves is None:                   # get-or-create: one per name
        waves = _BACKEND_WAVES.setdefault(name, _obs_metrics.GLOBAL.counter(
            f"engine_waves_{name}_total", f"waves served on {name}"))
    waves.inc()
    _QUERIES.add(len(plans))
    ax = len(lead)                      # the query axis
    buckets, zeros, comp = part
    q = len(plans)
    q_out = _pow2_ceil(max(q, 1)) if pad_output else q
    pieces_r: list[torch.Tensor] = []
    pieces_c: list[torch.Tensor] = []
    order: list[int] = []       # original query index per real row
    pos: list[int] = []         # its row in the concatenated pieces
    off = 0
    for shape, idxs, sels, invs, post in buckets:
        _DISPATCHES.inc()
        with _obs_trace.maybe_span("bucket.dispatch", backend=name,
                                   shape=shape, q=len(idxs), **span):
            rws, cts = run(shape, sels, invs, post)
        if not pad_output and rws.shape[ax] != len(idxs):   # drop Q-pads
            rws, cts = rws.narrow(ax, 0, len(idxs)), cts.narrow(ax, 0,
                                                               len(idxs))
        pieces_r.append(rws)
        pieces_c.append(cts)
        order.extend(idxs)
        pos.extend(range(off, off + len(idxs)))
        off += rws.shape[ax]
    if zeros:
        zn = _pow2_ceil(len(zeros)) if pad_output else len(zeros)
        pieces_r.append(torch.zeros(lead + (zn, nw), dtype=torch.int32,
                                    device=dev))
        pieces_c.append(torch.zeros(lead + (zn,), dtype=torch.int32,
                                    device=dev))
        order.extend(zeros)
        pos.extend(range(off, off + len(zeros)))
        off += zn
    for qi in comp:                     # size-guard fallback: out-of-band
        r, c = composite(qi)
        pieces_r.append(r.unsqueeze(ax))
        pieces_c.append(c.unsqueeze(ax))
        order.append(qi)
        pos.append(off)
        off += 1

    rows_all = (pieces_r[0] if len(pieces_r) == 1
                else torch.cat(pieces_r, dim=ax))
    counts_all = (pieces_c[0] if len(pieces_c) == 1
                  else torch.cat(pieces_c, dim=ax))
    if order == pos == list(range(q)) and rows_all.shape[ax] == q_out:
        # every query's row already at its own index (no pad row between
        # them); the reference tests ``order`` alone, so two padded
        # buckets in input order come back shifted there
        return rows_all, counts_all
    inv = np.zeros(q_out, np.int64)     # pad slots gather row 0 (ignored)
    inv[np.asarray(order, np.int64)] = np.asarray(pos, np.int64)
    inv = torch.from_numpy(inv).to(dev)
    return rows_all.index_select(ax, inv), counts_all.index_select(ax, inv)


def _serve(packed: torch.Tensor, num_records: int, plans: Sequence,
           part, name: str, pad_output: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a pre-partitioned batch against ONE packed buffer; results come
    back in input order.  ``pad_output=True`` pads the OUTPUT query axis to
    ``pow2_ceil(Q)`` (rows past the real Q are unspecified padding)."""
    def run(shape, sels, invs, post):
        return _executor(name, *shape)(_augmented(packed), num_records,
                                       sels, invs, post)

    def composite(qi):
        return planner.execute(packed, plans[qi], num_records=num_records,
                               backend=name)

    return _wave(name, plans, part, run, composite, (), packed.shape[1],
                 packed.device, pad_output)


def execute_many(packed: torch.Tensor,
                 predicates: Sequence[Union[planner.Pred, planner.QueryPlan,
                                            planner.FactoredPlan,
                                            planner.CompositePlan]], *,
                 num_records: int, backend: str = "auto",
                 max_clauses: int | None = planner.DEFAULT_MAX_CLAUSES,
                 factor: bool = False, pad_output: bool = False,
                 stats: planner.KeyStats | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve a batch of predicate trees (or pre-built plans) over one packed
    (M, Nw) index in a handful of bucket dispatches.

    Returns (rows (Q, Nw) int32, counts (Q,) int32) in input order, each
    row tail-masked past ``num_records`` — bit-identical to a sequential
    loop of :func:`planner.execute`.  ``factor=True`` runs common-clause
    factoring on each DNF plan before lowering.  ``pad_output=True`` pads
    the query axis of BOTH outputs to ``pow2_ceil(Q)`` (rows past Q are
    unspecified).

    ``backend="auto"`` is a *measured* per-wave choice: the lowered plans'
    padded bucket shapes feed :func:`repro_torch.engine.costmodel.decide`
    with the calibration of the index's device type, which picks the
    cheapest candidate backend (on a CUDA device only ``cuda`` is one) and
    whether common-clause factoring shrinks the streamed words.  ``stats`` (optional KeyStats) only
    refines the cost terms — never the result bits."""
    m, nw = packed.shape
    plans = _to_plans(predicates, m, max_clauses, factor)
    if not plans:
        return (torch.zeros((0, nw), dtype=torch.int32, device=packed.device),
                torch.zeros((0,), dtype=torch.int32, device=packed.device))
    if backend == "auto":
        decision = costmodel.decide(plans, num_words=nw, num_keys=m,
                                    stats=stats, allow_factor=not factor,
                                    device=packed.device)
        name = decision.backend
        if decision.factor:
            plans = _factored(plans)
    else:
        name = backends.resolve_backend(backend, packed.device)
    return _serve(packed, int(num_records), plans,
                  _partition(plans, m, packed.device), name, pad_output)


def _serve_stacked(stack: torch.Tensor, nrecs: Sequence[int], plans: Sequence,
                   part, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a pre-partitioned batch against a STACK of uniform-word-count
    packed buffers (S, M, Nw) holding ``nrecs[s]`` records each — one
    stacked executor call per bucket covers every segment.  Returns
    (rows (S, Q, Nw), counts (S, Q)) in input query order."""
    s, m, nw = stack.shape
    aug = []                            # built at the first bucket

    def run(shape, sels, invs, post):
        if not aug:
            a = torch.empty((s, m + 1, nw), dtype=torch.int32,
                            device=stack.device)
            a[:, :m] = stack
            a[:, m] = -1
            aug.append(a)
        return _stacked_executor(name, *shape)(aug[0], nrecs, sels, invs,
                                               post)

    def composite(qi):
        rs, cs = zip(*(planner.execute(stack[si], plans[qi],
                                       num_records=int(nrecs[si]),
                                       backend=name) for si in range(s)))
        return torch.stack(rs), torch.stack(cs)

    return _wave(name, plans, part, run, composite, (s,), nw, stack.device,
                 segments=s)


def execute_many_segments(parts: Sequence[tuple[torch.Tensor, int]],
                          predicates: Sequence, *, backend: str = "auto",
                          max_clauses: int | None =
                          planner.DEFAULT_MAX_CLAUSES,
                          factor: bool = False,
                          stack_uniform: bool | None = None,
                          stats: planner.KeyStats | None = None,
                          device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve a query batch over an index stored as a chain of packed
    segments covering contiguous record ranges — the durable layout of
    :mod:`repro_torch.store` — without materializing one contiguous buffer.

    ``parts``: ordered ``(packed (M, ceil(n_i/32)) int32, n_i)`` pairs on
    one device; record ``sum(n_(<i))`` is the absolute offset of segment
    i.  Plans lower, validate, and bucket ONCE; each segment then runs the
    bucketed dispatch and its result rows — tail-masked within the segment
    — are OR-spliced into the global (Q, ceil(N/32)) rows at the segment's
    bit offset.  Counts sum per segment.  Bit-identical to
    :func:`execute_many` over the spliced-together index.

    ``stack_uniform``: when every segment shares ONE word count the
    segments stack into an (S, M, Nw) tensor and each bucket serves ALL
    segments in one stacked executor call (:func:`_serve_stacked`);
    results stay bit-identical to the per-segment path.  ``None`` (the
    default) means: stack for explicit backends, and for ``backend="auto"``
    let the cost model weigh the stack-copy bytes against the saved
    per-segment dispatch overheads.  ``device`` is where an empty chain's
    results go (default the card)."""
    parts = [(p, int(n)) for p, n in parts]
    if not parts:
        # an empty index has no key count to validate against; every
        # query matches nothing by definition
        dev = policy.resolve_device("cuda" if device is None else device)
        q = len(predicates)
        return (torch.zeros((q, 0), dtype=torch.int32, device=dev),
                torch.zeros((q,), dtype=torch.int32, device=dev))
    dev = parts[0][0].device
    total = sum(n for _, n in parts)
    tw = policy.num_words(total)
    m = parts[0][0].shape[0]
    if any(p.shape[0] != m for p, _ in parts):
        raise ValueError("segments disagree on key count: "
                         f"{[p.shape[0] for p, _ in parts]}")
    plans = _to_plans(predicates, m, max_clauses, factor)
    q = len(plans)
    if q == 0:
        return (torch.zeros((q, tw), dtype=torch.int32, device=dev),
                torch.zeros((q,), dtype=torch.int32, device=dev))
    max_bw = max(p.shape[1] for p, _ in parts)
    if backend == "auto":
        decision = costmodel.decide(plans, num_words=max_bw,
                                    num_segments=len(parts), num_keys=m,
                                    stats=stats, allow_factor=not factor,
                                    device=dev)
        name = decision.backend
        if decision.factor:
            plans = _factored(plans)
        if stack_uniform is None:
            stack_uniform = decision.stack_uniform
    else:
        name = backends.resolve_backend(backend, dev)
        if stack_uniform is None:
            stack_uniform = True
    part = _partition(plans, m, dev)
    # a fresh buffer no snapshot shares: the per-segment splices go in place
    rows = torch.zeros((q, tw + max_bw + 1), dtype=torch.int32, device=dev)
    uniform = len({p.shape[1] for p, _ in parts}) == 1
    if stack_uniform and uniform and len(parts) > 1:
        stack = torch.stack([p for p, _ in parts])
        nrecs = [n for _, n in parts]
        rows_s, counts_s = _serve_stacked(stack, nrecs, plans, part, name)
        start = 0
        for si, n in enumerate(nrecs):
            policy.splice_into(rows, start, rows_s[si])
            start += n
        return rows[:, :tw], counts_s.sum(dim=0, dtype=torch.int32)
    counts = torch.zeros((q,), dtype=torch.int32, device=dev)
    start = 0
    for packed, n in parts:
        r_i, c_i = _serve(packed, n, plans, part, name)
        policy.splice_into(rows, start, r_i)
        counts = counts + c_i
        start += n
    return rows[:, :tw], counts
