"""Batched query serving: many predicate trees per dispatch.

The port's twin of ``repro.engine.batch`` (in-memory half):

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
     cache key; :data:`COUNTERS` counts cache misses as
     ``executor_builds``.

Composite plans (the DNF size-guard fallback) are served out-of-band
through ``planner.execute`` (which reaches ``Backend.query``: the
``bitmap_query`` kernel on the ``cuda`` backend), contradictions as constant
zeros, and both are spliced back into input order.
"""
from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.engine import backends, planner, policy

#: bucket executors built (executor cache misses) — process-wide, like
#: the cache below.
COUNTERS = {"executor_builds": 0}

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


@functools.lru_cache(maxsize=64)
def _executor(backend_name: str, g: int, p: int, l: int):
    """One batched executor per (backend, canonical shape): the backend's
    whole-bucket ``run_program`` when it has one, else the per-pass body."""
    COUNTERS["executor_builds"] += 1   # body runs only on a cache miss
    backend = backends.get_backend(backend_name)
    if backend.run_program is not None:
        return backend.run_program
    return _bucket_body(backend, p, g)


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


def _serve(packed: torch.Tensor, num_records: int, plans: Sequence,
           part, name: str, pad_output: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a pre-partitioned batch against ONE packed buffer; results come
    back in input order.  ``pad_output=True`` pads the OUTPUT query axis to
    ``pow2_ceil(Q)`` (rows past the real Q are unspecified padding)."""
    m, nw = packed.shape
    dev = packed.device
    buckets, zeros, composite = part
    q = len(plans)
    q_out = _pow2_ceil(max(q, 1)) if pad_output else q
    pieces_r: list[torch.Tensor] = []
    pieces_c: list[torch.Tensor] = []
    order: list[int] = []       # original query index per real row
    pos: list[int] = []         # its row in the concatenated pieces
    off = 0
    if buckets:
        aug = _augmented(packed)
        for shape, idxs, sels, invs, post in buckets:
            rws, cts = _executor(name, *shape)(aug, num_records, sels, invs,
                                               post)
            if not pad_output and rws.shape[0] != len(idxs):
                rws, cts = rws[:len(idxs)], cts[:len(idxs)]  # drop Q-pads
            pieces_r.append(rws)
            pieces_c.append(cts)
            order.extend(idxs)
            pos.extend(range(off, off + len(idxs)))
            off += rws.shape[0]
    if zeros:
        zn = _pow2_ceil(len(zeros)) if pad_output else len(zeros)
        pieces_r.append(torch.zeros((zn, nw), dtype=torch.int32, device=dev))
        pieces_c.append(torch.zeros((zn,), dtype=torch.int32, device=dev))
        order.extend(zeros)
        pos.extend(range(off, off + len(zeros)))
        off += zn
    for qi in composite:                # size-guard fallback: out-of-band
        r, c = planner.execute(packed, plans[qi], num_records=num_records,
                               backend=name)
        pieces_r.append(r[None])
        pieces_c.append(c[None])
        order.append(qi)
        pos.append(off)
        off += 1

    rows_all = pieces_r[0] if len(pieces_r) == 1 else torch.cat(pieces_r)
    counts_all = pieces_c[0] if len(pieces_c) == 1 else torch.cat(pieces_c)
    if order == list(range(q)) and rows_all.shape[0] == q_out:
        return rows_all, counts_all     # single in-order exact bucket
    inv = np.zeros(q_out, np.int64)     # pad slots gather row 0 (ignored)
    inv[np.asarray(order, np.int64)] = np.asarray(pos, np.int64)
    inv = torch.from_numpy(inv).to(dev)
    return rows_all[inv], counts_all[inv]


def execute_many(packed: torch.Tensor,
                 predicates: Sequence[Union[planner.Pred, planner.QueryPlan,
                                            planner.FactoredPlan,
                                            planner.CompositePlan]], *,
                 num_records: int, backend: str = "auto",
                 max_clauses: int | None = planner.DEFAULT_MAX_CLAUSES,
                 factor: bool = False, pad_output: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve a batch of predicate trees (or pre-built plans) over one packed
    (M, Nw) index in a handful of bucket dispatches.

    Returns (rows (Q, Nw) int32, counts (Q,) int32) in input order, each
    row tail-masked past ``num_records`` — bit-identical to a sequential
    loop of :func:`planner.execute`.  ``factor=True`` runs common-clause
    factoring on each DNF plan before lowering.  ``pad_output=True`` pads
    the query axis of BOTH outputs to ``pow2_ceil(Q)`` (rows past Q are
    unspecified).  ``backend="auto"`` resolves by the index's device."""
    m, nw = packed.shape
    plans = _to_plans(predicates, m, max_clauses, factor)
    if not plans:
        return (torch.zeros((0, nw), dtype=torch.int32, device=packed.device),
                torch.zeros((0,), dtype=torch.int32, device=packed.device))
    name = backends.resolve_backend(backend, packed.device)
    return _serve(packed, int(num_records), plans,
                  _partition(plans, m, packed.device), name, pad_output)
