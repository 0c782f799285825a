"""Boolean query planner: predicate trees -> fused bitmap-kernel passes.

The bitmap kernels execute one shape of work natively: a fused
AND-with-per-row-inversion over packed index rows (``Backend.query``).  The
planner maps arbitrary AND/OR/NOT predicate trees onto a *minimal sequence*
of those passes:

  1. normalize to negation normal form (De Morgan pushes NOT to leaves);
  2. distribute to disjunctive normal form — each conjunctive clause is
     exactly one fused kernel pass;
  3. simplify: drop contradictory clauses (``x & ~x``), dedup literals,
     absorb clauses subsumed by a subset clause (``a | (a & b)`` -> ``a``);
  4. OR the per-clause result rows, then apply the canonical tail mask and
     popcount once.

Three serving-path refinements sit on top of the plain DNF pipeline:

  * **Plan-size guard** — DNF distribution is exponential on adversarial
    trees (an AND of k ORs is 2^k clauses).  :func:`plan` estimates the
    clause count *before* distributing and, past ``max_clauses``, falls
    back to a :class:`CompositePlan` that evaluates the offending AND/OR
    node as separate sub-plans whose packed rows combine with ``&``/``|``.
  * **Common-clause factoring** — :func:`factor` groups clauses that differ
    in exactly one literal: ``(a&b&c) | (a&b&d)`` becomes ``a&b & (c|d)``,
    one shared fused pass plus one De-Morgan OR pass instead of one pass
    per clause (pure single-literal clauses ``a|b|c`` collapse to a single
    pass the same way).
  * **Plan-constant cache** — the gather/inversion literal arrays for a
    plan are built once and kept device-resident, keyed on the plan and the
    device, so a hot serving loop never re-uploads literals per call.

Executors are cached keyed on *plan shape* (backend, literals per clause),
as the reference's jit cache is; the port runs them eagerly.  This module
is the port's twin of ``repro.engine.planner``: the predicate algebra, DNF,
size guard, factoring and ``KeyStats`` are copied as they are.

Predicates compose with Python operators::

    from repro_torch.engine import key
    pred = (key(2) | key(7)) & key(4) & ~key(5)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence, Union

import torch

from repro_torch.engine import backends, policy

# ---------------------------------------------------------- predicate algebra
class Pred:
    """Base predicate; combine with ``&``, ``|``, ``~``."""

    def __and__(self, other: "Pred") -> "Pred":
        return And((self, other))

    def __or__(self, other: "Pred") -> "Pred":
        return Or((self, other))

    def __invert__(self) -> "Pred":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class Key(Pred):
    """Leaf: "the record contains index key ``index``"."""
    index: int


@dataclasses.dataclass(frozen=True)
class And(Pred):
    children: tuple[Pred, ...]


@dataclasses.dataclass(frozen=True)
class Or(Pred):
    children: tuple[Pred, ...]


@dataclasses.dataclass(frozen=True)
class Not(Pred):
    child: Pred


def key(index: int) -> Key:
    return Key(int(index))


def from_include_exclude(include: Sequence[int] = (),
                         exclude: Sequence[int] = ()) -> Pred:
    """The legacy API surface: AND of positive/negated literals."""
    lits: list[Pred] = [key(i) for i in include]
    lits += [~key(i) for i in exclude]
    if not lits:
        raise ValueError("query needs at least one operand row")
    return lits[0] if len(lits) == 1 else And(tuple(lits))


# ------------------------------------------------------------- normalization
Literal = tuple[int, bool]           # (key index, inverted)
Clause = frozenset  # of Literal


@dataclasses.dataclass(frozen=True)
class KeyStats:
    """Per-key set-bit counts — the planner's cardinality estimates.

    ``counts[i]`` is the number of records whose index bit for key row
    ``i`` is set (exactly, or an upper-bound estimate); ``num_records`` is
    the record population the counts were taken over.  When supplied to
    :func:`plan`, DNF clauses execute cheapest-estimated-selectivity first
    instead of fewest-literals first.  Ordering NEVER changes a result bit
    (the clause rows OR together), only which fused pass a short-circuiting
    executor would try first and how plans bucket by shape.
    """
    counts: tuple[int, ...]
    num_records: int

    @classmethod
    def from_counts(cls, counts, num_records: int) -> "KeyStats":
        return cls(tuple(int(c) for c in counts), int(num_records))

    def literal_estimate(self, index: int, inverted: bool) -> int:
        """Estimated matching records for one literal (unknown keys fall
        back to the whole population — no information)."""
        if not 0 <= index < len(self.counts):
            return self.num_records
        c = min(self.counts[index], self.num_records)
        return self.num_records - c if inverted else c

    def clause_estimate(self, clause: Iterable[Literal]) -> int:
        """Upper bound on an AND clause's selectivity: its most selective
        literal bounds the intersection."""
        return min((self.literal_estimate(i, inv) for i, inv in clause),
                   default=self.num_records)


def _dnf(p: Pred, neg: bool) -> frozenset:
    """Disjunctive normal form as a set of conjunctive clauses."""
    if isinstance(p, Key):
        return frozenset({Clause({(p.index, neg)})})
    if isinstance(p, Not):
        return _dnf(p.child, not neg)
    if isinstance(p, (And, Or)):
        if not p.children:
            raise ValueError(f"{type(p).__name__} needs at least one child")
        parts = [_dnf(c, neg) for c in p.children]
        conjunctive = isinstance(p, And) != neg       # De Morgan under neg
        if not conjunctive:
            return frozenset().union(*parts)
        out = {Clause()}
        for part in parts:
            out = {a | b for a in out for b in part}
        return frozenset(out)
    raise TypeError(f"not a predicate: {p!r}")


def _simplify(clauses: Iterable[Clause],
              stats: KeyStats | None = None) -> list[tuple[Literal, ...]]:
    sat = [c for c in clauses
           if not any((i, not inv) in c for i, inv in c)]
    # absorption: a clause subsumed by a subset clause contributes nothing
    kept = [c for c in sat
            if not any(o < c for o in sat)]
    # deterministic cheapest-first ordering: estimated selectivity when
    # per-key stats are available, literal count as the uninformed
    # fallback, lexicographic tiebreak — stable plan shapes / cache keys,
    # and a short-circuit executor can try the cheapest pass first.  The
    # clause order never changes the OR-of-clauses result.
    if stats is None:
        sort_key = lambda c: (len(c), c)                  # noqa: E731
    else:
        sort_key = lambda c: (stats.clause_estimate(c),   # noqa: E731
                              len(c), c)
    return sorted((tuple(sorted(c)) for c in set(kept)), key=sort_key)


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Normalized, simplified DNF: one fused kernel pass per clause."""
    clauses: tuple[tuple[Literal, ...], ...]

    @property
    def shape(self) -> tuple[int, ...]:
        """Literals per pass — the jit-cache key component."""
        return tuple(len(c) for c in self.clauses)

    @property
    def num_passes(self) -> int:
        return len(self.clauses)


@dataclasses.dataclass(frozen=True)
class CompositePlan:
    """Size-guard fallback: AND/OR combination of independently executed
    sub-plans.  Leaf rows are tail-masked, and ``&``/``|`` preserve zeroed
    tail bits, so the combined row needs only a final popcount."""
    op: str                                  # "and" | "or"
    parts: tuple                             # of QueryPlan | CompositePlan

    @property
    def num_passes(self) -> int:
        return sum(p.num_passes for p in self.parts)


@dataclasses.dataclass(frozen=True)
class FactoredPlan:
    """Factored DNF: each group is ``AND(common) & OR(ored)`` (either side
    may be empty, not both); group rows OR together."""
    groups: tuple                # of (common: tuple[Literal], ored: tuple[Literal])

    @property
    def shape(self) -> tuple[tuple[int, int], ...]:
        return tuple((len(c), len(d)) for c, d in self.groups)

    @property
    def num_passes(self) -> int:
        return sum((1 if c else 0) + (1 if d else 0) for c, d in self.groups)


AnyPlan = Union[QueryPlan, FactoredPlan, CompositePlan]

#: Past this many DNF clauses, ``plan`` stops distributing and emits a
#: CompositePlan instead (sub-plans combined by row-wise AND/OR).
DEFAULT_MAX_CLAUSES = 128


def _dnf_size(p: Pred, neg: bool, cap: int) -> int:
    """Clause count full distribution would produce, saturating at cap+1
    (never materializes a clause, so adversarial trees stay cheap)."""
    if isinstance(p, Key):
        return 1
    if isinstance(p, Not):
        return _dnf_size(p.child, not neg, cap)
    sizes = [_dnf_size(c, neg, cap) for c in p.children]
    if isinstance(p, And) != neg:            # conjunctive: sizes multiply
        out = 1
        for s in sizes:
            out *= s
            if out > cap:
                return cap + 1
        return out
    return min(sum(sizes), cap + 1)


def _plan_guarded(p: Pred, neg: bool, max_clauses: int,
                  stats: KeyStats | None) -> AnyPlan:
    if _dnf_size(p, neg, max_clauses) <= max_clauses:
        return QueryPlan(tuple(_simplify(_dnf(p, neg), stats)))
    if isinstance(p, Not):
        return _plan_guarded(p.child, not neg, max_clauses, stats)
    conjunctive = isinstance(p, And) != neg
    parts = tuple(_plan_guarded(c, neg, max_clauses, stats)
                  for c in p.children)
    return CompositePlan("and" if conjunctive else "or", parts)


def plan(pred: Pred, *, max_clauses: int | None = DEFAULT_MAX_CLAUSES,
         stats: KeyStats | None = None) -> AnyPlan:
    """Normalize + simplify a predicate tree into an executable plan.

    Returns a :class:`QueryPlan` whenever the simplified DNF fits in
    ``max_clauses`` clauses; otherwise a :class:`CompositePlan` that keeps
    the offending AND/OR nodes as separate sub-plans instead of distributing
    them (``max_clauses=None`` disables the guard).  ``stats`` (per-key
    set-bit counts, see :class:`KeyStats`) orders the DNF clauses by
    estimated selectivity instead of literal count — result bits are
    identical either way."""
    if max_clauses is None:
        return QueryPlan(tuple(_simplify(_dnf(pred, neg=False), stats)))
    return _plan_guarded(pred, False, max_clauses, stats)


def total_clauses(pl: AnyPlan) -> int:
    """Fused-pass clause count across a plan tree — the quantity the size
    guard bounds per leaf."""
    if isinstance(pl, QueryPlan):
        return len(pl.clauses)
    if isinstance(pl, FactoredPlan):
        return len(pl.groups)
    return sum(total_clauses(p) for p in pl.parts)


def factor(qp: QueryPlan) -> FactoredPlan:
    """Common-clause factoring: clauses that differ in exactly one literal
    share their common AND pass — ``(a&b&c)|(a&b&d)`` -> ``a&b & (c|d)``.

    Greedy largest-group-first; each clause joins at most one group, and
    unfactored clauses pass through as ``(clause, ())`` groups."""
    clauses = qp.clauses
    cand: dict[tuple, list[tuple[int, Literal]]] = {}
    for ci, c in enumerate(clauses):
        cset = frozenset(c)
        for lit in c:
            base = tuple(sorted(cset - {lit}))
            cand.setdefault(base, []).append((ci, lit))
    used: set[int] = set()
    groups: list[tuple[tuple, tuple]] = []
    for base, members in sorted(cand.items(),
                                key=lambda kv: (-len(kv[1]), kv[0])):
        live = [(ci, lit) for ci, lit in members if ci not in used]
        if len(live) < 2:
            continue
        used.update(ci for ci, _ in live)
        groups.append((base, tuple(sorted(lit for _, lit in live))))
    groups += [(c, ()) for ci, c in enumerate(clauses) if ci not in used]
    return FactoredPlan(tuple(sorted(groups)))


def key_indices(pred: Pred) -> set[int]:
    """Every key index mentioned anywhere in a predicate tree (including
    branches that normalization would simplify away)."""
    if isinstance(pred, Key):
        return {pred.index}
    if isinstance(pred, Not):
        return key_indices(pred.child)
    if isinstance(pred, (And, Or)):
        out: set[int] = set()
        for c in pred.children:
            out |= key_indices(c)
        return out
    raise TypeError(f"not a predicate: {pred!r}")


# ----------------------------------------------------------------- execution
@functools.lru_cache(maxsize=256)
def _compiled(backend_name: str, shape: tuple[int, ...]):
    """One executor per (backend, plan shape) — the reference's jit-cache
    key; the record count, gather indices and inversion flags are call
    arguments."""
    backend = backends.get_backend(backend_name)

    def run(packed, num_records, sels, invs):
        acc = torch.zeros((packed.shape[1],), dtype=torch.int32,
                          device=packed.device)
        for sel, inv in zip(sels, invs):
            row, _ = backend.query(packed[sel], inv)
            acc = acc | row
        return policy.mask_tail(acc, num_records)

    return run


@functools.lru_cache(maxsize=256)
def _compiled_factored(backend_name: str,
                       shape: tuple[tuple[int, int], ...]):
    """Executor for factored plans: per group one shared AND pass over the
    common literals plus one De-Morgan pass for the OR'd literals
    (``OR(lits) == ~AND(~lits)``; the caller pre-flips those inversion
    flags).  Same shape-keyed caching as the plain executor."""
    backend = backends.get_backend(backend_name)

    def run(packed, num_records, consts):
        nw = packed.shape[1]
        acc = torch.zeros((nw,), dtype=torch.int32, device=packed.device)
        for c_sel, c_inv, d_sel, d_inv in consts:
            if c_sel is not None:
                row, _ = backend.query(packed[c_sel], c_inv)
            else:
                row = torch.full((nw,), -1, dtype=torch.int32,
                                 device=packed.device)
            if d_sel is not None:
                r, _ = backend.query(packed[d_sel], d_inv)
                row = row & ~r
            acc = acc | row
        return policy.mask_tail(acc, num_records)

    return run


def _ints(values, device) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=4096)
def _plan_constants(clauses: tuple, device: torch.device):
    """Device-resident gather/inversion literal arrays, keyed on the plan's
    clauses and the device — a hot serving loop re-executing a plan never
    re-uploads them."""
    sels = tuple(_ints((i for i, _ in c), device) for c in clauses)
    invs = tuple(_ints((int(inv) for _, inv in c), device) for c in clauses)
    return sels, invs


@functools.lru_cache(maxsize=4096)
def _factored_constants(groups: tuple, device: torch.device):
    """Device-resident constants for a factored plan; OR-side inversion
    flags enter pre-flipped for the De-Morgan pass."""
    out = []
    for common, ored in groups:
        c_sel = _ints((i for i, _ in common), device) if common else None
        c_inv = _ints((int(v) for _, v in common), device) if common else None
        d_sel = _ints((i for i, _ in ored), device) if ored else None
        d_inv = _ints((int(not v) for _, v in ored), device) if ored else None
        out.append((c_sel, c_inv, d_sel, d_inv))
    return tuple(out)


def check_key_range(mentioned: Iterable[int], num_keys: int) -> None:
    """Raise on any key id outside [0, num_keys) — a gather would fault or
    mis-select, and the batch layer's virtual identity row lives at index
    ``num_keys``."""
    bad = sorted(i for i in mentioned if not 0 <= i < num_keys)
    if bad:
        raise ValueError(f"key indices {bad} out of range for an index "
                         f"with {num_keys} keys")


def plan_key_indices(pl: AnyPlan) -> set[int]:
    """Every key index a compiled plan gathers."""
    if isinstance(pl, QueryPlan):
        return {i for c in pl.clauses for i, _ in c}
    if isinstance(pl, FactoredPlan):
        return {i for c, d in pl.groups for i, _ in (*c, *d)}
    out: set[int] = set()
    for p in pl.parts:
        out |= plan_key_indices(p)
    return out


def _zeros(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dev = packed.device
    return (torch.zeros((packed.shape[1],), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def _run(packed: torch.Tensor, pl: AnyPlan, num_records: int, name: str
         ) -> tuple[torch.Tensor, torch.Tensor]:
    if isinstance(pl, QueryPlan):
        if not pl.clauses:   # contradiction: provably empty, no kernel pass
            return _zeros(packed)
        sels, invs = _plan_constants(pl.clauses, packed.device)
        return _compiled(name, pl.shape)(packed, num_records, sels, invs)
    if isinstance(pl, FactoredPlan):
        if not pl.groups:
            return _zeros(packed)
        consts = _factored_constants(pl.groups, packed.device)
        return _compiled_factored(name, pl.shape)(packed, num_records,
                                                  consts)
    row = _composite_row(packed, pl, num_records, name)
    return row, policy.popcount(row).sum(dtype=torch.int32)


def _composite_row(packed, node, num_records, name):
    """Leaf rows come back tail-masked, and AND/OR preserve zeroed tails, so
    the composite needs no second mask pass."""
    if not isinstance(node, CompositePlan):
        return _run(packed, node, num_records, name)[0]
    rows = [_composite_row(packed, p, num_records, name) for p in node.parts]
    out = rows[0]
    for r in rows[1:]:
        out = (out & r) if node.op == "and" else (out | r)
    return out


def execute(packed: torch.Tensor, predicate: Union[Pred, AnyPlan], *,
            num_records: int, backend: str = "auto"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a predicate (or pre-built plan) over a packed (M, Nw) index.

    Returns (packed result row (Nw,) int32, matching-record count), with
    tail bits past ``num_records`` masked to zero.  ``backend="auto"``
    routes through the measured cost model
    (:mod:`repro_torch.engine.costmodel`) of the index's device type — a
    per-call choice of the cheapest candidate backend for this plan shape
    and word count (on a CUDA device, always ``cuda``)."""
    if isinstance(predicate, (QueryPlan, FactoredPlan, CompositePlan)):
        pl = predicate
        mentioned = plan_key_indices(pl)
    else:
        # validate on the raw tree, BEFORE simplification, so a typo'd id
        # inside a contradictory/absorbed branch still raises
        mentioned = key_indices(predicate)
        pl = plan(predicate)
    if backend == "auto":
        from repro_torch.engine import costmodel  # deferred: it imports us
        name = costmodel.decide([pl], num_words=packed.shape[1],
                                num_keys=packed.shape[0],
                                allow_factor=False,
                                device=packed.device).backend
    else:
        name = backends.resolve_backend(backend, packed.device)
    check_key_range(mentioned, packed.shape[0])
    return _run(packed, pl, int(num_records), name)
