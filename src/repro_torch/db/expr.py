"""Typed expression DSL: schema-aware predicates that lower to the engine's
:class:`repro_torch.engine.planner.Pred` trees.

::

    from repro_torch.db import col

    q = (col("city") == "SF") & col("temp").between(10, 25) & \\
        ~col("tag").isin(["flagged", "dup"])

Expressions are immutable and hashable — a :class:`repro_torch.db.BitmapDB`
caches the lowered plan per expression, so a serving loop re-submitting the
same query never re-plans.  :func:`lower` maps an expression onto a schema:

  * ``col(c) == v``      -> ``key(schema.key_of(c, v))`` (for a binned
    column, the bin containing ``v``);
  * ``col(c) != v``      -> the negation of the above;
  * ``col(c).isin(vs)``  -> OR over the value keys (empty ``vs`` is a
    provable contradiction — the planner serves it as constant zeros);
  * ``col(c).between(lo, hi)`` (closed interval; also ``<``/``<=``/``>``/
    ``>=`` sugar on binned columns) -> OR over the overlapping bin keys;
  * ``& | ~``            -> ``And`` / ``Or`` / ``Not``.

Raw :class:`repro_torch.engine.planner.Pred` trees (integer ``key(i)`` literals)
pass through :func:`lower` untouched — the compatibility shim for callers
that address key rows directly.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.db.schema import Schema
from repro_torch.engine import planner


class Expr:
    """Base schema-level predicate; combine with ``&``, ``|``, ``~``."""

    def __and__(self, other: "Expr") -> "Expr":
        return AndExpr((self, _check(other)))

    def __or__(self, other: "Expr") -> "Expr":
        return OrExpr((self, _check(other)))

    def __invert__(self) -> "Expr":
        return NotExpr(self)


def _check(e) -> "Expr":
    if not isinstance(e, (Expr, planner.Pred)):
        raise TypeError(f"cannot combine an expression with {e!r}; did you "
                        "mean col(...) == value / .isin(...) / .between(...)?")
    return e


@dataclasses.dataclass(frozen=True)
class Eq(Expr):
    column: str
    value: object


@dataclasses.dataclass(frozen=True)
class In(Expr):
    column: str
    values: tuple


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    """Closed interval [lo, hi] over a column's values."""
    column: str
    lo: object
    hi: object


@dataclasses.dataclass(frozen=True)
class AndExpr(Expr):
    children: tuple


@dataclasses.dataclass(frozen=True)
class OrExpr(Expr):
    children: tuple


@dataclasses.dataclass(frozen=True)
class NotExpr(Expr):
    child: object


@dataclasses.dataclass(frozen=True)
class ColumnRef:
    """``col(name)`` — build typed predicates with comparison operators."""
    name: str

    def __eq__(self, value) -> Expr:          # type: ignore[override]
        if isinstance(value, ColumnRef):
            raise TypeError("column-to-column comparison is not a bitmap "
                            "operation; compare against a value")
        return Eq(self.name, value)

    def __ne__(self, value) -> Expr:          # type: ignore[override]
        return NotExpr(Eq(self.name, value))

    def __hash__(self) -> int:                # __eq__ override drops it
        return hash(("ColumnRef", self.name))

    def isin(self, values) -> Expr:
        return In(self.name, tuple(values))

    def between(self, lo, hi) -> Expr:
        return Between(self.name, lo, hi)

    # range sugar (binned columns; lowered via Between against the edges)
    def __lt__(self, value) -> Expr:
        return Between(self.name, float("-inf"), _open_below(value))

    def __le__(self, value) -> Expr:
        return Between(self.name, float("-inf"), value)

    def __gt__(self, value) -> Expr:
        return Between(self.name, _open_above(value), float("inf"))

    def __ge__(self, value) -> Expr:
        return Between(self.name, value, float("inf"))


def _open_below(value):
    """Largest float strictly below ``value`` — turns an open bound into
    the closed interval Between models."""
    import math
    return math.nextafter(float(value), float("-inf"))


def _open_above(value):
    import math
    return math.nextafter(float(value), float("inf"))


def col(name: str) -> ColumnRef:
    """Reference a schema column by name."""
    return ColumnRef(str(name))


AnyQuery = Union[Expr, planner.Pred]


def _or_keys(keys) -> planner.Pred:
    """OR over key rows; an empty key set lowers to a provable
    contradiction (the planner simplifies ``k & ~k`` to zero clauses and
    serves it as constant zeros with no kernel pass)."""
    keys = list(keys)
    if not keys:
        return planner.key(0) & ~planner.key(0)
    if len(keys) == 1:
        return planner.key(keys[0])
    return planner.Or(tuple(planner.key(k) for k in keys))


def lower(expr: AnyQuery, schema: Schema | None) -> planner.Pred:
    """Lower a schema expression to an engine predicate tree.  Raw ``Pred``
    literals pass through, and mixed trees (``key(3) & (col("c") == v)``)
    lower branch by branch."""
    if isinstance(expr, planner.Key):
        return expr
    if isinstance(expr, (planner.Not, NotExpr)):
        return planner.Not(lower(expr.child, schema))
    if isinstance(expr, (planner.And, AndExpr)):
        return planner.And(tuple(lower(c, schema) for c in expr.children))
    if isinstance(expr, (planner.Or, OrExpr)):
        return planner.Or(tuple(lower(c, schema) for c in expr.children))
    if not isinstance(expr, Expr):
        raise TypeError(f"not a query expression: {expr!r}")
    if schema is None:
        raise ValueError("schema-level expressions need a Schema; this "
                         "session was opened without one (raw key(i) "
                         "predicates still work)")
    return _lower(expr, schema)


def _lower(e: Expr, s: Schema) -> planner.Pred:
    if isinstance(e, Eq):
        return planner.key(s.key_of(e.column, e.value))
    if isinstance(e, In):
        keys = [s.key_of(e.column, v) for v in e.values]
        return _or_keys(dict.fromkeys(keys))    # dedup, keep order
    if isinstance(e, Between):
        return _or_keys(s[e.column].keys_between(e.lo, e.hi))
    raise TypeError(f"not a query expression: {e!r}")
