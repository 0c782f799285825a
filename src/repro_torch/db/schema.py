"""`Schema` — named, typed columns mapped onto bitmap-index key rows.

The engine below this layer knows nothing but integer key rows: a record
is a bag of integer words, key row ``k`` is set for every record containing
word ``k``.  A :class:`Schema` is the dictionary that makes those rows mean
something:

  * a **categorical** column owns one key row per distinct value
    (``city == "SF"`` is exactly one row test);
  * a **binned** numeric column owns one key row per half-open bin
    ``[edges[i], edges[i+1])`` (range predicates become ORs over the
    overlapping bins — the classic bitmap-index binning trade: coarser bins
    -> fewer rows, weaker pruning).

Key rows are assigned contiguously in column order, so a schema with a
3-value categorical followed by a 4-bin numeric occupies rows 0-2 and 3-6.
:meth:`Schema.encode` turns structured rows (dicts, or a column-major
mapping of arrays) into the ``(N, num_columns)`` int32 key-word records the
engine backends index directly — one word per column, each word a global
key id, so per-key value frequencies from :meth:`count_keys` are EXACT
set-bit counts for schema-encoded data.

Schemas serialize to/from JSON (:meth:`to_json` / :meth:`from_json`), the
same ``SCHEMA.json`` text the reference persists next to its segment store.
This module is a copy of ``repro.db.schema``.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import json
from typing import Iterable, Mapping, Sequence

import numpy as np

CATEGORICAL = "categorical"
BINNED = "binned"


@dataclasses.dataclass(frozen=True)
class Column:
    """One named column and its key-row mapping (``base`` is assigned by
    the owning :class:`Schema`)."""
    name: str
    kind: str                          # CATEGORICAL | BINNED
    values: tuple = ()                 # categorical: distinct values
    edges: tuple = ()                  # binned: ascending bin edges
    base: int = 0                      # first key row owned by this column

    @staticmethod
    def categorical(name: str, values: Iterable) -> "Column":
        vals = tuple(values)
        if not vals:
            raise ValueError(f"column {name!r} needs at least one value")
        if len(set(vals)) != len(vals):
            raise ValueError(f"column {name!r} has duplicate values")
        return Column(name, CATEGORICAL, values=vals)

    @staticmethod
    def binned(name: str, edges: Iterable[float]) -> "Column":
        e = tuple(float(x) for x in edges)
        if len(e) < 2 or any(a >= b for a, b in zip(e, e[1:])):
            raise ValueError(f"column {name!r} needs >= 2 strictly "
                             "ascending bin edges")
        return Column(name, BINNED, edges=e)

    @property
    def cardinality(self) -> int:
        """Key rows this column owns."""
        return (len(self.values) if self.kind == CATEGORICAL
                else len(self.edges) - 1)

    # ------------------------------------------------------- value -> key
    @functools.cached_property
    def _value_keys(self) -> dict:
        """value -> key row lookup (cached_property writes the instance
        ``__dict__`` directly, so it coexists with frozen=True)."""
        return {v: self.base + i for i, v in enumerate(self.values)}

    def key_of(self, value) -> int:
        """The single key row testing ``value`` (a categorical value, or
        the bin containing a numeric value)."""
        if self.kind == CATEGORICAL:
            try:
                return self._value_keys[value]
            except KeyError:
                raise KeyError(f"column {self.name!r} has no value "
                               f"{value!r}") from None
            except TypeError:              # unhashable probe value
                raise KeyError(f"column {self.name!r} has no value "
                               f"{value!r}") from None
        v = float(value)
        if not self.edges[0] <= v <= self.edges[-1]:
            raise KeyError(f"column {self.name!r}: {value!r} outside "
                           f"binned range [{self.edges[0]}, "
                           f"{self.edges[-1]}]")
        # right edge of the last bin is inclusive (it would otherwise map
        # to a nonexistent bin)
        bin_i = min(bisect.bisect_right(self.edges, v) - 1,
                    self.cardinality - 1)
        return self.base + bin_i

    def keys_between(self, lo, hi) -> tuple[int, ...]:
        """Key rows whose value set can intersect the CLOSED interval
        ``[lo, hi]`` — for binned columns the overlapping bins, for
        categoricals the values inside the interval."""
        if lo > hi:
            return ()
        if self.kind == CATEGORICAL:
            return tuple(self.base + i for i, v in enumerate(self.values)
                         if lo <= v <= hi)
        nbins = self.cardinality
        if float(lo) > self.edges[-1] or float(hi) < self.edges[0]:
            return ()
        first = min(max(bisect.bisect_right(self.edges, float(lo)) - 1, 0),
                    nbins - 1)
        last = min(max(bisect.bisect_right(self.edges, float(hi)) - 1, 0),
                   nbins - 1)
        return tuple(self.base + i for i in range(first, last + 1))

    def key_label(self, key_id: int) -> str:
        i = key_id - self.base
        if self.kind == CATEGORICAL:
            return f"{self.name}={self.values[i]!r}"
        return f"{self.name}∈[{self.edges[i]}, {self.edges[i + 1]})"


class Schema:
    """An ordered set of :class:`Column` s sharing one key-row space."""

    def __init__(self, columns: Sequence[Column]):
        if not columns:
            raise ValueError("a Schema needs at least one column")
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {names}")
        out, base = [], 0
        for c in columns:
            out.append(dataclasses.replace(c, base=base))
            base += c.cardinality
        self.columns: tuple[Column, ...] = tuple(out)
        self.num_keys: int = base
        self._by_name = {c.name: c for c in self.columns}

    def __getitem__(self, name: str) -> Column:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"schema has no column {name!r}; columns: "
                           f"{sorted(self._by_name)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema)
                and self.columns == other.columns)

    def __hash__(self) -> int:
        return hash(self.columns)

    def __repr__(self) -> str:
        cols = ", ".join(f"{c.name}:{c.kind}[{c.cardinality}]"
                         for c in self.columns)
        return f"Schema({cols}; {self.num_keys} keys)"

    def key_of(self, column: str, value) -> int:
        return self[column].key_of(value)

    def key_label(self, key_id: int) -> str:
        """Human name of one key row (reverse mapping, for repr/debug)."""
        for c in self.columns:
            if c.base <= key_id < c.base + c.cardinality:
                return c.key_label(key_id)
        raise KeyError(f"key id {key_id} outside schema "
                       f"({self.num_keys} keys)")

    # ------------------------------------------------------------- encode
    def encode(self, rows) -> np.ndarray:
        """Structured rows -> ``(N, num_columns)`` int32 key-word records.

        ``rows`` is either column-major (a mapping ``{name: values}``, all
        the same length) or row-major (an iterable of per-row mappings).
        Every column must be present in every row — a bitmap index has no
        NULL; model optional attributes as an explicit category."""
        if isinstance(rows, Mapping):
            cols = {}
            n = None
            for c in self.columns:
                if c.name not in rows:
                    raise KeyError(f"encode: missing column {c.name!r}")
                vals = list(rows[c.name])
                if n is None:
                    n = len(vals)
                elif len(vals) != n:
                    raise ValueError(
                        f"encode: column {c.name!r} has {len(vals)} values, "
                        f"expected {n}")
                cols[c.name] = vals
            extra = set(rows) - set(cols)
            if extra:
                raise KeyError(f"encode: unknown columns {sorted(extra)}")
            out = np.empty((n or 0, len(self.columns)), np.int32)
            for j, c in enumerate(self.columns):
                out[:, j] = [c.key_of(v) for v in cols[c.name]]
            return out
        rows = list(rows)
        out = np.empty((len(rows), len(self.columns)), np.int32)
        for i, r in enumerate(rows):
            extra = set(r) - set(self._by_name)
            if extra:
                raise KeyError(f"encode: unknown columns {sorted(extra)} "
                               f"in row {i}")
            for j, c in enumerate(self.columns):
                if c.name not in r:
                    raise KeyError(f"encode: row {i} missing column "
                                   f"{c.name!r}")
                out[i, j] = c.key_of(r[c.name])
        return out

    def count_keys(self, encoded: np.ndarray) -> np.ndarray:
        """Per-key occurrence counts over encoded records (int64,
        ``num_keys`` long).  Exact set-bit counts when every record's
        words are distinct — always true for :meth:`encode` output (one
        word per column, disjoint key ranges); an upper bound for raw
        key-word records that may repeat a key within a record."""
        enc = np.asarray(encoded)
        words = enc[(enc >= 0) & (enc < self.num_keys)]
        return np.bincount(words, minlength=self.num_keys).astype(np.int64)

    # ----------------------------------------------------------- serialize
    def to_json(self) -> str:
        return json.dumps({
            "version": 1,
            "columns": [{"name": c.name, "kind": c.kind,
                         "values": list(c.values), "edges": list(c.edges)}
                        for c in self.columns]})

    @classmethod
    def from_json(cls, text: str) -> "Schema":
        data = json.loads(text)
        cols = []
        for c in data["columns"]:
            if c["kind"] == CATEGORICAL:
                vals = [tuple(v) if isinstance(v, list) else v
                        for v in c["values"]]
                cols.append(Column.categorical(c["name"], vals))
            else:
                cols.append(Column.binned(c["name"], c["edges"]))
        return cls(cols)
