"""``repro_torch.db`` — the schema-aware database facade over the engine
(the port's twin of ``repro.db``, in-memory half):

  * :class:`Schema` / :class:`Column` — named, typed columns mapped onto
    bitmap-index key rows.
  * :func:`col` — the typed expression DSL, lowering to engine predicates.
  * :class:`BitmapDB` — the session object: streaming ingest,
    selectivity-stats-ordered planning, lazy :class:`Result` handles and
    ``serve_step()``.
  * :func:`include_exclude_pred` — the deprecation shim for legacy
    ``include=``/``exclude=`` key lists.

Symbols resolve lazily (the :mod:`repro_torch.engine` idiom)::

    from repro_torch.db import BitmapDB, Column, Schema, col

    db = BitmapDB(schema)                    # on the card
    db.ingest({"city": [...], "temp": [...]})
    hot = db.query((col("city") == "SF") & col("temp").between(20, 30))
    print(hot.count, hot.ids[:10])
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("schema", "expr", "result", "session")

_EXPORTS = {
    # schema
    "Schema": "schema", "Column": "schema",
    # expression DSL
    "col": "expr", "Expr": "expr", "lower": "expr",
    # results
    "Result": "result", "LazyBatch": "result", "ResultBatch": "result",
    # session
    "BitmapDB": "session", "include_exclude_pred": "session",
}

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return __all__
