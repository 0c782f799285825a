"""``repro_torch`` — the PyTorch + CUDA port of ``repro``, the bitmap-index
system grown from the paper's BIC core (see ROADMAP.md).

It mirrors ``repro``'s module layout one for one and imports nothing of it:
plain tensor code is PyTorch, and the Pallas TPU kernels of the BIC path
are hand-written CUDA kernels for Hopper (``repro_torch/csrc``), built with
``nvcc`` at first use.  Entry points run on the card (``device="cuda"``)
unless the caller asks for ``device="cpu"``::

    import repro_torch as rt

    schema = rt.Schema([rt.Column.categorical("city", ["SF", "NY", "LA"])])
    db = rt.BitmapDB(schema)
    db.ingest({"city": ["SF", "LA", "SF"]})
    db.query(rt.col("city") == "SF").ids        # -> array([0, 2])

    db = rt.BitmapDB(schema, path="/data/idx")  # durable: WAL + segments
    ...                                         # crash
    db = rt.open("/data/idx")                   # the same index, recovered

Symbols resolve lazily, so importing ``repro_torch`` alone loads no
submodule.
"""
from __future__ import annotations

import importlib

#: facade symbols re-exported at top level -> their home in repro_torch.db
_DB_EXPORTS = ("BitmapDB", "Schema", "Column", "col", "Result", "open")

_SUBMODULES = ("db", "engine", "store", "core", "kernels", "fault", "obs")

__all__ = sorted(_DB_EXPORTS) + sorted(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _DB_EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.db"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
