"""``repro_torch.engine`` — the execution layer for bitmap indexing (the
port's twin of ``repro.engine``):

  * :mod:`repro_torch.engine.policy`   — padding/sentinel policy, the tail
    mask, the packed splice, and the :class:`BitmapIndex` container.
  * :mod:`repro_torch.engine.backends` — backend registry (``cuda`` / ``ref``
    / ``bulk`` / ``auto``) behind one ``create_index`` / ``query``
    interface.
  * :mod:`repro_torch.engine.planner`  — boolean query planner: DNF, size
    guard, factoring, shape-keyed executor caches.
  * :mod:`repro_torch.engine.batch`    — batched query serving: plan-shape
    bucketing, identity-row padding, one executor call per bucket, and
    segment-parallel serving (stacked or per segment).
  * :mod:`repro_torch.engine.bulk`     — whole pass programs as fused
    sweeps (``bulk_program`` kernel on the card, plain sweep on the CPU).
  * :mod:`repro_torch.engine.costmodel` — measured roofline cost model
    behind ``backend="auto"``: a persisted per-device-type calibration
    plus a per-wave decision (backend, factoring, segment stacking).
  * :mod:`repro_torch.engine.runtime`  — streaming, durable append into a
    packed index, and the multi-core runtime with its energy accounting.

Symbols resolve lazily, so lower layers never form an import cycle through
this package ``__init__``.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("policy", "backends", "planner", "batch", "bulk",
               "costmodel", "runtime")

_EXPORTS = {
    # policy
    "PACK": "policy", "RECORD_SENTINEL": "policy", "KEY_SENTINEL": "policy",
    "BitmapIndex": "policy", "mask_tail": "policy",
    # backends
    "Backend": "backends", "register_backend": "backends",
    "get_backend": "backends", "resolve_backend": "backends",
    "available_backends": "backends",
    # planner
    "Pred": "planner", "Key": "planner", "And": "planner", "Or": "planner",
    "Not": "planner", "key": "planner", "plan": "planner",
    "QueryPlan": "planner", "CompositePlan": "planner",
    "FactoredPlan": "planner", "factor": "planner",
    "total_clauses": "planner", "execute": "planner",
    "from_include_exclude": "planner", "KeyStats": "planner",
    # batch
    "execute_many": "batch", "execute_many_segments": "batch",
    # costmodel
    "decide": "costmodel", "Decision": "costmodel",
    "Calibration": "costmodel", "BackendProfile": "costmodel",
    "get_calibration": "costmodel", "set_calibration": "costmodel",
    "measure_calibration": "costmodel",
    # runtime
    "StreamingIndexer": "runtime", "MulticoreRuntime": "runtime",
    "multicore_create_index": "runtime",
    "append_packed": "runtime", "fold_block_indexes": "runtime",
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
