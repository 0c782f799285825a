"""Backend registry — every index build and query pass dispatches here.

The port's twin of ``repro.engine.backends``.  A :class:`Backend` pairs the
two primitive operations the engine needs:

  * ``create_index(records (N, W) int, keys (M,) int)``
      -> key-major packed bitmap (M, ceil(N/32)) int32, all pad bits past N
      zero;
  * ``query(rows (K, Nw) int32, invert (K,) int)``
      -> (result row (Nw,) int32, popcount) for AND_k (invert_k ? ~r : r),
      tail bits past the record count NOT masked (the planner masks once per
      plan);

and optionally ``run_program``, a whole-bucket executor with the batched
layer's call contract (see :mod:`repro_torch.engine.bulk`), and
``run_program_stacked``, its twin over a stack of uniform segments.

Built-ins:

  * ``cuda`` — the hand-written kernels: ``create_index`` is ``cam_match``
    then ``bit_transpose``, ``query`` is ``bitmap_query``, ``run_program`` is
    the counted ``bulk_program`` launch, ``run_program_stacked`` the stacked
    counted launch (tail masks and popcounts in the kernel's epilogue).
    On CPU tensors each kernel wrapper runs its plain version.
  * ``ref`` — the plain-torch oracle (per-pass bucket body).
  * ``bulk`` — the plain-torch tiled sweep (whole-bucket ``run_program``).

``ref`` and ``bulk`` are plain torch on every device, so on the card they
are the references the kernels are held against.  ``auto`` without
workload information resolves by the device of the index: ``cuda`` on a
CUDA device, ``ref`` on the CPU; with no device it resolves for the card,
like every entry point of the port.  The workload-aware call sites
(``planner.execute``, ``engine.batch``, ``repro_torch.db``) instead route
``auto`` through the measured cost model
(:mod:`repro_torch.engine.costmodel`), whose only candidate on a CUDA
device is ``cuda``.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import torch

from repro_torch.engine import bulk, policy
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    create_index: Callable
    query: Callable
    #: optional whole-bucket executor; backends without one get the
    #: per-pass bucket body composed around ``query``
    run_program: Callable | None = None
    #: optional segment-stacked whole-bucket executor (aug (S, M+1, Nw),
    #: S record counts); backends without one run their bucket body
    #: segment by segment
    run_program_stacked: Callable | None = None


_REGISTRY: dict[str, Backend] = {}

# Executor caches close over Backend objects; re-registering a name must
# drop them so stale backends never keep serving.  getattr-guarded: a
# module may be mid-import.
_COMPILED_CACHES = (
    ("repro_torch.engine.planner", ("_compiled", "_compiled_factored")),
    ("repro_torch.engine.batch", ("_executor", "_stacked_executor")),
)


def register_backend(backend: Backend) -> Backend:
    _REGISTRY[backend.name] = backend
    for modname, attrs in _COMPILED_CACHES:
        mod = sys.modules.get(modname)
        for attr in attrs if mod is not None else ():
            cache = getattr(mod, attr, None)
            if cache is not None:
                cache.cache_clear()
    return backend


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY)) + ("auto",)


def resolve_backend(name: str, device=None) -> str:
    """Map ``auto`` to a concrete backend for ``device`` (default the card:
    raises through :func:`policy.resolve_device` when no GPU is present)."""
    if name == "auto":
        dev = (policy.resolve_device("cuda") if device is None
               else torch.device(device))
        return "cuda" if dev.type == "cuda" else "ref"
    if name not in _REGISTRY:
        raise ValueError(f"unknown backend {name!r}; "
                         f"registered: {available_backends()}")
    return name


def get_backend(name: str = "auto", device=None) -> Backend:
    return _REGISTRY[resolve_backend(name, device)]


# ------------------------------------------------------------ built-ins
# ref and bulk share the oracle index build (sentinel padding + the plain
# pipeline, sliced back to logical shape)
register_backend(Backend("ref", bulk.create_index, ref.bitmap_query))
register_backend(Backend("bulk", bulk.create_index, bulk.query,
                         run_program=bulk.run_program_plain))
register_backend(Backend("cuda", ops.create_index, ops.query,
                         run_program=bulk.run_program,
                         run_program_stacked=bulk.run_program_stacked))
