"""Logical-axis sharding: model code names axes, a rules table maps them to
mesh axes, and a divisibility guard drops any mapping that does not divide.

The port's twin of ``repro.parallel.sharding``, over the port's meshes
(``repro_torch.launch.mesh``: an ``AbstractMesh`` of axis names and sizes,
or a ``DistMesh`` over the processes' devices, made current by
``set_mesh``).  A spec is a tuple with one entry per dimension: a mesh axis
name, a tuple of names, or None (replicated), as the entries of the
reference's ``PartitionSpec``; :func:`placements` turns it into the
DTensor placements of a ``DistMesh``, one per mesh dimension.

Why the guard: the production mesh is fixed at (data=16, model=16)
[+pod=2], but the assigned architectures have head counts (28, 25, 96/kv8),
expert counts (60, 40) and vocabs that are not all divisible by 16.
Rather than hand-casing every arch, :func:`logical_spec` checks
divisibility per tensor and falls back to replication on that axis (e.g.
qwen2's 28 Q-heads replicate over ``model`` while its head_dim (128) takes
the TP sharding instead: "heads" and "head_dim" both map to "model", the
first divisible one wins, axes are never used twice).

Logical axes used by the model code:
  batch     -> ("pod", "data")   data parallel (pod folds into DP)
  fsdp      -> "data"            parameter/optimizer sharding (ZeRO-3)
  model/tp  -> "model"           tensor parallel (d_ff, heads, vocab, experts)
  seq       -> sequence parallel axis (activations, long-context)

The dry run (``repro_torch.launch.dryrun``) reads these specs on an
abstract mesh for the per-device bytes of each argument (:func:`shard_bytes`);
there :func:`constrain` is an identity, as it is with no mesh or a mesh of
one device.  On a ``DistMesh`` of more than one device it is the
reference's ``with_sharding_constraint``: it redistributes a DTensor to the
spec's placements (``DTensor.redistribute``: the collectives that XLA's
partitioner would insert).  :func:`distribute` places a tensor that every
process holds whole (a parameter, a batch, rope angles) on a ``DistMesh``
without communication.
"""
from __future__ import annotations

import threading
from typing import Sequence

import torch

from repro_torch.launch.mesh import (AbstractMesh, DistMesh, as_mesh,
                                     get_abstract_mesh, set_mesh)

AxisName = str | tuple[str, ...] | None

DEFAULT_RULES: dict[str, AxisName] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "embed": None,           # d_model on activations: replicated
    "mlp": "model",          # d_ff
    "heads": "model",        # attention / ssm heads
    "head_dim": "model",     # fallback TP axis when heads don't divide
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",      # EP when divisible, else falls back
    "expert_mlp": "model",   # TP inside experts (used when EP doesn't divide)
    "seq": "data",           # sequence parallelism (activations only)
    "seq_sp": "model",       # Megatron-style SP: residual stream S over TP
    "cache_seq": None,
    "conv": None,
    "state": None,
}


class LogicalRules(threading.local):
    def __init__(self):
        self.rules = dict(DEFAULT_RULES)


_RULES = LogicalRules()


def set_rules(rules: dict[str, AxisName]) -> None:
    _RULES.rules = dict(rules)


def get_rules() -> dict[str, AxisName]:
    return _RULES.rules


def _mesh_axis_sizes() -> dict[str, int]:
    mesh = get_abstract_mesh()
    if mesh is None or mesh.empty:
        return {}
    return mesh.shape


def logical_spec(shape: Sequence[int], logical: Sequence[str | None]
                 ) -> tuple:
    """Map logical axis names to a spec, enforcing divisibility and never
    assigning the same mesh axis twice (first divisible dim wins).  Tuple
    rules (e.g. batch -> ("pod", "data")) keep whichever member axes exist
    in the current mesh.  With no current mesh every entry is None."""
    sizes = _mesh_axis_sizes()
    used: set[str] = set()
    out: list[AxisName] = []
    for dim, name in zip(shape, logical):
        axis = _RULES.rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        axes = tuple(a for a in ((axis,) if isinstance(axis, str) else axis)
                     if sizes.get(a))
        n = 1
        for a in axes:
            n *= sizes[a]
        if not axes or dim % n or any(a in used for a in axes):
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def placements(spec, mesh: AbstractMesh) -> list:
    """The DTensor placements of a :func:`logical_spec` entry on ``mesh``,
    one per mesh dimension: ``Shard(dim)`` on each mesh axis that the
    spec's entry for tensor dimension ``dim`` names (a tuple entry such as
    ("pod", "data") shards that dimension over both, outer axis first, as
    the reference's ``PartitionSpec``), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[mesh.axis_names.index(a)] = Shard(dim)
    return out


def mesh_placements(shape: Sequence[int], logical: Sequence[str | None],
                    mesh: AbstractMesh) -> list:
    """:func:`placements` of the :func:`logical_spec` of ``shape`` under
    ``logical`` on ``mesh`` (whatever mesh is current)."""
    with set_mesh(mesh):
        return placements(logical_spec(shape, logical), mesh)


def constrain(x: torch.Tensor, logical: Sequence[str | None]
              ) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: ``x``
    itself with no current mesh, on an abstract mesh (the dry run's meta
    trace: no devices exist) and on a mesh of one device (nothing to
    reshard); on a :class:`DistMesh` of more than one device ``x`` (a
    DTensor, or a plain tensor the same on every process) redistributed to
    :func:`placements` of its :func:`logical_spec`.  A DTensor is held on
    its own mesh, current or not (a remat recompute runs in the backward,
    outside the forward's ``set_mesh``)."""
    mesh = (as_mesh(x.device_mesh) if hasattr(x, "device_mesh")
            else get_abstract_mesh())
    if not isinstance(mesh, DistMesh) or mesh.size == 1:
        return x
    if not hasattr(x, "redistribute"):
        return distribute(x, logical, mesh)
    return x.redistribute(mesh.device_mesh,
                          mesh_placements(x.shape, logical, mesh))


def distribute(x: torch.Tensor, logical: Sequence[str | None],
               mesh: AbstractMesh | None = None) -> torch.Tensor:
    """``x``, which every process holds whole and alike, as a DTensor on
    ``mesh`` (default the current one) under :func:`mesh_placements`: each
    process keeps its own slice, with no communication.  On a
    :class:`DistMesh` of any size, one device too (so that it meets the
    model's DTensor parameters there); ``x`` itself off one."""
    mesh = get_abstract_mesh() if mesh is None else mesh
    if not isinstance(mesh, DistMesh):
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh.device_mesh,
                             mesh_placements(x.shape, logical, mesh),
                             src_data_rank=None)


def _is_names(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in v)


def spec_tree(logical_tree, params):
    """Map a tree of logical-name tuples (dicts mirroring ``params``) to
    specs.  ``params`` may hold meta tensors (abstract init)."""
    if _is_names(logical_tree):
        return logical_spec(params.shape, logical_tree)
    return {k: spec_tree(v, params[k]) for k, v in logical_tree.items()}


def shard_bytes(tensor: torch.Tensor, spec, mesh: AbstractMesh) -> int:
    """The bytes of ``tensor``'s shard on one device of ``mesh`` under
    ``spec``: its bytes over the product of the sizes of the mesh axes the
    spec names.  Each dimension must split evenly over its axes
    (:func:`logical_spec` only names such axes), so this is exact."""
    sizes = mesh.shape
    n = 1
    for dim, entry in zip(tensor.shape, spec):
        k = 1
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            k *= sizes[a]
        if dim % k:
            raise ValueError(f"{tuple(tensor.shape)} does not split over "
                             f"{spec} on the {mesh.name} mesh")
        n *= k
    return tensor.numel() * tensor.element_size() // n
