"""Meshes: axis names and sizes, abstract or over the processes' devices.

The port's twin of ``repro.launch.mesh``.  A :class:`AbstractMesh` is what
``jax.sharding.AbstractMesh`` is to the reference: the shape that
``repro_torch.parallel.sharding.logical_spec`` maps logical axes onto, with
no devices (the dry run traces on it).  A :class:`DistMesh` is the same
shape over real devices: one ``torch.distributed`` process a device, its
``device_mesh`` a ``torch.distributed.device_mesh.DeviceMesh`` (NCCL on the
cards, ``gloo`` when the caller asks for the CPU), on which
``repro_torch.parallel.sharding.constrain`` redistributes DTensors.  Both
read alike (``shape``, ``size``, ``name``), so ``logical_spec`` works on
both.  :func:`set_mesh` makes either current for the calling thread, the
way ``jax.set_mesh`` does.  Nothing here touches a device when imported,
and the production meshes never do (the reference forces 512 host devices
to build them; the port needs none).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist

from repro_torch.engine.policy import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, outermost first."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names {self.axis_names} repeat")

    @property
    def shape(self) -> dict[str, int]:
        """name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def empty(self) -> bool:
        return not self.axis_names

    @property
    def name(self) -> str:
        """"16x16", "2x16x16", "1" ..."""
        return "x".join(str(s) for s in self.axis_sizes)


@dataclasses.dataclass(frozen=True)
class DistMesh(AbstractMesh):
    """An :class:`AbstractMesh` over the devices of the processes of the
    default ``torch.distributed`` group, one device a process, in rank
    order: ``device_mesh`` is its ``DeviceMesh`` (dimension names the axis
    names), ``device`` this process's device."""
    device_mesh: object = dataclasses.field(default=None, compare=False,
                                            repr=False)
    device: torch.device = dataclasses.field(default=None, compare=False)


def as_mesh(mesh):
    """A torch ``DeviceMesh`` (with dimension names) as a :class:`DistMesh`;
    a mesh of this module, or None, as it is."""
    if isinstance(mesh, AbstractMesh) or mesh is None:
        return mesh
    if not mesh.mesh_dim_names:
        raise ValueError("a DeviceMesh needs mesh_dim_names")
    dev = torch.device(mesh.device_type, torch.cuda.current_device()
                       if mesh.device_type == "cuda" else None)
    return DistMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh, dev)


class _Current(threading.local):
    def __init__(self):
        self.mesh = None


_CURRENT = _Current()


def get_abstract_mesh() -> AbstractMesh | None:
    """The calling thread's current mesh (None outside :func:`set_mesh`):
    an :class:`AbstractMesh` or a :class:`DistMesh`."""
    return _CURRENT.mesh


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` current for the calling thread inside the block: an
    :class:`AbstractMesh`, a :class:`DistMesh` or a torch ``DeviceMesh``
    with dimension names (held as a :class:`DistMesh`)."""
    mesh = as_mesh(mesh)
    prev = _CURRENT.mesh
    _CURRENT.mesh = mesh
    try:
        yield mesh
    finally:
        _CURRENT.mesh = prev


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16x16 = 256 devices (data, model).  Multi-pod: 2x16x16 =
    512 (pod, data, model); the pod axis is an outer data-parallel axis
    (see ``repro_torch.parallel.sharding``)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def init_distributed(coordinator: str, world_size: int, rank: int, *,
                     device="cuda", local_rank: int = 0) -> torch.device:
    """Join the default process group at ``tcp://<coordinator>`` (host:port)
    as ``rank`` of ``world_size`` and return this process's device: card
    ``local_rank`` under NCCL for ``device="cuda"`` (raises without a card),
    the CPU under ``gloo`` only when the caller asks for ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: "
                               f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank,
                            device_id=dev if dev.type == "cuda" else None)
    return dev


def make_device_mesh(axis_sizes, axis_names, device="cuda") -> DistMesh:
    """A :class:`DistMesh` of ``axis_sizes`` over the processes of the
    default group (``torch.distributed.device_mesh.init_device_mesh``): on
    the cards under NCCL, on the CPU under ``gloo`` only when the caller
    asks for ``device="cpu"``.  Raises unless the group is up with the
    backend the device needs and one process a device of the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh: no process group; call "
                           "init_distributed (or init_process_group) first")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if want not in str(dist.get_backend()):
        raise RuntimeError(f"make_device_mesh: a {dev.type} mesh needs the "
                           f"{want} backend, the group has "
                           f"{dist.get_backend()}")
    sizes, names = tuple(axis_sizes), tuple(axis_names)
    n = 1
    for s_ in sizes:
        n *= s_
    if n != dist.get_world_size():
        raise RuntimeError(f"a {'x'.join(map(str, sizes))} mesh needs {n} "
                           f"processes, the group has "
                           f"{dist.get_world_size()}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return DistMesh(sizes, names,
                    init_device_mesh(dev.type, sizes, mesh_dim_names=names),
                    dev)


def make_smoke_mesh(device="cuda") -> AbstractMesh:
    """A (data,) mesh over the ranks: a :class:`DistMesh` of one device a
    process when a process group is up, else one device (this process's,
    checked: the card unless the caller asks for ``device="cpu"``) as an
    :class:`AbstractMesh`, on which nothing is sharded."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return make_device_mesh((dist.get_world_size(),), ("data",), dev)
    return AbstractMesh((1,), ("data",))
