"""Meshes as the dry run sees them: axis names and sizes, no devices.

The port's twin of ``repro.launch.mesh``.  A :class:`AbstractMesh` is what
``jax.sharding.AbstractMesh`` is to the reference: the shape that
``repro_torch.parallel.sharding.logical_spec`` maps logical axes onto.
:func:`set_mesh` makes one current for the calling thread, the way
``jax.set_mesh`` does.  Nothing here touches a device when imported, and
the production meshes never do (the reference forces 512 host devices to
build them; the port needs none).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

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


class _Current(threading.local):
    def __init__(self):
        self.mesh = None


_CURRENT = _Current()


def get_abstract_mesh() -> AbstractMesh | None:
    """The calling thread's current mesh (None outside :func:`set_mesh`)."""
    return _CURRENT.mesh


@contextlib.contextmanager
def set_mesh(mesh: AbstractMesh):
    """Make ``mesh`` current for the calling thread inside the block."""
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


def make_smoke_mesh(device="cuda") -> AbstractMesh:
    """A (data,) mesh over the cards present (raises without one), or over
    the CPU, one device, when the caller asks for ``device="cpu"``."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return AbstractMesh((n,), ("data",))
