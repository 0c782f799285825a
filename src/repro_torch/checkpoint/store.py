"""Checkpointing and restart: the training loop's fault tolerance.

The port's twin of ``repro.checkpoint.store``, on the port's own
:mod:`repro_torch.store.format` (the versioned, CRC-checked array file the
segment store uses), so a torn or bit-flipped checkpoint raises
``CorruptFileError`` on restore.  A state is a nested dict of tensors (or
numpy arrays, or numbers); it is flattened to "/"-joined names, as the
reference flattens its pytrees, and the training loop hands over the
reference's layout (flat parameter names, per-layer tensors stacked on the
L axis, ``opt/m``, ``opt/v``, ``opt/step``), so a checkpoint written by
either package restores in the other.  bf16 tensors go to disk under the
dtype name ``bfloat16`` as the reference's do.

  * Atomic writes: the array file lands in ``tmp-<step>``, which is renamed
    to ``step-<step:08d>`` whole, so a crash mid-save never leaves a partial
    step behind and restart always finds a complete one.
  * ``CheckpointManager`` adds the cadence, retention and an async mode
    (the state is copied to host memory on the caller's thread, then
    written on a thread) so the step loop does not wait for the disk.
  * Distributed: a DTensor leaf is gathered whole (every process takes
    part) and the file is written once, by rank 0, in the same format, so
    the reference reads it.  Restore reads every array by name into
    ``state_like``'s placements: a checkpoint written on one mesh restores
    on another, or on one process (the elastic restart).  A
    :class:`LayerStack` leaf is stacked on the host a layer at a time, so
    no stacked copy of the state is made on a device.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.store import format as fmt


class LayerStack:
    """A leaf that stands for ``torch.stack(tensors)``: saved as one array
    stacked on the host a layer at a time (each DTensor gathered whole
    first), restored as one tensor a layer placed like each of
    ``tensors``; indexing gives a layer."""

    def __init__(self, tensors):
        self.tensors = list(tensors)

    def __getitem__(self, i):
        return self.tensors[i]

    def __len__(self):
        return len(self.tensors)


def writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf, keep: bool = True) -> tuple[np.ndarray | None,
                                                 str | None]:
    """(host array, stored dtype name or None) of one leaf; a bf16 tensor
    becomes its uint16 bits stored as ``bfloat16``.  A DTensor is gathered
    whole first; without ``keep`` (a process that does not write) nothing
    is copied to the host and the array is None."""
    if isinstance(leaf, LayerStack):
        parts = [_to_numpy(t, keep) for t in leaf.tensors]
        return (np.stack([a for a, _ in parts]) if keep else None,
                parts[0][1])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        dtype = "bfloat16" if t.dtype == torch.bfloat16 else None
        if not keep:
            return None, dtype
        t = t.cpu()
        if dtype:
            return t.view(torch.int16).numpy().view(np.uint16), dtype
        return t.numpy(), None
    return np.asarray(leaf), None


def _flatten(tree: Any, prefix: str = "", names: dict | None = None,
             keep: bool = True) -> dict[str, np.ndarray]:
    """"/"-joined names -> host arrays (device -> host copies happen here,
    and the gathers of DTensors: every process of their mesh calls this);
    ``names`` collects stored dtype names that differ from numpy's."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", names, keep))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", names, keep))
    else:
        arr, dtype = _to_numpy(tree, keep)
        out[prefix[:-1]] = arr
        if dtype is not None and names is not None:
            names[prefix[:-1]] = dtype
    return out


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """A stored array as a CPU tensor; where ``like`` is a tensor, in its
    dtype and on its device (kept on the CPU for a meta ``like``), and for
    a DTensor ``like`` as a DTensor of its placements (each process keeps
    its slice); a :class:`LayerStack` ``like`` gives one such tensor a
    layer.  A bf16 ``like`` reads the stored 16 bits as bf16."""
    if isinstance(like, LayerStack):
        if len(arr) != len(like):
            raise ValueError(f"checkpoint array of {len(arr)} layers does "
                             f"not fit {len(like)}")
        return LayerStack(_to_tensor(a, t) for a, t in zip(arr, like))
    if isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16:
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        # a scalar goes to disk as shape (1,) (the format's contiguous copy
        # of a 0-d array, in both packages)
        if t.numel() != like.numel() or (t.dim() and like.dim()
                                         and t.shape != like.shape):
            raise ValueError(f"checkpoint array of shape {tuple(t.shape)} "
                             f"does not fit {tuple(like.shape)}")
        t = t.reshape(like.shape)
        dev = "cpu" if like.device.type == "meta" else like.device
        t = t.to(device=dev, dtype=like.dtype)
        if hasattr(like, "placements"):
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, like.device_mesh, like.placements,
                                  src_data_rank=None)
    return t


def _unflatten_into(tree: Any, flat: dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
        return type(tree)(vals)
    return _to_tensor(flat[prefix[:-1]], tree)


def _write_step_dir(ckpt_dir: str, step: int, flat: dict,
                    names: dict) -> str:
    """The array file inside a tmp dir, then an atomic dir rename."""
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    fmt.write_array_file(os.path.join(tmp, "arrays.bin"), flat,
                         meta={"step": step, "keys": sorted(flat)},
                         dtype_names=names)
    os.replace(tmp, final)
    fmt.fsync_dir(ckpt_dir)
    return final


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_checkpoint(ckpt_dir: str, step: int, state: dict) -> str:
    """Atomic: write <dir>/tmp-<step>, fsync, rename to <dir>/step-<step>.
    In a process group every process calls it (DTensors are gathered), rank
    0 writes, and all return once the step is on disk."""
    names: dict[str, str] = {}
    flat = _flatten(state, names=names, keep=writes())
    final = os.path.join(ckpt_dir, f"step-{step:08d}")
    if writes():
        os.makedirs(ckpt_dir, exist_ok=True)
        final = _write_step_dir(ckpt_dir, step, flat, names)
    _barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step-")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, state_like: dict,
                       step: int | None = None) -> tuple[dict, int]:
    """Restore by name into a tree shaped like ``state_like``: tensor leaves
    come back in their dtype and on their device (meta tensors give CPU
    tensors), other leaves as CPU tensors of the stored dtype."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step-{step:08d}")
    flat, _ = fmt.read_array_file(os.path.join(path, "arrays.bin"))
    return _unflatten_into(state_like, flat), step


class CheckpointManager:
    """Cadence + retention + async save.  In a process group every process
    calls :meth:`maybe_save` alike (DTensors are gathered) and rank 0
    writes; :meth:`wait` returns on every process once its save is on
    disk."""

    def __init__(self, ckpt_dir: str, *, every_steps: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.every_steps = every_steps
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._last: int | None = None

    def maybe_save(self, step: int, state: dict | Callable[[], dict], *,
                   force: bool = False):
        """Save at the cadence (or when ``force``).  ``state`` may be a
        callable that builds the state, called only when a save is due."""
        if not force and (step == 0 or step % self.every_steps):
            return
        if step == self._last:
            return                        # already saved (force after cadence)
        self._last = step                 # decided alike on every process
        self.wait()                       # one in-flight save at a time
        done = os.path.exists(os.path.join(self.ckpt_dir, f"step-{step:08d}"))
        if done and not dist.is_initialized():
            return                        # saved by an earlier run
        names: dict[str, str] = {}
        snapshot = _flatten(state() if callable(state) else state,
                            names=names, keep=writes() and not done)
        if done or not writes():          # device -> host before returning
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)

        def _write():
            _write_step_dir(self.ckpt_dir, step, snapshot, names)
            self._gc()

        def _write_async():
            try:
                _write()
            except Exception as e:        # re-raised by wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write_async, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        """Join the in-flight save; re-raise its error, if it failed.  In a
        process group every process waits for rank 0's write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        _barrier()

    def _gc(self):
        steps = sorted(int(d.split("-")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step-"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step-{s:08d}"),
                          ignore_errors=True)
