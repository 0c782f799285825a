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
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.store import format as fmt


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """(host array, stored dtype name or None) of one leaf; a bf16 tensor
    becomes its uint16 bits stored as ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def _flatten(tree: Any, prefix: str = "", names: dict | None = None
             ) -> dict[str, np.ndarray]:
    """"/"-joined names -> host arrays (device -> host copies happen here);
    ``names`` collects stored dtype names that differ from numpy's."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", names))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", names))
    else:
        arr, dtype = _to_numpy(tree)
        out[prefix[:-1]] = arr
        if dtype is not None and names is not None:
            names[prefix[:-1]] = dtype
    return out


def _to_tensor(arr: np.ndarray, like) -> torch.Tensor:
    """A stored array as a CPU tensor; where ``like`` is a tensor, in its
    dtype and on its device (kept on the CPU for a meta ``like``).  A bf16
    ``like`` reads the stored 16 bits as bf16."""
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


def save_checkpoint(ckpt_dir: str, step: int, state: dict) -> str:
    """Atomic: write <dir>/tmp-<step>, fsync, rename to <dir>/step-<step>."""
    os.makedirs(ckpt_dir, exist_ok=True)
    names: dict[str, str] = {}
    flat = _flatten(state, names=names)
    return _write_step_dir(ckpt_dir, step, flat, names)


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
    """Cadence + retention + async save."""

    def __init__(self, ckpt_dir: str, *, every_steps: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.ckpt_dir = ckpt_dir
        self.every_steps = every_steps
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def maybe_save(self, step: int, state: dict | Callable[[], dict], *,
                   force: bool = False):
        """Save at the cadence (or when ``force``).  ``state`` may be a
        callable that builds the state, called only when a save is due."""
        if not force and (step == 0 or step % self.every_steps):
            return
        self.wait()                       # one in-flight save at a time
        if os.path.exists(os.path.join(self.ckpt_dir, f"step-{step:08d}")):
            return                        # already saved (force after cadence)
        names: dict[str, str] = {}
        snapshot = _flatten(state() if callable(state) else state,
                            names=names)  # device -> host before returning
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
        """Join the in-flight save; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(int(d.split("-")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step-"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step-{s:08d}"),
                          ignore_errors=True)
