"""Fault-tolerant training loop: bitmap-indexed data, checkpoint cadence,
crash-safe restart.

The port's twin of ``repro.train.loop``: the loop behind
``examples/train_lm_torch.py`` and ``repro_torch.launch.train``.  The model
trains on ``device`` (the card unless the caller asks for the CPU) with fp32
master weights, or with ``mesh`` (a ``repro_torch.launch.mesh.DistMesh``)
on every process of the mesh: the parameters and the optimizer state as
DTensors placed by the model's logical axes, each batch split by rows over
the data axes (every process reads the same deterministic stream and keeps
its rows); rank 0 logs and writes the checkpoints.  Checkpoints hold the
reference's layout (see :func:`checkpoint_state`), so either package can
resume the other's run, on any mesh.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.store import (CheckpointManager, LayerStack,
                                          latest_step, restore_checkpoint,
                                          writes)
from repro_torch.launch.mesh import DistMesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (Model, init_params, stack_layers,
                                      unstack_layers)
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel.sharding import distribute
from repro_torch.train.step import TrainConfig, make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 300
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    log_every: int = 10


def checkpoint_state(params: Model, opt: dict) -> dict:
    """The training state in the reference's checkpoint layout:
    ``{"params": <flat names, stacked>, "opt": {"m": ..., "v": ...,
    "step": int32}}`` (tensors on the model's device; the checkpoint store
    copies them to the host).  For a model on a mesh each per-layer key is
    a ``LayerStack``: the store gathers and stacks it on the host a layer
    at a time, so no second copy of the state is made on the devices."""
    cfg = params.cfg
    stack = torch.stack if params.mesh is None else LayerStack
    named = {n: p.detach() for n, p in params.named_parameters()}
    return {"params": stack_layers(cfg, named, stack),
            "opt": {"m": stack_layers(cfg, opt["m"], stack),
                    "v": stack_layers(cfg, opt["v"], stack),
                    "step": opt["step"]}}


def load_checkpoint_state(params: Model, opt: dict, state: dict) -> None:
    """Copy a restored :func:`checkpoint_state` into ``params`` and ``opt``
    in place (the parameters keep their identity)."""
    cfg = params.cfg
    with torch.no_grad():
        named = dict(params.named_parameters())
        for name, t in unstack_layers(cfg, state["params"]).items():
            named[name].copy_(t)
        for mom in ("m", "v"):
            for name, t in unstack_layers(cfg, state["opt"][mom]).items():
                opt[mom][name].copy_(t)
        opt["step"] = state["opt"]["step"].to(opt["step"].device)


def distribute_batch(batch: dict, mesh) -> dict:
    """A batch that every process of ``mesh`` read whole and alike, split
    by rows over the data axes (``mrope_positions`` by its axis 1); the
    batch itself off a ``DistMesh``."""
    if not isinstance(mesh, DistMesh):
        return batch
    return {k: distribute(torch.as_tensor(x).to(mesh.device),
                          (None, "batch") if k == "mrope_positions"
                          else ("batch",), mesh)
            for k, x in batch.items()}


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, lcfg: LoopConfig,
               batches: Callable[[int], Iterator[dict]], *, seed: int = 0,
               log=print, device="cuda", mesh=None) -> dict:
    """Runs to ``total_steps`` with checkpoint/restart.  ``batches(start)``
    must return a deterministic stream starting at ``start`` (the data
    pipeline replays from the checkpointed step — see data/pipeline.py).
    With ``mesh`` (a ``DistMesh``) every process of it calls this alike;
    the model lives on the mesh's devices and only rank 0 logs."""
    if not writes():
        def log(*_args, **_kwargs):
            return None
    params = init_params(cfg, seed=seed, device=device, dtype=torch.float32,
                         mesh=mesh)
    opt = init_opt_state(params, tcfg.optim)
    start = 0

    if latest_step(lcfg.ckpt_dir) is not None:
        restored, start = restore_checkpoint(lcfg.ckpt_dir,
                                             checkpoint_state(params, opt))
        load_checkpoint_state(params, opt, restored)
        log(f"[restart] resumed from step {start}")

    step_fn = make_train_step(cfg, tcfg)
    mgr = CheckpointManager(lcfg.ckpt_dir, every_steps=lcfg.ckpt_every)
    it = batches(start)
    t0 = time.time()
    metrics = {}
    for step in range(start + 1, lcfg.total_steps + 1):
        batch = distribute_batch(next(it), mesh)
        params, opt, metrics = step_fn(params, opt, batch)
        if step % lcfg.log_every == 0 or step == lcfg.total_steps:
            dt = time.time() - t0
            log(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.2f} "
                f"({dt / max(step - start, 1):.2f}s/step)")
        mgr.maybe_save(step, lambda: checkpoint_state(params, opt))
    mgr.maybe_save(lcfg.total_steps, lambda: checkpoint_state(params, opt),
                   force=True)
    mgr.wait()
    return {"params": params, "opt": opt,
            "final_loss": float(metrics.get("loss", float("nan")))}
