"""Fault-tolerant training loop: bitmap-indexed data, checkpoint cadence,
crash-safe restart.

The port's twin of ``repro.train.loop``: the single-card driver behind
``examples/train_lm_torch.py`` and ``repro_torch.launch.train``.  The model
trains on ``device`` (the card unless the caller asks for the CPU) with fp32
master weights; checkpoints hold the reference's layout (see
:func:`checkpoint_state`), so either package can resume the other's run.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore_checkpoint)
from repro_torch.engine.policy import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (Model, init_params, stack_layers,
                                      unstack_layers)
from repro_torch.optim.adamw import init_opt_state
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
    copies them to the host)."""
    cfg = params.cfg
    named = {n: p.detach() for n, p in params.named_parameters()}
    return {"params": stack_layers(cfg, named),
            "opt": {"m": stack_layers(cfg, opt["m"]),
                    "v": stack_layers(cfg, opt["v"]),
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


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, lcfg: LoopConfig,
               batches: Callable[[int], Iterator[dict]], *, seed: int = 0,
               log=print, device="cuda") -> dict:
    """Runs to ``total_steps`` with checkpoint/restart.  ``batches(start)``
    must return a deterministic stream starting at ``start`` (the data
    pipeline replays from the checkpointed step — see data/pipeline.py)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev, dtype=torch.float32)
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
        batch = next(it)
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
