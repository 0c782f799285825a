"""The training step: loss and gradients through autograd, the AdamW
update, optional gradient accumulation over microbatches.

The port's twin of ``repro.train.step``.  ``train_step(params, opt_state,
batch)`` updates the :class:`repro_torch.models.model.Model` and the
optimizer state in place and returns them with the step's metrics.  On a
device mesh (DTensor parameters) each gradient is pinned to its
parameter's placements before the update, as the reference's
``shard_grads``: autograd leaves some as partial sums (the embedding's
scatter, the FSDP products), which this reduces onto their shards.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import full_tensor, lm_loss
from repro_torch.optim.adamw import OptimConfig, apply_updates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = OptimConfig()
    accum_steps: int = 1          # gradient-accumulation microbatches


def microbatch(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n``: the reference's strided slice (every
    n-th row: rows i, i + n, ...), over axis 1 for ``mrope_positions``;
    a tensor whose axis does not divide by n is passed whole."""
    def take(x, ax):
        if x.dim() < 2 or x.shape[ax] % n:
            return x
        shp = (*x.shape[:ax], x.shape[ax] // n, n, *x.shape[ax + 1:])
        return x.reshape(shp).select(ax + 1, i)
    return {k: take(x, 1 if k == "mrope_positions" else 0)
            for k, x in batch.items()}


def shard_grad(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The reference's ``shard_grads`` for one gradient: on a device mesh
    ``g`` redistributed to its parameter's placements (a partial sum
    reduced onto its shard), else ``g`` itself."""
    if hasattr(p, "placements") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  With ``accum_steps`` n > 1 the batch is cut into n strided
    microbatches whose gradients are summed (one backward at a time, so
    activation memory is one microbatch's) and then divided by n; metrics
    then hold the mean ``loss``, as the reference's."""
    n = tcfg.accum_steps
    if n < 1:
        raise ValueError("accum_steps must be >= 1")

    def train_step(params, opt_state: dict, batch: dict):
        named = dict(params.named_parameters())
        for p in named.values():
            p.requires_grad_(True)
            p.grad = None
        if n > 1:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=params.embed.device)
            for i in range(n):
                loss, _ = lm_loss(params, cfg, microbatch(batch, i, n))
                loss.backward()
                loss_sum = loss_sum + full_tensor(loss.detach())
            metrics = {"loss": loss_sum / n}
        else:
            loss, metrics = lm_loss(params, cfg, batch)
            loss.backward()
            metrics = {k: t.detach() for k, t in metrics.items()}
        grads = {}
        for k, p in named.items():
            g = shard_grad(p.grad if p.grad is not None
                           else torch.zeros_like(p), p)
            grads[k] = g.div_(n) if n > 1 else g
            p.grad = None
        _, opt_state, opt_metrics = apply_updates(named, grads, opt_state,
                                                  tcfg.optim)
        metrics = {k: full_tensor(t) for k, t in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
