"""AdamW with warmup + cosine schedule, global-norm clipping, bias
correction and decoupled weight decay; optional bf16 moments and int8
gradient compression.

The port's twin of ``repro.optim.adamw``, in plain torch (the reference has
no kernel here).  Parameters, gradients and moments are dicts of tensors
keyed alike (a :class:`repro_torch.models.model.Model`'s
``named_parameters()``, or the reference's flat names).  Unlike the
reference's pure function, :func:`apply_updates` updates parameters and
moments in place, tensor by tensor, and consumes the gradients (their
buffers are reused as scratch): the transient memory is about one tensor's,
not the model's (the 152064 x 3584 embedding alone is 2.2 GB in fp32).

On a device mesh (DTensor parameters and gradients of equal placements,
as the train step leaves them) the moments take the parameters'
placements, each process updates its own shards, and the global norm and
the int8 scale reduce over every shard of a tensor (DTensor's
``vector_norm``, gathered whole), not over one process's.

  * ``moment_dtype="bfloat16"`` halves optimizer-state memory; the update
    runs in fp32 and rounds the moments back once.
  * ``grad_compression="int8"`` models the numerics of per-tensor symmetric
    int8 gradients (quantize, dequantize) before the update.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"        # float32 | bfloat16
    grad_compression: str = "none"       # none | int8


def _moment_dtype(cfg: OptimConfig) -> torch.dtype:
    if cfg.moment_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"moment_dtype must be float32 or bfloat16, got "
                         f"{cfg.moment_dtype!r}")
    return getattr(torch, cfg.moment_dtype)


def learning_rate(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr_ratio``
    of it at ``decay_steps``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _named(params) -> dict[str, torch.Tensor]:
    return (dict(params.named_parameters())
            if isinstance(params, torch.nn.Module) else dict(params))


def init_opt_state(params, cfg: OptimConfig) -> dict:
    """Zero moments like ``params`` (a Model or a dict of tensors) in the
    moment dtype (DTensors placed as their parameters on a device mesh),
    and step 0 (an int32 scalar on their device)."""
    named = _named(params)
    dt = _moment_dtype(cfg)
    dev = next(iter(named.values())).device
    zeros = {k: torch.zeros_like(p, dtype=dt, requires_grad=False)
             for k, p in named.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(params, cfg: OptimConfig) -> dict:
    """:func:`init_opt_state`'s shapes and dtypes on the meta device."""
    dt = _moment_dtype(cfg)
    meta = {k: torch.empty(p.shape, dtype=dt, device="meta")
            for k, p in _named(params).items()}
    return {"m": meta, "v": dict(meta),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _local(t: torch.Tensor) -> torch.Tensor:
    """This process's shard of a DTensor (its storage, under no_grad), or
    ``t`` itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def _norm(t: torch.Tensor, ord=2) -> torch.Tensor:
    """``t``'s vector norm over the whole tensor: a DTensor's over all its
    shards (gathered whole), a plain scalar tensor either way."""
    n = torch.linalg.vector_norm(t, ord=ord)
    return n.full_tensor() if hasattr(n, "full_tensor") else n


def _compress_int8(g: torch.Tensor) -> None:
    """Symmetric per-tensor int8 quantize/dequantize, in place.  After the
    clamp the values are the int8 codes exactly, so they are scaled back
    without a round trip through an int8 tensor.  The scale is the whole
    tensor's largest magnitude, across shards."""
    scale = torch.clamp(_norm(g, float("inf")), min=1e-12) / 127.0
    _local(g).div_(scale).round_().clamp_(-127, 127).mul_(scale)


def _update(p, g, m, v, *, scale, lr, b1c, b2c, cfg: OptimConfig) -> None:
    """One tensor's AdamW update, in place, in the reference's order of
    operations; ``g`` (fp32, owned) is used as scratch."""
    g.mul_(scale)
    m32 = m if m.dtype == torch.float32 else m.float()
    v32 = v if v.dtype == torch.float32 else v.float()
    t = g * (1 - cfg.b1)
    m32.mul_(cfg.b1).add_(t)
    torch.mul(g, 1 - cfg.b2, out=t).mul_(g)
    v32.mul_(cfg.b2).add_(t)
    den = torch.div(v32, b2c, out=g).sqrt_().add_(cfg.eps)    # g consumed
    torch.div(m32, b1c, out=t).div_(den)                      # mhat / den
    p32 = p if p.dtype == torch.float32 else p.float()
    t.add_(torch.mul(p32, cfg.weight_decay, out=den))         # + wd * p
    p32.sub_(t.mul_(lr))
    if p32 is not p:
        p.copy_(p32)
    if m32 is not m:
        m.copy_(m32)
        v.copy_(v32)


def apply_updates(params, grads: dict, state: dict, cfg: OptimConfig
                  ) -> tuple[dict, dict, dict]:
    """One AdamW step over ``params`` (a Model or a dict of tensors) with
    ``grads`` (a dict keyed alike).  Updates parameters and moments in
    place and consumes the gradients.  Returns (params, state, metrics)
    with metrics ``grad_norm`` (after compression, before clipping) and
    ``lr``."""
    if cfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression must be none or int8, got "
                         f"{cfg.grad_compression!r}")
    named = _named(params)
    keys = sorted(named)
    with torch.no_grad():
        grads = {k: grads[k].float() for k in keys}
        if cfg.grad_compression == "int8":
            for k in keys:
                _compress_int8(grads[k])
        gnorm = torch.sqrt(sum(_norm(grads[k]).square() for k in keys))
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        step = state["step"] + 1
        lr = learning_rate(cfg, step)
        stepf = step.float()
        b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
        b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
        for k in keys:
            _update(_local(named[k]), _local(grads.pop(k)),
                    _local(state["m"][k]), _local(state["v"][k]),
                    scale=scale, lr=lr, b1c=b1c, b2c=b2c, cfg=cfg)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
