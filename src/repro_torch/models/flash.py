"""Flash attention for the model, in the model's layout: the prefill forward
and the training route with its gradient.

The port's twin of ``repro.models.flash.flash_attention_vjp``: causal or full
online-softmax attention, q (B, Sq, H, hd), k/v (B, Skv, KV, hd), query head
h reading KV head h // (H // KV), under the reference's mask: a sliding
``window``, a ``q_offset`` and a ``kv_len``.  :func:`flash_attention` is the
forward alone (prefill, no autograd); :func:`flash_attention_vjp` is a
``torch.autograd.Function`` whose forward launches the forward kernel
(``repro_torch.kernels.attention.flash_attention_fwd`` with its lse) and
saves only (q, k, v, out, lse), and whose backward launches the backward
kernel (``flash_attention_bwd``), which recomputes each probability block
from those, as the reference's custom VJP does.  On CPU tensors the kernel
wrappers run their plain versions; on CUDA tensors they launch the kernels
or raise.

On a device mesh (q, k and v DTensors) :func:`flash_attention` (serving)
and :func:`flash_attention_vjp` (training) run the forward kernel, and the
same ``torch.autograd.Function``, on each process's local shard through
``local_map``: the batch over the data axes and the heads over ``model``
where both the query and the KV heads divide it (so that a GQA group stays
on one process), else whole; ``head_dim`` always whole, as the kernels need
it.  q, k and v are redistributed to that first (a ``logical_spec`` that
put ``head_dim`` on ``model``, as Qwen2-7B's 28 heads on 16, is gathered).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window=None, q_offset: int = 0, kv_len=None
                    ) -> torch.Tensor:
    """Attention forward, q (B, Sq, H, hd) against k/v (B, Skv, KV, hd):
    ``window`` (None is the reference's ``WINDOW_INF``, unbounded),
    ``q_offset`` (the absolute position of q[0]) and ``kv_len`` (valid keys,
    None for Skv) mask as the reference's ``_block_ok``, the window and
    offset under ``causal`` only.  DTensor q, k, v (a device mesh) run the
    kernel on each process's shard (:func:`_on_shards`)."""
    def forward(q_, k_, v_):
        return attention.flash_attention_fwd(
            q_.contiguous(), k_.contiguous(), v_.contiguous(), causal=causal,
            window=window, q_offset=q_offset, kv_len=kv_len)
    if hasattr(q, "device_mesh"):
        return _on_shards(forward, q, k, v)
    return forward(q, k, v)


class _FlashVJP(torch.autograd.Function):
    """Forward kernel with lse; backward kernel from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window, q_offset: int, kv_len):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        mask = {"window": window, "q_offset": q_offset, "kv_len": kv_len}
        out, lse = attention.flash_attention_fwd(q, k, v, causal=causal,
                                                 return_lse=True, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.mask = causal, mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention.flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            **ctx.mask)
        return dq, dk, dv, None, None, None, None


def _local_placements(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """(q's, k's and v's) placements for the kernels on q's device mesh:
    the batch as the ``batch`` rule shards it, the heads over ``model``
    when both head counts divide it, else whole; ``head_dim`` whole."""
    from repro_torch.launch.mesh import as_mesh
    from repro_torch.parallel.sharding import mesh_placements
    mesh = as_mesh(q.device_mesh)
    pq = mesh_placements(q.shape, ("batch", None, "heads", None), mesh)
    pk = mesh_placements(k.shape, ("batch", None, "kv_heads", None), mesh)
    if pq != pk:                        # a GQA group would span processes
        pq = pk = mesh_placements(q.shape, ("batch",), mesh)
    return pq, pk


def _on_shards(fn, q, k, v):
    """``fn(q, k, v)`` of local tensors on each process's shard of DTensor
    q, k, v, placed by :func:`_local_placements`; the output is placed as
    q."""
    from torch.distributed.tensor.experimental import local_map
    pq, pk = _local_placements(q, k)
    return local_map(fn, out_placements=pq, in_placements=(pq, pk, pk),
                     device_mesh=q.device_mesh, redistribute_inputs=True)(
        q, k, v)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window=None, q_offset: int = 0,
                        kv_len=None, q_chunk: int = 512, kv_chunk: int = 1024,
                        block_skip: bool = False) -> torch.Tensor:
    """Differentiable flash attention, memory-bounded in both passes (the
    reference's signature; the mask arguments as :func:`flash_attention`'s).
    ``q_chunk``/``kv_chunk`` are the reference's chunk sizes and
    ``block_skip`` its causal chunk skipping: checked, not used (the
    kernels tile 64 or 128 queries by 32 to 128 keys and always skip the
    tiles above the causal diagonal and below the window, which the
    reference proves gives the dense route's numbers)."""
    if q_chunk <= 0 or kv_chunk <= 0:
        raise ValueError("flash_attention_vjp: q_chunk/kv_chunk must be "
                         "positive")
    if block_skip and not causal:
        raise ValueError("flash_attention_vjp: block_skip needs causal")
    def vjp(q_, k_, v_):
        return _FlashVJP.apply(q_, k_, v_, causal, window, q_offset, kv_len)
    if hasattr(q, "device_mesh"):
        return _on_shards(vjp, q, k, v)
    return vjp(q, k, v)


class FlashAttention(nn.Module):
    """Flash attention as a module without parameters, so a forward hook can
    see one layer's q, k and v (and its output; a hook registered
    ``with_kwargs=True`` also sees the layer's ``window``):
    :func:`flash_attention` for serving, :func:`flash_attention_vjp` with
    ``train=True``."""

    def forward(self, q, k, v, *, causal: bool = True, train: bool = False,
                window=None, **vjp_options):
        if train:
            return flash_attention_vjp(q, k, v, causal=causal, window=window,
                                       **vjp_options)
        return flash_attention(q, k, v, causal=causal, window=window)
