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

A q that reaches the wrappers split by sequence over ``model`` (the
model's ``ulysses_attn``: ("batch", "seq_sp") with every head whole) runs
the Ulysses way instead: each process takes its batch rows and its slice
of the queries, every head, against k and v whole over ``model``, and
under ``causal`` passes the kernels ``q_offset`` = its index over
``model`` x the local Sq (added to the caller's), the absolute position of
its first query, so that the causal and window masks are the unsplit
ones.  Keys past a process's last query get exactly zero dK and dV from
it, and each process's dK and dV are partial sums over ``model``, which
``local_map``'s ``in_grad_placements`` reduce onto k's and v's placements.
Where the sequence does not divide ``model`` the model's constraint leaves
it whole, and the heads route above runs at offset 0.
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
    def forward(q_, k_, v_, offset=0):
        return attention.flash_attention_fwd(
            q_.contiguous(), k_.contiguous(), v_.contiguous(), causal=causal,
            window=window, q_offset=q_offset + offset, kv_len=kv_len)
    if hasattr(q, "device_mesh"):
        return _on_shards(forward, q, k, v, causal)
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


def _seq_axes(q: torch.Tensor) -> list:
    """The axes of q's mesh that split q's sequence (dimension 1): those of
    the Ulysses layout (``seq_sp`` on ``model``), empty otherwise."""
    return [a for a, p in zip(q.device_mesh.mesh_dim_names, q.placements)
            if p.is_shard(1)]


def _ulysses_placements(q: torch.Tensor) -> tuple:
    """(q's, k's and v's, k's and v's gradients') placements for a q that
    reaches the wrapper split by sequence (the Ulysses layout): q by batch
    and by sequence as it is, k and v by batch only, whole over the
    sequence's axes, where each process's gradient of them is a partial
    sum (its own queries' share); every head and ``head_dim`` whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pq = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
          for p in q.placements]
    pk = [Shard(0) if p.is_shard(0) else Replicate() for p in pq]
    gk = [Partial() if p.is_shard(1) else r for p, r in zip(pq, pk)]
    return pq, pk, gk


def _seq_offset(q: torch.Tensor, local_sq: int) -> int:
    """The absolute position of this process's first query in q split by
    sequence: its index over the sequence's axes (outer first, as DTensor
    splits) times the local Sq."""
    mesh = q.device_mesh
    index = 0
    for a in _seq_axes(q):
        index = index * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return index * local_sq


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


def _on_shards(fn, q, k, v, causal: bool):
    """``fn(q, k, v[, offset])`` of local tensors on each process's shard
    of DTensor q, k, v; the output is placed as q.  A q split by sequence
    (the Ulysses layout) runs against k and v whole over the sequence's
    axes (:func:`_ulysses_placements`), at ``offset`` its first query's
    absolute position under ``causal`` (0 for bidirectional attention,
    which no offset moves); any other q is placed by
    :func:`_local_placements`, at offset 0."""
    from torch.distributed.tensor.experimental import local_map
    if _seq_axes(q):
        pq, pk, gk = _ulysses_placements(q)

        def shard(q_, k_, v_):
            return fn(q_, k_, v_, _seq_offset(q, q_.shape[1]) if causal
                      else 0)
        return local_map(shard, out_placements=pq, in_placements=(pq, pk, pk),
                         in_grad_placements=(pq, gk, gk),
                         device_mesh=q.device_mesh,
                         redistribute_inputs=True)(q, k, v)
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
    def vjp(q_, k_, v_, offset=0):
        return _FlashVJP.apply(q_, k_, v_, causal, window, q_offset + offset,
                               kv_len)
    if hasattr(q, "device_mesh"):
        return _on_shards(vjp, q, k, v, causal)
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
