"""Flash attention for the model, in the model's layout: the prefill forward
and the training route with its gradient.

The port's twin of ``repro.models.flash.flash_attention_vjp``: causal or full
online-softmax attention, q (B, S, H, hd), k/v (B, S, KV, hd), query head h
reading KV head h // (H // KV).  :func:`flash_attention` is the forward alone
(prefill, no autograd); :func:`flash_attention_vjp` is a
``torch.autograd.Function`` whose forward launches the forward kernel
(``repro_torch.kernels.attention.flash_attention_fwd`` with its lse) and
saves only (q, k, v, out, lse), and whose backward launches the backward
kernel (``flash_attention_bwd``), which recomputes each probability block
from those, as the reference's custom VJP does.  On CPU tensors the kernel
wrappers run their plain versions; on CUDA tensors they launch the kernels
or raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import attention


def _not_ported(q, k, window, q_offset, kv_len) -> None:
    """Raise for the options the kernels do not take yet."""
    if window is not None or kv_len is not None or q_offset != 0:
        raise NotImplementedError(
            "flash attention with a window, q_offset or kv_len is not "
            "ported yet (ROADMAP A10.2)")
    if k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            "flash attention over a kv length other than q's (cross "
            "attention) is not ported yet (ROADMAP A10.3)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window=None, q_offset=0, kv_len=None
                    ) -> torch.Tensor:
    """Attention forward over one sequence length.  ``window``, a non-zero
    ``q_offset`` and ``kv_len`` (sliding windows, chunked prefill, padded
    caches) are not ported: the TPU kernel takes none of them."""
    _not_ported(q, k, window, q_offset, kv_len)
    return attention.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal=causal)


class _FlashVJP(torch.autograd.Function):
    """Forward kernel with lse; backward kernel from (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = attention.flash_attention_fwd(q, k, v, causal=causal,
                                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention.flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window=None, q_offset=0,
                        kv_len=None, q_chunk: int = 512, kv_chunk: int = 1024,
                        block_skip: bool = False) -> torch.Tensor:
    """Differentiable flash attention, memory-bounded in both passes (the
    reference's signature).  ``q_chunk``/``kv_chunk`` are the reference's
    chunk sizes and ``block_skip`` its causal chunk skipping: checked, not
    used (the kernels tile 64 queries by 64 keys and always skip the tiles
    above the causal diagonal, which the reference proves gives the dense
    route's numbers)."""
    _not_ported(q, k, window, q_offset, kv_len)
    if q_chunk <= 0 or kv_chunk <= 0:
        raise ValueError("flash_attention_vjp: q_chunk/kv_chunk must be "
                         "positive")
    if block_skip and not causal:
        raise ValueError("flash_attention_vjp: block_skip needs causal")
    return _FlashVJP.apply(q, k, v, causal)


class FlashAttention(nn.Module):
    """Flash attention as a module without parameters, so a forward hook can
    see one layer's q, k and v (and its output): :func:`flash_attention`
    for serving, :func:`flash_attention_vjp` with ``train=True``."""

    def forward(self, q, k, v, *, causal: bool = True, train: bool = False,
                **vjp_options):
        if train:
            return flash_attention_vjp(q, k, v, causal=causal, **vjp_options)
        return flash_attention(q, k, v, causal=causal)
