"""Flash attention for the model's prefill, in the model's layout.

The port's twin of the forward of ``repro.models.flash.flash_attention_vjp``:
causal or full online-softmax attention, q (B, S, H, hd), k/v (B, S, KV, hd).
On CUDA tensors it launches the hand-written kernel
(``repro_torch.kernels.attention.flash_attention_fwd``), reading each query
head's KV head directly; on CPU tensors the kernel wrapper runs its plain
version.  The custom-VJP backward waits for the training slice, where it
becomes a ``torch.autograd.Function`` (ROADMAP A10).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window=None, q_offset=0, kv_len=None
                    ) -> torch.Tensor:
    """Attention forward over one sequence length.  ``window``, a non-zero
    ``q_offset`` and ``kv_len`` (sliding windows, chunked prefill, padded
    caches) are not ported: the TPU kernel takes none of them."""
    if window is not None or kv_len is not None or q_offset != 0:
        raise NotImplementedError(
            "flash attention with a window, q_offset or kv_len is not "
            "ported yet (ROADMAP A10)")
    if k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            "flash attention over a kv length other than q's (cross "
            "attention) is not ported yet (ROADMAP A10)")
    return attention.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal=causal)


class FlashAttention(nn.Module):
    """:func:`flash_attention` as a module without parameters, so a forward
    hook can see one layer's q, k and v."""

    def forward(self, q, k, v, *, causal: bool = True):
        return flash_attention(q, k, v, causal=causal)
