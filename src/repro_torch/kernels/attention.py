"""Flash-attention forward: the ``flash_attention_fwd`` CUDA kernel
(``csrc/attention.cu``) and its plain-torch version.

Online-softmax attention, causal or full, scale 1/sqrt(hd), fp32
accumulation, output in q's dtype.  Two layouts, one entry point:

* the model's: q (B, S, H, hd), k/v (B, S, KV, hd) with H % KV == 0; query
  head h reads KV head h // (H // KV), with no broadcast copy;
* the reference kernel's: q/k/v (BH, S, hd), KV heads pre-broadcast (the
  model layout with H = KV = 1).

On the card the C entry point picks one of two hand-written kernels by type
and shape: bf16 at head_dim 64 or 128 (every full config the port serves)
runs on the tensor cores (``flash_fwd_wgmma``: wgmma tiles fed by TMA
copies, P carried as a bf16 hi + lo pair); fp32 inputs and the other head
dims run on the CUDA cores (``flash_fwd_kernel``: fp32 FMAs, which keep
fp32 within the reference test's atol of 2e-5).

Replaces ``src/repro/kernels/attention.py::flash_attention_fwd``; the source
note in the ``.cu`` file gives the kernels' bound and design.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * torch.finfo(torch.float32).max
#: head dims the kernel is instantiated for (every config's head_dim)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _model_layout(q, k, v):
    """(q, k, v) as 4-D model-layout views, and whether they were 3-D."""
    if q.dim() == 3:
        return q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), True
    return q, k, v, False


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """The plain-torch version: per query head, fp32
    ``softmax(q k^T * scale + mask) v``, the mask at ``NEG_INF``."""
    q4, k4, v4, flat = _model_layout(q, k, v)
    B, S, H, hd = q4.shape
    g = H // k4.shape[2]
    scale = 1.0 / math.sqrt(hd)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    for h in range(H):
        qh = q4[:, :, h].float() * scale
        s = qh @ k4[:, :, h // g].float().transpose(1, 2)
        p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
        out[:, :, h] = (p @ v4[:, :, h // g].float()).to(q.dtype)
    return out[:, :, 0] if flat else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, block_q: int = 256,
                        block_k: int = 256) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; run the plain version on CPU
    tensors.  Takes q/k/v of one dtype (fp32 or bf16), either (BH, S, hd)
    each or q (B, S, H, hd) with k/v (B, S, KV, hd); on the card they must be
    contiguous and 16-byte aligned, with hd in :data:`HEAD_DIMS`.
    ``block_q``/``block_k`` are the reference kernel's tile sizes: checked,
    not used (the kernels tile 128 queries by 128 keys on the tensor cores,
    64 queries by 32 or 64 keys on the CUDA cores)."""
    name = "flash_attention_fwd"
    card = _build.on_card(name, q, k, v)
    _build.require(name, q.dtype in DTYPES and k.dtype == q.dtype
                   and v.dtype == q.dtype,
                   f"q/k/v must share one dtype of {DTYPES}, got "
                   f"{q.dtype}, {k.dtype}, {v.dtype}")
    _build.require(name, block_q > 0 and block_k > 0,
                   "block_q/block_k must be positive")
    _build.require(name, q.dim() in (3, 4) and k.dim() == q.dim()
                   and k.shape == v.shape,
                   f"want q/k/v (BH, S, hd) or q (B, S, H, hd) with k/v "
                   f"(B, S, KV, hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                   f"{tuple(v.shape)}")
    q4, k4, v4, _ = _model_layout(q, k, v)
    B, S, H, hd = q4.shape
    KV = k4.shape[2]
    _build.require(name, k4.shape[:2] == (B, S) and k4.shape[3] == hd
                   and KV >= 1 and H % KV == 0,
                   f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not card:
        return flash_attention_fwd_plain(q, k, v, causal=causal)
    _build.require(name, hd in HEAD_DIMS,
                   f"head_dim {hd} not in {HEAD_DIMS}")
    _build.require(name, q.is_contiguous() and k.is_contiguous()
                   and v.is_contiguous(), "q/k/v must be contiguous")
    _build.require(name, all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                   "q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _build.library(name)
    _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                    _build.ptr(out), B, S, H, KV, hd, int(causal),
                    int(q.dtype == torch.bfloat16),
                    _build.stream(q.device)), name)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
