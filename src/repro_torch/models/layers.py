"""Transformer building blocks: norms, rotary embeddings, gated MLPs and
single-position decode attention.

The port's twin of ``repro.models.layers``.  Prefill attention goes through
the flash kernel (``repro_torch.models.flash``); decode attention stays plain
torch, as the reference computes it in plain jnp outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in fp32 with a ``(1 + scale)`` gain, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


# -------------------------------------------------------------------- rope
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: tuple[int, ...] | None = None
                ) -> torch.Tensor:
    """positions (B, S) -> angles (B, S, hd/2) fp32, plain RoPE."""
    if positions.dim() != 2:
        raise NotImplementedError(
            "M-RoPE positions (3, B, S) are not ported yet (ROADMAP A10)")
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device)
                                / half))
    return positions[..., None].float() * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd), angles (B, S, hd/2): rotate-half, in fp32."""
    dt = x.dtype
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# --------------------------------------------------------------------- mlp
def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Gated (silu/geglu) or plain (gelu) MLP.  Weights: w_in/w_gate
    (d, f), w_out (f, d), used in x's dtype."""
    h = x @ p["w_in"].to(x.dtype)
    if act in ("silu", "geglu"):
        g = x @ p["w_gate"].to(x.dtype)
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        h = g * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"].to(x.dtype)


# --------------------------------------------------------------- attention
class AttnMask(NamedTuple):
    """Static attention-mask description."""
    causal: bool
    window: int | None          # sliding window size (None = unbounded)
    q_offset: int               # absolute position of q[0] (decode: pos)
    kv_len: int | None          # valid kv length (decode: pos + 1)


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, m: AttnMask
                ) -> torch.Tensor:
    """(Sq, Sk) bool — True where attention is allowed."""
    q_abs = q_pos + m.q_offset
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=k_pos.device)
    if m.causal:
        ok &= k_pos[None, :] <= q_abs[:, None]
    if m.window is not None:
        ok &= k_pos[None, :] > (q_abs[:, None] - m.window)
    if m.kv_len is not None:
        ok &= k_pos[None, :] < m.kv_len
    return ok


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, mask: AttnMask) -> torch.Tensor:
    """Single-position attention against a (possibly padded) KV cache.

    q: (B, 1, H, hd); caches: (B, Smax, KV, hd)."""
    B, _, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    groups = H // KV
    scale = 1.0 / math.sqrt(hd)
    qv = (q.float() * scale).reshape(B, KV, groups, hd)
    s = torch.einsum("bkgh,bckh->bkgc", qv, k_cache.float())
    k_pos = torch.arange(Smax, device=q.device)
    ok = _block_mask(torch.zeros((1,), dtype=torch.long, device=q.device),
                     k_pos, mask)[0]
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(k_cache.dtype)
