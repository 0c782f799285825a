"""Transformer building blocks: norms, rotary embeddings (RoPE and M-RoPE),
gated MLPs and single-position decode attention.

The port's twin of ``repro.models.layers``.  Prefill attention goes through
the flash kernel (``repro_torch.models.flash``); decode attention stays plain
torch, as the reference computes it in plain jnp outside any Pallas kernel.
:func:`cached_decode_attention` writes the new position into the KV caches
in place (the reference returns an updated copy) and attends; on DTensor
caches it runs on each process's shard (``local_map``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import constrain

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
    """positions (B, S) for RoPE or (3, B, S) for M-RoPE -> angles
    (B, S, hd/2) fp32.

    M-RoPE (Qwen2-VL): the hd/2 frequency slots are split into
    ``mrope_sections`` (temporal, height, width); slot i takes its position
    from the stream its section belongs to.  Text tokens carry identical
    streams, so M-RoPE degenerates to RoPE for them."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device)
                                / half))
    if positions.dim() == 2:                      # plain RoPE
        return positions[..., None].float() * inv_freq
    if mrope_sections is None or sum(mrope_sections) != half:
        raise ValueError(f"M-RoPE positions {tuple(positions.shape)} need "
                         f"mrope_sections summing to {half}, got "
                         f"{mrope_sections}")
    stream_of_slot = torch.repeat_interleave(
        torch.arange(len(mrope_sections), device=positions.device),
        torch.tensor(mrope_sections, device=positions.device),
        output_size=half)                                    # (half,)
    pos = positions[stream_of_slot]                          # (half, B, S)
    return pos.movedim(0, -1).float() * inv_freq


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
    (d, f), w_out (f, d), used in x's dtype; the hidden (B, S, f) held to
    the reference's ("batch", None, "mlp") sharding."""
    h = x @ p["w_in"].to(x.dtype)
    if act in ("silu", "geglu"):
        g = x @ p["w_gate"].to(x.dtype)
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        h = g * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, ("batch", None, "mlp"))
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


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, scale: float
                  ) -> torch.Tensor:
    """q (B, 1, H, hd) against the cache (B, Smax, KV, hd): the scaled
    scores (B, KV, H // KV, Smax) in fp32, unmasked."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qv = (q.float() * scale).reshape(B, KV, H // KV, hd)
    return torch.einsum("bkgh,bckh->bkgc", qv, k_cache.float())


def decode_values(s: torch.Tensor, v_cache: torch.Tensor, mask: AttnMask
                  ) -> torch.Tensor:
    """Scores (B, KV, G, Smax) masked by ``mask`` and softmaxed, against
    the cache (B, Smax, KV, hd): the output (B, 1, KV * G, hd) in the
    cache's dtype."""
    B, KV, G, Smax = s.shape
    k_pos = torch.arange(Smax, device=s.device)
    ok = _block_mask(torch.zeros((1,), dtype=torch.long, device=s.device),
                     k_pos, mask)[0]
    p = torch.softmax(torch.where(ok[None, None, None, :], s, NEG_INF),
                      dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, KV * G, v_cache.shape[-1]).to(v_cache.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, mask: AttnMask) -> torch.Tensor:
    """Single-position attention against a (possibly padded) KV cache.

    q: (B, 1, H, hd); caches: (B, Smax, KV, hd)."""
    return decode_values(decode_scores(q, k_cache,
                                       1.0 / math.sqrt(q.shape[-1])),
                         v_cache, mask)


def write_cache(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``new`` (B, n, KV, hd) into ``cache`` (B, Smax, KV, hd) at positions
    ``start`` .. ``start + n``, in place, in the cache's dtype; a DTensor
    cache takes ``new`` at its own placements, each process writing its
    shard."""
    if hasattr(cache, "device_mesh"):
        new = new.redistribute(cache.device_mesh, cache.placements).to_local()
        cache = cache.to_local()
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)


def cached_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, mask: AttnMask
                            ) -> torch.Tensor:
    """One decode step's attention: the new position's k/v (B, 1, KV, hd)
    written into the caches (B, Smax, KV, hd) at ``mask.q_offset``, in
    place, then :func:`decode_attention` of q (B, 1, H, hd) against them.
    With k and v None nothing is written (an encoder-decoder's
    cross-attention reads the ``xk``/``xv`` caches its prefill wrote).

    On DTensor caches (a device mesh) the write and the attention run on
    each process's shard through ``local_map``, q, k and v taken at the
    caches' placements (the batch over the data axes; KV heads over
    ``model`` where they divide it, and then the query heads too, so each
    GQA group stays on one process).  Where the KV heads do not divide
    ``model`` the reference's rule shards the caches' ``head_dim`` instead
    (``cache_logical``: the first divisible dimension wins).  There each
    process scores its slice of ``head_dim`` and the partial scores
    (B, H, Smax) are summed over ``model``: per step that moves H scores a
    position where gathering the caches would move 2 KV hd values (Qwen2-7B:
    28 against 1024), and a replicated cache would hold ``model`` copies of
    it.  The softmax is then taken whole on every process and multiplies
    each process's slice of the V cache, so the output leaves sharded on
    ``head_dim``; nothing gathers a cache."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def write(k_, v_, ck, cv):
        if k_ is not None:
            write_cache(ck, k_, mask.q_offset)
            write_cache(cv, v_, mask.q_offset)

    if not hasattr(k_cache, "device_mesh"):
        write(k, v, k_cache, v_cache)
        return decode_values(decode_scores(q, k_cache, scale), v_cache, mask)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, pc = k_cache.device_mesh, list(k_cache.placements)
    pin = (pc, None, None, pc, pc) if k is None else (pc,) * 5

    def whole(q_, k_, v_, ck, cv):
        write(k_, v_, ck, cv)
        return decode_values(decode_scores(q_, ck, scale), cv, mask)

    if not any(p.is_shard(3) for p in pc):
        return local_map(whole, out_placements=pc, in_placements=pin,
                         device_mesh=mesh, redistribute_inputs=True)(
            q, k, v, k_cache, v_cache)

    def scores(q_, k_, v_, ck, cv):
        write(k_, v_, ck, cv)
        return decode_scores(q_, ck, scale)

    partial = [Partial() if p.is_shard(3) else p for p in pc]
    s = local_map(scores, out_placements=partial, in_placements=pin,
                  device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, k_cache, v_cache)
    summed = [Replicate() if p.is_partial() else p for p in partial]
    s = s.redistribute(mesh, summed)
    return local_map(lambda s_, cv: decode_values(s_, cv, mask),
                     out_placements=pc, in_placements=(summed, pc),
                     device_mesh=mesh, redistribute_inputs=True)(s, v_cache)
