"""The dense decoder: schema-driven parameters as ``nn.Module``s, and the
forward in prefill and decode mode.

The port's twin of ``repro.models.model``.  Parameter names are the schema's
keys: ``embed``, ``final_norm``, ``lm_head`` at the top and ``layers.<i>.<key>``
for each decoder layer (the reference stacks those on a leading L axis for
``lax.scan``; here each layer is a module in a ``ModuleList``).  Shapes keep
the reference's semantics: ``wq`` (d, H, hd), ``wo`` (H, hd, d), ``w_in``
(d, f).  Matrices, embedding and biases are stored in the compute dtype, norm
scales in fp32 (the reference casts matrices at use and reads norm scales in
fp32, so this computes the same thing at half the memory).

Prefill attention runs the flash kernel (``models.flash``); decode writes the
new position into the KV cache in place (saving a copy of the whole cache per
step, where the reference returns an updated copy) and attends with the plain
``decode_attention``.  Ported: the dense families with ``qkv_bias``,
``qk_norm``, ``parallel_block``, ``logit_softcap``, tied and untied heads,
silu/geglu/gelu.  MoE, SSM, hybrid, enc-dec, VLM, sliding windows and the
training mode raise ``NotImplementedError`` naming their ROADMAP item; the
sharding constraints of the reference are identities on one card and are
dropped.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.engine.policy import resolve_device
from repro_torch.models import flash
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnMask, apply_rope,
                                       decode_attention, mlp, rms_norm,
                                       rope_angles)

COMPUTE_DTYPE = torch.bfloat16

#: global (not per-layer) parameters
GLOBAL_KEYS = ("embed", "final_norm", "lm_head")
#: parameters kept in fp32 whatever the compute dtype
NORM_KEYS = ("final_norm", "ln1", "ln2", "q_norm", "k_norm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.moe is not None or cfg.family == "moe":
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  "yet (ROADMAP A10)")
    if cfg.block != "attn" or cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: SSM / hybrid blocks are not "
                                  "ported yet (ROADMAP A10)")
    if cfg.enc_dec or cfg.family == "audio":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder stack is "
                                  "not ported yet (ROADMAP A10)")
    if cfg.vlm or cfg.rope == "mrope" or cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: VLM prefixes and M-RoPE are "
                                  "not ported yet (ROADMAP A10)")
    if cfg.sliding_window is not None:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention is "
                                  "not ported yet (ROADMAP A10)")


# ----------------------------------------------------------------- schema
def _schema(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], float]]:
    """name -> (shape, init scale) of the dense decoder.  Per-layer tensors
    are stacked on a leading L axis, as in the reference's schema."""
    check_supported(cfg)
    d, L = cfg.d_model, cfg.num_layers
    H, KV, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    w_scale = 0.02
    o_scale = 0.02 / math.sqrt(2 * max(L, 1))
    s = {"embed": ((cfg.vocab_padded, d), 0.02), "final_norm": ((d,), 0.0)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ((d, cfg.vocab_padded), 0.02)
    s["ln1"] = ((L, d), 0.0)
    s["wq"] = ((L, d, H, hd), w_scale)
    s["wk"] = ((L, d, KV, hd), w_scale)
    s["wv"] = ((L, d, KV, hd), w_scale)
    s["wo"] = ((L, H, hd, d), o_scale)
    if cfg.qkv_bias:
        s["bq"] = ((L, H, hd), 0.0)
        s["bk"] = ((L, KV, hd), 0.0)
        s["bv"] = ((L, KV, hd), 0.0)
    if cfg.qk_norm:
        s["q_norm"] = ((L, hd), 0.0)
        s["k_norm"] = ((L, hd), 0.0)
    if cfg.d_ff:
        s["ln2"] = ((L, d), 0.0)
        if cfg.mlp_act in ("silu", "geglu"):
            s["w_gate"] = ((L, d, f), w_scale)
        s["w_in"] = ((L, d, f), w_scale)
        s["w_out"] = ((L, f, d), o_scale)
    return s


def _store_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if name in NORM_KEYS else dtype


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------------- modules
class DecoderLayer(nn.Module):
    """One dense decoder layer; its parameters are the schema's per-layer
    keys, one layer's slice each."""

    def __init__(self, cfg: ModelConfig, tensors: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, t in tensors.items():
            self.register_parameter(name, _param(t))
        self.attn_core = flash.FlashAttention()

    def _attention(self, x, angles, mode, cache_k, cache_v, pos):
        cfg = self.cfg
        B, S, d = x.shape
        dt = x.dtype
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        x2 = x.reshape(B * S, d)
        q = (x2 @ self.wq.to(dt).reshape(d, H * hd)).view(B, S, H, hd)
        k = (x2 @ self.wk.to(dt).reshape(d, KV * hd)).view(B, S, KV, hd)
        v = (x2 @ self.wv.to(dt).reshape(d, KV * hd)).view(B, S, KV, hd)
        if cfg.qkv_bias:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        if angles is not None:
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
        if mode == "decode":
            cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
            cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
            out = decode_attention(q, cache_k, cache_v,
                                   AttnMask(True, None, pos, pos + 1))
        else:
            out = self.attn_core(q, k, v, causal=True)
            cache_k[:, :S] = k.to(cache_k.dtype)
            cache_v[:, :S] = v.to(cache_v.dtype)
        return out.reshape(B * S, H * hd) @ self.wo.to(dt).reshape(H * hd, d)

    def forward(self, x, angles, mode, cache_k, cache_v, pos):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        mix = self._attention(h, angles, mode, cache_k, cache_v,
                              pos).view(x.shape)
        p = {n: getattr(self, n) for n in ("w_in", "w_gate", "w_out")
             if hasattr(self, n)}
        if cfg.parallel_block and cfg.d_ff:
            return x + mix + mlp(h, p, cfg.mlp_act)
        x = x + mix
        if cfg.d_ff:
            x = x + mlp(rms_norm(x, self.ln2, cfg.norm_eps), p, cfg.mlp_act)
        return x


class Model(nn.Module):
    """The decoder stack: ``embed``, ``layers`` (a ``ModuleList`` of
    :class:`DecoderLayer`), ``final_norm`` and, untied, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, tensors: dict[str, torch.Tensor]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        for name in GLOBAL_KEYS:
            if name in tensors:
                self.register_parameter(name, _param(tensors[name]))
        per_layer = {n: t for n, t in tensors.items() if n not in GLOBAL_KEYS}
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, {n: t[i] for n, t in per_layer.items()})
            for i in range(cfg.num_layers))


# ------------------------------------------------------------ construction
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype | None = None) -> Model:
    """A :class:`Model` with the reference's init rule (normal * scale, zero
    where the scale is 0) drawn from a ``torch.Generator`` on ``device``
    seeded with ``seed``, on ``device`` (the card unless the caller asks for
    the CPU).  The numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    generator = torch.Generator(device=dev).manual_seed(seed)
    tensors = {}
    for name, (shape, scale) in sorted(_schema(cfg).items()):
        sd = _store_dtype(name, dtype)
        if scale == 0.0:
            tensors[name] = torch.zeros(shape, dtype=sd, device=dev)
        else:
            tensors[name] = (torch.randn(shape, generator=generator,
                                         dtype=torch.float32, device=dev)
                             .mul_(scale).to(sd))
    return Model(cfg, tensors)


def params_from_numpy(cfg: ModelConfig, params: dict, *, device="cuda",
                      dtype: torch.dtype | None = None) -> Model:
    """A :class:`Model` holding the reference's flat parameter dict (numpy
    arrays, per-layer tensors stacked on a leading L axis), matrices,
    embedding and biases in ``dtype`` (default the compute dtype), norm
    scales in fp32, on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    tensors = {}
    for name, (shape, _) in _schema(cfg).items():
        arr = np.array(params[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: want shape {shape}, got {arr.shape}")
        tensors[name] = torch.from_numpy(arr).to(
            device=dev, dtype=_store_dtype(name, dtype))
    return Model(cfg, tensors)


# ------------------------------------------------------------------ caches
def _empty_caches(cfg: ModelConfig, batch: int, length: int,
                  device) -> dict[str, torch.Tensor]:
    """Zeroed per-layer KV caches (L, batch, length, KV, hd) in the compute
    dtype."""
    shape = (cfg.num_layers, batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {nm: torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
            for nm in ("k", "v")}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Decode state: full-length KV caches and the next position."""
    check_supported(cfg)
    cache = _empty_caches(cfg, batch, max_len, resolve_device(device))
    cache["pos"] = 0
    return cache


# ----------------------------------------------------------------- forward
def model_forward(params: Model, cfg: ModelConfig, tokens: torch.Tensor, *,
                  mode: str, cache: dict | None = None,
                  max_len: int | None = None):
    """Returns (logits, new_cache).

    prefill : tokens (B, S) -> last-position logits (B, 1, Vp) + a cache
              padded to ``max_len`` positions
    decode  : tokens (B, 1) + cache -> logits (B, 1, Vp) + the same cache,
              updated in place, with ``pos`` advanced
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} belongs to the training "
                                  "slice (ROADMAP A10)")
    check_supported(cfg)
    B, S = tokens.shape
    dt = COMPUTE_DTYPE
    dev = params.embed.device
    with torch.no_grad():
        if mode == "decode":
            pos0 = int(cache["pos"])
            caches = cache
        else:
            pos0 = 0
            caches = _empty_caches(cfg, B, max(S, max_len or S), dev)
        x = params.embed[tokens.long()].to(dt)
        angles = None
        if cfg.rope == "rope":
            positions = (pos0 + torch.arange(S, device=dev))[None].expand(B, S)
            angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        for i, layer in enumerate(params.layers):
            x = layer(x, angles, mode, caches["k"][i], caches["v"][i], pos0)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        if mode == "prefill":
            x = x[:, -1:]
        head = params.embed.T if cfg.tie_embeddings else params.lm_head
        logits = x @ head.to(dt)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
    new_cache = dict(caches)
    new_cache["pos"] = pos0 + 1 if mode == "decode" else S
    return logits, new_cache
