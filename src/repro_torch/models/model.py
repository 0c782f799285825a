"""The decoder: schema-driven parameters as ``nn.Module``s, and the forward
in train, prefill and decode mode.

The port's twin of ``repro.models.model``.  Parameter names are the schema's
keys: ``embed``, ``final_norm``, ``lm_head`` at the top and ``layers.<i>.<key>``
for each decoder layer (the reference stacks those on a leading L axis for
``lax.scan``; here each layer is a module in a ``ModuleList``).  Shapes keep
the reference's semantics: ``wq`` (d, H, hd), ``wo`` (H, hd, d), ``w_in``
(d, f).  Matrices, embedding and biases are stored in the compute dtype;
norm scales and the SSM's conv weights, dt bias, A_log and D in fp32 (the
reference casts matrices at use and reads those in fp32, so this computes
the same thing at half the memory).

A layer mixes by attention (``block`` attn), the Mamba2 mixer
(``models.ssm``, block ssm) or both, averaged (hybrid, Hymba), then runs
the MoE FFN (``models.moe``), the dense MLP or nothing (Mamba2).  Prefill
attention runs the flash kernel (``models.flash``); decode writes the new
position into the KV cache in place (saving a copy of the whole cache per
step, where the reference returns an updated copy) and attends with the
plain ``decode_attention``; the SSM's conv and state caches are updated in
place alike.  Training (``mode="train"``, autograd on) runs
attention through ``flash_attention_vjp`` (the forward and backward kernels)
and, unless ``cfg.remat == "none"``, each layer under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): ``"full"``
saves each layer's input only, ``"dots"`` also the weight products' outputs
(a selective-checkpoint policy on ``aten.mm``).  Training holds fp32 master
weights (``init_params(..., dtype=torch.float32)``), cast to the compute
dtype at use as the reference does; serving keeps bf16 storage.  Ported: the
dense families with ``qkv_bias``, ``qk_norm``, ``parallel_block``,
``logit_softcap``, tied and untied heads, silu/geglu/gelu, sliding windows
with the reference's per-layer global flags (``global_flags``: Gemma3's
local:global pattern), M-RoPE and the VLM prefix (Qwen2-VL); serving of the
MoE, SSM and hybrid families.  Training those and enc-dec raise
``NotImplementedError`` naming their ROADMAP item; the sharding constraints
of the reference are identities on one card and are dropped
(``param_logical`` and ``cache_logical`` keep their names).
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.engine.policy import resolve_device
from repro_torch.models import flash
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnMask, apply_rope,
                                       decode_attention, mlp, rms_norm,
                                       rope_angles)
from repro_torch.models.loss import fused_ce_loss

COMPUTE_DTYPE = torch.bfloat16

#: global (not per-layer) parameters
GLOBAL_KEYS = ("embed", "final_norm", "lm_head")
#: norm scales: kept in fp32 whatever the compute dtype
NORM_KEYS = ("final_norm", "ln1", "ln2", "q_norm", "k_norm")
#: the SSM's parameters that the reference reads in fp32: kept in fp32 too
SSM_FP32_KEYS = ("ssm_conv_w", "ssm_conv_b", "ssm_dt_bias", "ssm_A_log",
                 "ssm_D", "ssm_norm")
#: per-layer cache entries: KV (attention) and conv / state (SSM)
CACHE_KEYS = ("k", "v", "conv", "ssm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    the encoder-decoder stack of ROADMAP A10.3."""
    if cfg.enc_dec or cfg.family == "audio":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder stack is "
                                  "not ported yet (ROADMAP A10.3)")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port serves but does
    not train yet: MoE, SSM and hybrid need the backward of the MoE
    dispatch and of the SSD scan (ROADMAP A10.3, training)."""
    check_supported(cfg)
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: training MoE layers is not "
                                  "ported yet (ROADMAP A10.3, training)")
    if cfg.block != "attn":
        raise NotImplementedError(f"{cfg.name}: training SSM / hybrid "
                                  "blocks is not ported yet (ROADMAP A10.3, "
                                  "training)")


def global_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer bool: True = full/global attention, False = sliding window
    (the reference's rule: every ``global_every``-th layer, else the first,
    middle and last layers)."""
    if cfg.num_layers == 0:
        return np.zeros(0, bool)
    if cfg.sliding_window is None:
        return np.ones(cfg.num_layers, bool)
    if cfg.global_every is not None:
        return np.array([(i + 1) % cfg.global_every == 0
                         for i in range(cfg.num_layers)])
    # hybrid default (Hymba): first / middle / last layers global
    flags = np.zeros(cfg.num_layers, bool)
    flags[[0, cfg.num_layers // 2, cfg.num_layers - 1]] = True
    return flags


def layer_windows(cfg: ModelConfig) -> list:
    """Each layer's attention window: None (unbounded) on a global layer,
    ``cfg.sliding_window`` on the others (the reference's
    ``_apply_global``)."""
    return [None if flag else cfg.sliding_window
            for flag in global_flags(cfg)]


# ----------------------------------------------------------------- schema
#: the reference's logical axis names per parameter (per-layer tensors lead
#: with the stacked L axis, None): on one card every sharding constraint they
#: drive is an identity, so they serve parity only (:func:`param_logical`)
LOGICAL = {
    "embed": ("vocab", "fsdp"), "final_norm": (None,),
    "lm_head": ("fsdp", "vocab"), "ln1": (None, None), "ln2": (None, None),
    "wq": (None, "fsdp", "heads", "head_dim"),
    "wk": (None, "fsdp", "kv_heads", "head_dim"),
    "wv": (None, "fsdp", "kv_heads", "head_dim"),
    "wo": (None, "heads", "head_dim", "fsdp"),
    "bq": (None, "heads", "head_dim"), "bk": (None, "kv_heads", "head_dim"),
    "bv": (None, "kv_heads", "head_dim"),
    "q_norm": (None, None), "k_norm": (None, None),
    "w_gate": (None, "fsdp", "mlp"), "w_in": (None, "fsdp", "mlp"),
    "w_out": (None, "mlp", "fsdp"),
    "ssm_in_proj": (None, "fsdp", "mlp"), "ssm_conv_w": (None, None, "mlp"),
    "ssm_conv_b": (None, "mlp"), "ssm_dt_bias": (None, "heads"),
    "ssm_A_log": (None, "heads"), "ssm_D": (None, "heads"),
    "ssm_norm": (None, "mlp"), "ssm_out_proj": (None, "mlp", "fsdp"),
    "router": (None, "fsdp", None),
    "moe_w_gate": (None, "experts", "fsdp", "expert_mlp"),
    "moe_w_in": (None, "experts", "fsdp", "expert_mlp"),
    "moe_w_out": (None, "experts", "expert_mlp", "fsdp"),
    "shared_w_gate": (None, "fsdp", "mlp"),
    "shared_w_in": (None, "fsdp", "mlp"),
    "shared_w_out": (None, "mlp", "fsdp"),
    "shared_gate": (None, "fsdp", None),
}


def _ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, nh, conv_dim) of the Mamba2 mixer."""
    sp = cfg.ssm
    d_inner = sp.expand * cfg.d_model
    conv_dim = d_inner + 2 * sp.n_groups * sp.d_state
    return d_inner, d_inner // sp.head_dim, conv_dim


def _schema(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], float]]:
    """name -> (shape, init scale).  Per-layer tensors are stacked on a
    leading L axis, as in the reference's schema."""
    check_supported(cfg)
    d, L = cfg.d_model, cfg.num_layers
    H, KV, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    w_scale = 0.02
    o_scale = 0.02 / math.sqrt(2 * max(L, 1))
    s = {"embed": ((cfg.vocab_padded, d), 0.02), "final_norm": ((d,), 0.0)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ((d, cfg.vocab_padded), 0.02)
    s["ln1"] = ((L, d), 0.0)
    if cfg.block in ("attn", "hybrid"):
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
    if cfg.block in ("ssm", "hybrid"):
        sp = cfg.ssm
        d_inner, nh, conv_dim = _ssm_dims(cfg)
        d_proj = d_inner + conv_dim + nh
        s["ssm_in_proj"] = ((L, d, d_proj), w_scale)
        s["ssm_conv_w"] = ((L, sp.conv_width, conv_dim), 0.1)
        s["ssm_conv_b"] = ((L, conv_dim), 0.0)
        s["ssm_dt_bias"] = ((L, nh), 0.1)
        s["ssm_A_log"] = ((L, nh), 0.1)
        s["ssm_D"] = ((L, nh), 0.1)
        s["ssm_norm"] = ((L, d_inner), 0.0)
        s["ssm_out_proj"] = ((L, d_inner, d), o_scale)
    if cfg.moe is not None:
        m = cfg.moe
        E, fe = m.padded_experts(), m.d_ff_expert
        s["ln2"] = ((L, d), 0.0)
        s["router"] = ((L, d, m.num_experts), w_scale)
        s["moe_w_gate"] = ((L, E, d, fe), w_scale)
        s["moe_w_in"] = ((L, E, d, fe), w_scale)
        s["moe_w_out"] = ((L, E, fe, d), o_scale)
        if m.num_shared:
            fs = m.num_shared * fe
            s["shared_w_gate"] = ((L, d, fs), w_scale)
            s["shared_w_in"] = ((L, d, fs), w_scale)
            s["shared_w_out"] = ((L, fs, d), o_scale)
            s["shared_gate"] = ((L, d, 1), w_scale)
    elif cfg.d_ff:
        s["ln2"] = ((L, d), 0.0)
        if cfg.mlp_act in ("silu", "geglu"):
            s["w_gate"] = ((L, d, f), w_scale)
        s["w_in"] = ((L, d, f), w_scale)
        s["w_out"] = ((L, f, d), o_scale)
    return s


def _store_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return (torch.float32 if name in NORM_KEYS or name in SSM_FP32_KEYS
            else dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------------- modules
class DecoderLayer(nn.Module):
    """One decoder layer; its parameters are the schema's per-layer keys,
    one layer's slice each."""

    def __init__(self, cfg: ModelConfig, tensors: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, t in tensors.items():
            self.register_parameter(name, _param(t))
        if cfg.block in ("attn", "hybrid"):
            self.attn_core = flash.FlashAttention()

    def _params(self, names) -> dict:
        return {n: getattr(self, n) for n in names if hasattr(self, n)}

    def _attention(self, x, angles, mode, cache, pos, window):
        cfg = self.cfg
        cache_k, cache_v = (cache["k"], cache["v"]) if cache else (None, None)
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
                                   AttnMask(True, window, pos, pos + 1))
        elif mode == "train":
            skip = cfg.flash_block_skip
            out = self.attn_core(q, k, v, causal=True, train=True,
                                 window=window, block_skip=skip,
                                 kv_chunk=512 if skip else 1024)
        else:
            out = self.attn_core(q, k, v, causal=True, window=window)
            cache_k[:, :S] = k.to(cache_k.dtype)
            cache_v[:, :S] = v.to(cache_v.dtype)
        return out.reshape(B * S, H * hd) @ self.wo.to(dt).reshape(H * hd, d)

    def _ssm(self, x, mode, cache):
        """The Mamba2 mixer; its conv and state caches written in place
        (prefill fills them, decode steps them)."""
        p = {n[len("ssm_"):]: t for n, t in self.named_parameters()
             if n.startswith("ssm_")}
        state = ({"conv": cache["conv"].to(x.dtype), "ssm": cache["ssm"]}
                 if mode == "decode" else None)
        out, new = ssm_lib.mamba2_mix(
            p, x, self.cfg, mode="step" if mode == "decode" else "full",
            state=state)
        cache["conv"].copy_(new["conv"])
        cache["ssm"].copy_(new["ssm"])
        return out

    def forward(self, x, angles, mode, cache=None, pos=0, window=None):
        """``cache``: this layer's views of the cache entries (``k``/``v``,
        ``conv``/``ssm``), None in training."""
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        mix = None
        if cfg.block in ("attn", "hybrid"):
            mix = self._attention(h, angles, mode, cache, pos,
                                  window).view(x.shape)
        if cfg.block in ("ssm", "hybrid"):
            ssm_out = self._ssm(h, mode, cache)
            mix = ssm_out if mix is None else mix + ssm_out
        if cfg.block == "hybrid":
            mix = mix * 0.5                   # average the parallel heads
        p = self._params(("w_in", "w_gate", "w_out"))
        if cfg.parallel_block and cfg.moe is None and cfg.d_ff:
            return x + mix + mlp(h, p, cfg.mlp_act)
        x = x + mix
        if cfg.moe is not None:
            mo = {"router": self.router, "w_gate": self.moe_w_gate,
                  "w_in": self.moe_w_in, "w_out": self.moe_w_out,
                  **self._params(("shared_w_gate", "shared_w_in",
                                  "shared_w_out", "shared_gate"))}
            return x + moe_lib.moe_ffn(rms_norm(x, self.ln2, cfg.norm_eps),
                                       mo, cfg.moe, cfg.mlp_act)
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
    where the scale is 0, 0.5 for the SSM's A_log, dt_bias and D) drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``, on
    ``device`` (the card unless the caller asks for the CPU).  The numbers differ from ``jax.random``'s.  ``dtype`` is the
    storage of matrices, embedding and biases (default the compute dtype;
    training passes ``torch.float32`` for fp32 master weights)."""
    dev = resolve_device(device)
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    generator = torch.Generator(device=dev).manual_seed(seed)
    tensors = {}
    for name, (shape, scale) in sorted(_schema(cfg).items()):
        sd = _store_dtype(name, dtype)
        if scale == 0.0:
            tensors[name] = torch.zeros(shape, dtype=sd, device=dev)
        elif name.endswith(("A_log", "dt_bias", "D")):
            tensors[name] = torch.full(shape, 0.5, dtype=sd, device=dev)
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


def stack_layers(cfg: ModelConfig, named: dict) -> dict[str, torch.Tensor]:
    """Tensors keyed by :class:`Model` parameter name (``embed``,
    ``layers.<i>.<key>``) -> the reference's flat names, per-layer tensors
    stacked on a leading L axis (a copy, on their device)."""
    out = {}
    for name in _schema(cfg):
        if name in GLOBAL_KEYS:
            out[name] = named[name]
        else:
            out[name] = torch.stack([named[f"layers.{i}.{name}"]
                                     for i in range(cfg.num_layers)])
    return out


def unstack_layers(cfg: ModelConfig, flat: dict) -> dict[str, torch.Tensor]:
    """The inverse of :func:`stack_layers`: the reference's flat names ->
    :class:`Model` parameter names (per-layer views of the stacked
    tensors)."""
    out = {}
    for name in _schema(cfg):
        if name in GLOBAL_KEYS:
            out[name] = flat[name]
        else:
            for i in range(cfg.num_layers):
                out[f"layers.{i}.{name}"] = flat[name][i]
    return out


def params_to_numpy(params: Model) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: the reference's flat
    parameter dict, fp32 numpy arrays with per-layer tensors stacked on the
    L axis."""
    named = {n: p.detach() for n, p in params.named_parameters()}
    return {name: t.float().cpu().numpy()
            for name, t in stack_layers(params.cfg, named).items()}


def abstract_params(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """fp32 tensors on the meta device in the reference's flat, stacked
    layout: shapes and dtypes, no allocation."""
    return {name: torch.empty(shape, dtype=torch.float32, device="meta")
            for name, (shape, _) in _schema(cfg).items()}


def param_logical(cfg: ModelConfig) -> dict[str, tuple]:
    """The reference's logical axis names per parameter (:data:`LOGICAL`)."""
    return {name: LOGICAL[name] for name in _schema(cfg)}


# ------------------------------------------------------------------ caches
def _empty_caches(cfg: ModelConfig, batch: int, length: int,
                  device) -> dict[str, torch.Tensor]:
    """Zeroed per-layer caches: for attention KV (L, batch, length, KV, hd)
    in the compute dtype; for the SSM the conv inputs (L, batch, K-1,
    conv_dim) in the compute dtype and the state (L, batch, nh, hp, ds) in
    fp32 (the reference's keys and shapes)."""
    L = cfg.num_layers
    out = {}
    if cfg.block in ("attn", "hybrid"):
        shape = (L, batch, length, cfg.num_kv_heads, cfg.head_dim)
        for nm in ("k", "v"):
            out[nm] = torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
    if cfg.block in ("ssm", "hybrid"):
        sp = cfg.ssm
        _, nh, conv_dim = _ssm_dims(cfg)
        out["conv"] = torch.zeros((L, batch, sp.conv_width - 1, conv_dim),
                                  dtype=COMPUTE_DTYPE, device=device)
        out["ssm"] = torch.zeros((L, batch, nh, sp.head_dim, sp.d_state),
                                 dtype=torch.float32, device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Decode state: full-length KV caches, the SSM's conv and state caches
    and the next position."""
    check_supported(cfg)
    cache = _empty_caches(cfg, batch, max_len, resolve_device(device))
    cache["pos"] = 0
    return cache


def cache_logical(cfg: ModelConfig) -> dict[str, tuple]:
    """The reference's logical axis names per cache entry (identities on
    one card, kept for parity)."""
    check_supported(cfg)
    names: dict[str, tuple] = {"pos": ()}
    if cfg.block in ("attn", "hybrid"):
        names["k"] = (None, "batch", None, "kv_heads", "head_dim")
        names["v"] = (None, "batch", None, "kv_heads", "head_dim")
    if cfg.block in ("ssm", "hybrid"):
        names["conv"] = (None, "batch", None, "mlp")
        names["ssm"] = (None, "batch", "heads", None, "state")
    return names


# ----------------------------------------------------------------- forward
def _remat_context(cfg: ModelConfig):
    """``context_fn`` of ``torch.utils.checkpoint`` for ``cfg.remat``:
    ``"full"`` saves nothing inside the layer (the default contexts);
    ``"dots"`` saves the outputs of the weight products (``aten.mm``, the
    reference's ``dots_with_no_batch_dims_saveable``) and recomputes the
    rest, attention included."""
    if cfg.remat != "dots":
        return torch_checkpoint.noop_context_fn
    policy_cls = torch_checkpoint.CheckpointPolicy
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (policy_cls.MUST_SAVE if op in saved
                else policy_cls.PREFER_RECOMPUTE)
    return functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, policy)


def _train_layers(params: Model, cfg: ModelConfig, x, angles):
    """The layer stack with autograd on, each layer under
    ``torch.utils.checkpoint`` unless ``cfg.remat == "none"``."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")
    for layer, window in zip(params.layers, layer_windows(cfg)):
        if cfg.remat == "none":
            x = layer(x, angles, "train", None, 0, window)
        else:
            x = torch_checkpoint.checkpoint(
                layer, x, angles, "train", None, 0, window,
                use_reentrant=False, context_fn=_remat_context(cfg))
    return x


def model_forward(params: Model, cfg: ModelConfig, tokens: torch.Tensor, *,
                  mode: str, visual: torch.Tensor | None = None,
                  mrope_positions: torch.Tensor | None = None,
                  cache: dict | None = None, max_len: int | None = None,
                  return_hidden: bool = False):
    """Returns (logits, new_cache).

    ``visual`` (B, V, d), with ``cfg.vlm``: patch embeddings that take the
    place of the first V token embeddings.  ``mrope_positions`` (3, B, S),
    with ``cfg.rope == "mrope"``: each stream's positions (default
    pos0 + arange(S) in all three, the reference's, as in decode).  Each
    layer attends under its window (:func:`layer_windows`).

    train   : tokens (B, S) -> logits (B, S, Vp), cache None, with autograd;
              ``return_hidden`` returns the final-norm hidden states
              (B, S, d) in their place (the fused loss takes those)
    prefill : tokens (B, S) -> last-position logits (B, 1, Vp) + a cache
              padded to ``max_len`` positions
    decode  : tokens (B, 1) + cache -> logits (B, 1, Vp) + the same cache,
              updated in place, with ``pos`` advanced
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    if mode == "train" and cache is not None:
        raise ValueError("mode='train' takes no cache")
    (check_trainable if mode == "train" else check_supported)(cfg)
    B, S = tokens.shape
    dt = COMPUTE_DTYPE
    dev = params.embed.device
    with contextlib.nullcontext() if mode == "train" else torch.no_grad():
        if mode == "decode":
            pos0 = int(cache["pos"])
            caches = cache
        else:
            pos0 = 0
            caches = (None if mode == "train" else
                      _empty_caches(cfg, B, max(S, max_len or S), dev))
        x = params.embed[tokens.long()].to(dt)
        if cfg.vlm and visual is not None:
            V = visual.shape[1]
            x = torch.cat([visual.to(device=dev, dtype=dt), x[:, V:]], dim=1)
        angles = None
        if cfg.rope in ("rope", "mrope"):
            positions = (pos0 + torch.arange(S, device=dev))[None].expand(B, S)
            if cfg.rope == "mrope":
                if mrope_positions is None:
                    mrope_positions = positions[None].expand(3, B, S)
                angles = rope_angles(mrope_positions.to(dev), cfg.head_dim,
                                     cfg.rope_theta, cfg.mrope_sections)
            else:
                angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        if mode == "train":
            x = rms_norm(_train_layers(params, cfg, x, angles),
                         params.final_norm, cfg.norm_eps)
            return (x if return_hidden else _head_logits(params, cfg, x)), None
        for i, (layer, window) in enumerate(zip(params.layers,
                                                layer_windows(cfg))):
            x = layer(x, angles, mode, {nm: caches[nm][i] for nm in
                                        CACHE_KEYS if nm in caches},
                      pos0, window)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        if mode == "prefill":
            x = x[:, -1:]
        logits = _head_logits(params, cfg, x)
    new_cache = dict(caches)
    new_cache["pos"] = pos0 + 1 if mode == "decode" else S
    return logits, new_cache


def _head_logits(params: Model, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# -------------------------------------------------------------------- loss
def lm_loss(params: Model, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy through the fused chunked loss (full
    (B, S, V) logits are never materialized; see ``models.loss``).  batch:
    ``tokens`` and ``labels`` (B, S), label -1 masked, and for a VLM
    ``visual`` and ``mrope_positions`` (:func:`model_forward`).  Returns
    (loss, {"loss", "tokens"}), differentiable in the parameters."""
    if "frames" in batch:
        raise NotImplementedError("frames inputs (the encoder-decoder "
                                  "stack) are not ported yet (ROADMAP "
                                  "A10.3)")
    hidden, _ = model_forward(params, cfg, batch["tokens"], mode="train",
                              visual=batch.get("visual"),
                              mrope_positions=batch.get("mrope_positions"),
                              return_hidden=True)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    loss, tokens = fused_ce_loss(hidden, head.to(hidden.dtype),
                                 batch["labels"], valid_vocab=cfg.vocab_size)
    return loss, {"loss": loss, "tokens": tokens}
