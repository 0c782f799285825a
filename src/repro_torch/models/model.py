"""The model: schema-driven parameters as ``nn.Module``s, and the forward
in train, prefill and decode mode.

The port's twin of ``repro.models.model``.  Parameter names are the schema's
keys: ``embed``, ``final_norm``, ``lm_head`` and ``enc_final_norm`` at the
top, ``layers.<i>.<key>`` for each decoder layer and ``enc_layers.<i>.<key>``
for each encoder layer of an encoder-decoder (the reference stacks those on
a leading L or ``enc_layers`` axis for ``lax.scan``; here each layer is a
module in a ``ModuleList``).  Shapes keep
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
place alike.

An encoder-decoder (Whisper) runs its encoder over precomputed frame
embeddings (``frames`` (B, F, d); the conv / log-mel frontend is a stub,
as in the reference) plus sinusoidal positions: per layer RMSNorm,
bidirectional flash attention, RMSNorm and the gelu MLP, then
``enc_final_norm``.  Each decoder layer then cross-attends: RMSNorm of the
residual plus the layer's mix, q against k/v projected from the encoder
output (no bias, qk-norm or rope), through the flash kernel with
``causal=False`` in train and prefill; prefill writes those k/v to the
``xk``/``xv`` caches, and decode reads them with the plain decode
attention (``cached_decode_attention`` with nothing to write).

Training (``mode="train"``, autograd on) runs attention through
``flash_attention_vjp`` (the forward and backward kernels) and, unless
``cfg.remat == "none"``, each layer (encoder layers too) under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): ``"full"``
saves each layer's input only, ``"dots"`` also the weight products' outputs
(a selective-checkpoint policy on ``aten.mm``/``aten.addmm``, the
reference's ``dots_with_no_batch_dims_saveable``: the experts' ``bmm`` and
the SSD's batched fp32 products have a batch dimension and are recomputed,
as the reference recomputes them).  A layer's recompute routes its MoE
tokens exactly as its forward did: the routing is a stable sort of the same
numbers.  Training holds fp32 master weights (``init_params(...,
dtype=torch.float32)``), cast to the compute dtype at use as the reference
does; serving keeps bf16 storage.  Every family of the reference serves and
trains: the dense ones with ``qkv_bias``, ``qk_norm``, ``parallel_block``,
``logit_softcap``, tied and untied heads, silu/geglu/gelu, sliding windows
with the reference's per-layer global flags (``global_flags``: Gemma3's
local:global pattern), M-RoPE and the VLM prefix (Qwen2-VL), MoE, SSM,
hybrid and the encoder-decoder.

On a device mesh (``init_params(..., mesh=)``, a
``repro_torch.launch.mesh.DistMesh``) the parameters are DTensors placed by
:func:`param_logical` (FSDP over ``data``, TP over ``model``, the
reference's divisibility fallback; under the reference's ``serve_tp`` rules,
``fsdp`` mapped to None, TP only) and every family whose block is attention
(the dense family, the MoE and the encoder-decoder) trains and serves under
the reference's sharding constraints (``parallel.sharding.constrain`` at
the residual after the embedding, q after rope, the MLP hidden and the
logits; identities on one device): DTensor propagates the products and
their collectives, flash attention runs its kernels on each process's
local heads and batch (``models.flash``; causal, bidirectional and cross
attention alike), the MoE dispatches its tokens to the processes that hold
their experts (``models.moe``: expert parallelism over ``model``, or tensor
parallelism inside each expert), and the loss is vocab-parallel
(``models.loss``).  An encoder-decoder's frames are split by rows over the
data axes and its sinusoidal positions placed whole on every process, as
the rope angles are.  The caches are DTensors placed by
:func:`cache_logical`; prefill writes each process's shard of them (the
``xk``/``xv`` caches too), and decode writes and attends on each process's
shard (``layers.cached_decode_attention``; the cross-attention reads its
shard of ``xk``/``xv`` and writes none).  A table sharded on ``vocab``
alone (serving) is looked up where each row lives and summed over its
axes; one sharded on both dimensions (training) is gathered whole for the
lookup.  Prefill and decode logits stay sharded on ``vocab``.

The reference's two sequence options run there too, in the same places.
``ulysses_attn`` (DeepSpeed-Ulysses; train and prefill, self- and
cross-attention, not decode): q is resharded to ("batch", "seq_sp") with
every head whole and k and v whole over ``model``, so flash runs each
process's slice of the queries at their absolute positions against every
key (``models.flash``), and the output goes back to the heads layout;
prefill still writes each process's shard of the caches.  ``seq_sharded``
(Megatron-SP; training only): a layer's input, and so every remat-saved
carry, sits on ("batch", "seq_sp", None); the port gathers the normed
input whole over ``model`` before each branch's products and
reduce-scatters each branch's output back onto the carry's rows, where
the reference leaves both to XLA.  With either option the SSM and hybrid
blocks raise on a device mesh (ROADMAP A16).

The SSM (Mamba2) and hybrid (Hymba) blocks train and serve there without
the options: the Mamba2 mixer runs its mesh route (``models.ssm``: each
process's columns of ``in_proj``, channels of the conv and of its cache,
SSM heads and state, and rows of ``out_proj``, with explicit collectives),
and Hymba averages the two branches on the mixer output's placement.  Where
a projection's heads do not divide ``model`` (Hymba's 25 query and 5 KV
heads) the reference's rule splits ``head_dim``; :func:`heads_in` and
:func:`heads_out` then multiply each process's local slices, never
flattening a split ``head_dim`` (torch 2.11's DTensor refuses that view).
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
from repro_torch.launch.mesh import DistMesh, set_mesh
from repro_torch.models import flash
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnMask, apply_rope,
                                       cached_decode_attention, mlp,
                                       rms_norm, rope_angles, write_cache)
from repro_torch.models.loss import fused_ce_loss
from repro_torch.parallel.sharding import (constrain, distribute,
                                          mesh_placements)

COMPUTE_DTYPE = torch.bfloat16

#: global (not per-layer) parameters
GLOBAL_KEYS = ("embed", "final_norm", "lm_head", "enc_final_norm")
#: the encoder's per-layer parameters, stacked on ``cfg.enc_layers``
ENC_KEYS = ("enc_wq", "enc_wk", "enc_wv", "enc_wo", "enc_w_in", "enc_w_out",
            "enc_ln1", "enc_ln2")
#: norm scales: kept in fp32 whatever the compute dtype
NORM_KEYS = ("final_norm", "ln1", "ln2", "q_norm", "k_norm", "enc_ln1",
             "enc_ln2", "enc_final_norm", "ln_x")
#: the SSM's parameters that the reference reads in fp32: kept in fp32 too
SSM_FP32_KEYS = ("ssm_conv_w", "ssm_conv_b", "ssm_dt_bias", "ssm_A_log",
                 "ssm_D", "ssm_norm")
#: per-layer cache entries: KV (attention), conv / state (SSM) and the
#: encoder output's cross-attention KV (encoder-decoder)
CACHE_KEYS = ("k", "v", "conv", "ssm", "xk", "xv")


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
#: with the stacked L axis, None): the placements of the parameters on a
#: device mesh (:func:`param_logical`)
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
    "enc_wq": (None, "fsdp", "heads", "head_dim"),
    "enc_wk": (None, "fsdp", "kv_heads", "head_dim"),
    "enc_wv": (None, "fsdp", "kv_heads", "head_dim"),
    "enc_wo": (None, "heads", "head_dim", "fsdp"),
    "enc_w_in": (None, "fsdp", "mlp"), "enc_w_out": (None, "mlp", "fsdp"),
    "enc_ln1": (None, None), "enc_ln2": (None, None),
    "enc_final_norm": (None,),
    "xattn_wq": (None, "fsdp", "heads", "head_dim"),
    "xattn_wk": (None, "fsdp", "kv_heads", "head_dim"),
    "xattn_wv": (None, "fsdp", "kv_heads", "head_dim"),
    "xattn_wo": (None, "heads", "head_dim", "fsdp"),
    "ln_x": (None, None),
}


def _ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, nh, conv_dim) of the Mamba2 mixer."""
    sp = cfg.ssm
    d_inner = sp.expand * cfg.d_model
    conv_dim = d_inner + 2 * sp.n_groups * sp.d_state
    return d_inner, d_inner // sp.head_dim, conv_dim


def _schema(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], float]]:
    """name -> (shape, init scale).  Per-layer tensors are stacked on a
    leading L axis (the encoder's on ``cfg.enc_layers``), as in the
    reference's schema."""
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
    if cfg.enc_dec:
        Le = cfg.enc_layers
        s["enc_wq"] = ((Le, d, H, hd), w_scale)
        s["enc_wk"] = ((Le, d, KV, hd), w_scale)
        s["enc_wv"] = ((Le, d, KV, hd), w_scale)
        s["enc_wo"] = ((Le, H, hd, d), o_scale)
        s["enc_w_in"] = ((Le, d, f), w_scale)
        s["enc_w_out"] = ((Le, f, d), o_scale)
        s["enc_ln1"] = ((Le, d), 0.0)
        s["enc_ln2"] = ((Le, d), 0.0)
        s["enc_final_norm"] = ((d,), 0.0)
        s["xattn_wq"] = ((L, d, H, hd), w_scale)
        s["xattn_wk"] = ((L, d, KV, hd), w_scale)
        s["xattn_wv"] = ((L, d, KV, hd), w_scale)
        s["xattn_wo"] = ((L, H, hd, d), o_scale)
        s["ln_x"] = ((L, d), 0.0)
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
        if cfg.enc_dec:
            self.xattn_core = flash.FlashAttention()

    def _params(self, names) -> dict:
        return {n: getattr(self, n) for n in names if hasattr(self, n)}

    def _attention(self, x, angles, mode, cache, pos, window):
        cfg = self.cfg
        cache_k, cache_v = (cache["k"], cache["v"]) if cache else (None, None)
        B, S, d = x.shape
        dt = x.dtype
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        x2 = x.reshape(B * S, d)
        q = heads_in(x2, self.wq, dt).view(B, S, H, hd)
        k = heads_in(x2, self.wk, dt).view(B, S, KV, hd)
        v = heads_in(x2, self.wv, dt).view(B, S, KV, hd)
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
        q = constrain(q, ("batch", None, "heads", "head_dim"))
        if mode == "decode":
            # back to q's layout: caches that shard ``head_dim`` (KV heads
            # that do not divide ``model``) leave the output split there,
            # and DTensor (torch 2.11) cannot flatten (H, hd) split on hd
            out = constrain(cached_decode_attention(
                q, k, v, cache_k, cache_v,
                AttnMask(True, window, pos, pos + 1)),
                ("batch", None, "heads", "head_dim"))
        else:
            q, k, v = _ulysses_in(cfg, q, k, v)
            if mode == "train":
                skip = cfg.flash_block_skip
                out = self.attn_core(q, k, v, causal=True, train=True,
                                     window=window, block_skip=skip,
                                     kv_chunk=512 if skip else 1024)
            else:
                out = self.attn_core(q, k, v, causal=True, window=window)
                write_cache(cache_k, k, 0)
                write_cache(cache_v, v, 0)
            out = _ulysses_out(cfg, out)
        return heads_out(out, self.wo, dt)

    def _cross_attention(self, x, mode, cache, enc_out):
        """Attention of x to the encoder output, bidirectional, with no
        bias, qk-norm or rope: k/v projected from ``enc_out`` in train and
        prefill (which writes them to the ``xk``/``xv`` caches), read from
        those caches in decode."""
        cfg = self.cfg
        B, S, d = x.shape
        dt = x.dtype
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = heads_in(x.reshape(B * S, d), self.xattn_wq, dt).view(B, S, H, hd)
        if mode == "decode":
            out = cached_decode_attention(q, None, None, cache["xk"],
                                          cache["xv"],
                                          AttnMask(False, None, 0, None))
        else:
            F_ = enc_out.shape[1]
            e2 = enc_out.reshape(B * F_, d)
            xk = heads_in(e2, self.xattn_wk, dt).view(B, F_, KV, hd)
            xv = heads_in(e2, self.xattn_wv, dt).view(B, F_, KV, hd)
            q, xk, xv = _ulysses_in(cfg, q, xk, xv)
            out = _ulysses_out(cfg, self.xattn_core(q, xk, xv, causal=False,
                                                    train=mode == "train"))
            if mode == "prefill":
                write_cache(cache["xk"], xk, 0)
                write_cache(cache["xv"], xv, 0)
        return heads_out(out, self.xattn_wo, dt)

    def _ssm(self, x, mode, cache):
        """The Mamba2 mixer; its conv and state caches written in place
        (prefill fills them, decode steps them; training writes none).  On
        a device mesh the mixer returns each process's shard of the new
        states at the caches' placements, and each process writes its own
        shard."""
        p = {n[len("ssm_"):]: t for n, t in self.named_parameters()
             if n.startswith("ssm_")}
        state = ({"conv": cache["conv"].to(x.dtype), "ssm": cache["ssm"]}
                 if mode == "decode" else None)
        out, new = ssm_lib.mamba2_mix(
            p, x, self.cfg, mode="step" if mode == "decode" else "full",
            state=state)
        if mode != "train":
            for nm in ("conv", "ssm"):
                dst, src = cache[nm], new[nm]
                if hasattr(dst, "device_mesh"):
                    dst, src = dst.to_local(), src.redistribute(
                        dst.device_mesh, dst.placements).to_local()
                dst.copy_(src)
        return out

    def forward(self, x, angles, mode, cache=None, pos=0, window=None,
                enc_out=None):
        """``cache``: this layer's views of the cache entries (``k``/``v``,
        ``conv``/``ssm``, ``xk``/``xv``), None in training; ``enc_out``:
        the encoder's output (B, F, d) for cross-attention in train and
        prefill."""
        cfg = self.cfg
        sp = cfg.seq_sharded and mode == "train"

        def rows(t):
            """Megatron-SP (``seq_sharded``, training): ``t`` (B, S, d) on
            the carry's rows, the sequence split over ``model`` (a
            reduce-scatter of a branch's partial sums); ``t`` itself
            otherwise."""
            return constrain(t, SEQ_SP) if sp else t

        def whole(t):
            """The normed carry gathered whole over ``model`` before a
            branch's column-parallel products (left to DTensor, the
            products' redistribution may move weights); ``t`` itself
            without ``seq_sharded``."""
            return constrain(t, ("batch", None, "embed")) if sp else t
        x = rows(x)
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        mix = None
        if cfg.block in ("attn", "hybrid"):
            mix = rows(self._attention(whole(h), angles, mode, cache, pos,
                                       window).view(x.shape))
        if cfg.block in ("ssm", "hybrid"):
            ssm_out = self._ssm(h, mode, cache)
            # both branches on the mixer output's rows, whole over the
            # other axes (the attention's product may be a partial sum)
            mix = ssm_out if mix is None else constrain(
                mix, ("batch", None, "embed")) + ssm_out
        if cfg.block == "hybrid":
            mix = mix * 0.5                   # average the parallel heads
        if cfg.enc_dec:
            xh = rms_norm(x + mix, self.ln_x, cfg.norm_eps)
            mix = mix + rows(self._cross_attention(
                whole(xh), mode, cache, enc_out).view(x.shape))
        p = self._params(("w_in", "w_gate", "w_out"))
        if cfg.parallel_block and cfg.moe is None and cfg.d_ff:
            return rows(x + mix + rows(mlp(whole(h), p, cfg.mlp_act)))
        x = x + mix
        if cfg.moe is not None:
            mo = {"router": self.router, "w_gate": self.moe_w_gate,
                  "w_in": self.moe_w_in, "w_out": self.moe_w_out,
                  **self._params(("shared_w_gate", "shared_w_in",
                                  "shared_w_out", "shared_gate"))}
            return rows(x + rows(moe_lib.moe_ffn(
                whole(rms_norm(x, self.ln2, cfg.norm_eps)), mo, cfg.moe,
                cfg.mlp_act)))
        if cfg.d_ff:
            x = x + rows(mlp(whole(rms_norm(x, self.ln2, cfg.norm_eps)), p,
                             cfg.mlp_act))
        return rows(x)


#: the carry's logical names under ``seq_sharded`` (the reference's)
SEQ_SP = ("batch", "seq_sp", None)


def _ulysses_in(cfg: ModelConfig, q, k, v):
    """DeepSpeed-Ulysses (``cfg.ulysses_attn``, train and prefill, the
    reference's ``_attention_sub``): q resharded to the sequence over
    ``model`` with every head whole (an all-to-all from the heads layout),
    k and v whole over ``model``; the flash wrapper then runs each
    process's queries against every key at their absolute positions
    (``models.flash``).  k and v pass through their heads layout on the
    way: the cross-attention's arrive as partial sums, and their
    gradients, partial over ``model`` under Ulysses, then come back
    reduce-scattered onto that layout (a partial gradient would have
    DTensor gather the projection's weight whole in its backward).
    (q, k, v) themselves without the option."""
    if not cfg.ulysses_attn:
        return q, k, v
    heads, whole = ("batch", None, "kv_heads", "head_dim"), \
        ("batch", None, None, None)
    return (constrain(q, ("batch", "seq_sp", None, None)),
            constrain(constrain(k, heads), whole),
            constrain(constrain(v, heads), whole))


def _ulysses_out(cfg: ModelConfig, out):
    """The attention output back to the heads layout under
    ``cfg.ulysses_attn`` (the all-to-all back); ``out`` itself
    otherwise."""
    if not cfg.ulysses_attn:
        return out
    return constrain(out, ("batch", None, "heads", "head_dim"))


def _split_on(t, dim: int) -> bool:
    """Whether ``t`` is a DTensor that splits its dimension ``dim`` over a
    mesh axis of more than one device."""
    return hasattr(t, "placements") and any(
        p.is_shard(dim) and t.device_mesh.size(i) > 1
        for i, p in enumerate(t.placements))


def heads_in(x2, w, dt):
    """x2 (T, d) projected onto the heads of ``w`` (d, N, hd): (T, N, hd)
    in ``dt``, one product with (N, hd) flattened.  Where a DTensor ``w``
    splits ``head_dim`` (its N heads do not divide ``model``, so the
    reference's rule gives ``model`` to ``head_dim``) the flattened
    dimension would be a strided shard, which DTensor refuses to make in
    some versions (torch 2.11); there each process multiplies its rows of
    x2 by its own (d, N, hd / m) slice flattened, under ``local_map``,
    ``w``'s FSDP shards gathered as DTensor's product gathers them.  The
    gradients: x2's partial over the axes that split ``head_dim``, ``w``'s
    partial over those that split x2's rows."""
    d, N, hd = w.shape
    if not _split_on(w, 2):
        return (x2 @ w.to(dt).reshape(d, N * hd)).view(x2.shape[0], N, hd)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    wp = [Shard(2) if p.is_shard(2) else Replicate() for p in w.placements]
    xp = [Replicate() if p.is_shard() or q.is_shard(1) else q
          for p, q in zip(wp, x2.placements)]
    out = [p if p.is_shard() else q for p, q in zip(wp, xp)]
    gx = [Partial() if p.is_shard() else q for p, q in zip(wp, xp)]
    gw = [Partial() if q.is_shard(0) else p for p, q in zip(wp, xp)]
    return local_map(
        lambda x_, w_: (x_ @ w_.to(dt).reshape(d, -1)).view(
            x_.shape[0], N, -1),
        out_placements=out, in_placements=(xp, wp),
        in_grad_placements=(gx, gw), device_mesh=w.device_mesh,
        redistribute_inputs=True)(x2, w)


def heads_out(o, w, dt):
    """The output projection: ``o`` (..., N, hd), the heads' outputs, times
    ``w`` (N, hd, d) summed over (N, hd): (T, d) in ``dt``, T the product
    of o's leading dimensions.  Where a DTensor ``w`` splits ``head_dim``,
    each process multiplies its local slices flattened (as
    :func:`heads_in`) and the (T, d) partial sums are left to DTensor;
    ``w``'s gradient is partial over the axes that split o's rows."""
    N, hd, d = w.shape
    T = o.numel() // (N * hd)
    if not _split_on(w, 1):
        return o.reshape(T, N * hd) @ w.to(dt).reshape(N * hd, d)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    wp = [Shard(1) if p.is_shard(1) else Replicate() for p in w.placements]
    op = [Shard(o.ndim - 1) if p.is_shard() else q if q.is_shard(0)
          else Replicate() for p, q in zip(wp, o.placements)]
    out = [Partial() if p.is_shard() else q for p, q in zip(wp, op)]
    gw = [Partial() if q.is_shard(0) else p for p, q in zip(wp, op)]
    return local_map(
        lambda o_, w_: o_.reshape(-1, o_.shape[-2] * o_.shape[-1])
        @ w_.to(dt).reshape(-1, d),
        out_placements=out, in_placements=(op, wp),
        in_grad_placements=(op, gw), device_mesh=w.device_mesh,
        redistribute_inputs=True)(o, w)


class EncoderLayer(nn.Module):
    """One encoder layer of an encoder-decoder: RMSNorm, bidirectional
    attention (through its own ``attn_core``, so hooks see it) and ``wo``,
    then RMSNorm and the gelu MLP, each added to the residual.  Its
    parameters are the schema's ``enc_*`` keys, one layer's slice each."""

    def __init__(self, cfg: ModelConfig, tensors: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, t in tensors.items():
            self.register_parameter(name, _param(t))
        self.attn_core = flash.FlashAttention()

    def forward(self, x, train: bool):
        cfg = self.cfg
        B, F_, d = x.shape
        dt = x.dtype
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = rms_norm(x, self.enc_ln1, cfg.norm_eps).reshape(B * F_, d)
        q = heads_in(h, self.enc_wq, dt).view(B, F_, H, hd)
        k = heads_in(h, self.enc_wk, dt).view(B, F_, KV, hd)
        v = heads_in(h, self.enc_wv, dt).view(B, F_, KV, hd)
        out = self.attn_core(q, k, v, causal=False, train=train)
        x = x + heads_out(out, self.enc_wo, dt).view(B, F_, d)
        h2 = rms_norm(x, self.enc_ln2, cfg.norm_eps)
        return x + mlp(h2, {"w_in": self.enc_w_in, "w_out": self.enc_w_out},
                       "gelu")


class Model(nn.Module):
    """The stack: ``embed``, ``layers`` (a ``ModuleList`` of
    :class:`DecoderLayer`), ``final_norm`` and, untied, ``lm_head``; for an
    encoder-decoder also ``enc_layers`` (of :class:`EncoderLayer`) and
    ``enc_final_norm``.  ``tensors``: the schema's tensors by name, a
    per-layer one stacked on its leading axis or as a list of one tensor a
    layer.  ``mesh``: the ``DistMesh`` the parameters are DTensors on, or
    None."""

    def __init__(self, cfg: ModelConfig, tensors: dict,
                 mesh: DistMesh | None = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        for name in GLOBAL_KEYS:
            if name in tensors:
                self.register_parameter(name, _param(tensors[name]))
        per_layer = {n: t for n, t in tensors.items()
                     if n not in GLOBAL_KEYS and n not in ENC_KEYS}
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, {n: t[i] for n, t in per_layer.items()})
            for i in range(cfg.num_layers))
        if cfg.enc_dec:
            enc = {n: t for n, t in tensors.items() if n in ENC_KEYS}
            self.enc_layers = nn.ModuleList(
                EncoderLayer(cfg, {n: t[i] for n, t in enc.items()})
                for i in range(cfg.enc_layers))


# ------------------------------------------------------------ construction
def device_mesh_for(cfg: ModelConfig, mesh) -> DistMesh | None:
    """``mesh`` if it is a device mesh (a ``DistMesh``), else None (no
    mesh, or an abstract one: nothing to place).  Every block trains and
    serves on a device mesh: attention (the dense family, the MoE and the
    encoder-decoder, with ``ulysses_attn`` and ``seq_sharded`` or
    without), the SSM (Mamba2) and the hybrid (Hymba).  Raises
    ``NotImplementedError`` for the SSM and hybrid blocks with either
    sequence option (ROADMAP A16: the reference constrains the SSM
    branch's carry too), and nothing is replicated in their place."""
    if not isinstance(mesh, DistMesh):
        return None
    if cfg.block != "attn" and (cfg.ulysses_attn or cfg.seq_sharded):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.block} block with ulysses_attn or "
            f"seq_sharded on the {mesh.name} device mesh is not ported, in "
            f"serving or training (ROADMAP A16: the sequence options on the "
            f"SSM and hybrid blocks)")
    return mesh


def _place(name: str, t: torch.Tensor, mesh: DistMesh | None,
           layer: bool = False) -> torch.Tensor:
    """Schema tensor ``name`` (one layer's slice of it with ``layer``),
    which every process holds whole and alike: on ``mesh`` a DTensor placed
    by :func:`param_logical` (each process keeps its slice), else ``t``
    itself."""
    if mesh is None:
        return t
    return distribute(t, LOGICAL[name][1:] if layer else LOGICAL[name], mesh)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype | None = None, mesh=None) -> Model:
    """A :class:`Model` with the reference's init rule (normal * scale, zero
    where the scale is 0, 0.5 for the SSM's A_log, dt_bias and D) drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``, on
    ``device`` (the card unless the caller asks for the CPU).  The numbers
    differ from ``jax.random``'s.  ``dtype`` is the storage of matrices,
    embedding and biases (default the compute dtype; training passes
    ``torch.float32`` for fp32 master weights).  Per-layer tensors are drawn
    one layer's slice at a time, in the same order with or without a mesh,
    so every mesh of the same device type holds the same numbers.  With
    ``mesh`` (a ``DistMesh``) every process draws each slice on its device
    and keeps its shard of it (DTensors placed by :func:`param_logical`,
    under the current rules; :func:`device_mesh_for` first): no process
    ever holds a whole stacked tensor."""
    mesh = device_mesh_for(cfg, mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    generator = torch.Generator(device=dev).manual_seed(seed)

    def draw(name, shape, scale, sd):
        if scale == 0.0:
            return torch.zeros(shape, dtype=sd, device=dev)
        if name.endswith(("A_log", "dt_bias", "D")):
            return torch.full(shape, 0.5, dtype=sd, device=dev)
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev).mul_(scale).to(sd))

    tensors = {}
    for name, (shape, scale) in sorted(_schema(cfg).items()):
        sd = _store_dtype(name, dtype)
        tensors[name] = (
            _place(name, draw(name, shape, scale, sd), mesh)
            if name in GLOBAL_KEYS else
            [_place(name, draw(name, shape[1:], scale, sd), mesh, layer=True)
             for _ in range(shape[0])])
    return Model(cfg, tensors, mesh)


def params_from_numpy(cfg: ModelConfig, params: dict, *, device="cuda",
                      dtype: torch.dtype | None = None, mesh=None) -> Model:
    """A :class:`Model` holding the reference's flat parameter dict (numpy
    arrays, per-layer tensors stacked on a leading L axis), matrices,
    embedding and biases in ``dtype`` (default the compute dtype), norm
    scales in fp32, on ``device`` (the card unless the caller asks for the
    CPU); with ``mesh`` (a ``DistMesh``) as DTensors placed by
    :func:`param_logical`, as :func:`init_params`."""
    mesh = device_mesh_for(cfg, mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    dtype = COMPUTE_DTYPE if dtype is None else dtype
    tensors = {}
    for name, (shape, _) in _schema(cfg).items():
        arr = np.array(params[name], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: want shape {shape}, got {arr.shape}")
        tensors[name] = _place(name, torch.from_numpy(arr).to(
            device=dev, dtype=_store_dtype(name, dtype)), mesh)
    return Model(cfg, tensors, mesh)


def _layer_names(cfg: ModelConfig, name: str) -> list[str]:
    """The :class:`Model` parameter names of a per-layer schema key, one a
    layer: ``enc_layers.<i>.<key>`` for the encoder's keys (the reference's
    ``_split_layer_params``), ``layers.<i>.<key>`` for the others."""
    if name in ENC_KEYS:
        return [f"enc_layers.{i}.{name}" for i in range(cfg.enc_layers)]
    return [f"layers.{i}.{name}" for i in range(cfg.num_layers)]


def stack_layers(cfg: ModelConfig, named: dict, stack=torch.stack
                 ) -> dict[str, torch.Tensor]:
    """Tensors keyed by :class:`Model` parameter name (``embed``,
    ``layers.<i>.<key>``, ``enc_layers.<i>.<key>``) -> the reference's flat
    names, per-layer tensors stacked on a leading L (or ``enc_layers``)
    axis by ``stack`` (of the list of a key's layers; default a copy on
    their device)."""
    return {name: named[name] if name in GLOBAL_KEYS else
            stack([named[n] for n in _layer_names(cfg, name)])
            for name in _schema(cfg)}


def unstack_layers(cfg: ModelConfig, flat: dict) -> dict[str, torch.Tensor]:
    """The inverse of :func:`stack_layers`: the reference's flat names ->
    :class:`Model` parameter names (per-layer views of the stacked
    tensors)."""
    out = {}
    for name in _schema(cfg):
        if name in GLOBAL_KEYS:
            out[name] = flat[name]
        else:
            for i, n in enumerate(_layer_names(cfg, name)):
                out[n] = flat[name][i]
    return out


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor gathered (a collective: every process of its
    mesh calls it), another tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def params_to_numpy(params: Model) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: the reference's flat
    parameter dict, fp32 numpy arrays with per-layer tensors stacked on the
    L axis (DTensors gathered whole on every process, a layer at a
    time)."""
    named = {n: p.detach() for n, p in params.named_parameters()}
    return {name: full_tensor(t).float().cpu().numpy() if name in GLOBAL_KEYS
            else np.stack([full_tensor(x).float().cpu().numpy() for x in t])
            for name, t in stack_layers(params.cfg, named, list).items()}


def abstract_params(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """fp32 tensors on the meta device in the reference's flat, stacked
    layout: shapes and dtypes, no allocation."""
    return {name: torch.empty(shape, dtype=torch.float32, device="meta")
            for name, (shape, _) in _schema(cfg).items()}


def param_logical(cfg: ModelConfig) -> dict[str, tuple]:
    """The reference's logical axis names per parameter (:data:`LOGICAL`)."""
    return {name: LOGICAL[name] for name in _schema(cfg)}


# ------------------------------------------------------------------ caches
def _zeros(shape: tuple, dtype: torch.dtype, device, mesh: DistMesh | None,
           logical: tuple) -> torch.Tensor:
    """A zeroed tensor of ``shape``; on ``mesh`` a DTensor placed by
    ``logical`` under the current rules, each process allocating its shard
    only."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    placements = mesh_placements(shape, logical, mesh)
    local = list(shape)
    for axis, p in zip(mesh.axis_names, placements):
        if p.is_shard():
            local[p.dim] //= mesh.shape[axis]
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=mesh.device),
        mesh.device_mesh, placements, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _empty_caches(cfg: ModelConfig, batch: int, length: int, device,
                  frames: int | None = None, mesh: DistMesh | None = None
                  ) -> dict[str, torch.Tensor]:
    """Zeroed per-layer caches: for attention KV (L, batch, length, KV, hd)
    in the compute dtype; for the SSM the conv inputs (L, batch, K-1,
    conv_dim) in the compute dtype and the state (L, batch, nh, hp, ds) in
    fp32; for an encoder-decoder the cross-attention KV ``xk``/``xv`` (L,
    batch, frames, KV, hd) in the compute dtype, ``frames`` defaulting to
    ``cfg.enc_frames`` (the reference's keys and shapes).  On ``mesh``
    DTensors placed by :func:`cache_logical`."""
    L = cfg.num_layers
    shapes = {}
    if cfg.block in ("attn", "hybrid"):
        shape = (L, batch, length, cfg.num_kv_heads, cfg.head_dim)
        shapes["k"] = shapes["v"] = (shape, COMPUTE_DTYPE)
    if cfg.block in ("ssm", "hybrid"):
        sp = cfg.ssm
        _, nh, conv_dim = _ssm_dims(cfg)
        shapes["conv"] = ((L, batch, sp.conv_width - 1, conv_dim),
                          COMPUTE_DTYPE)
        shapes["ssm"] = ((L, batch, nh, sp.head_dim, sp.d_state),
                         torch.float32)
    if cfg.enc_dec:
        shape = (L, batch, cfg.enc_frames if frames is None else frames,
                 cfg.num_kv_heads, cfg.head_dim)
        shapes["xk"] = shapes["xv"] = (shape, COMPUTE_DTYPE)
    logical = cache_logical(cfg)
    return {nm: _zeros(shape, dt, device, mesh, logical[nm])
            for nm, (shape, dt) in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", mesh=None) -> dict:
    """Decode state: full-length KV caches, the SSM's conv and state caches,
    an encoder-decoder's cross-attention KV over ``cfg.enc_frames`` and the
    next position (a host int).  With ``mesh`` (a ``DistMesh``) the caches
    are DTensors placed by :func:`cache_logical` under the current rules,
    on the mesh's devices."""
    mesh = device_mesh_for(cfg, mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    cache = _empty_caches(cfg, batch, max_len, dev, mesh=mesh)
    cache["pos"] = 0
    return cache


def cache_logical(cfg: ModelConfig) -> dict[str, tuple]:
    """The reference's logical axis names per cache entry: the placements
    of the caches on a device mesh (:func:`init_cache`, the prefill's)."""
    names: dict[str, tuple] = {"pos": ()}
    if cfg.block in ("attn", "hybrid"):
        names["k"] = (None, "batch", None, "kv_heads", "head_dim")
        names["v"] = (None, "batch", None, "kv_heads", "head_dim")
    if cfg.block in ("ssm", "hybrid"):
        names["conv"] = (None, "batch", None, "mlp")
        names["ssm"] = (None, "batch", "heads", None, "state")
    if cfg.enc_dec:
        names["xk"] = (None, "batch", None, "kv_heads", "head_dim")
        names["xv"] = (None, "batch", None, "kv_heads", "head_dim")
    return names


# ----------------------------------------------------------------- forward
def _remat_context(cfg: ModelConfig):
    """``context_fn`` of ``torch.utils.checkpoint`` for ``cfg.remat``:
    ``"full"`` saves nothing inside the layer (the default contexts);
    ``"dots"`` saves the outputs of the weight products (``aten.mm`` and
    ``aten.addmm``, the reference's ``dots_with_no_batch_dims_saveable``)
    and recomputes the rest, attention included: the experts' ``torch.bmm``
    and the SSD's batched fp32 products have a batch dimension, so they are
    recomputed, as the reference recomputes its batched dots."""
    if cfg.remat != "dots":
        return torch_checkpoint.noop_context_fn
    policy_cls = torch_checkpoint.CheckpointPolicy
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (policy_cls.MUST_SAVE if op in saved
                else policy_cls.PREFER_RECOMPUTE)
    return functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, policy)


def _layer_call(cfg: ModelConfig, train: bool, layer, *args):
    """``layer(*args)``, under ``torch.utils.checkpoint`` when training
    with ``cfg.remat`` other than ``"none"``."""
    if not train or cfg.remat == "none":
        return layer(*args)
    return torch_checkpoint.checkpoint(layer, *args, use_reentrant=False,
                                       context_fn=_remat_context(cfg))


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embeddings (..., d) fp32: sin then cos of
    position x 10000^(-i / (d/2 - 1)), the reference's."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder(params: Model, cfg: ModelConfig, frames: torch.Tensor,
             train: bool) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, F, d): frames plus
    sinusoidal positions in fp32, cast to the compute dtype, the
    :class:`EncoderLayer` stack (each under ``torch.utils.checkpoint`` when
    training with remat, as the reference's ``jax.checkpoint``), then
    ``enc_final_norm``."""
    B, F_, d = frames.shape
    dev = params.embed.device
    if not hasattr(frames, "device_mesh"):
        frames = frames.to(device=dev)
    x = _replicated(params, frames, ("batch", None, "embed")).float()
    pos = _replicated(params, _sinusoidal(torch.arange(F_, device=dev), d),
                      (None, "embed"))
    x = (x + pos).to(COMPUTE_DTYPE)
    for layer in params.enc_layers:
        x = _layer_call(cfg, train, layer, x, train)
    return rms_norm(x, params.enc_final_norm, cfg.norm_eps)


def _train_layers(params: Model, cfg: ModelConfig, x, angles, enc_out):
    """The decoder stack with autograd on, each layer under
    ``torch.utils.checkpoint`` unless ``cfg.remat == "none"``."""
    for layer, window in zip(params.layers, layer_windows(cfg)):
        x = _layer_call(cfg, True, layer, x, angles, "train", None, 0,
                        window, enc_out)
    return x


def model_forward(params: Model, cfg: ModelConfig, tokens: torch.Tensor, *,
                  mode: str, visual: torch.Tensor | None = None,
                  mrope_positions: torch.Tensor | None = None,
                  frames: torch.Tensor | None = None,
                  cache: dict | None = None, max_len: int | None = None,
                  return_hidden: bool = False):
    """Returns (logits, new_cache).

    ``visual`` (B, V, d), with ``cfg.vlm``: patch embeddings that take the
    place of the first V token embeddings.  ``mrope_positions`` (3, B, S),
    with ``cfg.rope == "mrope"``: each stream's positions (default
    pos0 + arange(S) in all three, the reference's, as in decode).  Each
    layer attends under its window (:func:`layer_windows`).  ``frames``
    (B, F, d), with ``cfg.enc_dec``: the encoder's input frame embeddings,
    needed in train and prefill (decode reads the cross-attention KV that
    prefill cached).

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
    if mode == "train" and cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")
    if cfg.enc_dec and mode != "decode" and frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: mode={mode!r} "
                         f"needs frames (B, F, d_model)")
    if params.mesh is not None:
        device_mesh_for(cfg, params.mesh)
        with set_mesh(params.mesh):
            return _forward(params, cfg, tokens, mode, visual,
                            mrope_positions, frames, cache, max_len,
                            return_hidden)
    return _forward(params, cfg, tokens, mode, visual, mrope_positions,
                    frames, cache, max_len, return_hidden)


def _replicated(params: Model, t, logical):
    """A tensor every process computed whole and alike (rope angles, the
    visual prefix, a batch), on the parameters' mesh under ``logical``;
    ``t`` itself for a model off any mesh or a tensor already there."""
    if params.mesh is None or t is None or hasattr(t, "device_mesh"):
        return t
    return distribute(t, logical, params.mesh)


def _embed(params: Model, tokens: torch.Tensor, dt) -> torch.Tensor:
    """The token embeddings in ``dt``.  On a mesh, a table sharded on
    ``vocab`` alone (serving's TP-only rules) is looked up by
    :func:`_vocab_parallel_embed`; otherwise the lookup reads the table
    gathered whole (DTensor has no rule for a gather from a table sharded on
    both dimensions), and the gradient comes back as the parameter's, summed
    in fp32 as the plain lookup's."""
    if params.mesh is None:
        return params.embed[tokens.long()].to(dt)
    table = params.embed
    if not any(p.is_shard(1) for p in table.placements) and not any(
            p.is_shard(0) for p, q in zip(table.placements, tokens.placements)
            if q.is_shard()):
        return _vocab_parallel_embed(params.mesh, table, tokens, dt)
    from torch.distributed.tensor import Replicate
    table = table.redistribute(
        params.mesh.device_mesh, [Replicate()] * len(params.mesh.axis_names))
    return torch.nn.functional.embedding(tokens.long(), table).to(dt)


def _vocab_parallel_embed(mesh: DistMesh, table, tokens, dt):
    """The lookup of DTensor ``tokens`` (B, S) in a DTensor ``table``
    (Vp, d) sharded on its rows alone, over mesh axes that do not split the
    tokens: each process reads the ids its rows hold, zeros elsewhere, and
    the sum over the table's axes (one non-zero summand per element) is the
    plain lookup, bit for bit, with no copy of the table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    rows = table.to_local()
    ids = tokens.to_local().long()
    first = 0
    for axis, p in zip(mesh.axis_names, table.placements):
        if p.is_shard(0):
            first = (first * mesh.shape[axis]
                     + mesh.device_mesh.get_local_rank(axis))
    first *= rows.shape[0]
    local = ids - first
    mine = (local >= 0) & (local < rows.shape[0])
    x = torch.where(mine[..., None],
                    rows[local.clamp(0, rows.shape[0] - 1)].to(dt), 0)
    out = [Partial() if p.is_shard(0) else q
           for p, q in zip(table.placements, tokens.placements)]
    shape = (*tokens.shape, table.shape[1])
    x = DTensor.from_local(x, mesh.device_mesh, out, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    return x.redistribute(mesh.device_mesh, [Replicate() if p.is_partial()
                                             else p for p in out])


def _forward(params: Model, cfg: ModelConfig, tokens, mode, visual,
             mrope_positions, frames, cache, max_len, return_hidden):
    B, S = tokens.shape
    dt = COMPUTE_DTYPE
    dev = params.embed.device
    tokens = _replicated(params, tokens, ("batch", None))
    with contextlib.nullcontext() if mode == "train" else torch.no_grad():
        if mode == "decode":
            pos0 = int(cache["pos"])
            caches = cache
        else:
            pos0 = 0
            caches = (None if mode == "train" else
                      _empty_caches(cfg, B, max(S, max_len or S), dev,
                                    None if frames is None
                                    else frames.shape[1], params.mesh))
        x = _embed(params, tokens, dt)
        if cfg.vlm and visual is not None:
            V = visual.shape[1]
            vis = _replicated(params, visual.to(device=dev, dtype=dt),
                              ("batch", None, "embed"))
            x = torch.cat([vis, x[:, V:]], dim=1)
        x = constrain(x, ("batch", "seq", "embed"))
        angles = None
        if cfg.rope in ("rope", "mrope"):
            positions = (pos0 + torch.arange(S, device=dev))[None].expand(B, S)
            if cfg.rope == "mrope":
                if hasattr(mrope_positions, "full_tensor"):
                    mrope_positions = mrope_positions.full_tensor()
                if mrope_positions is None:
                    mrope_positions = positions[None].expand(3, B, S)
                angles = rope_angles(mrope_positions.to(dev), cfg.head_dim,
                                     cfg.rope_theta, cfg.mrope_sections)
            else:
                angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            angles = _replicated(params, angles, ("batch", None, None))
        enc_out = (_encoder(params, cfg, frames, mode == "train")
                   if cfg.enc_dec and mode != "decode" else None)
        if mode == "train":
            x = rms_norm(_train_layers(params, cfg, x, angles, enc_out),
                         params.final_norm, cfg.norm_eps)
            return (x if return_hidden else _head_logits(params, cfg, x)), None
        for i, (layer, window) in enumerate(zip(params.layers,
                                                layer_windows(cfg))):
            x = layer(x, angles, mode, {nm: caches[nm][i] for nm in
                                        CACHE_KEYS if nm in caches},
                      pos0, window, enc_out)
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
    logits = constrain(x @ head.to(x.dtype), ("batch", None, "vocab"))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# -------------------------------------------------------------------- loss
def lm_loss(params: Model, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy through the fused chunked loss (full
    (B, S, V) logits are never materialized; see ``models.loss``).  batch:
    ``tokens`` and ``labels`` (B, S), label -1 masked, for a VLM
    ``visual`` and ``mrope_positions``, for an encoder-decoder ``frames``
    (:func:`model_forward`).  Returns (loss, {"loss", "tokens"}),
    differentiable in the parameters."""
    hidden, _ = model_forward(params, cfg, batch["tokens"], mode="train",
                              visual=batch.get("visual"),
                              mrope_positions=batch.get("mrope_positions"),
                              frames=batch.get("frames"), return_hidden=True)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    labels = _replicated(params, batch["labels"], ("batch", None))
    loss, tokens = fused_ce_loss(hidden, head.to(hidden.dtype), labels,
                                 valid_vocab=cfg.vocab_size)
    return loss, {"loss": loss, "tokens": tokens}
