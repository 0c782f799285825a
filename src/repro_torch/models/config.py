"""Unified architecture description covering all assigned families:
dense / GQA / MQA, MoE (shared+routed), SSM (Mamba2 SSD), hybrid (Hymba),
encoder-decoder (Whisper), VLM prefix (Qwen2-VL M-RoPE), local:global
sliding-window patterns (Gemma3).

The port's copy of ``repro.models.config`` (pure dataclasses, kept
identical).  The port's model serves every family but the encoder-decoder
and trains the dense ones; the rest raise ``NotImplementedError`` in
``repro_torch.models.model``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared experts, fused into one wide MLP
    capacity_factor: float = 1.25
    router_norm: bool = False    # granite normalizes top-k gate weights
    ep_pad: bool = False         # pad expert count to the EP axis size so
                                 # experts shard (60->64, 40->48 on TP=16);
                                 # padded experts receive no tokens.

    def padded_experts(self, axis: int = 16) -> int:
        if not self.ep_pad:
            return self.num_experts
        return -(-self.num_experts // axis) * axis


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block: str = "attn"              # attn | ssm | hybrid
    mlp_act: str = "silu"            # silu (gated) | gelu | geglu (gated gelu)
    qkv_bias: bool = False
    parallel_block: bool = False     # command-r: attn and mlp from one norm
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    sliding_window: int | None = None
    global_every: int | None = None  # gemma3: every Nth layer is global
    qk_norm: bool = False
    logit_softcap: float | None = None
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    enc_dec: bool = False
    enc_layers: int = 0
    enc_frames: int = 1500           # whisper 30 s window
    vlm: bool = False
    visual_prefix: int = 1024        # patch-embedding positions at seq start
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    remat: str = "full"              # none | dots | full (full: recompute the
                                     # layer in bwd — saves only (B,S,d)/layer)
    flash_block_skip: bool = False   # causal chunk skipping (~2x attn FLOPs)
    seq_sharded: bool = False        # shard the residual stream's sequence
                                     # dim over the TP axis (Megatron-SP):
                                     # remat-saved activations / 16
    ulysses_attn: bool = False       # DeepSpeed-Ulysses: reshard q to
                                     # sequence-sharded full-head layout for
                                     # flash (a2a) instead of head_dim TP —
                                     # removes per-block score psums when
                                     # head counts don't divide the TP axis
    # description metadata
    family: str = "dense"
    source: str = ""

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 so the TP axis always divides (Megatron-style)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_is_global(self, i: int) -> bool:
        if self.sliding_window is None:
            return True
        if self.global_every is None:
            return False
        return (i + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.block in ("attn", "hybrid"):
            per_layer += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.block in ("ssm", "hybrid"):
            s = self.ssm
            d_inner = s.expand * d
            nh = d_inner // s.head_dim
            conv_dim = d_inner + 2 * s.n_groups * s.d_state
            per_layer += (d * (2 * d_inner + 2 * s.n_groups * s.d_state + nh)
                          + s.conv_width * conv_dim + 3 * nh
                          + d_inner + d_inner * d)
        if self.moe is not None:
            m = self.moe
            per_layer += d * m.num_experts
            per_layer += m.num_experts * 3 * d * m.d_ff_expert
            if m.num_shared:
                fs = m.num_shared * m.d_ff_expert
                per_layer += 3 * d * fs + d
        elif f:
            gates = 2 if self.mlp_act in ("silu", "geglu") else 1
            per_layer += (gates + 1) * d * f
        per_layer += 2 * d
        n += L * per_layer
        if self.enc_dec:
            enc_per = 2 * (d * self.q_dim + self.q_dim * d) // 2  # self-attn
            # encoder self-attn + mlp + cross-attn params in decoder
            n += self.enc_layers * (d * (self.q_dim + 2 * self.kv_dim)
                                    + self.q_dim * d + 2 * d * f + 2 * d)
            n += L * (d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d + d)
            del enc_per
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.num_layers
        inactive = L * (m.num_experts - m.top_k) * 3 * d * m.d_ff_expert
        return self.param_count() - inactive
