"""Granite-MoE-3B-A800M [moe]: 32L d_model=1536 24H (GQA kv=8)
d_ff_expert=512 vocab=49155, 40 routed experts top-8 (no shared experts;
top-k gate renormalized).  [hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from repro_torch.models.config import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=0, vocab_size=49155,
    rope="rope", rope_theta=1e4,
    moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512, num_shared=0,
                router_norm=True),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe", source="reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=0, vocab_size=512,
    rope="rope",
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=32, num_shared=0,
                router_norm=True),
    tie_embeddings=True,
)
