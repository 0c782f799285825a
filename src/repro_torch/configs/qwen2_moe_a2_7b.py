"""Qwen2-MoE-A2.7B [moe]: 24L d_model=2048 16H (kv=16) d_ff_expert=1408
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=151936,
    qkv_bias=True, rope="rope", rope_theta=1e6,
    moe=MoESpec(num_experts=60, top_k=4, d_ff_expert=1408, num_shared=4),
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe", source="reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512,
    qkv_bias=True, rope="rope",
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=32, num_shared=2),
    tie_embeddings=False,
)
