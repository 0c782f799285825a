"""Qwen2-VL-7B [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution (vision frontend is a stub:
input_specs provides precomputed patch embeddings).  [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", source="arXiv:2409.12191",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope="mrope", rope_theta=1e6, mrope_sections=(16, 24, 24),
    vlm=True, visual_prefix=1024,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke", family="vlm", source="reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    qkv_bias=True, rope="mrope", rope_theta=1e6, mrope_sections=(2, 3, 3),
    vlm=True, visual_prefix=8,
    tie_embeddings=False,
)
