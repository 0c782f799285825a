"""Gemma3-4B [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context,
GeGLU, qk-norm.  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense", source="hf:google/gemma-3-4b-pt",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    mlp_act="geglu", qk_norm=True,
    sliding_window=1024, global_every=6, rope="rope", rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-4b-smoke", family="dense", source="reduced",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    mlp_act="geglu", qk_norm=True,
    sliding_window=16, global_every=6, rope="rope",
    tie_embeddings=True,
)
