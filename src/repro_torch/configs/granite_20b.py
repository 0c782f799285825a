"""Granite-20B (code) [dense]: 52L d_model=6144 48H (MQA kv=1)
d_ff=24576 vocab=49152 — llama-style stack with multi-query attention.
[arXiv:2405.04324; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense", source="arXiv:2405.04324",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    mlp_act="gelu", rope="rope", rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-20b-smoke", family="dense", source="reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=512,
    mlp_act="gelu", rope="rope",
    tie_embeddings=True,
)
