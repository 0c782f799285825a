"""Hymba-1.5B [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + Mamba heads in every
layer; sliding-window attention except 3 global layers (first/middle/last).
[arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", source="arXiv:2411.13676",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    block="hybrid",
    ssm=SSMSpec(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=128,
                n_groups=1),
    sliding_window=1024, rope="rope", rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid", source="reduced",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    block="hybrid",
    ssm=SSMSpec(d_state=8, head_dim=8, expand=2, conv_width=4, chunk=16,
                n_groups=1),
    sliding_window=16, rope="rope",
    tie_embeddings=True,
)
