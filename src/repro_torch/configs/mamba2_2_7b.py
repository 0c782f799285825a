"""Mamba2-2.7B [ssm]: 64L d_model=2560 attention-free, d_ff=0,
vocab=50280, ssm_state=128 — SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", source="arXiv:2405.21060",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    block="ssm", rope="none",
    ssm=SSMSpec(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=128,
                n_groups=1),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm", source="reduced",
    num_layers=3, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512,
    block="ssm", rope="none",
    ssm=SSMSpec(d_state=16, head_dim=8, expand=2, conv_width=4, chunk=16,
                n_groups=1),
    tie_embeddings=True,
)
