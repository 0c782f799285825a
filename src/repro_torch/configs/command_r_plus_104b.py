"""Command-R-Plus-104B [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attn+FFN block.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    source="hf:CohereForAI/c4ai-command-r-plus",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    parallel_block=True, rope="rope", rope_theta=75e6, mlp_act="silu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="command-r-plus-smoke", family="dense", source="reduced",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512,
    parallel_block=True, rope="rope", mlp_act="silu",
    tie_embeddings=True,
)
