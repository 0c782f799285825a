"""Whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865 —
encoder-decoder; conv/mel frontend is a stub (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", source="arXiv:2212.04356",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    enc_dec=True, enc_layers=12, enc_frames=1500,
    mlp_act="gelu", rope="none",       # sinusoidal positions (see DESIGN.md)
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="audio", source="reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    enc_dec=True, enc_layers=2, enc_frames=32,
    mlp_act="gelu", rope="none",
    tie_embeddings=True,
)
