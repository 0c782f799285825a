"""Concrete demo inputs for the model's modes.

The port's twin of ``repro.launch.shapes.demo_batch`` (the abstract input
specs and the assigned cell shapes wait for ROADMAP A10.5).  Random token
ids come from a ``torch.Generator`` and differ from ``jax.random``'s.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache


def demo_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
               generator: torch.Generator) -> dict:
    """Small concrete inputs on the generator's device.  ``train``: int32
    ``tokens`` (batch, seq) and ``labels`` = tokens rolled by -1 along the
    sequence; ``prefill``: tokens; ``decode``: one token per row and an
    empty cache of ``seq`` positions.  A VLM's train and prefill batches
    also hold ``visual`` (batch, visual_prefix, d_model) fp32 patch
    embeddings, standard normal x 0.02, and ``mrope_positions`` (3, batch,
    seq) int32, arange(seq) in every stream; an encoder-decoder's also hold
    ``frames`` (batch, enc_frames, d_model) fp32 frame embeddings, standard
    normal x 0.02."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")
    dev = generator.device
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                         device=dev, dtype=torch.int32)
    if kind == "decode":
        return {"tokens": toks[:, :1],
                "cache": init_cache(cfg, batch, seq, device=dev)}
    out = {"tokens": toks}
    if kind == "train":
        out["labels"] = torch.roll(toks, -1, dims=1)
    if cfg.vlm:
        out["visual"] = torch.randn(
            (batch, cfg.visual_prefix, cfg.d_model), generator=generator,
            device=dev, dtype=torch.float32) * 0.02
        out["mrope_positions"] = torch.arange(
            seq, dtype=torch.int32, device=dev)[None, None].expand(
                3, batch, seq).contiguous()
    if cfg.enc_dec:
        out["frames"] = torch.randn(
            (batch, cfg.enc_frames, cfg.d_model), generator=generator,
            device=dev, dtype=torch.float32) * 0.02
    return out
