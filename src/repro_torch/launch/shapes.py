"""Concrete demo inputs for the model's modes.

The port's twin of ``repro.launch.shapes.demo_batch`` (the abstract input
specs and the assigned cell shapes wait for ROADMAP A10.5).  Random token
ids come from a ``torch.Generator`` and differ from ``jax.random``'s.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported, init_cache


def demo_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
               generator: torch.Generator) -> dict:
    """Small concrete inputs on the generator's device.  ``train``: int32
    ``tokens`` (batch, seq) and ``labels`` = tokens rolled by -1 along the
    sequence; ``prefill``: tokens; ``decode``: one token per row and an
    empty cache of ``seq`` positions."""
    check_supported(cfg)
    dev = generator.device
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                         device=dev, dtype=torch.int32)
    if kind == "train":
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if kind == "prefill":
        return {"tokens": toks}
    if kind == "decode":
        return {"tokens": toks[:, :1],
                "cache": init_cache(cfg, batch, seq, device=dev)}
    raise ValueError(f"kind must be train, prefill or decode, got {kind!r}")
