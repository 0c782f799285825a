"""Serving steps: batched prefill (last-position logits + a KV cache padded
to the decode horizon), single-token decode, and a batched greedy loop.

The port's twin of the LM half of ``repro.serve.step``;
``make_bitmap_query_step`` waits for the service (ROADMAP A6)."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import model_forward


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    def prefill_step(params, batch):
        return model_forward(params, cfg, batch["tokens"], mode="prefill",
                             max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, batch):
        return model_forward(params, cfg, batch["tokens"],
                             cache=batch["cache"], mode="decode")
    return decode_step


def greedy_generate(params, cfg: ModelConfig, tokens: torch.Tensor,
                    steps: int, max_len: int | None = None) -> torch.Tensor:
    """Batched greedy loop (prefill + steps - 1 decodes): tokens (B, S) ->
    generated ids (B, steps)."""
    B, S = tokens.shape
    max_len = max_len or (S + steps)
    logits, cache = model_forward(params, cfg, tokens, mode="prefill",
                                  max_len=max_len)
    out = [torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)]
    for _ in range(steps - 1):
        logits, cache = model_forward(params, cfg, out[-1][:, None],
                                      cache=cache, mode="decode")
        out.append(torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1))
    return torch.stack(out, dim=1)
