"""Assigned input shapes, abstract input specs for every architecture and
concrete demo inputs.

The port's twin of ``repro.launch.shapes``.  Four shapes per LM arch (40
cells total):
  train_4k    : train_step,  seq 4096,  global_batch 256
  prefill_32k : prefill_step, seq 32768, global_batch 32
  decode_32k  : decode_step, KV cache 32768, global_batch 128
  long_500k   : decode_step, cache 524288, global_batch 1 — sub-quadratic
                archs only (SSM / hybrid); skipped for pure full-attention
                archs per the assignment.
:func:`batch_specs` gives a cell's inputs as meta tensors (the port's
``ShapeDtypeStruct``: shapes and dtypes, no allocation).  Random token ids
of :func:`demo_batch` come from a ``torch.Generator`` and differ from
``jax.random``'s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """None if the (arch, shape) cell runs; else why it is skipped."""
    if shape.name == "long_500k":
        if cfg.block == "attn" and (cfg.sliding_window is None
                                    or cfg.global_every is not None):
            return ("pure full-attention arch: 500k decode requires "
                    "sub-quadratic attention (assignment rule)")
        if cfg.enc_dec:
            return "enc-dec full attention: 500k decode out of scope"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """One cell's model inputs as meta tensors, with the reference's keys,
    shapes and dtypes: int32 ``tokens`` (and ``labels`` in train), a VLM's
    fp32 ``visual`` and int32 ``mrope_positions``, an encoder-decoder's fp32
    ``frames``; decode takes one token per row and a ``cache`` of
    ``seq_len`` positions (``init_cache`` on the meta device) whose ``pos``
    is the reference's int32 scalar."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        cache = init_cache(cfg, B, S, device="meta")
        cache["pos"] = _meta((), I32)
        return {"tokens": _meta((B, 1), I32), "cache": cache}
    specs = {"tokens": _meta((B, S), I32)}
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), I32)
    if cfg.vlm:
        specs["visual"] = _meta((B, cfg.visual_prefix, cfg.d_model), F32)
        specs["mrope_positions"] = _meta((3, B, S), I32)
    if cfg.enc_dec:
        specs["frames"] = _meta((B, cfg.enc_frames, cfg.d_model), F32)
    return specs


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
