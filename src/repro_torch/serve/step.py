"""Serving steps: batched prefill (last-position logits + a cache: KV padded
to the decode horizon, an SSM's conv and state caches, and an
encoder-decoder's cross-attention KV), single-token
decode, a batched greedy loop, and
batched structured retrieval over a bitmap index (the paper's query
workload served through the engine's bucketed batch executor).

The port's twin of ``repro.serve.step``."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import model_forward


def make_prefill_step(cfg: ModelConfig, max_len: int | None = None):
    def prefill_step(params, batch):
        return model_forward(params, cfg, batch["tokens"], mode="prefill",
                             visual=batch.get("visual"),
                             mrope_positions=batch.get("mrope_positions"),
                             frames=batch.get("frames"), max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, batch):
        return model_forward(params, cfg, batch["tokens"],
                             cache=batch["cache"], mode="decode")
    return decode_step


def make_bitmap_query_step(index, *, backend: str = "auto"):
    """Batched structured-retrieval step over a bitmap index: the returned
    ``query_step(queries)`` serves many queries per dispatch (plan-shape
    bucketing through the :mod:`repro_torch.db` facade) and yields
    (rows (Q, Nw) int32, counts (Q,) int32) in request order.  Queries are
    engine predicate trees, pre-built plans, or (when the session carries a
    schema) ``repro_torch.db`` expressions.

    A thin shim over a synchronous one-shot
    :class:`repro_torch.serve.service.BitmapService` (``background=False``:
    no threads, no deferred maintenance — appends keep their synchronous
    spill semantics): each ``query_step(queries)`` call submits the batch
    and drains it in coalesced dispatches, bit-identical to the direct
    ``query_many`` path.  Callers that want cross-caller coalescing,
    admission control, standby and background maintenance hold the
    service itself — ``BitmapDB.serve()``.

    ``index`` is a :class:`repro_torch.db.BitmapDB` session (served as-is),
    an in-memory :class:`repro_torch.engine.policy.BitmapIndex`, or a
    segment-backed :class:`repro_torch.store.StoredIndex` (served
    segment-parallel)."""
    from repro_torch.serve.service import BitmapService, ServiceConfig

    svc = BitmapService.open(index, backend=backend,
                             config=ServiceConfig(background=False,
                                                  maintenance=False,
                                                  pad_output=False,
                                                  max_batch=1 << 20,
                                                  max_queue=1 << 20))
    db = svc.db

    def query_step(queries):
        futs = [svc.submit(q) for q in queries]
        svc.drain()
        if not futs:
            return db.query_many([]).materialize()
        rows, counts = futs[0]._rows, futs[0]._counts
        if rows is not None \
                and all(f._err is None and f._rows is rows for f in futs) \
                and [f._qi for f in futs] == list(range(len(futs))):
            return rows, counts        # one coalesced batch: zero-copy
        # multiple coalesced batches — or a failed query, which .rows
        # re-raises here exactly as the direct path does
        return (torch.stack([f.rows for f in futs]),
                torch.stack([f.result()[1] for f in futs]))

    query_step.service = svc
    return query_step


def next_ids(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The greedy ids (B,) of the last position of ``logits`` (B, S, Vp),
    over the real vocabulary.  Logits sharded on ``vocab`` (a model on a
    device mesh) are gathered at that position alone, (B, 1, Vp), so every
    process takes the same argmax and holds the ids whole."""
    last = logits[:, -1:]
    if hasattr(last, "full_tensor"):
        last = last.full_tensor()
    return torch.argmax(last[:, -1, :cfg.vocab_size], dim=-1)


def greedy_generate(params, cfg: ModelConfig, tokens: torch.Tensor,
                    steps: int, max_len: int | None = None, **kw
                    ) -> torch.Tensor:
    """Batched greedy loop (prefill + steps - 1 decodes): tokens (B, S) ->
    generated ids (B, steps), whole on every process of a device mesh
    (:func:`next_ids`).  ``kw`` goes to the prefill (a VLM's ``visual``
    and ``mrope_positions``, an encoder-decoder's ``frames``); decode
    positions follow the prefill's, pos0 + arange, in every M-RoPE
    stream."""
    B, S = tokens.shape
    max_len = max_len or (S + steps)
    logits, cache = model_forward(params, cfg, tokens, mode="prefill",
                                  max_len=max_len, **kw)
    out = [next_ids(logits, cfg)]
    for _ in range(steps - 1):
        logits, cache = model_forward(params, cfg, out[-1][:, None],
                                      cache=cache, mode="decode")
        out.append(next_ids(logits, cfg))
    return torch.stack(out, dim=1)
