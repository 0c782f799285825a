"""Fused, vocab-parallel cross-entropy: the "never materialize the logits"
loss.

The port's twin of ``repro.models.loss.fused_ce_loss``.  With 152k vocabs,
(B, S, V) fp32 logits are GBs and their gradient doubles them, so the loss
walks the sequence in chunks: the forward keeps only each row's logsumexp
and gold logit, and the backward rebuilds each chunk's logits to form dx
and accumulate an fp32 head gradient.  Vocab padding (``valid_vocab`` up
to the head's padded width) is masked to -inf.

On a device mesh (x a DTensor) it is the reference's ``shard_map`` branch,
run on each process's shard through ``local_map``: x and the labels split
by batch over the data axes (``pod``, ``data``), the head by vocab over
``model``.  The forward all-reduces the logsumexp's max and sum and the
gold logit over ``model`` and the loss's sums over the data axes; the
backward all-reduces dx over ``model`` and the head gradient over the data
axes (the reference's psums), on the groups of the DTensors' mesh.  Where
the batch does not divide the data axes or the padded vocab ``model``, the
whole loss runs on every process (the reference's fallback to its local
loss).  With no mesh it is the reference's one-device path.

The chunk products are plain ``torch`` matrix products (the reference leaves
them to XLA): logits in fp32 from operands in x's dtype (on the card, bf16
through the tensor cores with fp32 output).  The backward keeps dlogits in
fp32 and multiplies it against the fp32-widened head and x, as the
reference does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with an fp32 result: bf16 operands on the card go to
    the tensor cores with fp32 accumulation and output (and so do meta
    operands, so that a dry run traces the card's allocations and flops);
    elsewhere the fp32 product of the (exactly widened) operands."""
    if a.device.type in ("cuda", "meta") and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(x_c: torch.Tensor, head: torch.Tensor, valid: int
            ) -> torch.Tensor:
    """fp32 logits (B, c, V) of one chunk, columns from ``valid`` on (the
    padded vocab) at -inf."""
    B, c, d = x_c.shape
    logits = _dot_f32(x_c.reshape(B * c, d), head).view(B, c, -1)
    logits[..., max(valid, 0):] = -float("inf")
    return logits


def _all_reduce(t: torch.Tensor, groups, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(t, op=op, group=g)
    return t


class _FusedCE(torch.autograd.Function):
    """The loss on one shard: x (B, S, d) and labels (B, S) of this
    process's batch, the head's (d, V) columns from ``v_off`` on; ``tp``
    the groups that hold the other vocab columns (none, or ``model``'s),
    ``dp`` those that hold the other batch rows."""

    @staticmethod
    def forward(ctx, x, head, labels, valid_vocab: int, chunk: int,
                v_off: int = 0, tp=(), dp=()):
        B, S, _ = x.shape
        V = head.shape[1]
        lse = torch.empty((B, S), dtype=torch.float32, device=x.device)
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, S, chunk):
            lab = labels[:, c0:c0 + chunk].long()
            logits = _logits(x[:, c0:c0 + chunk], head, valid_vocab - v_off)
            loc = lab - v_off
            gold = logits.gather(-1, loc.clamp(0, V - 1)[..., None])[..., 0]
            m = _all_reduce(logits.amax(-1), tp, dist.ReduceOp.MAX)
            z = _all_reduce(logits.sub_(m[..., None]).exp_().sum(-1), tp)
            lse_c = m + torch.log(z)
            del logits
            if tp:
                gold = _all_reduce(torch.where((loc >= 0) & (loc < V), gold,
                                               0.0), tp)
            mask = lab >= 0
            nll_sum = nll_sum + torch.where(mask, lse_c - gold, 0.0).sum()
            count = count + mask.sum()
            lse[:, c0:c0 + chunk] = lse_c
        _all_reduce(nll_sum, dp)
        cnt = _all_reduce(count, dp).float()
        loss = nll_sum / torch.clamp(cnt, min=1.0)
        ctx.save_for_backward(x, head, labels, lse, cnt)
        ctx.valid_vocab, ctx.chunk = valid_vocab, chunk
        ctx.v_off, ctx.tp, ctx.dp = v_off, tp, dp
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, _g_cnt):
        x, head, labels, lse, cnt = ctx.saved_tensors
        B, S, d = x.shape
        V = head.shape[1]
        w = g_loss.float() / torch.clamp(cnt, min=1.0)
        dx = torch.empty_like(x)
        dhead = torch.zeros(head.shape, dtype=torch.float32, device=x.device)
        head_t = head.t().float()
        for c0 in range(0, S, ctx.chunk):
            x_c = x[:, c0:c0 + ctx.chunk]
            lab = labels[:, c0:c0 + ctx.chunk].long()
            c = x_c.shape[1]
            # p = softmax, in place of the logits (the pad stays exactly 0)
            p = _logits(x_c, head, ctx.valid_vocab - ctx.v_off)
            p.sub_(lse[:, c0:c0 + ctx.chunk, None]).exp_()
            mask = lab >= 0
            wm = w * mask.float()
            loc = lab - ctx.v_off
            idx = loc.clamp(0, V - 1)[..., None]
            # dlogits = (p - onehot) * wm: the gold column's (p - 1) * wm,
            # where the gold column is this shard's
            onehot = mask & (loc >= 0) & (loc < V)
            gold = (p.gather(-1, idx)[..., 0] - onehot.float()) * wm
            p.mul_(wm[..., None]).scatter_(-1, idx, gold[..., None])
            dl = p.view(B * c, V)
            dx_c = (dl @ head_t).view(B, c, d)
            dx[:, c0:c0 + c] = _all_reduce(dx_c, ctx.tp)
            dhead.addmm_(x_c.reshape(B * c, d).t().float(), dl)
            del p, dl, dx_c
        _all_reduce(dhead, ctx.dp)
        return (dx, dhead.to(head.dtype), None, None, None, None, None,
                None)


def _sharded_loss(x, head, labels, valid_vocab: int, chunk: int):
    """The reference's ``shard_map`` branch on DTensor x, head, labels."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names, sizes = mesh.mesh_dim_names, dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape))
    dp = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    tp = "model" if sizes.get("model", 1) > 1 else None
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    whole = [Replicate()] * len(names)
    if x.shape[0] % n_dp or (tp and head.shape[1] % sizes[tp]):
        dp, tp = (), None             # the reference's local-loss fallback
    rows = [Shard(0) if a in dp else Replicate() for a in names]
    cols = [Shard(1) if a == tp else Replicate() for a in names]
    v_off = mesh.get_local_rank(tp) * (head.shape[1] // sizes[tp]) if tp \
        else 0
    tp_groups = (mesh.get_group(tp),) if tp else ()
    dp_groups = tuple(mesh.get_group(a) for a in dp)
    fn = local_map(
        lambda x_, h_, l_: _FusedCE.apply(x_, h_, l_, valid_vocab, chunk,
                                          v_off, tp_groups, dp_groups),
        out_placements=(whole, whole), in_placements=(rows, cols, rows),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(x, head, labels)


def fused_ce_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                  *, valid_vocab: int, chunk: int = 1024
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token NLL over labels >= 0 (-1 = masked).  x (B, S, d),
    head (d, Vp), labels (B, S) integers, all DTensors on one device mesh
    or none.  Returns (loss, token_count), both fp32 scalars (on a mesh
    replicated DTensors); the loss is differentiable in x and head."""
    if chunk <= 0:
        raise ValueError("fused_ce_loss: chunk must be positive")
    if hasattr(x, "device_mesh"):
        return _sharded_loss(x, head, labels, valid_vocab, chunk)
    return _FusedCE.apply(x, head, labels, valid_vocab, chunk)
