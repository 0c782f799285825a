"""Fused cross-entropy: the "never materialize the logits" loss.

The port's twin of ``repro.models.loss.fused_ce_loss`` on one card (the
reference's one-device path, ``_make_local_loss`` with no mesh axes; its
``shard_map`` over a vocab-parallel mesh waits for a multi-card slice).
With 152k vocabs, (B, S, V) fp32 logits are GBs and their gradient doubles
them, so the loss walks the sequence in chunks: the forward keeps only each
row's logsumexp and gold logit, and the backward rebuilds each chunk's
logits to form dx and accumulate an fp32 head gradient.  Vocab padding
(``valid_vocab`` up to the head's padded width) is masked to -inf.

The chunk products are plain ``torch`` matrix products (the reference leaves
them to XLA): logits in fp32 from operands in x's dtype (on the card, bf16
through the tensor cores with fp32 output).  The backward keeps dlogits in
fp32 and multiplies it against the fp32-widened head and x, as the
reference does.
"""
from __future__ import annotations

import torch


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with an fp32 result: bf16 operands on the card go to
    the tensor cores with fp32 accumulation and output (and so do meta
    operands, so that a dry run traces the card's allocations and flops);
    elsewhere the fp32 product of the (exactly widened) operands."""
    if a.device.type in ("cuda", "meta") and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(x_c: torch.Tensor, head: torch.Tensor, valid_vocab: int
            ) -> torch.Tensor:
    """fp32 logits (B, c, Vp) of one chunk, the padded vocab at -inf."""
    B, c, d = x_c.shape
    logits = _dot_f32(x_c.reshape(B * c, d), head).view(B, c, -1)
    logits[..., valid_vocab:] = -float("inf")
    return logits


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, labels, valid_vocab: int, chunk: int):
        B, S, _ = x.shape
        V = head.shape[1]
        lse = torch.empty((B, S), dtype=torch.float32, device=x.device)
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        count = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, S, chunk):
            lab = labels[:, c0:c0 + chunk].long()
            logits = _logits(x[:, c0:c0 + chunk], head, valid_vocab)
            gold = logits.gather(-1, lab.clamp(0, V - 1)[..., None])[..., 0]
            m = logits.amax(-1)
            lse_c = m + torch.log(logits.sub_(m[..., None]).exp_().sum(-1))
            del logits
            mask = lab >= 0
            nll_sum = nll_sum + torch.where(mask, lse_c - gold, 0.0).sum()
            count = count + mask.sum()
            lse[:, c0:c0 + chunk] = lse_c
        cnt = count.float()
        loss = nll_sum / torch.clamp(cnt, min=1.0)
        ctx.save_for_backward(x, head, labels, lse, cnt)
        ctx.valid_vocab, ctx.chunk = valid_vocab, chunk
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
            p = _logits(x_c, head, ctx.valid_vocab)
            p.sub_(lse[:, c0:c0 + ctx.chunk, None]).exp_()
            mask = lab >= 0
            wm = w * mask.float()
            idx = lab.clamp(0, V - 1)[..., None]
            # dlogits = (p - onehot) * wm: the gold column's (p - 1) * wm
            gold = (p.gather(-1, idx)[..., 0] - mask.float()) * wm
            p.mul_(wm[..., None]).scatter_(-1, idx, gold[..., None])
            dl = p.view(B * c, V)
            dx[:, c0:c0 + c] = (dl @ head_t).view(B, c, d)
            dhead.addmm_(x_c.reshape(B * c, d).t().float(), dl)
            del p, dl
        return dx, dhead.to(head.dtype), None, None, None


def fused_ce_loss(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                  *, valid_vocab: int, chunk: int = 1024
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token NLL over labels >= 0 (-1 = masked).  x (B, S, d),
    head (d, Vp), labels (B, S) integers.  Returns (loss, token_count), both
    fp32 scalars; the loss is differentiable in x and head."""
    if chunk <= 0:
        raise ValueError("fused_ce_loss: chunk must be positive")
    return _FusedCE.apply(x, head, labels, valid_vocab, chunk)
