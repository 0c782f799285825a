"""Flash attention on the card: the ``flash_attention_fwd`` and
``flash_attention_bwd`` CUDA kernels (``csrc/attention.cu``), each beside
its plain-torch version.

Online-softmax attention, causal or full, scale 1/sqrt(hd), fp32
accumulation, output in q's dtype, under the reference's mask
(``repro.models.flash._block_ok``, here :func:`allowed`): ``kv_len`` valid
keys and, under the causal mask, a sliding ``window`` below each query's
absolute position q + ``q_offset``.  The kernels skip whole tiles outside
the window.  A row that sees no key is zeros with an lse of ``NEG_INF``.
Two layouts, one entry point:

* the model's: q (B, Sq, H, hd), k/v (B, Skv, KV, hd) with H % KV == 0;
  query head h reads KV head h // (H // KV), with no broadcast copy;
* the reference kernel's: q (BH, Sq, hd), k/v (BH, Skv, hd), KV heads
  pre-broadcast (the model layout with H = KV = 1).

On the card the C entry point picks one of two hand-written kernels by type
and shape: bf16 at head_dim 64, 128 or 256 (every full config the port
serves) runs on the tensor cores (``flash_fwd_wgmma``: wgmma tiles fed by
TMA copies, 128 queries a CTA against 128-key K/V tiles, 64-key at head_dim
256, P carried as a bf16 hi + lo pair); fp32 inputs, at every head dim,
and bf16 at head_dim 8, 16 and 32 run on the CUDA cores
(``flash_fwd_kernel``: fp32 FMAs, which keep fp32 within the reference
test's atol of 2e-5).

The forward also returns lse (B, H, Sq) fp32, the natural-log normalizer of
the scaled scores, when asked (``return_lse=True``: the training path).  The
backward takes (q, k, v, out, lse, dout) and the forward's mask arguments
in the model layout and returns dq, dk, dv in q's dtype (fp32
accumulation, two launches, no atomics, so bit-identical from run to
run).  Its C entry picks by the same rule: bf16
at head_dim 64, 128 or 256 runs on the tensor cores (``flash_bwd_dq_wgmma``,
one CTA per 128-query tile streaming 64-key K/V tiles, 32-key at head_dim
256, which also writes delta; then ``flash_bwd_dkdv_wgmma``, one CTA per
(batch, KV head, 128-key tile) streaming the group's 64-query Q/dO tiles,
so the GQA sum stays in the CTA; at head_dim 256 a CTA takes 64 keys and
its two consumer warpgroups split the outputs, dV in one and dK in the
other; a TMA producer warp and a 3-deep ring each, 2-deep at head_dim 256,
P and dS as bf16 A operands from registers); fp32 and bf16 at head_dim 8,
16 and 32 on the CUDA cores (``flash_bwd_dq_kernel``,
``flash_bwd_dkdv_kernel``).  A failure of either raises; neither falls
back to the other.

On meta tensors (a dry run's trace, ``repro_torch.launch.dryrun``) both
wrappers make the card's argument checks but the pointer alignment,
return meta outputs of the kernel's shapes (the backward also makes its
delta workspace, as the card route does), and add the call and its flops to
their ``traced`` and ``traced_flops`` counters: 4·B·H·hd per allowed pair
(:func:`allowed_pairs`) forward, 2.5 times that backward.  They never launch
nor run a plain version there, and leave ``launches`` alone.

The forward replaces ``src/repro/kernels/attention.py::flash_attention_fwd``;
the backward replaces the plain-JAX backward of
``repro.models.flash.flash_attention_vjp`` (``_flash_bwd_dense``), which is
no TPU kernel.  The source note in the ``.cu`` file gives each kernel's
bound and design.  :func:`kernel_launches` reads the launches the C entries
count at each kernel's launch site: which route the calls took.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * torch.finfo(torch.float32).max
#: the reference's unbounded window (``repro.models.flash.WINDOW_INF``)
WINDOW_INF = 2 ** 30
#: head dims the kernel is instantiated for (every config's head_dim)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
#: the kernels of both C entries, in the order ``flash_attention_launched``
#: reports their launches
KERNELS = ("flash_fwd_wgmma", "flash_fwd_kernel", "flash_bwd_dq_wgmma",
           "flash_bwd_dkdv_wgmma", "flash_bwd_dq_kernel",
           "flash_bwd_dkdv_kernel")


def kernel_launches(reset: bool = False) -> dict:
    """{kernel: launches} of :data:`KERNELS` as the C entries counted them
    where they launched each kernel in this process, since the library was
    loaded or last reset; ``reset`` sets them to 0 after the read.  Card
    only (it loads the kernel library)."""
    got = (ctypes.c_longlong * len(KERNELS))()
    _build.check(_build.library("flash_attention_launched")(got, int(reset)),
                 "flash_attention_launched")
    return dict(zip(KERNELS, got))


def _model_layout(q, k, v):
    """(q, k, v) as 4-D model-layout views, and whether they were 3-D."""
    if q.dim() == 3:
        return q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), True
    return q, k, v, False


def allowed(sq: int, skv: int, *, causal: bool, window=None, q_offset=0,
            kv_len=None, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: key k is allowed for query q when k < kv_len (clipped
    to Skv) and, under ``causal`` only, q + q_offset - window < k <=
    q + q_offset: the mask of the reference's ``models.flash._block_ok``
    (``window`` None is unbounded)."""
    kl = skv if kv_len is None else max(0, min(int(kv_len), skv))
    k_pos = torch.arange(skv, device=device)
    keep = (k_pos < kl)[None, :].expand(sq, skv)
    if causal:
        q_abs = torch.arange(sq, device=device)[:, None] + int(q_offset)
        keep = keep & (k_pos[None, :] <= q_abs)
        if window is not None:
            keep = keep & (k_pos[None, :] > q_abs - int(window))
    return keep


def allowed_pairs(sq: int, skv: int, *, causal: bool, window=None,
                  q_offset=0, kv_len=None) -> int:
    """How many entries of :func:`allowed` are True, without the (Sq, Skv)
    matrix: query q (absolute position a = q + q_offset) sees keys
    max(0, a - window + 1) ..min(a, kv_len - 1) under ``causal``, all
    kv_len keys otherwise."""
    kl = skv if kv_len is None else max(0, min(int(kv_len), skv))
    if not causal:
        return sq * kl
    a = torch.arange(sq, dtype=torch.int64) + int(q_offset)
    hi = torch.clamp(a, max=kl - 1)
    lo = (torch.zeros_like(a) if window is None
          else torch.clamp(a - int(window) + 1, min=0))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def flash_flops(B: int, H: int, hd: int, pairs: int, *,
                backward: bool = False) -> int:
    """The forward's flops, 4·B·H·hd per allowed pair (q k^T and p v, two
    flops a multiply-add); the backward's are 2.5 times those (the bound
    column of ``PERF.md``'s rows 5 and 5b)."""
    f = 4 * B * H * hd * pairs
    return f * 5 // 2 if backward else f


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window=None, q_offset: int = 0, kv_len=None,
                              return_lse: bool = False):
    """The plain-torch version: per query head, fp32
    ``softmax(q k^T * scale + mask) v``, the mask (:func:`allowed`) at
    ``NEG_INF``; with ``return_lse``, also the logsumexp of each masked
    score row, (B, H, Sq) fp32 ((BH, Sq) for 3-D inputs).  A row with no
    allowed key is written as zeros with an lse of ``NEG_INF`` (the
    reference's chunked forward averages V over its padded chunk there;
    its gradient through such a row is zero in both)."""
    q4, k4, v4, flat = _model_layout(q, k, v)
    B, S, H, hd = q4.shape
    g = H // k4.shape[2]
    scale = 1.0 / math.sqrt(hd)
    keep = allowed(S, k4.shape[1], causal=causal, window=window,
                   q_offset=q_offset, kv_len=kv_len, device=q.device)
    empty = ~keep.any(-1)
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for h in range(H):
        qh = q4[:, :, h].float() * scale
        s = qh @ k4[:, :, h // g].float().transpose(1, 2)
        s = s.masked_fill(~keep, NEG_INF)
        p = torch.softmax(s, dim=-1)
        if empty.any():
            p = p.masked_fill(empty[:, None], 0.0)
        out[:, :, h] = (p @ v4[:, :, h // g].float()).to(q.dtype)
        lse[:, h] = torch.logsumexp(s, dim=-1).masked_fill(empty, NEG_INF)
    if flat:
        out, lse = out[:, :, 0], lse[:, 0]
    return (out, lse) if return_lse else out


def _card_checks(name: str, hd: int, tensors, *, meta: bool = False
                 ) -> None:
    """What the kernels take beyond the plain version: a head_dim they are
    instantiated for, contiguous and (but on meta tensors, which have no
    address) 16-byte aligned tensors."""
    _build.require(name, hd in HEAD_DIMS,
                   f"head_dim {hd} not in {HEAD_DIMS}")
    _build.require(name, all(t.is_contiguous() for t in tensors),
                   "inputs must be contiguous")
    _build.require(name, meta or all(t.data_ptr() % 16 == 0
                                     for t in tensors),
                   "inputs must be 16-byte aligned")


def _mask_args(name: str, sq: int, skv: int, window, q_offset, kv_len):
    """The mask's integers as the C entries take them: window (None is
    :data:`WINDOW_INF`), q_offset and kv_len (None is Skv), checked."""
    w = WINDOW_INF if window is None else int(window)
    kl = skv if kv_len is None else int(kv_len)
    _build.require(name, w >= 1, f"window must be >= 1, got {window}")
    _build.require(name, int(q_offset) >= 0,
                   f"q_offset must be >= 0, got {q_offset}")
    _build.require(name, skv >= 1, "k/v need at least one position")
    _build.require(name, sq + int(q_offset) + skv <= 2 ** 31 - 1025,
                   "sequence positions past int32")
    return w, int(q_offset), kl


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None,
                        q_offset: int = 0, kv_len=None, block_q: int = 256,
                        block_k: int = 256, return_lse: bool = False):
    """Launch the kernel on CUDA tensors; run the plain version on CPU
    tensors.  Returns the output, or (output, lse) with ``return_lse``.
    Takes q/k/v of one dtype (fp32 or bf16), either q (BH, Sq, hd) with k/v
    (BH, Skv, hd) or q (B, Sq, H, hd) with k/v (B, Skv, KV, hd); on the card
    they must be contiguous and 16-byte aligned, with hd in
    :data:`HEAD_DIMS`.  The mask is :func:`allowed`'s: ``kv_len`` valid
    keys and, under ``causal``, a ``window`` below each query's absolute
    position q + ``q_offset``.  ``block_q``/``block_k`` are the reference
    kernel's tile sizes: checked, not used (the kernels tile 128 queries by
    128 keys on the tensor cores, by 64 at head_dim 256, and 64 queries by
    32 or 64 keys on the CUDA cores)."""
    name = "flash_attention_fwd"
    meta = _build.on_meta(name, q, k, v)
    card = not meta and _build.on_card(name, q, k, v)
    _build.require(name, q.dtype in DTYPES and k.dtype == q.dtype
                   and v.dtype == q.dtype,
                   f"q/k/v must share one dtype of {DTYPES}, got "
                   f"{q.dtype}, {k.dtype}, {v.dtype}")
    _build.require(name, block_q > 0 and block_k > 0,
                   "block_q/block_k must be positive")
    _build.require(name, q.dim() in (3, 4) and k.dim() == q.dim()
                   and k.shape == v.shape,
                   f"want q/k/v (BH, S, hd) or q (B, S, H, hd) with k/v "
                   f"(B, S, KV, hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                   f"{tuple(v.shape)}")
    q4, k4, v4, _ = _model_layout(q, k, v)
    B, S, H, hd = q4.shape
    Skv, KV = k4.shape[1], k4.shape[2]
    _build.require(name, k4.shape[0] == B and k4.shape[3] == hd
                   and KV >= 1 and H % KV == 0,
                   f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    w, qo, kl = _mask_args(name, S, Skv, window, q_offset, kv_len)
    if not (card or meta):
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         kv_len=kv_len, return_lse=return_lse)
    _card_checks(name, hd, (q, k, v), meta=meta)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if meta:
        flash_attention_fwd.traced += 1
        flash_attention_fwd.traced_flops += flash_flops(
            B, H, hd, allowed_pairs(S, Skv, causal=causal, window=window,
                                    q_offset=qo, kv_len=kv_len))
    else:
        _build.launch(name, q.device, _build.ptr(q), _build.ptr(k),
                      _build.ptr(v), _build.ptr(out),
                      None if lse is None else _build.ptr(lse), B, S, Skv, H,
                      KV, hd, int(causal), w, qo, kl,
                      int(q.dtype == torch.bfloat16))
        flash_attention_fwd.launches += 1
    if not return_lse:
        return out
    return out, (lse[:, 0] if q.dim() == 3 else lse)


flash_attention_fwd.launches = 0
flash_attention_fwd.traced = 0
flash_attention_fwd.traced_flops = 0


# ---------------------------------------------------------------- backward
def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window=None,
                              q_offset: int = 0, kv_len=None,
                              kv_chunk: int = 512):
    """The plain-torch version: the chunked twin of the reference's
    ``_flash_bwd_dense`` in fp32, ``kv_chunk`` keys at a time (memory
    O(Sq * kv_chunk) per head).  delta = rowsum(dout * out), p = exp(q k^T *
    scale - lse) where :func:`allowed` (0 elsewhere), dv = p^T dout, ds =
    p (dp - delta), dq = ds k * scale, dk = ds^T q * scale; dq, dk, dv in
    q's, k's and v's dtypes."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qs = q.float().reshape(B, S, KV, g, hd) * scale
    do = dout.float().reshape(B, S, KV, g, hd)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", do,
                         out.float().reshape(B, S, KV, g, hd))
    lse_ = lse.float().reshape(B, KV, g, S)
    keep = allowed(S, Skv, causal=causal, window=window, q_offset=q_offset,
                   kv_len=kv_len, device=q.device)
    dq = torch.zeros((B, S, KV, g, hd), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, Skv, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, Skv, kv_chunk):
        kj = k[:, k0:k0 + kv_chunk].float()
        vj = v[:, k0:k0 + kv_chunk].float()
        s = torch.einsum("bqkgh,bckh->bkgqc", qs, kj)
        p = torch.exp(s - lse_[..., None])
        p = p.masked_fill(~keep[:, k0:k0 + kv_chunk], 0.0)
        dv[:, k0:k0 + kv_chunk] = torch.einsum("bkgqc,bqkgh->bckh", p, do)
        dp = torch.einsum("bqkgh,bckh->bkgqc", do, vj)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bkgqc,bckh->bqkgh", ds, kj)
        dk[:, k0:k0 + kv_chunk] = torch.einsum("bkgqc,bqkgh->bckh", ds, qs)
    dq = (dq * scale).reshape(B, S, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window=None, q_offset: int = 0, kv_len=None):
    """dq, dk, dv of :func:`flash_attention_fwd` in the model layout: q, out,
    dout (B, Sq, H, hd), k/v (B, Skv, KV, hd) of one dtype, lse (B, H, Sq)
    fp32 as the forward returned it, and the forward's mask arguments.
    Launches the kernel on CUDA tensors (both of its launches count as
    one), runs the plain version on CPU tensors."""
    name = "flash_attention_bwd"
    meta = _build.on_meta(name, q, k, v, out, lse, dout)
    card = not meta and _build.on_card(name, q, k, v, out, lse, dout)
    _build.require(name, q.dtype in DTYPES and all(
        t.dtype == q.dtype for t in (k, v, out, dout)),
                   f"q/k/v/out/dout must share one dtype of {DTYPES}")
    _build.require(name, lse.dtype == torch.float32, "lse must be fp32")
    _build.require(name, q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
                   and out.shape == q.shape and dout.shape == q.shape,
                   f"want q/out/dout (B, S, H, hd) and k/v (B, S, KV, hd), "
                   f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                   f"{tuple(out.shape)}, {tuple(dout.shape)}")
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    _build.require(name, k.shape[0] == B and k.shape[3] == hd
                   and KV >= 1 and H % KV == 0 and lse.shape == (B, H, S),
                   f"k/v {tuple(k.shape)} or lse {tuple(lse.shape)} do not "
                   f"fit q {tuple(q.shape)}")
    w, qo, kl = _mask_args(name, S, Skv, window, q_offset, kv_len)
    if not (card or meta):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset, kv_len=kv_len)
    _card_checks(name, hd, (q, k, v, out, lse, dout), meta=meta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if meta:
        flash_attention_bwd.traced += 1
        flash_attention_bwd.traced_flops += flash_flops(
            B, H, hd, allowed_pairs(S, Skv, causal=causal, window=window,
                                    q_offset=qo, kv_len=kv_len),
            backward=True)
        return dq, dk, dv
    _build.launch(name, q.device,
                  *(_build.ptr(t) for t in (q, k, v, out, lse, dout, dq, dk,
                                            dv, delta)),
                  B, S, Skv, H, KV, hd, int(causal), w, qo, kl,
                  int(q.dtype == torch.bfloat16))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.traced = 0
flash_attention_bwd.traced_flops = 0
