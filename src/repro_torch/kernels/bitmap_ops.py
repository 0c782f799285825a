"""Fused bitmap query execution: the ``bitmap_query`` and ``bulk_program``
CUDA kernels (``csrc/bitmap_ops.cu``) and their plain-torch versions.

* ``bitmap_query``: rows (K, Nw) int32, invert (K,) int32 -> (result (Nw,),
  count () int32) for AND_k (invert_k ? ~rows_k : rows_k) with the popcount
  fused.  Replaces ``src/repro/kernels/bitmap_ops.py::bitmap_query``.
* ``bulk_program``: a whole bucket of lowered pass programs — aug (M+1, Nw)
  (all-ones identity row at M), sels/invs (Q, G, P, L), post (Q, G, P) xor
  masks -> rows (Q, Nw) = OR over groups of [AND over passes of [(AND over
  literals of possibly inverted aug[sel]) ^ post]], tails NOT masked.
  Replaces ``src/repro/kernels/bitmap_ops.py::bulk_program``.
* ``bulk_program_stacked``: the same bucket over a stack of uniform
  segments in one launch — aug (S, M+1, Nw), nrecs (S,) int32 -> rows
  (S, Q, Nw), the program shared by every segment, segment s's tail masked
  past nrecs[s].  The reference vmaps ``bulk_program`` over the segment
  axis (``src/repro/engine/batch.py:155-165``).

The source notes in the ``.cu`` file give each kernel's bound and design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


# ---------------------------------------------------------- bitmap_query
def bitmap_query_plain(rows: torch.Tensor, invert: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain-torch version."""
    return ref.bitmap_query(rows, invert)


def bitmap_query(rows: torch.Tensor, invert: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; run the plain version on CPU
    tensors.  Takes contiguous int32 rows (K >= 1, Nw) and invert (K,)."""
    name = "bitmap_query"
    card = _build.on_card(name, rows, invert)
    _build.require(name, rows.dtype == torch.int32
                   and invert.dtype == torch.int32, "rows/invert must be int32")
    _build.require(name, rows.dim() == 2 and invert.shape == rows.shape[:1],
                   f"want rows (K, Nw) and invert (K,), got "
                   f"{tuple(rows.shape)} and {tuple(invert.shape)}")
    _build.require(name, rows.shape[0] >= 1, "needs at least one operand row")
    if not card:
        return bitmap_query_plain(rows, invert)
    _build.require(name, rows.is_contiguous() and invert.is_contiguous(),
                   "rows/invert must be contiguous")
    k, nw = rows.shape
    out = torch.empty((nw,), dtype=torch.int32, device=rows.device)
    count = torch.zeros((1,), dtype=torch.int32, device=rows.device)
    _build.launch(name, rows.device, _build.ptr(rows), _build.ptr(invert),
                  _build.ptr(out), _build.ptr(count), k, nw)
    bitmap_query.launches += 1
    return out, count[0]


bitmap_query.launches = 0


# ---------------------------------------------------------- bulk_program
#: Cap on the plain version's largest intermediate — the (Qc, G, P, Nw)
#: accumulator of one query chunk.
SWEEP_BUDGET_BYTES = 64 << 20


def _fold(aug: torch.Tensor, sels: torch.Tensor, invs: torch.Tensor,
          post: torch.Tensor) -> torch.Tensor:
    """One fused sweep over full rows, materializing the (Q, G, P, Nw)
    accumulator."""
    q, g, p, l = sels.shape
    flip = -invs.to(torch.int32)                  # 0 or ~0 per literal
    acc = None
    for li in range(l):
        x = aug[sels[..., li].long()] ^ flip[..., li, None]   # (q, g, p, Nw)
        acc = x if acc is None else acc & x
    acc = acc ^ post[..., None]                   # De-Morgan OR-pass mask
    grp = acc[:, :, 0]
    for pi in range(1, p):
        grp = grp & acc[:, :, pi]
    out = grp[:, 0]
    for gi in range(1, g):
        out = out | grp[:, gi]
    return out


def bulk_program_plain(aug: torch.Tensor, sels: torch.Tensor,
                       invs: torch.Tensor, post: torch.Tensor
                       ) -> torch.Tensor:
    """The plain-torch version (the reference's ``_sweep_jnp``): the query
    axis is chunked whenever the (Q, G, P, Nw) accumulator would outgrow
    :data:`SWEEP_BUDGET_BYTES`; bit-identical either way."""
    nw = aug.shape[1]
    q, g, p, _ = sels.shape
    qc = max(1, SWEEP_BUDGET_BYTES // max(g * p * max(nw, 1) * 4, 1))
    if qc >= q:
        return _fold(aug, sels, invs, post)
    while q % qc:                             # q is a power of two
        qc -= 1
    return torch.cat([_fold(aug, sels[i:i + qc], invs[i:i + qc],
                            post[i:i + qc]) for i in range(0, q, qc)])


def bulk_program(aug: torch.Tensor, sels: torch.Tensor, invs: torch.Tensor,
                 post: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; run the plain version on CPU
    tensors.  Takes contiguous int32 aug (M+1, Nw) whose row M is all ones
    (the kernel folds a literal on it without reading it), sels/invs
    (Q, G, P, L) and post (Q, G, P); every selector must lie in [0, M] (the
    batch layer checks key ranges on the host)."""
    name = "bulk_program"
    card = _build.on_card(name, aug, sels, invs, post)
    _build.require(name, all(t.dtype == torch.int32
                             for t in (aug, sels, invs, post)),
                   "aug/sels/invs/post must be int32")
    _build.require(name, aug.dim() == 2 and sels.dim() == 4
                   and invs.shape == sels.shape
                   and post.shape == sels.shape[:3],
                   f"want aug (M+1, Nw), sels/invs (Q, G, P, L), post "
                   f"(Q, G, P); got {tuple(aug.shape)}, {tuple(sels.shape)}, "
                   f"{tuple(invs.shape)}, {tuple(post.shape)}")
    _build.require(name, min(sels.shape) >= 1, "empty program axis")
    if not card:
        return bulk_program_plain(aug, sels, invs, post)
    _build.require(name, all(t.is_contiguous()
                             for t in (aug, sels, invs, post)),
                   "aug/sels/invs/post must be contiguous")
    m1, nw = aug.shape
    q, g, p, l = sels.shape
    out = torch.empty((q, nw), dtype=torch.int32, device=aug.device)
    _build.launch(name, aug.device, _build.ptr(aug), _build.ptr(sels),
                  _build.ptr(invs), _build.ptr(post), _build.ptr(out), m1, nw,
                  q, g, p, l)
    bulk_program.launches += 1
    return out


bulk_program.launches = 0


# ---------------------------------------------------- bulk_program, stacked
def bulk_program_stacked_plain(aug: torch.Tensor, nrecs: torch.Tensor,
                               sels: torch.Tensor, invs: torch.Tensor,
                               post: torch.Tensor) -> torch.Tensor:
    """The plain-torch version: :func:`bulk_program_plain` per segment,
    each segment's rows masked past its own record count."""
    return torch.stack([
        bulk_program_plain(aug[s], sels, invs, post)
        & ref.tail_mask(aug.shape[2], int(nrecs[s]), aug.device)
        for s in range(aug.shape[0])])


def bulk_program_stacked(aug: torch.Tensor, nrecs: torch.Tensor,
                         sels: torch.Tensor, invs: torch.Tensor,
                         post: torch.Tensor) -> torch.Tensor:
    """Launch the stacked kernel on CUDA tensors; run the plain version on
    CPU tensors.  Takes contiguous int32 aug (S, M+1, Nw) whose row M of
    every segment is all ones, nrecs (S,), sels/invs (Q, G, P, L) and post
    (Q, G, P); every selector must lie in [0, M]."""
    name = "bulk_program_stacked"
    card = _build.on_card(name, aug, nrecs, sels, invs, post)
    _build.require(name, all(t.dtype == torch.int32
                             for t in (aug, nrecs, sels, invs, post)),
                   "aug/nrecs/sels/invs/post must be int32")
    _build.require(name, aug.dim() == 3 and nrecs.shape == aug.shape[:1]
                   and sels.dim() == 4 and invs.shape == sels.shape
                   and post.shape == sels.shape[:3],
                   f"want aug (S, M+1, Nw), nrecs (S,), sels/invs "
                   f"(Q, G, P, L), post (Q, G, P); got {tuple(aug.shape)}, "
                   f"{tuple(nrecs.shape)}, {tuple(sels.shape)}, "
                   f"{tuple(invs.shape)}, {tuple(post.shape)}")
    _build.require(name, min(sels.shape) >= 1, "empty program axis")
    if not card:
        return bulk_program_stacked_plain(aug, nrecs, sels, invs, post)
    _build.require(name, all(t.is_contiguous()
                             for t in (aug, nrecs, sels, invs, post)),
                   "aug/nrecs/sels/invs/post must be contiguous")
    s, m1, nw = aug.shape
    q, g, p, l = sels.shape
    out = torch.empty((s, q, nw), dtype=torch.int32, device=aug.device)
    _build.launch(name, aug.device, _build.ptr(aug), _build.ptr(nrecs),
                  _build.ptr(sels), _build.ptr(invs), _build.ptr(post),
                  _build.ptr(out), s, m1, nw, q, g, p, l)
    bulk_program_stacked.launches += 1
    return out


bulk_program_stacked.launches = 0
