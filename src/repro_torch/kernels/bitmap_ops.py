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
* ``bulk_program_counted``: the same rows masked past ``num_records`` and
  their popcounts (Q,) int32, from the kernel's epilogue: what the
  reference's ``run_program_pallas`` returns
  (``src/repro/engine/bulk.py:162-177``).
* ``bulk_program_stacked``: the same bucket over a stack of uniform
  segments in one launch — aug (S, M+1, Nw), nrecs (S,) int32 -> rows
  (S, Q, Nw), the program shared by every segment, segment s's tail masked
  past nrecs[s].  The reference vmaps ``bulk_program`` over the segment
  axis (``src/repro/engine/batch.py:155-165``).
  ``bulk_program_stacked_counted`` adds the counts (S, Q).

The four ``bulk_program`` forms launch through one C entry, which picks
the kernel by shape: the staged route (``bulk_staged_kernel``: each
distinct operand row of a query chunk copied into shared memory once per
word tile) or, when a chunk may select more rows than two stages of
32-word tiles hold, the direct-gather route (``bulk_gather_kernel``).  A
counted form counts on its uncounted twin's launch counter.
``bulk_program_plan`` reports the route and schedule a launch takes.  The
source notes in the ``.cu`` file give each kernel's bound and design.
"""
from __future__ import annotations

import ctypes

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


def _check_bucket(name: str, aug: torch.Tensor, sels: torch.Tensor,
                  invs: torch.Tensor, post: torch.Tensor,
                  nrecs: torch.Tensor | None = None) -> bool:
    """Argument checks of a ``bulk_program`` wrapper (stacked when given
    ``nrecs``); True when the tensors lie on the card (the kernel
    launches)."""
    stacked = nrecs is not None
    extra = (nrecs,) if stacked else ()
    tensors = (aug, *extra, sels, invs, post)
    card = _build.on_card(name, *tensors)
    names = "aug/nrecs/sels/invs/post" if extra else "aug/sels/invs/post"
    _build.require(name, all(t.dtype == torch.int32 for t in tensors),
                   f"{names} must be int32")
    aug_want = "(S, M+1, Nw), nrecs (S,)" if stacked else "(M+1, Nw)"
    _build.require(name, aug.dim() == (3 if stacked else 2)
                   and (not stacked or nrecs.shape == aug.shape[:1])
                   and sels.dim() == 4 and invs.shape == sels.shape
                   and post.shape == sels.shape[:3],
                   f"want aug {aug_want}, sels/invs (Q, G, P, L), post "
                   f"(Q, G, P); got {tuple(aug.shape)}, "
                   + "".join(f"{tuple(t.shape)}, " for t in extra)
                   + f"{tuple(sels.shape)}, {tuple(invs.shape)}, "
                   f"{tuple(post.shape)}")
    _build.require(name, min(sels.shape) >= 1, "empty program axis")
    if card:
        _build.require(name, all(t.is_contiguous() for t in tensors),
                       f"{names} must be contiguous")
    return card


def _launch(name: str, aug: torch.Tensor, nrecs, sels: torch.Tensor,
            invs: torch.Tensor, post: torch.Tensor, *, num_records: int = 0,
            counted: bool):
    """One launch of the C entry: rows (lead + (Q, Nw)) and, when
    ``counted``, counts (lead + (Q,)), lead being (S,) for a stacked aug."""
    lead = tuple(aug.shape[:-2])
    m1, nw = aug.shape[-2:]
    q, g, p, l = sels.shape
    out = torch.empty(lead + (q, nw), dtype=torch.int32, device=aug.device)
    counts = (torch.empty(lead + (q,), dtype=torch.int32, device=aug.device)
              if counted else None)
    _build.launch(name, aug.device, _build.ptr(aug),
                  None if nrecs is None else _build.ptr(nrecs),
                  _build.ptr(sels), _build.ptr(invs), _build.ptr(post),
                  _build.ptr(out), None if counts is None else
                  _build.ptr(counts), int(num_records),
                  lead[0] if lead else 1, m1, nw, q, g, p, l)
    return out, counts


def bulk_program(aug: torch.Tensor, sels: torch.Tensor, invs: torch.Tensor,
                 post: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; run the plain version on CPU
    tensors.  Takes contiguous int32 aug (M+1, Nw) whose row M is all ones
    (the kernel folds a literal on it without reading it), sels/invs
    (Q, G, P, L) and post (Q, G, P); every selector must lie in [0, M] (the
    batch layer checks key ranges on the host).  Tails are not masked."""
    name = "bulk_program"
    if not _check_bucket(name, aug, sels, invs, post):
        return bulk_program_plain(aug, sels, invs, post)
    out, _ = _launch(name, aug, None, sels, invs, post, counted=False)
    bulk_program.launches += 1
    return out


bulk_program.launches = 0


def bulk_program_counted_plain(aug: torch.Tensor, num_records: int,
                               sels: torch.Tensor, invs: torch.Tensor,
                               post: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain-torch version: :func:`bulk_program_plain` masked past
    ``num_records``, and the rows' popcounts (the engine's ``mask_tail``)."""
    rows = bulk_program_plain(aug, sels, invs, post) & ref.tail_mask(
        aug.shape[1], int(num_records), aug.device)
    return rows, ref.popcount(rows).sum(dim=-1, dtype=torch.int32)


def bulk_program_counted(aug: torch.Tensor, num_records: int,
                         sels: torch.Tensor, invs: torch.Tensor,
                         post: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bulk_program` with the tail masked past ``num_records`` and
    the popcounts (Q,) int32 fused into the kernel's epilogue; the plain
    version on CPU tensors.  Counts on ``bulk_program.launches``."""
    name = "bulk_program"
    if not _check_bucket(name, aug, sels, invs, post):
        return bulk_program_counted_plain(aug, num_records, sels, invs, post)
    out, counts = _launch(name, aug, None, sels, invs, post,
                          num_records=num_records, counted=True)
    bulk_program.launches += 1
    return out, counts


def bulk_program_plan(s: int, m: int, nw: int, shape, *, stacked: bool,
                      counted: bool, device=None) -> dict:
    """The plan that a ``bulk_program`` launch of that form takes on
    ``device`` (default: the current card) for a bucket of program shape
    (Q, G, P, L) over ``s`` segments of M+1 rows of ``nw`` words, as the C
    entry computes it: {"route": "staged" or "gather", "ctas": resident
    CTAs planned for, "qc": chunk queries, "chunks", "strips"} (the last
    three 0 on the gather route).  Launches nothing."""
    q, g, p, l = shape
    plan = (ctypes.c_longlong * 5)()
    fn = _build.library("bulk_program_plan")
    with torch.cuda.device(device):
        rc = fn(s if stacked else 1, m + 1, nw, q, g * p * l, int(stacked),
                int(counted), ctypes.cast(plan, ctypes.c_void_p))
    _build.check(rc, "bulk_program_plan")
    staged = bool(plan[0])
    return {"route": "staged" if staged else "gather", "ctas": plan[1],
            **{k: plan[i] if staged else 0
               for i, k in enumerate(("qc", "chunks", "strips"), 2)}}


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
                         post: torch.Tensor
                         ) -> torch.Tensor:
    """Launch the stacked kernel on CUDA tensors; run the plain version on
    CPU tensors.  Takes contiguous int32 aug (S, M+1, Nw) whose row M of
    every segment is all ones, nrecs (S,), sels/invs (Q, G, P, L) and post
    (Q, G, P); every selector must lie in [0, M]."""
    name = "bulk_program_stacked"
    if not _check_bucket(name, aug, sels, invs, post, nrecs):
        return bulk_program_stacked_plain(aug, nrecs, sels, invs, post)
    out, _ = _launch(name, aug, nrecs, sels, invs, post, counted=False)
    bulk_program_stacked.launches += 1
    return out


bulk_program_stacked.launches = 0


def bulk_program_stacked_counted_plain(aug: torch.Tensor, nrecs: torch.Tensor,
                                       sels: torch.Tensor, invs: torch.Tensor,
                                       post: torch.Tensor
                                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain-torch version: :func:`bulk_program_stacked_plain` and its
    rows' popcounts (S, Q)."""
    rows = bulk_program_stacked_plain(aug, nrecs, sels, invs, post)
    return rows, ref.popcount(rows).sum(dim=-1, dtype=torch.int32)


def bulk_program_stacked_counted(aug: torch.Tensor, nrecs: torch.Tensor,
                                 sels: torch.Tensor, invs: torch.Tensor,
                                 post: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bulk_program_stacked` with the popcounts (S, Q) int32 fused
    into the kernel's epilogue; the plain version on CPU tensors.  Counts
    on ``bulk_program_stacked.launches``."""
    name = "bulk_program_stacked"
    if not _check_bucket(name, aug, sels, invs, post, nrecs):
        return bulk_program_stacked_counted_plain(aug, nrecs, sels, invs,
                                                  post)
    out, counts = _launch(name, aug, nrecs, sels, invs, post, counted=True)
    bulk_program_stacked.launches += 1
    return out, counts


