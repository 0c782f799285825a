"""Bulk-bitwise execution: whole pass programs as multi-word sweeps.

The port's twin of ``repro.engine.bulk``.  A bucket of lowered pass
programs (the ``(Q, G, P, L)`` selector arrays of :mod:`repro_torch.engine
.batch`) runs as ONE fused sweep: every literal of every query gathers its
operand row once, and the AND over literals, the De-Morgan xor, the AND
over passes and the OR over groups fold before the result rows are written;
tail masking + popcount follow once per query.

:func:`run_program` goes through the counted ``bulk_program`` wrapper
(:func:`repro_torch.kernels.bitmap_ops.bulk_program_counted`), which
decides the route by the device of the tensors (the reference switches on
``jax.default_backend()`` instead): a CUDA tensor launches the kernel,
whose epilogue masks the tail and popcounts, so no plain-torch pass
follows it on the card; a CPU tensor runs the plain sweep, which chunks
the QUERY axis whenever the ``(Q, G, P, Nw)`` accumulator would outgrow
:data:`~repro_torch.kernels.bitmap_ops.SWEEP_BUDGET_BYTES`, then the tail
mask and popcount; any other device raises.  :func:`run_program_stacked`
does the same through the stacked counted launch.

:func:`run_program_plain` runs the plain sweep on any device: the ``bulk``
backend uses it, so that on the card it stays a plain-torch reference
beside the ``cuda`` backend's kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.engine import policy
from repro_torch.kernels import bitmap_ops, ref

#: Fast-memory budget (bytes) one tile of work should fit in (kept from the
#: reference for :func:`tile_words`).
TILE_BUDGET_BYTES = 4 << 20

#: Floor on the tile width (words).
MIN_TILE_WORDS = 64

def tile_words(m1: int, qgp: int, nw: int,
               budget: int = TILE_BUDGET_BYTES) -> int:
    """Largest power-of-two word-tile width such that one augmented index
    tile (``m1`` rows) plus the accumulator (``qgp`` rows) fits the budget;
    never below :data:`MIN_TILE_WORDS`, never wider than the (pow2-rounded)
    row itself."""
    t = 1
    while t < nw:
        t *= 2
    while t > MIN_TILE_WORDS and (m1 + qgp) * t * 4 > budget:
        t //= 2
    return t


def query(rows: torch.Tensor, invert: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``Backend.query`` for the bulk backend: one fused AND-with-inversion
    pass as a single bulk reduction over the literal axis.  Tail bits are
    NOT masked."""
    if rows.shape[0] == 0:
        raise ValueError("query needs at least one operand row")
    flips = -invert.to(device=rows.device, dtype=torch.int32)[:, None]
    terms = rows ^ flips
    # AND-reduce by halving (torch has no bitwise reduction op)
    while terms.shape[0] > 1:
        h = terms.shape[0] // 2
        head = terms[:h] & terms[h:2 * h]
        terms = torch.cat([head, terms[2 * h:]]) if terms.shape[0] % 2 \
            else head
    result = terms[0]
    return result, ref.popcount(result).sum(dtype=torch.int32)


def create_index(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Index creation shares the oracle pipeline (its win is the query
    side)."""
    n = records.shape[0]
    m = keys.shape[0]
    packed = ref.create_index(policy.pad_records(records.to(torch.int32)),
                              policy.pad_keys(keys.to(torch.int32)))
    return packed[:m, : policy.num_words(n)]


def run_program(aug: torch.Tensor, num_records: int, sels: torch.Tensor,
                invs: torch.Tensor, post: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-bucket executor (the ``Backend.run_program`` hook): aug
    (M+1, Nw) with the all-ones identity row at M, selector arrays
    (Q, G, P, L), post xor masks (Q, G, P) -> (rows (Q, Nw), counts (Q,))
    with tails masked past ``num_records``.  One counted ``bulk_program``
    launch on a CUDA tensor (mask and popcount in its epilogue), the plain
    sweep then ``mask_tail`` on a CPU tensor; raises elsewhere."""
    return bitmap_ops.bulk_program_counted(aug, num_records, sels, invs,
                                           post)


def run_program_plain(aug: torch.Tensor, num_records: int,
                      sels: torch.Tensor, invs: torch.Tensor,
                      post: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`run_program` through the plain sweep on any device."""
    return policy.mask_tail(bitmap_ops.bulk_program_plain(aug, sels, invs,
                                                          post), num_records)


def run_program_stacked(aug: torch.Tensor, nrecs, sels: torch.Tensor,
                        invs: torch.Tensor, post: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment-stacked whole-bucket executor (the
    ``Backend.run_program_stacked`` hook): aug (S, M+1, Nw), ``nrecs`` S
    record counts, selector arrays shared by every segment -> (rows
    (S, Q, Nw) with each segment's tail masked past its own count, counts
    (S, Q)).  One stacked counted ``bulk_program`` launch on a CUDA tensor
    (mask and popcount in its epilogue), its plain version on a CPU
    tensor."""
    n = _record_counts(tuple(int(c) for c in nrecs), aug.device)
    return bitmap_ops.bulk_program_stacked_counted(aug, n, sels, invs, post)


@functools.lru_cache(maxsize=64)
def _record_counts(nrecs: tuple[int, ...], device: torch.device
                   ) -> torch.Tensor:
    """The segments' record counts as an int32 tensor on ``device``,
    uploaded once per (counts, device): a blocking copy from pageable
    memory inside the executor would synchronize the stream on every
    stacked bucket."""
    return torch.tensor(nrecs, dtype=torch.int32).to(device)
