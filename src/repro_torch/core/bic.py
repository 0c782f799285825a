"""Bitmap Index Creation (BIC) — the paper's core, as a composable PyTorch
module (the port's twin of ``repro.core.bic``).

Mirrors Fig. 3 of the paper: a BIC core indexes N records by M keys through
CAM-match -> buffer -> transpose, producing an M x N bitmap index on which
multi-dimensional queries are bitwise row operations.  The fabricated core
used M=8 keys, N=16 records, W=32 8-bit words per record (``PaperConfig``).

Querying an index wraps it in a read-only :class:`repro_torch.db.BitmapDB`
session, so ``BICCore.query`` / ``query_many`` serve through the same path
as the facade; ``BICCore.create`` dispatches the backend registry directly:

  * ``backend="cuda"`` — the hand-written kernels (plain versions on CPU
    tensors).
  * ``backend="ref"``  — the plain-torch oracle.
  * ``backend="auto"`` — ``cuda`` on a CUDA device, ``ref`` on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import torch

from repro_torch.engine import backends as _backends
from repro_torch.engine import planner as _planner
from repro_torch.engine.policy import PACK, BitmapIndex, resolve_device

__all__ = ["PACK", "BICConfig", "PaperConfig", "BitmapIndex", "BICCore"]


@dataclasses.dataclass(frozen=True)
class BICConfig:
    """Geometry of one BIC core."""
    num_keys: int = 8          # M
    num_records: int = 16      # N
    words_per_record: int = 32 # W
    word_bits: int = 8         # 8-bit words in the paper
    backend: Literal["cuda", "ref", "bulk", "auto"] = "auto"

    @property
    def memory_bits(self) -> int:
        """Paper §IV accounting: one CAM cell costs 32 RAM bits, buffer is N*M."""
        cam_bits = self.words_per_record * PACK * self.word_bits
        buffer_bits = self.num_records * self.num_keys
        return cam_bits + buffer_bits


# The fabricated proof-of-concept chip (paper §IV): 8,320 memory bits.
PaperConfig = BICConfig(num_keys=8, num_records=16, words_per_record=32)


class BICCore:
    """One BIC core on ``device``: ``create`` builds the index, ``query``
    executes multi-dimensional predicates over it."""

    def __init__(self, config: BICConfig = PaperConfig, *, device="cuda"):
        self.config = config
        self.device = resolve_device(device)

    def create(self, records, keys) -> BitmapIndex:
        """records (N, W) int, keys (M,) int -> key-major BitmapIndex."""
        records = torch.as_tensor(records).to(self.device)
        keys = torch.as_tensor(keys).to(self.device)
        backend = _backends.get_backend(self.config.backend, self.device)
        return BitmapIndex(backend.create_index(records, keys),
                           num_records=records.shape[0])

    def session(self, index: BitmapIndex):
        """Wrap ``index`` in a read-only :class:`repro_torch.db.BitmapDB`
        query session."""
        from repro_torch.db.session import BitmapDB
        return BitmapDB.from_index(index, backend=self.config.backend)

    def query(self, index: BitmapIndex, include: Sequence[int] = (),
              exclude: Sequence[int] = (), *,
              where: _planner.Pred | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The paper's example: ``query(idx, include=[2, 4], exclude=[5])``
        answers "all objects containing A2 and A4 but not A5"; ``where``
        takes an arbitrary AND/OR/NOT predicate tree instead.  Returns
        (packed result row, matching-object count)."""
        from repro_torch.db.session import include_exclude_pred
        if where is None:
            where = include_exclude_pred(include, exclude)
        elif include or exclude:
            raise ValueError("pass either include/exclude or where=, not both")
        return self.session(index).query(where).raw

    def query_many(self, index: BitmapIndex,
                   predicates: Sequence[_planner.Pred]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Serve a whole batch of predicate trees (or pre-built plans) in a
        handful of bucket dispatches; (rows (Q, Nw) int32, counts (Q,)
        int32) in input order."""
        return self.session(index).serve_step()(predicates)

    def batch_create(self, records, keys) -> BitmapIndex:
        """Index B batches of records with shared keys by flattening the
        batch into the record axis."""
        records = torch.as_tensor(records)
        b, n, w = records.shape
        return self.create(records.reshape(b * n, w), keys)
