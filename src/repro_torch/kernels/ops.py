"""Public entry points for the BIC kernels, shape-tolerant.

The wrappers accept any integer dtype and layout, make the contiguous int32
operands the kernels take, and route by device: on CUDA tensors they launch
the hand-written kernels, on CPU tensors the kernels' plain versions run.
The kernels mask every ragged edge by bounds, so no shape is padded here:
padded words never exist, so they can never count (the JAX wrappers pad to
block multiples and add a guard row for all-inverted queries instead,
``src/repro/kernels/ops.py:90-98``).  ``ref.py`` holds the oracles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmap_ops as _bq
from repro_torch.kernels import ref
from repro_torch.kernels.bit_transpose import bit_transpose as _bit_transpose
from repro_torch.kernels.cam_match import cam_match as _cam_match


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def cam_match(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """records (N, W) int, keys (M,) int -> packed (N, ceil(M/32)) int32."""
    return _cam_match(_i32(records), _i32(keys))


def transpose(packed: torch.Tensor) -> torch.Tensor:
    """Packed (R, Cw) -> (Cw*32, ceil(R/32)) int32 (zero-padded R)."""
    return _bit_transpose(_i32(packed))


def query(rows: torch.Tensor, invert: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused AND_k (invert_k ? ~row_k : row_k) + popcount over packed rows
    (K, Nw); tail bits past the record count are not masked."""
    return _bq.bitmap_query(_i32(rows), _i32(invert))


def create_index(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Full BIC pipeline (CAM match -> buffer -> TM transpose): records
    (N, W), keys (M,) -> key-major packed bitmap (M, ceil(N/32)), pad bits
    past N zero."""
    record_major = cam_match(records, keys)          # (N, Mw)
    key_major = transpose(record_major)              # (Mw*32, ceil(N/32))
    return key_major[: keys.shape[0]]


__all__ = ["cam_match", "transpose", "query", "create_index", "ref"]
