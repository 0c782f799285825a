"""CAM match stage of the BIC core: the ``cam_match`` CUDA kernel
(``csrc/cam_match.cu``) and its plain-torch version.

records (N, W) int32 x keys (M,) int32 -> record-major match bits
(N, ceil(M/32)) int32, packed LSB-first along the key axis.  Keys past M in
the last word read as no-match (the bits the key sentinel gives).

Replaces ``src/repro/kernels/cam_match.py::cam_match``; the source note in
the ``.cu`` file gives the kernel's bound and design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def cam_match_plain(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The plain-torch version (record-chunked oracle)."""
    return ref.cam_match(records, keys)


def cam_match(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; run the plain version on CPU
    tensors.  Takes contiguous int32 records (N, W) and keys (M,)."""
    name = "cam_match"
    card = _build.on_card(name, records, keys)
    _build.require(name, records.dtype == torch.int32
                   and keys.dtype == torch.int32, "records/keys must be int32")
    _build.require(name, records.dim() == 2 and keys.dim() == 1,
                   f"want records (N, W) and keys (M,), got "
                   f"{tuple(records.shape)} and {tuple(keys.shape)}")
    if not card:
        return cam_match_plain(records, keys)
    _build.require(name, records.is_contiguous() and keys.is_contiguous(),
                   "records/keys must be contiguous")
    n, w = records.shape
    (m,) = keys.shape
    out = torch.empty((n, ref.num_words(m)), dtype=torch.int32,
                      device=records.device)
    fn = _build.library(name)
    _build.check(fn(_build.ptr(records), _build.ptr(keys), _build.ptr(out),
                    n, w, m, _build.stream(records.device)), name)
    cam_match.launches += 1
    return out


cam_match.launches = 0
