"""Transpose-Matrix stage of the BIC core: the ``bit_transpose`` CUDA
kernel (``csrc/bit_transpose.cu``) and its plain-torch version.

Packed (R, Cw) int32 for a logical R x (32 Cw) bit matrix -> packed
(32 Cw, ceil(R/32)) int32; rows past R read as zero.

Replaces ``src/repro/kernels/bit_transpose.py::bit_transpose``; the source
note in the ``.cu`` file gives the kernel's bound and design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def bit_transpose_plain(packed: torch.Tensor) -> torch.Tensor:
    """The plain-torch version (row-chunked unpack / transpose / pack)."""
    return ref.bit_transpose(packed)


def bit_transpose(packed: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor; run the plain version on a CPU
    tensor.  Takes a contiguous int32 (R, Cw)."""
    name = "bit_transpose"
    card = _build.on_card(name, packed)
    _build.require(name, packed.dtype == torch.int32, "packed must be int32")
    _build.require(name, packed.dim() == 2,
                   f"want (R, Cw), got {tuple(packed.shape)}")
    if not card:
        return bit_transpose_plain(packed)
    _build.require(name, packed.is_contiguous(), "packed must be contiguous")
    r, cw = packed.shape
    out = torch.empty((cw * ref.PACK, ref.num_words(r)), dtype=torch.int32,
                      device=packed.device)
    fn = _build.library(name)
    _build.check(fn(_build.ptr(packed), _build.ptr(out), r, cw,
                    _build.stream(packed.device)), name)
    bit_transpose.launches += 1
    return out


bit_transpose.launches = 0
