"""Canonical padding / sentinel policy for every bitmap-index execution path.

The port's twin of ``repro.engine.policy``:

  * records pad with :data:`RECORD_SENTINEL` (-1) — a padded record matches
    no key, so its index column is all-zero;
  * keys pad with :data:`KEY_SENTINEL` (-2) — a padded key matches no
    record (and differs from the record sentinel);
  * packed query results carry garbage bits past ``num_records`` whenever an
    operand row enters inverted; :func:`mask_tail` zeroes them and recounts.

Packed words are ``torch.int32`` carrying the reference's ``uint32`` bits;
:class:`BitmapIndex` is the packed key-major index container all layers
exchange, and :meth:`BitmapIndex.from_numpy` / :meth:`BitmapIndex.to_numpy`
carry an index across from (and back to) the reference's numpy ``uint32``
words.  :func:`resolve_device` is the one rule for where an entry point
runs: on the card unless the caller asks for the CPU, never quietly on the
CPU when the card is missing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import (KEY_SENTINEL, PACK,  # noqa: F401
                                     RECORD_SENTINEL, num_words, pad_keys,
                                     pad_records, popcount, round_up, shr,
                                     tail_mask)


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no GPU is present (entry points default to ``"cuda"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain-torch path")
    return dev


def stream_sync(device) -> None:
    """Wait for the work queued on ``device``'s current stream (nothing to
    wait for on the CPU): the port's ``block_until_ready``, which also
    surfaces a kernel fault in the call that queued the kernel."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def mask_tail(result: torch.Tensor, num_records: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero bits >= num_records of (..., nw) packed rows (they exist only
    due to 32-bit packing) and return (masked rows, popcounts (...) int32)."""
    masked = result & tail_mask(result.shape[-1], int(num_records),
                                result.device)
    count = popcount(masked).sum(dim=-1, dtype=torch.int32)
    return masked, count


def splice_into(buf: torch.Tensor, bit_offset: int,
                block: torch.Tensor) -> None:
    """In-place OR of packed ``block`` (M, BW) into ``buf`` (M, W) at
    ``bit_offset`` — for buffers no snapshot shares (callers that must keep
    snapshots valid use :func:`splice_packed`)."""
    m, bw = block.shape
    off = bit_offset % PACK
    full = bit_offset // PACK
    if full + bw + 1 > buf.shape[1]:
        raise ValueError(f"splice window [{full}, {full + bw + 1}) past the "
                         f"buffer's {buf.shape[1]} words")
    region = buf[:, full:full + bw + 1]
    if off == 0:
        # a shift by 32 is undefined (CUDA, torch, XLA alike); at off == 0
        # the carry into the next word is zero anyway
        region[:, :bw] |= block
        return
    region[:, :bw] |= block << off
    region[:, 1:] |= shr(block, PACK - off)


def splice_packed(buf: torch.Tensor, bit_offset: int,
                  block: torch.Tensor) -> torch.Tensor:
    """OR packed ``block`` rows (M, BW) into a copy of the packed capacity
    buffer ``buf`` (M, W) at ``bit_offset`` and return the copy — functional
    like the reference, so a snapshot of ``buf`` stays valid.  Caller
    guarantees that bits past each logical tail are zero."""
    out = buf.clone()
    splice_into(out, int(bit_offset), block)
    return out


def extract_packed(packed: torch.Tensor, start: int, count: int
                   ) -> torch.Tensor:
    """Copy packed bit columns ``[start, start + count)`` out of (M, W)
    packed rows into a fresh ``(M, ceil(count/32))`` packed array with
    zeroed tail bits — the inverse of :func:`splice_packed`."""
    m, w = packed.shape
    nw = num_words(count)
    off = start % PACK
    w0 = start // PACK
    need = w0 + nw + (1 if off else 0)
    if need > w:
        packed = torch.cat([packed, packed.new_zeros((m, need - w))], dim=1)
    if off:
        lo = shr(packed[:, w0:w0 + nw], off)
        hi = packed[:, w0 + 1:w0 + 1 + nw] << (PACK - off)
        out = lo | hi
    else:
        out = packed[:, w0:w0 + nw]
    return out & tail_mask(nw, count, packed.device)


@dataclasses.dataclass
class BitmapIndex:
    """Key-major packed bitmap index: rows = keys, columns = records."""
    packed: torch.Tensor          # (M, ceil(N/32)) int32
    num_records: int

    @property
    def num_keys(self) -> int:
        return self.packed.shape[0]

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def row(self, key_idx: int) -> torch.Tensor:
        return self.packed[key_idx]

    def to_dense(self) -> torch.Tensor:
        """(M, N) {0,1} — for tests and small examples only."""
        return ref.unpack_bits(self.packed, self.num_records)

    @classmethod
    def from_numpy(cls, packed_u32: np.ndarray, num_records: int, *,
                   device="cuda") -> "BitmapIndex":
        """The reference's packed index — numpy ``uint32`` (M,
        ceil(N/32)), bits past ``num_records`` zero — as the port's index
        on ``device``."""
        arr = np.asarray(packed_u32)
        if arr.dtype != np.uint32 or arr.ndim != 2:
            raise ValueError(f"want a 2-D uint32 array, got {arr.dtype} "
                             f"{arr.shape}")
        n = int(num_records)
        if arr.shape[1] != num_words(n):
            raise ValueError(f"{arr.shape[1]} words per row do not hold "
                             f"{n} records ({num_words(n)} words)")
        rem = n % PACK
        if rem and arr.size and np.any(arr[:, -1] >> np.uint32(rem)):
            raise ValueError("bits past num_records are set")
        words = torch.from_numpy(np.array(arr, copy=True).view(np.int32))
        return cls(words.to(resolve_device(device)), n)

    def to_numpy(self) -> np.ndarray:
        """The packed words as the reference's numpy ``uint32`` array."""
        return self.packed.cpu().contiguous().numpy().view(np.uint32)
