"""Streaming index runtime: incremental append into packed indexes.

The port's twin of the in-memory half of ``repro.engine.runtime``:

  * :func:`append_packed` — bit-splice one freshly indexed block onto a
    packed index;
  * :class:`StreamingIndexer` — grow one key-major index record-block by
    record-block with NO full rebuild: each block is indexed alone and
    bit-spliced onto the packed tail (a shift/carry merge when the current
    record count is not 32-aligned), into a geometrically grown capacity
    buffer;
  * :func:`fold_block_indexes` — fold per-block indexes of uniform blocks
    into one packed index.

The durable store hooks (``attach_store``/``spill``/``restore``), the
multi-core runtime and its energy accounting wait for later slices
(ROADMAP A3/A4).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.engine import backends, policy


def append_packed(packed: torch.Tensor, num_records: int,
                  block: torch.Tensor, block_records: int) -> torch.Tensor:
    """Bit-splice a freshly indexed ``block`` (M, ceil(n'/32)) onto a packed
    index (M, ceil(n/32)) holding ``num_records`` records.  Pad bits past
    each logical record count must be zero (every backend guarantees it)."""
    total_words = policy.num_words(num_records + block_records)
    m = packed.shape[0]
    buf = packed.new_zeros((m, packed.shape[1] + block.shape[1] + 1))
    buf[:, :packed.shape[1]] = packed
    policy.splice_into(buf, num_records, block)     # buf is fresh
    return buf[:, :total_words]


class StreamingIndexer:
    """Grow one key-major index record-block by record-block.

    ``append`` indexes only the incoming block and splices it in; the live
    index is always available via ``.index`` (bit-identical to a
    from-scratch rebuild over all records seen so far).  The packed words
    live in a geometrically doubled capacity buffer.

    The splice is functional, as in the reference: every append writes a
    fresh buffer (one device copy of the capacity buffer), so a
    ``(buffer, count)`` pair from :meth:`view` — the snapshot
    :mod:`repro_torch.db` results execute against — stays a bit-exact
    point-in-time view forever.
    """

    def __init__(self, keys, *, backend: str = "auto",
                 capacity_words: int = 16, device="cuda"):
        self.device = policy.resolve_device(device)
        self.keys = torch.as_tensor(keys).to(self.device, torch.int32)
        self.backend = backends.resolve_backend(backend, self.device)
        self._cap = max(int(capacity_words), 2)
        self._buf = torch.zeros((self.keys.shape[0], self._cap),
                                dtype=torch.int32, device=self.device)
        self._num_records = 0
        # pins the (buf, num_records) commit point of an append against
        # concurrent snapshot readers; held for the splice, not the build
        self._mu = threading.RLock()

    @property
    def num_records(self) -> int:
        return self._num_records

    def _grow(self, need_words: int) -> None:
        if need_words > self._cap:
            new = self._cap
            while new < need_words:
                new *= 2
            buf = self._buf.new_zeros((self._buf.shape[0], new))
            buf[:, :self._cap] = self._buf
            self._buf, self._cap = buf, new

    def _records(self, records) -> torch.Tensor:
        return torch.as_tensor(records).to(self.device).to(torch.int32)

    def append(self, records) -> policy.BitmapIndex:
        """Index a (N', W) record block and splice it in; returns the
        updated live index.  An empty block is a no-op (no dispatch)."""
        records = self._records(records)
        if records.shape[0] == 0:
            return self.index
        block = backends.get_backend(self.backend).create_index(
            records, self.keys)
        return self.append_indexed(records, block)

    def append_indexed(self, records, block: torch.Tensor
                       ) -> policy.BitmapIndex:
        """Splice in a block whose (M, ceil(N'/32)) index ``block`` was
        already built elsewhere."""
        n_new = int(records.shape[0])
        if n_new == 0:
            return self.index
        with self._mu:
            self._grow(self._num_records // policy.PACK + block.shape[1] + 1)
            self._buf = policy.splice_packed(self._buf, self._num_records,
                                             block)
            self._num_records += n_new
        return self.index

    def append_many(self, records) -> policy.BitmapIndex:
        """Append a batch of uniform blocks (B, N', W), block by block."""
        for block in self._records(records):
            self.append(block)
        return self.index

    def view(self) -> tuple[torch.Tensor, int]:
        """A consistent (capacity buffer, record count) pair even under a
        concurrent append."""
        with self._mu:
            return self._buf, self._num_records

    @property
    def index(self) -> policy.BitmapIndex:
        buf, n = self.view()
        return policy.BitmapIndex(buf[:, :policy.num_words(n)], n)


def fold_block_indexes(blocks: torch.Tensor,
                       block_records: int) -> policy.BitmapIndex:
    """Fold per-block indexes (B, M, BW) of uniform ``block_records``-record
    blocks into ONE packed index over the concatenated records."""
    b, m, bw = blocks.shape
    total = b * block_records
    buf = blocks.new_zeros((m, total // policy.PACK + bw + 1))
    for i in range(b):
        policy.splice_into(buf, i * block_records, blocks[i])
    return policy.BitmapIndex(buf[:, :policy.num_words(total)], total)
