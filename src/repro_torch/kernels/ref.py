"""Plain-torch reference oracles for the BIC kernels.

Conventions (shared by kernels, oracles and tests; the same as the JAX
package's ``repro.kernels.ref``):
  * A *record* is a row of W integer words (the paper uses 32 x 8-bit words).
  * ``cam_match``  : records (N, W) x keys (M,) -> record-major match bits,
                     packed along the key axis  -> (N, M/32) words.
  * ``bit_transpose``: packed (R, C/32) -> packed (C, R/32), i.e. bit (r, c)
                     of the logical R x C bit-matrix moves to bit (c, r).
  * Packing is LSB-first: bit j of word w covers logical column w*32 + j.

Storage: packed words are ``torch.int32`` tensors carrying the same bits as
the reference's ``uint32`` (compare through ``.numpy().view(np.uint32)``).
torch's ``>>`` on int32 is arithmetic, so every right shift that can see a
set sign bit goes through :func:`shr` (masked); torch has no popcount op,
so :func:`popcount` is a SWAR popcount.

The oracles chunk over records/rows so that their intermediates stay at a
few hundred MiB whatever the input size: the results are bit-identical to
an unchunked evaluation.
"""
from __future__ import annotations

import torch

PACK = 32

# Canonical padding/sentinel policy (the engine re-exports these via
# repro_torch.engine.policy):
#   * records pad with RECORD_SENTINEL — a padded record matches no key;
#   * keys pad with KEY_SENTINEL — a padded key matches no record, and the
#     two sentinels differ so sentinel never matches sentinel.
# Application data must not use the sentinel values as real key material.
RECORD_SENTINEL = -1
KEY_SENTINEL = -2

#: Bytes the oracles' largest intermediate may take per chunk.
CHUNK_BYTES = 256 << 20


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def num_words(n: int) -> int:
    """Packed 32-bit words needed for ``n`` bits."""
    return -(-n // PACK)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words by ``0 <= s < 32``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (PACK - s)) - 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 words (SWAR), as int32."""
    x = x - (shr(x, 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)   # now non-negative
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pad_records(records: torch.Tensor, n_to: int | None = None) -> torch.Tensor:
    """Pad (N, W) records to ``n_to`` rows (default: next PACK multiple)
    with the record sentinel, as int32."""
    n, w = records.shape
    n_to = round_up(n, PACK) if n_to is None else n_to
    out = torch.full((n_to, w), RECORD_SENTINEL, dtype=torch.int32,
                     device=records.device)
    out[:n] = records
    return out


def pad_keys(keys: torch.Tensor, m_to: int | None = None) -> torch.Tensor:
    """Pad (M,) keys to ``m_to`` entries (default: next PACK multiple) with
    the key sentinel, as int32."""
    (m,) = keys.shape
    m_to = round_up(m, PACK) if m_to is None else m_to
    out = torch.full((m_to,), KEY_SENTINEL, dtype=torch.int32,
                     device=keys.device)
    out[:m] = keys
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., L) bool/int tensor of {0, 1} into (..., L/32) int32
    words, LSB-first.  L must be a multiple of 32 (callers pad)."""
    *lead, length = bits.shape
    if length % PACK:
        raise ValueError(f"pack_bits: L={length} not a multiple of {PACK}")
    b = bits.reshape(*lead, length // PACK, PACK)
    out = torch.zeros((*lead, length // PACK), dtype=torch.int32,
                      device=bits.device)
    for j in range(PACK):
        out |= b[..., j].to(torch.int32) << j
    return out


def unpack_bits(packed: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> (..., L) int32 of {0, 1}."""
    *lead, lw = packed.shape
    shifts = torch.arange(PACK, dtype=torch.int32, device=packed.device)
    bits = ((packed[..., None] >> shifts) & 1).reshape(*lead, lw * PACK)
    if length is not None:
        bits = bits[..., :length]
    return bits


def cam_match(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """records (N, W) x keys (M,) -> packed (N, ceil(M/32)) int32 match
    bits: bit m of record n is set when any word of record n equals key m.
    Keys pad to a PACK multiple with :data:`KEY_SENTINEL`.  Chunked over
    records so the (chunk, M) match matrix stays under :data:`CHUNK_BYTES`
    (an unchunked (N, M, W) compare is 32 GiB at a 2^22-record block)."""
    n, w = records.shape
    ks = pad_keys(keys.to(torch.int32))
    mp = ks.shape[0]
    rec = records.to(torch.int32)
    out = torch.empty((n, mp // PACK), dtype=torch.int32,
                      device=records.device)
    chunk = max(1, CHUNK_BYTES // max(mp, 1))
    for lo in range(0, n, chunk):
        r = rec[lo:lo + chunk]
        match = torch.zeros((r.shape[0], mp), dtype=torch.bool,
                            device=records.device)
        for i in range(w):
            match |= r[:, i:i + 1] == ks[None, :]
        out[lo:lo + chunk] = pack_bits(match)
    return out


def bit_transpose(packed: torch.Tensor) -> torch.Tensor:
    """Packed bit-matrix transpose: (R, Cw) words for a logical R x (32 Cw)
    bit matrix -> (32 Cw, ceil(R/32)) words.  Rows past R read as zero.
    Chunked over 32-row groups."""
    r, cw = packed.shape
    c = cw * PACK
    rw = num_words(r)
    out = torch.empty((c, rw), dtype=torch.int32, device=packed.device)
    # one chunk holds `rows` rows unpacked to one int32 per bit
    rows = max(PACK, CHUNK_BYTES // (4 * max(c, 1)) // PACK * PACK)
    for lo in range(0, r, rows):
        x = packed[lo:lo + rows]
        n = x.shape[0]
        if n % PACK:
            x = torch.cat([x, x.new_zeros((PACK - n % PACK, cw))])
        bits = unpack_bits(x)                               # (n', C)
        out[:, lo // PACK:lo // PACK + x.shape[0] // PACK] = \
            pack_bits(bits.T.contiguous())
    return out


def bitmap_query(rows: torch.Tensor, invert: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bitmap query: rows (K, Nw) packed words, invert (K,) {0, 1}
    (1 = the row enters negated).  Returns (result row (Nw,), popcount ()
    int32) for AND_k (invert_k ? ~rows_k : rows_k)."""
    k = rows.shape[0]
    if k == 0:
        raise ValueError("bitmap_query needs at least one operand row")
    flips = -invert.to(device=rows.device, dtype=torch.int32)  # 0 or ~0
    result = rows[0] ^ flips[0]
    for i in range(1, k):
        result = result & (rows[i] ^ flips[i])
    count = popcount(result).sum(dtype=torch.int32)
    return result, count


def create_index(records: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Full reference BIC pipeline: records (N, W), keys (M,) -> key-major
    bitmap index, packed (M, N/32).  N, M % 32 == 0."""
    record_major = cam_match(records, keys)       # (N, M/32)
    return bit_transpose(record_major)            # (M, N/32)
