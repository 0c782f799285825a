"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors every kernel wrapper of ``repro_torch.kernels`` runs its
plain-torch version; these tests hold those (and the shape-tolerant
``ops`` wrappers around them) against ``repro.kernels.ref`` and against the
Pallas kernels in interpret mode, on the same seeded numpy inputs.  Packed
words are integers, so every comparison is bit-identical, with no
tolerance.  The CUDA kernels themselves are held against these plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import bulk as jbulk
from repro.kernels import bit_transpose as jbit_transpose
from repro.kernels import bitmap_ops as jbitmap_ops
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bit_transpose as tbt
from repro_torch.kernels import bitmap_ops as tbq
from repro_torch.kernels import cam_match as tcm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_checks import any_int32_cam_inputs

# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)


def u32(t: torch.Tensor) -> np.ndarray:
    """The reference's uint32 view of the port's int32 words."""
    return t.contiguous().numpy().view(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    """numpy uint32 words as the port's int32 words."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


# --------------------------------------------------------------- packing
@pytest.mark.parametrize("lead,length", [((), 32), ((3,), 96), ((2, 5), 64)])
def test_pack_unpack_match_reference(lead, length):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (*lead, length)).astype(np.int32)
    got = tref.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(u32(got),
                                  np.asarray(jref.pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(tref.unpack_bits(got).numpy(), bits)


def test_popcount_and_shift_edges():
    edge = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555],
                    np.uint32)
    x = np.concatenate([edge, words(np.random.default_rng(2), 1000)])
    np.testing.assert_array_equal(tref.popcount(t32(x)).numpy(),
                                  np.bitwise_count(x).astype(np.int32))
    for s in (0, 1, 5, 31):
        np.testing.assert_array_equal(u32(tref.shr(t32(x), s)), x >> s)


# ------------------------------------------------------------- cam_match
@pytest.mark.parametrize("n,w,m", [(8, 32, 32), (19, 7, 37), (1, 3, 1)])
def test_cam_match_unpacked_matches_reference(n, w, m):
    """The unpacked match matrix, bit-identical to the reference's, and
    packing it gives the packed plain version's words."""
    rng = np.random.default_rng(n * 1000 + m)
    records = rng.integers(0, 2 * m, (n, w), dtype=np.int32)
    keys = rng.integers(0, 2 * m, m, dtype=np.int32)
    got = tref.cam_match_unpacked(torch.from_numpy(records),
                                  torch.from_numpy(keys))
    want = jref.cam_match_unpacked(jnp.asarray(records), jnp.asarray(keys))
    assert got.shape == (n, m) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    pad = (-m) % 32
    packed = tref.pack_bits(torch.nn.functional.pad(got, (0, pad)))
    np.testing.assert_array_equal(
        u32(packed), u32(tref.cam_match(torch.from_numpy(records),
                                        torch.from_numpy(keys))))


@pytest.mark.parametrize("n,w,m", [
    (8, 32, 32),         # paper-like core geometry
    (64, 32, 128),
    (19, 7, 37),         # ragged N, W and M
    (1, 3, 1),
])
def test_cam_match_plain_matches_reference_and_pallas(n, w, m):
    rng = np.random.default_rng(n * 1000 + m)
    records = rng.integers(0, 256, (n, w), dtype=np.int32)
    keys = rng.integers(0, 256, (m,), dtype=np.int32)
    got = tcm.cam_match(torch.from_numpy(records), torch.from_numpy(keys))
    pallas = jops.cam_match(jnp.asarray(records), jnp.asarray(keys))
    np.testing.assert_array_equal(u32(got), np.asarray(pallas))
    if m % 32 == 0:
        np.testing.assert_array_equal(
            u32(got), np.asarray(jref.cam_match(jnp.asarray(records),
                                                jnp.asarray(keys))))


@pytest.mark.parametrize("n,w,m", [
    (40, 7, 37),         # ragged, keys outside the 256-entry table
    (33, 32, 256),       # the paper's geometry
    (20, 500, 64),       # records wider than one staged pass
    (9, 1, 1),
])
def test_cam_match_plain_any_int32_matches_reference_and_pallas(n, w, m):
    rng = np.random.default_rng(n * 7 + w + m)
    records, keys = any_int32_cam_inputs(rng, n, w, m)
    got = tcm.cam_match(torch.from_numpy(records), torch.from_numpy(keys))
    assert u32(got).any()                 # the cases do match something
    pallas = jops.cam_match(jnp.asarray(records), jnp.asarray(keys))
    np.testing.assert_array_equal(u32(got), np.asarray(pallas))
    if m % 32 == 0:
        np.testing.assert_array_equal(
            u32(got), np.asarray(jref.cam_match(jnp.asarray(records),
                                                jnp.asarray(keys))))


def test_cam_match_chunking_is_bit_identical(monkeypatch):
    rng = np.random.default_rng(3)
    records = torch.from_numpy(rng.integers(0, 64, (300, 9), dtype=np.int32))
    keys = torch.arange(70, dtype=torch.int32)
    whole = tref.cam_match(records, keys)
    monkeypatch.setattr(tref, "CHUNK_BYTES", 96 * 7)   # 7-record chunks
    np.testing.assert_array_equal(tref.cam_match(records, keys).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int16, np.int64])
def test_ops_cam_match_dtypes(dtype):
    rng = np.random.default_rng(4)
    records = rng.integers(0, 120, (16, 8)).astype(dtype)
    keys = rng.integers(0, 120, (32,)).astype(dtype)
    got = tops.cam_match(torch.from_numpy(records), torch.from_numpy(keys))
    want = jref.cam_match(jnp.asarray(records.astype(np.int32)),
                          jnp.asarray(keys.astype(np.int32)))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


# --------------------------------------------------------- bit_transpose
@pytest.mark.parametrize("r,cw", [(32, 1), (64, 4), (256, 16), (1024, 8)])
def test_bit_transpose_plain_matches_reference(r, cw):
    x = words(np.random.default_rng(r + cw), r, cw)
    got = tbt.bit_transpose(t32(x))
    np.testing.assert_array_equal(u32(got),
                                  np.asarray(jref.bit_transpose(jnp.asarray(x))))


@pytest.mark.parametrize("r,cw", [(19, 3), (33, 2), (1, 1)])
def test_ops_transpose_ragged_matches_pallas(r, cw):
    x = words(np.random.default_rng(7 * r + cw), r, cw)
    got = tops.transpose(t32(x))
    np.testing.assert_array_equal(u32(got),
                                  np.asarray(jops.transpose(jnp.asarray(x))))


def test_bit_transpose_chunking_is_bit_identical(monkeypatch):
    x = t32(words(np.random.default_rng(5), 300, 3))
    whole = tref.bit_transpose(x)
    monkeypatch.setattr(tref, "CHUNK_BYTES", 4 * 96 * 64)   # 64-row chunks
    np.testing.assert_array_equal(tref.bit_transpose(x).numpy(),
                                  whole.numpy())


# -------------------------------- bit_transpose's CUDA tile arithmetic
# A torch model of what csrc/bit_transpose.cu runs: the butterfly across the
# 32 lanes of a warp (shuffle partner lane ^ j, a rotate by j or 32 - j and
# a masked select), the two shared-memory swizzles and the order of the
# item's copies, reads, writes and stores.  Words are held as int64 with
# uint32 values.
_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
_LANE = torch.arange(32)
_ROWS, _COLS = 1024, 8                  # rows x column words of one item


def _shuffle_transpose32(x: torch.Tensor) -> torch.Tensor:
    """x (..., 32): lane i holds word i of a tile; returns lane b holding
    output word b."""
    for k, m in enumerate(_MASKS):
        j = 16 >> k
        up = (_LANE & j) == 0
        take = torch.where(up, torch.tensor(~m & 0xFFFFFFFF), torch.tensor(m))
        rot = torch.where(up, torch.tensor(j), torch.tensor(32 - j))
        p = x[..., _LANE ^ j]                           # __shfl_xor_sync
        q = ((p << rot) | (p >> (32 - rot))) & 0xFFFFFFFF  # funnel shift
        x = (x & ~take) | (q & take)
    return x


def _in_slot(lr, c):
    """Stage word of item word (row lr, column word c): the row's two
    16-byte chunks swap on every other group of 4 rows."""
    return lr * _COLS + ((((c >> 2) ^ (lr >> 2)) & 1) << 2) + (c & 3)


def _out_slot(o, tr):
    """Stage word of output row o (= 32 c + b) of the item, row tile tr."""
    return o * 32 + (tr ^ (o & 31))


def _model_bit_transpose(packed: torch.Tensor) -> torch.Tensor:
    """The kernel's item loop on the CPU: copy, lane reads, butterfly,
    staged writes and row stores, with its index arithmetic."""
    r, cw = packed.shape
    rw = tref.num_words(r)
    src = packed.long() & 0xFFFFFFFF
    out = torch.zeros((cw * 32, rw), dtype=torch.int64)
    lr, c = torch.meshgrid(torch.arange(_ROWS), torch.arange(_COLS),
                           indexing="ij")
    tr = torch.arange(32)[:, None]                      # (tile, lane)
    row_of = tr * 32 + _LANE                            # lane i reads row i
    sw = (_LANE >> 2) & 1
    o = torch.arange(_COLS * 32)[:, None]               # (out row, lane)
    for row0 in range(0, r, _ROWS):
        for col0 in range(0, cw, _COLS):
            stage = torch.zeros(_ROWS * _COLS, dtype=torch.int64)
            gr, gc = row0 + lr, col0 + c
            ok = (gr < r) & (gc < cw)                   # the rest zero-filled
            stage[_in_slot(lr[ok], c[ok])] = src[gr[ok], gc[ok]]
            base = row_of * _COLS
            lo = stage[base[..., None] + 4 * sw[:, None] + torch.arange(4)]
            hi = stage[base[..., None] + 4 * (sw ^ 1)[:, None]
                       + torch.arange(4)]
            x = torch.cat([lo, hi], -1)                 # (tr, lane, c)
            x = _shuffle_transpose32(x.transpose(1, 2)).transpose(1, 2)
            tile, b, cc = torch.meshgrid(torch.arange(32), _LANE,
                                         torch.arange(_COLS), indexing="ij")
            stage[_out_slot(cc * 32 + b, tile)] = x[tile, b, cc]
            gcol, t = col0 + o // 32, row0 // 32 + _LANE
            keep = (gcol < cw) & (t < rw)
            val = stage[_out_slot(o, _LANE)]
            gcol, t = gcol.expand_as(val), t.expand_as(val)
            orow = (gcol * 32 + o % 32).expand_as(val)
            out[orow[keep], t[keep]] = val[keep]
    return (out & 0xFFFFFFFF).numpy().astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_shuffle_butterfly_matches_reference_transpose32(seed):
    """The kernel's lane butterfly on random tiles against the reference
    kernel's _transpose32 (JAX, CPU) and the port's plain version."""
    rng = np.random.default_rng(100 + seed)
    tiles = words(rng, 16, 32)                          # 16 tiles, row-major
    got = _shuffle_transpose32(torch.from_numpy(tiles.astype(np.int64)))
    got = got.numpy().astype(np.uint32)
    want = np.asarray(jbit_transpose._transpose32(jnp.asarray(tiles.T))).T
    np.testing.assert_array_equal(got, want)
    for i in range(tiles.shape[0]):
        plain = tref.bit_transpose(t32(tiles[i][:, None]))   # (32, 1)
        np.testing.assert_array_equal(got[i], u32(plain)[:, 0])


@pytest.mark.parametrize("r,cw", [(1, 1), (31, 3), (33, 8), (1025, 17),
                                  (2100, 8)])
def test_kernel_model_matches_reference(r, cw):
    """The whole item loop, ragged rows and column words included."""
    x = words(np.random.default_rng(r * 31 + cw), r, cw)
    want = u32(tref.bit_transpose(t32(x)))
    np.testing.assert_array_equal(
        _model_bit_transpose(t32(x)).view(np.uint32), want)
    np.testing.assert_array_equal(
        want, np.asarray(jops.transpose(jnp.asarray(x))))


def test_kernel_swizzles_are_bijections_on_distinct_banks():
    """Both stage layouts fill the 8192-word stage exactly once, 16-byte
    chunks stay whole and aligned, and every shared-memory access of a warp
    (each quarter-warp's eight 16-byte reads, a warp's 32 word writes and
    32 word reads) covers 32 distinct banks."""
    lr, c = np.meshgrid(np.arange(_ROWS), np.arange(_COLS), indexing="ij")
    slots = _in_slot(lr, c)
    assert sorted(slots.ravel()) == list(range(_ROWS * _COLS))
    assert (slots[:, [0, 4]] % 4 == 0).all()
    assert (slots[:, 1:4] - slots[:, :1] == [1, 2, 3]).all()
    o, tr = np.meshgrid(np.arange(_COLS * 32), np.arange(32), indexing="ij")
    assert sorted(_out_slot(o, tr).ravel()) == list(range(_ROWS * _COLS))
    lane = np.arange(32)
    for t in range(32):
        row = t * 32 + lane
        for half in (0, 4):                             # the lo and hi reads
            first = _in_slot(row, half)
            for q in range(4):
                banks = (first[8 * q:8 * q + 8, None] + np.arange(4)) % 32
                assert len(set(banks.ravel())) == 32
        for cc in range(_COLS):                         # staged writes
            assert len(set(_out_slot(cc * 32 + lane, t) % 32)) == 32
    for oo in range(_COLS * 32):                        # row reads
        assert len(set(_out_slot(oo, lane) % 32)) == 32


# ---------------------------------------------------------- bitmap_query
@pytest.mark.parametrize("k,nw,invert", [
    (3, 64, [0, 0, 1]),
    (4, 100, [1, 1, 1, 1]),      # every operand inverted, ragged Nw
    (1, 17, [1]),
    (5, 2048, [0, 1, 0, 1, 1]),
])
def test_bitmap_query_matches_reference_and_pallas(k, nw, invert):
    rows = words(np.random.default_rng(k * nw), k, nw)
    inv = np.asarray(invert, np.int32)
    got_r, got_c = tbq.bitmap_query(t32(rows), torch.from_numpy(inv))
    want_r, want_c = jref.bitmap_query(jnp.asarray(rows), jnp.asarray(inv))
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    assert int(got_c) == int(want_c)
    pal_r, pal_c = jops.query(jnp.asarray(rows), jnp.asarray(inv))
    np.testing.assert_array_equal(u32(tops.query(t32(rows),
                                                 torch.from_numpy(inv))[0]),
                                  np.asarray(pal_r))
    assert int(got_c) == int(pal_c)
    assert got_c.dtype == torch.int32


@pytest.mark.parametrize("k,nw", [(2, 1025), (3, 1026), (33, 1027),
                                  (33, 2048), (1, 5), (8, 3)])
def test_bitmap_query_odd_widths_match_reference_and_pallas(k, nw):
    """Ragged widths (Nw % 4 != 0 puts rows k >= 1 off a 16-byte
    boundary) and K past 32, mixed inversions."""
    rng = np.random.default_rng(k * 7 + nw)
    rows = words(rng, k, nw)
    inv = rng.integers(0, 2, k).astype(np.int32)
    got_r, got_c = tbq.bitmap_query(t32(rows), torch.from_numpy(inv))
    want_r, want_c = jref.bitmap_query(jnp.asarray(rows), jnp.asarray(inv))
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    pal_r, pal_c = jops.query(jnp.asarray(rows), jnp.asarray(inv))
    np.testing.assert_array_equal(u32(got_r), np.asarray(pal_r))
    assert int(got_c) == int(want_c) == int(pal_c)


# ---------------------------------------------------------- bulk_program
def _program(rng, m, q, g, p, l):
    sels = rng.integers(0, m + 1, (q, g, p, l)).astype(np.int32)
    invs = rng.integers(0, 2, (q, g, p, l)).astype(np.int32)
    post = np.where(rng.random((q, g, p)) < 0.3, 0xFFFFFFFF, 0
                    ).astype(np.uint32)
    return sels, invs, post


@pytest.mark.parametrize("m,nw,q,g,p,l", [
    (8, 64, 4, 2, 2, 2),
    (13, 37, 2, 4, 1, 4),       # ragged Nw
    (5, 1, 1, 1, 1, 1),
])
def test_bulk_program_plain_matches_pallas(m, nw, q, g, p, l):
    rng = np.random.default_rng(m * nw + q)
    aug = np.concatenate([words(rng, m, nw),
                          np.full((1, nw), 0xFFFFFFFF, np.uint32)])
    sels, invs, post = _program(rng, m, q, g, p, l)
    got = tbq.bulk_program(t32(aug), torch.from_numpy(sels),
                           torch.from_numpy(invs), t32(post))
    want = jbitmap_ops.bulk_program(jnp.asarray(aug), jnp.asarray(sels),
                                    jnp.asarray(invs), jnp.asarray(post),
                                    block_n=64)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_bulk_run_program_matches_pallas_run_program():
    from repro_torch.engine import bulk as tbulk
    rng = np.random.default_rng(11)
    m, nw, n = 9, 40, 40 * 32 - 13
    aug = np.concatenate([words(rng, m, nw),
                          np.full((1, nw), 0xFFFFFFFF, np.uint32)])
    sels, invs, post = _program(rng, m, 8, 2, 2, 4)
    got_r, got_c = tbulk.run_program(t32(aug), n, torch.from_numpy(sels),
                                     torch.from_numpy(invs), t32(post))
    want_r, want_c = jbulk.run_program_pallas(
        jnp.asarray(aug), n, jnp.asarray(sels), jnp.asarray(invs),
        jnp.asarray(post))
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


# ---------------------------------------------------------- create_index
@pytest.mark.parametrize("n,w,m", [(64, 32, 32), (100, 6, 37), (33, 32, 256)])
def test_create_index_matches_pallas(n, w, m):
    rng = np.random.default_rng(n + w + m)
    records = rng.integers(0, m, (n, w), dtype=np.int32)
    keys = np.arange(m, dtype=np.int32)
    got = tops.create_index(torch.from_numpy(records), torch.from_numpy(keys))
    want = jops.create_index(jnp.asarray(records), jnp.asarray(keys))
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    if n % 32 == 0 and m % 32 == 0:
        np.testing.assert_array_equal(
            u32(tref.create_index(torch.from_numpy(records),
                                  torch.from_numpy(keys))),
            np.asarray(jref.create_index(jnp.asarray(records),
                                         jnp.asarray(keys))))


# ------------------------------------------------------ wrapper contract
def test_wrappers_check_arguments_and_never_count_plain_runs():
    rec = torch.zeros((4, 2), dtype=torch.int32)
    keys = torch.zeros((3,), dtype=torch.int32)
    before = (tcm.cam_match.launches, tbt.bit_transpose.launches,
              tbq.bitmap_query.launches, tbq.bulk_program.launches)
    tcm.cam_match(rec, keys)
    tbt.bit_transpose(rec)
    tbq.bitmap_query(rec, torch.zeros((4,), dtype=torch.int32))
    assert before == (tcm.cam_match.launches, tbt.bit_transpose.launches,
                      tbq.bitmap_query.launches, tbq.bulk_program.launches)
    with pytest.raises(ValueError, match="int32"):
        tcm.cam_match(rec.long(), keys)
    with pytest.raises(ValueError, match="at least one"):
        tbq.bitmap_query(rec[:0], keys[:0])
    with pytest.raises(ValueError, match="device type 'meta'"):
        tbt.bit_transpose(torch.empty((32, 1), dtype=torch.int32,
                                      device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tcm.cam_match(rec, keys.to("meta"))


def test_launch_calls_the_entry_under_the_tensors_device(monkeypatch):
    """``_build.launch`` is every wrapper's way to its C entry: it calls the
    entry with the device's stream last while that device is current, and
    raises on a non-zero return code."""
    import contextlib
    from repro_torch.kernels import _build
    current, calls = [None], []

    @contextlib.contextmanager
    def device(d):
        current[0] = d
        yield
        current[0] = None

    def entry(*args):
        calls.append((current[0], args))
        return calls[-1][1][0]

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "library", lambda kernel: entry)
    monkeypatch.setattr(_build, "stream", lambda d: ("stream", d))
    card = torch.device("cuda", 1)
    _build.launch("cam_match", card, 0, 7)
    assert calls == [(card, (0, 7, ("stream", card)))]
    assert current[0] is None
    with pytest.raises(_build.KernelError, match="cam_match.*error 3"):
        _build.launch("cam_match", card, 3)
