"""The port's engine (policy, planner, batch, bulk, backends, runtime)
against the JAX package's engine, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages; packed
words and counts must be bit-identical (integers: no tolerance).  The JAX
side runs its ``ref`` backend (the cost model behind ``auto`` is held
against the reference in ``tests/test_torch_costmodel.py``); the port runs
each of its backends, ``cuda`` included — on CPU tensors its kernel
wrappers run their plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import batch as jbatch
from repro.engine import bulk as jbulk
from repro.engine import planner as jplanner
from repro.engine import policy as jpolicy
from repro.engine import runtime as jruntime
from repro_torch.engine import backends as tbackends
from repro_torch.engine import batch as tbatch
from repro_torch.engine import bulk as tbulk
from repro_torch.engine import planner as tplanner
from repro_torch.engine import policy as tpolicy
from repro_torch.engine import runtime as truntime
from repro_torch.kernels import bitmap_ops as tbq

PORT_BACKENDS = ("ref", "bulk", "cuda")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)


def zero_tail(a: np.ndarray, n: int) -> np.ndarray:
    """Clear the bits past record ``n`` (the backends' pad guarantee)."""
    a = a.copy()
    if n % 32:
        a[..., -1] &= np.uint32((1 << (n % 32)) - 1)
    return a


def _random_pred(rng, depth, kind):
    """One random predicate tree, built for both packages alike."""
    m = 12
    if depth == 0 or rng.random() < 0.3:
        leaf = kind.key(int(rng.integers(0, m)))
        return ~leaf if rng.random() < 0.4 else leaf
    children = tuple(_random_pred(rng, depth - 1, kind)
                     for _ in range(int(rng.integers(2, 4))))
    node = kind.And(children) if rng.random() < 0.5 else kind.Or(children)
    return ~node if rng.random() < 0.2 else node


def _wave(seed, count, kind):
    rng = np.random.default_rng(seed)
    preds = [_random_pred(rng, 3, kind) for _ in range(count)]
    k = kind.key
    preds.append(k(1) & ~k(1))                       # contradiction
    preds.append(~(k(2) & ~k(2)))                    # tautology
    preds.append(kind.And(tuple(k(i) | k(i + 1)     # 2^8 > 128 clauses:
                                for i in range(8))))  # composite plan
    return preds


# ---------------------------------------------------------------- policy
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100, 160])
def test_mask_tail_matches_reference(n):
    row = words(np.random.default_rng(n), 5)
    got_r, got_c = tpolicy.mask_tail(t32(row), n)
    want_r, want_c = jpolicy.mask_tail(jnp.asarray(row), n)
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    assert int(got_c) == int(want_c)


@pytest.mark.parametrize("bit_offset", [0, 64, 5, 31, 33, 95])
def test_splice_packed_matches_reference(bit_offset):
    """Shift 0 (word-aligned: no carry, the shift-by-32 trouble spot) and
    shifts that straddle a word boundary."""
    rng = np.random.default_rng(bit_offset)
    buf = zero_tail(words(rng, 4, 10), bit_offset)
    buf[:, (bit_offset + 31) // 32:] = 0
    block = zero_tail(words(rng, 4, 3), 3 * 32 - 7)
    got = tpolicy.splice_packed(t32(buf), bit_offset, t32(block))
    want = jpolicy.splice_packed(jnp.asarray(buf), jnp.int32(bit_offset),
                                 jnp.asarray(block))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_splice_packed_leaves_its_input_alone():
    buf = t32(np.zeros((2, 4), np.uint32))
    tpolicy.splice_packed(buf, 3, t32(np.full((2, 1), 7, np.uint32)))
    assert not buf.any()
    with pytest.raises(ValueError, match="splice window"):
        tpolicy.splice_packed(buf, 96, buf[:, :1])


@pytest.mark.parametrize("start,count", [(0, 64), (5, 40), (32, 33),
                                         (37, 91), (100, 1)])
def test_extract_packed_matches_reference(start, count):
    packed = words(np.random.default_rng(start + count), 3, 6)
    got = tpolicy.extract_packed(t32(packed), start, count)
    want = jpolicy.extract_packed(jnp.asarray(packed), start, count)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_bitmap_index_numpy_round_trip_and_checks():
    packed = zero_tail(words(np.random.default_rng(0), 3, 4), 100)
    idx = tpolicy.BitmapIndex.from_numpy(packed, 100, device="cpu")
    np.testing.assert_array_equal(idx.to_numpy(), packed)
    np.testing.assert_array_equal(
        idx.to_dense().numpy(),
        np.asarray(jpolicy.BitmapIndex(jnp.asarray(packed), 100).to_dense()))
    packed[0, 0] ^= 1                       # the port copies its input
    assert idx.to_numpy()[0, 0] != packed[0, 0]
    with pytest.raises(ValueError, match="past num_records"):
        tpolicy.BitmapIndex.from_numpy(words(np.random.default_rng(1), 3, 4),
                                       100, device="cpu")
    with pytest.raises(ValueError, match="words per row"):
        tpolicy.BitmapIndex.from_numpy(packed, 200, device="cpu")


# ------------------------------------------------------------- bulk sweep
@pytest.mark.parametrize("m1,qgp,nw", [(257, 64, 1 << 20), (9, 4, 37),
                                       (1000, 1000, 3000)])
def test_tile_words_matches_reference(m1, qgp, nw):
    assert tbulk.tile_words(m1, qgp, nw) == jbulk.tile_words(m1, qgp, nw)


def test_bulk_sweep_query_chunking_is_bit_identical(monkeypatch):
    rng = np.random.default_rng(3)
    m, nw, shape = 6, 40, (8, 2, 2, 2)
    aug = np.concatenate([words(rng, m, nw),
                          np.full((1, nw), 0xFFFFFFFF, np.uint32)])
    sels = rng.integers(0, m + 1, shape).astype(np.int32)
    invs = rng.integers(0, 2, shape).astype(np.int32)
    post = np.where(rng.random(shape[:3]) < 0.5, 0xFFFFFFFF, 0
                    ).astype(np.uint32)
    args = (t32(aug), torch.from_numpy(sels), torch.from_numpy(invs),
            t32(post))
    whole = tbq.bulk_program_plain(*args)
    monkeypatch.setattr(tbq, "SWEEP_BUDGET_BYTES", 2 * 2 * nw * 4 * 3)
    np.testing.assert_array_equal(tbq.bulk_program_plain(*args).numpy(),
                                  whole.numpy())
    want = jbulk._sweep_jnp(jnp.asarray(aug), jnp.asarray(sels),
                            jnp.asarray(invs), jnp.asarray(post))
    np.testing.assert_array_equal(u32(whole), np.asarray(want))


def test_run_program_raises_off_cuda_and_cpu():
    z = torch.zeros((1, 1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tbulk.run_program(torch.zeros((2, 1), dtype=torch.int32,
                                      device="meta"), 1, z, z, z[..., 0])


# --------------------------------------------------------------- planner
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_planner_execute_matches_reference(backend):
    rng = np.random.default_rng(5)
    n = 300
    packed = words(rng, 12, 10)             # tail bits arbitrary on purpose
    for tp, jp in zip(_wave(6, 12, tplanner), _wave(6, 12, jplanner)):
        got_r, got_c = tplanner.execute(t32(packed), tp, num_records=n,
                                        backend=backend)
        want_r, want_c = jplanner.execute(jnp.asarray(packed), jp,
                                          num_records=n, backend="ref")
        np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
        assert int(got_c) == int(want_c)


def test_plans_and_factoring_equal_reference():
    for tp, jp in zip(_wave(8, 20, tplanner), _wave(8, 20, jplanner)):
        tpl, jpl = tplanner.plan(tp), jplanner.plan(jp)
        assert repr(tpl) == repr(jpl)
        if isinstance(tpl, tplanner.QueryPlan) and tpl.clauses:
            assert repr(tplanner.factor(tpl)) == repr(jplanner.factor(jpl))
            assert tbatch.lower(tpl) == jbatch.lower(jpl)
            assert (tbatch.canonical_shape(tbatch.lower(tpl))
                    == jbatch.canonical_shape(jbatch.lower(jpl)))


def test_key_range_is_checked():
    packed = t32(np.zeros((4, 2), np.uint32))
    with pytest.raises(ValueError, match="out of range"):
        tplanner.execute(packed, tplanner.key(4), num_records=50)
    with pytest.raises(ValueError, match="out of range"):
        tbatch.execute_many(packed, [tplanner.key(1) & ~tplanner.key(9)],
                            num_records=50)


# ------------------------------------------------------------ batch
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("n,factor,pad_output", [
    (320, False, False), (301, True, False), (301, False, True),
    (37, True, True)])
def test_execute_many_matches_reference(backend, n, factor, pad_output):
    """Mixed waves with factored, composite and contradiction plans;
    ``pad_output`` rows past Q are unspecified, so only the prefix is
    compared (its shape is checked)."""
    rng = np.random.default_rng(n)
    packed = words(rng, 12, -(-n // 32))
    tq, jq = _wave(n, 25, tplanner), _wave(n, 25, jplanner)
    got_r, got_c = tbatch.execute_many(t32(packed), tq, num_records=n,
                                       backend=backend, factor=factor,
                                       pad_output=pad_output)
    want_r, want_c = jbatch.execute_many(jnp.asarray(packed), jq,
                                         num_records=n, backend="ref",
                                         factor=factor, pad_output=pad_output)
    q = len(tq)
    assert got_r.shape == tuple(want_r.shape)
    np.testing.assert_array_equal(u32(got_r[:q]), np.asarray(want_r)[:q])
    np.testing.assert_array_equal(got_c[:q].numpy(), np.asarray(want_c)[:q])


def test_execute_many_empty_and_executor_cache():
    packed = t32(words(np.random.default_rng(1), 4, 3))
    r, c = tbatch.execute_many(packed, [], num_records=90)
    assert r.shape == (0, 3) and c.shape == (0,)
    tbackends.register_backend(tbackends.get_backend("bulk"))  # clears caches
    builds = tbatch._BUILDS.value
    preds = [tplanner.key(0) & ~tplanner.key(1), tplanner.key(2)]
    for _ in range(3):
        tbatch.execute_many(packed, preds, num_records=90, backend="bulk")
    # two bucket shapes, built once each: later waves are cache hits
    assert tbatch._BUILDS.value - builds == 2
    assert tbatch.batched_executor_cache_info().currsize == 2


def test_auto_resolves_by_device():
    assert tbackends.resolve_backend("auto", "cpu") == "ref"
    assert tbackends.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert tbackends.resolve_backend("bulk", "cuda") == "bulk"
    with pytest.raises(ValueError, match="unknown backend"):
        tbackends.resolve_backend("pallas")


def test_auto_without_a_device_resolves_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tbackends.resolve_backend("auto") == "cuda"
    assert tbackends.get_backend().name == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbackends.resolve_backend("auto")
    assert tbackends.resolve_backend("auto", "cpu") == "ref"


# ------------------------------------------------------------ runtime
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_streaming_indexer_matches_reference(backend):
    """Unaligned blocks (straddling splices), word-aligned ones (shift 0)
    and capacity growth, held against the reference indexer's packed words
    after every block and against a from-scratch rebuild."""
    rng = np.random.default_rng(7)
    keys = np.arange(40, dtype=np.int32)
    tsi = truntime.StreamingIndexer(keys, backend=backend, device="cpu")
    jsi = jruntime.StreamingIndexer(jnp.asarray(keys), backend="ref")
    seen = []
    for n in (50, 14, 64, 3, 129):
        blk = rng.integers(0, 48, (n, 6), dtype=np.int32)
        seen.append(blk)
        got = tsi.append(torch.from_numpy(blk))
        want = jsi.append(jnp.asarray(blk))
        assert got.num_records == want.num_records
        np.testing.assert_array_equal(u32(got.packed),
                                      np.asarray(want.packed))
    rebuilt = tbackends.get_backend(backend).create_index(
        torch.from_numpy(np.concatenate(seen)), torch.from_numpy(keys))
    np.testing.assert_array_equal(tsi.index.packed.numpy(), rebuilt.numpy())


def test_append_many_append_packed_and_fold_match_reference():
    rng = np.random.default_rng(8)
    keys = np.arange(33, dtype=np.int32)
    blocks = rng.integers(0, 40, (3, 45, 5), dtype=np.int32)
    tsi = truntime.StreamingIndexer(keys, backend="ref", device="cpu")
    jsi = jruntime.StreamingIndexer(jnp.asarray(keys), backend="ref")
    np.testing.assert_array_equal(
        u32(tsi.append_many(torch.from_numpy(blocks)).packed),
        np.asarray(jsi.append_many(jnp.asarray(blocks)).packed))
    tb = torch.stack([tbackends.get_backend("ref").create_index(
        torch.from_numpy(b), torch.from_numpy(keys)) for b in blocks])
    jb = jnp.stack([jplanner.backends.get_backend("ref").create_index(
        jnp.asarray(b), jnp.asarray(keys)) for b in blocks])
    got = truntime.fold_block_indexes(tb, 45)
    want = jruntime.fold_block_indexes(jb, 45)
    np.testing.assert_array_equal(u32(got.packed), np.asarray(want.packed))
    np.testing.assert_array_equal(
        u32(truntime.append_packed(tb[0], 45, tb[1], 45)),
        np.asarray(jruntime.append_packed(jb[0], 45, jb[1], 45)))


def test_snapshot_survives_later_appends():
    keys = np.arange(8, dtype=np.int32)
    si = truntime.StreamingIndexer(keys, device="cpu", capacity_words=2)
    si.append(torch.full((40, 2), 3, dtype=torch.int32))
    buf, n = si.view()
    before = buf.clone()
    si.append(torch.full((500, 2), 3, dtype=torch.int32))
    assert n == 40 and torch.equal(buf, before)
