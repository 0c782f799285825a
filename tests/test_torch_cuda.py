"""The hand-written CUDA kernels against their plain-torch versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU; this file
imports no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Packed words and counts are integers: bit-identical, no tolerance.  The
flash-attention kernel is held against its plain version in fp32 on the
same inputs: atol 2e-5 for fp32 inputs (the reference kernel test's), and
for bf16 inputs one bf16 ulp at the output's largest magnitude
(2^-7 * max|plain|: kernel and plain version each round an fp32 result to
bf16 once) and, element by element, ``torch_checks.bf16_attn_err``: one
bf16 ulp of the element plus 2^-12 of its row's largest magnitude, which a
kernel that rounds P to bf16 before P V fails.  The backward kernel is held
against its plain version on the forward kernel's own output and lse at
phase 2's shapes of ``chip_smoke.py``: atol 2e-4 for fp32 (the reference's
gradient tolerance), one bf16 ulp at each output's largest magnitude plus
that atol for bf16; two launches must be bit-identical, and a train step
must launch the forward kernel twice and the backward kernel once per
layer.  Both kernels are held alike under a sliding window, a q_offset
and a kv_len (``torch_checks.FLASH_WINDOW_CASES`` and
``FLASH_OFFSET_CASES``, shared with ``chip_smoke.py``'s phase 2),
including rows that see no key (zeros, lse NEG_INF) and the Ulysses shards
(a quarter of the queries at its offset against every key), where every
key that no query sees must get exactly zero dK and dV.

The MoE FFN and the Mamba2 mixer on the card against the same functions
on the CPU at smoke sizes, and ``greedy_generate`` of the MoE, SSM and
hybrid smoke configs on the card (one flash launch an attention layer, the
CPU's tokens in fp32).  Whisper's bidirectional flash shapes
(``torch_checks.ENCDEC_FLASH_CASES``: 1500 x 1500, 224 and 448 x 1500),
forward and backward, against the plain versions; one smoke-width fp32
training step of each family trained since the encoder-decoder slice
(Whisper, the MoEs, Mamba2, Hymba) on the card against the same step on
the CPU, with its launch counts; Whisper's greedy tokens on the card equal
to the CPU's; and the MoE's gradients bit-identical across two runs on
the card.

The serving layer on the card: a four-thread storm through
``BitmapDB.serve()`` over a 2^20-record index (every answer the ``ref``
backend's, the fallback ladder never engaged, every wave on the kernels),
a ``measure_calibration`` that must rank ``cuda`` first, and ``explain``
on a card session.

The dry run (``repro_torch.launch.dryrun``): the flash wrappers' meta
route leaves the card route's launches and outputs as they were, and one
small cell's predicted peak (arguments plus the traced temp) holds
``max_memory_allocated`` within 20%, with the traced launches and
non-attention flops.
"""
import contextlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.db import BitmapDB
from repro_torch.engine import planner
from repro_torch.kernels import bit_transpose as tbt
from repro_torch.kernels import bitmap_ops as tbq
from repro_torch.kernels import attention as tfa
from repro_torch.kernels import cam_match as tcm
from torch_checks import (COMMAND_R_FLASH_SHAPES, COUNTED_CASES,
                          ENCDEC_FLASH_CASES,
                          ENCDEC_FLASH_SHAPE, FLASH_BWD_CASES,
                          FLASH_OFFSET_CASES, FLASH_WINDOW_CASES,
                          STACKED_CASES, any_int32_cam_inputs, attn_tol,
                          bf16_attn_err,
                          bulk_counted_inputs, bulk_plan_route,
                          bulk_routes_seen, bwd_tol,
                          flash_bwd_inputs, flash_mask_ratios, record_cuts,
                          stacked_program_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _words(rng, *shape, dev):
    return torch.from_numpy(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)


@pytest.mark.parametrize("n,w,m", [(1000, 7, 37), (4096, 32, 256),
                                   (33, 1, 1), (70, 500, 70)])
def test_cam_match_kernel(dev, n, w, m):
    rng = np.random.default_rng(n + m)
    rec = torch.from_numpy(rng.integers(0, 256, (n, w), dtype=np.int32)).to(dev)
    keys = torch.from_numpy(rng.integers(0, 256, (m,), dtype=np.int32)).to(dev)
    got = tcm.cam_match(rec, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, tcm.cam_match_plain(rec, keys))


@pytest.mark.parametrize("m", [1, 37, 256, 300, 4096])
@pytest.mark.parametrize("w", [1, 32, 500])
def test_cam_match_kernel_any_int32(dev, w, m):
    """Every table width: key words up to 4, 8, 16 (M = 300) and 32 per
    key-word range; M = 4096 takes two ranges."""
    rec, keys = (torch.from_numpy(a).to(dev) for a in any_int32_cam_inputs(
        np.random.default_rng(w * m), 777, w, m))
    got = tcm.cam_match(rec, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, tcm.cam_match_plain(rec, keys))


# bit_transpose: rows around a tile (32) and an item (1024 rows) of the
# kernel and one past a full 2^22-record block; column words around its 8
# per item and its 16-byte (4-word) copies; Cw = 12 ends on half an item
# with 16-byte copies.
@pytest.mark.parametrize("r,cw", [(1000, 3), (4096, 8), (32, 1), (2100, 17),
                                  (1025, 12),
                                  *itertools.product(
                                      (1, 31, 33, 1023, 1025, (1 << 22) + 1),
                                      (1, 3, 8, 17))])
def test_bit_transpose_kernel(dev, r, cw):
    x = _words(np.random.default_rng(r), r, cw, dev=dev)
    got = tbt.bit_transpose(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tbt.bit_transpose_plain(x))


def _unaligned(rng, *shape, dev):
    """Random words as a contiguous view 4 bytes past a 16-byte boundary
    (``bit_transpose``'s 4-byte copies)."""
    v = _words(rng, int(np.prod(shape)) + 1, dev=dev)[1:].view(*shape)
    assert v.is_contiguous() and v.data_ptr() % 16 == 4
    return v


def test_bit_transpose_kernel_unaligned_view(dev):
    x = _unaligned(np.random.default_rng(9), 3000, 8, dev=dev)
    got = tbt.bit_transpose(x)
    torch.cuda.synchronize()
    assert torch.equal(got, tbt.bit_transpose_plain(x))


# bitmap_query: K around the kernel's row pairs and its four rows in
# flight, past 32 and past the 1024 flags it stages at once; Nw % 4 != 0
# puts rows k >= 1 off a 16-byte boundary, and Nw off the 4096-word block
# leaves a last block with bounds checks; 2^23 + 5 words take more blocks
# than the card holds at once.
@pytest.mark.parametrize("k,nw,allinv", [(4, 1001, True), (1, 1 << 16, False),
                                         (7, 333, False), (1030, 4100, False),
                                         (1, (1 << 23) + 5, False),
                                         *itertools.product(
                                             (1, 2, 8, 33),
                                             (1, 3, 1001, 1 << 20,
                                              (1 << 20) + 3),
                                             (True, False))])
def test_bitmap_query_kernel(dev, k, nw, allinv):
    rng = np.random.default_rng(k * nw)
    rows = _words(rng, k, nw, dev=dev)
    inv = (torch.ones(k, dtype=torch.int32) if allinv else
           torch.from_numpy(rng.integers(0, 2, k).astype(np.int32))).to(dev)
    got_r, got_c = tbq.bitmap_query(rows, inv)
    want_r, want_c = tbq.bitmap_query_plain(rows, inv)
    torch.cuda.synchronize()
    assert torch.equal(got_r, want_r) and int(got_c) == int(want_c)


def test_bitmap_query_kernel_unaligned_view(dev):
    rows = _unaligned(np.random.default_rng(10), 3, 4096, dev=dev)
    inv = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    got_r, got_c = tbq.bitmap_query(rows, inv)
    want_r, want_c = tbq.bitmap_query_plain(rows, inv)
    torch.cuda.synchronize()
    assert torch.equal(got_r, want_r) and int(got_c) == int(want_c)


@pytest.mark.parametrize("m,nw,shape", [(13, 1001, (8, 4, 2, 4)),
                                        (256, 4096, (16, 2, 1, 4)),
                                        (5, 33, (65536, 1, 1, 1)),
                                        (13, 300, (2, 128, 1, 64))])
def test_bulk_program_kernel(dev, m, nw, shape):
    rng = np.random.default_rng(m + nw)
    aug = torch.cat([_words(rng, m, nw, dev=dev),
                     torch.full((1, nw), -1, dtype=torch.int32, device=dev)])
    sels = torch.from_numpy(rng.integers(0, m + 1, shape).astype(np.int32))
    invs = torch.from_numpy(rng.integers(0, 2, shape).astype(np.int32))
    post = torch.from_numpy(np.where(rng.random(shape[:3]) < 0.3, -1, 0)
                            .astype(np.int32))
    sels, invs, post = sels.to(dev), invs.to(dev), post.to(dev)
    got = tbq.bulk_program(aug, sels, invs, post)
    torch.cuda.synchronize()
    assert torch.equal(got, tbq.bulk_program_plain(aug, sels, invs, post))


@pytest.mark.parametrize("s,m,nw,shape,literals", STACKED_CASES)
def test_bulk_program_stacked_kernel(dev, s, m, nw, shape, literals):
    """The stacked launch against its plain version (bulk_program_plain
    per segment, each masked past its own record count)."""
    rng = np.random.default_rng(s * 1000 + nw)
    args = [torch.from_numpy(a).to(dev) for a in stacked_program_inputs(
        rng, s, m, nw, shape, literals)]
    n0 = tbq.bulk_program_stacked.launches
    got = tbq.bulk_program_stacked(*args)
    torch.cuda.synchronize()
    assert tbq.bulk_program_stacked.launches == n0 + 1
    assert got.shape == (s, shape[0], nw)
    assert torch.equal(got, tbq.bulk_program_stacked_plain(*args))


@pytest.mark.parametrize("m,nw,shape,literals", COUNTED_CASES)
def test_bulk_program_counted_kernel(dev, m, nw, shape, literals):
    """The 2-D counted form against its plain version at record counts of
    0, 1, 32 Nw - 5, 32 Nw and mid-word; the unmasked form on the same
    inputs; launches counted on ``bulk_program``; both forms take the route
    of the C entry's plan (held against its mirror), and the profiler sees
    no kernel of the other route."""
    rng = np.random.default_rng(m * 7 + nw)
    aug, sels, invs, post = (torch.from_numpy(a).to(dev) for a in
                             bulk_counted_inputs(rng, m, nw, shape, literals))
    for n in record_cuts(nw):
        n0 = tbq.bulk_program.launches
        got_r, got_c = tbq.bulk_program_counted(aug, n, sels, invs, post)
        want_r, want_c = tbq.bulk_program_counted_plain(aug, n, sels, invs,
                                                        post)
        torch.cuda.synchronize()
        assert tbq.bulk_program.launches == n0 + 1
        assert got_c.shape == (shape[0],) and got_c.dtype == torch.int32
        assert torch.equal(got_r, want_r) and torch.equal(got_c, want_c)
    got = tbq.bulk_program(aug, sels, invs, post)
    torch.cuda.synchronize()
    assert torch.equal(got, tbq.bulk_program_plain(aug, sels, invs, post))
    route = bulk_plan_route(1, m, nw, shape, stacked=False, counted=True)
    assert route == bulk_plan_route(1, m, nw, shape, stacked=False,
                                    counted=False)
    seen = bulk_routes_seen(lambda: (
        tbq.bulk_program(aug, sels, invs, post),
        tbq.bulk_program_counted(aug, 32 * nw - 5, sels, invs, post)), 2)
    assert seen[route] <= 2 and not any(
        n for r, n in seen.items() if r != route)


@pytest.mark.parametrize("s,m,nw,shape,literals", STACKED_CASES)
def test_bulk_program_stacked_counted_kernel(dev, s, m, nw, shape, literals):
    """The stacked counted form against its plain version; the uncounted
    stacked form on the same inputs; both take the route of the C entry's
    plan (held against its mirror), and the profiler sees no kernel of the
    other route."""
    rng = np.random.default_rng(s * 1000 + nw + 1)
    args = [torch.from_numpy(a).to(dev) for a in stacked_program_inputs(
        rng, s, m, nw, shape, literals)]
    n0 = tbq.bulk_program_stacked.launches
    got_r, got_c = tbq.bulk_program_stacked_counted(*args)
    got = tbq.bulk_program_stacked(*args)
    want_r, want_c = tbq.bulk_program_stacked_counted_plain(*args)
    torch.cuda.synchronize()
    assert tbq.bulk_program_stacked.launches == n0 + 2
    assert got_c.shape == (s, shape[0])
    assert torch.equal(got_r, want_r) and torch.equal(got_c, want_c)
    assert torch.equal(got, want_r)
    route = bulk_plan_route(s, m, nw, shape, stacked=True, counted=True)
    assert route == bulk_plan_route(s, m, nw, shape, stacked=True,
                                    counted=False)
    seen = bulk_routes_seen(lambda: (tbq.bulk_program_stacked_counted(*args),
                                 tbq.bulk_program_stacked(*args)), 2)
    assert seen[route] <= 2 and not any(
        n for r, n in seen.items() if r != route)


def test_bulk_program_counted_launches_are_bit_identical(dev):
    """Two launches of each counted form give the same rows and counts
    (count partials are summed by integer atomics), on a bucket whose
    queries share rows."""
    rng = np.random.default_rng(33)
    assert all(bulk_plan_route(s, 256, 8192, (64, 4, 2, 4), stacked=s > 1,
                               counted=True) == "staged" for s in (1, 2))
    aug, sels, invs, post = (torch.from_numpy(a).to(dev) for a in
                             bulk_counted_inputs(rng, 256, 8192,
                                                 (64, 4, 2, 4)))
    runs = [tbq.bulk_program_counted(aug, 8192 * 32 - 77, sels, invs, post)
            for _ in range(2)]
    stack = torch.stack([aug, aug.flip(1)])          # row M stays all ones
    nrecs = torch.tensor([8192 * 32, 4000], dtype=torch.int32, device=dev)
    runs_s = [tbq.bulk_program_stacked_counted(stack, nrecs, sels, invs,
                                               post) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in (runs, runs_s):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(runs[0][1], tbq.bulk_program_counted_plain(
        aug, 8192 * 32 - 77, sels, invs, post)[1])


def test_bucket_executors_on_the_card_run_no_plain_mask(dev, monkeypatch):
    """``run_program`` and ``run_program_stacked`` on CUDA tensors reach the
    counted kernels: the plain tail mask and popcount never run (they are
    made to raise), one launch each."""
    from repro_torch.engine import bulk as tbulk
    from repro_torch.engine import policy
    from repro_torch.kernels import ref
    rng = np.random.default_rng(34)
    aug, nrecs, sels, invs, post = (
        torch.from_numpy(a).to(dev) for a in stacked_program_inputs(
            rng, 3, 40, 4099, (8, 2, 2, 4), "mixed"))

    def plain(*args, **kwargs):
        raise AssertionError("plain tail mask/popcount on the card")

    for mod in (policy, ref):
        monkeypatch.setattr(mod, "popcount", plain)
        monkeypatch.setattr(mod, "tail_mask", plain)
    monkeypatch.setattr(policy, "mask_tail", plain)
    counts0 = (tbq.bulk_program.launches, tbq.bulk_program_stacked.launches)
    n = int(nrecs[1])
    rows, counts = tbulk.run_program(aug[1].contiguous(), n, sels, invs,
                                     post)
    rows_s, counts_s = tbulk.run_program_stacked(aug, nrecs.tolist(), sels,
                                                 invs, post)
    torch.cuda.synchronize()
    assert (tbq.bulk_program.launches - counts0[0],
            tbq.bulk_program_stacked.launches - counts0[1]) == (1, 1)
    monkeypatch.undo()
    want = tbq.bulk_program_counted_plain(aug[1], n, sels, invs, post)
    want_s = tbq.bulk_program_stacked_counted_plain(aug, nrecs, sels, invs,
                                                    post)
    assert torch.equal(rows, want[0]) and torch.equal(counts, want[1])
    assert torch.equal(rows_s, want_s[0]) and torch.equal(counts_s,
                                                          want_s[1])


def test_stacked_segments_match_per_segment_and_ref(dev):
    from repro_torch.engine import batch as tbatch
    rng = np.random.default_rng(21)
    parts = []
    for n in (4096, 4096, 4090):       # uniform word counts, ragged tail
        idx = BitmapDB(num_keys=64, device=dev)
        idx.append_encoded(rng.integers(0, 64, (n, 8), dtype=np.uint8))
        parts.append((idx.index.packed.contiguous(), n))
    k = planner.key
    preds = [k(1) & ~k(2), (k(3) | k(4)) & k(5), k(6) | k(7), k(9) & ~k(9),
             planner.And(tuple(k(2 * i) | k(2 * i + 1) for i in range(8)))]
    n0 = tbq.bulk_program_stacked.launches
    got = tbatch.execute_many_segments(parts, preds, backend="cuda")
    assert tbq.bulk_program_stacked.launches - n0 == 3     # one per bucket
    per = tbatch.execute_many_segments(parts, preds, backend="cuda",
                                       stack_uniform=False)
    ref = tbatch.execute_many_segments(parts, preds, backend="ref")
    torch.cuda.synchronize()
    for other in (per, ref):
        assert torch.equal(got[0], other[0]) and torch.equal(got[1], other[1])


def _waves_off_the_kernels(before: dict) -> dict:
    """Waves since ``before`` (a ``waves_by_backend()``) that ran on a
    backend other than the kernels'."""
    from repro_torch.engine import batch as tbatch
    after = tbatch.waves_by_backend()
    return {n: v - before.get(n, 0) for n, v in after.items()
            if n != "cuda" and v != before.get(n, 0)}


def test_cuda_backend_matches_ref_end_to_end(dev):
    """An auto session on the card: every wave runs on the kernels (the
    cost model's only candidate there), bit-identical to ref."""
    from repro_torch.engine import batch as tbatch
    rng = np.random.default_rng(9)
    db = BitmapDB(num_keys=64, device=dev)
    for n in (1000, 77, 4096):
        db.append_encoded(rng.integers(0, 64, (n, 8), dtype=np.uint8))
    k = planner.key
    preds = [k(1) & ~k(2), (k(3) | k(4)) & k(5), k(6) | k(7) | k(8),
             k(9) & ~k(9)]
    preds.append(planner.And(tuple(k(2 * i) | k(2 * i + 1)
                                   for i in range(8))))      # composite
    counts0 = (tbq.bulk_program.launches, tbq.bitmap_query.launches)
    waves0 = tbatch.waves_by_backend()
    rows, cnt = db.query_many(preds).materialize()
    single = db.query(preds[0]).count
    assert _waves_off_the_kernels(waves0) == {}
    rows_ref, cnt_ref = db.query_many(preds, backend="ref").materialize()
    torch.cuda.synchronize()
    assert torch.equal(rows, rows_ref) and torch.equal(cnt, cnt_ref)
    assert single == int(cnt_ref[0])
    assert tbq.bulk_program.launches > counts0[0]
    assert tbq.bitmap_query.launches > counts0[1]


def _attn_inputs(rng, b, s, h, kv, hd, dtype, dev):
    def one(heads):
        return torch.from_numpy(rng.standard_normal((b, s, heads, hd))
                                .astype(np.float32)).to(dev, dtype)
    return one(h), one(kv), one(kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kv,hd", [(300, 4, 4, 32), (1, 7, 1, 128),
                                       (300, 28, 4, 128), (77, 8, 2, 8),
                                       (129, 4, 2, 256), (64, 2, 1, 16),
                                       (200, 4, 1, 64)])
def test_flash_attention_kernel(dev, dtype, causal, s, h, kv, hd):
    rng = np.random.default_rng(s * h + hd)
    q, k, v = _attn_inputs(rng, 2, s, h, kv, hd, dtype, dev)
    before = tfa.flash_attention_fwd.launches
    got = tfa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = tfa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                         causal=causal)
    err = float((got.float() - want).abs().max())
    assert err <= attn_tol(want, dtype), err
    if dtype == torch.bfloat16:
        assert bf16_attn_err(got, want) <= 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4, 7])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 300, 2048])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_tensor_core_kernel(dev, hd, s, g, causal):
    """bf16 at head_dim 64 / 128 / 256 runs on the tensor-core kernel:
    ragged S off the 128-row query tiles and the 128-key (64 at head_dim
    256) K/V tiles, GQA groups 1, 4 and 7."""
    rng = np.random.default_rng(s * g + hd)
    q, k, v = _attn_inputs(rng, 2, s, 2 * g, 2, hd, torch.bfloat16, dev)
    got = tfa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = tfa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                         causal=causal)
    err = float((got.float() - want).abs().max())
    assert err <= attn_tol(want, torch.bfloat16), err
    assert bf16_attn_err(got, want) <= 1


@pytest.mark.parametrize("label", sorted(COMMAND_R_FLASH_SHAPES))
def test_flash_attention_at_command_r_plus_shapes(dev, label):
    """Row 5c: the forward kernel at Command-R+-104B's prefill (4 x 2048,
    96 / 8 heads of 128, causal, bf16) and at one rank's quarter of the
    heads on a (1, 4) mesh (24 / 2), one launch, against its plain version
    by phase 2's two bf16 checks."""
    h, kv = COMMAND_R_FLASH_SHAPES[label]
    rng = np.random.default_rng(h)
    q, k, v = _attn_inputs(rng, 4, 2048, h, kv, 128, torch.bfloat16, dev)
    before = tfa.flash_attention_fwd.launches
    got = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    want = tfa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                         causal=True)
    err = float((got.float() - want).abs().max())
    assert err <= attn_tol(want, torch.bfloat16), err
    assert bf16_attn_err(got, want) <= 1


def test_flash_attention_launches_the_named_kernel(dev):
    """The profiler sees the kernel the C entry picks: the tensor-core one
    for bf16 at head_dim 64, 128 and 256, the CUDA-core one for fp32 and for
    bf16 at the other head dims.  The profiler now and then records no
    kernel of a session (on an H100, once in 684 card tests), so a session
    that recorded no flash kernel is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    for dtype, hd, want in (
            (torch.bfloat16, 128, "flash_fwd_wgmma"),
            (torch.bfloat16, 64, "flash_fwd_wgmma"),
            (torch.float32, 128, "flash_fwd_kernel"),
            (torch.float32, 64, "flash_fwd_kernel"),
            (torch.bfloat16, 32, "flash_fwd_kernel"),
            (torch.bfloat16, 256, "flash_fwd_wgmma"),
            (torch.float32, 256, "flash_fwd_kernel")):
        q, k, v = _attn_inputs(rng, 1, 200, 4, 2, hd, dtype, dev)
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                tfa.flash_attention_fwd(q, k, v)
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages()
                     if "flash_fwd" in e.key]
            if names:
                break
        assert len(names) == 1 and want in names[0], (dtype, hd, names)


def test_flash_backward_launches_the_named_kernels(dev):
    """The profiler sees the backward pair the C entry picks: the
    tensor-core pair for bf16 at head_dim 64, 128 and 256, the CUDA-core
    pair for fp32 and for bf16 at the other head dims; one launch of each
    of the pair's two kernels and none of the other pair's.  A session in
    which the profiler recorded fewer than the two launches is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    tensor = ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    cuda = ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
    rng = np.random.default_rng(6)
    for dtype, hd, want in (
            (torch.bfloat16, 128, tensor),
            (torch.bfloat16, 64, tensor),
            (torch.float32, 128, cuda),
            (torch.float32, 64, cuda),
            (torch.bfloat16, 32, cuda),
            (torch.bfloat16, 256, tensor),
            (torch.float32, 256, cuda)):
        q, k, v, dout = flash_bwd_inputs(rng, 200, hd, 7, dtype, dev)
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True,
                                           return_lse=True)
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1)
                tfa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
                torch.cuda.synchronize()
            seen = {e.key: e.count for e in prof.key_averages()
                    if "flash_bwd" in e.key}
            if sum(seen.values()) >= 2:
                break
        got = {name: sum(n for key, n in seen.items() if name in key)
               for name in tensor + cuda}
        assert got == {name: int(name in want) for name in tensor + cuda}, (
            dtype, hd, seen)


def test_flash_launch_counts_name_the_route(dev):
    """The C entries count each kernel where they launch it: one call of
    the forward adds one to the kernel the profiler tests above see, one
    call of the backward one to each kernel of its pair, and nothing else
    moves; a reset reads the counts and sets them to 0."""
    rng = np.random.default_rng(7)
    tensor = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    cuda = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
    for dtype, hd, want in ((torch.bfloat16, 128, tensor),
                            (torch.bfloat16, 64, tensor),
                            (torch.bfloat16, 256, tensor),
                            (torch.float32, 128, cuda),
                            (torch.bfloat16, 32, cuda)):
        q, k, v, dout = flash_bwd_inputs(rng, 200, hd, 7, dtype, dev)
        torch.cuda.synchronize()
        tfa.kernel_launches(reset=True)
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True,
                                           return_lse=True)
        torch.cuda.synchronize()
        assert tfa.kernel_launches() == {
            n: int(n == want[0]) for n in tfa.KERNELS}, (dtype, hd)
        tfa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
        torch.cuda.synchronize()
        assert tfa.kernel_launches(reset=True) == {
            n: int(n in want) for n in tfa.KERNELS}, (dtype, hd)
        assert not any(tfa.kernel_launches().values())


def test_flash_attention_kernel_reference_layout(dev):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 300, 32))
                                .astype(np.float32)).to(dev)
               for _ in range(3))
    got = tfa.flash_attention_fwd(q, k, v, causal=False, block_q=64,
                                  block_k=96)
    torch.cuda.synchronize()
    want = tfa.flash_attention_fwd_plain(q, k, v, causal=False)
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "strided", "kv_heads",
                                 "devices", "unaligned"])
def test_flash_attention_kernel_rejects_before_launch(dev, bad):
    rng = np.random.default_rng(0)
    q, k, v = _attn_inputs(rng, 1, 16, 4, 2, 32, torch.float32, dev)
    if bad == "head_dim":
        q, k, v = _attn_inputs(rng, 1, 16, 4, 2, 48, torch.float32, dev)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "kv_heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "unaligned":                # contiguous, 4 bytes off
        q = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].view(q.shape)
    else:
        k = k.cpu()
    before = tfa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="flash_attention_fwd"):
        tfa.flash_attention_fwd(q, k, v)
    assert tfa.flash_attention_fwd.launches == before


@pytest.mark.parametrize("s,hd,g,causal,dtype", FLASH_BWD_CASES)
def test_flash_backward_kernel(dev, hd, s, g, causal, dtype):
    """dq, dk, dv against the plain backward on the kernel's own forward
    output and lse; the lse against the plain logsumexp (atol 1e-5); two
    launches on the same inputs bit-identical."""
    rng = np.random.default_rng(s * g + hd)
    q, k, v, dout = flash_bwd_inputs(rng, s, hd, g, dtype, dev)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _, want_lse = tfa.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), causal=causal, return_lse=True)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    want = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         out.float(), lse, dout.float(),
                                         causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = float((a.float() - b).abs().max())
        assert err <= bwd_tol(b, dtype), (name, err)


def test_flash_attention_vjp_on_the_card_runs_the_kernels(dev):
    """The autograd route launches the forward kernel (with lse) and the
    backward kernel, never the plain backward; its gradients are the plain
    route's within the kernel check's tolerance."""
    from repro_torch.models import flash
    rng = np.random.default_rng(9)
    q, k, v = (x.requires_grad_() for x in _attn_inputs(
        rng, 2, 300, 8, 2, 128, torch.bfloat16, dev))
    f0, b0 = tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches
    out = flash.flash_attention_vjp(q, k, v, causal=True)
    dout = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == f0 + 1
    assert tfa.flash_attention_bwd.launches == b0 + 1
    _, lse = tfa.flash_attention_fwd_plain(q.detach().float(),
                                           k.detach().float(),
                                           v.detach().float(), causal=True,
                                           return_lse=True)
    want = tfa.flash_attention_bwd_plain(
        q.detach().float(), k.detach().float(), v.detach().float(),
        out.detach().float(), lse, dout.float(), causal=True)
    for a, b in zip(grads, want):
        assert float((a.float() - b).abs().max()) <= bwd_tol(
            b, torch.bfloat16)


@pytest.mark.parametrize("s,window,hd,g,dtype", FLASH_WINDOW_CASES)
def test_flash_kernels_windowed(dev, s, window, hd, g, dtype):
    """Both flash kernels under a sliding window against their plain
    versions (``torch_checks.flash_mask_ratios``: the forward's output and
    lse, dq, dk and dv, two backward launches bit-identical)."""
    rng = np.random.default_rng(s * g + hd + window)
    q, k, v, dout = flash_bwd_inputs(rng, s, hd, g, dtype, dev)
    ratios = flash_mask_ratios(tfa, q, k, v, dout, causal=True,
                               window=window)
    assert all(r <= 1 for r in ratios.values()), ratios


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("sq,skv,q_offset,kv_len,window,causal",
                         FLASH_OFFSET_CASES)
def test_flash_kernels_offset(dev, sq, skv, q_offset, kv_len, window, causal,
                              hd, dtype):
    """A chunk of queries against a longer cache, kv_len < Skv, cross
    attention, rows that see no key and the Ulysses shards (dK and dV
    exactly zero at keys no query sees), through both kernels."""
    rng = np.random.default_rng(sq + skv + hd)
    q, k, v, dout = flash_bwd_inputs(rng, sq, hd, 2 if hd == 256 else 7,
                                     dtype, dev, skv=skv)
    ratios = flash_mask_ratios(tfa, q, k, v, dout, causal=causal,
                               window=window, q_offset=q_offset,
                               kv_len=kv_len)
    assert all(r <= 1 for r in ratios.values()), ratios


@pytest.mark.parametrize("sq,skv,dtype", ENCDEC_FLASH_CASES)
def test_flash_kernels_at_whisper_shapes(dev, sq, skv, dtype):
    """Both flash kernels, bidirectional, at Whisper-small's encoder and
    cross-attention shapes, against their plain versions
    (``torch_checks.flash_mask_ratios``)."""
    sh = ENCDEC_FLASH_SHAPE
    rng = np.random.default_rng(sq)
    q, k, v, dout = flash_bwd_inputs(rng, sq, sh["hd"], sh["g"], dtype, dev,
                                     batch=sh["batch"], kv=sh["kv"], skv=skv)
    ratios = flash_mask_ratios(tfa, q, k, v, dout, causal=False)
    assert all(r <= 1 for r in ratios.values()), ratios


def test_flash_rows_with_no_key_are_zero_on_the_card(dev):
    """A row that sees no key: output 0 and lse NEG_INF from both kernels
    (the plain version's choice), its gradients 0."""
    rng = np.random.default_rng(12)
    for dtype, hd in ((torch.bfloat16, 128), (torch.float32, 128),
                      (torch.bfloat16, 256)):
        q, k, v, dout = flash_bwd_inputs(rng, 128, hd, 2, dtype, dev,
                                         skv=512)
        mask = {"window": 100, "q_offset": 384, "kv_len": 400}
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True,
                                           return_lse=True, **mask)
        dq, _, _ = tfa.flash_attention_bwd(q, k, v, out, lse, dout,
                                           causal=True, **mask)
        torch.cuda.synchronize()
        assert not out[:, 115:].any() and not dq[:, 115:].any()
        assert bool((lse[:, :, 115:] == tfa.NEG_INF).all())
        assert out[:, :115].abs().amax(-1).min() > 0


def test_windowed_flash_launches_the_named_kernels(dev):
    """Under a window the C entries pick by the same rule: the tensor-core
    forward and backward pair for bf16 at head_dim 64, 128 and 256
    (Gemma3's), the CUDA-core kernels for fp32 (at 256 here); the forward
    and the backward each profiled alone, twice a session.  The profiler loses
    kernel records, up to whole sessions several times in a row on an
    H100, so, as every route check here, the test forbids the other
    route's kernels and retries; it never fails on a record the profiler
    missed: of the route's own kernels it may see none, or each once or
    twice."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    tensor = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
    cuda = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
    for hd, dtype, names in ((64, torch.bfloat16, tensor),
                             (128, torch.bfloat16, tensor),
                             (256, torch.bfloat16, tensor),
                             (256, torch.float32, cuda)):
        q, k, v, dout = flash_bwd_inputs(rng, 300, hd, 2, dtype, dev)
        out, lse = tfa.flash_attention_fwd(q, k, v, causal=True, window=64,
                                           return_lse=True)
        calls = ((lambda: tfa.flash_attention_fwd(q, k, v, causal=True,
                                                  window=64), names[:1]),
                 (lambda: tfa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  causal=True, window=64),
                  names[1:]))
        for fn, want in calls:
            for _ in range(3):      # the profiler now and then loses records
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    torch.cuda._sleep(1)
                    fn()
                    fn()
                    torch.cuda.synchronize()
                seen = {e.key: e.count for e in prof.key_averages()
                        if "flash_" in e.key}
                got = {name: sum(n for key, n in seen.items() if name in key)
                       for name in tensor + cuda}
                if all(got[name] for name in want):
                    break
            assert all(got[name] <= 2 for name in want), (hd, dtype, seen)
            assert not any(got[name] for name in tensor + cuda
                           if name not in want), (hd, dtype, seen)


def test_windowed_flash_attention_vjp_runs_no_plain_version(dev,
                                                           monkeypatch):
    """The windowed autograd route on CUDA tensors launches both kernels
    and never their plain versions."""
    from repro_torch.models import flash

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on the card")
    rng = np.random.default_rng(10)
    q, k, v, dout = flash_bwd_inputs(rng, 300, 256, 2, torch.bfloat16, dev)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    monkeypatch.setattr(tfa, "flash_attention_fwd_plain", refuse)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", refuse)
    f0, b0 = tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches
    out = flash.flash_attention_vjp(q, k, v, causal=True, window=64)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == f0 + 1
    assert tfa.flash_attention_bwd.launches == b0 + 1
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernels_launch_from_a_fresh_thread(dev, hd):
    """The tensor-core kernels encode TMA tensor maps, which need the
    device's context current in the calling thread: forward and backward
    launched from a thread that has made no CUDA call (as autograd's may
    be) run, and give the main thread's results bit for bit."""
    import threading
    rng = np.random.default_rng(hd)
    q, k, v, dout = flash_bwd_inputs(rng, 200, hd, 4, torch.bfloat16, dev)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    got = []

    def run():
        o, l_ = tfa.flash_attention_fwd(q, k, v, causal=True,
                                        return_lse=True)
        got.append((o, l_, tfa.flash_attention_bwd(q, k, v, o, l_, dout,
                                                   causal=True)))
    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert got, "the launches raised in the thread"
    o, l_, g = got[0]
    assert torch.equal(o, out) and torch.equal(l_, lse)
    assert all(torch.equal(a, b) for a, b in zip(g, grads))


def test_train_step_launches_the_kernels(dev):
    """One smoke-config train step under remat="full": the forward kernel
    twice per layer (forward and recompute), the backward kernel once."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.shapes import demo_batch
    from repro_torch.models import model
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = get_smoke_config("qwen2_7b")
    params = model.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    opt = init_opt_state(params, OptimConfig())
    batch = demo_batch(cfg, "train", 2, 64,
                       torch.Generator(device=dev).manual_seed(0))
    f0, b0 = tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches
    params, opt, m = make_train_step(cfg, TrainConfig())(params, opt, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and int(opt["step"]) == 1
    assert tfa.flash_attention_fwd.launches - f0 == 2 * cfg.num_layers
    assert tfa.flash_attention_bwd.launches - b0 == cfg.num_layers


def test_prefill_launches_the_kernel_once_per_layer(dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.serve.step import greedy_generate
    cfg = get_smoke_config("qwen2_7b")
    params = model.init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(dev)
    before = tfa.flash_attention_fwd.launches
    out = greedy_generate(params, cfg, tokens, steps=3)
    torch.cuda.synchronize()
    assert out.shape == (2, 3)
    assert tfa.flash_attention_fwd.launches - before == cfg.num_layers


FAMILIES = ["qwen2_moe_a2_7b", "granite_moe_3b_a800m", "mamba2_2_7b",
            "hymba_1_5b"]


@contextlib.contextmanager
def _no_host_sync():
    """Any operation that waits for the card raises inside the block."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _family_params(arch, seed=0):
    """A family's smoke config and random fp32 weights as numpy (the port's
    schema: the same weights load on the card and on the CPU)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    cfg = get_smoke_config(arch)
    cpu = model.init_params(cfg, seed=seed, device="cpu",
                            dtype=torch.float32)
    return cfg, model.params_to_numpy(cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "granite_moe_3b_a800m"])
def test_moe_ffn_on_the_card_matches_the_cpu(dev, arch, dtype):
    """Smoke-size ``moe_ffn`` (T = 3 x 29 tokens, capacity factor 0.5: the
    capacity drops some assignments) on the card against the same function
    on the CPU, the
    routing and ``keep`` equal and the output within 1e-4 of its largest
    magnitude (fp32) or 1/32 plus 1e-3 (bf16); two card runs
    bit-identical (no scatter-add on the card), and no host sync (every
    shape static)."""
    import dataclasses
    from repro_torch.models import moe
    cfg, params = _family_params(arch)
    spec = dataclasses.replace(cfg.moe, capacity_factor=0.5)
    p = {"router": params["router"][0] * 20,
         **{k[len("moe_"):]: params[k][0] for k in
            ("moe_w_gate", "moe_w_in", "moe_w_out")},
         **{k: params[k][0] for k in ("shared_w_gate", "shared_w_in",
                                      "shared_w_out", "shared_gate")
            if k in params}}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 29, cfg.d_model)).astype(np.float32)).to(dtype)
    cpu_p = {k: torch.from_numpy(v) for k, v in p.items()}
    card_p = {k: v.to(dev) for k, v in cpu_p.items()}
    want = moe.moe_ffn(x, cpu_p, spec, cfg.mlp_act)
    xd = x.to(dev)
    torch.cuda.synchronize()
    with _no_host_sync():
        got = moe.moe_ffn(xd, card_p, spec, cfg.mlp_act)
    again = moe.moe_ffn(xd, card_p, spec, cfg.mlp_act)
    assert torch.equal(got, again)
    T = x.shape[0] * x.shape[1]
    C = moe._capacity(T, spec.top_k, spec.num_experts, spec.capacity_factor)
    if dtype == torch.float32:
        routes = [moe.route(xx.reshape(T, -1), pp["router"], spec)[1]
                  for xx, pp in ((x, cpu_p), (x.to(dev), card_p))]
        assert torch.equal(routes[0], routes[1].cpu())
        keeps = [moe.dispatch(r, spec.num_experts, C)[1] for r in routes]
        assert torch.equal(keeps[0], keeps[1].cpu())
        assert not keeps[0].all()
    frac, floor = (1e-4, 0.0) if dtype == torch.float32 else (1 / 32, 1e-3)
    tol = frac * float(want.float().abs().max()) + floor
    assert float((got.cpu().float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_mamba2_mix_on_the_card_matches_the_cpu(dev, arch):
    """Smoke-size ``mamba2_mix`` in fp32, a prompt of 37 (chunk 16: padded)
    then three steps, on the card against the CPU: outputs and states
    within 1e-4 of their largest magnitude; no host sync."""
    from repro_torch.models import ssm
    cfg, params = _family_params(arch)
    p = {k[len("ssm_"):]: torch.from_numpy(v[0]) for k, v in params.items()
         if k.startswith("ssm_")}
    card_p = {k: v.to(dev) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))

    def near(got, want):
        tol = 1e-4 * float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= tol
    xd = x.to(dev)
    torch.cuda.synchronize()
    want, ws = ssm.mamba2_mix(p, x[:, :37], cfg, mode="full")
    with _no_host_sync():
        got, gs = ssm.mamba2_mix(card_p, xd[:, :37], cfg, mode="full")
    near(got, want)
    for i in range(37, 40):
        want, ws = ssm.mamba2_mix(p, x[:, i:i + 1], cfg, mode="step",
                                  state=ws)
        with _no_host_sync():
            got, gs = ssm.mamba2_mix(card_p, xd[:, i:i + 1], cfg,
                                     mode="step", state=gs)
        near(got, want)
        for nm in ("conv", "ssm"):
            near(gs[nm], ws[nm])


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_greedy_generate_on_the_card(dev, arch, monkeypatch):
    """``greedy_generate`` of each family's smoke config on the card: one
    flash launch an attention layer per prefill (none for Mamba2); in
    fp32 the tokens equal the CPU's, in bf16 they are in the vocabulary."""
    from repro_torch.models import model
    from repro_torch.serve.step import greedy_generate
    cfg, params = _family_params(arch)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 37)))
    attn_layers = cfg.num_layers if cfg.block != "ssm" else 0
    card = model.params_from_numpy(cfg, params, device=dev)
    before = tfa.flash_attention_fwd.launches
    out = greedy_generate(card, cfg, tokens.to(dev), steps=4)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches - before == attn_layers
    assert out.shape == (2, 4)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    monkeypatch.setattr(model, "COMPUTE_DTYPE", torch.float32)
    card = model.params_from_numpy(cfg, params, device=dev,
                                   dtype=torch.float32)
    cpu = model.params_from_numpy(cfg, params, device="cpu",
                                  dtype=torch.float32)
    got = greedy_generate(card, cfg, tokens.to(dev), steps=4)
    assert torch.equal(got.cpu(), greedy_generate(cpu, cfg, tokens, steps=4))


# ------------------------------------------- cost model and service
def _serving_preds(rng, m, count):
    k = planner.key
    out = []
    for i in range(count):
        a, b, c = (int(x) for x in rng.integers(0, m, 3))
        out.append([k(a), k(a) & ~k(b), (k(a) | k(b)) & k(c),
                    k(a) | k(b) | k(c)][i % 4])
    out.append(planner.And(tuple(k(2 * i) | k(2 * i + 1)
                                 for i in range(8))))        # composite
    return out


def test_service_storm_on_the_card(dev):
    """Four submitter threads against BitmapDB.serve() over a 2^20-record
    index on an auto session: every answer equals the ref backend's, no
    wave degraded, retried, isolated or deadline-rejected, the breaker
    closed and no fallback configured, every wave on the kernels, and the
    coalesced waves launched the bitmap kernels."""
    import threading
    from repro_torch.engine import batch as tbatch
    rng = np.random.default_rng(31)
    db = BitmapDB(num_keys=64, device=dev)
    db.append_encoded(rng.integers(0, 64, (1 << 20, 8), dtype=np.uint8))
    preds = _serving_preds(rng, 64, 120)
    want_r, want_c = db.query_many(preds, backend="ref").materialize()
    n0 = (tbq.bulk_program.launches, tbq.bitmap_query.launches)
    waves0 = tbatch.waves_by_backend()
    with db.serve(max_batch=32, max_delay_ms=2.0,
                  idle_after_ms=1000.0) as svc:
        outs = [[] for _ in range(4)]

        def caller(t):
            for i in range(t, len(preds), 4):
                outs[t].append((i, svc.submit(preds[i])))

        threads = [threading.Thread(target=caller, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
            assert not th.is_alive()
        assert svc.drain(timeout=120)
        h = svc.health()
        assert (h["degraded_waves"], h["fallback_queries"],
                h["wave_retries"], h["isolated_failures"],
                h["deadline_rejected"]) == (0, 0, 0, 0, 0)
        assert h["breaker"]["state"] == "closed"
        assert h["fallback_backend"] is None
        assert _waves_off_the_kernels(waves0) == {}
        for lane in outs:
            seqs = [f.resolve_seq for _, f in lane]
            assert seqs == sorted(seqs)
            for i, f in lane:
                r, c = f.result(timeout=120)
                assert torch.equal(r, want_r[i]) and int(c) == int(want_c[i])
    assert tbq.bulk_program.launches > n0[0]
    assert tbq.bitmap_query.launches > n0[1]


def test_measure_calibration_on_the_card(dev):
    from repro_torch.engine import costmodel
    cal = costmodel.measure_calibration(device="cuda", num_records=1 << 20,
                                        reps=2)
    assert (cal.platform, cal.source) == ("cuda", "measured")
    ranked = sorted(cal.profiles, key=lambda kv: -kv[1].words_per_sec)
    assert ranked[0][0] == "cuda", ranked
    assert all(p.dispatch_overhead_s > 0 for _, p in cal.profiles)


def test_explain_on_a_card_session(dev):
    """explain on an auto session on the card: the decision of the card's
    calibration over its one candidate, the kernels, and the one a query
    then runs."""
    from repro_torch.engine import costmodel
    rng = np.random.default_rng(33)
    db = BitmapDB(num_keys=64, device=dev)
    db.append_encoded(rng.integers(0, 64, (1 << 20, 8), dtype=np.uint8))
    q = planner.key(1) & ~planner.key(2)
    ex = db.explain(q)
    d = ex["decision"]
    assert d is not None and d["backend"] == ex["backend"]
    assert set(d["estimates"]) == set(costmodel.candidates(device=dev)) \
        == {"cuda"}
    assert d["backend"] == "cuda"
    assert ex["num_words"] == (1 << 20) // 32 and ex["segments"] == 1
    assert ex["est_matches"] is not None
    want = costmodel.decide([ex["plan"]], num_words=ex["num_words"],
                            num_keys=64, stats=db.stats, device=dev)
    assert (want.backend, dict(want.estimates)) == (d["backend"],
                                                    d["estimates"])
    assert db.query(q).count == db.query_many([q], backend="ref")[0].count


def test_fabric_host_rows_on_the_card(dev):
    """The fabric over card sessions: ServiceHost's one-copy row path
    (the live rows stacked on the card, copied once, viewed as uint32)
    equals the rows copied one future at a time, a failed query's slot
    is a zero row, and a blocked two-shard loopback fabric answers
    bit-identically to one card session with every wave on the kernels."""
    from repro_torch.fabric import FabricClient, ShardMap
    from repro_torch.fabric.protocol import _result_payload
    rng = np.random.default_rng(35)
    recs = rng.integers(0, 64, (1 << 20, 8), dtype=np.uint8)
    db = BitmapDB(num_keys=64, device=dev)
    db.append_encoded(recs)
    preds = _serving_preds(rng, 64, 40) + [planner.key(10_000)]
    with db.serve(max_batch=64, max_delay_ms=2.0) as svc:
        futs = [svc.submit(p) for p in preds]
        assert svc.drain(timeout=120)
        out = _result_payload(futs, count_only=False)
    for qi, f in enumerate(futs[:-1]):
        r, c = f.result(timeout=120)
        want = r.cpu().numpy().view(np.uint32)
        assert np.array_equal(out["rows"][qi, :want.shape[0]], want)
        assert out["counts"][qi] == int(c)
    assert not out["rows"][-1].any() and len(out["errors"]) == 1
    half = 1 << 19
    shards = []
    for s in range(2):
        sdb = BitmapDB(num_keys=64, device=dev)
        sdb.append_encoded(recs[s * half:(s + 1) * half])
        shards.append(sdb)
    gids = [np.arange(s * half, (s + 1) * half, dtype=np.int64)
            for s in range(2)]
    from repro_torch.engine import batch as tbatch
    waves0 = tbatch.waves_by_backend()
    with FabricClient.local(shards, ShardMap.blocked(2, block_size=half),
                            gids=gids) as fc:
        ffuts = fc.submit_many(preds[:-1])
        assert fc.drain(timeout=120)
        for f, (r, c) in zip(ffuts, (g.result() for g in futs[:-1])):
            row, count = f.result(timeout=120)
            assert np.array_equal(row, r.cpu().numpy().view(np.uint32))
            assert count == int(c)
        proc = fc.health()["shards"][0]["process"]
    assert _waves_off_the_kernels(waves0) == {}
    assert proc["waves_by_backend"].get("cuda", 0) >= 1
    assert proc["launches"]["bulk_program"] >= 1


# ------------------------- training the families, and Whisper, on the card
TRAINED = ["whisper_small", "qwen2_moe_a2_7b", "granite_moe_3b_a800m",
           "mamba2_2_7b", "hymba_1_5b"]


def _smoke_batch(cfg, seed: int, batch: int = 2, seq: int = 40) -> dict:
    """Tokens, labels and, for an encoder-decoder, frames (standard normal
    x 0.02), as CPU tensors."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.enc_dec:
        out["frames"] = torch.from_numpy((rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32))
    return out


def _loss_and_grads(model_mod, cfg, params, batch):
    params.requires_grad_(True)
    loss, _ = model_mod.lm_loss(params, cfg, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in params.named_parameters()
             if p.grad is not None}
    params.zero_grad(set_to_none=True)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", TRAINED)
def test_family_train_step_on_the_card_matches_the_cpu(dev, arch,
                                                       monkeypatch):
    """A smoke-width fp32 step (remat full): the loss rtol 1e-5 and every
    gradient within 1e-4 of its largest magnitude plus 1e-7 of the CPU's
    (``tests/test_torch_train.py``'s rule against the reference); the
    forward kernel twice and the backward kernel once an attention layer
    (Whisper: encoder, self and cross), then a ``make_train_step`` step
    with a finite loss."""
    from repro_torch.models import model
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    monkeypatch.setattr(model, "COMPUTE_DTYPE", torch.float32)
    cfg, params = _family_params(arch, seed=3)
    batch = _smoke_batch(cfg, 4)
    cpu = model.params_from_numpy(cfg, params, device="cpu",
                                  dtype=torch.float32)
    card = model.params_from_numpy(cfg, params, device=dev,
                                   dtype=torch.float32)
    want_loss, want = _loss_and_grads(model, cfg, cpu, batch)
    f0, b0 = tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches
    got_loss, got = _loss_and_grads(model, cfg, card,
                                    {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    attn = ((cfg.num_layers if cfg.block != "ssm" else 0)
            + (cfg.num_layers + cfg.enc_layers if cfg.enc_dec else 0))
    assert tfa.flash_attention_fwd.launches - f0 == 2 * attn
    assert tfa.flash_attention_bwd.launches - b0 == attn
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    assert set(got) == set(want)
    for name, g in want.items():
        tol = 1e-4 * float(g.abs().max()) + 1e-7
        assert float((got[name].cpu() - g).abs().max()) <= tol, name
    opt = init_opt_state(card, OptimConfig())
    card, opt, m = make_train_step(cfg, TrainConfig())(
        card, opt, {k: v.to(dev) for k, v in batch.items()})
    assert bool(torch.isfinite(m["loss"])) and int(opt["step"]) == 1


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "granite_moe_3b_a800m"])
def test_moe_backward_is_bit_identical_on_the_card(dev, arch):
    """bf16 compute from fp32 masters, capacity factor 0.5 (drops): two
    runs of the loss and its backward from the same state give
    bit-identical gradients (the token rows enter the expert buffer
    through a view whose backward sums in a fixed order)."""
    import dataclasses
    from repro_torch.models import model
    cfg, params = _family_params(arch, seed=5)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    card = model.params_from_numpy(cfg, params, device=dev,
                                   dtype=torch.float32)
    batch = {k: v.to(dev) for k, v in _smoke_batch(cfg, 6, 4, 64).items()}
    loss1, g1 = _loss_and_grads(model, cfg, card, batch)
    loss2, g2 = _loss_and_grads(model, cfg, card, batch)
    assert torch.equal(loss1, loss2) and set(g1) == set(g2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1), [
        n for n in g1 if not torch.equal(g1[n], g2[n])]


def test_whisper_greedy_generate_on_the_card(dev, monkeypatch):
    """Whisper's smoke config on the card: a prefill launches the flash
    kernel three times a layer pair (encoder, self, cross); in fp32 the
    greedy tokens equal the CPU's."""
    from repro_torch.models import model
    from repro_torch.serve.step import greedy_generate
    cfg, params = _family_params("whisper_small")
    batch = _smoke_batch(cfg, 0, 2, 37)
    tokens, frames = batch["tokens"], batch["frames"]
    card = model.params_from_numpy(cfg, params, device=dev)
    before = tfa.flash_attention_fwd.launches
    out = greedy_generate(card, cfg, tokens.to(dev), steps=4,
                          frames=frames.to(dev))
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches - before
            == cfg.enc_layers + 2 * cfg.num_layers)
    assert out.shape == (2, 4)
    monkeypatch.setattr(model, "COMPUTE_DTYPE", torch.float32)
    card = model.params_from_numpy(cfg, params, device=dev,
                                   dtype=torch.float32)
    cpu = model.params_from_numpy(cfg, params, device="cpu",
                                  dtype=torch.float32)
    got = greedy_generate(card, cfg, tokens.to(dev), steps=4,
                          frames=frames.to(dev))
    want = greedy_generate(cpu, cfg, tokens, steps=4, frames=frames)
    assert torch.equal(got.cpu(), want)


def test_flash_meta_route_leaves_the_card_route_alone(dev):
    """Meta calls between two card calls: the card's launch counters count
    the card calls only, the traced counters the meta ones, and the card
    outputs are bit-identical."""
    torch.manual_seed(0)
    q = torch.randn(2, 256, 4, 64, device=dev, dtype=torch.bfloat16)
    k = torch.randn(2, 256, 2, 64, device=dev, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    dout = torch.randn_like(q)
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd

    def card():
        out, lse = fwd(q, k, v, causal=True, window=100, return_lse=True)
        return (out, lse, *bwd(q, k, v, out, lse, dout, causal=True,
                               window=100))
    f0, b0, tf0, tb0 = fwd.launches, bwd.launches, fwd.traced, bwd.traced
    first = card()
    m = [t.to("meta") for t in (q, k, v, dout)]
    out, lse = fwd(*m[:3], causal=True, window=100, return_lse=True)
    bwd(*m[:3], out, lse, m[3], causal=True, window=100)
    second = card()
    torch.cuda.synchronize()
    assert (fwd.launches - f0, bwd.launches - b0) == (2, 2)
    assert (fwd.traced - tf0, bwd.traced - tb0) == (1, 1)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_dry_run_predicts_a_small_cells_peak_on_the_card(dev):
    """Whisper-small, one fp32 train step of 2 x (1500 frames, 448
    tokens) under ``dryrun.FlopCount``: the arguments' bytes exact, the
    peak over what was resident within ``dryrun.PEAK_BOUND`` (20%) of the
    prediction, the flash launches the traced calls and the non-attention
    flops the trace's."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec, batch_specs
    from repro_torch.optim.adamw import OptimConfig, abstract_opt_state
    from torch_checks import STEP_FILLS, materialize
    cfg = get_config("whisper_small")
    pred = dryrun.config_peak(cfg, "train", 2, 448)
    params = dryrun.meta_params(cfg)
    args = (params, abstract_opt_state(params, OptimConfig()),
            batch_specs(cfg, ShapeSpec("t", 448, 2, "train")))
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(0)
    real = [materialize(a, dev, gen, cfg.vocab_size, f)
            for a, f in zip(args, STEP_FILLS["train"])]
    torch.cuda.synchronize()
    assert dryrun.tree_bytes(real) == pred["argument_bytes"]
    torch.cuda.reset_peak_memory_stats()
    f0, b0 = tfa.flash_attention_fwd.launches, tfa.flash_attention_bwd.launches
    with dryrun.FlopCount() as fc:
        _, _, m = dryrun.train_fn(cfg, 1)(*real)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    want = pred["argument_bytes"] + pred["temp"]
    assert abs(peak - want) <= dryrun.PEAK_BOUND * want, (peak, want)
    assert {"flash_attention_fwd": tfa.flash_attention_fwd.launches - f0,
            "flash_attention_bwd": tfa.flash_attention_bwd.launches - b0} \
        == pred["flash_calls"]
    assert fc.flops == pred["matmul_flops"]
    assert bool(torch.isfinite(m["loss"]))
