"""The counted ``bulk_program`` forms and a model of the kernel's schedule,
against the JAX package, on the CPU.

On CPU tensors the counted wrappers run their plain versions; these tests
hold those against the reference's executors bit for bit (the 2-D counted
form against ``repro.engine.bulk.run_program_pallas`` in interpret mode,
the stacked counted form against the reference's segment-stacked executor,
``repro.engine.batch._stacked_executor``).  The CUDA kernel cannot run
here, so :func:`model_bulk` replays its schedule in numpy, as
``csrc/bitmap_ops.cu`` runs it: the plan by shape (query chunks, strips of
word tiles, the route), the prologue's hash map from row id to slot (in a
random order, as the threads' atomics may take it), the tile width from D,
the two-stage ring with words past Nw left as garbage, the warp items, the
masked epilogue, the per-CTA count partials, and the gather route's
word-major blocks.  It is held against the reference on
programs with identity literals, pad groups, every literal inverted and D
past the staged route's cap.  Packed words and counts are integers: no
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import batch as jbatch
from repro.engine import bulk as jbulk
from repro_torch.engine import bulk as tbulk
from repro_torch.engine import policy as tpolicy
from repro_torch.kernels import bitmap_ops as tbq
from torch_checks import (BULK_DCAP, BULK_GATHER_WPT, BULK_HBITS,
                          BULK_QPI, BULK_RING_BYTES, BULK_STAGES,
                          BULK_THREADS,
                          bulk_counted_inputs, bulk_staged_plan,
                          bulk_staged_route, bulk_tile_words, record_cuts,
                          stacked_program_inputs)

# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

IDENT, INV = 0x7FFF, 0x8000


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def tail_np(v: np.ndarray, n: int, w: np.ndarray) -> np.ndarray:
    """The kernel's tail mask of words ``w`` for ``n`` records."""
    left = n - w.astype(np.int64) * 32
    part = ((np.uint64(1) << np.clip(left, 0, 31).astype(np.uint64))
            - np.uint64(1)).astype(np.uint32)
    return np.where(left >= 32, v, np.where(left <= 0, 0, v & part)
                    ).astype(np.uint32)


def popcount_np(v: np.ndarray) -> int:
    return int(np.bitwise_count(v.astype(np.uint32)).sum())


def fold_np(get, lits, post_q, g, p, l, shape):
    """OR over groups of AND over passes of [(AND over literals) ^ post]
    for one query; ``lits`` yields (slot or None, flip), ``get(slot)`` the
    operand words."""
    res = np.zeros(shape, np.uint32)
    for gi in range(g):
        grp = np.full(shape, 0xFFFFFFFF, np.uint32)
        for pi in range(p):
            acc = np.full(shape, 0xFFFFFFFF, np.uint32)
            for li in range(l):
                slot, flip = lits[(gi * p + pi) * l + li]
                acc &= (~flip if slot is None else get(slot) ^ flip)
            grp &= acc ^ np.uint32(post_q[gi, pi])
        res |= grp
    return res


def _map_chunk(rng, sel, inv, m):
    """The prologue: a hash of the chunk's distinct rows (inserted in a
    random order, linear probing), slots handed out in a random order, the
    program rewritten as 16-bit slot literals."""
    hcap = 1 << BULK_HBITS
    hkey = np.full(hcap, -1, np.int64)
    prog = np.zeros(sel.size, np.int64)
    for i in rng.permutation(sel.size):
        key = int(sel[i])
        flag = INV if inv[i] else 0
        if not 0 <= key < m:
            prog[i] = flag | IDENT
            continue
        h = ((key * 2654435761) & 0xFFFFFFFF) >> (32 - BULK_HBITS)
        for _ in range(hcap):
            if hkey[h] in (-1, key):
                break
            h = (h + 1) & (hcap - 1)
        else:
            raise AssertionError("hash table full")
        hkey[h] = key
        prog[i] = flag | h
    occupied = np.flatnonzero(hkey >= 0)
    hslot = np.zeros(hcap, np.int64)
    rowlist = np.zeros(len(occupied), np.int64)
    for slot, h in enumerate(rng.permutation(occupied)):
        hslot[h] = slot
        rowlist[slot] = hkey[h]
    ident = (prog & IDENT) == IDENT
    prog = np.where(ident, prog,
                    (prog & INV) | hslot[np.where(ident, 0, prog & IDENT)])
    assert len(rowlist) == len(set(sel[(sel >= 0) & (sel < m)].tolist()))
    return prog, rowlist


def _lits(prog_q):
    return [(None if (v & IDENT) == IDENT else int(v & IDENT),
             np.uint32(0xFFFFFFFF if v & INV else 0)) for v in prog_q]


def model_staged(rng, aug, nrecs, nrec, sels, invs, post, counted, plan,
                 out, written, counts):
    s_n, m1, nw = aug.shape
    m = m1 - 1
    q, g, p, l = sels.shape
    gpl = g * p * l
    qc, nchunks, nstrips = plan
    masked = nrecs is not None or counted
    lane = np.arange(32)
    for b in rng.permutation(s_n * nchunks * nstrips):    # blocks: any order
        chunk, s = b % nchunks, b // (nchunks * nstrips)
        strip = (b // nchunks) % nstrips
        q0 = chunk * qc
        qn = min(qc, q - q0)
        prog, rowlist = _map_chunk(rng, sels[q0:q0 + qn].reshape(-1),
                                   invs[q0:q0 + qn].reshape(-1), m)
        d = len(rowlist)
        assert d <= BULK_DCAP
        tw = bulk_tile_words(d, nw)
        assert BULK_STAGES * (d + 1) * tw * 4 <= BULK_RING_BYTES
        vl = min(tw // 32, 4)                   # words a lane, consecutive
        sw = 32 * vl
        segs = tw // sw
        ntiles = -(-nw // tw)
        n = int(nrecs[s]) if nrecs is not None else nrec
        qcount = np.zeros(qn, np.int64)
        for t in range(strip, ntiles, nstrips):
            w0 = t * tw
            ring = rng.integers(0, 2 ** 32, (d, tw), dtype=np.uint32)
            have = min(tw, nw - w0)             # words past Nw stay garbage
            ring[:, :have] = aug[s, rowlist, w0:w0 + have]
            for it in range(-(-qn // BULK_QPI) * segs):
                offs = (it % segs) * sw + vl * lane[:, None] + np.arange(vl)
                w = w0 + offs
                ok = w < nw
                for qq in range(it // segs * BULK_QPI,
                                min(it // segs * BULK_QPI + BULK_QPI, qn)):
                    res = fold_np(lambda slot: ring[slot, offs],
                                  _lits(prog[qq * gpl:(qq + 1) * gpl]),
                                  post[q0 + qq], g, p, l, offs.shape)
                    v = tail_np(res, n, w) if masked else res
                    out[s, q0 + qq, w[ok]] = v[ok]
                    written[s, q0 + qq, w[ok]] += 1
                    qcount[qq] += popcount_np(v[ok])
        counts[s, q0:q0 + qn] += qcount         # one atomicAdd per query


def model_gather(rng, aug, nrecs, nrec, sels, invs, post, counted, out,
                 written, counts):
    s_n, m1, nw = aug.shape
    m = m1 - 1
    q, g, p, l = sels.shape
    masked = nrecs is not None or counted
    span = BULK_THREADS * BULK_GATHER_WPT
    bpq = -(-nw // span)
    words = np.arange(BULK_THREADS)[:, None] \
        + BULK_THREADS * np.arange(BULK_GATHER_WPT)
    for bid in rng.permutation(s_n * q * bpq):
        s, r = divmod(bid, q * bpq)
        qq, wblk = r % q, r // q
        w = wblk * span + words
        ok = w < nw
        lits = [(None if sel == m else int(sel),
                 np.uint32(0xFFFFFFFF if inv else 0))
                for sel, inv in zip(sels[qq].reshape(-1),
                                    invs[qq].reshape(-1))]
        res = fold_np(lambda row: np.where(ok, aug[s, row, np.minimum(
            w, nw - 1)], 0).astype(np.uint32), lits, post[qq], g, p, l,
            w.shape)
        n = int(nrecs[s]) if nrecs is not None else nrec
        v = tail_np(res, n, w) if masked else res
        out[s, qq, w[ok]] = v[ok]
        written[s, qq, w[ok]] += 1
        counts[s, qq] += popcount_np(v[ok])     # one atomicAdd per block


def model_bulk(aug, sels, invs, post, *, nrecs=None, nrec=0, counted,
               ctas, seed=0):
    """The kernel's schedule in numpy: (rows (S, Q, Nw), counts (S, Q),
    route) for uint32 aug (S, M+1, Nw); every word is written once."""
    rng = np.random.default_rng(seed)
    s_n, m1, nw = aug.shape
    q, g, p, l = sels.shape
    post = post.view(np.uint32)
    out = np.zeros((s_n, q, nw), np.uint32)
    written = np.zeros((s_n, q, nw), np.int64)
    counts = np.zeros((s_n, q), np.int64)
    plan = bulk_staged_plan(s_n, m1 - 1, nw, q, g * p * l, ctas)
    if plan is not None:
        model_staged(rng, aug, nrecs, nrec, sels, invs, post, counted, plan,
                     out, written, counts)
        launched = "staged"
    else:
        model_gather(rng, aug, nrecs, nrec, sels, invs, post, counted, out,
                     written, counts)
        launched = "gather"
    assert (written == 1).all()
    return out, counts.astype(np.int32), launched


def _program(rng, m, shape, *, identity=0.3, pad_groups=True,
             literals="mixed"):
    """A random program over [0, M] with identity literals and pad groups
    (identity literals, post all ones at pass 0), as the batch layer pads."""
    sels = rng.integers(0, m, shape).astype(np.int32)
    sels[rng.random(shape) < identity] = m
    invs = (np.ones(shape, np.int32) if literals == "all inverted"
            else rng.integers(0, 2, shape).astype(np.int32))
    post = np.where(rng.random(shape[:3]) < 0.3, -1, 0).astype(np.int32)
    if pad_groups and shape[1] > 1:
        q, g = shape[:2]
        pad = rng.random((q, g)) < 0.25
        pad[:, 0] = False
        sels[pad] = m
        post[pad] = 0
        post[pad, 0] = -1
    return sels, invs, post


def _aug(rng, s, m, nw):
    aug = rng.integers(0, 2 ** 32, (s, m + 1, nw), dtype=np.uint32)
    aug[:, m] = 0xFFFFFFFF
    return aug


# --------------------------------------------------- counted, 2-D and stacked
@pytest.mark.parametrize("m,nw,shape,literals", [
    (9, 40, (8, 2, 2, 4), "mixed"),
    (13, 37, (4, 4, 1, 4), "mixed"),            # ragged Nw
    (6, 5, (2, 2, 2, 2), "all inverted"),
    (5, 1, (1, 1, 1, 1), "mixed"),
])
def test_counted_plain_matches_pallas_run_program(m, nw, shape, literals):
    """The 2-D counted form's plain version against the reference's
    ``run_program_pallas`` in interpret mode, at record counts that cut
    the row mid-word, and against the engine's ``mask_tail``."""
    rng = np.random.default_rng(m * nw)
    aug, sels, invs, post = bulk_counted_inputs(rng, m, nw, shape, literals)
    for n in record_cuts(nw):
        got_r, got_c = tbq.bulk_program_counted(
            torch.from_numpy(aug), n, *map(torch.from_numpy,
                                           (sels, invs, post)))
        want_r, want_c = jbulk.run_program_pallas(
            jnp.asarray(aug.view(np.uint32)), n, jnp.asarray(sels),
            jnp.asarray(invs), jnp.asarray(post.view(np.uint32)))
        np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        assert got_c.dtype == torch.int32
        eng_r, eng_c = tpolicy.mask_tail(tbq.bulk_program_plain(
            *map(torch.from_numpy, (aug, sels, invs, post))), n)
        assert torch.equal(got_r, eng_r) and torch.equal(got_c, eng_c)


@pytest.mark.parametrize("s,m,nw,shape,literals", [
    (1, 13, 101, (8, 4, 2, 4), "mixed"),
    (3, 13, 101, (8, 4, 2, 4), "mixed"),
    (5, 7, 33, (4, 2, 2, 8), "mixed"),
    (3, 13, 30, (4, 2, 2, 8), "all inverted"),
])
def test_stacked_counted_plain_matches_reference_stacked_executor(
        s, m, nw, shape, literals):
    """The stacked counted form's plain version against the reference's
    segment-stacked executor (its bucket body vmapped over segments) at
    per-segment record counts that cut empty, one record, mid-word and
    full; the uncounted stacked form gives the same rows."""
    rng = np.random.default_rng(s * 100 + nw)
    aug, nrecs, sels, invs, post = stacked_program_inputs(
        rng, s, m, nw, shape, literals)
    got_r, got_c = tbq.bulk_program_stacked_counted(
        *map(torch.from_numpy, (aug, nrecs, sels, invs, post)))
    run = jbatch._stacked_executor("bulk", *shape[1:])
    want_r, want_c = run(jnp.asarray(aug.view(np.uint32)),
                         jnp.asarray(nrecs), jnp.asarray(sels),
                         jnp.asarray(invs), jnp.asarray(post.view(np.uint32)))
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert torch.equal(got_r, tbq.bulk_program_stacked(
        *map(torch.from_numpy, (aug, nrecs, sels, invs, post))))


def test_executors_on_the_cpu_keep_the_plain_route():
    """``run_program`` and ``run_program_stacked`` on CPU tensors equal the
    plain sweep with the engine's tail mask and popcount, and count no
    kernel launch."""
    rng = np.random.default_rng(5)
    aug, nrecs, sels, invs, post = map(torch.from_numpy,
                                       stacked_program_inputs(
                                           rng, 3, 11, 70, (4, 2, 2, 2),
                                           "mixed"))
    before = (tbq.bulk_program.launches, tbq.bulk_program_stacked.launches)
    for si in range(3):
        got = tbulk.run_program(aug[si], int(nrecs[si]), sels, invs, post)
        want = tbulk.run_program_plain(aug[si], int(nrecs[si]), sels, invs,
                                       post)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    rows, counts = tbulk.run_program_stacked(aug, nrecs.tolist(), sels, invs,
                                             post)
    for si in range(3):
        want = tbulk.run_program_plain(aug[si], int(nrecs[si]), sels, invs,
                                       post)
        assert torch.equal(rows[si], want[0])
        assert torch.equal(counts[si], want[1])
    assert before == (tbq.bulk_program.launches,
                      tbq.bulk_program_stacked.launches)


def test_counted_wrappers_check_arguments():
    aug = torch.zeros((3, 4), dtype=torch.int32)
    prog = torch.zeros((1, 1, 1, 1), dtype=torch.int32)
    post = torch.zeros((1, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="want aug \\(M\\+1, Nw\\)"):
        tbq.bulk_program_counted(aug, 3, prog, prog, post[0])
    with pytest.raises(ValueError, match="want aug \\(S, M\\+1, Nw\\)"):
        tbq.bulk_program_stacked_counted(
            aug, torch.zeros(3, dtype=torch.int32), prog, prog, post)
    with pytest.raises(ValueError, match="must be int32"):
        tbq.bulk_program_counted(aug.long(), 3, prog, prog, post)


# ------------------------------------------------------ the kernel's schedule
#: (S, M, Nw, (Q, G, P, L), literals, resident CTAs): chunked queries and
#: strips of several tiles (few CTAs), a ragged last tile, Nw % 4 != 0,
#: every literal inverted, D past the staged route's 351 rows (M = 400,
#: one chunk of 1024 literals: the gather route), and many one-query
#: chunks (a one-tile bucket spread over the card's CTAs).
MODEL_CASES = (
    (1, 13, 1001, (8, 4, 2, 4), "mixed", 264),
    (1, 13, 1001, (8, 4, 2, 4), "mixed", 3),
    (1, 40, 3000, (16, 2, 1, 4), "mixed", 4),
    (3, 13, 601, (4, 2, 2, 8), "all inverted", 5),
    (1, 400, 130, (64, 4, 1, 4), "mixed", 1),
    (1, 7, 33, (300, 1, 1, 2), "mixed", 64),
    (2, 300, 70, (8, 8, 2, 4), "mixed", 2),
)


def _reference(aug, sels, invs, post, nrecs, nrec, counted):
    """The JAX reference's answer: rows and counts (None when uncounted)."""
    post_u = jnp.asarray(post.view(np.uint32))
    if nrecs is not None:
        run = jbatch._stacked_executor("bulk", *sels.shape[1:])
        rows, counts = run(jnp.asarray(aug), jnp.asarray(nrecs),
                           jnp.asarray(sels), jnp.asarray(invs), post_u)
        return np.asarray(rows), np.asarray(counts) if counted else None
    if counted:
        rows, counts = jbulk.run_program(jnp.asarray(aug[0]), nrec,
                                         jnp.asarray(sels), jnp.asarray(invs),
                                         post_u)
        return np.asarray(rows)[None], np.asarray(counts)[None]
    rows = jbulk._sweep_jnp(jnp.asarray(aug[0]), jnp.asarray(sels),
                            jnp.asarray(invs), post_u)
    return np.asarray(rows)[None], None


@pytest.mark.parametrize("s,m,nw,shape,literals,ctas", MODEL_CASES)
@pytest.mark.parametrize("counted", [False, True])
def test_kernel_schedule_model_matches_reference(s, m, nw, shape, literals,
                                                 ctas, counted):
    rng = np.random.default_rng(s * 7919 + m * 31 + nw)
    aug = _aug(rng, s, m, nw)
    sels, invs, post = _program(rng, m, shape, literals=literals)
    stacked = s > 1
    nrecs = (np.array([record_cuts(nw)[i % 5] for i in range(s)], np.int32)
             if stacked else None)
    nrec = 32 * nw - 5
    want_r, want_c = _reference(aug, sels, invs, post, nrecs, nrec, counted)
    got_r, got_c, route = model_bulk(aug, sels, invs, post, nrecs=nrecs,
                                     nrec=nrec, counted=counted, ctas=ctas,
                                     seed=nw)
    assert route == bulk_staged_route(s, m, nw, shape, ctas)
    np.testing.assert_array_equal(got_r, want_r)
    if counted:
        np.testing.assert_array_equal(got_c, want_c)


def test_model_covers_both_routes_and_the_cap():
    """The cases above take both routes; the staged plan's worst chunk fits
    the ring at 32-word tiles, and one row more than the cap (with every
    chunk selecting it) takes the gather route."""
    routes = {bool(bulk_staged_plan(s, m, nw, sh[0], sh[1] * sh[2] * sh[3],
                                    c))
              for s, m, nw, sh, _, c in MODEL_CASES}
    assert routes == {True, False}
    assert BULK_STAGES * (BULK_DCAP + 1) * 32 * 4 <= BULK_RING_BYTES
    assert bulk_staged_plan(1, BULK_DCAP, 4096, 1024, 4, 1) is not None
    assert bulk_staged_plan(1, BULK_DCAP + 1, 4096, 1024, 4, 1) is None
    assert bulk_tile_words(0, 1 << 20) == 512
    assert bulk_tile_words(11, 1 << 20) == 512
    assert bulk_tile_words(51, 1 << 20) == 128
    assert bulk_tile_words(BULK_DCAP, 1 << 20) == 32
    assert bulk_tile_words(3, 33) == 64


@pytest.mark.parametrize("s", [1, 3])
def test_gather_route_model_matches_reference(s):
    """The gather route, taken by shape (queries of 512 literals over
    M = 500, past the staged route's 351 rows), counted and masked past a
    mid-word record count, 2-D and stacked."""
    rng = np.random.default_rng(17 + s)
    m, nw, shape = 500, 1500, (4, 8, 2, 32)
    aug = _aug(rng, s, m, nw)
    sels, invs, post = _program(rng, m, shape)
    nrecs = (np.array([record_cuts(nw)[i] for i in (2, 4, 0)][:s], np.int32)
             if s > 1 else None)
    nrec = nw * 16 + 9
    want_r, want_c = _reference(aug, sels, invs, post, nrecs, nrec, True)
    got_r, got_c, launched = model_bulk(aug, sels, invs, post, nrecs=nrecs,
                                        nrec=nrec, counted=True, ctas=264)
    assert launched == "gather"
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_c, want_c)
