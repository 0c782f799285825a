"""Inputs and tolerances shared by the port's kernel tests and
``chip_smoke.py``.  numpy and torch only (no JAX), so the card's tests and
the smoke script import it too.
"""
import itertools
import math

import numpy as np
import torch

#: slack of the bf16 attention check, a fraction of the largest magnitude
#: of the element's output row: far above the fp32 accumulation-order
#: differences between a kernel and the plain version (about 2^-17 of the
#: row), far below what rounding P to bf16 before P V costs (about 2^-10)
BF16_ROW_SLACK = 2.0 ** -12


def any_int32_cam_inputs(rng, n: int, w: int, m: int):
    """``cam_match`` inputs off the main path's [0, 256): keys over the
    whole int32 range (about half in the table's [0, 256)), with duplicates
    and the key sentinel -2; records drawn from those keys, other int32
    values, [0, 256) and the record sentinel -1.  numpy int32 (records,
    keys)."""
    keys = np.where(rng.random(m) < 0.5, rng.integers(0, 256, m),
                    rng.integers(-2 ** 31, 2 ** 31, m)).astype(np.int32)
    keys[rng.random(m) < 0.1] = -2
    keys[m // 2:m // 2 + 2] = keys[0]                       # duplicates
    pool = np.concatenate([keys, rng.integers(-2 ** 31, 2 ** 31, 64),
                           rng.integers(0, 256, 64), [-1]]).astype(np.int32)
    return rng.choice(pool[pool != -2], (n, w)), keys


def bf16_spacing(x: torch.Tensor) -> torch.Tensor:
    """The gap between adjacent bf16 values in the binade of each |x|."""
    a = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)


def bf16_attn_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The bf16 attention check: the worst ratio of |got - want| to the
    element's tolerance, one bf16 ulp of the element plus
    :data:`BF16_ROW_SLACK` of its output row's largest magnitude (a row is
    the last axis).  ``want`` is the fp32 result; an output within 1 passes.
    Rounding an fp32-accurate result to bf16 once scores about 1/2; rounding
    P to bf16 before P V scores several times 1, whatever the row's length."""
    if not want.numel():
        return 0.0
    want = want.float()
    tol = bf16_spacing(want) + BF16_ROW_SLACK * want.abs().amax(
        -1, keepdim=True)
    return float(((got.float() - want).abs() / tol).max())


#: flash backward kernel cases (S, head_dim, H/KV, causal, dtype): ragged
#: and one-token sequences, S = 200 across two 128-row tiles raggedly, S =
#: 1000 whose last 128-row tile is cut inside its second 64-row half (the
#: tensor-core kernels tile 128 queries or keys a CTA and 64 a step; at
#: head_dim 256, 64-key forward and dK/dV tiles and 32-key dQ tiles), head
#: dims 64, 128 and 256, no GQA and Qwen2-7B's 7 query heads a KV head (2 at
#: head_dim 256, Gemma3's).  Shared by the card tests and chip_smoke.py.
FLASH_BWD_CASES = tuple(
    (s, hd, g, causal, dt)
    for s in (1, 63, 200, 1000, 2048) for hd in (64, 128, 256)
    for g in ((1, 2) if hd == 256 else (1, 7))
    for causal in (True, False) for dt in (torch.float32, torch.bfloat16))


def flash_bwd_inputs(rng, s: int, hd: int, g: int, dtype, dev, *,
                     batch: int = 2, kv: int = 2, skv: int | None = None):
    """q, k, v, dout of a :data:`FLASH_BWD_CASES` case: ``batch`` (2)
    sequences, ``kv`` (2) KV heads and ``kv`` g query heads, standard
    normal; k and v hold ``skv`` positions (default ``s``)."""
    def one(heads, n):
        return torch.from_numpy(rng.standard_normal((batch, n, heads, hd))
                                .astype(np.float32)).to(dev, dtype)
    skv = s if skv is None else skv
    return one(kv * g, s), one(kv, skv), one(kv, skv), one(kv * g, s)


#: sliding-window flash cases (S, window, head_dim, H/KV, dtype), causal:
#: windows of one key, of a 64-row tile, off the tiles (100) and Gemma3's
#: 1024, over ragged and full-tile sequences; H/KV 1 and Qwen2's 7 (2 at
#: head_dim 256, Gemma3's).  Shared by the card tests and chip_smoke.py.
FLASH_WINDOW_CASES = tuple(
    (s, w, hd, g, dt) for s, w, hd, dt in itertools.product(
        (63, 200, 1000, 2048), (1, 64, 100, 1024), (64, 128, 256),
        (torch.float32, torch.bfloat16))
    for g in ((1, 2) if hd == 256 else (1, 7)))

#: offset flash cases (Sq, Skv, q_offset, kv_len, window, causal): a chunk
#: of queries against a longer cache, with and without a window; one
#: decode position; kv_len < Skv, causal and full (a padded cache); cross
#: attention (full, Sq != Skv); rows that see no key (115..127 of the
#: eighth case: q + 384 - 100 >= kv_len), written as zeros with an lse of
#: NEG_INF; and the Ulysses shards of a 2048-position sequence over 4
#: processes (Sq 512 against every key, no kv_len, causal): ranks 0, 1
#: and 3, whose keys past their last query get no query, and rank 3 under
#: a window of 1024.  Each runs at head_dim 64, 128 and 256 in fp32 and
#: bf16.
FLASH_OFFSET_CASES = (
    (64, 1000, 936, None, None, True),
    (200, 1000, 800, None, 100, True),
    (1, 300, 299, None, 64, True),
    (130, 700, 400, 600, 64, True),
    (200, 200, 0, 150, None, True),
    (200, 200, 0, 150, None, False),
    (77, 300, 0, None, None, False),
    (128, 512, 384, 400, 100, True),
    (512, 2048, 0, None, None, True),
    (512, 2048, 512, None, None, True),
    (512, 2048, 1536, None, None, True),
    (512, 2048, 1536, None, 1024, True),
)


#: Whisper-small's bidirectional flash cases (Sq, Skv, dtype): the encoder
#: over its 1500 frames, the 224-token prompt's cross-attention and the
#: 448-token text context's in training, each against the 1500 frames; at
#: batch 8 with 12 query and 12 KV heads of 64 (:data:`ENCDEC_FLASH_SHAPE`).
#: 1500 is no tile multiple, so the edge tiles are masked by bounds.
#: Shared by the card tests and chip_smoke.py's phase 2.
ENCDEC_FLASH_CASES = tuple(
    (sq, 1500, dt) for sq in (1500, 224, 448)
    for dt in (torch.float32, torch.bfloat16))
#: batch, KV heads, H/KV and head_dim of :data:`ENCDEC_FLASH_CASES`
ENCDEC_FLASH_SHAPE = {"batch": 8, "kv": 12, "g": 1, "hd": 64}


def grid_positions(batch: int, seq: int, patches: int, side: int
                   ) -> np.ndarray:
    """Qwen2-VL's M-RoPE layout (3, batch, seq) int32, so that the streams
    differ: patch i of the ``patches`` at the sequence's start gets (t, h,
    w) = (0, i // side, i % side), a grid of ``side`` columns; text token j
    after them gets side + j in all three streams."""
    i = np.arange(patches)
    j = np.arange(seq - patches)
    pos = np.stack([np.concatenate([np.zeros(patches, np.int64), side + j]),
                    np.concatenate([i // side, side + j]),
                    np.concatenate([i % side, side + j])])
    return np.broadcast_to(pos[:, None], (3, batch, seq)).astype(np.int32)


def attn_tol(want: torch.Tensor, dtype) -> float:
    """Kernel-vs-plain tolerance of the flash forward: the reference test's
    atol 2e-5 for fp32 inputs; for bf16, one bf16 ulp at the output's
    largest magnitude (each side rounds an fp32 result to bf16 once)."""
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -7 * float(want.float().abs().max())


def flash_mask_ratios(attention, q, k, v, dout, *, causal: bool = True,
                      **mask) -> dict:
    """The flash kernels against their plain versions on one case with
    mask arguments ``mask`` (window, q_offset, kv_len): err/tol of the
    forward output (``max``, :func:`attn_tol`; ``element``,
    :func:`bf16_attn_err`, bf16 only), of the lse (atol 1e-5), and of dq,
    dk, dv (:func:`bwd_tol`) from the backward on the kernel's own output
    and lse; ``repeat`` is 0 when two backward launches on the same inputs
    are bit-identical, else infinity; ``unseen`` is 0 when dk and dv are
    exactly zero at every key that no query may see (past the last
    query's diagonal, before the first one's window, past kv_len), else
    infinity.  Every ratio must be <= 1."""
    dt = q.dtype
    out, lse = attention.flash_attention_fwd(q, k, v, causal=causal,
                                             return_lse=True, **mask)
    got = attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                        causal=causal, **mask)
    again = attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=causal, **mask)
    want, want_lse = attention.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), causal=causal, return_lse=True,
        **mask)
    grads = attention.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        causal=causal, **mask)

    def err(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    ratios = {"max": err(out, want) / attn_tol(want, dt),
              "lse": err(lse, want_lse) / 1e-5}
    if dt == torch.bfloat16:
        ratios["element"] = bf16_attn_err(out, want)
    for name, a, b in zip(("dq", "dk", "dv"), got, grads):
        ratios[name] = err(a, b) / bwd_tol(b, dt)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ratios["repeat"] = 0.0 if same else math.inf
    unseen = ~attention.allowed(q.shape[1], k.shape[1], causal=causal,
                                device=q.device, **mask).any(0)
    ratios["unseen"] = 0.0 if not (got[1][:, unseen].any()
                                   or got[2][:, unseen].any()) else math.inf
    return ratios


def unit_rms(t: torch.Tensor) -> torch.Tensor:
    """``t`` times the power of two that brings its RMS nearest 1.  The
    product is exact in any float type, and dq, dk, dv are linear in dout,
    so a backward fed ``unit_rms(dout)`` gives its gradients times that
    power, exactly: what a gradient check sees at a scale where
    :func:`bwd_tol`'s ulp term, not its absolute floor, rules."""
    rms = float(t.float().pow(2).mean().sqrt())
    return t * 2.0 ** -round(math.log2(rms)) if rms > 0 else t


def bwd_tol(want: torch.Tensor, dtype) -> float:
    """Tolerance of the flash backward kernel against its plain version
    (fp32 on the same inputs), per output: the reference's gradient atol
    2e-4 for fp32 inputs; for bf16, one bf16 ulp at the output's largest
    magnitude plus that atol (where an output is near 0 the two fp32 sums
    differ by their own rounding before either rounds to bf16)."""
    if dtype == torch.float32:
        return 2e-4
    return 2.0 ** -7 * float(want.float().abs().max()) + 2e-4


#: stacked ``bulk_program`` cases (S, M, Nw, (Q, G, P, L), literals):
#: one, three and eight segments, ragged Nw, Q past grid.y's 65535, every
#: literal inverted, and queries of 512 literals over M = 500, past the
#: staged route's 351 rows (the gather route).  Shared by the card tests
#: and chip_smoke.py.
STACKED_CASES = (
    (1, 13, 1001, (8, 4, 2, 4), "mixed"),
    (3, 13, 1001, (8, 4, 2, 4), "mixed"),
    (8, 256, 4096, (16, 2, 1, 4), "mixed"),
    (8, 13, 33, (4, 2, 2, 8), "mixed"),
    (3, 5, 33, (65536, 1, 1, 1), "mixed"),
    (3, 13, 300, (4, 2, 2, 8), "all inverted"),
    (2, 500, 130, (4, 8, 2, 32), "mixed"),
)


def stacked_program_inputs(rng, s: int, m: int, nw: int, shape, literals):
    """numpy int32 inputs of a stacked ``bulk_program``: aug (S, M+1, Nw)
    with the all-ones identity row at M of every segment, record counts
    (S,) that cut each segment's tail at a different place (empty, ragged,
    full), and a random program over [0, M] (sels, invs, post)."""
    aug = rng.integers(0, 2 ** 32, (s, m + 1, nw), dtype=np.uint32)
    aug[:, m] = 0xFFFFFFFF
    cuts = [0, 1, 32 * nw - 5, 32 * nw, 32 * (nw // 2) + 7]
    nrecs = np.array([cuts[i % len(cuts)] if s > 1 else 32 * nw - 3
                      for i in range(s)], np.int32)
    sels = rng.integers(0, m + 1, shape).astype(np.int32)
    invs = (np.ones(shape, np.int32) if literals == "all inverted"
            else rng.integers(0, 2, shape).astype(np.int32))
    post = np.where(rng.random(shape[:3]) < 0.3, -1, 0).astype(np.int32)
    return aug.view(np.int32), nrecs, sels, invs, post


# The staged bulk_program route's constants and plan, mirrored from
# src/repro_torch/csrc/bitmap_ops.cu, which owns them.  The model test in
# tests/test_torch_bulk.py holds the schedule they give against the
# reference; the card tests and chip_smoke.py hold the mirror against the
# C entry's own plan (bulk_plan_route) and that route against the kernel
# the profiler sees launched.
BULK_THREADS, BULK_GATHER_WPT = 256, 4
BULK_STAGES, BULK_TW_LG, BULK_RING_BYTES = 2, 9, 88 << 10
BULK_DCAP = BULK_RING_BYTES // (BULK_STAGES * 32 * 4) - 1
BULK_HBITS, BULK_PROG_LITS, BULK_QCAP, BULK_QPI = 10, 4096, 1024, 4


def bulk_staged_plan(s: int, m: int, nw: int, q: int, gpl: int, ctas: int):
    """(chunk queries qc, chunks, strips) of the staged route for ``ctas``
    resident CTAs, or None when the bucket takes the gather route."""
    if gpl > BULK_PROG_LITS:
        return None
    cap = min(BULK_QCAP, BULK_PROG_LITS // gpl)
    tiles = -(-nw // (1 << BULK_TW_LG))
    chunks = -(-q // cap)
    if s * tiles * chunks < ctas:
        want = -(-ctas // (s * tiles))
        chunks = max(want, chunks) if want < q else q
    qc = -(-q // chunks)
    nchunks = -(-q // qc)
    nstrips = min(-(-ctas // (s * nchunks)), tiles)
    return (qc, nchunks, nstrips) if min(qc * gpl, m) <= BULK_DCAP else None


#: the kernel of each ``bulk_program`` route, as the profiler names it
BULK_KERNELS = {"staged": "bulk_staged_kernel",
                "gather": "bulk_gather_kernel"}


def bulk_routes_seen(fn, launches: int) -> dict:
    """Launches of each ``bulk_program`` route's kernel that the profiler
    sees over one call of ``fn`` on the card, which makes ``launches``
    launches: {"staged": n, "gather": n}.  The profiler can miss a
    session's first kernel, so a session starts with a marker kernel
    (``torch.cuda._sleep``'s); it now and then misses more, up to all of
    them: up to three calls, until it sees them all.  It never sees a
    launch that was not made, so a kernel seen was launched, while a count
    below ``launches`` shows nothing."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        seen = {route: sum(ev.count for ev in prof.key_averages()
                           if name in ev.key)
                for route, name in BULK_KERNELS.items()}
        if sum(seen.values()) >= launches:
            break
    return seen


def bulk_plan_route(s: int, m: int, nw: int, shape, *, stacked: bool,
                    counted: bool) -> str:
    """The route that ``bitmap_ops.bulk_program_plan`` gives for a bucket
    on the current card, after holding the mirror :func:`bulk_staged_plan`
    (at the resident CTAs the C entry plans for) against its schedule."""
    from repro_torch.kernels import bitmap_ops
    plan = bitmap_ops.bulk_program_plan(s, m, nw, shape, stacked=stacked,
                                        counted=counted)
    q, g, p, l = shape
    mirror = bulk_staged_plan(s if stacked else 1, m, nw, q, g * p * l,
                              plan["ctas"])
    want = ((plan["qc"], plan["chunks"], plan["strips"])
            if plan["route"] == "staged" else None)
    if mirror != want:
        raise AssertionError(f"bulk_staged_plan {mirror} disagrees with the "
                             f"C entry's plan {plan} at S={s} M={m} Nw={nw} "
                             f"{tuple(shape)}")
    return plan["route"]


def bulk_staged_route(s: int, m: int, nw: int, shape, ctas: int) -> str:
    """The route a bucket of program shape (Q, G, P, L) takes."""
    q, g, p, l = shape
    return ("staged" if bulk_staged_plan(s, m, nw, q, g * p * l, ctas)
            else "gather")


def bulk_tile_words(d: int, nw: int) -> int:
    """The staged route's tile width for ``d`` distinct rows (a stage holds
    them and an all-ones row)."""
    lg = BULK_TW_LG
    while lg > 5 and BULK_STAGES * (d + 1) * (4 << lg) > BULK_RING_BYTES:
        lg -= 1
    while lg > 5 and (1 << (lg - 1)) >= nw:
        lg -= 1
    return 1 << lg


def bulk_counted_inputs(rng, m: int, nw: int, shape, literals="mixed"):
    """numpy int32 inputs of a 2-D ``bulk_program``: aug (M+1, Nw) with the
    all-ones identity row at M and a random program over [0, M] (sels,
    invs, post).  ``literals``: "mixed" inversions, "all inverted", or
    "every row" (mixed, and every row of aug selected at least once)."""
    aug = rng.integers(0, 2 ** 32, (m + 1, nw), dtype=np.uint32)
    aug[m] = 0xFFFFFFFF
    if literals == "every row":
        size = int(np.prod(shape))
        assert size >= m + 1
        sels = rng.permutation(np.resize(np.arange(m + 1), size))
        sels = sels.reshape(shape).astype(np.int32)
    else:
        sels = rng.integers(0, m + 1, shape).astype(np.int32)
    invs = (np.ones(shape, np.int32) if literals == "all inverted"
            else rng.integers(0, 2, shape).astype(np.int32))
    post = np.where(rng.random(shape[:3]) < 0.3, -1, 0).astype(np.int32)
    return aug.view(np.int32), sels, invs, post


#: counted ``bulk_program`` cases (M, Nw, (Q, G, P, L), literals): the 2-D
#: card cases, Nw % 4 != 0, Q past grid.y's 65535, every literal inverted,
#: and M = 4096 with every row selected by queries of 4096 literals, past
#: the staged route's 351 rows (the gather route).  Shared by the card
#: tests and chip_smoke.py.
COUNTED_CASES = (
    (13, 1001, (8, 4, 2, 4), "mixed"),
    (256, 4096, (16, 2, 1, 4), "mixed"),
    (5, 33, (65536, 1, 1, 1), "mixed"),
    (13, 300, (2, 128, 1, 64), "mixed"),
    (13, 1002, (4, 2, 2, 8), "all inverted"),
    (4096, 129, (2, 32, 1, 128), "every row"),
)


def record_cuts(nw: int) -> tuple:
    """Record counts that cut a row of ``nw`` words: none, one record, 5
    short of full, full, and mid-word."""
    return (0, 1, 32 * nw - 5, 32 * nw, 16 * nw + 7)


#: how ``materialize`` fills a dry-run step's arguments, by kind: the
#: parameters and a batch's floats normal, AdamW's moments and the decode
#: cache zero
STEP_FILLS = {"train": ("normal", "zeros", "normal"),
              "prefill": ("normal", "normal"),
              "decode": ("normal", {"tokens": "normal", "cache": "zeros"})}


def materialize(tree, dev, gen, vocab: int, fill):
    """Real tensors on ``dev`` in the shapes and dtypes of ``tree``'s meta
    leaves (a dry run's arguments): token ids uniform below ``vocab``,
    floats standard normal x 0.02 from ``gen`` where ``fill`` is "normal",
    zero where it is "zeros" (``fill`` a dict: per key of ``tree``)."""
    if isinstance(tree, dict):
        return {k: materialize(v, dev, gen, vocab,
                               fill[k] if isinstance(fill, dict) else fill)
                for k, v in tree.items()}
    if not tree.is_floating_point():
        return torch.randint(0, vocab, tuple(tree.shape), generator=gen,
                             device=dev, dtype=tree.dtype)
    if fill == "zeros":
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    return torch.randn(tuple(tree.shape), generator=gen, device=dev,
                       dtype=torch.float32).mul_(0.02).to(tree.dtype)


#: row 5c: Command-R+-104B's prefill attention (4 x 2048, 128-wide heads,
#: causal, bf16), label -> (query heads, KV heads): the whole model's, and
#: one rank's quarter on a (1, 4) mesh under TP
COMMAND_R_FLASH_SHAPES = {"command-r+": (96, 8),
                          "command-r+ (1, 4) rank": (24, 2)}
