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
#: tensor-core kernels tile 128 queries or keys a CTA and 64 a step), both
#: head dims, no GQA and Qwen2-7B's 7 query heads a KV head.  Shared by the
#: card tests and chip_smoke.py.
FLASH_BWD_CASES = tuple(itertools.product(
    (1, 63, 200, 1000, 2048), (64, 128), (1, 7), (True, False),
    (torch.float32, torch.bfloat16)))


def flash_bwd_inputs(rng, s: int, hd: int, g: int, dtype, dev, *,
                     batch: int = 2, kv: int = 2):
    """q, k, v, dout of a :data:`FLASH_BWD_CASES` case: ``batch`` (2)
    sequences, ``kv`` (2) KV heads and ``kv`` g query heads, standard
    normal."""
    def one(heads):
        return torch.from_numpy(rng.standard_normal((batch, s, heads, hd))
                                .astype(np.float32)).to(dev, dtype)
    return one(kv * g), one(kv), one(kv), one(kv * g)


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
#: one, three and eight segments, ragged Nw, Q past grid.y's 65535, and
#: every literal inverted.  Shared by the card tests and chip_smoke.py.
STACKED_CASES = (
    (1, 13, 1001, (8, 4, 2, 4), "mixed"),
    (3, 13, 1001, (8, 4, 2, 4), "mixed"),
    (8, 256, 4096, (16, 2, 1, 4), "mixed"),
    (8, 13, 33, (4, 2, 2, 8), "mixed"),
    (3, 5, 33, (65536, 1, 1, 1), "mixed"),
    (3, 13, 300, (4, 2, 2, 8), "all inverted"),
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
