"""Inputs and tolerances shared by the port's kernel tests and
``chip_smoke.py``.  numpy and torch only (no JAX), so the card's tests and
the smoke script import it too.
"""
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
