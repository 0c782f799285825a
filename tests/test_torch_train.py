"""The port's training slice against the JAX package, on the CPU.

Flash attention's gradient (``flash_attention_vjp``), the fused CE loss,
``lm_loss`` with every parameter's gradient, the AdamW update, the train
step, gradient accumulation, checkpoints (across packages both ways) and
restart, the launcher and the example, on the same seeded numpy inputs and
weights carried across with ``params_from_numpy``.  Tolerances:

* flash attention: the forward at 2e-3 and the gradients at atol 2e-4, the
  reference's own test (``tests/test_models.py``, naive against flash);
* the fused CE loss at fp32: the loss rtol 1e-6, dx and dhead atol 1e-7
  (the same products in the same chunks; only summation order differs);
  at bf16 the loss rtol 1e-5, dx and dhead within one bf16 ulp plus 1e-6
  of their largest magnitude, at most 1% of the elements differing;
* ``lm_loss`` at fp32: the loss rtol 1e-5, each gradient within 1e-4 of
  its largest magnitude plus 1e-7 (as the model logits test: two packages
  sum the same products in other orders through every layer);
* AdamW: parameters rtol 1e-6 (fp32 rounding of the same operations in
  the same order; ``pow`` and ``cos`` may differ in the last place); the
  moments rtol 1e-6 plus 1e-6 of their largest magnitude (b1 m + (1 - b1) g
  can cancel, so near 0 only an absolute bound means anything), bf16
  moments within one bf16 ulp more;
* two train steps: the loss and grad norm rtol 1e-5, the moments within
  1e-4 of their largest magnitude, the parameters within 4 lr (the first
  step's Adam update is g / |g| per element, so a gradient element near 0
  whose sign differs between the packages moves by 2 lr).

Restart on the CPU is bit-identical, as the reference's test requires.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import loss as jloss  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.shapes import demo_batch  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import loss as tloss  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from torch_checks import bf16_spacing  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DENSE = ["qwen2_7b", "granite_20b", "command_r_plus_104b"]
#: the encoder-decoder, MoE, SSM and hybrid families
FAMILIES = ["whisper_small", "qwen2_moe_a2_7b", "granite_moe_3b_a800m",
            "mamba2_2_7b", "hymba_1_5b"]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def close(got: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def scaled_tol(want, frac: float, floor: float) -> float:
    return frac * float(np.abs(np.asarray(want, np.float32)).max()) + floor


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)


def _reference_params(cfg, seed: int) -> dict:
    """The JAX init with random norm scales and biases (not zeros), numpy."""
    params = {k: np.asarray(v) for k, v in
              jmodel.init_params(cfg, jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    for name in params:
        if name in tmodel.NORM_KEYS or name in ("bq", "bk", "bv"):
            params[name] = (rng.standard_normal(params[name].shape) * 0.3
                            ).astype(np.float32)
    return params


def _train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """Tokens, labels (three masked) and, for an encoder-decoder, frames
    (standard normal x 0.02, the reference's ``demo_batch``)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :3] = -1                                   # masked positions
    out = {"tokens": tokens, "labels": labels}
    if cfg.enc_dec:
        out["frames"] = (rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


# ------------------------------------------------------ flash attention
@pytest.mark.parametrize("causal,block_skip", [(True, False), (True, True),
                                               (False, False)])
def test_flash_attention_vjp_matches_reference_grad(causal, block_skip):
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 2, 150, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))

    def jf(q, k, v):
        return (jflash.flash_attention_vjp(
            q, k, v, causal=causal, q_chunk=64, kv_chunk=48,
            block_skip=block_skip) ** 2).sum()

    want, jgrads = jax.value_and_grad(jf, (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    got = (tflash.flash_attention_vjp(tq, tk, tv, causal=causal,
                                      q_chunk=64, kv_chunk=48,
                                      block_skip=block_skip) ** 2).sum()
    got.backward()
    assert abs(float(got.detach()) - float(want)) < 2e-3
    for mine, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
        close(mine, ref, 2e-4)


def test_flash_attention_vjp_options_raise():
    """block_skip needs causal, as in the reference; the mask arguments run
    (``tests/test_torch_window_vlm.py``), and a window below 1 or a
    negative q_offset are refused."""
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="block_skip"):
        tflash.flash_attention_vjp(q, q, q, causal=False, block_skip=True)
    for kw in ({"window": 0}, {"q_offset": -1}):
        with pytest.raises(ValueError, match="flash_attention_fwd"):
            tflash.flash_attention_vjp(q, q, q, causal=True, **kw)


def test_flash_backward_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the backward wrapper runs its plain version and counts
    no launch; the forward's lse is the plain logsumexp."""
    from repro_torch.kernels import attention
    rng = np.random.default_rng(4)
    q = t(rng.standard_normal((2, 33, 6, 8)).astype(np.float32))
    k, v = (t(rng.standard_normal((2, 33, 2, 8)).astype(np.float32))
            for _ in range(2))
    before = attention.flash_attention_bwd.launches
    out, lse = attention.flash_attention_fwd(q, k, v, causal=True,
                                             return_lse=True)
    assert lse.shape == (2, 6, 33) and lse.dtype == torch.float32
    dout = torch.ones_like(out)
    got = attention.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    want = attention.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert attention.flash_attention_bwd.launches == before
    with pytest.raises(ValueError, match="flash_attention_bwd"):
        attention.flash_attention_bwd(q, k, v, out, lse[:, :3], dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_rms_dout_scales_the_gradients_exactly(dtype):
    """The card's layer check feeds the backward ``unit_rms(dout)``, the
    step's small dout times a power of two: the gradients are the ones of
    dout times that power, bit for bit, so the check holds the step's own
    gradients at a scale where ``bwd_tol``'s ulp term rules."""
    from repro_torch.kernels import attention
    from torch_checks import unit_rms
    rng = np.random.default_rng(5)
    q = t(rng.standard_normal((2, 40, 4, 16)).astype(np.float32)).to(dtype)
    k, v = (t(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
            .to(dtype) for _ in range(2))
    dout = t(1e-5 * rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
             ).to(dtype)
    out, lse = attention.flash_attention_fwd(q, k, v, causal=True,
                                             return_lse=True)
    unit = unit_rms(dout)
    scale = float(unit.float().abs().max() / dout.float().abs().max())
    assert scale == 2.0 ** round(np.log2(scale)) and scale > 1e4
    assert 0.5 < float(unit.float().pow(2).mean().sqrt()) < 2
    small = attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=True)
    big = attention.flash_attention_bwd(q, k, v, out, lse, unit, causal=True)
    for a, b in zip(small, big):
        assert b.dtype == dtype and torch.equal(b, a * scale)


# ------------------------------------------------------- fused CE loss
@pytest.mark.parametrize("chunk", [5, 1024])
def test_fused_ce_loss_matches_reference(chunk):
    """A padded vocab (200 of 256) and masked labels, fp32."""
    rng = np.random.default_rng(chunk)
    B, S, d, Vp, V = 2, 13, 16, 256, 200
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    head = (rng.standard_normal((d, Vp)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.3] = -1

    def jf(x, head):
        return jloss.fused_ce_loss(x, head, jnp.asarray(labels),
                                   valid_vocab=V, chunk=chunk)

    (jl, jcnt), jvjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(head))
    jdx, jdh = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    tx, th = t(x).requires_grad_(), t(head).requires_grad_()
    loss, cnt = tloss.fused_ce_loss(tx, th, t(labels), valid_vocab=V,
                                    chunk=chunk)
    loss.backward()
    assert float(cnt) == float(jcnt) == float((labels >= 0).sum())
    close(loss, jl, 0.0, rtol=1e-6)
    close(tx.grad, jdx, 1e-7)
    close(th.grad, jdh, 1e-7)


def test_fused_ce_loss_bf16_forward_matches_reference():
    """bf16 operands: the logits are fp32 products of the widened bf16
    values in both packages, so the loss agrees to fp32 rounding."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    head = (rng.standard_normal((32, 512)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 500, (2, 9)).astype(np.int32)
    jl, _ = jloss.fused_ce_loss(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(head, jnp.bfloat16),
                                jnp.asarray(labels), valid_vocab=500, chunk=4)
    tl, _ = tloss.fused_ce_loss(t(x).bfloat16(), t(head).bfloat16(),
                                t(labels), valid_vocab=500, chunk=4)
    close(tl, jl, 0.0, rtol=1e-5)


def test_fused_ce_loss_bf16_backward_matches_reference():
    """bf16 operands: both packages form dlogits in fp32 and multiply it
    against the widened bf16 head and x, then round dx and dhead to bf16
    once, so the two agree element by element but where their fp32 sums
    (other summation orders) straddle a bf16 rounding boundary: within one
    bf16 ulp plus 1e-6 of the largest magnitude (near-cancelling sums), and
    differing on at most 1% of the elements.  Rounding dlogits to bf16
    before the products moves about a fifth of dx and a third of dhead."""
    rng = np.random.default_rng(11)
    B, S, d, Vp, V = 2, 16, 64, 1024, 1000
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    head = (rng.standard_normal((d, Vp)) * 0.2).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1

    def jf(x, head):
        return jloss.fused_ce_loss(x, head, jnp.asarray(labels),
                                   valid_vocab=V, chunk=8)

    _, jvjp = jax.vjp(jf, jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(head, jnp.bfloat16))
    jdx, jdh = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    tx = t(x).bfloat16().requires_grad_()
    th = t(head).bfloat16().requires_grad_()
    loss, _ = tloss.fused_ce_loss(tx, th, t(labels), valid_vocab=V, chunk=8)
    loss.backward()
    for got, want in ((tx.grad, jdx), (th.grad, jdh)):
        assert got.dtype == torch.bfloat16
        want = t(np.asarray(want.astype(jnp.float32)))
        diff = (got.float() - want).abs()
        slack = 1e-6 * float(want.abs().max())
        assert bool((diff <= bf16_spacing(want) + slack).all())
        assert float((diff > 0).float().mean()) <= 0.01


# ------------------------------------------------------------ lm_loss
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_lm_loss_and_grads_match_reference_fp32(fp32, arch, remat):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    jcfg = dataclasses.replace(jget_smoke(arch), remat=remat)
    params = _reference_params(jcfg, 3)
    batch = _train_batch(cfg, 2, 12, 5)
    (jl, jaux), jgrads = jax.value_and_grad(jmodel.lm_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    model.requires_grad_(True)
    loss, aux = tmodel.lm_loss(model, cfg, {k: t(v) for k, v in batch.items()})
    loss.backward()
    close(loss, jl, 0.0, rtol=1e-5)
    assert float(aux["tokens"]) == float(jaux["tokens"]) == 21
    # a parameter the config never reads (parallel_block's ln2) gets no
    # grad here and a zero one from jax.grad
    grads = tmodel.stack_layers(cfg, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        close(g, jgrads[name], scaled_tol(jgrads[name], 1e-4, 1e-7))


def test_model_helpers_keep_the_reference_layout():
    cfg = get_smoke_config("qwen2_7b")
    params = _reference_params(jget_smoke("qwen2_7b"), 2)
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    back = tmodel.params_to_numpy(model)
    assert set(back) == set(params)
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr)
    abstract = tmodel.abstract_params(cfg)
    jabstract = jmodel.abstract_params(jget_smoke("qwen2_7b"))
    assert {k: (tuple(v.shape), v.device.type) for k, v in abstract.items()} \
        == {k: (tuple(v.shape), "meta") for k, v in jabstract.items()}
    assert tmodel.param_logical(cfg) == jmodel.param_logical(
        jget_smoke("qwen2_7b"))


def test_train_mode_runs_and_returns_logits():
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = demo_batch(cfg, "train", 2, 8, torch.Generator().manual_seed(1))
    assert torch.equal(batch["labels"], torch.roll(batch["tokens"], -1, 1))
    logits, cache = tmodel.model_forward(model, cfg, batch["tokens"],
                                         mode="train")
    assert cache is None and logits.shape == (2, 8, cfg.vocab_padded)
    with pytest.raises(ValueError, match="mode"):
        tmodel.model_forward(model, cfg, batch["tokens"], mode="eval")


# -------------------------------------------------------------- AdamW
def test_learning_rate_matches_reference():
    o = jadamw.OptimConfig(warmup_steps=10, decay_steps=100)
    steps = np.arange(0, 130, 7, dtype=np.int32)
    want = jadamw.learning_rate(o, jnp.asarray(steps))
    got = tadamw.learning_rate(tadamw.OptimConfig(warmup_steps=10,
                                                  decay_steps=100),
                               t(steps))
    close(got, want, 0.0, rtol=1e-6)


def _adam_inputs(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (33,), "w": (4, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("moments,compression", [
    ("float32", "none"), ("bfloat16", "none"), ("float32", "int8")])
def test_apply_updates_matches_reference(moments, compression):
    kw = dict(peak_lr=1e-2, warmup_steps=1, clip_norm=0.5,
              moment_dtype=moments, grad_compression=compression)
    jo, to = jadamw.OptimConfig(**kw), tadamw.OptimConfig(**kw)
    params, grads = _adam_inputs(1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.init_opt_state(jp, jo)
    tp = {k: t(v) for k, v in params.items()}
    ts = tadamw.init_opt_state(tp, to)
    for g in grads:
        jp, js, jm = jadamw.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jo)
        tp, ts, tm = tadamw.apply_updates(tp, {k: t(v) for k, v in g.items()},
                                          ts, to)
    assert int(ts["step"]) == int(js["step"]) == 2
    close(tm["grad_norm"], jm["grad_norm"], 0.0, rtol=1e-6)
    close(tm["lr"], jm["lr"], 0.0, rtol=1e-6)
    for k in params:
        close(tp[k], jp[k], 1e-7, rtol=1e-6)
        for mom in ("m", "v"):
            want = np.asarray(js[mom][k], np.float32)
            got = ts[mom][k]
            assert got.dtype == getattr(torch, moments)
            ulp = (2.0 ** -7 if moments == "bfloat16" else 1e-6)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=ulp,
                                       atol=scaled_tol(want, 1e-6, 0.0))


def test_opt_state_shapes():
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, device="cpu", dtype=torch.float32)
    o = tadamw.OptimConfig(moment_dtype="bfloat16")
    state = tadamw.init_opt_state(model, o)
    abstract = tadamw.abstract_opt_state(model, o)
    for mom in ("m", "v"):
        assert {k: (v.shape, v.dtype) for k, v in state[mom].items()} == {
            k: (v.shape, v.dtype) for k, v in abstract[mom].items()}
        assert all(v.dtype == torch.bfloat16 for v in state[mom].values())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


# --------------------------------------------------------- train step
def test_train_step_matches_reference_two_steps(fp32):
    cfg, jcfg = get_smoke_config("qwen2_7b"), jget_smoke("qwen2_7b")
    params = _reference_params(jcfg, 6)
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
    jstep_fn = jstep.make_train_step(
        jcfg, jstep.TrainConfig(jadamw.OptimConfig(**kw)))
    tstep_fn = tstep.make_train_step(
        cfg, tstep.TrainConfig(tadamw.OptimConfig(**kw)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.init_opt_state(jp, jadamw.OptimConfig(**kw))
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    ts = tadamw.init_opt_state(model, tadamw.OptimConfig(**kw))
    lr_max = 0.0
    for i in range(2):
        batch = _train_batch(cfg, 2, 16, 10 + i)
        jp, js, jm = jstep_fn(jp, js, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        model, ts, tm = tstep_fn(model, ts, {k: t(v) for k, v in
                                             batch.items()})
        for name in ("loss", "grad_norm", "lr"):
            close(tm[name], jm[name], 0.0, rtol=1e-5)
        lr_max = max(lr_max, float(jm["lr"]))
    got = tmodel.params_to_numpy(model)
    for name in params:
        close(t(got[name]), jp[name], 4 * lr_max)
        for mom in ("m", "v"):
            mine = tmodel.stack_layers(cfg, ts[mom])[name]
            close(mine, js[mom][name], scaled_tol(js[mom][name], 1e-4, 0.0))


@pytest.mark.parametrize("arch", ["qwen2_7b", "granite_moe_3b_a800m"])
def test_accum_one_matches_accum_four(arch):
    """The reference's accumulation test (``tests/test_system.py``, on its
    MoE smoke config), here on the MoE's and on qwen2_7b's: the same batch
    of 8 x 16, the same bounds (loss within 2e-2, parameters within
    3e-4)."""
    cfg = get_smoke_config(arch)
    batch = demo_batch(cfg, "train", 8, 16, torch.Generator().manual_seed(0))
    o = tadamw.OptimConfig(peak_lr=1e-3)
    out = {}
    for n in (1, 4):
        model = tmodel.init_params(cfg, seed=0, device="cpu",
                                   dtype=torch.float32)
        step = tstep.make_train_step(cfg, tstep.TrainConfig(o, accum_steps=n))
        model, _, m = step(model, tadamw.init_opt_state(model, o), batch)
        out[n] = (float(m["loss"]), tmodel.params_to_numpy(model))
    assert abs(out[1][0] - out[4][0]) < 2e-2
    for name, arr in out[1][1].items():
        np.testing.assert_allclose(out[4][1][name], arr, atol=3e-4)


def test_microbatch_is_the_strided_slice():
    batch = {"tokens": torch.arange(8 * 3).view(8, 3),
             "labels": torch.arange(8 * 3).view(8, 3)}
    mb = tstep.microbatch(batch, 1, 4)
    assert torch.equal(mb["tokens"], batch["tokens"][1::4])


@pytest.mark.parametrize("optim,drop", [
    ({}, 0.5),
    ({"grad_compression": "int8", "moment_dtype": "bfloat16"}, 0.3)])
def test_loss_falls_over_8_steps(optim, drop):
    """The reference's two learning tests: a fixed batch memorized, plain
    and with int8 gradients and bf16 moments."""
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    o = tadamw.OptimConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=50,
                           **optim)
    opt = tadamw.init_opt_state(model, o)
    step = tstep.make_train_step(cfg, tstep.TrainConfig(o))
    batch = demo_batch(cfg, "train", 4, 32, torch.Generator().manual_seed(0))
    losses = []
    for _ in range(8):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - drop


# -------------------------------------------------------- checkpoints
def _model_and_opt(cfg, seed: int, moments: str = "float32"):
    model = tmodel.init_params(cfg, seed=seed, device="cpu",
                               dtype=torch.float32)
    o = tadamw.OptimConfig(moment_dtype=moments)
    opt = tadamw.init_opt_state(model, o)
    rng = np.random.default_rng(seed)
    for mom in ("m", "v"):
        for v in opt[mom].values():
            v.copy_(t(rng.standard_normal(tuple(v.shape))
                      .astype(np.float32)))
    opt["step"] = torch.tensor(5, dtype=torch.int32)
    return model, opt


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_smoke_config("granite_20b")
    model, opt = _model_and_opt(cfg, 1, "bfloat16")
    state = tloop.checkpoint_state(model, opt)
    state["data_step"] = torch.tensor(17)
    tckpt.save_checkpoint(str(tmp_path), 17, state)
    restored, step = tckpt.restore_checkpoint(str(tmp_path), state)
    assert step == 17 and int(restored["data_step"]) == 17
    for name, want in state["params"].items():
        assert torch.equal(restored["params"][name], want)
    for name, want in state["opt"]["m"].items():
        got = restored["opt"]["m"][name]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_written_by_the_port_restores_in_the_reference(
        tmp_path, moments):
    cfg, jcfg = get_smoke_config("qwen2_7b"), jget_smoke("qwen2_7b")
    model, opt = _model_and_opt(cfg, 2, moments)
    tckpt.save_checkpoint(str(tmp_path), 3,
                          tloop.checkpoint_state(model, opt))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jadamw.init_opt_state(jparams,
                                 jadamw.OptimConfig(moment_dtype=moments))
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jparams, "opt": jopt})
    restored, step = jckpt.restore_checkpoint(str(tmp_path), like)
    # the reference stores a scalar as shape (1,) and restores it so
    assert step == 3 and np.asarray(restored["opt"]["step"]).item() == 5
    want = tmodel.params_to_numpy(model)
    for name, arr in want.items():
        np.testing.assert_array_equal(np.asarray(restored["params"][name]),
                                      arr)
        got_m = np.asarray(restored["opt"]["m"][name])
        assert str(got_m.dtype) == moments
        mine = tmodel.stack_layers(cfg, opt["m"])[name].float().numpy()
        np.testing.assert_array_equal(got_m.astype(np.float32), mine)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_written_by_the_reference_restores_in_the_port(
        tmp_path, moments):
    cfg, jcfg = get_smoke_config("qwen2_7b"), jget_smoke("qwen2_7b")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    jopt = jadamw.init_opt_state(jparams,
                                 jadamw.OptimConfig(moment_dtype=moments))
    rng = np.random.default_rng(4)
    jopt["m"] = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                 for k, v in jopt["m"].items()}
    jckpt.save_checkpoint(str(tmp_path), 9, {"params": jparams, "opt": jopt})
    model, opt = _model_and_opt(cfg, 0, moments)
    restored, step = tckpt.restore_checkpoint(
        str(tmp_path), tloop.checkpoint_state(model, opt))
    tloop.load_checkpoint_state(model, opt, restored)
    assert step == 9 and int(opt["step"]) == 0
    got = tmodel.params_to_numpy(model)
    for name, arr in jparams.items():
        np.testing.assert_array_equal(got[name], np.asarray(arr))
        mine = tmodel.stack_layers(cfg, opt["m"])[name]
        assert mine.dtype == getattr(torch, moments)
        np.testing.assert_array_equal(
            mine.float().numpy(), np.asarray(jopt["m"][name], np.float32))


def test_checkpoint_manager_cadence_retention(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), every_steps=2, keep=2,
                                  async_save=False)
    state = {"x": torch.arange(4)}
    for s in range(1, 9):
        mgr.maybe_save(s, state)
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step-"))
    assert steps == [6, 8]


def test_checkpoint_manager_async_builds_state_only_when_due(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), every_steps=3)
    built = []

    def state():
        built.append(1)
        return {"x": torch.arange(3)}
    for s in range(1, 7):
        mgr.maybe_save(s, state)
    mgr.wait()
    assert len(built) == 2 and tckpt.latest_step(str(tmp_path)) == 6


def test_checkpoint_atomicity(tmp_path):
    """A leftover tmp dir (crash mid-save) must not corrupt restore."""
    state = {"x": torch.arange(3, dtype=torch.int32)}
    tckpt.save_checkpoint(str(tmp_path), 1, state)
    os.makedirs(tmp_path / "tmp-2")          # simulated crashed save
    assert tckpt.latest_step(str(tmp_path)) == 1
    restored, step = tckpt.restore_checkpoint(str(tmp_path), state)
    assert step == 1 and torch.equal(restored["x"], state["x"])


def _run_loop(cfg, ckpt_dir: str, total: int, ckpt_every: int):
    data = [demo_batch(cfg, "train", 2, 16, torch.Generator().manual_seed(i))
            for i in range(total)]
    o = tadamw.OptimConfig(peak_lr=1e-3, warmup_steps=2)
    return tloop.train_loop(
        cfg, tstep.TrainConfig(o),
        tloop.LoopConfig(total_steps=total, ckpt_dir=ckpt_dir,
                         ckpt_every=ckpt_every, log_every=1),
        lambda start: iter(data[start:]), seed=3, log=lambda s: None,
        device="cpu")


def test_restart_resumes_training_bitexact(tmp_path):
    """Kill-and-restart: train 4 steps; against train 2, checkpoint, restart
    in a fresh model from that checkpoint, train 2 more — identical
    parameters and moments."""
    cfg = get_smoke_config("qwen2_7b")
    full = _run_loop(cfg, str(tmp_path / "a"), 4, 2)
    _run_loop(cfg, str(tmp_path / "b"), 2, 2)
    assert tckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = _run_loop(cfg, str(tmp_path / "b"), 4, 2)
    for (name, p), q in zip(full["params"].named_parameters(),
                            resumed["params"].parameters()):
        assert torch.equal(p, q), name
    for mom in ("m", "v"):
        for name, v in full["opt"][mom].items():
            assert torch.equal(v, resumed["opt"][mom][name]), name
    assert int(resumed["opt"]["step"]) == 4


# ------------------------------------------------- launcher and example
def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import train
    cfg = get_smoke_config("qwen2_7b")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tloop.train_loop(cfg, tstep.TrainConfig(), tloop.LoopConfig(
            total_steps=1, ckpt_dir=str(tmp_path)), lambda start: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train.main(["--demo", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_launch_train_demo_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--demo", "--device", "cpu", "--steps", "3", "--seq", "16",
                "--global-batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "qwen2-7b-smoke on cpu: final loss" in out
    assert tckpt.latest_step(str(tmp_path)) == 3


def test_train_lm_torch_example_imports_no_jax(tmp_path):
    """``examples/train_lm_torch.py --device cpu`` in a fresh interpreter:
    it trains, checkpoints, and never imports ``jax`` or ``repro``."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train_lm_torch.py', '--device', 'cpu', '--steps', "
        f"'3', '--batch', '2', '--seq', '16', '--ckpt', {str(tmp_path)!r}]\n"
        "runpy.run_path('examples/train_lm_torch.py', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    # one intra-op thread, as in this process (the example's steps are
    # tiny: torch's default pool spends more CPU than it saves)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
    assert "bitmap query selected" in out.stdout
    assert "done: final loss" in out.stdout
    assert tckpt.latest_step(str(tmp_path)) == 3
