"""Sliding-window and offset attention, M-RoPE, the per-layer global flags
and the VLM prefix of the port against the JAX package, on the CPU.

(a) The plain flash forward, its lse and its gradients against
``repro.models.flash.flash_attention_vjp`` (and its ``_fwd_impl`` for the
lse) under windows, ``q_offset`` with Sq < Skv, ``kv_len`` < Skv, causal
and full, with chunk sizes that split the window: the forward and lse at
atol 2e-5 (the reference kernel test's), the gradients at 2e-4 (the
reference's gradient test).  A row that sees no key is a difference by
design: the port writes zeros and an lse of NEG_INF, the reference averages
V over its padded chunk; such rows are kept out of the comparison, and a
test shows they exist and differ.  (b) M-RoPE angles bit for bit.  (c)
``global_flags`` for every config.  (d) prefill, decode and greedy
generation of the Gemma3 and Qwen2-VL smoke configs at the tolerances of
``tests/test_torch_models.py`` (fp32 logits 1e-4 of their largest
magnitude plus 1e-5, bf16 1/32 plus 1e-3; the fp32 KV cache 1e-4); the
bf16 KV cache within 1/64 of its largest magnitude plus 1e-3: Gemma3's
qk-norm leaves keys of magnitude ~4, where one bf16 ulp is 0.016 and the
packages' roundings, six layers deep, differ by up to 1/116 of it.
(e) ``lm_loss`` and every gradient of both at fp32, at the tolerances of
``tests/test_torch_train.py`` (the loss rtol 1e-5, each gradient within
1e-4 of its largest magnitude plus 1e-7).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import attention as tattention  # noqa: E402
from repro_torch.launch.shapes import demo_batch  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from repro_torch.train.step import TrainConfig, make_train_step  # noqa: E402
from torch_checks import grid_positions  # noqa: E402


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


# ------------------------------------------- (a) windowed flash attention
#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset, kv_len, q_chunk,
#: kv_chunk, block_skip)
MASK_CASES = [
    (2, 40, 40, 4, 2, 16, True, 1, 0, None, 16, 8, False),
    (2, 40, 40, 4, 2, 16, True, 5, 0, None, 16, 8, False),
    (2, 40, 40, 4, 2, 16, True, 17, 0, None, 16, 8, True),
    (2, 48, 48, 4, 4, 8, True, 17, 0, None, 12, 12, False),
    (2, 16, 60, 4, 2, 16, True, 17, 44, None, 8, 16, False),
    (2, 16, 60, 4, 2, 16, True, None, 44, None, 8, 16, False),
    (2, 40, 40, 4, 2, 16, True, None, 0, 30, 16, 8, False),
    (2, 40, 40, 4, 2, 16, False, None, 0, 30, 16, 8, False),
    (2, 20, 50, 4, 4, 8, False, None, 0, None, 8, 16, False),
    (1, 16, 60, 6, 2, 16, True, 5, 30, 50, 8, 16, False),
]


def _mask_inputs(seed, B, Sq, Skv, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _both_routes(case, seed: int):
    """(port out, lse, grads), (reference out, lse, grads) and the rows
    that see a key, for the loss sum(out^2) over those rows."""
    B, Sq, Skv, H, KV, hd, causal, window, qo, kl, qc, kc, skip = case
    q, k, v = _mask_inputs(seed, B, Sq, Skv, H, KV, hd)
    mask = {"window": window, "q_offset": qo, "kv_len": kl}
    seen = tattention.allowed(Sq, Skv, causal=causal, **mask).any(-1).numpy()

    def jf(q, k, v):
        out = jflash.flash_attention_vjp(q, k, v, causal=causal, q_chunk=qc,
                                         kv_chunk=kc, block_skip=skip, **mask)
        return (out[:, seen] ** 2).sum(), out
    (_, jout), jgrads = jax.value_and_grad(jf, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    w = jflash.WINDOW_INF if window is None else jnp.int32(window)
    _, jlse = jflash._fwd_impl(min(qc, Sq), min(kc, Skv), causal,
                               jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), w, jnp.int32(qo),
                               jnp.int32(Skv if kl is None else kl))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention_vjp(tq, tk, tv, causal=causal, q_chunk=qc,
                                     kv_chunk=kc, block_skip=skip, **mask)
    (out[:, torch.from_numpy(seen)] ** 2).sum().backward()
    _, lse = tattention.flash_attention_fwd(t(q), t(k), t(v), causal=causal,
                                            return_lse=True, **mask)
    lse = lse.reshape(B, KV, H // KV, Sq)
    return ((out.detach(), lse, (tq.grad, tk.grad, tv.grad)),
            (jout, jlse, jgrads), seen)


@pytest.mark.parametrize("case", MASK_CASES)
def test_plain_flash_matches_reference_vjp(case):
    """Forward, lse and gradients of the port's plain route (a CPU tensor
    takes the plain versions) against the reference's custom VJP."""
    (out, lse, grads), (jout, jlse, jgrads), seen = _both_routes(case, 7)
    close(out[:, seen], np.asarray(jout)[:, seen], 2e-5)
    close(lse[..., seen], np.asarray(jlse)[..., seen], 2e-5)
    for mine, ref in zip(grads, jgrads):
        close(mine, ref, 2e-4)


def test_rows_that_see_no_key_are_kept_out_and_differ():
    """Queries 14 and 15 of this case see no key (q + 30 - 5 >= kv_len
    40): the port writes zeros and an lse of NEG_INF, the reference a
    mean of V over its chunk; every other row agrees (the test above), and
    the gradients agree everywhere (p is 0 on such a row in both)."""
    case = (2, 16, 60, 4, 2, 16, True, 5, 30, 40, 8, 16, False)
    (out, lse, grads), (jout, jlse, jgrads), seen = _both_routes(case, 3)
    assert list(np.flatnonzero(~seen)) == [14, 15]
    assert not out[:, ~seen].any()
    assert bool((lse[..., ~seen] == tattention.NEG_INF).all())
    assert float(np.abs(np.asarray(jout)[:, ~seen]).max()) > 0.1
    close(out[:, seen], np.asarray(jout)[:, seen], 2e-5)
    for mine, ref in zip(grads, jgrads):
        close(mine, ref, 2e-4)


def test_flash_entry_takes_the_mask_on_the_cpu():
    """The serving entry (``models.flash.flash_attention``) under a window
    and an offset: the reference's forward, and the wrapper counts no
    launch on CPU tensors."""
    q, k, v = _mask_inputs(5, 2, 24, 64, 4, 2, 16)
    before = tattention.flash_attention_fwd.launches
    got = tflash.flash_attention(t(q), t(k), t(v), causal=True, window=9,
                                 q_offset=40)
    want = jflash.flash_attention_vjp(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True, window=9,
                                      q_offset=40, q_chunk=8, kv_chunk=16)
    close(got, want, 2e-5)
    assert tattention.flash_attention_fwd.launches == before


# ---------------------------------------------------------- (b) M-RoPE
@pytest.mark.parametrize("hd,theta,sections", [(16, 1e6, (2, 3, 3)),
                                               (16, 1e4, (4, 2, 2)),
                                               (8, 1e6, (1, 1, 2))])
def test_mrope_angles_match_reference(hd, theta, sections):
    """(3, B, S) positions whose streams differ: the reference's angles bit
    for bit at the smoke configs' head dims."""
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 4096, (3, 2, 9)).astype(np.int32)
    got = tlayers.rope_angles(t(pos), hd, theta, sections).numpy()
    want = np.asarray(jlayers.rope_angles(jnp.asarray(pos), hd, theta,
                                          sections))
    np.testing.assert_array_equal(got, want)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    close(tlayers.apply_rope(t(x), t(got)),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(want)), 2e-5,
          rtol=1e-5)


def test_mrope_at_qwen2_vl_width_takes_each_slot_from_its_stream():
    """At head_dim 128, sections (16, 24, 24): slot i's angle is, bit for
    bit, plain RoPE's angle of its section's stream; the reference's
    within two fp32 ulps (the two packages' inverse frequencies, theta to
    a power, may differ in the last place, and the product rounds once
    more)."""
    rng = np.random.default_rng(128)
    pos = rng.integers(0, 4096, (3, 2, 9)).astype(np.int32)
    got = tlayers.rope_angles(t(pos), 128, 1e6, (16, 24, 24))
    stream = np.repeat([0, 1, 2], (16, 24, 24))
    for s in range(3):
        plain = tlayers.rope_angles(t(pos[s]), 128, 1e6)
        assert torch.equal(got[..., stream == s], plain[..., stream == s])
    want = jlayers.rope_angles(jnp.asarray(pos), 128, 1e6, (16, 24, 24))
    close(got, want, 0.0, rtol=2.0 ** -22)
    with pytest.raises(ValueError, match="mrope_sections"):
        tlayers.rope_angles(t(pos), 128, 1e6, (16, 24, 23))


# ------------------------------------------------- (c) the global flags
@pytest.mark.parametrize("arch", ARCHS)
def test_global_flags_match_reference(arch):
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch))):
        np.testing.assert_array_equal(tmodel.global_flags(mine),
                                      jmodel.global_flags(ref))


def test_global_flags_without_a_period_are_first_middle_last():
    """Hymba's rule (a window and no ``global_every``): the first, middle
    and last layers are global, which ``ModelConfig.layer_is_global`` does
    not say; a config without a window is global everywhere."""
    cfg = get_smoke_config("hymba_1_5b")
    assert cfg.sliding_window is not None and cfg.global_every is None
    for n in (1, 4, 7):
        c = dataclasses.replace(cfg, num_layers=n)
        want = np.zeros(n, bool)
        want[[0, n // 2, n - 1]] = True
        np.testing.assert_array_equal(tmodel.global_flags(c), want)
        np.testing.assert_array_equal(
            jmodel.global_flags(dataclasses.replace(jget_smoke("hymba_1_5b"),
                                                    num_layers=n)), want)
    assert tmodel.layer_windows(get_smoke_config("gemma3_4b")) == \
        [16, 16, 16, 16, 16, None]
    assert tmodel.layer_windows(get_smoke_config("qwen2_7b")) == [None] * 2


# ------------------------------------ (d) prefill, decode and generation
def _reference_params(cfg, seed: int) -> dict:
    """The JAX init, with random norm scales and biases (not zeros), as
    numpy."""
    params = {k: np.asarray(v) for k, v in
              jmodel.init_params(cfg, jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    for name in params:
        if name in tmodel.NORM_KEYS or name in ("bq", "bk", "bv"):
            params[name] = (rng.standard_normal(params[name].shape) * 0.3
                            ).astype(np.float32)
    return params


def _inputs(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens, and for a VLM a visual prefix (standard normal x 0.02) and
    grid positions, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.vlm:
        out["visual"] = (rng.standard_normal(
            (B, cfg.visual_prefix, cfg.d_model)) * 0.02).astype(np.float32)
        out["mrope_positions"] = grid_positions(B, S, cfg.visual_prefix, 4)
    return out


#: Gemma3's smoke window is 16: prompts of 40 and decodes past position 32
#: leave every local layer masking keys
SEQ = {"gemma3_4b": 40, "qwen2_vl_7b": 20}


def _prefill_and_decode(arch, frac, floor, cache_frac, cache_floor):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    params = _reference_params(jcfg, 11)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    B, S = 2, SEQ[arch]
    max_len = S + 4
    inputs = _inputs(cfg, B, S, 5)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    jl, jc = jmodel.model_forward(
        params, jcfg, jnp.asarray(inputs["tokens"]), mode="prefill",
        max_len=max_len, **{k: jnp.asarray(v) for k, v in extra.items()})
    tl, tc = tmodel.model_forward(
        model, cfg, t(inputs["tokens"]), mode="prefill", max_len=max_len,
        **{k: t(v) for k, v in extra.items()})
    assert tl.shape == (B, 1, cfg.vocab_padded)
    close(tl, jl, scaled_tol(jl, frac, floor))
    for nm in ("k", "v"):
        close(tc[nm], jc[nm], scaled_tol(jc[nm], cache_frac, cache_floor))
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        nxt = nxt[:, None].astype(np.int32)
        jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(nxt),
                                      cache=jc, mode="decode")
        tl, tc = tmodel.model_forward(model, cfg, t(nxt), cache=tc,
                                      mode="decode")
        close(tl, jl, scaled_tol(jl, frac, floor))
        assert tc["pos"] == int(jc["pos"]) == S + step + 1
    for nm in ("k", "v"):
        close(tc[nm], jc[nm], scaled_tol(jc[nm], cache_frac, cache_floor))


@pytest.mark.parametrize("arch", ["gemma3_4b", "qwen2_vl_7b"])
def test_prefill_decode_match_reference_fp32(fp32, arch):
    _prefill_and_decode(arch, 1e-4, 1e-5, 0.0, 1e-4)


@pytest.mark.parametrize("arch", ["gemma3_4b", "qwen2_vl_7b"])
def test_prefill_decode_match_reference_bf16(arch):
    _prefill_and_decode(arch, 1 / 32, 1e-3, 1 / 64, 1e-3)


@pytest.mark.parametrize("arch", ["gemma3_4b", "qwen2_vl_7b"])
def test_greedy_generate_matches_reference_fp32(fp32, arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    params = _reference_params(jcfg, 4)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    inputs = _inputs(cfg, 3, SEQ[arch], 8)
    extra = {k: v for k, v in inputs.items() if k != "tokens"}
    want = jstep.greedy_generate(
        params, jcfg, jnp.asarray(inputs["tokens"]), steps=5,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    got = tstep.greedy_generate(model, cfg, t(inputs["tokens"]), steps=5,
                                **{k: t(v) for k, v in extra.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_and_positions_change_the_logits():
    """The window masks keys on Gemma3's local layers (a window past the
    prompt gives other logits), and Qwen2-VL's grid positions and visual
    prefix reach the logits (equal streams, or no prefix, give others)."""
    cfg = get_smoke_config("gemma3_4b")
    model = tmodel.init_params(cfg, seed=2, device="cpu")
    toks = t(_inputs(cfg, 2, 40, 1)["tokens"])
    base, _ = tmodel.model_forward(model, cfg, toks, mode="prefill")
    wide = dataclasses.replace(cfg, sliding_window=64)
    other, _ = tmodel.model_forward(model, wide, toks, mode="prefill")
    assert float((base - other).abs().max()) > 1e-3
    cfg = get_smoke_config("qwen2_vl_7b")
    model = tmodel.init_params(cfg, seed=2, device="cpu")
    inputs = {k: t(v) for k, v in _inputs(cfg, 2, 20, 1).items()}
    step = tstep.make_prefill_step(cfg)
    base, _ = step(model, inputs)
    same = dict(inputs, mrope_positions=inputs["mrope_positions"][:1].expand(
        3, -1, -1))
    no_prefix = {k: v for k, v in inputs.items() if k != "visual"}
    for variant in (same, no_prefix):
        assert float((base - step(model, variant)[0]).abs().max()) > 1e-3


# ------------------------------------------------- (e) loss and gradients
@pytest.mark.parametrize("arch", ["gemma3_4b", "qwen2_vl_7b"])
def test_lm_loss_and_grads_match_reference_fp32(fp32, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full")
    jcfg = dataclasses.replace(jget_smoke(arch), remat="full")
    params = _reference_params(jcfg, 3)
    batch = _inputs(cfg, 2, SEQ[arch], 6)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    batch["labels"][0, :3] = -1
    (jl, _), jgrads = jax.value_and_grad(jmodel.lm_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    model.requires_grad_(True)
    loss, _ = tmodel.lm_loss(model, cfg, {k: t(v) for k, v in batch.items()})
    loss.backward()
    close(loss, jl, 0.0, rtol=1e-5)
    grads = tmodel.stack_layers(cfg, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        close(g, jgrads[name], scaled_tol(jgrads[name], 1e-4, 1e-7))


def test_vlm_demo_batch_trains_through_the_train_step():
    """A VLM demo batch (visual prefix and M-RoPE positions) trains
    through ``make_train_step``, microbatched on axis 0 (and axis 1 of the
    positions): a finite loss, the step counted."""
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    cfg = get_smoke_config("qwen2_vl_7b")
    model = tmodel.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = demo_batch(cfg, "train", 4, 16, torch.Generator().manual_seed(3))
    assert batch["visual"].shape == (4, cfg.visual_prefix, cfg.d_model)
    assert batch["mrope_positions"].shape == (3, 4, 16)
    opt = init_opt_state(model, OptimConfig())
    for accum in (1, 2):
        step = make_train_step(cfg, TrainConfig(accum_steps=accum))
        model, opt, metrics = step(model, opt, batch)
        assert bool(torch.isfinite(metrics["loss"]))
    assert int(opt["step"]) == 2
