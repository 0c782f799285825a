"""The Whisper encoder-decoder, and training of the MoE, SSM and hybrid
families, in the port against the JAX package, on the CPU.

(a) The encoder-decoder on ``whisper_small``'s smoke config (2 + 2 layers,
32 frames): ``_sinusoidal`` and the encoder alone against the reference's
in fp32; prefill and four decode steps (logits and every cache entry,
``xk``/``xv`` included) at ``tests/test_torch_moe_ssm.py``'s tolerances:
fp32 logits 1e-4 of their largest magnitude plus 1e-5 and caches 1e-4,
bf16 logits 1/32 plus 1e-3 and caches 1/64 plus 1e-3; ``greedy_generate``
(fp32 tokens equal to the reference's); a prefill of S - 1 plus one decode
step against a prefill of S; ``init_cache``, ``cache_logical`` and
``_empty_caches`` with their cross-attention entries; a config given no
frames raises.

(b) Training of the families: two ``make_train_step`` steps against the
reference's for each family (``tests/test_torch_train.py``'s bounds); the
MoE at capacity factor 0.5, where the capacity drops assignments, with
every gradient equal to ``jax.grad``'s within ``scaled_tol(ref, 1e-4,
1e-7)``; under ``remat="full"`` each MoE layer's recompute routes and
drops every token as its forward did.  (The loss and every gradient of each
family under remat none, full and dots are
``tests/test_torch_train.py::test_lm_loss_and_grads_match_reference_fp32``.)

(c) The SSD fault the port repairs: at the published chunk of 128, with
``init_params``' dt (softplus(N(0, 1) + 0.5)) and A (-exp(0.5)), the
reference's ``ssd_chunked`` gradient is NaN (shown, not fixed: the
reference is frozen); the port's is finite and within 1e-4 of the largest
gradient of ``ssd_sequential``'s autograd, its forward is bit-identical to
the unmasked form it replaced and matches the reference's within 1e-5
(the reference's own SSD tolerance) of its largest magnitude plus 1e-5.

(d) Whisper and Qwen2-MoE checkpoints restore across the two packages both
ways, and ``launch/serve.py --demo --arch whisper_small`` runs here.
"""
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.checkpoint import store as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve import step as jserve  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.shapes import demo_batch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import step as tserve  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH = "whisper_small"
FAMILIES = ["whisper_small", "qwen2_moe_a2_7b", "granite_moe_3b_a800m",
            "mamba2_2_7b", "hymba_1_5b"]
MOE = ["qwen2_moe_a2_7b", "granite_moe_3b_a800m"]
PROMPT = 9


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


def _frames(cfg, batch: int, seed: int) -> np.ndarray:
    """Frame embeddings, standard normal x 0.02 (the reference's
    ``demo_batch``)."""
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32)


def _train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :3] = -1                                   # masked positions
    out = {"tokens": tokens, "labels": labels}
    if cfg.enc_dec:
        out["frames"] = _frames(cfg, batch, seed + 100)
    return out


def _grads(model, cfg) -> dict:
    return tmodel.stack_layers(cfg, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})


# ------------------------------------------------- (a) the encoder-decoder
@settings(max_examples=20, deadline=None)
@given(half=st.integers(min_value=1, max_value=384),
       frames=st.integers(min_value=1, max_value=1500))
def test_sinusoidal_matches_reference(half, frames):
    pos = np.arange(frames, dtype=np.int32)
    want = np.asarray(jmodel._sinusoidal(jnp.asarray(pos), 2 * half))
    got = tmodel._sinusoidal(t(pos), 2 * half)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the frequencies' exp may differ in the last place between the two
    # libraries, which moves an angle of up to ``frames`` rad by about its
    # own ulp: two fp32 ulps of the largest angle, plus sin/cos's own
    close(got, want, 2 * 2.0 ** -23 * frames + 1e-6)


def test_encoder_matches_reference_fp32(fp32):
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    params = _reference_params(jcfg, 1)
    frames = _frames(cfg, 3, 2)
    want = np.asarray(jmodel._encoder(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        jnp.asarray(frames)))
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    with torch.no_grad():
        got = tmodel._encoder(model, cfg, t(frames), train=False)
    assert got.shape == (3, cfg.enc_frames, cfg.d_model)
    close(got, want, scaled_tol(want, 1e-5, 1e-6))


def _prefill_and_decode(frac, floor, cache_frac, cache_floor):
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    params = _reference_params(jcfg, 11)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    B, S = 2, PROMPT
    max_len = S + 4
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(cfg, B, 6)
    jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(tokens),
                                  frames=jnp.asarray(frames),
                                  mode="prefill", max_len=max_len)
    tl, tc = tmodel.model_forward(model, cfg, t(tokens), frames=t(frames),
                                  mode="prefill", max_len=max_len)
    assert tl.shape == (B, 1, cfg.vocab_padded)
    close(tl, jl, scaled_tol(jl, frac, floor))
    assert set(tc) == set(jc) == {"pos", "k", "v", "xk", "xv"}
    assert tc["pos"] == int(jc["pos"]) == S
    assert tc["k"].shape[2] == max_len and tc["xk"].shape[2] == cfg.enc_frames

    def caches_match():
        for nm in tc:
            if nm != "pos":
                assert tc[nm].shape == jc[nm].shape, nm
                assert str(tc[nm].dtype) == f"torch.{jc[nm].dtype}", nm
                close(tc[nm], jc[nm],
                      scaled_tol(jc[nm], cache_frac, cache_floor))
    caches_match()
    xk = tc["xk"].clone()
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        nxt = nxt[:, None].astype(np.int32)
        jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(nxt),
                                      cache=jc, mode="decode")
        tl, tc = tmodel.model_forward(model, cfg, t(nxt), cache=tc,
                                      mode="decode")
        close(tl, jl, scaled_tol(jl, frac, floor))
        assert tc["pos"] == int(jc["pos"]) == S + step + 1
    caches_match()
    assert torch.equal(tc["xk"], xk)          # decode never writes xk/xv


def test_whisper_prefill_decode_match_reference_fp32(fp32):
    _prefill_and_decode(1e-4, 1e-5, 0.0, 1e-4)


def test_whisper_prefill_decode_match_reference_bf16():
    _prefill_and_decode(1 / 32, 1e-3, 1 / 64, 1e-3)


def test_whisper_greedy_generate_matches_reference_fp32(fp32):
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    params = _reference_params(jcfg, 4)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    frames = _frames(cfg, 3, 9)
    want = jserve.greedy_generate(params, jcfg, jnp.asarray(prompts),
                                  steps=5, frames=jnp.asarray(frames))
    got = tserve.greedy_generate(model, cfg, t(prompts), steps=5,
                                 frames=t(frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the serving steps carry the frames through the batch
    logits, cache = tserve.make_prefill_step(cfg, max_len=PROMPT + 5)(
        model, {"tokens": t(prompts), "frames": t(frames)})
    out = [logits[:, -1, :cfg.vocab_size].argmax(-1)]
    decode = tserve.make_decode_step(cfg)
    for _ in range(4):
        logits, cache = decode(model, {"tokens": out[-1][:, None],
                                       "cache": cache})
        out.append(logits[:, -1, :cfg.vocab_size].argmax(-1))
    assert torch.equal(torch.stack(out, 1), got)


def test_whisper_prefill_then_a_step_matches_a_longer_prefill(fp32):
    cfg = get_smoke_config(ARCH)
    model = tmodel.params_from_numpy(
        cfg, _reference_params(jget_smoke(ARCH), 6), device="cpu")
    tokens = t(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                 (2, PROMPT)))
    frames = t(_frames(cfg, 2, 4))
    want, _ = tmodel.model_forward(model, cfg, tokens, frames=frames,
                                   mode="prefill")
    _, cache = tmodel.model_forward(model, cfg, tokens[:, :-1], frames=frames,
                                    mode="prefill", max_len=PROMPT)
    got, _ = tmodel.model_forward(model, cfg, tokens[:, -1:], cache=cache,
                                  mode="decode")
    close(got, want.numpy(), scaled_tol(want.numpy(), 1e-4, 1e-5))


def test_whisper_caches_and_their_names_match_reference():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    mine = tmodel.init_cache(cfg, 3, 10, device="cpu")
    want = jmodel.init_cache(jcfg, 3, 10)
    assert set(mine) == set(want) == {"pos", "k", "v", "xk", "xv"}
    for nm, v in want.items():
        if nm == "pos":
            assert mine[nm] == int(v) == 0
            continue
        assert tuple(mine[nm].shape) == v.shape, nm
        assert str(mine[nm].dtype).split(".")[-1] == str(v.dtype), nm
        assert not mine[nm].any()
    assert tmodel.cache_logical(cfg) == jmodel.cache_logical(jcfg)
    assert tmodel.param_logical(cfg) == jmodel.param_logical(jcfg)
    # the reference's placeholders hold no positions of k/v/xk/xv; the
    # port's are the caches themselves, the same keys and other axes
    empty = tmodel._empty_caches(cfg, 3, 7, torch.device("cpu"), frames=5)
    jempty = jmodel._empty_caches(jcfg, 3, 7)
    assert set(empty) == set(jempty)
    for nm, v in jempty.items():
        shape = list(v.shape)
        shape[2] = {"k": 7, "v": 7, "xk": 5, "xv": 5}[nm]
        assert list(empty[nm].shape) == shape, nm


def test_whisper_schema_and_weights_match_reference():
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    params = _reference_params(jcfg, 2)
    assert set(params) == set(tmodel._schema(cfg))
    assert {k: tuple(v.shape) for k, v in tmodel.abstract_params(
        cfg).items()} == {k: v.shape for k, v in params.items()}
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    assert len(model.enc_layers) == cfg.enc_layers
    back = tmodel.params_to_numpy(model)
    for name, v in params.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)
    for name, p in tmodel.params_from_numpy(
            cfg, params, device="cpu").named_parameters():
        fp32_key = name.split(".")[-1] in tmodel.NORM_KEYS
        assert p.dtype == (torch.float32 if fp32_key else torch.bfloat16), \
            name
    sd = tmodel.init_params(cfg, seed=3, device="cpu").state_dict()
    for name, v in sd.items():
        key = name.split(".")[-1]
        if key in ("ln1", "ln2", "ln_x", "enc_ln1", "enc_ln2",
                   "final_norm", "enc_final_norm"):
            assert not v.any(), name
        else:
            assert v.float().std() > 0, name


def test_whisper_without_frames_raises():
    cfg = get_smoke_config(ARCH)
    model = tmodel.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="frames"):
            tmodel.model_forward(model, cfg, tokens, mode=mode)
    with pytest.raises(ValueError, match="frames"):
        tmodel.lm_loss(model, cfg, {"tokens": tokens, "labels": tokens})
    batch = demo_batch(cfg, "train", 2, 8, torch.Generator().manual_seed(0))
    assert batch["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert "frames" not in demo_batch(cfg, "decode", 2, 8,
                                      torch.Generator().manual_seed(0))


# ------------------------------------------------------ (b) training
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference_two_steps(fp32, arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
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


def _recording_dispatch(monkeypatch) -> list:
    """``moe.dispatch`` wrapped to append each call's (experts, keep)."""
    calls, saved = [], tmoe.dispatch

    def dispatch(experts, num_experts, capacity):
        pos, keep = saved(experts, num_experts, capacity)
        calls.append((experts.detach().clone(), keep.detach().clone()))
        return pos, keep
    monkeypatch.setattr(tmoe, "dispatch", dispatch)
    return calls


@pytest.mark.parametrize("arch", MOE)
def test_moe_drops_at_factor_half_with_the_references_grads(
        fp32, monkeypatch, arch):
    cfg, jcfg = (dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=0.5))
        for c in (get_smoke_config(arch), jget_smoke(arch)))
    params = _reference_params(jcfg, 7)
    batch = _train_batch(cfg, 2, 16, 3)
    (jl, _), jgrads = jax.value_and_grad(jmodel.lm_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    calls = _recording_dispatch(monkeypatch)
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    model.requires_grad_(True)
    loss, _ = tmodel.lm_loss(model, cfg, {k: t(v) for k, v in batch.items()})
    loss.backward()
    dropped = [int((~keep).sum()) for _, keep in calls]
    assert all(n > 0 for n in dropped), dropped
    close(loss, jl, 0.0, rtol=1e-5)
    grads = _grads(model, cfg)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        close(g, jgrads[name], scaled_tol(jgrads[name], 1e-4, 1e-7))


@pytest.mark.parametrize("arch", MOE)
def test_remat_recompute_routes_as_the_forward(monkeypatch, arch):
    """bf16 compute from fp32 masters, remat full, capacity factor 0.5: the
    forward routes and drops each MoE layer's tokens; the backward's
    recompute (layers in reverse order) must route and drop them again
    exactly so."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    model = tmodel.params_from_numpy(cfg, _reference_params(
        jget_smoke(arch), 5), device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    batch = {k: t(v) for k, v in _train_batch(cfg, 2, 16, 8).items()}
    calls = _recording_dispatch(monkeypatch)
    loss, _ = tmodel.lm_loss(model, cfg, batch)
    L = cfg.num_layers
    assert len(calls) == L
    loss.backward()
    assert len(calls) == 2 * L
    forward, recompute = calls[:L], calls[L:][::-1]
    for (e1, k1), (e2, k2) in zip(forward, recompute):
        assert torch.equal(e1, e2) and torch.equal(k1, k2)
    assert any(int((~k).sum()) for _, k in forward)


# ------------------------------------------------- (c) the SSD fault
def _ssd_init_inputs(seed: int, S: int = 512):
    """x, dt, A, B, C, D with ``init_params``' dt and A: dt_bias = A_log =
    0.5, so dt = softplus(N(0, 1) + 0.5) and A = -exp(0.5); a cotangent
    for y and one for the final state."""
    rng = np.random.default_rng(seed)
    Bt, nh, hp, ng, ds = 1, 4, 8, 1, 16
    x = rng.standard_normal((Bt, S, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, nh)) + 0.5)).astype(
        np.float32)
    A = -np.full((nh,), np.exp(0.5), np.float32)
    Bm = (rng.standard_normal((Bt, S, ng, ds)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((Bt, S, ng, ds)) * 0.3).astype(np.float32)
    D = rng.standard_normal((nh,)).astype(np.float32)
    gy = rng.standard_normal((Bt, S, nh, hp)).astype(np.float32)
    gh = rng.standard_normal((Bt, nh, hp, ds)).astype(np.float32)
    return (x, dt, A, Bm, Cm, D), (gy, gh)


def _unmasked_ssd_chunked():
    """``ssd_chunked`` as it was before the repair: the decay built as
    ``where(tril, exp(cum_i - cum_j), 0)`` (the reference's form), from
    the port's own source with that one expression put back."""
    src = inspect.getsource(tssm.ssd_chunked)
    masked = ("torch.exp(torch.where(tri, cum[..., :, None] - "
              "cum[..., None, :],\n                              -torch.inf))")
    assert src.count(masked) == 1
    src = src.replace(masked, "torch.where(tri, torch.exp(cum[..., :, None] "
                      "- cum[..., None, :]), 0.0)")
    namespace = dict(vars(tssm))
    exec(compile(src, tssm.__file__, "exec"), namespace)
    return namespace["ssd_chunked"]


def test_ssd_gradient_at_the_published_chunk():
    (x, dt, A, Bm, Cm, D), (gy, gh) = _ssd_init_inputs(0)
    wrt = (0, 1, 3, 4)                                   # x, dt, B, C

    def jloss(*args):
        y, h = jssm.ssd_chunked(*args, chunk=128)
        return (y * gy).sum() + (h * gh).sum()
    jgrads = jax.grad(jloss, wrt)(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    # the reference's gradient (frozen): NaN at chunk 128
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads)

    def grads_of(fn, **kw):
        args = [t(a) for a in (x, dt, A, Bm, Cm, D)]
        for i in wrt:
            args[i].requires_grad_(True)
        y, h = fn(*args, **kw)
        ((y * t(gy)).sum() + (h * t(gh)).sum()).backward()
        return (y.detach(), h.detach()), [args[i].grad for i in wrt]
    (y, h), got = grads_of(tssm.ssd_chunked, chunk=128)
    _, want = grads_of(tssm.ssd_sequential)
    tol = 1e-4 * max(float(g.abs().max()) for g in want)
    for name, a, b in zip(("x", "dt", "B", "C"), got, want):
        assert bool(torch.isfinite(a).all()), name
        close(a, b.numpy(), tol)
    # the forward: bit-identical to the unmasked form; the reference's
    # within its own SSD tolerance (1e-5) relative to the output's largest
    # magnitude (512 steps of dt ~ 1 here against 64 small ones there)
    with torch.no_grad():
        y0, h0 = _unmasked_ssd_chunked()(*map(t, (x, dt, A, Bm, Cm, D)),
                                         chunk=128)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)),
                              chunk=128)
    close(y, jy, scaled_tol(jy, 1e-5, 1e-5))
    close(h, jh, scaled_tol(jh, 1e-5, 1e-5))


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_ssm_training_at_the_published_chunk_is_finite(arch):
    """A smoke config at the published chunk of 128 and d_state: one
    training step's gradients are all finite (the reference's are NaN
    there)."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=128))
    model = tmodel.init_params(cfg, seed=1, device="cpu",
                               dtype=torch.float32)
    model.requires_grad_(True)
    batch = demo_batch(cfg, "train", 1, 256, torch.Generator().manual_seed(2))
    loss, _ = tmodel.lm_loss(model, cfg, batch)
    loss.backward()
    assert bool(torch.isfinite(loss))
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name


# ------------------------------------- (d) checkpoints and the launcher
def _model_and_opt(cfg, seed: int):
    model = tmodel.init_params(cfg, seed=seed, device="cpu",
                               dtype=torch.float32)
    opt = tadamw.init_opt_state(model, tadamw.OptimConfig())
    opt["step"].fill_(5)
    for mom in ("m", "v"):
        for p in opt[mom].values():
            p.normal_(generator=torch.Generator().manual_seed(seed))
    return model, opt


@pytest.mark.parametrize("arch", ["whisper_small", "qwen2_moe_a2_7b"])
def test_checkpoint_written_by_the_port_restores_in_the_reference(
        tmp_path, arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    model, opt = _model_and_opt(cfg, 2)
    tckpt.save_checkpoint(str(tmp_path), 3,
                          tloop.checkpoint_state(model, opt))
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jadamw.init_opt_state(jparams, jadamw.OptimConfig())
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jparams, "opt": jopt})
    restored, step = jckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 3 and np.asarray(restored["opt"]["step"]).item() == 5
    for name, arr in tmodel.params_to_numpy(model).items():
        np.testing.assert_array_equal(np.asarray(restored["params"][name]),
                                      arr)
        for mom in ("m", "v"):
            mine = tmodel.stack_layers(cfg, opt[mom])[name].numpy()
            np.testing.assert_array_equal(
                np.asarray(restored["opt"][mom][name]), mine)


@pytest.mark.parametrize("arch", ["whisper_small", "qwen2_moe_a2_7b"])
def test_checkpoint_written_by_the_reference_restores_in_the_port(
        tmp_path, arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    jopt = jadamw.init_opt_state(jparams, jadamw.OptimConfig())
    rng = np.random.default_rng(4)
    jopt["m"] = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                 for k, v in jopt["m"].items()}
    jckpt.save_checkpoint(str(tmp_path), 9, {"params": jparams, "opt": jopt})
    model, opt = _model_and_opt(cfg, 0)
    restored, step = tckpt.restore_checkpoint(
        str(tmp_path), tloop.checkpoint_state(model, opt))
    tloop.load_checkpoint_state(model, opt, restored)
    assert step == 9 and int(opt["step"]) == 0
    got = tmodel.params_to_numpy(model)
    assert set(got) == set(jparams)
    for name, arr in jparams.items():
        np.testing.assert_array_equal(got[name], np.asarray(arr))
        np.testing.assert_array_equal(
            tmodel.stack_layers(cfg, opt["m"])[name].numpy(),
            np.asarray(jopt["m"][name]))


def test_launch_serve_demo_serves_whisper_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--demo", "--arch", "whisper_small", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--steps", "3"])
    assert "whisper-small-smoke on cpu: 6 tokens" in capsys.readouterr().out
