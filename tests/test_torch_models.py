"""The port's LM serving slice against the JAX package, on the CPU.

Layers, the flash attention forward (plain version and the model-layout
entry), prefill logits, the KV cache, decode steps and greedy generation of
the dense smoke configs, on the same seeded numpy inputs and weights carried
across with ``params_from_numpy``.  Tolerances:

* fp32 layers and attention: atol 2e-5, the reference kernel test's;
* fp32 model logits: 1e-4 of the logits' largest magnitude, plus 1e-5
  (two packages sum the same products in other orders through every layer);
* bf16 model logits: 1/32 of the logits' largest magnitude plus 1e-3, and
  the bf16 KV cache atol 0.02 (the two packages round to bf16 at other
  places: up to 2^-8 relative per rounding, a few dozen roundings deep;
  the smoke configs show about 1/200);
* bf16 attention against its fp32 plain version: the card's element check
  (``torch_checks.bf16_attn_err``), shown here to pass the reference and
  to fail P rounded to bf16 before P V.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import attention as jattention  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import attention as tattention  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from torch_checks import bf16_attn_err  # noqa: E402

DENSE = ["qwen2_7b", "granite_20b", "command_r_plus_104b"]
#: dense branches no smoke config takes: qk-norm, a logit soft-cap, geglu
BRANCHES = {"qk_norm": True, "logit_softcap": 3.0, "mlp_act": "geglu"}


def configs(arch: str):
    """(port config, reference config) of a smoke arch; "<arch>+branches"
    turns on :data:`BRANCHES` in both."""
    name, _, extra = arch.partition("+")
    mine, ref = get_smoke_config(name), jget_smoke(name)
    if extra:
        mine = dataclasses.replace(mine, **BRANCHES)
        ref = dataclasses.replace(ref, **BRANCHES)
    return mine, ref


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------ (a) layers
def test_configs_are_the_reference_configs():
    import repro.configs as jconfigs
    assert ARCHS == jconfigs.ARCHS
    for arch in ARCHS:
        for mine, ref in ((get_config(arch), jconfigs.get_config(arch)),
                          (get_smoke_config(arch), jget_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.param_count() == ref.param_count()
            assert mine.vocab_padded == ref.vocab_padded


def test_rms_norm_with_random_scale():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    close(tlayers.rms_norm(t(x), t(scale), 1e-5),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 2e-5)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6), (8, 75e6)])
def test_rope_matches(hd, theta):
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    ang_t = tlayers.rope_angles(t(pos), hd, theta)
    ang_j = jlayers.rope_angles(jnp.asarray(pos), hd, theta)
    close(ang_t, ang_j, 1e-6, rtol=1e-6)
    close(tlayers.apply_rope(t(x), ang_t),
          jlayers.apply_rope(jnp.asarray(x), ang_j), 2e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for n, s in (("w_in", (32, 64)), ("w_gate", (32, 64)),
                      ("w_out", (64, 32)))}
    close(tlayers.mlp(t(x), {k: t(v) for k, v in p.items()}, act),
          jlayers.mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in p.items()}, act), 2e-5)


@pytest.mark.parametrize("pos,groups", [(0, 1), (5, 2), (12, 4)])
def test_decode_attention_matches(pos, groups):
    rng = np.random.default_rng(pos)
    B, smax, kv, hd = 2, 13, 2, 16
    q = rng.standard_normal((B, 1, kv * groups, hd)).astype(np.float32)
    kc = rng.standard_normal((B, smax, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, smax, kv, hd)).astype(np.float32)
    got = tlayers.decode_attention(t(q), t(kc), t(vc),
                                   tlayers.AttnMask(True, None, pos, pos + 1))
    want = jlayers.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jlayers.AttnMask(True, None, pos, pos + 1))
    close(got, want, 2e-5)


# ------------------------------------------------- (b) the flash kernel
@pytest.mark.parametrize("causal,s,bq,bk", [
    (True, 256, 64, 64), (False, 300, 64, 96), (True, 128, 128, 32),
])
def test_flash_plain_matches_pallas_interpret(causal, s, bq, bk):
    """The three cases of the reference's kernel test, atol 2e-5; the
    wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(1)
    BH, hd = 3, 32
    q, k, v = (rng.standard_normal((BH, s, hd)).astype(np.float32)
               for _ in range(3))
    want = jattention.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk)
    close(tattention.flash_attention_fwd_plain(t(q), t(k), t(v),
                                               causal=causal), want, 2e-5)
    before = tattention.flash_attention_fwd.launches
    close(tattention.flash_attention_fwd(t(q), t(k), t(v), causal=causal,
                                         block_q=bq, block_k=bk), want, 2e-5)
    assert tattention.flash_attention_fwd.launches == before


@pytest.mark.parametrize("bad", ["dtype", "kv_heads", "layout"])
def test_flash_wrapper_rejects(bad):
    q = torch.zeros(1, 4, 6, 8)
    k = v = torch.zeros(1, 4, 2, 8)
    if bad == "dtype":
        q = q.double()
    elif bad == "kv_heads":
        k = v = torch.zeros(1, 4, 4, 8)
    else:                           # another batch (a kv length other
        k = v = torch.zeros(2, 4, 2, 8)  # than q's is cross attention)
    with pytest.raises(ValueError, match="flash_attention_fwd"):
        tattention.flash_attention_fwd(q, k, v)


def _tiled_bf16_attention(q, k, v, causal: bool, split: bool):
    """The tensor-core kernel's arithmetic on the CPU: 128-key tiles, online
    softmax in fp32, P into P V as bf16 hi + lo (``split``, the kernel) or
    rounded to bf16 alone (the control); the output rounded to bf16 once."""
    S = q.shape[1]
    s = (q.float() @ k.float().transpose(1, 2)) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          tattention.NEG_INF)
    m = torch.full((*s.shape[:2], 1), tattention.NEG_INF)
    den = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, S, 128):
        st, vt = s[:, :, k0:k0 + 128], v[:, k0:k0 + 128].float()
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(st - m_new)
        den = den * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc, m = acc * corr + pv, m_new
    return (acc / den).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [63, 129, 300])
def test_bf16_attention_check_fails_a_bf16_pv_control(s, causal):
    """The card's bf16 check (``torch_checks.bf16_attn_err``) passes the
    Pallas reference, the plain version and the tensor-core kernel's
    arithmetic (P as a bf16 hi + lo pair), and fails the same arithmetic
    with P rounded to bf16 alone."""
    rng = np.random.default_rng(s)
    q, k, v = (t(rng.standard_normal((3, s, 128)).astype(np.float32))
               .bfloat16() for _ in range(3))
    want = tattention.flash_attention_fwd_plain(q.float(), k.float(),
                                                v.float(), causal=causal)
    pallas = jattention.flash_attention_fwd(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        causal=causal, block_q=128, block_k=128)
    assert bf16_attn_err(t(np.asarray(pallas, np.float32)), want) <= 1
    assert bf16_attn_err(tattention.flash_attention_fwd(
        q, k, v, causal=causal), want) <= 1
    assert bf16_attn_err(_tiled_bf16_attention(q, k, v, causal, True),
                         want) <= 1
    assert bf16_attn_err(_tiled_bf16_attention(q, k, v, causal, False),
                         want) > 2


# --------------------------------------- (c) the model-layout flash entry
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kv", [(37, 4, 2), (100, 8, 2), (1, 4, 1),
                                    (65, 8, 8)])
def test_flash_entry_matches_flash_attention_vjp(causal, s, h, kv):
    rng = np.random.default_rng(s * h)
    q = rng.standard_normal((2, s, h, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, kv, 16)).astype(np.float32)
            for _ in range(2))
    want = jflash.flash_attention_vjp(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      q_chunk=32, kv_chunk=16)
    close(tflash.flash_attention(t(q), t(k), t(v), causal=causal), want,
          2e-5)


# ---------------------------------------------------------- (d) the model
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


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)


def _logit_tol(want, frac: float, floor: float) -> float:
    return frac * float(np.abs(np.asarray(want, np.float32)).max()) + floor


def _prefill_and_decode(arch, frac, floor, cache_atol):
    cfg, jcfg = configs(arch)
    params = _reference_params(jcfg, 11)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    rng = np.random.default_rng(5)
    B, S, max_len = 2, 12, 16
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(tokens),
                                  mode="prefill", max_len=max_len)
    tl, tc = tmodel.model_forward(model, cfg, t(tokens), mode="prefill",
                                  max_len=max_len)
    assert tl.shape == (B, 1, cfg.vocab_padded)
    close(tl, jl, _logit_tol(jl, frac, floor))
    assert tc["pos"] == int(jc["pos"]) == S
    for nm in ("k", "v"):
        assert tc[nm].shape == jc[nm].shape == (
            cfg.num_layers, B, max_len, cfg.num_kv_heads, cfg.head_dim)
        close(tc[nm], jc[nm], cache_atol)
        assert not tc[nm][:, :, S:].any()
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        nxt = nxt[:, None].astype(np.int32)
        jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(nxt),
                                      cache=jc, mode="decode")
        tl, tc = tmodel.model_forward(model, cfg, t(nxt), cache=tc,
                                      mode="decode")
        close(tl, jl, _logit_tol(jl, frac, floor))
        assert tc["pos"] == int(jc["pos"]) == S + step + 1
    for nm in ("k", "v"):
        close(tc[nm], jc[nm], cache_atol)


@pytest.mark.parametrize("arch", DENSE + ["qwen2_7b+branches"])
def test_prefill_decode_match_reference_fp32(fp32, arch):
    _prefill_and_decode(arch, 1e-4, 1e-5, 1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_match_reference_bf16(arch):
    _prefill_and_decode(arch, 1 / 32, 1e-3, 0.02)


def test_params_carried_across_keep_norms_fp32():
    cfg = get_smoke_config("qwen2_7b")
    params = _reference_params(cfg, 2)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    names = dict(model.named_parameters())
    assert set(names) == (
        {k for k in params if k in tmodel.GLOBAL_KEYS}
        | {f"layers.{i}.{k}" for i in range(cfg.num_layers)
           for k in params if k not in tmodel.GLOBAL_KEYS})
    assert names["layers.1.ln1"].dtype == torch.float32
    assert names["layers.1.wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(names["layers.1.ln1"].numpy(),
                                  params["ln1"][1])
    assert names["layers.0.wq"].shape == params["wq"].shape[1:]
    with pytest.raises(ValueError, match="want shape"):
        tmodel.params_from_numpy(cfg, {**params, "wq": params["wq"][:1]},
                                 device="cpu")


def test_init_params_is_seeded_and_follows_the_schema():
    cfg = get_smoke_config("granite_20b")
    a = tmodel.init_params(cfg, seed=3, device="cpu")
    b = tmodel.init_params(cfg, seed=3, device="cpu")
    sd_a, sd_b = a.state_dict(), b.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    assert not sd_a["layers.0.ln1"].any()                 # scale 0 -> zeros
    assert "lm_head" not in sd_a                          # tied head
    std = sd_a["embed"].float().std().item()
    assert 0.015 < std < 0.025


# --------------------------------------------------------------- (e) greedy
@pytest.mark.parametrize("arch", DENSE + ["qwen2_7b+branches"])
def test_greedy_generate_matches_reference_fp32(fp32, arch):
    cfg, jcfg = configs(arch)
    params = _reference_params(jcfg, 4)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32)
    want = jstep.greedy_generate(params, jcfg, jnp.asarray(prompts), steps=5)
    got = tstep.greedy_generate(model, cfg, t(prompts), steps=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_steps_match_greedy():
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, seed=1, device="cpu")
    prompts = t(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)))
    want = tstep.greedy_generate(model, cfg, prompts, steps=4)
    logits, cache = tstep.make_prefill_step(cfg, max_len=10)(
        model, {"tokens": prompts})
    out = [logits[:, -1, :cfg.vocab_size].argmax(-1)]
    decode = tstep.make_decode_step(cfg)
    for _ in range(3):
        logits, cache = decode(model, {"tokens": out[-1][:, None],
                                       "cache": cache})
        out.append(logits[:, -1, :cfg.vocab_size].argmax(-1))
    assert torch.equal(torch.stack(out, 1), want)


# --------------------------------------------------------- (f) the launcher
def test_launch_serve_demo_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--demo", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--steps", "3"])
    out = capsys.readouterr().out
    assert "qwen2-7b-smoke on cpu: 6 tokens" in out


# ------------------------------------------- (g) what is not ported raises
@pytest.mark.parametrize("arch", ["whisper_small"])
def test_unported_configs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tmodel.init_params(get_smoke_config(arch), device="cpu")


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "granite_moe_3b_a800m",
                                  "mamba2_2_7b", "hymba_1_5b"])
def test_training_the_served_families_raises(arch):
    """MoE, SSM and hybrid serve (``tests/test_torch_moe_ssm.py``); their
    training waits for the backward of the MoE dispatch and the SSD scan."""
    cfg = get_smoke_config(arch)
    model = tmodel.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.3, training"):
        tmodel.model_forward(model, cfg, tokens, mode="train")
    with pytest.raises(NotImplementedError, match="ROADMAP A10.3, training"):
        tmodel.lm_loss(model, cfg, {"tokens": tokens, "labels": tokens})


def test_unported_modes_and_options_raise():
    """Training runs (``tests/test_torch_train.py``); training an unported
    family (the MoE smoke config) still raises, and so do an enc-dec
    batch's frames.  Windows, offsets, M-RoPE and the VLM prefix run
    (``tests/test_torch_window_vlm.py``)."""
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="MoE.*ROADMAP A10"):
        tmodel.lm_loss(model, get_smoke_config("qwen2_moe_a2_7b"),
                       {"tokens": tokens, "labels": tokens})
    with pytest.raises(NotImplementedError, match="encoder-decoder.*A10.3"):
        tmodel.lm_loss(model, cfg, {"tokens": tokens, "labels": tokens,
                                    "frames": torch.zeros((1, 4, 64))})
