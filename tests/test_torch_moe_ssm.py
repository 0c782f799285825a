"""The MoE FFN, the Mamba2 (SSD) mixer and the MoE / SSM / hybrid serving
path of the port against the JAX package, on the CPU.

(a) ``_capacity`` over a grid; the routing (a stable top-k: ties to the
lower expert index) and each assignment's rank within its expert against a
loop over tokens; ``moe_ffn`` of both MoE smoke configs (shared experts,
``router_norm``, top-2, and padded experts) against
``repro.models.moe.moe_ffn``: fp32 at atol 2e-5 of the output's scale
(the reference kernel tests' 2e-5 plus 1e-5 of max|out|), bf16 at 1/32 of
max|out| plus 1e-3 (``tests/test_torch_models.py``'s bf16 logits rule).
A zero router ties every probability: every token picks experts 0..k-1
and the capacity drops all but the first C tokens, which the port must
route, keep and drop exactly as the reference does.

(b) ``ssd_sequential``, ``ssd_recurrent`` and ``ssd_chunked`` against their
twins at atol 1e-5 (the reference's own SSD test), and the reference's
chunked-against-sequential and chunked-prefix-plus-step checks repeated on
the port; ``causal_conv`` and ``conv_step`` at 1e-6; ``mamba2_mix`` in
both modes, at a length that needs chunk padding, at 2e-5.

(c) Prefill, decode and ``greedy_generate`` of the four smoke configs
(``qwen2_moe_a2_7b``, ``granite_moe_3b_a800m``, ``mamba2_2_7b``,
``hymba_1_5b``) at the tolerances of ``tests/test_torch_models.py``: fp32
logits 1e-4 of their largest magnitude plus 1e-5, every cache entry 1e-4;
bf16 logits 1/32 plus 1e-3, every cache entry within 1/64 of its largest
magnitude plus 1e-3 (``tests/test_torch_window_vlm.py``'s bf16 cache
rule).  bf16 greedy tokens must be the reference's argmax at every step
whose top-2 margin exceeds that logit tolerance.  In bf16 the two packages'
router logits can round apart near a tie and flip an expert choice: each
MoE layer's routing is recomputed by the reference from the port's own
layer input, the flips are counted and printed, and each flip must sit at
a tie (a logit gap within 2^-6 of the row's largest logit).  Also: a
prefill of S - 1 tokens plus one decode step against a prefill of S
(``chip_smoke.py`` phase 16's cache check, fp32 at 1e-4 of max|logit|
plus 1e-5), ``init_cache`` and ``cache_logical`` against the reference,
and the weight carry (``params_from_numpy`` / ``params_to_numpy``,
``stack_layers`` / ``unstack_layers``) of every key bit for bit.
"""
import dataclasses
import itertools

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

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.shapes import demo_batch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

MOE = ["qwen2_moe_a2_7b", "granite_moe_3b_a800m"]
FAMILIES = MOE + ["mamba2_2_7b", "hymba_1_5b"]
#: the SSM's per-head parameters: 0.5 constants in the reference's init,
#: drawn at random here so that every head decays at its own rate
SSM_RANDOM = {"ssm_A_log": 0.5, "ssm_dt_bias": 0.5, "ssm_D": 1.0,
              "ssm_conv_b": 0.1, "ssm_norm": 0.3}


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
    """The JAX init, with random norm scales, biases and SSM per-head
    parameters (not zeros or constants), as numpy."""
    params = {k: np.asarray(v) for k, v in
              jmodel.init_params(cfg, jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    for name in params:
        if name in tmodel.NORM_KEYS or name in ("bq", "bk", "bv"):
            scale = 0.3
        elif name in SSM_RANDOM:
            scale = SSM_RANDOM[name]
        else:
            continue
        params[name] = (rng.standard_normal(params[name].shape) * scale
                        ).astype(np.float32)
    return params


# ----------------------------------------------------------- (a) the MoE
@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 0.3])
def test_capacity_matches_reference(factor):
    for T, k, E in itertools.product([1, 7, 8, 24, 8192, 100003],
                                     [1, 2, 4, 8], [8, 40, 60, 64]):
        assert tmoe._capacity(T, k, E, factor) == jmoe._capacity(
            T, k, E, factor), (T, k, E, factor)


def _dispatch_loop(experts: np.ndarray, capacity: int):
    """Each assignment's rank within its expert, counted in token order
    (token-major, then slot), and whether it fits the capacity."""
    seen: dict[int, int] = {}
    pos = []
    for e in experts.reshape(-1):
        pos.append(seen.get(int(e), 0))
        seen[int(e)] = pos[-1] + 1
    pos = np.array(pos)
    return pos, pos < capacity


@settings(max_examples=40, deadline=None)
@given(tokens=st.integers(min_value=1, max_value=40),
       k=st.integers(min_value=1, max_value=4),
       experts=st.integers(min_value=4, max_value=9),
       capacity=st.integers(min_value=1, max_value=12),
       seed=st.integers(min_value=0, max_value=2 ** 16))
def test_dispatch_ranks_assignments_in_token_order(tokens, k, experts,
                                                   capacity, seed):
    rng = np.random.default_rng(seed)
    # few distinct logits: many ties, which go to the lower expert index
    logits = rng.integers(0, 3, (tokens, experts)).astype(np.float32)
    spec = dataclasses.replace(get_smoke_config("qwen2_moe_a2_7b").moe,
                               num_experts=experts, top_k=k)
    gates, chosen = tmoe.route(t(logits), torch.eye(experts), spec)
    want = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(chosen.numpy(), want)
    jvals, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jidx))
    close(gates, jvals, 1e-7)
    pos, keep = tmoe.dispatch(chosen, experts, capacity)
    want_pos, want_keep = _dispatch_loop(want, capacity)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)


def _moe_layer(arch: str, seed: int, ep_pad: bool = False):
    """(spec, act, the reference's layer-0 MoE params as numpy) of a smoke
    config, the router scaled up so that routing is decided by the data."""
    cfg = jget_smoke(arch)
    spec = dataclasses.replace(cfg.moe, ep_pad=ep_pad)
    cfg = dataclasses.replace(cfg, moe=spec)
    params = _reference_params(cfg, seed)
    p = {"router": params["router"][0] * 20,
         **{k[len("moe_"):]: params[k][0] for k in
            ("moe_w_gate", "moe_w_in", "moe_w_out")},
         **{k: params[k][0] for k in ("shared_w_gate", "shared_w_in",
                                      "shared_w_out", "shared_gate")
            if k in params}}
    return spec, cfg.mlp_act, p


def _moe_both(spec, act, p, x: np.ndarray, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jmoe.moe_ffn(jnp.asarray(x, jdt),
                        {k: jnp.asarray(v) for k, v in p.items()}, spec, act)
    got = tmoe.moe_ffn(t(x).to(dtype), {k: t(v) for k, v in p.items()},
                       spec, act)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,ep_pad", [("qwen2_moe_a2_7b", False),
                                         ("granite_moe_3b_a800m", False),
                                         ("granite_moe_3b_a800m", True)])
def test_moe_ffn_matches_reference(arch, ep_pad, dtype):
    spec, act, p = _moe_layer(arch, 3, ep_pad)
    assert (spec.padded_experts() > spec.num_experts) == ep_pad
    x = np.random.default_rng(1).standard_normal((3, 17, 64)).astype(
        np.float32)
    got, want = _moe_both(spec, act, p, x, dtype)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        close(got, want, scaled_tol(want, 1e-5, 2e-5))
    else:
        close(got, want, scaled_tol(want, 1 / 32, 1e-3))
    # the capacity binds: some assignments are dropped
    T = x.shape[0] * x.shape[1]
    C = tmoe._capacity(T, spec.top_k, spec.num_experts, spec.capacity_factor)
    _, experts = tmoe.route(t(x).reshape(T, -1), t(p["router"]), spec)
    assert not tmoe.dispatch(experts, spec.num_experts, C)[1].all()


@pytest.mark.parametrize("arch", MOE)
def test_zero_router_drops_exactly_the_references_tokens(arch):
    """Every probability ties: each token picks experts 0..k-1 and the
    capacity keeps the first C tokens of each; the others take nothing of
    the routed experts, in both packages."""
    spec, act, p = _moe_layer(arch, 5)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(2).standard_normal((2, 21, 64)).astype(
        np.float32)
    T, k = 42, spec.top_k
    C = tmoe._capacity(T, k, spec.num_experts, spec.capacity_factor)
    assert C < T
    gates, experts = tmoe.route(t(x).reshape(T, -1), t(p["router"]), spec)
    jvals, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x).reshape(T, -1) @ jnp.asarray(p["router"])), k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(experts.numpy(),
                                  np.tile(np.arange(k), (T, 1)))
    pos, keep = tmoe.dispatch(experts, spec.num_experts, C)
    np.testing.assert_array_equal(keep.numpy().reshape(T, k),
                                  (np.arange(T) < C)[:, None].repeat(k, 1))
    np.testing.assert_array_equal(pos.numpy().reshape(T, k),
                                  np.arange(T)[:, None].repeat(k, 1))
    # the routed part alone: dropped tokens are exactly zero in both
    routed = {n: v for n, v in p.items() if not n.startswith("shared")}
    got, want = _moe_both(spec, act, routed, x, torch.float32)
    got = got.reshape(T, -1).numpy()
    want = want.reshape(T, -1)
    assert not got[C:].any() and not want[C:].any()
    assert np.abs(want[:C]).max(axis=1).min() > 0
    close(t(got), want, scaled_tol(want, 1e-5, 2e-5))
    got, want = _moe_both(spec, act, p, x, torch.float32)
    close(got, want, scaled_tol(want, 1e-5, 2e-5))


# ----------------------------------------------------------- (b) the SSM
def _ssd_inputs(seed, B, S, nh, hp, ng, ds):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2, (nh,)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, ng, ds)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, ng, ds)) * 0.3).astype(np.float32)
    D = rng.standard_normal((nh,)).astype(np.float32)
    h0 = (rng.standard_normal((B, nh, hp, ds)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("S,nh,ng,chunk,with_h0", [
    (64, 4, 2, 16, False), (64, 4, 1, 32, True), (48, 6, 3, 16, True),
    (16, 2, 2, 16, False)])
def test_ssd_forms_match_reference(S, nh, ng, chunk, with_h0):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(S + nh, 2, S, nh, 8, ng, 16)
    h0_j = jnp.asarray(h0) if with_h0 else None
    h0_t = t(h0) if with_h0 else None
    args = (x, dt, A, Bm, Cm, D)
    for tf, jf, kw in ((tssm.ssd_sequential, jssm.ssd_sequential, {}),
                       (tssm.ssd_chunked, jssm.ssd_chunked,
                        {"chunk": chunk})):
        y, h = tf(*map(t, args), h0=h0_t, **kw)
        jy, jh = jf(*map(jnp.asarray, args), h0=h0_j, **kw)
        close(y, jy, 1e-5)
        close(h, jh, 1e-5)
    y, h = tssm.ssd_recurrent(t(h0), *(t(a[:, 5]) for a in (x, dt)),
                              t(A), t(Bm[:, 5]), t(Cm[:, 5]), t(D))
    jy, jh = jssm.ssd_recurrent(jnp.asarray(h0), jnp.asarray(x[:, 5]),
                                jnp.asarray(dt[:, 5]), jnp.asarray(A),
                                jnp.asarray(Bm[:, 5]), jnp.asarray(Cm[:, 5]),
                                jnp.asarray(D))
    close(y, jy, 1e-5)
    close(h, jh, 1e-5)


def test_ssd_chunked_vs_sequential_on_the_port():
    """The reference's ``tests/test_models.py`` SSD check, on the port."""
    x, dt, A, Bm, Cm, D, _ = map(t, _ssd_inputs(0, 2, 64, 4, 8, 2, 16))
    y_ref, h_ref = tssm.ssd_sequential(x, dt, A, Bm, Cm, D)
    y_chk, h_chk = tssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=16)
    close(y_chk, y_ref.numpy(), 1e-5)
    close(h_chk, h_ref.numpy(), 1e-5)
    # decode continuation
    y1, h1 = tssm.ssd_chunked(x[:, :48], dt[:, :48], A, Bm[:, :48],
                              Cm[:, :48], D, chunk=16)
    yt, _ = tssm.ssd_recurrent(h1, x[:, 48], dt[:, 48], A, Bm[:, 48],
                               Cm[:, 48], D)
    close(yt, y_ref[:, 48].numpy(), 1e-5)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40], D,
                         chunk=16)


@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_and_conv_step_match_reference(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    close(tssm.causal_conv(t(x), t(w), t(b)),
          jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
          1e-6, rtol=1e-6)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    y, new = tssm.conv_step(t(state), t(x[:, -1]), t(w), t(b))
    jy, jnew = jssm.conv_step(jnp.asarray(state), jnp.asarray(x[:, -1]),
                              jnp.asarray(w), jnp.asarray(b))
    close(y, jy, 1e-6, rtol=1e-6)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_mamba2_mix_matches_reference_in_both_modes(arch):
    """A prompt of 21 (chunk 16: padded to 32), then two steps from its
    state."""
    cfg = jget_smoke(arch)
    params = _reference_params(cfg, 9)
    p = {k[len("ssm_"):]: v[1] for k, v in params.items()
         if k.startswith("ssm_")}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 23, cfg.d_model)).astype(np.float32)
    S = 21
    jy, js = jssm.mamba2_mix(jp, jnp.asarray(x[:, :S]), cfg, mode="full")
    ty, ts = tssm.mamba2_mix(tp, t(x[:, :S]), cfg, mode="full")
    close(ty, jy, 2e-5)
    for nm in ("conv", "ssm"):
        assert tuple(ts[nm].shape) == js[nm].shape
        close(ts[nm], js[nm], 2e-5)
    np.testing.assert_array_equal(ts["conv"].numpy(),
                                  np.asarray(js["conv"]))
    for i in range(S, x.shape[1]):
        jy, js = jssm.mamba2_mix(jp, jnp.asarray(x[:, i:i + 1]), cfg,
                                 mode="step", state=js)
        ty, ts = tssm.mamba2_mix(tp, t(x[:, i:i + 1]), cfg, mode="step",
                                 state=ts)
        close(ty, jy, 2e-5)
        close(ts["ssm"], js["ssm"], 2e-5)
        close(ts["conv"], js["conv"], 2e-5)
    # a prompt shorter than the conv window pads the conv state on the left
    _, js = jssm.mamba2_mix(jp, jnp.asarray(x[:, :2]), cfg, mode="full")
    _, ts = tssm.mamba2_mix(tp, t(x[:, :2]), cfg, mode="full")
    close(ts["conv"], js["conv"], 2e-5)
    assert not ts["conv"][:, 0].any()


# ------------------------------------------------------- (c) the families
#: Hymba's smoke window is 16: a prompt of 21 leaves every local layer
#: masking keys; the SSM smoke chunk is 16, so 21 also needs padding
PROMPT = 21


def _moe_flips(model, cfg, call) -> list:
    """Run ``call()`` with each MoE layer's input captured; the reference
    routes each captured input again (its router logits in the input's
    dtype, softmax in fp32, ``jax.lax.top_k``).  Returns per call and
    layer (flipped (token, slot) routings, the worst logit gap of a flip
    over its row's largest logit)."""
    captured = []
    saved = tmodel.moe_lib.moe_ffn

    def capture(x, p, spec, act):
        captured.append((x.detach().clone(), p["router"], spec))
        return saved(x, p, spec, act)
    tmodel.moe_lib.moe_ffn = capture
    try:
        call()
    finally:
        tmodel.moe_lib.moe_ffn = saved
    out = []
    for x, router, spec in captured:
        xf = x.reshape(-1, x.shape[-1])
        mine = tmoe.route(xf, router, spec)[1].numpy()
        jdt = jnp.float32 if x.dtype == torch.float32 else jnp.bfloat16
        jx = jnp.asarray(xf.float().numpy(), jdt)
        jl = (jx @ jnp.asarray(router.float().numpy()).astype(jdt)).astype(
            jnp.float32)
        _, jidx = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), spec.top_k)
        jl, jidx = np.asarray(jl), np.asarray(jidx)
        flips = mine != jidx
        worst = 0.0
        for tok, slot in zip(*np.nonzero(flips)):
            gap = abs(jl[tok, jidx[tok, slot]] - jl[tok, mine[tok, slot]])
            worst = max(worst, gap / np.abs(jl[tok]).max())
        out.append((int(flips.sum()), worst))
    return out


def _prefill_and_decode(arch, frac, floor, cache_frac, cache_floor):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    params = _reference_params(jcfg, 11)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    B, S = 2, PROMPT
    max_len = S + 4
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(tokens),
                                  mode="prefill", max_len=max_len)
    results = {}

    def prefill():
        results["prefill"] = tmodel.model_forward(
            model, cfg, t(tokens), mode="prefill", max_len=max_len)
    flips = _moe_flips(model, cfg, prefill) if cfg.moe else prefill() or []
    tl, tc = results["prefill"]
    assert tl.shape == (B, 1, cfg.vocab_padded)
    close(tl, jl, scaled_tol(jl, frac, floor))
    assert set(tc) == set(jc)
    assert tc["pos"] == int(jc["pos"]) == S

    def caches_match():
        for nm in tc:
            if nm != "pos":
                assert tc[nm].shape == jc[nm].shape, nm
                assert str(tc[nm].dtype) == f"torch.{jc[nm].dtype}", nm
                close(tc[nm], jc[nm],
                      scaled_tol(jc[nm], cache_frac, cache_floor))
    caches_match()
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1))
        nxt = nxt[:, None].astype(np.int32)
        jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(nxt),
                                      cache=jc, mode="decode")

        def decode():
            results["decode"] = tmodel.model_forward(
                model, cfg, t(nxt), cache=tc, mode="decode")
        flips += _moe_flips(model, cfg, decode) if cfg.moe else decode() or []
        tl, tc = results["decode"]
        close(tl, jl, scaled_tol(jl, frac, floor))
        assert tc["pos"] == int(jc["pos"]) == S + step + 1
    caches_match()
    return flips


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_match_reference_fp32(fp32, arch):
    flips = _prefill_and_decode(arch, 1e-4, 1e-5, 0.0, 1e-4)
    assert all(n == 0 for n, _ in flips), flips


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_match_reference_bf16(arch, capsys):
    flips = _prefill_and_decode(arch, 1 / 32, 1e-3, 1 / 64, 1e-3)
    if flips:
        with capsys.disabled():
            print(f"\n{arch} bf16: routings flipped against the reference "
                  f"per MoE layer call (count, worst logit gap / row max): "
                  f"{flips}")
        assert all(gap <= 2.0 ** -6 for _, gap in flips), flips


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_generate_matches_reference_fp32(fp32, arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    params = _reference_params(jcfg, 4)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    want = jstep.greedy_generate(params, jcfg, jnp.asarray(prompts), steps=5)
    got = tstep.greedy_generate(model, cfg, t(prompts), steps=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_generate_matches_reference_bf16(arch):
    """The port's greedy tokens, fed back to the reference step by step:
    each must be the reference's argmax wherever the reference's top-2
    margin exceeds the bf16 logit tolerance."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    params = _reference_params(jcfg, 4)
    model = tmodel.params_from_numpy(cfg, params, device="cpu")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    steps = 5
    got = tstep.greedy_generate(model, cfg, t(prompts), steps=steps).numpy()
    jl, jc = jmodel.model_forward(params, jcfg, jnp.asarray(prompts),
                                  mode="prefill", max_len=PROMPT + steps)
    decided = 0
    for step in range(steps):
        logits = np.asarray(jl[:, -1, :cfg.vocab_size], np.float32)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > scaled_tol(logits, 1 / 32, 1e-3)
        np.testing.assert_array_equal(got[sure, step],
                                      logits.argmax(-1)[sure])
        decided += int(sure.sum())
        jl, jc = jmodel.model_forward(
            params, jcfg, jnp.asarray(got[:, step:step + 1]), cache=jc,
            mode="decode")
    assert decided > 0


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_prefill_then_a_step_matches_a_longer_prefill(fp32, arch):
    """The conv and SSM caches carry a prefill of S - 1 tokens into one
    decode step that reads as the prefill of S (phase 16's check)."""
    cfg = get_smoke_config(arch)
    model = tmodel.params_from_numpy(
        cfg, _reference_params(jget_smoke(arch), 6), device="cpu")
    tokens = t(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                 (2, PROMPT)))
    want, _ = tmodel.model_forward(model, cfg, tokens, mode="prefill")
    _, cache = tmodel.model_forward(model, cfg, tokens[:, :-1],
                                    mode="prefill", max_len=PROMPT)
    got, _ = tmodel.model_forward(model, cfg, tokens[:, -1:], cache=cache,
                                  mode="decode")
    close(got, want.numpy(), scaled_tol(want.numpy(), 1e-4, 1e-5))


@pytest.mark.parametrize("arch", FAMILIES)
def test_caches_and_their_names_match_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    mine = tmodel.init_cache(cfg, 3, 10, device="cpu")
    want = jmodel.init_cache(jcfg, 3, 10)
    assert set(mine) == set(want)
    for nm, v in want.items():
        if nm == "pos":
            assert mine[nm] == int(v) == 0
            continue
        assert tuple(mine[nm].shape) == v.shape, nm
        assert str(mine[nm].dtype).split(".")[-1] == str(v.dtype), nm
        assert not mine[nm].any()
    assert tmodel.cache_logical(cfg) == jmodel.cache_logical(jcfg)
    assert tmodel.param_logical(cfg) == jmodel.param_logical(jcfg)
    batch = demo_batch(cfg, "decode", 2, 12, torch.Generator().manual_seed(0))
    logits, cache = tmodel.model_forward(tmodel.init_params(
        cfg, device="cpu"), cfg, batch["tokens"], cache=batch["cache"],
        mode="decode")
    assert logits.shape == (2, 1, cfg.vocab_padded) and cache["pos"] == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_weights_carry_across_bit_for_bit(arch):
    """The reference's init dict of every key through ``params_from_numpy``
    at fp32, ``params_to_numpy`` and back; the stored dtypes: norm scales
    and the SSM's fp32 keys fp32 whatever the compute dtype."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    params = _reference_params(jcfg, 2)
    assert set(params) == set(tmodel._schema(cfg))
    model = tmodel.params_from_numpy(cfg, params, device="cpu",
                                     dtype=torch.float32)
    back = tmodel.params_to_numpy(model)
    assert set(back) == set(params)
    for name, v in params.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)
    named = {n: p.detach() for n, p in model.named_parameters()}
    again = tmodel.unstack_layers(cfg, tmodel.stack_layers(cfg, named))
    assert set(again) == set(named)
    assert all(torch.equal(again[n], named[n]) for n in named)
    names = dict(tmodel.params_from_numpy(cfg, params,
                                          device="cpu").named_parameters())
    for name, p in names.items():
        key = name.split(".")[-1]
        fp32_key = key in tmodel.NORM_KEYS or key in tmodel.SSM_FP32_KEYS
        assert p.dtype == (torch.float32 if fp32_key else torch.bfloat16), \
            name


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_follows_the_reference_rule(arch):
    cfg = get_smoke_config(arch)
    sd = tmodel.init_params(cfg, seed=3, device="cpu").state_dict()
    assert set(k.split(".")[-1] for k in sd) == set(
        jmodel._schema(jget_smoke(arch)))
    for name, v in sd.items():
        key = name.split(".")[-1]
        if key in ("ssm_A_log", "ssm_dt_bias", "ssm_D"):
            assert bool((v == 0.5).all()), name
        elif key in ("ln1", "ln2", "ssm_norm", "ssm_conv_b", "bq", "bk",
                     "bv", "final_norm"):
            assert not v.any(), name
        else:
            assert v.float().std() > 0, name


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b",
                                  "qwen2-moe-a2.7b"])
def test_launch_serve_demo_serves_the_families_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--demo", "--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--steps", "3"])
    assert "on cpu: 6 tokens" in capsys.readouterr().out
