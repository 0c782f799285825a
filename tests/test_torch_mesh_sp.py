"""The port's sequence options across processes against the JAX package, on
the CPU: ``ulysses_attn`` (DeepSpeed-Ulysses attention, in training and
prefill) and ``seq_sharded`` (Megatron-SP's sequence-sharded carry, in
training) on (data, model) device meshes.

The port runs in 4 processes of one ``gloo`` group a mesh
(``tests/torch_mesh_worker.py``, ``sp_runs``: one spawn for (2, 2) and one
for (1, 4), every case of that mesh in it); the reference runs in a
subprocess with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on the same
meshes, the same options flipped on its config by ``dataclasses.replace``.
Both take the same numpy inputs at fp32: the smoke configs of Qwen2-7B (2
KV heads, which do not divide 4), Granite-20B (MQA), Gemma3-4B (window 16
at 40 positions), Qwen2-MoE-A2.7B and Whisper-small (cross-attention),
``torch_mesh_worker.SP_ARCHS``, each with ``ulysses_attn``, with
``seq_sharded`` and with both.  Tolerances, those of
``tests/test_torch_mesh_train.py`` and ``tests/test_torch_mesh_families.py``
for the same configs without the options:

* one ``make_train_step`` step: the loss within 1e-4 relative of the
  reference's loss on the same mesh with the same options (its sharded
  gradients are scaled: ROADMAP C, so the gradients are held against the
  port's unsharded step); against the port's unsharded step the loss
  within 1e-5 relative, the gradients it applied within 1e-5 of each
  tensor's largest magnitude, the parameters after it within 2 lr;
* the prefill under ``serve_tp`` with ``ulysses_attn`` (``seq_sharded``
  acts in training only, as in the reference): the last-position logits
  within 1e-4 of their largest magnitude of the reference's on the same
  mesh and of the unsharded port's, the caches (each process's shard
  written from k and v whole over ``model``) within 1e-5 of both;
* placements and offsets, exactly: inside the flash wrappers q is split by
  sequence over ``model`` and k/v are whole over it, each process passes
  ``q_offset`` = its rank over ``model`` x the local Sq under ``causal``
  (0 for the cross-attention); a layer's output under ``seq_sharded`` sits
  on ("batch", "seq_sp", None); no parameter is gathered whole over
  ``model`` that the same step without the options does not gather (and
  ``CommDebugMode`` counts the collectives the options add); a
  sequence that ``model`` does not divide runs the heads route at offset
  0 with the unsharded logits.

On one process, the plain flash route on q split into 4 sequence pieces,
each at its offset against k/v whole, concatenated (dk/dv summed), is the
unsplit route in fp32, forward and backward.  Every block, the SSM and
hybrid ones too, is admitted on a device mesh with either option (those
two run with the options in ``tests/test_torch_mesh_ssm.py``).
"""
import ast
import os
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.dryrun import serve_tp_rules  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as tsharding  # noqa: E402
from repro_torch.serve import step as sstep  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
NAMES = ("data", "model")
ARCHS = list(worker.SP_ARCHS)
OPTIONS = list(worker.SP_OPTIONS)
TAGS = [worker.tag(s) for s in worker.MESHES]
B, S, ODD = worker.SP_BATCH, worker.SP_SEQ, worker.SP_ODD_SEQ
LOGIT_FRAC, CACHE_FRAC, GRAD_FRAC = 1e-4, 1e-5, 1e-5
OCFG = tadamw.OptimConfig(warmup_steps=1, decay_steps=10)

_REFERENCE = """
import contextlib, os, sys
# XLA unoptimised and without multi-threaded Eigen: the programs are
# tiny, and the suite runs several processes at once
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_cpu_multi_thread_eigen=false")
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_smoke_config
from repro.models import model as jmodel
from repro.parallel import sharding as jsharding
from repro.parallel.sharding import logical_spec
from repro.serve import step as sstep
from torch_mesh_worker import (MESHES, SP_ARCHS, SP_OPTIONS, SP_SEQ,
                               sp_config)
assert len(jax.devices()) == 4, jax.devices()
jmodel.COMPUTE_DTYPE = jnp.float32
data = dict(np.load(sys.argv[1]))
names = {"tokens": ("batch", None), "labels": ("batch", None),
         "frames": ("batch", None, None)}
out = {}
for arch in SP_ARCHS:
    key = arch + "/p/"
    params = {k[len(key):]: jnp.asarray(v) for k, v in data.items()
              if k.startswith(key)}
    train = {k: jnp.asarray(data[arch + "/train/" + k])
             for k in ("tokens", "labels", "frames")
             if arch + "/train/" + k in data}
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        put = lambda v, n: jax.device_put(
            v, NamedSharding(mesh, logical_spec(v.shape, n)))
        for opts in SP_OPTIONS:
            cfg = sp_config(arch, opts, get_smoke_config)
            logical = jmodel.param_logical(cfg)
            jsharding.set_rules(dict(jsharding.DEFAULT_RULES))
            with jax.set_mesh(mesh):
                p = {k: put(v, logical[k]) for k, v in params.items()}
                b = {k: put(v, names[k]) for k, v in train.items()}
                loss = jax.jit(lambda p, b: jmodel.lm_loss(p, cfg, b)[0])(
                    p, b)
                out[f"{tag}/{arch}/{opts}/loss"] = np.asarray(loss)
            if opts != "ulysses":
                continue
            jsharding.set_rules(dict(jsharding.DEFAULT_RULES, fsdp=None))
            with jax.set_mesh(mesh):
                p = {k: put(v, logical[k]) for k, v in params.items()}
                batch = {"tokens": put(jnp.asarray(data[arch + "/tokens"]),
                                       names["tokens"])}
                if arch + "/frames" in data:
                    batch["frames"] = put(jnp.asarray(data[arch + "/frames"]),
                                          names["frames"])
                logits, cache = jax.jit(sstep.make_prefill_step(
                    cfg, max_len=SP_SEQ + 2))(p, batch)
                out[f"{tag}/{arch}/prefill_logits"] = np.asarray(logits)
                for nm in ("k", "v", "xk", "xv"):
                    if nm in cache:
                        out[f"{tag}/{arch}/prefill_cache/{nm}"] = np.asarray(
                            cache[nm])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs(path: str) -> dict:
    """Seeded numpy inputs for every configuration: its parameters (norm
    scales and biases random too), a train batch (labels rolled, three
    masked), prompts and, for Whisper, frame embeddings; prompts of
    :data:`ODD` positions for the fallback."""
    rng = np.random.default_rng(31)
    d = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for k, t in tmodel.abstract_params(cfg).items():
            scale = 0.3 if k in tmodel.NORM_KEYS or k in ("bq", "bk", "bv") \
                else 0.02
            d[f"{arch}/p/{k}"] = (rng.standard_normal(tuple(t.shape)) * scale
                                  ).astype(np.float32)
        tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[0, :3] = -1
        d[f"{arch}/train/tokens"], d[f"{arch}/train/labels"] = tok, lab
        d[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                           ).astype(np.int32)
        if cfg.enc_dec:
            for key in ("frames", "train/frames"):
                d[f"{arch}/{key}"] = (rng.standard_normal(
                    (B, cfg.enc_frames, cfg.d_model)) * 0.02
                    ).astype(np.float32)
    d["odd/tokens"] = rng.integers(
        0, get_smoke_config("qwen2_7b").vocab_size, (B, ODD)).astype(np.int32)
    np.savez(path, **d)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's two spawns (one a mesh)
    side by side: (inputs, reference results, the port's results by mesh
    tag)."""
    tmp = tmp_path_factory.mktemp("sp")
    src, ref = str(tmp / "in.npz"), str(tmp / "ref.npz")
    inputs = _inputs(src)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [SRC, TESTS] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, src, ref],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    errors = []

    def one(shape):
        try:
            worker.spawn(worker.sp_runs, 4, shape, src,
                         str(tmp / f"{worker.tag(shape)}.npz"))
        except Exception as exc:     # noqa: BLE001 - re-raised below
            errors.append(exc)
    threads = [threading.Thread(target=one, args=(s,))
               for s in worker.MESHES]
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            th.join(timeout=900)
        out, err = proc.communicate(timeout=600)
    assert not any(th.is_alive() for th in threads), "a spawn hung"
    assert not errors, errors
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    port = {worker.tag(s): dict(np.load(str(tmp / f"{worker.tag(s)}.npz")))
            for s in worker.MESHES}
    return inputs, dict(np.load(ref)), port


def _unsharded_step(cfg, inputs: dict, arch: str) -> dict:
    """One ``make_train_step`` step of ``cfg`` on one process, unsharded:
    its loss, the gradients it applied and the parameters after it, the
    reference's flat names."""
    flat = {k[len(arch) + 3:]: v for k, v in inputs.items()
            if k.startswith(f"{arch}/p/")}
    params = tmodel.params_from_numpy(cfg, flat, device="cpu",
                                      dtype=torch.float32)
    batch = {k: torch.from_numpy(inputs[f"{arch}/train/{k}"])
             for k in ("tokens", "labels", "frames")
             if f"{arch}/train/{k}" in inputs}
    applied = {}
    saved = tstep.apply_updates

    def keep(named, grads, opt_state, *a, **kw):
        applied.update({n: g.clone() for n, g in grads.items()})
        return saved(named, grads, opt_state, *a, **kw)
    tstep.apply_updates = keep
    try:
        params, _, metrics = tstep.make_train_step(
            cfg, tstep.TrainConfig(OCFG))(
            params, tadamw.init_opt_state(params, OCFG), batch)
    finally:
        tstep.apply_updates = saved
    named = {n: p.detach() for n, p in params.named_parameters()}
    return {"loss": float(metrics["loss"]),
            "g": {k: v.numpy() for k, v in
                  tmodel.stack_layers(cfg, applied).items()},
            "p": {k: v.numpy() for k, v in
                  tmodel.stack_layers(cfg, named).items()}}


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port on one process, unsharded, at fp32 from the same inputs,
    without the options: per configuration one train step
    (:func:`_unsharded_step`) and the prefill's logits and caches;
    Qwen2-7B's prefill at :data:`ODD` positions."""
    inputs = runs[0]
    saved = tmodel.COMPUTE_DTYPE
    tmodel.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            out[arch] = _unsharded_step(cfg, inputs, arch)
            flat = {k[len(arch) + 3:]: v for k, v in inputs.items()
                    if k.startswith(f"{arch}/p/")}
            params = tmodel.params_from_numpy(cfg, flat, device="cpu",
                                              dtype=torch.float32)
            extra = ({"frames": torch.from_numpy(inputs[f"{arch}/frames"])}
                     if cfg.enc_dec else {})
            logits, cache = sstep.make_prefill_step(cfg, max_len=S + 2)(
                params, {"tokens": torch.from_numpy(inputs[f"{arch}/tokens"]),
                         **extra})
            out[arch]["prefill_logits"] = logits.numpy()
            for nm in ("k", "v", "xk", "xv"):
                if nm in cache:
                    out[arch][f"prefill_cache/{nm}"] = cache[nm].numpy()
            if arch == "qwen2_7b":
                logits, _ = sstep.make_prefill_step(cfg)(params, {
                    "tokens": torch.from_numpy(inputs["odd/tokens"])})
                out["odd/prefill_logits"] = logits.numpy()
    finally:
        tmodel.COMPUTE_DTYPE = saved
    return out


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _close(got, want, frac: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=what)


def _want_placements(shape: tuple, dims, logical) -> str:
    """The placements the port's rules give ``dims`` under ``logical`` on
    an abstract mesh of ``shape``."""
    return repr(tuple(tsharding.mesh_placements(
        dims, logical, tmesh.AbstractMesh(shape, NAMES))))


# ------------------------------------------------------------ training
@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_the_reference_on_the_mesh(runs, arch, opts,
                                                      mesh):
    _, ref, port = runs
    assert _rel(port[mesh][f"{arch}/{opts}/loss"],
                ref[f"{mesh}/{arch}/{opts}/loss"]) <= 1e-4


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_unsharded_step(runs, unsharded, arch, opts,
                                               mesh):
    """The loss, every gradient the step applied and every parameter after
    it against the port's unsharded step without the options."""
    _, _, port = runs
    got, want = port[mesh], unsharded[arch]
    assert _rel(got[f"{arch}/{opts}/loss"], want["loss"]) <= 1e-5
    lr = OCFG.peak_lr             # the first step's rate, warmup 1
    assert sorted(want["g"]) == sorted(tmodel.abstract_params(
        get_smoke_config(arch)))
    for k in want["g"]:
        _close(got[f"{arch}/{opts}/g/{k}"], want["g"][k], GRAD_FRAC,
               f"{arch} {opts} grad {k}")
        np.testing.assert_allclose(got[f"{arch}/{opts}/p/{k}"], want["p"][k],
                                   rtol=0, atol=2 * lr, err_msg=k)


def test_options_leave_the_one_device_step_alone(runs, monkeypatch):
    """Off a device mesh both options are identities: Qwen2-7B's and
    Whisper's unsharded steps with them are the steps without, bit for
    bit."""
    inputs = runs[0]
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    for arch in ("qwen2_7b", "whisper_small"):
        plain = _unsharded_step(get_smoke_config(arch), inputs, arch)
        both = _unsharded_step(worker.sp_config(arch, "both",
                                                get_smoke_config),
                               inputs, arch)
        assert plain["loss"] == both["loss"]
        for what in ("g", "p"):
            for k, v in plain[what].items():
                np.testing.assert_array_equal(both[what][k], v, err_msg=k)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ulysses_prefill_matches_the_reference_and_the_unsharded_port(
        runs, unsharded, arch, mesh):
    _, ref, port = runs
    got = port[mesh]
    logits = got[f"{arch}/serve/prefill_logits"]
    assert logits.shape == (B, 1, get_smoke_config(arch).vocab_padded)
    _close(logits, ref[f"{mesh}/{arch}/prefill_logits"], LOGIT_FRAC, arch)
    _close(logits, unsharded[arch]["prefill_logits"], LOGIT_FRAC, arch)
    names = [k.rsplit("/", 1)[1] for k in ref
             if k.startswith(f"{mesh}/{arch}/prefill_cache/")]
    assert sorted(names) == (["k", "v", "xk", "xv"] if arch == "whisper_small"
                             else ["k", "v"])
    for nm in names:
        for want in (ref[f"{mesh}/{arch}/prefill_cache/{nm}"],
                     unsharded[arch][f"prefill_cache/{nm}"]):
            _close(got[f"{arch}/serve/prefill_cache/{nm}"], want,
                   CACHE_FRAC, f"{arch} cache {nm}")


# ---------------------------------------------------------- placements
def _flash_calls(text) -> list:
    """Every process's recorded flash calls, in rank order."""
    return ast.literal_eval(str(text))


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("when", ["serve", "ulysses", "both"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_runs_on_sequence_shards_at_their_offsets(runs, arch, when,
                                                        mesh):
    """Each process's flash calls (the prefill's; in training the forward,
    the recompute and the backward): q of its batch rows and its slice of
    the sequence with every head, k/v of every position and KV head, and
    ``q_offset`` = its rank over ``model`` x the local Sq where causal, 0
    for the bidirectional cross-attention."""
    _, _, port = runs
    cfg = get_smoke_config(arch)
    dp, tp = (int(s) for s in mesh.split("x"))
    key = f"{arch}/serve/flash" if when == "serve" else f"{arch}/{when}/flash"
    calls = _flash_calls(port[mesh][key])
    assert len(calls) == dp * tp
    n_dec = cfg.num_layers * (2 if cfg.enc_dec else 1)
    per = {"fwd": 1} if when == "serve" else {"fwd": 2, "bwd": 1}
    for rank, seen in enumerate(calls):
        # the encoder's own attention (Whisper) runs the heads route
        dec = [c for c in seen
               if not (cfg.enc_dec and c[2][1] == cfg.enc_frames)]
        for kind, n in per.items():
            assert sum(c[0] == kind for c in dec) == n * n_dec
            assert sum(c[0] == kind for c in seen) == n * (
                n_dec + (cfg.enc_layers if cfg.enc_dec else 0))
        m = rank % tp                 # the rank over ``model``
        for kind, typ, q, k, offset, causal in dec:
            assert typ == "Tensor"
            skv = S if causal else cfg.enc_frames
            assert q == (B // dp, S // tp, cfg.num_heads, cfg.head_dim)
            assert k == (B // dp, skv, cfg.num_kv_heads, cfg.head_dim)
            assert offset == (m * (S // tp) if causal else 0), (rank, kind)
            assert causal or cfg.enc_dec


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("opts", ["seq", "both"])
@pytest.mark.parametrize("arch", ARCHS)
def test_carry_sits_sequence_sharded(runs, arch, opts, mesh):
    """Under ``seq_sharded`` every layer's output (the next layer's input,
    the remat-saved carry; a forward hook sees the forward's, and the
    recompute's where it runs to the layer's end) is placed on ("batch", "seq_sp", None), as the
    reference's constraint says; without it, ``ulysses_attn`` alone leaves
    the carry's sequence whole."""
    _, _, port = runs
    cfg = get_smoke_config(arch)
    shape = tuple(int(s) for s in mesh.split("x"))
    want = _want_placements(shape, (B, S, cfg.d_model), tmodel.SEQ_SP)
    carry = ast.literal_eval(str(port[mesh][f"{arch}/{opts}/carry"]))
    assert len(carry) >= cfg.num_layers      # the forward (and recompute)
    assert set(carry) == {want}
    assert "Shard(dim=1)" in want
    alone = ast.literal_eval(str(port[mesh][f"{arch}/ulysses/carry"]))
    assert not any("Shard(dim=1)" in c for c in alone)


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_parameter_is_gathered_over_model_by_the_options(runs, arch, opts,
                                                            mesh):
    """Every redistribution of one train step that takes a tensor of a
    parameter's shape from a shard over ``model`` to whole there is one
    the same step without the options makes too: the options gather
    activations (the sequence before the products, k and v for Ulysses),
    never weights."""
    _, _, port = runs
    got = set(port[mesh][f"{arch}/{opts}/gathered"].tolist())
    base = set(port[mesh][f"{arch}/none/gathered"].tolist())
    assert got <= base, sorted(got - base)


@pytest.mark.parametrize("mesh", TAGS)
def test_the_options_change_the_collectives_of_a_step(runs, mesh):
    """``CommDebugMode``'s counts of one train step of Qwen2-7B, with no
    option and with both: every kind is counted, and the options change
    them (on (2, 2) the step without them made 80 all-gathers, 82
    all-reduces and 61 reduce-scatters on ``gloo``, with both 77, 54 and
    29: the explicit gathers of the sequence take the place of the
    propagator's reshards of the products' partial sums)."""
    _, _, port = runs
    none, both = (dict(ast.literal_eval(str(
        port[mesh][f"{worker.SP_COMM_ARCH}/{o}/comm"])))
        for o in ("none", "both"))
    assert all(none.values()) and all(both.values()), (none, both)
    assert none != both, none


@pytest.mark.parametrize("mesh", TAGS)
def test_indivisible_sequence_falls_back_to_the_heads_route(runs, unsharded,
                                                            mesh):
    """At 41 positions, which ``model`` does not divide, ``ulysses_attn``'s
    constraint leaves q's sequence whole: each process runs its heads (or
    all of them, where the KV heads do not divide ``model``) over the
    whole sequence at offset 0, and the logits are the unsharded port's."""
    _, _, port = runs
    cfg = get_smoke_config("qwen2_7b")
    dp, tp = (int(s) for s in mesh.split("x"))
    split = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    h, kv = ((cfg.num_heads // tp, cfg.num_kv_heads // tp) if split
             else (cfg.num_heads, cfg.num_kv_heads))
    for seen in _flash_calls(port[mesh]["odd/flash"]):
        assert seen == [("fwd", "Tensor", (B // dp, ODD, h, cfg.head_dim),
                         (B // dp, ODD, kv, cfg.head_dim), 0, True)
                        ] * cfg.num_layers
    _close(port[mesh]["odd/prefill_logits"], unsharded["odd/prefill_logits"],
           LOGIT_FRAC, "fallback")


# ------------------------------------------------------- one process
@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
def test_plain_flash_on_sequence_pieces_is_the_whole(mask):
    """The plain flash route (the wrappers on CPU tensors) on q split into
    4 sequence pieces, each at its offset against k/v whole: the pieces'
    outputs concatenated and their dk/dv summed equal the unsplit route in
    fp32 within 1e-6 of the largest magnitude, forward and backward; keys
    past a piece's last query get exactly zero dk and dv from it."""
    from repro_torch.models import flash as tflash
    rng = np.random.default_rng(5)
    Bq, Sq, H, KV, hd = 2, 64, 4, 2, 16
    causal = mask != "bidirectional"
    window = 24 if mask == "window" else None

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_()
    q, k, v = t(Bq, Sq, H, hd), t(Bq, Sq, KV, hd), t(Bq, Sq, KV, hd)
    dout = torch.from_numpy(rng.standard_normal((Bq, Sq, H, hd)).astype(
        np.float32))
    whole = tflash.flash_attention_vjp(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(whole, (q, k, v), dout)
    n = 4
    step = Sq // n
    outs, dq, dk, dv = [], [], 0, 0
    for i in range(n):
        qi = q.detach()[:, i * step:(i + 1) * step].clone().requires_grad_()
        ki, vi = (x.detach().clone().requires_grad_() for x in (k, v))
        o = tflash.flash_attention_vjp(qi, ki, vi, causal=causal,
                                       window=window,
                                       q_offset=i * step if causal else 0)
        g = torch.autograd.grad(o, (qi, ki, vi),
                                dout[:, i * step:(i + 1) * step])
        if causal:                     # no query of this piece sees them
            assert not g[1][:, (i + 1) * step:].any()
            assert not g[2][:, (i + 1) * step:].any()
        outs.append(o.detach())
        dq.append(g[0])
        dk, dv = dk + g[1], dv + g[2]
    for got, w in ((torch.cat(outs, 1), whole.detach()),
                   (torch.cat(dq, 1), want[0]), (dk, want[1]),
                   (dv, want[2])):
        tol = 1e-6 * float(w.abs().max())
        assert float((got - w).abs().max()) <= tol


@pytest.mark.parametrize("opts", [None, *OPTIONS])
@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_every_block_is_admitted_with_every_option(arch, opts):
    """``device_mesh_for`` admits every block on a device mesh with either
    sequence option, both or none: the SSM (Mamba2) and hybrid (Hymba)
    blocks as every attention family (no process group is needed to
    decide), and places nothing off one."""
    mesh = tmesh.DistMesh((1,), ("data",), None, torch.device("cpu"))
    for name in (arch, *ARCHS):
        cfg = worker.sp_config(name, opts, get_smoke_config)
        assert tmodel.device_mesh_for(cfg, mesh) is mesh
        assert tmodel.device_mesh_for(cfg, tmesh.AbstractMesh(
            (1, 4), NAMES)) is None
        assert tmodel.device_mesh_for(cfg, None) is None


def test_sequence_rules_are_the_references():
    """``seq_sp`` maps to ``model`` under both rule sets, and the
    divisibility guard applies per tensor: 40 positions split over 4,
    41 stay whole.  A dimension of extent 1 (Granite's one KV head on a
    ``model`` axis of one device, which the guard gives it) is placed
    whole: the same layout, one DTensor can flatten."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.AbstractMesh((1, 4), NAMES)
    for rules in (tsharding.DEFAULT_RULES, serve_tp_rules()):
        assert rules["seq_sp"] == "model"
    with tmesh.set_mesh(mesh):
        assert tsharding.logical_spec((4, 40, 8, 16), (
            "batch", "seq_sp", None, None)) == ("data", "model", None, None)
        assert tsharding.logical_spec((4, 41, 8, 16), (
            "batch", "seq_sp", None, None)) == ("data", None, None, None)
    one = tmesh.AbstractMesh((1, 1), NAMES)
    wk = (64, 1, 16)
    with tmesh.set_mesh(one):
        assert tsharding.logical_spec(wk, ("fsdp", "kv_heads", "head_dim")
                                      ) == ("data", "model", None)
    assert tsharding.mesh_placements(wk, ("fsdp", "kv_heads", "head_dim"),
                                     one) == [Shard(0), Replicate()]
