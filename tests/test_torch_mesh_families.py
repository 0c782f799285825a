"""The port's MoE and encoder-decoder families across processes against the
JAX package, on the CPU: served under the reference's ``serve_tp`` rules
and trained under its default rules on (data, model) device meshes.

The port runs in 4 processes of one ``gloo`` group a mesh
(``tests/torch_mesh_worker.py``, ``family_runs``: one spawn for (2, 2) and
one for (1, 4), every case of that mesh in it); the reference runs in a
subprocess a case with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on the same meshes
and on one device.  Both take the same numpy inputs at fp32.  The cases
(``torch_mesh_worker.FAMILY_CASES``): the smoke configs of Qwen2-MoE
(shared experts, ``qkv_bias``; 8 experts, 2 a process on (1, 4): expert
parallelism), Granite-MoE (no shared experts, ``router_norm``, tied head,
2 KV heads that do not divide 4) and Whisper-small (encoder, cross
attention, the ``xk``/``xv`` caches); Qwen2-MoE with 6 experts on (1, 4),
which ``model`` does not divide, so ``expert_mlp`` takes it (tensor
parallelism inside each expert); Qwen2-MoE at capacity factor 0.5, whose
drops are counted in global token order across the data shards on
(2, 2).  Tolerances:

* the prefill's last-position logits and each decode step's: within 1e-4
  of their largest magnitude, against the reference on the same mesh and
  on one device; the caches within 1e-5; greedy ids equal to the
  reference's one-device loop and the unsharded port's on decided rows;
* the routing (every MoE call's experts, ``pos``, ``keep`` and drop
  count, the prefill's and the train forward's, the remat recompute's
  equal to the forward's): equal to the unsharded port's on one process;
* one train step: against the reference's one-device step the loss and
  ``grad_norm`` within 1e-4 relative, the parameters within 2 lr, the
  moments within 1e-3 of each tensor's largest magnitude; the loss within
  1e-4 relative of the reference's step on the same mesh (its sharded
  gradients are off: ``tests/test_torch_mesh_train.py``); two runs of
  the loss and backward bit-identical;
* placements, each process's local bytes against the dry run's
  ``serve_arg_bytes``, the experts' blocks each process ran and the
  (2, 2) checkpoint restored on (4, 1): exact.
"""
import ast
import os
import subprocess
import sys
import textwrap
import threading

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402,F401
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as tsharding  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
NAMES = ("data", "model")
B, S, STEPS = worker.SERVE_BATCH, worker.SERVE_SEQ, worker.SERVE_STEPS
TB, TS = worker.FAMILY_TRAIN_BATCH, worker.FAMILY_TRAIN_SEQ
LOGIT_FRAC, CACHE_FRAC = 1e-4, 1e-5
OCFG = tadamw.OptimConfig(warmup_steps=1, decay_steps=10)
PAIRS = [(case, worker.tag(m)) for case, meshes in worker.FAMILY_CASES.items()
         for m in meshes]
MOE_PAIRS = [(c, m) for c, m in PAIRS if c != "whisper"]


def _cfg(case: str):
    return worker.family_config(case, get_smoke_config)


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
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding
from repro.parallel.sharding import logical_spec
from repro.serve import step as sstep
from repro.train import step as jstep
from torch_mesh_worker import (FAMILY_CASES, SERVE_BATCH, SERVE_SEQ,
                               SERVE_STEPS, family_config)
assert len(jax.devices()) == 4, jax.devices()
jmodel.COMPUTE_DTYPE = jnp.float32
data = dict(np.load(sys.argv[1]))
S, STEPS = SERVE_SEQ, SERVE_STEPS
ocfg = jadamw.OptimConfig(warmup_steps=1, decay_steps=10)
names = {"tokens": ("batch", None), "labels": ("batch", None),
         "frames": ("batch", None, None)}
out = {}
for case in sys.argv[3:]:
    meshes = FAMILY_CASES[case]
    cfg = family_config(case, get_smoke_config)
    logical = jmodel.param_logical(cfg)
    key = case + "/p/"
    params = {k[len(key):]: jnp.asarray(v) for k, v in data.items()
              if k.startswith(key)}
    cache_names = [n for n in ("k", "v", "xk", "xv")
                   if n in jmodel.cache_logical(cfg)]
    extra = ({"frames": jnp.asarray(data[case + "/frames"])}
             if cfg.enc_dec else {})
    train = {k: jnp.asarray(data[case + "/train/" + k])
             for k in ("tokens", "labels", "frames")
             if case + "/train/" + k in data}
    for shape in tuple(meshes) + (None,):
        tag = "x".join(map(str, shape)) if shape else "one"
        for rules in ("serve", "train"):
            jsharding.set_rules(dict(jsharding.DEFAULT_RULES, fsdp=None)
                                if rules == "serve"
                                else dict(jsharding.DEFAULT_RULES))
            ctx, put = contextlib.nullcontext(), lambda v, n: v
            if shape:
                mesh = jax.make_mesh(shape, ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2)
                ctx = jax.set_mesh(mesh)
                put = lambda v, n: jax.device_put(
                    v, NamedSharding(mesh, logical_spec(v.shape, n)))
            with ctx:
                p = {k: put(v, logical[k]) for k, v in params.items()}
                if rules == "train":
                    b = {k: put(v, names[k]) for k, v in train.items()}
                    step = jax.jit(jstep.make_train_step(
                        cfg, jstep.TrainConfig(ocfg)))
                    p2, o2, m = step(p, jadamw.init_opt_state(p, ocfg), b)
                    out[f"{tag}/{case}/loss"] = np.asarray(m["loss"])
                    out[f"{tag}/{case}/grad_norm"] = np.asarray(
                        m["grad_norm"])
                    for k in p2:
                        out[f"{tag}/{case}/p/{k}"] = np.asarray(p2[k])
                        if shape is None:
                            out[f"{tag}/{case}/m/{k}"] = np.asarray(
                                o2["m"][k])
                            out[f"{tag}/{case}/v/{k}"] = np.asarray(
                                o2["v"][k])
                    continue
                batch = {k: put(v, names[k]) for k, v in extra.items()}
                batch["tokens"] = put(jnp.asarray(data[case + "/tokens"]),
                                      names["tokens"])
                prefill = jax.jit(sstep.make_prefill_step(
                    cfg, max_len=S + STEPS))
                decode = jax.jit(sstep.make_decode_step(cfg))
                logits, cache = prefill(p, batch)
                out[f"{tag}/{case}/prefill_logits"] = np.asarray(logits)
                for nm in cache_names:
                    out[f"{tag}/{case}/prefill_cache/{nm}"] = np.asarray(
                        cache[nm])
                if shape is None:
                    c, lg, ids, all_lg = cache, logits, [], []
                    for i in range(STEPS):
                        all_lg.append(np.asarray(lg[:, -1]))
                        ids.append(jnp.argmax(lg[:, -1, :cfg.vocab_size], -1))
                        if i < STEPS - 1:
                            lg, c = decode(p, {"tokens": ids[-1][:, None],
                                               "cache": c})
                    out[f"{tag}/{case}/greedy"] = np.asarray(
                        jnp.stack(ids, 1))
                    out[f"{tag}/{case}/greedy_logits"] = np.stack(all_lg)
                dec = []
                for i in range(STEPS - 1):
                    logits, cache = decode(p, {
                        "tokens": put(jnp.asarray(data[case + "/decode"][i]),
                                      names["tokens"]), "cache": cache})
                    dec.append(np.asarray(logits))
                out[f"{tag}/{case}/decode_logits"] = np.stack(dec)
                out[f"{tag}/{case}/pos"] = np.asarray(cache["pos"])
                for nm in cache_names:
                    out[f"{tag}/{case}/decode_cache/{nm}"] = np.asarray(
                        cache[nm])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs(path: str) -> dict:
    """Seeded numpy inputs for every case: its parameters (norm scales and
    biases random too), prompts, the decode steps' tokens, a train batch
    (labels rolled, three masked) and, for Whisper, frame embeddings."""
    rng = np.random.default_rng(29)
    d = {}
    for case in worker.FAMILY_CASES:
        cfg = _cfg(case)
        for k, t in tmodel.abstract_params(cfg).items():
            scale = 0.3 if k in tmodel.NORM_KEYS or k in ("bq", "bk", "bv") \
                else 0.02
            d[f"{case}/p/{k}"] = (rng.standard_normal(tuple(t.shape)) * scale
                                  ).astype(np.float32)
        d[f"{case}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                           ).astype(np.int32)
        d[f"{case}/decode"] = rng.integers(0, cfg.vocab_size,
                                           (STEPS - 1, B, 1)).astype(np.int32)
        tok = rng.integers(0, cfg.vocab_size, (TB, TS)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[0, :3] = -1
        d[f"{case}/train/tokens"], d[f"{case}/train/labels"] = tok, lab
        if cfg.enc_dec:
            for key, n in (("frames", B), ("train/frames", TB)):
                d[f"{case}/{key}"] = (rng.standard_normal(
                    (n, cfg.enc_frames, cfg.d_model)) * 0.02
                    ).astype(np.float32)
    np.savez(path, **d)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses (one a case: compiling is most of
    their time, and one alone would outlast the spawns) and the port's two
    spawns (one a mesh) side by side: (inputs, reference results, the
    port's results by mesh tag, the checkpoint directory written on
    (2, 2))."""
    tmp = tmp_path_factory.mktemp("families")
    src = str(tmp / "in.npz")
    refs = {case: str(tmp / f"ref_{case}.npz")
            for case in worker.FAMILY_CASES}
    ckpt = str(tmp / "ckpt")
    inputs = _inputs(src)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [SRC, TESTS] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, src, dst,
                               case], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for case, dst in refs.items()]
    errors = []

    def one(shape):
        try:
            worker.spawn(worker.family_runs, 4, shape, src,
                         str(tmp / f"{worker.tag(shape)}.npz"), ckpt)
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
        outs = [proc.communicate(timeout=900) for proc in procs]
    assert not any(th.is_alive() for th in threads), "a spawn hung"
    assert not errors, errors
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0 and "OK" in out, err[-3000:]
    port = {worker.tag(s): dict(np.load(str(tmp / f"{worker.tag(s)}.npz")))
            for s in worker.MESHES}
    ref = {k: v for dst in refs.values() for k, v in np.load(dst).items()}
    return inputs, ref, port, ckpt


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port on one process, unsharded, at fp32 from the same inputs:
    per case the greedy ids, and the routing of the prefill and of the
    train forward (with its remat recompute)."""
    inputs = runs[0]
    saved = tmodel.COMPUTE_DTYPE
    tmodel.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for case in worker.FAMILY_CASES:
            cfg = _cfg(case)
            flat = {k[len(case) + 3:]: v for k, v in inputs.items()
                    if k.startswith(f"{case}/p/")}
            params = tmodel.params_from_numpy(cfg, flat, device="cpu",
                                              dtype=torch.float32)
            frames = ({"frames": torch.from_numpy(inputs[f"{case}/frames"])}
                      if cfg.enc_dec else {})
            tokens = torch.from_numpy(inputs[f"{case}/tokens"])
            calls = []
            undo = worker._record_routing(calls)
            try:
                tstep.make_prefill_step(cfg, max_len=S + STEPS)(
                    params, {"tokens": tokens, **frames})
            finally:
                undo()
            worker._routing_out(out, f"{case}/serve_routing", calls)
            out[f"{case}/greedy"] = tstep.greedy_generate(
                params, cfg, tokens, STEPS, **frames).numpy()
            batch = {k: torch.from_numpy(inputs[f"{case}/train/{k}"])
                     for k in ("tokens", "labels", "frames")
                     if f"{case}/train/{k}" in inputs}
            params.requires_grad_(True)
            calls = []
            undo = worker._record_routing(calls)
            try:
                loss, _ = tmodel.lm_loss(params, cfg, batch)
                loss.backward()
            finally:
                undo()
            out[f"{case}/train_routing_calls"] = len(calls)
            worker._routing_out(out, f"{case}/train_routing", calls)
    finally:
        tmodel.COMPUTE_DTYPE = saved
    return out


def _close(got, want, frac: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=what)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _cache_names(case: str) -> list:
    return [n for n in ("k", "v", "xk", "xv")
            if n in tmodel.cache_logical(_cfg(case))]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("case,mesh", PAIRS)
def test_prefill_logits_match_the_reference_on_the_mesh(runs, case, mesh):
    _, ref, port, _ = runs
    got = port[mesh][f"{case}/prefill_logits"]
    assert got.shape == (B, 1, _cfg(case).vocab_padded)
    _close(got, ref[f"{mesh}/{case}/prefill_logits"], LOGIT_FRAC, case)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_prefill_logits_match_the_reference_on_one_device(runs, case, mesh):
    _, ref, port, _ = runs
    _close(port[mesh][f"{case}/prefill_logits"],
           ref[f"one/{case}/prefill_logits"], LOGIT_FRAC, case)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_caches_and_decode_logits_match_the_reference(runs, case, mesh):
    """The caches (KV, and Whisper's ``xk``/``xv``) after the prefill and
    after 3 decode steps, and those steps' logits, against the reference
    on the same mesh and on one device."""
    _, ref, port, _ = runs
    got = port[mesh]
    assert int(got[f"{case}/pos"]) == S + STEPS - 1
    for want in (mesh, "one"):
        assert int(ref[f"{want}/{case}/pos"]) == S + STEPS - 1
        for when in ("prefill_cache", "decode_cache"):
            for nm in _cache_names(case):
                _close(got[f"{case}/{when}/{nm}"],
                       ref[f"{want}/{case}/{when}/{nm}"], CACHE_FRAC,
                       f"{case} {when} {nm} vs {want}")
        _close(got[f"{case}/decode_logits"],
               ref[f"{want}/{case}/decode_logits"], LOGIT_FRAC,
               f"{case} decode logits vs {want}")


def _decided_prefix(logits: np.ndarray) -> np.ndarray:
    """Per row, the leading greedy steps whose top-2 margin exceeds the
    logits' tolerance."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > LOGIT_FRAC * np.abs(
        logits).max()
    return np.argmin(np.concatenate(
        [decided, np.zeros((1, decided.shape[1]), bool)]), axis=0)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_greedy_tokens_match_on_decided_rows(runs, unsharded, case, mesh):
    _, ref, port, _ = runs
    cfg = _cfg(case)
    got = port[mesh][f"{case}/greedy"]
    assert got.shape == (B, STEPS)
    assert ((0 <= got) & (got < cfg.vocab_size)).all()
    n = _decided_prefix(ref[f"one/{case}/greedy_logits"][..., :cfg.vocab_size])
    assert n.sum() > 0
    for want in (ref[f"one/{case}/greedy"], unsharded[f"{case}/greedy"]):
        for row in range(B):
            np.testing.assert_array_equal(got[row, :n[row]],
                                          want[row, :n[row]])


# ------------------------------------------------------------- routing
def _routing(d: dict, key: str) -> list:
    out, i = [], 0
    while f"{key}/{i}/experts" in d:
        out.append({n: d[f"{key}/{i}/{n}"] for n in ("experts", "pos",
                                                     "keep", "block")})
        i += 1
    return out


@pytest.mark.parametrize("case,mesh", MOE_PAIRS)
@pytest.mark.parametrize("when", ["serve", "train"])
def test_routing_matches_one_device(runs, unsharded, case, mesh, when):
    """Every MoE call's experts (T, k) over the global batch, ``pos``,
    ``keep`` and drop count on the mesh equal the unsharded port's: the
    capacity from the global T, the ranks in global token order; in
    training the remat recompute routes as its forward did."""
    _, _, port, _ = runs
    cfg = _cfg(case)
    key = f"{case}/{when}_routing"
    got, want = _routing(port[mesh], key), _routing(unsharded, key)
    n_calls = cfg.num_layers * (2 if when == "train" else 1)
    assert len(got) == len(want) == n_calls
    T = (B * S) if when == "serve" else (TB * TS)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["experts"].shape == (T, cfg.moe.top_k)
        for n in ("experts", "pos", "keep"):
            np.testing.assert_array_equal(g[n], w[n], err_msg=f"{i} {n}")
    if when == "train":      # the backward recomputes the last layer first
        for g, r in zip(got[:cfg.num_layers], got[cfg.num_layers:][::-1]):
            for n in ("experts", "pos", "keep"):
                np.testing.assert_array_equal(g[n], r[n])
    drops = [int((~g["keep"]).sum()) for g in got]
    if cfg.moe.capacity_factor < 1:
        assert min(drops) > 0, drops


@pytest.mark.parametrize("case,mesh", MOE_PAIRS)
def test_each_process_runs_only_its_own_experts(runs, case, mesh):
    """The weights each process's expert block read and the buffer block
    it ran: its own experts (all of them, with a slice of ``expert_mlp``,
    where ``model`` does not divide the experts) and its slice of the
    capacity over ``data``, the tokens gathered whole."""
    _, _, port, _ = runs
    cfg = _cfg(case)
    dp, tp = (int(s) for s in mesh.split("x"))
    E, d, fe = cfg.moe.padded_experts(), cfg.d_model, cfg.moe.d_ff_expert
    ep = E % tp == 0
    for when, T in (("serve", B * S), ("train", TB * TS)):
        for g in _routing(port[mesh], f"{case}/{when}_routing"):
            C = tmoe._capacity(T, cfg.moe.top_k, cfg.moe.num_experts,
                               cfg.moe.capacity_factor)
            w_in, w_out, rows, cols, xf = ast.literal_eval(str(g["block"]))
            n_e, f = (E // tp, fe) if ep else (E, fe // tp)
            assert w_in == (n_e, d, f) and w_out == (n_e, f, d)
            assert rows == (0, n_e)         # rank 0's experts
            assert cols == (0, C // dp)     # rank 0's capacity slots
            assert xf == (T, d)


# ------------------------------------------------------------ training
def _close_state(port: dict, ref: dict, case: str, mesh: str,
                 moments: bool) -> None:
    lr = OCFG.peak_lr            # the first step's rate, warmup 1
    names = sorted(tmodel.abstract_params(_cfg(case)))
    for k in names:
        np.testing.assert_allclose(port[f"{case}/p/{k}"],
                                   ref[f"{mesh}/{case}/p/{k}"], rtol=0,
                                   atol=2 * lr, err_msg=k)
        for mom in ("m", "v") if moments else ():
            w = ref[f"{mesh}/{case}/{mom}/{k}"]
            np.testing.assert_allclose(
                port[f"{case}/{mom}/{k}"], w, rtol=0,
                atol=1e-3 * float(np.abs(w).max()), err_msg=f"{mom} {k}")


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_train_step_matches_the_reference_on_one_device(runs, case, mesh):
    _, ref, port, _ = runs
    got = port[mesh]
    assert _rel(got[f"{case}/loss"], ref[f"one/{case}/loss"]) <= 1e-4
    assert _rel(got[f"{case}/grad_norm"],
                ref[f"one/{case}/grad_norm"]) <= 1e-4
    _close_state(got, ref, case, "one", moments=True)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_train_step_matches_the_reference_on_the_mesh(runs, case, mesh):
    """The loss and the updated parameters of the reference's step on the
    same mesh (the first Adam update is g / |g|, so its sharded
    gradients' scale does not move the parameters)."""
    _, ref, port, _ = runs
    got = port[mesh]
    assert _rel(got[f"{case}/loss"], ref[f"{mesh}/{case}/loss"]) <= 1e-4
    _close_state(got, ref, case, mesh, moments=False)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_two_runs_of_the_backward_are_bit_identical(runs, case, mesh):
    _, _, port, _ = runs
    assert bool(port[mesh][f"{case}/grads_bit_identical"])


def test_checkpoint_written_on_2x2_restores_on_4x1(runs):
    """Qwen2-MoE's trained state on (2, 2) (experts over ``model``, FSDP
    over ``data``) restored on (4, 1), where ``fsdp`` takes the 4 data
    processes: the parameters and moments bit for bit, placed by the
    default rules there."""
    _, _, port, _ = runs
    got = port["2x2"]
    e = f"qwen2_moe/{worker.tag(worker.ELASTIC)}"
    assert int(got[f"{e}/step"]) == 1
    names = tmodel.abstract_params(_cfg("qwen2_moe"))
    for what in ("p", "m", "v"):
        for k in names:
            np.testing.assert_array_equal(got[f"{e}/{what}/{k}"],
                                          got[f"qwen2_moe/{what}/{k}"])
    want = _spec_placements(worker.ELASTIC, "qwen2_moe", False)
    for name, pl in want.items():
        assert str(got[f"{e}/placement/{name}"]) == pl, name


# ---------------------------------------------------------- placements
def _want_placements(spec) -> str:
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(NAMES)
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[NAMES.index(a)] = Shard(dim)
    return repr(tuple(out))


def _jspec(shape, dims, logical, serve: bool) -> tuple:
    saved = jsharding.get_rules()
    jsharding.set_rules(dict(jsharding.DEFAULT_RULES, fsdp=None) if serve
                        else dict(jsharding.DEFAULT_RULES))
    try:
        with jax.sharding.use_abstract_mesh(
                jax.sharding.AbstractMesh(tuple(shape), NAMES)):
            return tuple(jsharding.logical_spec(dims, logical))
    finally:
        jsharding.set_rules(saved)


def _jcfg(case: str):
    return worker.family_config(case, jget_smoke)


def _spec_placements(shape, case: str, serve: bool) -> dict:
    """Every parameter's placements by the reference's ``logical_spec`` of
    its stacked name on a mesh of ``shape`` (the L axis never sharded)."""
    cfg = _cfg(case)
    stacked = tmodel.abstract_params(cfg)
    out = {}
    for name, logical in jmodel.param_logical(_jcfg(case)).items():
        spec = _jspec(shape, stacked[name].shape, logical, serve)
        per_layer = name not in tmodel.GLOBAL_KEYS
        assert not per_layer or spec[0] is None
        want = _want_placements(spec[1:] if per_layer else spec)
        if not per_layer:
            out[name] = want
            continue
        n = cfg.enc_layers if name in tmodel.ENC_KEYS else cfg.num_layers
        prefix = "enc_layers" if name in tmodel.ENC_KEYS else "layers"
        for i in range(n):
            out[f"{prefix}.{i}.{name}"] = want
    return out


@pytest.mark.parametrize("case,mesh", PAIRS)
@pytest.mark.parametrize("rules", ["serve", "train"])
def test_parameters_follow_the_reference_specs(runs, case, mesh, rules):
    """Every parameter of every layer (the encoder's too), served under
    ``serve_tp`` and trained under the default rules (with its AdamW
    moments), placed as the reference's ``logical_spec`` says: the expert
    weights on ``model`` where it divides the experts, else their hidden
    on ``model``."""
    _, _, port, _ = runs
    got = port[mesh]
    shape = tuple(int(s) for s in mesh.split("x"))
    want = _spec_placements(shape, case, rules == "serve")
    keys = [k for k in got if k.startswith(f"{case}/{rules}/placement/")]
    assert len(keys) == len(want)
    for name, pl in want.items():
        assert str(got[f"{case}/{rules}/placement/{name}"]) == pl, name
        if rules == "train":
            assert str(got[f"{case}/train/moment_placement/{name}"]) == pl
    cfg = _cfg(case)
    if cfg.moe is not None:
        tp = shape[1]
        dim = 0 if cfg.moe.padded_experts() % tp == 0 else 2
        assert f"Shard(dim={dim})" in want["layers.0.moe_w_in"]


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_caches_follow_the_serve_tp_specs(runs, case, mesh):
    _, _, port, _ = runs
    got = port[mesh]
    cfg = _cfg(case)
    shape = tuple(int(s) for s in mesh.split("x"))
    c_logical = jmodel.cache_logical(_jcfg(case))
    for nm in _cache_names(case):
        length = cfg.enc_frames if nm in ("xk", "xv") else S + STEPS
        dims = (cfg.num_layers, B, length, cfg.num_kv_heads, cfg.head_dim)
        want = _want_placements(_jspec(shape, dims, c_logical[nm], True))
        assert str(got[f"{case}/init_cache_placement/{nm}"]) == want, nm
        assert str(got[f"{case}/cache_placement/{nm}"]) == want, nm


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_prefill_runs_the_flash_wrapper_on_local_shards(runs, case, mesh):
    """One call of the flash wrapper an attention module in the prefill
    (Whisper: each encoder layer's bidirectional attention, then each
    decoder layer's causal self-attention and its cross-attention against
    the frames), each on a process's local q and k (plain tensors): the
    batch over ``data``, the heads over ``model`` where both head counts
    divide it, else whole."""
    _, _, port, _ = runs
    cfg = _cfg(case)
    dp, tp = (int(s) for s in mesh.split("x"))
    calls = ast.literal_eval(str(port[mesh][f"{case}/flash_calls"]))
    split = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    h, kv = ((cfg.num_heads // tp, cfg.num_kv_heads // tp) if split
             else (cfg.num_heads, cfg.num_kv_heads))
    b, hd = B // dp, cfg.head_dim

    def call(sq, skv, causal):
        return ("Tensor", (b, sq, h, hd), (b, skv, kv, hd), causal)
    if not cfg.enc_dec:
        want = [call(S, S, True)] * cfg.num_layers
    else:
        F_ = cfg.enc_frames
        want = ([call(F_, F_, False)] * cfg.enc_layers
                + [call(S, S, True), call(S, F_, False)] * cfg.num_layers)
    assert calls == want


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_local_bytes_are_the_dry_runs(runs, case, mesh, monkeypatch):
    """Rank 0's local bytes of the parameters and of ``init_cache``'s
    caches (Whisper's ``xk``/``xv`` too): ``launch.dryrun.serve_arg_bytes``
    on the abstract mesh of the same shape, exactly."""
    _, _, port, _ = runs
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    saved = tsharding.get_rules()
    try:
        want = tdryrun.serve_arg_bytes(
            _cfg(case), tmesh.AbstractMesh(
                tuple(int(s) for s in mesh.split("x")), NAMES),
            B, S + STEPS, torch.float32)
    finally:
        tsharding.set_rules(saved)
    got = port[mesh]
    assert int(got[f"{case}/local_bytes/params"]) == want["params"]
    assert int(got[f"{case}/local_bytes/cache"]) == want["cache"]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_dry_run_bytes_of_qwen2_moe_at_published_width(shape):
    """Qwen2-MoE-A2.7B at its published width under ``serve_tp`` on the
    meta device: on (1, 4) each card holds a quarter of the 60 experts'
    weights (15 a card) and the rest whole."""
    cfg = get_config("qwen2-moe-a2.7b")
    saved = tsharding.get_rules()
    try:
        got = tdryrun.serve_arg_bytes(cfg, tmesh.AbstractMesh(shape, NAMES),
                                      4, 2080)
    finally:
        tsharding.set_rules(saved)
    m, d, L = cfg.moe, cfg.d_model, cfg.num_layers
    experts = 3 * L * m.num_experts * d * m.d_ff_expert * 2
    whole = sum(t.numel() * (4 if k in tmodel.NORM_KEYS else 2)
                for k, t in tmodel.abstract_params(cfg).items())
    tp = shape[1]
    assert got["params"] <= whole - experts + experts // tp
    if shape == (4, 1):
        assert got["params"] == whole


# ------------------------------------------------ what the slice covers
@pytest.mark.parametrize("arch", ARCHS)
def test_device_mesh_for_admits_every_attention_block(arch):
    """``device_mesh_for`` returns a device mesh for every configuration,
    whatever its block: attention (the dense family, the MoE, the
    encoder-decoder), the SSM and the hybrid (no process group needed:
    the mesh's type decides), and None off a device mesh."""
    cfg = get_config(arch)
    mesh = tmesh.DistMesh((1,), ("data",), None, torch.device("cpu"))
    assert tmodel.device_mesh_for(cfg, mesh) is mesh
    assert tmodel.device_mesh_for(cfg, tmesh.make_production_mesh()) is None


def test_family_modules_import_no_jax():
    """The MoE, model, layers and flash modules and the worker in a fresh
    interpreter import neither ``jax`` nor ``repro``."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.models.moe, repro_torch.models.model
        import repro_torch.models.layers, repro_torch.models.flash
        import repro_torch.launch.dryrun, repro_torch.train.loop
        import torch_mesh_worker
        bad = sorted(m for m in sys.modules if m == "jax" or
                     m.startswith("jax.") or m == "repro" or
                     m.startswith("repro."))
        assert not bad, bad
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout


def test_expert_blocks_sum_to_the_whole_buffer():
    """``moe_ffn`` at capacity factor 0.5 (drops) on one process equals
    the sum of ``_expert_sums`` over the buffer split into two expert
    halves and two capacity halves (the blocks of a (2, 2) mesh's
    processes), up to the order of the final sums."""
    cfg = _cfg("qwen2_moe_c05")
    spec = cfg.moe
    rng = np.random.default_rng(5)
    d, fe, E = cfg.d_model, spec.d_ff_expert, spec.num_experts
    x = torch.from_numpy(rng.standard_normal((4, 8, d)).astype(np.float32))
    p = {"router": torch.from_numpy(rng.standard_normal((d, E))
                                    .astype(np.float32)),
         **{n: torch.from_numpy((rng.standard_normal(s) * 0.1)
                                .astype(np.float32))
            for n, s in (("w_in", (E, d, fe)), ("w_gate", (E, d, fe)),
                         ("w_out", (E, fe, d)))}}
    whole = tmoe.moe_ffn(x, p, spec)
    T = 32
    C = tmoe._capacity(T, spec.top_k, E, spec.capacity_factor)
    xf = x.reshape(T, d)
    gates, experts = tmoe.route(xf, p["router"], spec)
    pos, keep = tmoe.dispatch(experts, E, C)
    assert int((~keep).sum()) > 0
    parts = torch.zeros_like(xf)
    for rows in ((0, E // 2), (E // 2, E // 2)):
        sl = slice(rows[0], rows[0] + rows[1])
        for cols in ((0, C // 2), (C // 2, C // 2)):
            parts += tmoe._expert_sums(xf, gates, experts, pos, keep,
                                       p["w_in"][sl], p["w_gate"][sl],
                                       p["w_out"][sl], "silu", rows, cols)
    np.testing.assert_allclose(parts.view(4, 8, d).numpy(), whole.numpy(),
                               rtol=0, atol=1e-6 * float(whole.abs().max()))

