"""The port's SSM (Mamba2) and hybrid (Hymba) families across processes
against the JAX package, on the CPU: served under the reference's
``serve_tp`` rules and trained under its default rules on (data, model)
device meshes.

The port runs in 4 processes of one ``gloo`` group a mesh
(``tests/torch_mesh_worker.py``, ``ssm_runs``: one spawn for (2, 2) and one
for (1, 4), every case in it) and in one process on a (1, 1) mesh beside
the unsharded port (``ssm_one``); the reference runs in a subprocess a case
with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) on the same meshes
and on one device.  Both take the same numpy inputs at
fp32.  The cases (``torch_mesh_worker.SSM_CASES``): the smoke configs of
Mamba2 (``in_proj``'s column shards straddle z | xBC | dt and the conv's
channel shards x | B | C on ``model`` of 4) and Hymba (GQA 4 / 2, so
``head_dim`` takes ``model`` of 4 for k and v), and Hymba at d_model 72,
whose SSM widths repeat the published Hymba's divisibility on ``model`` of
4 (d_proj 322 and 18 SSM heads stay whole, conv_dim 160 splits, d_inner 144
splits mid-head).  Tolerances, those of
``tests/test_torch_mesh_families.py``:

* the prefill's last-position logits and each decode step's: within 1e-4
  of their largest magnitude, against the reference on the same mesh and
  on one device; the ``conv``/``ssm`` caches (and Hymba's KV) within 1e-5;
  greedy ids equal to the reference's one-device loop and the unsharded
  port's on decided rows;
* one train step: against the reference's one-device step the loss and
  ``grad_norm`` within 1e-4 relative, the parameters within 2 lr, the
  moments within 1e-3 of each tensor's largest magnitude; the loss within
  1e-4 relative of the reference's step on the same mesh; the gradients of
  one sequence (a batch of 1, whole on the data axis) within 1e-5 of the
  unsharded port's largest magnitude;
* exact: two runs of the loss and backward bit-identical; on (1, 1) every
  logit, cache, id, loss, gradient and updated tensor bit-identical to the
  unsharded port's; placements; each process's local bytes against the dry
  run's ``serve_arg_bytes``; the states each process's mixer returns at
  its own cache shard, and no cache redistributed; the flash wrapper's
  local shapes; the (2, 2) checkpoint restored on (4, 1) and off any mesh.

Every case also runs with the reference's sequence options
(``torch_mesh_worker.SSM_OPTIONS``: ``ulysses_attn``, ``seq_sharded`` and
both), in the same subprocesses and spawns, at the same tolerances: one train
step with each (the loss against the reference's on the same mesh with the
same options, and against its one-device step; the gradients, whose
sharded form the reference scales (ROADMAP C), and the updated parameters
and moments against the one-device step and the unsharded port), and the
serving run with ``ulysses_attn`` (``seq_sharded`` acts in training only)
against the reference on the same mesh with it, on one device and the
unsharded port.  Exact: on (1, 1) every option run is the unsharded port's
bit for bit, and Mamba2, which has no attention, with ``ulysses_attn`` is
the option-free run bit for bit on every mesh; under ``seq_sharded`` each
layer's output sits on ("batch", "seq_sp", None); under ``ulysses_attn``
Hymba's flash wrapper runs each process's slice of the queries at its
offset against every key, and each process still writes only its own
cache shard.
"""
import ast
import os
import re
import subprocess
import sys
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
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as tsharding  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
NAMES = ("data", "model")
B, S, STEPS = worker.SERVE_BATCH, worker.SERVE_SEQ, worker.SERVE_STEPS
LOGIT_FRAC, CACHE_FRAC, GRAD_FRAC = (worker.LOGIT_FRAC, worker.CACHE_FRAC,
                                     worker.GRAD_FRAC)
OCFG = tadamw.OptimConfig(warmup_steps=1, decay_steps=10)
CASES = list(worker.SSM_CASES)
PAIRS = [(case, worker.tag(m)) for case, meshes in worker.SSM_CASES.items()
         for m in meshes]
OPTIONS = list(worker.SSM_OPTIONS)
#: every case on every mesh with every option set
OPAIRS = [(case, mesh, opts) for case, mesh in PAIRS for opts in OPTIONS]


def _cfg(case: str):
    return worker.ssm_config(case, get_smoke_config)


def _jcfg(case: str):
    return worker.ssm_config(case, jget_smoke)


_REFERENCE = """
import contextlib, dataclasses, os, sys
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
from torch_mesh_worker import (SP_OPTIONS, SSM_CASES, SSM_OPTIONS,
                               SERVE_SEQ, SERVE_STEPS, ssm_config)
assert len(jax.devices()) == 4, jax.devices()
jmodel.COMPUTE_DTYPE = jnp.float32
data = dict(np.load(sys.argv[1]))
S, STEPS = SERVE_SEQ, SERVE_STEPS
ocfg = jadamw.OptimConfig(warmup_steps=1, decay_steps=10)
names = {"tokens": ("batch", None), "labels": ("batch", None)}
out = {}


def serve(cfg, p, put, key, greedy):
    cache_names = [n for n in ("k", "v", "conv", "ssm")
                   if n in jmodel.cache_logical(cfg)]
    batch = {"tokens": put(jnp.asarray(data[case + "/tokens"]),
                           names["tokens"])}
    prefill = jax.jit(sstep.make_prefill_step(cfg, max_len=S + STEPS))
    decode = jax.jit(sstep.make_decode_step(cfg))
    logits, cache = prefill(p, batch)
    out[f"{key}/prefill_logits"] = np.asarray(logits)
    for nm in cache_names:
        out[f"{key}/prefill_cache/{nm}"] = np.asarray(
            cache[nm]).astype(np.float32)
    if greedy:
        c, lg, ids, all_lg = cache, logits, [], []
        for i in range(STEPS):
            all_lg.append(np.asarray(lg[:, -1]))
            ids.append(jnp.argmax(lg[:, -1, :cfg.vocab_size], -1))
            if i < STEPS - 1:
                lg, c = decode(p, {"tokens": ids[-1][:, None], "cache": c})
        out[f"{key}/greedy"] = np.asarray(jnp.stack(ids, 1))
        out[f"{key}/greedy_logits"] = np.stack(all_lg)
    dec = []
    for i in range(STEPS - 1):
        logits, cache = decode(p, {
            "tokens": put(jnp.asarray(data[case + "/decode"][i]),
                          names["tokens"]), "cache": cache})
        dec.append(np.asarray(logits))
    out[f"{key}/decode_logits"] = np.stack(dec)
    out[f"{key}/pos"] = np.asarray(cache["pos"])
    for nm in cache_names:
        out[f"{key}/decode_cache/{nm}"] = np.asarray(
            cache[nm]).astype(np.float32)


for case in sys.argv[3:]:
    meshes = SSM_CASES[case]
    cfg = ssm_config(case, get_smoke_config)
    logical = jmodel.param_logical(cfg)
    key = case + "/p/"
    params = {k[len(key):]: jnp.asarray(v) for k, v in data.items()
              if k.startswith(key)}
    train = {k: jnp.asarray(data[case + "/train/" + k])
             for k in ("tokens", "labels")}
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
                if rules == "serve":
                    serve(cfg, p, put, f"{tag}/{case}", shape is None)
                    if shape:
                        # seq_sharded acts in training only: serving takes
                        # ulysses_attn alone
                        serve(dataclasses.replace(cfg, ulysses_attn=True),
                              p, put, f"{tag}/{case}/ulysses", False)
                    continue
                b = {k: put(v, names[k]) for k, v in train.items()}
                step = jax.jit(jstep.make_train_step(
                    cfg, jstep.TrainConfig(ocfg)))
                p2, o2, m = step(p, jadamw.init_opt_state(p, ocfg), b)
                out[f"{tag}/{case}/loss"] = np.asarray(m["loss"])
                out[f"{tag}/{case}/grad_norm"] = np.asarray(m["grad_norm"])
                for k in p2:
                    out[f"{tag}/{case}/p/{k}"] = np.asarray(p2[k])
                    if shape is None:
                        out[f"{tag}/{case}/m/{k}"] = np.asarray(o2["m"][k])
                        out[f"{tag}/{case}/v/{k}"] = np.asarray(o2["v"][k])
                # the options' losses (the sharded gradients are scaled:
                # ROADMAP C)
                for opts in SSM_OPTIONS if shape else ():
                    ocfg_ = dataclasses.replace(cfg, **SP_OPTIONS[opts])
                    out[f"{tag}/{case}/{opts}/loss"] = np.asarray(jax.jit(
                        lambda p, b: jmodel.lm_loss(p, ocfg_, b)[0])(p, b))
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs(path: str) -> dict:
    """Seeded numpy inputs (``torch_mesh_worker.ssm_inputs``)."""
    return worker.ssm_inputs(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses (one a case: compiling is most of
    their time, and one alone would outlast the spawns) and the port's
    three spawns ((2, 2) and (1, 4) of 4 processes, (1, 1) of one) side by
    side: (inputs, reference results, the port's results by mesh tag with
    ``1x1`` the one-process run)."""
    tmp = tmp_path_factory.mktemp("ssm")
    src = str(tmp / "in.npz")
    refs = {case: str(tmp / f"ref_{case}.npz") for case in CASES}
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
            if shape == (1, 1):
                worker.spawn(worker.ssm_one, 1, src, str(tmp / "1x1.npz"))
            else:
                worker.spawn(worker.ssm_runs, 4, shape, src,
                             str(tmp / f"{worker.tag(shape)}.npz"), ckpt)
        except Exception as exc:     # noqa: BLE001 - re-raised below
            errors.append(exc)
    shapes = (*worker.MESHES, (1, 1))
    threads = [threading.Thread(target=one, args=(s,)) for s in shapes]
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
            for s in shapes}
    ref = {k: v for dst in refs.values() for k, v in np.load(dst).items()}
    return inputs, ref, port


def _close(got, want, frac: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=what)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _cache_names(case: str) -> list:
    return [n for n in ("k", "v", "conv", "ssm")
            if n in tmodel.cache_logical(_cfg(case))]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("case,mesh", PAIRS)
def test_prefill_logits_match_the_reference_on_the_mesh(runs, case, mesh):
    _, ref, port = runs
    got = port[mesh][f"{case}/prefill_logits"]
    assert got.shape == (B, 1, _cfg(case).vocab_padded)
    _close(got, ref[f"{mesh}/{case}/prefill_logits"], LOGIT_FRAC, case)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_prefill_logits_match_the_reference_on_one_device(runs, case, mesh):
    _, ref, port = runs
    _close(port[mesh][f"{case}/prefill_logits"],
           ref[f"one/{case}/prefill_logits"], LOGIT_FRAC, case)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_caches_and_decode_logits_match_the_reference(runs, case, mesh):
    """The ``conv`` and ``ssm`` caches (and Hymba's KV) after the prefill
    and after 3 decode steps, and those steps' logits, against the
    reference on the same mesh and on one device."""
    _, ref, port = runs
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
def test_greedy_tokens_match_on_decided_rows(runs, case, mesh):
    _, ref, port = runs
    cfg = _cfg(case)
    got = port[mesh][f"{case}/greedy"]
    assert got.shape == (B, STEPS)
    assert ((0 <= got) & (got < cfg.vocab_size)).all()
    n = _decided_prefix(ref[f"one/{case}/greedy_logits"][..., :cfg.vocab_size])
    assert n.sum() > 0
    for want in (ref[f"one/{case}/greedy"], port["1x1"][f"off/{case}/greedy"]):
        for row in range(B):
            np.testing.assert_array_equal(got[row, :n[row]],
                                          want[row, :n[row]])


# ------------------------------------------------------------ training
def _close_state(port: dict, ref: dict, case: str, mesh: str,
                 moments: bool, key: str | None = None) -> None:
    """The parameters after the step (and its moments) of ``case``, the
    port's under ``key`` (default ``case``), against the reference's step
    on ``mesh``."""
    lr = OCFG.peak_lr            # the first step's rate, warmup 1
    key = key or case
    for k in sorted(tmodel.abstract_params(_cfg(case))):
        np.testing.assert_allclose(port[f"{key}/p/{k}"],
                                   ref[f"{mesh}/{case}/p/{k}"], rtol=0,
                                   atol=2 * lr, err_msg=k)
        for mom in ("m", "v") if moments else ():
            w = ref[f"{mesh}/{case}/{mom}/{k}"]
            np.testing.assert_allclose(
                port[f"{key}/{mom}/{k}"], w, rtol=0,
                atol=1e-3 * float(np.abs(w).max()), err_msg=f"{mom} {k}")


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_train_step_matches_the_reference_on_one_device(runs, case, mesh):
    _, ref, port = runs
    got = port[mesh]
    assert _rel(got[f"{case}/loss"], ref[f"one/{case}/loss"]) <= 1e-4
    assert _rel(got[f"{case}/grad_norm"],
                ref[f"one/{case}/grad_norm"]) <= 1e-4
    _close_state(got, ref, case, "one", moments=True)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_train_step_matches_the_reference_on_the_mesh(runs, case, mesh):
    """The loss of the reference's step on the same mesh.  Its updated
    parameters are not held: the reference's sharded loss gradient is
    scaled (ROADMAP C: dhead by 1 / ``model``), and with a tied head the
    embedding's gradient is the sum of the lookup's (right) and the head's
    (scaled) parts, whose sign can then flip, and with it Adam's first
    update (Hymba at d_model 72 on (1, 4): one element of the embedding 2
    lr off).  The parameters are held against the one-device step."""
    _, ref, port = runs
    got = port[mesh]
    assert _rel(got[f"{case}/loss"], ref[f"{mesh}/{case}/loss"]) <= 1e-4


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_gradients_match_the_unsharded_port(runs, case, mesh):
    """Every gradient of the train batch and of one sequence (a batch of
    1, whole on the data axis, whose processes there then share the
    mixer's work: only the first contributes its output) against the
    unsharded port's."""
    _, _, port = runs
    got, one = port[mesh], port["1x1"]
    for key in ("", "one/"):
        want_loss = one[f"off/{case}/{key or 'grad_'}loss"]
        assert _rel(got[f"{case}/{key or 'grad_'}loss"], want_loss) <= 1e-5
        for k in tmodel.abstract_params(_cfg(case)):
            _close(got[f"{case}/{key}g/{k}"], one[f"off/{case}/{key}g/{k}"],
                   GRAD_FRAC, f"{key}{k}")


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_two_runs_of_the_backward_are_bit_identical(runs, case, mesh):
    _, _, port = runs
    assert bool(port[mesh][f"{case}/grads_bit_identical"])


@pytest.mark.parametrize("case", CASES)
def test_one_device_mesh_is_the_unsharded_port_bit_for_bit(runs, case):
    """On a (1, 1) mesh every slice of the mixer is whole and no
    collective runs: the prefill's and decode's logits and caches, the
    greedy ids, the loss, every gradient and the train step's parameters
    and moments equal the unsharded port's bit for bit."""
    _, _, port = runs
    one = port["1x1"]
    keys = [k[len("mesh/"):] for k in one if k.startswith(f"mesh/{case}/")]
    assert len(keys) > 50
    for k in keys:
        np.testing.assert_array_equal(one[f"mesh/{k}"], one[f"off/{k}"],
                                      err_msg=k)


def test_checkpoint_written_on_2x2_restores_on_4x1_and_off_the_mesh(runs):
    """Mamba2's trained state on (2, 2) restored on (4, 1) (``fsdp`` takes
    the 4 data processes) and into the unsharded model: the parameters
    (the fp32 SSM leaves too) and moments bit for bit, placed by the
    default rules on (4, 1)."""
    _, _, port = runs
    got = port["2x2"]
    case = worker.SSM_CKPT
    names = tmodel.abstract_params(_cfg(case))
    for where in (worker.tag(worker.ELASTIC), "off"):
        e = f"{case}/{where}"
        assert int(got[f"{e}/step"]) == 1
        for what in ("p", "m", "v"):
            for k in names:
                np.testing.assert_array_equal(got[f"{e}/{what}/{k}"],
                                              got[f"{case}/{what}/{k}"])
    want = _spec_placements(worker.ELASTIC, case, False)
    for name, pl in want.items():
        assert str(got[f"{case}/{worker.tag(worker.ELASTIC)}/placement/"
                       f"{name}"]) == pl, name


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
        for i in range(cfg.num_layers):
            out[f"layers.{i}.{name}"] = want
    return out


@pytest.mark.parametrize("case,mesh", PAIRS)
@pytest.mark.parametrize("rules", ["serve", "train"])
def test_parameters_follow_the_reference_specs(runs, case, mesh, rules):
    """Every parameter of every layer, served under ``serve_tp`` and
    trained under the default rules (with its AdamW moments), placed as the
    reference's ``logical_spec`` says: the fp32 SSM leaves beside the
    matrices, ``in_proj``'s columns on ``model`` only where ``model``
    divides d_proj."""
    _, _, port = runs
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
    d_inner, nh, conv_dim = tmodel._ssm_dims(cfg)
    split = "Shard(dim=1)" in want["layers.0.ssm_in_proj"].split(",")[-1]
    assert split == ((d_inner + conv_dim + nh) % shape[1] == 0)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_caches_follow_the_serve_tp_specs(runs, case, mesh):
    _, _, port = runs
    got = port[mesh]
    cfg = _cfg(case)
    shape = tuple(int(s) for s in mesh.split("x"))
    c_logical = jmodel.cache_logical(_jcfg(case))
    _, nh, conv_dim = tmodel._ssm_dims(cfg)
    sp = cfg.ssm
    dims = {"k": (cfg.num_layers, B, S + STEPS, cfg.num_kv_heads,
                  cfg.head_dim),
            "conv": (cfg.num_layers, B, sp.conv_width - 1, conv_dim),
            "ssm": (cfg.num_layers, B, nh, sp.head_dim, sp.d_state)}
    dims["v"] = dims["k"]
    for nm in _cache_names(case):
        want = _want_placements(_jspec(shape, dims[nm], c_logical[nm], True))
        assert str(got[f"{case}/init_cache_placement/{nm}"]) == want, nm
        assert str(got[f"{case}/cache_placement/{nm}"]) == want, nm


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_each_process_writes_only_its_own_cache_shard(runs, case, mesh):
    """Each layer's mixer, in the prefill and in every decode step,
    returns its new ``conv`` and ``ssm`` states at each process's own
    cache shard (the local shape and placements of that process's slice of
    the cache), and no cache nor state is redistributed in the prefill or
    the decode steps: no process gathers a cache whole."""
    _own_cache_shards(runs[2][mesh], case, mesh, case)


def _own_cache_shards(got: dict, case: str, mesh: str, key: str) -> None:
    """:func:`test_each_process_writes_only_its_own_cache_shard` on the
    serving run recorded under ``key``."""
    cfg = _cfg(case)
    _, nh, conv_dim = tmodel._ssm_dims(cfg)
    sp = cfg.ssm
    per_rank = ast.literal_eval(str(got[f"{key}/states"]))
    assert len(per_rank) == 4
    want_shapes = [tuple(int(v) for v in got[f"{key}/cache_local_shape/"
                                             f"{nm}"]) for nm in ("conv",
                                                                  "ssm")]
    dp, tp = (int(s) for s in mesh.split("x"))
    # rank 0's cache shard: the batch over data, conv_dim and the SSM heads
    # over model where it divides them
    assert want_shapes == [
        (B // dp, sp.conv_width - 1, conv_dim // tp if conv_dim % tp == 0
         else conv_dim),
        (B // dp, nh // tp if nh % tp == 0 else nh, sp.head_dim,
         sp.d_state)]
    # the cache's placements without its layer axis
    pls = [re.sub(r"Shard\(dim=(\d)\)",
                  lambda m: f"Shard(dim={int(m.group(1)) - 1})",
                  str(got[f"{key}/cache_placement/{nm}"]))
           for nm in ("conv", "ssm")]
    for calls in per_rank:
        assert len(calls) == cfg.num_layers * STEPS
        for (c_shape, c_pl), (s_shape, s_pl) in calls:
            assert [c_shape, s_shape] == want_shapes
            assert [c_pl, s_pl] == pls
    state_shapes = {(B, sp.conv_width - 1, conv_dim),
                    (B, nh, sp.head_dim, sp.d_state)}
    for n in _cache_names(case):
        state_shapes.add(tuple(int(v) for v in got[
            f"{key}/prefill_cache/{n}"].shape))
    for recs in ast.literal_eval(str(got[f"{key}/redistributed"])):
        moved = [r for r in recs if r[0] in state_shapes]
        assert not moved, moved


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_prefill_runs_the_flash_wrapper_on_local_shards(runs, case, mesh):
    """One call of the flash wrapper an attention layer on every process
    (Hymba's attention branch; none for Mamba2), on its local q and k: the
    batch over ``data``, the heads over ``model`` where both head counts
    divide it, else whole."""
    _, _, port = runs
    cfg = _cfg(case)
    dp, tp = (int(s) for s in mesh.split("x"))
    per_rank = ast.literal_eval(str(port[mesh][f"{case}/flash_calls"]))
    assert len(per_rank) == 4
    if cfg.block == "ssm":
        assert per_rank == [[]] * 4
        return
    split = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    h, kv = ((cfg.num_heads // tp, cfg.num_kv_heads // tp) if split
             else (cfg.num_heads, cfg.num_kv_heads))
    call = ("fwd", "Tensor", (B // dp, S, h, cfg.head_dim),
            (B // dp, S, kv, cfg.head_dim), 0, True)
    for calls in per_rank:
        assert calls == [call] * cfg.num_layers


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_local_bytes_are_the_dry_runs(runs, case, mesh, monkeypatch):
    """Rank 0's local bytes of the parameters (the fp32 SSM leaves at 4
    bytes) and of ``init_cache``'s caches (the fp32 state too):
    ``launch.dryrun.serve_arg_bytes`` on the abstract mesh of the same
    shape, exactly."""
    _, _, port = runs
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


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_dry_run_bytes_at_published_width(arch, shape):
    """Mamba2-2.7B and Hymba-1.5B at their published widths under
    ``serve_tp`` on the meta device: on ``model`` of 4 Mamba2's mixer
    weights split four ways (d_proj 10576 = 4 x 2644), Hymba's ``in_proj``
    stays whole (d_proj 6482) while its conv and ``out_proj`` split; on
    (4, 1) nothing of a weight splits."""
    cfg = get_config(arch)
    saved = tsharding.get_rules()
    try:
        got = tdryrun.serve_arg_bytes(cfg, tmesh.AbstractMesh(shape, NAMES),
                                      4, 2080)
    finally:
        tsharding.set_rules(saved)
    d_inner, nh, conv_dim = tmodel._ssm_dims(cfg)
    L, d = cfg.num_layers, cfg.d_model
    whole = sum(t.numel() * (4 if k in tmodel.NORM_KEYS
                             or k in tmodel.SSM_FP32_KEYS else 2)
                for k, t in tmodel.abstract_params(cfg).items())
    tp = shape[1]
    in_proj = L * d * (d_inner + conv_dim + nh) * 2
    out_proj = L * d_inner * d * 2
    if tp == 1:
        assert got["params"] == whole
    else:
        split_in = (d_inner + conv_dim + nh) % tp == 0
        assert split_in == (arch == "mamba2-2.7b" or tp == 2)
        assert got["params"] <= whole - out_proj + out_proj // tp - (
            in_proj - in_proj // tp if split_in else 0)


# ------------------------------------------------ what the slice covers
def test_mixer_blocks_cover_the_published_shards():
    """``_block_of`` slices as DTensor splits, and at Mamba2-2.7B's and
    Hymba-1.5B's published widths on ``model`` of 4 the reference's rules
    give the splits the mesh route is built for: Mamba2's in_proj columns
    (2644 a process) straddle z | xBC at 5120 and xBC | dt at 10496,
    Hymba's d_proj (6482) and 50 SSM heads stay whole while its 3200
    d_inner channels split into 800 (12.5 heads)."""
    mesh = tmesh.AbstractMesh((1, 4), NAMES)
    for arch, split in (("mamba2-2.7b", (True, True, True, True)),
                        ("hymba-1.5b", (False, True, False, True))):
        cfg = get_config(arch)
        d_inner, nh, conv_dim = tmodel._ssm_dims(cfg)
        with tmesh.set_mesh(mesh):
            specs = [tsharding.logical_spec(dims, names)[-1] for dims, names
                     in (((cfg.d_model, d_inner + conv_dim + nh),
                          ("fsdp", "mlp")),
                         ((cfg.ssm.conv_width, conv_dim), (None, "mlp")),
                         ((nh,), ("heads",)), ((d_inner,), ("mlp",)))]
        assert tuple(s == "model" for s in specs) == split, (arch, specs)
    logical = jmodel.cache_logical(_jcfg("hymba"))
    assert tssm.CONV_LOGICAL == logical["conv"][1:]
    assert tssm.STATE_LOGICAL == logical["ssm"][1:]


# ------------------------------------------------- the sequence options
def _want_carry(mesh: str) -> str:
    """The placements of ("batch", "seq_sp", None) on a (B, S, d) carry of
    the train batch on ``mesh``."""
    shape = tuple(int(s) for s in mesh.split("x"))
    dims = (worker.FAMILY_TRAIN_BATCH, worker.FAMILY_TRAIN_SEQ, 1)
    return _want_placements(_jspec(shape, dims, ("batch", "seq_sp", None),
                                   False))


@pytest.mark.parametrize("case,mesh,opts", OPAIRS)
def test_option_train_step_matches_the_reference(runs, case, mesh, opts):
    """One train step with the options: its loss within 1e-4 (relative)
    of the reference's lm_loss on the same mesh with the same options, and
    loss, ``grad_norm``, parameters (2 lr) and moments (1e-3 of each
    tensor's largest magnitude) against the reference's one-device step
    (its sharded gradients are scaled: ROADMAP C)."""
    _, ref, port = runs
    got = port[mesh]
    key = f"{case}/{opts}"
    assert _rel(got[f"{key}/loss"], ref[f"{mesh}/{key}/loss"]) <= 1e-4
    assert _rel(got[f"{key}/loss"], ref[f"one/{case}/loss"]) <= 1e-4
    assert _rel(got[f"{key}/grad_norm"],
                ref[f"one/{case}/grad_norm"]) <= 1e-4
    _close_state(got, ref, case, "one", moments=True, key=key)


@pytest.mark.parametrize("case,mesh,opts", OPAIRS)
def test_option_gradients_match_the_unsharded_port(runs, case, mesh, opts):
    """The gradients the step with the options applied, every one, within
    1e-5 of the unsharded port's largest magnitude, and its loss within
    1e-5 relative."""
    _, _, port = runs
    got, one = port[mesh], port["1x1"]
    key = f"{case}/{opts}"
    assert _rel(got[f"{key}/loss"], one[f"off/{case}/grad_loss"]) <= 1e-5
    for k in tmodel.abstract_params(_cfg(case)):
        _close(got[f"{key}/g/{k}"], one[f"off/{case}/g/{k}"], GRAD_FRAC,
               f"{opts} {k}")


def _serve_keys(case: str) -> list:
    """A serving run's logits and caches."""
    return ["prefill_logits", "decode_logits"] + [
        f"{when}/{nm}" for when in ("prefill_cache", "decode_cache")
        for nm in _cache_names(case)]


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_ulysses_serving_matches_the_reference(runs, case, mesh):
    """The serving run with ``ulysses_attn``: the prefill's last-position
    logits and each decode step's within 1e-4 of their largest magnitude,
    the caches within 1e-5, against the reference with the option on the
    same mesh, on one device, and the unsharded port."""
    _, ref, port = runs
    got = port[mesh]
    assert int(got[f"{case}/ulysses/pos"]) == S + STEPS - 1
    for want, name in ((ref, f"{mesh}/{case}/ulysses"), (ref, f"one/{case}"),
                       (port["1x1"], f"off/{case}")):
        for k in _serve_keys(case):
            _close(got[f"{case}/ulysses/{k}"], want[f"{name}/{k}"],
                   LOGIT_FRAC if "logits" in k else CACHE_FRAC,
                   f"{case} ulysses {k} vs {name}")


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_ulysses_greedy_tokens_match_on_decided_rows(runs, case, mesh):
    _, ref, port = runs
    cfg = _cfg(case)
    got = port[mesh][f"{case}/ulysses/greedy"]
    assert got.shape == (B, STEPS)
    n = _decided_prefix(ref[f"one/{case}/greedy_logits"][..., :cfg.vocab_size])
    assert n.sum() > 0
    for want in (ref[f"one/{case}/greedy"], port["1x1"][f"off/{case}/greedy"]):
        for row in range(B):
            np.testing.assert_array_equal(got[row, :n[row]],
                                          want[row, :n[row]])


@pytest.mark.parametrize("case,opts", [(c, o) for c in CASES
                                       for o in OPTIONS])
def test_options_on_one_device_mesh_are_the_unsharded_port_bit_for_bit(
        runs, case, opts):
    """On a (1, 1) mesh the step with the options (loss, ``grad_norm``,
    every gradient, parameter and moment) and, with ``ulysses_attn``, the
    serving run (logits, caches, greedy ids) equal the unsharded port's
    option-free runs bit for bit."""
    _, _, port = runs
    one = port["1x1"]
    key = f"opt/{case}/{opts}/"
    keys = [k[len(key):] for k in one if k.startswith(key)
            and not k.endswith(("/flash", "/carry"))]
    # loss, grad_norm and the four trees g, p, m, v (and the serving run's)
    assert len(keys) >= 2 + 4 * len(tmodel.abstract_params(_cfg(case)))
    for k in keys:
        np.testing.assert_array_equal(one[key + k], one[f"off/{case}/{k}"],
                                      err_msg=k)
    if opts == "ulysses":
        for k in [*_serve_keys(case), "pos", "greedy"]:
            np.testing.assert_array_equal(one[f"{key}{k}"],
                                          one[f"off/{case}/{k}"], err_msg=k)


@pytest.mark.parametrize("mesh", ["1x1", *(
    worker.tag(m) for m in worker.SSM_CASES["mamba2"])])
def test_mamba2_with_ulysses_is_the_option_free_run_bit_for_bit(runs, mesh):
    """Mamba2 has no attention: with ``ulysses_attn`` its train step
    (loss, ``grad_norm``, gradients, parameters, moments) and its serving
    run (logits, caches, greedy ids) are the option-free run's bit for bit,
    on every mesh."""
    _, _, port = runs
    got = port[mesh]
    pre, opt = ("mesh/", "opt/") if mesh == "1x1" else ("", "")
    key = f"{opt}mamba2/ulysses/"
    keys = [k[len(key):] for k in got if k.startswith(key)
            and not k.endswith(("/flash", "/carry"))]
    assert len(keys) > 50
    for k in keys:
        np.testing.assert_array_equal(got[key + k], got[f"{pre}mamba2/{k}"],
                                      err_msg=k)
    assert ast.literal_eval(str(got[f"{key}flash"])) == [
        [] for _ in range(1 if mesh == "1x1" else 4)]


@pytest.mark.parametrize("case,mesh,opts", OPAIRS)
def test_seq_sharded_carry_sits_on_the_sequence(runs, case, mesh, opts):
    """Each layer's output: on ("batch", "seq_sp", None) under
    ``seq_sharded`` (the sequence split over ``model``), never so
    without it."""
    _, _, port = runs
    carry = ast.literal_eval(str(port[mesh][f"{case}/{opts}/carry"]))
    want = _want_carry(mesh)
    if opts == "ulysses":
        assert want not in carry
    else:
        assert carry == [want]


@pytest.mark.parametrize("case,mesh", PAIRS)
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_ulysses_runs_the_flash_wrapper_on_sequence_shards(runs, case, mesh,
                                                           mode):
    """Under ``ulysses_attn`` Hymba's flash wrapper runs on each process's
    slice of the queries (the batch over ``data``, the sequence over
    ``model``, every head) against every key (k and v whole over
    ``model``), at ``q_offset`` = its index over ``model`` x the local Sq;
    in training as many backward as forward-without-recompute calls, and
    in serving one call a layer; Mamba2 makes none."""
    _, _, port = runs
    cfg = _cfg(case)
    dp, tp = (int(s) for s in mesh.split("x"))
    key = f"{case}/ulysses/{'flash' if mode == 'train' else 'flash_calls'}"
    per_rank = ast.literal_eval(str(port[mesh][key]))
    assert len(per_rank) == 4
    if cfg.block == "ssm":
        assert per_rank == [[]] * 4
        return
    b, seq = ((worker.FAMILY_TRAIN_BATCH, worker.FAMILY_TRAIN_SEQ)
              if mode == "train" else (B, S))
    for rank, calls in enumerate(per_rank):
        offset = (rank % tp) * (seq // tp)
        kinds = {c[0] for c in calls}
        assert kinds == ({"fwd", "bwd"} if mode == "train" else {"fwd"})
        for kind, typ, q, k, q_off, causal in calls:
            assert (q, k, q_off, causal) == (
                (b // dp, seq // tp, cfg.num_heads, cfg.head_dim),
                (b // dp, seq, cfg.num_kv_heads, cfg.head_dim), offset,
                True), (rank, kind)
        n_bwd = sum(c[0] == "bwd" for c in calls)
        assert n_bwd == cfg.num_layers if mode == "train" else not n_bwd


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_each_process_writes_only_its_own_cache_shard_under_ulysses(
        runs, case, mesh):
    """With ``ulysses_attn`` the caches keep their ``serve_tp`` placements
    and each process's mixer returns its new states at its own cache
    shard; no cache nor state is redistributed in the prefill or the decode
    steps."""
    _own_cache_shards(runs[2][mesh], case, mesh, f"{case}/ulysses")
