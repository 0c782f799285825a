"""The port's multi-card training path against the JAX package, on the CPU.

The port runs in 4 processes of one ``gloo`` group
(``tests/torch_mesh_worker.py``) on (data, model) device meshes of (2, 2)
and (1, 4); the reference runs in a subprocess with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_engine.py`` does) on the same meshes and on one device.  Both
take the same numpy inputs (the Qwen2-7B smoke config's parameters,
carried into the port by ``params_from_numpy``, and a batch), at fp32.  On
(1, 4) the 2 KV heads do not divide ``model``, so flash attention runs on
whole heads and ``wk``/``wv`` shard ``head_dim`` instead.

The reference's sharded gradients are not its own one-device gradients:
its vocab-parallel loss runs a ``custom_vjp`` inside ``shard_map(...,
check_vma=False)``, whose transpose divides the replicated loss's
cotangent over the mesh and sums it back over the axes an input is not
split on, on top of the backward's own psums, so dx comes out divided by
the data axes' size and dhead by ``model``'s (``src/repro/models/
loss.py:152-186``; the forward is right).  The port's sharded gradients
equal the one-device ones; the tests hold them against the reference's
one-device gradients, and against its sharded ones times those two
factors.  Tolerances:

* one ``make_train_step`` step: against the reference's step on the same
  mesh, the loss within 1e-4 relative and the parameters within 2 lr (the
  first Adam update is g / |g| per element, so a gradient's scale does not
  move it, and an element whose sign differs moves by 2 lr); against the
  reference's one-device step, the loss and ``grad_norm`` within 1e-4
  relative, the parameters within 2 lr, the moments within 1e-3 of each
  tensor's largest magnitude; against the port's unsharded step, the loss
  within 1e-5 relative;
* ``fused_ce_loss`` (a batch of 3 takes the reference's fallback to its
  local loss on data = 2): the loss within 1e-6 relative of the
  reference's on the same mesh; dx and dhead within 1e-5 of their largest
  magnitude of the reference's one-device ones, of its sharded ones times
  the factors above, and of the port's unsharded ones (the same products,
  summed across shards in another order);
* placements and checkpoints: exact.

The launcher's two-process run on the CPU ends within 1e-4 relative of its
one-process run's final loss (bf16, as the launcher trains), and the same
two-process command restarted from its step-2 checkpoint ends at its final
loss bit for bit.
"""
import ast
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402,F401
from repro.checkpoint import store as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import loss as tloss  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as tsharding  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TAGS = [worker.tag(s) for s in worker.MESHES]
LOSS_CASES = ["even", "odd"]
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
from repro.models import loss as jloss, model as jmodel
from repro.optim import adamw as jadamw
from repro.parallel.sharding import logical_spec
from repro.train import step as jstep
assert len(jax.devices()) == 4, jax.devices()
jmodel.COMPUTE_DTYPE = jnp.float32
data = dict(np.load(sys.argv[1]))
cfg = get_smoke_config("qwen2_7b")
params = {k[2:]: jnp.asarray(v) for k, v in data.items()
          if k.startswith("p/")}
batch = {k: jnp.asarray(data[k]) for k in ("tokens", "labels")}
ocfg = jadamw.OptimConfig(warmup_steps=1, decay_steps=10)
logical = jmodel.param_logical(cfg)
out = {}
for shape in (MESHES) + (None,):
    tag = "x".join(map(str, shape)) if shape else "one"
    ctx, put = contextlib.nullcontext(), lambda v, names: v
    if shape:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ctx = jax.set_mesh(mesh)
        put = lambda v, names: jax.device_put(
            v, NamedSharding(mesh, logical_spec(v.shape, names)))
    with ctx:
        p = {k: put(v, logical[k]) for k, v in params.items()}
        b = {k: put(v, ("batch", None)) for k, v in batch.items()}
        step = jax.jit(jstep.make_train_step(cfg, jstep.TrainConfig(ocfg)))
        p2, o2, m = step(p, jadamw.init_opt_state(p, ocfg), b)
        out[f"{tag}/loss"] = np.asarray(m["loss"])
        out[f"{tag}/grad_norm"] = np.asarray(m["grad_norm"])
        for k in p2:
            out[f"{tag}/p/{k}"] = np.asarray(p2[k])
            out[f"{tag}/m/{k}"] = np.asarray(o2["m"][k])
            out[f"{tag}/v/{k}"] = np.asarray(o2["v"][k])
        for case in ("even", "odd"):
            x, head, lab = (jnp.asarray(data[f"loss_{case}/{n}"])
                            for n in ("x", "head", "labels"))
            def f(x, head):
                return jloss.fused_ce_loss(
                    x, head, lab, valid_vocab=int(data["valid_vocab"]),
                    chunk=CHUNK)[0]
            loss, (dx, dhead) = jax.jit(jax.value_and_grad(f, (0, 1)))(
                x, head)
            out[f"{tag}/loss_{case}/loss"] = np.asarray(loss)
            out[f"{tag}/loss_{case}/dx"] = np.asarray(dx)
            out[f"{tag}/loss_{case}/dhead"] = np.asarray(dhead)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs(path: str) -> dict:
    """Seeded numpy inputs (``torch_mesh_worker.train_inputs``)."""
    return worker.train_inputs(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4 processes, side by side
    on the same inputs: (inputs, reference results, port results, the
    checkpoint directory written on (2, 2))."""
    tmp = tmp_path_factory.mktemp("mesh")
    src, ref, port = (str(tmp / n) for n in ("in.npz", "ref.npz",
                                              "port.npz"))
    ckpt = str(tmp / "ckpt")
    inputs = _inputs(src)
    code = (_REFERENCE.replace("(MESHES)", repr(worker.MESHES))
            .replace("CHUNK", str(worker.LOSS_CHUNK)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.Popen([sys.executable, "-c", code, src, ref], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        worker.spawn(worker.port_runs, 4, src, port, ckpt)
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "OK" in out, err[-3000:]
    return inputs, dict(np.load(ref)), dict(np.load(port)), ckpt


def _unsharded_step(inputs: dict, monkeypatch):
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    cfg = get_smoke_config("qwen2_7b")
    flat = {k[2:]: v for k, v in inputs.items() if k.startswith("p/")}
    params = tmodel.params_from_numpy(cfg, flat, device="cpu",
                                      dtype=torch.float32)
    step = tstep.make_train_step(cfg, tstep.TrainConfig(OCFG))
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}
    return step(params, tadamw.init_opt_state(params, OCFG), batch)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


# ------------------------------------------------------------ train step
def _close_state(port: dict, ref: dict, mesh: str, want: str,
                 moments: bool) -> None:
    lr = OCFG.peak_lr            # the first step's rate, warmup 1
    names = [k[len(f"{want}/p/"):] for k in ref if k.startswith(f"{want}/p/")]
    assert sorted(names) == sorted(tmodel.abstract_params(
        get_smoke_config("qwen2_7b")))
    for k in names:
        np.testing.assert_allclose(port[f"{mesh}/p/{k}"],
                                   ref[f"{want}/p/{k}"], rtol=0, atol=2 * lr,
                                   err_msg=k)
        for mom in ("m", "v") if moments else ():
            w = ref[f"{want}/{mom}/{k}"]
            np.testing.assert_allclose(
                port[f"{mesh}/{mom}/{k}"], w, rtol=0,
                atol=1e-3 * float(np.abs(w).max()), err_msg=f"{mom} {k}")


@pytest.mark.parametrize("mesh", TAGS)
def test_train_step_on_a_mesh_matches_the_reference_on_it(runs, mesh):
    """The loss and the updated parameters of the reference's step on the
    same mesh (its gradients' scale is off there: see the module
    docstring)."""
    _, ref, port, _ = runs
    assert _rel(port[f"{mesh}/loss"], ref[f"{mesh}/loss"]) <= 1e-4
    _close_state(port, ref, mesh, mesh, moments=False)


@pytest.mark.parametrize("mesh", TAGS)
def test_train_step_on_a_mesh_matches_the_reference_on_one_device(runs,
                                                                  mesh):
    _, ref, port, _ = runs
    assert _rel(port[f"{mesh}/loss"], ref["one/loss"]) <= 1e-4
    assert _rel(port[f"{mesh}/grad_norm"], ref["one/grad_norm"]) <= 1e-4
    _close_state(port, ref, mesh, "one", moments=True)


@pytest.mark.parametrize("mesh", TAGS)
def test_train_step_on_a_mesh_matches_the_unsharded_step(runs, mesh,
                                                         monkeypatch):
    inputs, ref, port, _ = runs
    _, _, metrics = _unsharded_step(inputs, monkeypatch)
    assert _rel(port[f"{mesh}/loss"], metrics["loss"]) <= 1e-5
    assert _rel(ref["one/loss"], metrics["loss"]) <= 1e-5


# -------------------------------------------------------------- the loss
def _reference_scales(mesh: str, batch: int, vocab: int) -> tuple:
    """(dx, dhead) factors of the reference's sharded loss gradient against
    its one-device one: 1 / the data axes' size and 1 / ``model``'s where
    it takes its ``shard_map`` branch, 1 where it falls back."""
    dp, tp = (int(s) for s in mesh.split("x"))
    if batch % dp or vocab % tp:
        return 1.0, 1.0
    return 1.0 / dp, 1.0 / tp


def _close_grad(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("case", LOSS_CASES)
def test_fused_loss_on_a_mesh_matches_the_reference(runs, mesh, case):
    _, ref, port, _ = runs
    key = f"{mesh}/loss_{case}"
    assert _rel(port[f"{key}/loss"], ref[f"{key}/loss"]) <= 1e-6
    for g in ("dx", "dhead"):
        _close_grad(port[f"{key}/{g}"], ref[f"one/loss_{case}/{g}"])


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("case", LOSS_CASES)
def test_reference_sharded_loss_gradient_is_scaled(runs, mesh, case):
    """The reference's sharded dx and dhead times the factors of its
    ``shard_map`` transpose are the port's."""
    inputs, ref, port, _ = runs
    key = f"{mesh}/loss_{case}"
    fx, fh = _reference_scales(mesh, inputs[f"loss_{case}/x"].shape[0],
                               inputs[f"loss_{case}/head"].shape[1])
    assert (fx, fh) != (1.0, 1.0) or (case, mesh) == ("odd", "2x2")
    _close_grad(ref[f"{key}/dx"] / fx, port[f"{key}/dx"])
    _close_grad(ref[f"{key}/dhead"] / fh, port[f"{key}/dhead"])


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("case", LOSS_CASES)
def test_fused_loss_on_a_mesh_matches_the_unsharded_loss(runs, mesh, case):
    inputs, _, port, _ = runs
    x = torch.from_numpy(inputs[f"loss_{case}/x"]).requires_grad_()
    head = torch.from_numpy(inputs[f"loss_{case}/head"]).requires_grad_()
    lab = torch.from_numpy(inputs[f"loss_{case}/labels"])
    loss, _ = tloss.fused_ce_loss(x, head, lab, chunk=worker.LOSS_CHUNK,
                                  valid_vocab=int(inputs["valid_vocab"]))
    loss.backward()
    key = f"{mesh}/loss_{case}"
    assert _rel(port[f"{key}/loss"], loss.detach()) <= 1e-6
    for g, want in (("dx", x.grad), ("dhead", head.grad)):
        _close_grad(port[f"{key}/{g}"], want.numpy())


# ------------------------------------------------------------ placements
def _want_placements(spec, names) -> str:
    """The DTensor placements of a reference ``PartitionSpec`` on a mesh of
    ``names``: ``Shard(dim)`` on each mesh axis the spec names at ``dim``,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[names.index(a)] = Shard(dim)
    return repr(tuple(out))


def _jax_mesh(shape, names):
    return jax.sharding.AbstractMesh(tuple(shape), tuple(names))


@pytest.mark.parametrize("mesh", TAGS + [worker.tag(worker.ELASTIC)])
def test_parameters_are_placed_by_the_reference_specs(runs, mesh):
    """Every parameter of every layer, on each mesh, placed as the
    reference's ``logical_spec`` of its stacked name says (the leading L
    axis is never sharded)."""
    _, _, port, _ = runs
    cfg, jcfg = get_smoke_config("qwen2_7b"), jget_smoke("qwen2_7b")
    shape = tuple(int(s) for s in mesh.split("x"))
    names = ("data", "model")
    stacked = tmodel.abstract_params(cfg)
    seen = 0
    with jax.sharding.use_abstract_mesh(_jax_mesh(shape, names)):
        for name, logical in jmodel.param_logical(jcfg).items():
            spec = tuple(jsharding.logical_spec(stacked[name].shape, logical))
            per_layer = name not in tmodel.GLOBAL_KEYS
            assert not per_layer or spec[0] is None
            want = _want_placements(spec[1:] if per_layer else spec, names)
            assert want == repr(tuple(tsharding.placements(
                spec[1:] if per_layer else spec, tmesh.AbstractMesh(
                    shape, names))))
            for pname in ([f"layers.{i}.{name}" for i in
                           range(cfg.num_layers)] if per_layer else [name]):
                assert str(port[f"{mesh}/placement/{pname}"]) == want, pname
                if mesh in TAGS:
                    assert str(port[f"{mesh}/moment_placement/{pname}"]) \
                        == want, pname
                seen += 1
    assert seen == sum(1 for k in port if k.startswith(f"{mesh}/placement/"))


@pytest.mark.parametrize("mesh", TAGS)
def test_constraints_give_the_reference_specs(runs, mesh):
    """Each ``constrain`` of the train step (the residual after the
    embedding, q, the MLP hidden) gave the placements of the reference's
    ``logical_spec`` for its names and shape on the same mesh."""
    _, _, port, _ = runs
    shape = tuple(int(s) for s in mesh.split("x"))
    names = ("data", "model")
    calls = [ast.literal_eval(c) for c in port[f"{mesh}/constraints"]]
    seen = {c[0] for c in calls}
    assert seen == {("batch", "seq", "embed"),
                    ("batch", None, "heads", "head_dim"),
                    ("batch", None, "mlp")}
    with jax.sharding.use_abstract_mesh(_jax_mesh(shape, names)):
        for logical, xshape, got in calls:
            spec = tuple(jsharding.logical_spec(xshape, logical))
            assert got == _want_placements(spec, names), (logical, xshape)


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((2, 2), ("data", "model")), ((1, 4), ("data", "model"))])
def test_placements_of_every_spec_on_the_production_meshes(shape, names):
    """``placements`` of ``logical_spec`` for every parameter of every
    config and the logits' constraint, on abstract meshes (no process):
    the reference's spec, mesh axis by mesh axis."""
    from repro_torch.configs import ARCHS
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    mesh = tmesh.AbstractMesh(shape, names)
    with tmesh.set_mesh(mesh), jax.sharding.use_abstract_mesh(
            _jax_mesh(shape, names)):
        for arch in ARCHS:
            cfg, jcfg = get_config(arch), jget_config(arch)
            items = list(tmodel.param_logical(cfg).items())
            items.append(("logits", ("batch", None, "vocab")))
            for name, logical in items:
                dims = (tmodel.abstract_params(cfg)[name].shape
                        if name != "logits" else (256, 4, cfg.vocab_padded))
                spec = tsharding.logical_spec(dims, logical)
                want = tuple(jsharding.logical_spec(dims, logical))
                assert spec == want, (arch, name)
                assert repr(tuple(tsharding.placements(spec, mesh))) == \
                    _want_placements(want, names), (arch, name)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_written_on_2x2_restores_on_4x1(runs):
    _, _, port, _ = runs
    e = worker.tag(worker.ELASTIC)
    assert int(port[f"{e}/step"]) == 1 and int(port[f"{e}/opt_step"]) == 1
    n = 0
    for key in port:
        if key.startswith("2x2/") and key.split("/")[1] in ("p", "m", "v"):
            np.testing.assert_array_equal(port[f"{e}/{key[4:]}"], port[key])
            n += 1
    assert n == 3 * len(tmodel.abstract_params(get_smoke_config("qwen2_7b")))


def test_checkpoint_written_on_2x2_restores_on_one_process(runs):
    _, _, port, ckpt = runs
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, seed=5, device="cpu", dtype=torch.float32)
    opt = tadamw.init_opt_state(model, OCFG)
    restored, step = tckpt.restore_checkpoint(
        ckpt, tloop.checkpoint_state(model, opt))
    tloop.load_checkpoint_state(model, opt, restored)
    assert step == 1 and int(opt["step"]) == 1
    for name, arr in tmodel.params_to_numpy(model).items():
        np.testing.assert_array_equal(arr, port[f"2x2/p/{name}"])
    for mom in ("m", "v"):
        for name, t in tmodel.stack_layers(cfg, opt[mom]).items():
            np.testing.assert_array_equal(t.numpy(), port[f"2x2/{mom}/{name}"])


def test_checkpoint_written_on_2x2_restores_in_the_reference(runs):
    _, _, port, ckpt = runs
    jcfg = jget_smoke("qwen2_7b")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jadamw.init_opt_state(jparams, jadamw.OptimConfig())
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": jparams, "opt": jopt})
    restored, step = jckpt.restore_checkpoint(ckpt, like)
    assert step == 1 and np.asarray(restored["opt"]["step"]).item() == 1
    for name in jparams:
        np.testing.assert_array_equal(np.asarray(restored["params"][name]),
                                      port[f"2x2/p/{name}"])
        for mom in ("m", "v"):
            np.testing.assert_array_equal(
                np.asarray(restored["opt"][mom][name]),
                port[f"2x2/{mom}/{name}"])


def test_one_device_and_abstract_meshes_leave_tensors_alone():
    """``constrain`` returns ``x`` itself with no mesh, on an abstract mesh
    of many devices (the dry run's), and on one of one; ``distribute``
    likewise off a device mesh."""
    x = torch.arange(12.0).reshape(3, 4)
    assert tsharding.constrain(x, ("batch", None)) is x
    for mesh in (tmesh.AbstractMesh((1,), ("data",)),
                 tmesh.make_production_mesh()):
        with tmesh.set_mesh(mesh):
            assert tsharding.constrain(x, ("batch", None)) is x
            assert tsharding.distribute(x, ("batch", None)) is x
    assert tmodel.init_params(get_smoke_config("qwen2_7b"), device="cpu",
                              mesh=tmesh.make_production_mesh()).mesh is None


# --------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_on_two_cpu_processes_ends_at_the_one_process_loss(
        tmp_path):
    """``python -m repro_torch.launch.train --demo --device cpu`` as two
    hosts of one process each (``--coordinator``, ``--num-hosts 2``, the
    smoke mesh of data 2) against one process alone: the final losses
    within 1e-4 relative.  Then the two-process run's last checkpoint is
    removed (a death after step 2's) and the same commands resume from
    step 2 to the same final loss, bit for bit; that checkpoint restores
    in the one-process port."""
    common = [sys.executable, "-m", "repro_torch.launch.train", "--demo",
              "--device", "cpu", "--steps", "4", "--ckpt-every", "2",
              "--seq", "16", "--global-batch", "4"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        OMP_NUM_THREADS="2")

    def two_hosts():
        port = _free_port()
        return [subprocess.Popen(
            common + ["--ckpt-dir", str(tmp_path / "two"), "--coordinator",
                      f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id",
                      str(h)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for h in (0, 1)]

    def finish(procs):
        outs = [p.communicate(timeout=600) for p in procs]
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
        return [out for out, _ in outs]

    def final(out):
        line = [ln for ln in out.splitlines() if "final loss:" in ln]
        assert len(line) == 1, out
        return line[0], float(line[0].rsplit(":", 1)[1])
    procs = two_hosts() + [subprocess.Popen(
        common + ["--ckpt-dir", str(tmp_path / "one")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    outs = finish(procs)
    (two_line, two), (one_line, one) = final(outs[0]), final(outs[2])
    assert "on the 2 mesh of cpu" in two_line and "on cpu" in one_line
    assert "final loss" not in outs[1]             # rank 1 does not log
    assert abs(two - one) / abs(one) <= 1e-4, (two, one)
    assert tckpt.latest_step(str(tmp_path / "two")) == 4
    import shutil
    shutil.rmtree(tmp_path / "two" / "step-00000004")
    again = finish(two_hosts())
    assert "resumed from step 2" in again[0]
    assert final(again[0])[1] == two
    cfg = get_smoke_config("qwen2_7b")
    model = tmodel.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    opt = tadamw.init_opt_state(model, OCFG)
    restored, step = tckpt.restore_checkpoint(
        str(tmp_path / "two"), tloop.checkpoint_state(model, opt))
    assert step == 4 and np.isfinite(
        restored["params"]["embed"].numpy()).all()


def test_port_mesh_modules_import_no_jax():
    """The mesh, sharding, model, loss, step, optimizer, checkpoint, loop
    and launcher modules in a fresh interpreter import neither ``jax`` nor
    ``repro``."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.launch.train, repro_torch.launch.mesh
        import repro_torch.parallel.sharding, repro_torch.models.model
        import repro_torch.train.loop
        import torch_mesh_worker
        bad = sorted(m for m in sys.modules if m == "jax" or
                     m.startswith("jax.") or m == "repro" or
                     m.startswith("repro."))
        assert not bad, bad
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(__file__)]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
