"""The port's dry run (``repro_torch.launch.dryrun``), its meshes
(``launch.mesh``), shapes (``launch.shapes``) and sharding rules
(``parallel.sharding``) against the reference's.

* ``logical_spec`` equals ``repro.parallel.sharding.logical_spec`` (run
  under ``jax.sharding.use_abstract_mesh``, no devices) for every
  parameter and cache entry of every architecture, at the meshes (1,)
  ``data``, 16x16 and 2x16x16, under the default, ``serve_tp`` and
  ``no_fsdp`` rules; the reference's thread-local rules are restored after
  each case.  ``tests/test_sharding.py``'s cases hold for the port.
* ``SHAPES``, ``skip_reason`` (all 40 cells) and ``batch_specs`` equal the
  reference's.
* Every cell's per-device argument bytes, at the three meshes and the
  variants "", ``serve_tp`` and ``no_fsdp``, equal the sums of the
  reference's specs over the reference's abstract arguments; and in a
  subprocess with 4 host devices they equal XLA's compiled
  ``argument_size_in_bytes`` on a 2x2 mesh (smoke configs).
* The production meshes' shapes and axis names equal the reference's
  (a subprocess forcing 512 host devices).
* The flash wrappers' meta route: outputs of the kernel's shapes, no
  launch, no plain version, and 4·B·H·hd flops per allowed pair forward
  (2.5 times that backward), under causal, windowed, offset and Skv != Sq
  masks.
* A smoke step traced on meta (``dryrun.FlopCount``) counts, attention
  aside, the flops that ``FlopCounterMode`` counts over the same step run
  on CPU tensors.
* :class:`LiveBytes` on cases with known answers, and the CLI in a fresh
  interpreter that imports neither ``jax`` nor ``repro``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils import checkpoint as torch_checkpoint
from torch.utils.flop_counter import FlopCounterMode

# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adamw import OptimConfig as JOptimConfig  # noqa: E402
from repro.optim.adamw import abstract_opt_state as jabstract_opt  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import attention as tattention  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.adamw import OptimConfig, init_opt_state  # noqa: E402
from repro_torch.parallel import sharding as tsharding  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1": ((1,), ("data",)), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = ("", "serve_tp", "no_fsdp")
CELLS = [(a, s) for a in ARCHS for s in tshapes.SHAPES]


def _rules(variant: str, kind: str = "prefill") -> dict:
    """The reference's rules of a variant: ``no_fsdp``, and ``serve_tp``
    on a serving cell, map ``fsdp`` to None."""
    rules = dict(jsharding.DEFAULT_RULES)
    if "no_fsdp" in variant or ("serve_tp" in variant and kind != "train"):
        rules["fsdp"] = None
    return rules


@pytest.fixture
def reference_rules():
    """The reference's thread-local rules, restored after the case."""
    saved = jsharding.get_rules()
    yield
    jsharding.set_rules(saved)


@pytest.fixture
def port_rules():
    saved = tsharding.get_rules()
    yield
    tsharding.set_rules(saved)


def _both_meshes(name: str):
    sizes, names = MESHES[name]
    return (jax.sharding.use_abstract_mesh(JAbstractMesh(sizes, names)),
            tmesh.set_mesh(tmesh.AbstractMesh(sizes, names)))


# ------------------------------------------------------------- sharding
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_spec_matches_reference(arch, mesh_name, variant,
                                        reference_rules, port_rules):
    cfg = get_config(arch)
    jsharding.set_rules(_rules(variant))
    tsharding.set_rules(_rules(variant))
    params = tmodel.abstract_params(cfg)
    p_names = tmodel.param_logical(cfg)
    assert p_names == jmodel.param_logical(jget_config(arch))
    cache = tmodel.init_cache(cfg, 2, 64, device="meta")
    c_names = tmodel.cache_logical(cfg)
    assert c_names == jmodel.cache_logical(jget_config(arch))
    leaves = [(k, t.shape, p_names[k]) for k, t in params.items()]
    leaves += [(k, t.shape, c_names[k]) for k, t in cache.items()
               if k != "pos"]
    # the cache's batch axis at the cells' global batches too
    for B in (1, 32, 128):
        big = tmodel.init_cache(cfg, B, 64, device="meta")
        leaves += [(k, t.shape, c_names[k]) for k, t in big.items()
                   if k != "pos"]
    jctx, tctx = _both_meshes(mesh_name)
    with jctx:
        want = [tuple(jsharding.logical_spec(s, n)) for _, s, n in leaves]
    with tctx:
        got = [tsharding.logical_spec(s, n) for _, s, n in leaves]
    assert got == want
    assert tsharding.spec_tree(p_names, params) == {
        k: tsharding.logical_spec(t.shape, p_names[k])
        for k, t in params.items()}      # no mesh: all None
    assert all(e is None for spec in tsharding.spec_tree(
        p_names, params).values() for e in spec)


def test_divisibility_fallback():
    with tmesh.set_mesh(tmesh.AbstractMesh((1,), ("data",))):
        # data axis size 1 -> everything divisible, sharded on 'data'
        assert tsharding.logical_spec((8, 16), ("batch", None)) == \
            ("data", None)
    with tmesh.set_mesh(tmesh.make_production_mesh()):
        # 28 heads do not divide 16: head_dim takes the model axis
        assert tsharding.logical_spec((3584, 28, 128),
                                      ("fsdp", "heads", "head_dim")) == \
            ("data", None, "model")
        assert tsharding.logical_spec((12, 64), ("batch", None)) == \
            (None, None)
    # no mesh context -> fully unsharded
    assert tsharding.logical_spec((8, 16), ("batch", None)) == (None, None)


def test_no_mesh_axis_used_twice():
    with tmesh.set_mesh(tmesh.AbstractMesh((1,), ("data",))):
        # both "batch" and "fsdp" map to data; only the first may take it
        assert tsharding.logical_spec((4, 4), ("batch", "fsdp")) == \
            ("data", None)
    with tmesh.set_mesh(tmesh.make_production_mesh(multi_pod=True)):
        # a tuple rule keeps the member axes the mesh has
        assert tsharding.logical_spec((64, 32), ("batch", "fsdp")) == \
            (("pod", "data"), None)
    with tmesh.set_mesh(tmesh.make_production_mesh()):
        assert tsharding.logical_spec((64, 32), ("batch", "fsdp")) == \
            ("data", None)


def test_set_rules_and_get_rules_are_per_thread(port_rules):
    import threading
    rules = dict(tsharding.DEFAULT_RULES, fsdp=None)
    tsharding.set_rules(rules)
    assert tsharding.get_rules() == rules
    seen = []
    t = threading.Thread(target=lambda: seen.append(tsharding.get_rules()))
    t.start()
    t.join()
    assert seen == [tsharding.DEFAULT_RULES]
    with tmesh.set_mesh(tmesh.make_production_mesh()):
        assert tsharding.logical_spec((64, 32), ("fsdp", "mlp")) == \
            (None, "model")


def test_constrain_is_the_identity_on_one_device_and_raises_on_many():
    """``constrain`` is the identity with no mesh and on one device; on an
    abstract mesh of many (the dry run's: no devices) it gives ``x``
    itself too, and a device mesh would take the spec's placements (held
    across processes in ``tests/test_torch_mesh_train.py``)."""
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(32.0).reshape(16, 2)
    assert tsharding.constrain(x, ("batch", None)) is x
    with tmesh.set_mesh(dryrun.card_mesh()):
        assert tsharding.constrain(x, ("batch", None)) is x
    mesh = tmesh.make_production_mesh()
    with tmesh.set_mesh(mesh):
        assert tsharding.constrain(x, ("batch", None)) is x
        spec = tsharding.logical_spec(x.shape, ("batch", None))
    assert spec == ("data", None)
    assert tsharding.placements(spec, mesh) == [Shard(0), Replicate()]


def test_shard_bytes():
    mesh = tmesh.make_production_mesh(multi_pod=True)
    t = torch.empty(64, 32, 16, dtype=torch.bfloat16, device="meta")
    assert tsharding.shard_bytes(t, (None, None, None), mesh) == 64 * 32 * 32
    assert tsharding.shard_bytes(t, (("pod", "data"), None, "model"),
                                 mesh) == 64 * 32 * 32 // 512
    assert tsharding.shard_bytes(torch.empty((), dtype=torch.int32,
                                             device="meta"), (), mesh) == 4
    with pytest.raises(ValueError, match="does not split"):
        tsharding.shard_bytes(torch.empty(8, 32, device="meta"),
                              ("model", None), mesh)


# ---------------------------------------------------------------- meshes
def test_meshes():
    sp, mp = tmesh.make_production_mesh(), tmesh.make_production_mesh(
        multi_pod=True)
    assert (sp.shape, sp.size, sp.name) == ({"data": 16, "model": 16}, 256,
                                            "16x16")
    assert (mp.axis_names, mp.size) == (("pod", "data", "model"), 512)
    smoke = tmesh.make_smoke_mesh("cpu")
    assert (smoke.axis_sizes, smoke.axis_names) == ((1,), ("data",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tmesh.make_smoke_mesh()
    assert tmesh.get_abstract_mesh() is None
    with tmesh.set_mesh(sp):
        assert tmesh.get_abstract_mesh() is sp
        with tmesh.set_mesh(mp):
            assert tmesh.get_abstract_mesh() is mp
        assert tmesh.get_abstract_mesh() is sp
    assert tmesh.get_abstract_mesh() is None


def test_production_meshes_match_reference():
    """The reference's meshes need 512 devices: a subprocess forces them
    (mesh creation only)."""
    code = textwrap.dedent("""
        import json, os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
        os.environ["JAX_PLATFORMS"] = "cpu"
        from repro.launch.mesh import make_production_mesh
        out = {}
        for mp in (False, True):
            m = make_production_mesh(multi_pod=mp)
            out[str(mp)] = [list(m.axis_names), [int(s) for s in
                            m.devices.shape], int(m.devices.size)]
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for mp in (False, True):
        m = tmesh.make_production_mesh(multi_pod=mp)
        assert [list(m.axis_names), list(m.axis_sizes), m.size] == \
            want[str(mp)]


# ---------------------------------------------------------------- shapes
def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}


_DT = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"): torch.float32,
       jnp.dtype("bfloat16"): torch.bfloat16}


def _like(want, got) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _like(w, got[k])
            continue
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _DT[jnp.dtype(w.dtype)], k


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reason_and_batch_specs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = jshapes.skip_reason(jcfg, jshapes.SHAPES[shape])
    assert tshapes.skip_reason(cfg, tshapes.SHAPES[shape]) == want
    if want is None:
        _like(jshapes.batch_specs(jcfg, jshapes.SHAPES[shape]),
              tshapes.batch_specs(cfg, tshapes.SHAPES[shape]))


# --------------------------------------------------------- argument bytes
def _reference_arg_bytes(arch: str, shape_name: str, mesh_name: str,
                         variant: str) -> int:
    """The reference's abstract arguments of the cell (its
    ``build_step_and_specs``: parameters, AdamW state and batch in train;
    parameters and batch (the cache in it) serving), each leaf's bytes
    over the mesh axes its ``logical_spec`` names."""
    cfg, shape = jget_config(arch), jshapes.SHAPES[shape_name]
    sizes, names = MESHES[mesh_name]
    axis = dict(zip(names, sizes))
    jsharding.set_rules(_rules(variant, shape.kind))
    params = jmodel.abstract_params(cfg)
    if "serve_tp" in variant and shape.kind != "train":
        params = {k: jax.ShapeDtypeStruct(v.shape, jnp.bfloat16)
                  for k, v in params.items()}
    p_names = jmodel.param_logical(cfg)
    batch = jshapes.batch_specs(cfg, shape)

    def nbytes(x, spec):
        n = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= axis[a]
        total = x.size * jnp.dtype(x.dtype).itemsize
        assert total % n == 0
        return total // n

    def batch_spec(name, x):
        if name == "mrope_positions":
            return jsharding.logical_spec(x.shape, (None, "batch", None))
        if name == "pos" or not x.ndim:
            return ()
        return jsharding.logical_spec(x.shape,
                                      ("batch",) + (None,) * (x.ndim - 1))

    with jax.sharding.use_abstract_mesh(JAbstractMesh(sizes, names)):
        p_bytes = sum(nbytes(v, jsharding.logical_spec(v.shape, p_names[k]))
                      for k, v in params.items())
        if shape.kind == "train":
            opt = jabstract_opt(params, JOptimConfig())
            p_specs = {k: jsharding.logical_spec(v.shape, p_names[k])
                       for k, v in params.items()}
            o_bytes = sum(nbytes(opt[m][k], p_specs[k]) for m in ("m", "v")
                          for k in params) + nbytes(opt["step"], ())
            return p_bytes + o_bytes + sum(
                nbytes(v, batch_spec(k, v)) for k, v in batch.items())
        if shape.kind == "prefill":
            return p_bytes + sum(nbytes(v, batch_spec(k, v))
                                 for k, v in batch.items())
        c_names = jmodel.cache_logical(cfg)
        c_bytes = sum(nbytes(v, jsharding.logical_spec(v.shape, c_names[k])
                             if k != "pos" else ())
                      for k, v in batch["cache"].items())
        return p_bytes + c_bytes + nbytes(
            batch["tokens"], batch_spec("tokens", batch["tokens"]))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_match_reference_specs(arch, shape, mesh_name,
                                              variant, reference_rules,
                                              port_rules):
    cfg = get_config(arch)
    if tshapes.skip_reason(cfg, tshapes.SHAPES[shape]):
        return
    mesh = tmesh.AbstractMesh(*MESHES[mesh_name])
    with tmesh.set_mesh(mesh):
        _, args, specs, donate, accum = dryrun.build_step_and_specs(
            cfg, tshapes.SHAPES[shape], mesh, variant)
    got = dryrun.tree_shard_bytes(args, specs, mesh)
    assert got == _reference_arg_bytes(arch, shape, mesh_name, variant)
    dp = mesh.size // mesh.shape.get("model", 1)
    if tshapes.SHAPES[shape].kind == "train":
        assert donate == (0, 1)
        assert accum == max(1, min(dryrun.ACCUM_BY_ARCH.get(
            arch, dryrun.ACCUM_STEPS), tshapes.SHAPES[shape].global_batch
            // dp))
    # run_cell's multi-device cells: the same bytes, no trace
    if mesh.size > 1 and variant == "" and shape == "train_4k":
        cell = dryrun.run_cell(arch, shape, mesh)
        assert cell["memory"]["argument_size_in_bytes"] == got
        assert cell["memory"]["temp_size_in_bytes"] is None
        assert cell["flops"] is None and cell["collective_bytes"] is None
        assert "temp_reason" in cell and cell["num_devices"] == mesh.size


_XLA_SCRIPT = textwrap.dedent("""
    import json, os
    # XLA unoptimised and without multi-threaded Eigen: the programs are
    # tiny, and the suite runs several processes at once
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_cpu_multi_thread_eigen=false")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    assert len(jax.devices()) == 4    # locks the count before the import
    from repro import compat          # noqa: F401
    from jax.sharding import AxisType
    from repro.launch import dryrun   # its 512-device flag comes too late
    from repro.configs import get_smoke_config
    from repro.launch.shapes import ShapeSpec
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ("qwen2_7b", "mamba2_2_7b"):
        cfg = get_smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            with jax.set_mesh(mesh):
                r = dryrun._compile_and_analyze(
                    cfg, ShapeSpec(kind, 64, 8, kind), mesh)
            out[arch + "/" + kind] = r["memory"]["argument_size_in_bytes"]
    print(json.dumps(out))
""")


def test_argument_bytes_equal_xla_on_a_2x2_mesh(port_rules):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _XLA_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
    got = {}
    for arch in ("qwen2_7b", "mamba2_2_7b"):
        cfg = get_smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            with tmesh.set_mesh(mesh):
                _, args, specs, _, _ = dryrun.build_step_and_specs(
                    cfg, tshapes.ShapeSpec(kind, 64, 8, kind), mesh)
            got[f"{arch}/{kind}"] = dryrun.tree_shard_bytes(args, specs,
                                                            mesh)
    assert got == want


# ----------------------------------------------------- the flash meta route
FLASH_CASES = [
    # B, Sq, Skv, H, KV, hd, mask
    (2, 256, 256, 4, 2, 64, dict(causal=True)),
    (1, 300, 300, 4, 4, 128, dict(causal=True, window=64)),
    (2, 64, 320, 2, 1, 32, dict(causal=True, q_offset=256)),
    (1, 96, 200, 3, 1, 16, dict(causal=True, window=40, q_offset=100,
                                kv_len=150)),
    (2, 128, 1500, 4, 4, 64, dict(causal=False)),
    (1, 50, 80, 2, 2, 256, dict(causal=False, kv_len=33)),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_meta_route_counts_the_kernels_flops(case, monkeypatch):
    B, Sq, Skv, H, KV, hd, mask = case
    fwd, bwd = tattention.flash_attention_fwd, tattention.flash_attention_bwd

    def forbidden(*a, **k):
        raise AssertionError("a meta tensor reached a plain version")
    monkeypatch.setattr(tattention, "flash_attention_fwd_plain", forbidden)
    monkeypatch.setattr(tattention, "flash_attention_bwd_plain", forbidden)
    launches = (fwd.launches, bwd.launches)
    for f in (fwd, bwd):
        f.traced = f.traced_flops = 0
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(B, Sq, H, hd, **meta)
    k = torch.empty(B, Skv, KV, hd, **meta)
    out, lse = fwd(q, k, k.clone(), return_lse=True, **mask)
    assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype,
                                                      "meta")
    assert (lse.shape, lse.dtype) == ((B, H, Sq), torch.float32)
    dq, dk, dv = bwd(q, k, k.clone(), out, lse, torch.empty_like(q), **mask)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    pairs = int(tattention.allowed(Sq, Skv, **mask).sum())
    assert tattention.allowed_pairs(Sq, Skv, **mask) == pairs
    assert (fwd.traced, bwd.traced) == (1, 1)
    assert fwd.traced_flops == 4 * B * H * pairs * hd
    assert bwd.traced_flops == 10 * B * H * pairs * hd // 1
    assert (fwd.launches, bwd.launches) == launches


def test_flash_meta_route_keeps_the_card_checks():
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(1, 64, 2, 48, **meta)      # head_dim 48: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        tattention.flash_attention_fwd(q, q, q)
    q = torch.empty(1, 2, 64, 64, **meta).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tattention.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="mixed"):
        tattention.flash_attention_fwd(torch.empty(1, 8, 1, 64, **meta),
                                       *[torch.zeros(1, 8, 1, 64)] * 2)


# ------------------------------------------------- the trace against the CPU
def _cpu_args(cfg, kind: str, B: int, S: int, seed: int = 0):
    """The dry run's arguments for (cfg, kind) as CPU tensors: fp32 flat
    parameters, AdamW state and a demo batch."""
    model = tmodel.init_params(cfg, seed=seed, device="cpu",
                               dtype=torch.float32)
    named = {n: p.detach() for n, p in model.named_parameters()}
    params = tmodel.stack_layers(cfg, named)
    gen = torch.Generator().manual_seed(seed)
    batch = tshapes.demo_batch(cfg, kind, B, S, gen)
    if kind == "train":
        return params, init_opt_state(params, OptimConfig()), batch
    return params, batch


TRACE_CASES = [("qwen2_7b", "train", 1), ("qwen2_7b", "train", 4),
               ("qwen2_7b", "prefill", 1), ("qwen2_7b", "decode", 1),
               ("whisper_small", "train", 2), ("whisper_small", "decode", 1),
               ("mamba2_2_7b", "train", 1), ("hymba_1_5b", "prefill", 1),
               ("qwen2_moe_a2_7b", "train", 1), ("gemma3_4b", "decode", 1),
               ("qwen2_vl_7b", "prefill", 1)]


@pytest.mark.parametrize("arch,kind,accum", TRACE_CASES)
def test_meta_trace_counts_the_cpu_steps_flops(arch, kind, accum,
                                               monkeypatch):
    """The trace's ``FlopCount`` (``FlopCounterMode``'s formulas without
    its module tracker) against ``FlopCounterMode`` itself over the same
    step on CPU tensors, attention aside: the CPU runs the flash wrappers'
    plain versions, whose products the counter sees; they are counted
    apart (a counter inside the plain version) and taken off."""
    cfg = get_smoke_config(arch)
    B, S = 4, 32
    shape = tshapes.ShapeSpec(kind, S, B, kind)
    mesh = dryrun.card_mesh()
    with tmesh.set_mesh(mesh):
        fn, args, _, _, got_accum = dryrun.build_step_and_specs(
            cfg, shape, mesh, f"accum{accum}" if kind == "train" else "")
    assert got_accum == accum
    traced = dryrun.trace(fn, args)
    runs = min(accum, dryrun.TRACED_MICROBATCHES)

    attn = [0]

    def counted(plain):
        def run(*a, **k):
            with FlopCounterMode(display=False) as inner:
                r = plain(*a, **k)
            attn[0] += inner.get_total_flops()
            return r
        return run
    for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(tattention, name,
                            counted(getattr(tattention, name)))
    if kind == "train":
        cpu_fn = dryrun.train_fn(cfg, accum)
    elif kind == "prefill":
        cpu_fn = dryrun.prefill_fn(cfg, S)
    else:
        cpu_fn = dryrun.decode_fn(cfg, S - 1)
    with FlopCounterMode(display=False) as outer:
        cpu_fn(*_cpu_args(cfg, kind, B, S))
    assert traced["matmul_flops"] * accum // runs == \
        outer.get_total_flops() - attn[0]
    assert traced["matmul_flops"] > 0
    calls = traced["flash_calls"]
    if cfg.block in ("attn", "hybrid") and kind != "decode":
        assert calls["flash_attention_fwd"] > 0 and traced["flash_flops"] > 0
        assert attn[0] > 0
    assert (calls["flash_attention_bwd"] > 0) == (
        kind == "train" and cfg.block != "ssm")


@pytest.mark.parametrize("arch", ["qwen2_7b", "whisper_small",
                                  "qwen2_vl_7b"])
def test_traced_cut_of_an_accumulating_step_is_the_whole_steps(arch):
    """A train step of 4 microbatches, traced whole and as the dry run
    cuts it (two microbatches over half the rows, a view; axis 1 of
    ``mrope_positions``): the same temp, outputs and argument bytes, and
    half the products' flops and flash calls."""
    cfg = get_smoke_config(arch)
    shape = tshapes.ShapeSpec("train", 32, 8, "train")
    mesh = dryrun.card_mesh()
    with tmesh.set_mesh(mesh):
        cut, args, _, _, accum = dryrun.build_step_and_specs(
            cfg, shape, mesh, "accum4")
    assert accum == 4
    whole = dryrun.trace(dryrun.train_fn(cfg, 4), args)
    part = dryrun.trace(cut, args)
    assert (part["temp"], part["output"]) == (whole["temp"], whole["output"])
    assert part["temp"] > 0
    assert 2 * part["matmul_flops"] == whole["matmul_flops"]
    assert {k: 2 * v for k, v in part["flash_calls"].items()} == \
        whole["flash_calls"]
    rows = dryrun.leading_rows(args[2], 2, 4)
    for k, x in rows.items():
        ax = 1 if k == "mrope_positions" else 0
        assert x.shape[ax] * 2 == args[2][k].shape[ax]
        assert x.untyped_storage()._cdata == \
            args[2][k].untyped_storage()._cdata


# ---------------------------------------------------------- the live bytes
def test_live_bytes_chain_view_and_freed_intermediate():
    x = torch.empty(1024, device="meta")         # an argument: not counted
    with dryrun.LiveBytes(known=(x,)) as live:
        a = x * 2                                 # 4096
        b = a + 1                                 # 8192: the peak
        del a                                     # 4096
        v = b[:512]                               # a view adds nothing
        assert live.live == 4096
        c = v * 3                                 # + 2048
        del b                                     # v holds b's storage
        assert live.live == 6144
        del v                                     # b's storage freed
        y = torch.empty(10, device="meta")        # 40 B, rounded to 512
        x.mul_(2)                                 # in place on an argument
    assert (live.live, live.peak) == (2048 + 512, 8192)
    del c, y


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_live_bytes_sees_the_checkpoint_recompute(use_checkpoint):
    """f(h) = sin(2 h) over 1024 fp32 values (4096 B a tensor).  Without
    the checkpoint the forward keeps 2 h for sin's backward (8192 B live
    after it); with it only the output (4096 B).  Either way the backward
    peaks at 17408 B: the loss and its seed (512 B each), the output, 2 h
    (kept, or recomputed by the checkpoint), cos(2 h) and the product;
    the gradient and the output stay."""
    h = torch.empty(1024, device="meta", requires_grad=True)

    def f(t):
        return (t * 2).sin()
    with dryrun.LiveBytes(known=(h,)) as live:
        out = (torch_checkpoint.checkpoint(f, h, use_reentrant=False)
               if use_checkpoint else f(h))
        after_forward = live.live
        out.sum().backward()
    assert after_forward == (4096 if use_checkpoint else 8192)
    assert (live.peak, live.live) == (17408, 8192)
    assert h.grad is not None


def test_run_cell_on_the_card_mesh():
    cell = dryrun.run_cell("mamba2_2_7b", "long_500k", dryrun.card_mesh())
    mem = cell["memory"]
    assert cell["status"] == "ok" and cell["mesh"] == "card"
    cfg = get_config("mamba2_2_7b")
    cache = tmodel.init_cache(cfg, 1, 524288, device="meta")
    cache_bytes = sum(t.numel() * t.element_size() for k, t in cache.items()
                      if k != "pos") + 4
    assert mem["alias_size_in_bytes"] == cache_bytes
    assert mem["argument_size_in_bytes"] == cache_bytes + 4 + 4 * sum(
        t.numel() for t in tmodel.abstract_params(cfg).values())
    assert mem["temp_size_in_bytes"] > 0 and cell["flops"] > 0
    assert cell["fits_card"] is True
    assert cell["model_flops"] == 2.0 * cfg.active_param_count()
    skipped = dryrun.run_cell("qwen2_7b", "long_500k", dryrun.card_mesh())
    assert skipped["status"] == "skipped" and "reason" in skipped


def test_cli_in_a_fresh_interpreter(tmp_path):
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["dryrun", "--card", "--arch", "mamba2-2.7b", "--shape",
                    "long_500k", "--out", {str(tmp_path)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
        assert "jax" not in sys.modules and "repro" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    cell = json.loads((tmp_path / "mamba2_2_7b-long_500k-card.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["fits_card"] is True
    assert "fits_card=True" in res.stdout
