"""The port's serving path across processes against the JAX package, on the
CPU.

The port runs in 4 processes of one ``gloo`` group
(``tests/torch_mesh_worker.py``, one spawn a mesh, every configuration in
it) on (data, model) device meshes of (2, 2) and (1, 4), under the
reference's ``serve_tp`` rules (``fsdp`` mapped to None: TP-only weights);
the reference runs in a subprocess with 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) under the same
rules on the same meshes and on one device.  Both take the same numpy
inputs at fp32: the smoke configs of Qwen2-7B (GQA: its 2 KV heads do not
divide 4, so on (1, 4) the caches shard ``head_dim``), Command-R+ (the
parallel block, tied head), Granite-20B (MQA), Gemma3-4B (sliding windows)
and Qwen2-VL-7B (M-RoPE and a visual prefix), their parameters carried into
the port by ``params_from_numpy``, 4 prompts of 40 tokens.  Tolerances:

* the prefill's last-position logits and each decode step's: within 1e-4
  of their largest magnitude, against the reference on the same mesh, on
  one device, and against the port unsharded;
* the KV caches after the prefill and after 3 decode steps: within 1e-5 of
  their largest magnitude, against the reference on the same mesh and on
  one device;
* ``greedy_generate``'s ids: equal to the reference's one-device greedy
  loop and to the unsharded port's on each row up to its first step whose
  top-2 margin (of the reference's logits) is within the logits'
  tolerance, and every process holds the same ids;
* the placements of the parameters and of the caches: the reference's
  ``logical_spec``s under ``serve_tp``, exactly; the vocab-parallel lookup
  bit for bit the plain one; ``init_params`` of one seed the same on
  (2, 2), (1, 4) and one process, exactly; each process's local bytes the
  dry run's ``shard_bytes``, exactly.
"""
import ast
import os
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

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
from repro_torch.parallel import sharding as tsharding  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from torch_checks import grid_positions  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TAGS = [worker.tag(s) for s in worker.MESHES]
ARCHS = list(worker.SERVED)
B, S, STEPS = worker.SERVE_BATCH, worker.SERVE_SEQ, worker.SERVE_STEPS
LOGIT_FRAC, CACHE_FRAC = 1e-4, 1e-5
NAMES = ("data", "model")

_REFERENCE = """
import contextlib, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_smoke_config
from repro.models import model as jmodel
from repro.parallel import sharding as jsharding
from repro.parallel.sharding import logical_spec
from repro.serve import step as jstep
assert len(jax.devices()) == 4, jax.devices()
jmodel.COMPUTE_DTYPE = jnp.float32
jsharding.set_rules(dict(jsharding.DEFAULT_RULES, fsdp=None))   # serve_tp
data = dict(np.load(sys.argv[1]))
B, S, STEPS = SERVE
out = {}
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    logical = jmodel.param_logical(cfg)
    key = arch + "/p/"
    params = {k[len(key):]: jnp.asarray(v) for k, v in data.items()
              if k.startswith(key)}
    extra = {k: jnp.asarray(data[arch + "/" + k])
             for k in ("visual", "mrope_positions") if arch + "/" + k in data}
    names = {"tokens": ("batch", None), "visual": ("batch", None, None),
             "mrope_positions": (None, "batch", None)}
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
            batch = {k: put(v, names[k]) for k, v in extra.items()}
            batch["tokens"] = put(jnp.asarray(data[arch + "/tokens"]),
                                  names["tokens"])
            prefill = jax.jit(jstep.make_prefill_step(cfg, max_len=S + STEPS))
            decode = jax.jit(jstep.make_decode_step(cfg))
            logits, cache = prefill(p, batch)
            out[f"{tag}/{arch}/prefill_logits"] = np.asarray(logits)
            for nm in ("k", "v"):
                out[f"{tag}/{arch}/prefill_cache/{nm}"] = np.asarray(cache[nm])
            if shape is None:          # the greedy loop, its logits kept
                c, lg, ids, all_lg = cache, logits, [], []
                for i in range(STEPS):
                    all_lg.append(np.asarray(lg[:, -1]))
                    ids.append(jnp.argmax(lg[:, -1, :cfg.vocab_size], -1))
                    if i < STEPS - 1:
                        lg, c = decode(p, {"tokens": ids[-1][:, None],
                                           "cache": c})
                out[f"{tag}/{arch}/greedy"] = np.asarray(jnp.stack(ids, 1))
                out[f"{tag}/{arch}/greedy_logits"] = np.stack(all_lg)
            dec = []
            for i in range(STEPS - 1):
                logits, cache = decode(p, {
                    "tokens": put(jnp.asarray(data[arch + "/decode"][i]),
                                  names["tokens"]), "cache": cache})
                dec.append(np.asarray(logits))
            out[f"{tag}/{arch}/decode_logits"] = np.stack(dec)
            out[f"{tag}/{arch}/pos"] = np.asarray(cache["pos"])
            for nm in ("k", "v"):
                out[f"{tag}/{arch}/decode_cache/{nm}"] = np.asarray(cache[nm])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs(path: str) -> dict:
    """Seeded numpy inputs for every served configuration: its parameters
    (norm scales and biases random too), prompts, the tokens of the decode
    steps and, for the VLM, a visual prefix and M-RoPE grid positions."""
    rng = np.random.default_rng(17)
    d = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        for k, t in tmodel.abstract_params(cfg).items():
            scale = 0.3 if k in tmodel.NORM_KEYS or k in ("bq", "bk", "bv") \
                else 0.02
            d[f"{arch}/p/{k}"] = (rng.standard_normal(tuple(t.shape)) * scale
                                  ).astype(np.float32)
        d[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                           ).astype(np.int32)
        d[f"{arch}/decode"] = rng.integers(0, cfg.vocab_size,
                                           (STEPS - 1, B, 1)).astype(np.int32)
        if cfg.vlm:
            d[f"{arch}/visual"] = (rng.standard_normal(
                (B, cfg.visual_prefix, cfg.d_model)) * 0.02).astype(np.float32)
            d[f"{arch}/mrope_positions"] = grid_positions(
                B, S, cfg.visual_prefix, 4)
    np.savez(path, **d)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's two spawns (one a mesh)
    side by side on the same inputs: (inputs, reference results, the port's
    results by mesh tag)."""
    tmp = tmp_path_factory.mktemp("serve")
    src, ref = str(tmp / "in.npz"), str(tmp / "ref.npz")
    inputs = _inputs(src)
    code = (_REFERENCE.replace("(MESHES)", repr(worker.MESHES))
            .replace("ARCHS", repr(ARCHS))
            .replace("SERVE", repr((B, S, STEPS))))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.Popen([sys.executable, "-c", code, src, ref], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    errors = []

    def one(shape):
        try:
            worker.spawn(worker.serve_runs, 4, shape, src,
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


@pytest.fixture(scope="module")
def unsharded(runs):
    """The port on one process, unsharded, at fp32 from the same inputs:
    per configuration the prefill's logits and the greedy ids."""
    inputs = runs[0]
    saved = tmodel.COMPUTE_DTYPE
    tmodel.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            flat = {k[len(arch) + 3:]: v for k, v in inputs.items()
                    if k.startswith(f"{arch}/p/")}
            params = tmodel.params_from_numpy(cfg, flat, device="cpu",
                                              dtype=torch.float32)
            extra = {k: torch.from_numpy(inputs[f"{arch}/{k}"])
                     for k in ("visual", "mrope_positions")
                     if f"{arch}/{k}" in inputs}
            tokens = torch.from_numpy(inputs[f"{arch}/tokens"])
            logits, _ = tstep.make_prefill_step(cfg, max_len=S + STEPS)(
                params, {"tokens": tokens, **extra})
            out[f"{arch}/prefill_logits"] = logits.numpy()
            out[f"{arch}/greedy"] = tstep.greedy_generate(
                params, cfg, tokens, STEPS, **extra).numpy()
    finally:
        tmodel.COMPUTE_DTYPE = saved
    return out


def _close(got, want, frac: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * float(np.abs(want).max()),
                               err_msg=what)


# ------------------------------------------------------------- the logits
@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_the_reference_on_the_mesh(runs, arch, mesh):
    _, ref, port = runs
    got = port[mesh][f"{arch}/prefill_logits"]
    assert got.shape == (B, 1, get_smoke_config(arch).vocab_padded)
    _close(got, ref[f"{mesh}/{arch}/prefill_logits"], LOGIT_FRAC, arch)


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_the_reference_on_one_device(runs, arch, mesh):
    _, ref, port = runs
    _close(port[mesh][f"{arch}/prefill_logits"],
           ref[f"one/{arch}/prefill_logits"], LOGIT_FRAC, arch)


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_the_unsharded_port(runs, unsharded, arch,
                                                 mesh):
    _, _, port = runs
    _close(port[mesh][f"{arch}/prefill_logits"],
           unsharded[f"{arch}/prefill_logits"], LOGIT_FRAC, arch)


# ------------------------------------------------------------- the caches
@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_caches_and_decode_logits_match_the_reference(runs, arch, mesh):
    """The KV caches after the prefill and after 3 decode steps of the same
    tokens, and those steps' logits, against the reference on the same
    mesh and on one device; the position a host int."""
    _, ref, port = runs
    got = port[mesh]
    assert int(got[f"{arch}/pos"]) == S + STEPS - 1
    for want in (mesh, "one"):
        assert int(ref[f"{want}/{arch}/pos"]) == S + STEPS - 1
        for when in ("prefill_cache", "decode_cache"):
            for nm in ("k", "v"):
                _close(got[f"{arch}/{when}/{nm}"],
                       ref[f"{want}/{arch}/{when}/{nm}"], CACHE_FRAC,
                       f"{arch} {when} {nm} vs {want}")
        _close(got[f"{arch}/decode_logits"],
               ref[f"{want}/{arch}/decode_logits"], LOGIT_FRAC,
               f"{arch} decode logits vs {want}")


# ------------------------------------------------------------- the tokens
def _decided_prefix(logits: np.ndarray) -> np.ndarray:
    """Per row, the number of leading greedy steps whose top-2 margin in
    ``logits`` (steps, B, V) exceeds the logits' tolerance: past the first
    near-tie the two runs may feed different tokens."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > LOGIT_FRAC * np.abs(
        logits).max()
    return np.argmin(np.concatenate(
        [decided, np.zeros((1, decided.shape[1]), bool)]), axis=0)


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_on_decided_rows(runs, unsharded, arch, mesh):
    _, ref, port = runs
    cfg = get_smoke_config(arch)
    got = port[mesh][f"{arch}/greedy"]
    assert got.shape == (B, STEPS)
    assert ((0 <= got) & (got < cfg.vocab_size)).all()
    n = _decided_prefix(ref[f"one/{arch}/greedy_logits"][..., :cfg.vocab_size])
    assert n.sum() > 0
    for want in (ref[f"one/{arch}/greedy"], unsharded[f"{arch}/greedy"]):
        for row in range(B):
            np.testing.assert_array_equal(got[row, :n[row]],
                                          want[row, :n[row]])


# --------------------------------------------------------- the placements
def _want_placements(spec) -> str:
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(NAMES)
    for dim, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[NAMES.index(a)] = Shard(dim)
    return repr(tuple(out))


@pytest.fixture
def serve_tp_spec():
    """The reference's ``logical_spec`` under its ``serve_tp`` rules on an
    abstract mesh of the given shape."""
    saved = jsharding.get_rules()
    jsharding.set_rules(dict(jsharding.DEFAULT_RULES, fsdp=None))

    def spec(shape, dims, logical):
        with jax.sharding.use_abstract_mesh(
                jax.sharding.AbstractMesh(tuple(shape), NAMES)):
            return tuple(jsharding.logical_spec(dims, logical))
    yield spec
    jsharding.set_rules(saved)


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_and_caches_follow_the_serve_tp_specs(runs, serve_tp_spec,
                                                         arch, mesh):
    """Every parameter of every layer, and the caches of ``init_cache`` and
    of the prefill, placed as the reference's ``logical_spec`` under
    ``serve_tp`` says (``fsdp`` on nothing: no parameter is split over
    ``data``)."""
    _, _, port = runs
    got = port[mesh]
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    shape = tuple(int(s) for s in mesh.split("x"))
    stacked = tmodel.abstract_params(cfg)
    seen = 0
    for name, logical in jmodel.param_logical(jcfg).items():
        spec = serve_tp_spec(shape, stacked[name].shape, logical)
        per_layer = name not in tmodel.GLOBAL_KEYS
        want = _want_placements(spec[1:] if per_layer else spec)
        assert "data" not in [a for e in spec for a in
                              ((e,) if isinstance(e, str) else (e or ()))]
        for pname in ([f"layers.{i}.{name}" for i in range(cfg.num_layers)]
                      if per_layer else [name]):
            assert str(got[f"{arch}/placement/{pname}"]) == want, pname
            seen += 1
    assert seen == sum(1 for k in got if k.startswith(f"{arch}/placement/"))
    c_logical = jmodel.cache_logical(jcfg)
    for nm in ("k", "v"):
        dims = (cfg.num_layers, B, S + STEPS, cfg.num_kv_heads, cfg.head_dim)
        want = _want_placements(serve_tp_spec(shape, dims, c_logical[nm]))
        assert str(got[f"{arch}/init_cache_placement/{nm}"]) == want
        assert str(got[f"{arch}/cache_placement/{nm}"]) == want


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_runs_the_flash_wrapper_on_local_shards(runs, arch, mesh):
    """One call of the flash wrapper a layer in the prefill, each on a
    process's local q (a plain tensor): the batch over ``data``, the heads
    over ``model`` where both head counts divide it, else whole."""
    _, _, port = runs
    cfg = get_smoke_config(arch)
    dp, tp = (int(s) for s in mesh.split("x"))
    calls = ast.literal_eval(str(port[mesh][f"{arch}/flash_calls"]))
    split = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    h, kv = ((cfg.num_heads // tp, cfg.num_kv_heads // tp) if split
             else (cfg.num_heads, cfg.num_kv_heads))
    want = ("Tensor", (B // dp, S, h, cfg.head_dim),
            (B // dp, S, kv, cfg.head_dim))
    assert calls == [want] * cfg.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", TAGS)
def test_vocab_parallel_lookup_is_the_plain_lookup(runs, mesh, dtype):
    """The table sharded on ``vocab`` alone, each process reading its rows
    and the sum over ``model``: bit for bit the plain lookup of the whole
    table (rank 0 compares its gathered result)."""
    _, _, port = runs
    got = port[mesh]
    assert bool(got[f"embed_{dtype}/bits_equal"])
    assert str(got[f"embed_{dtype}/placement"]) == _want_placements(
        ("model", None))


@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", worker.INIT_HELD)
def test_init_params_is_the_same_on_every_mesh(runs, arch, mesh):
    """``init_params`` of one seed, drawn a layer's slice at a time: the
    same numbers gathered from (2, 2) and (1, 4) as on one process."""
    _, _, port = runs
    one = tmodel.params_to_numpy(tmodel.init_params(
        get_smoke_config(arch), seed=worker.INIT_SEED, device="cpu",
        dtype=torch.float32))
    for k in one:
        np.testing.assert_array_equal(port[mesh][f"init/{arch}/{k}"], one[k],
                                      err_msg=k)


def test_init_params_draws_each_layer_anew():
    """One process: a seed gives the same numbers twice, another seed other
    numbers, and no two layers of a stacked tensor are alike."""
    cfg = get_smoke_config("qwen2_7b")

    def draw(seed):
        return tmodel.params_to_numpy(tmodel.init_params(
            cfg, seed=seed, device="cpu", dtype=torch.float32))
    a, b, c = draw(worker.INIT_SEED), draw(worker.INIT_SEED), draw(0)
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k])
        if v.any():
            assert not np.array_equal(v, c[k]), k
            if k not in tmodel.GLOBAL_KEYS:
                assert not np.array_equal(v[0], v[1]), k


# ----------------------------------------------------------- the dry run
@pytest.mark.parametrize("mesh", TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_bytes_are_the_dry_runs(runs, arch, mesh, monkeypatch):
    """Rank 0's local bytes of the parameters and of ``init_cache``'s
    caches: ``launch.dryrun.serve_arg_bytes`` on the abstract mesh of the
    same shape, exactly."""
    _, _, port = runs
    monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    saved = tsharding.get_rules()
    try:
        want = tdryrun.serve_arg_bytes(
            get_smoke_config(arch), tmesh.AbstractMesh(
                tuple(int(s) for s in mesh.split("x")), NAMES),
            B, S + STEPS, torch.float32)
    finally:
        tsharding.set_rules(saved)
    got = port[mesh]
    assert int(got[f"{arch}/local_bytes/params"]) == want["params"]
    assert int(got[f"{arch}/local_bytes/cache"]) == want["cache"]


def _spec_bytes(spec_of, shape, dims, logical, nbytes: int) -> int:
    """The bytes of one device's shard of a tensor of ``dims`` whose whole
    holds ``nbytes``, under the reference's spec on a mesh of ``shape``."""
    sizes = dict(zip(NAMES, shape))
    n = 1
    for dim, entry in zip(dims, spec_of(shape, dims, logical)):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            assert dim % sizes[a] == 0
            n *= sizes[a]
    return nbytes // n


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_dry_run_bytes_of_command_r_plus_served(serve_tp_spec, shape):
    """Command-R+-104B at its published width under ``serve_tp``, 4 x 2080
    positions of cache, on the meta device: the dry run's per-device bytes
    are the reference's specs' (parameters in the port's storage: bf16,
    norm scales fp32), and on (1, 4) about 51.9 GB of parameters and 0.55
    GB of cache a card."""
    cfg, jcfg = get_config("command-r-plus-104b"), jget_smoke(
        "command_r_plus_104b")
    saved = tsharding.get_rules()
    try:
        got = tdryrun.serve_arg_bytes(cfg, tmesh.AbstractMesh(shape, NAMES),
                                      4, 2080)
    finally:
        tsharding.set_rules(saved)
    p_logical = jmodel.param_logical(jcfg)
    params = sum(_spec_bytes(serve_tp_spec, shape, t.shape, p_logical[k],
                             t.numel() * (4 if k in tmodel.NORM_KEYS else 2))
                 for k, t in tmodel.abstract_params(cfg).items())
    kv = (cfg.num_layers, 4, 2080, cfg.num_kv_heads, cfg.head_dim)
    cache = 2 * _spec_bytes(serve_tp_spec, shape, kv,
                            jmodel.cache_logical(jcfg)["k"],
                            2 * int(np.prod(kv)))
    assert got == {"params": params, "cache": cache}
    if shape == (1, 4):
        assert abs(got["params"] / 1e9 - 51.9) < 0.1, got
        assert abs(got["cache"] / 1e9 - 0.545) < 0.01, got
