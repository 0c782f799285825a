"""The port's first slice as a whole, against the JAX package, on the CPU:
record blocks streamed into a session, a mixed serving wave (the seven
plan-shape families of the serving mix, a size-guard composite and a
contradiction), and the live index carried across the packages with
``BitmapIndex.from_numpy`` / ``to_numpy``.  Also the port's boundaries: it
imports neither JAX nor the JAX package, and its entry points never fall
back quietly to the CPU."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.engine import planner as jplanner
from repro_torch.db import BitmapDB
from repro_torch.engine import planner as tplanner
from repro_torch.engine.policy import BitmapIndex

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, W = 64, 8


def serving_mix(kind, m: int, count: int, seed: int) -> list:
    """The serving mix of ``benchmarks/run.py`` (seven plan-shape
    families over random key ids), built for either package, plus one
    size-guard composite (an AND of 8 two-key ORs: 256 > 128 DNF clauses)
    and one contradiction."""
    rng = np.random.default_rng(seed)
    key = kind.key

    def k() -> int:
        return int(rng.integers(0, m))

    preds = []
    for i in range(count):
        fam = i % 7
        if fam == 0:
            p = key(k())
        elif fam == 1:
            p = key(k()) & ~key(k())
        elif fam == 2:
            p = key(k()) & key(k()) & ~key(k())
        elif fam == 3:
            p = (key(k()) | key(k())) & key(k())
        elif fam == 4:
            p = (key(k()) | key(k())) & (key(k()) | key(k()))
        elif fam == 5:
            p = key(k()) | key(k()) | key(k())
        else:
            p = ((key(k()) & key(k()) & key(k())) |
                 (key(k()) & key(k()) & key(k())))
        preds.append(p)
    preds.append(kind.And(tuple(key(2 * i) | key(2 * i + 1)
                                for i in range(8))))
    preds.append(key(3) & ~key(3))
    return preds


def test_whole_slice_matches_reference():
    rng = np.random.default_rng(2026)
    blocks = [rng.integers(0, M, (n, W), dtype=np.uint8)
              for n in (1000, 77, 2048, 333)]
    t = BitmapDB(num_keys=M, device="cpu")
    j = repro.BitmapDB(num_keys=M, backend="ref")
    for b in blocks:
        t.append_encoded(b)
        j.append_encoded(jnp.asarray(b.astype(np.int32)))
    assert t.num_records == j.num_records == 3458
    ref_packed = np.asarray(j.index.packed)
    np.testing.assert_array_equal(t.index.to_numpy(), ref_packed)

    tq, jq = serving_mix(tplanner, M, 64, 7), serving_mix(jplanner, M, 64, 7)
    got_r, got_c = t.query_many(tq).materialize()
    want_r, want_c = j.query_many(jq).materialize()
    np.testing.assert_array_equal(got_r.numpy().view(np.uint32),
                                  np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    for backend in ("bulk", "cuda"):
        r, c = t.query_many(tq, backend=backend).materialize()
        assert torch.equal(r, got_r) and torch.equal(c, got_c)
    single = t.query(tq[3])
    assert single.count == int(want_c[3])

    # the reference's packed words carried into the port and back
    idx = BitmapIndex.from_numpy(ref_packed, j.num_records, device="cpu")
    np.testing.assert_array_equal(idx.to_numpy(), ref_packed)
    ro_r, ro_c = BitmapDB.from_index(idx).query_many(tq).materialize()
    assert torch.equal(ro_r, got_r) and torch.equal(ro_c, got_c)


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"the port must not import jax or repro: {bad}"


def test_cuda_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        BitmapDB(num_keys=8)                     # default device="cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        BitmapIndex.from_numpy(np.zeros((1, 1), np.uint32), 3)
    from repro_torch.core.bic import BICCore
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        BICCore()
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model
    cfg = get_smoke_config("qwen2_7b")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.init_params(cfg)                   # default device="cuda"
    params = {name: np.zeros(shape, np.float32)
              for name, (shape, _) in model._schema(cfg).items()}
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.params_from_numpy(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve.main(["--demo", "--steps", "2"])   # no --device cpu
