"""The port's database facade (``repro_torch.db``) and BIC core against the
JAX package's, on the CPU: the schema/DSL query of
``examples/quickstart.py`` at N = 4096, plan caches, lazy result
snapshots, the reference suite's DSL acceptance (random expressions over 6
seeds, and the durable end-to-end session with a 1k-query batch), and the
surfaces that wait for later slices."""
import os
import sys

import numpy as np
import pytest
import torch

import repro
from repro.core import bic as jbic
from repro_torch import db as tdb
from repro_torch.core import bic as tbic
from repro_torch.engine import planner as tplanner
from torch_witness import (torch_lock_witness,  # noqa: F401
                           torch_witness_isolation)

# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import quickstart  # noqa: E402  (make_rows / brute / the column vocab)


def _schema(mod):
    return mod.Schema([
        mod.Column.categorical("domain", quickstart.DOMAINS),
        mod.Column.categorical("lang", quickstart.LANGS),
        mod.Column.binned("temp", edges=quickstart.TEMP_EDGES),
        mod.Column.categorical("flagged", [False, True]),
    ])


def _query(col):
    return (col("domain").isin(["code", "math"]) & (col("lang") == "en")
            & (col("temp") >= 10.0) & ~(col("flagged") == True))  # noqa: E712


@pytest.fixture(scope="module")
def sessions():
    rows = quickstart.make_rows(np.random.default_rng(0), 4096)
    t = tdb.BitmapDB(_schema(tdb), device="cpu")
    j = repro.BitmapDB(_schema(repro), backend="ref")
    t.ingest(rows)
    j.ingest(rows)
    return rows, t, j


def test_quickstart_query_matches_reference_and_brute_force(sessions):
    rows, t, j = sessions
    got, want = t.query(_query(tdb.col)), j.query(_query(repro.col))
    brute = [i for i in range(4096) if quickstart.brute(rows, i)]
    assert list(got.ids) == list(want.ids) == brute
    assert got.count == want.count == len(brute)
    np.testing.assert_array_equal(got.rows.numpy().view(np.uint32),
                                  np.asarray(want.rows))


def test_quickstart_batch_and_stats_match_reference(sessions):
    _, t, j = sessions

    def batch(mod):
        col, key = mod.col, (tplanner.key if mod is tdb
                             else repro.engine.planner.key)
        return [_query(col), col("lang") == "de", key(1) & ~key(13),
                col("temp").between(0, 20) & (col("domain") == "web"),
                col("domain").isin([])]                   # contradiction
    got_r, got_c = t.serve_step()(batch(tdb))
    want_r, want_c = j.serve_step()(batch(repro))
    np.testing.assert_array_equal(got_r.numpy().view(np.uint32),
                                  np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert (t.stats.counts, t.stats.num_records) == \
        (j.stats.counts, j.stats.num_records)
    all_ids = t.query_many(batch(tdb)).all_ids()
    assert [list(a) for a in all_ids] == \
        [list(r.ids) for r in j.query_many(batch(repro))]


def test_plan_caches_count_hits_and_misses():
    s = tdb.BitmapDB(_schema(tdb), device="cpu")
    s.ingest(quickstart.make_rows(np.random.default_rng(1), 100))
    q = tdb.col("lang") == "en"
    s.query(q).count
    s.query(q).count                                     # identity hit
    s.query(tdb.col("lang") == "en").count               # value hit
    st = s.cache_stats()
    assert (st["misses"], st["id_hits"], st["value_hits"]) == (1, 1, 1)
    assert st["id_size"] == 2 and st["value_size"] == 1
    s.replan()
    assert s.cache_stats()["value_size"] == 0


def test_result_taken_before_an_append_is_unchanged_after_it():
    s = tdb.BitmapDB(num_keys=16, device="cpu", capacity_words=2)
    rng = np.random.default_rng(2)
    s.append_encoded(rng.integers(0, 16, (70, 4)))
    early = s.query(tplanner.key(3) | ~tplanner.key(5))   # not yet run
    later_rows = rng.integers(0, 16, (300, 4))
    s.append_encoded(later_rows)                          # grows + splices
    ref_s = tdb.BitmapDB(num_keys=16, device="cpu")
    ref_s.append_encoded(np.random.default_rng(2).integers(0, 16, (70, 4)))
    want = ref_s.query(tplanner.key(3) | ~tplanner.key(5))
    assert early.count == want.count
    assert torch.equal(early.rows, want.rows)
    assert s.num_records == 370


def test_bic_core_matches_reference():
    rng = np.random.default_rng(3)
    records = rng.integers(0, 8, (16, 32), dtype=np.int32)
    keys = np.arange(8, dtype=np.int32)
    tcore = tbic.BICCore(device="cpu")
    jcore = jbic.BICCore(jbic.BICConfig(backend="ref", num_keys=8,
                                        num_records=16))
    tidx, jidx = tcore.create(records, keys), jcore.create(records, keys)
    np.testing.assert_array_equal(tidx.to_numpy(), np.asarray(jidx.packed))
    with pytest.warns(DeprecationWarning):
        got = tcore.query(tidx, include=[2, 4], exclude=[5])
    with pytest.warns(DeprecationWarning):
        want = jcore.query(jidx, include=[2, 4], exclude=[5])
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    assert int(got[1]) == int(want[1])
    k = tplanner.key
    rows, counts = tcore.query_many(tidx, [k(1) | k(2), k(3) & ~k(4)])
    jk = repro.engine.planner.key
    jrows, jcounts = jcore.query_many(jidx, [jk(1) | jk(2), jk(3) & ~jk(4)])
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  np.asarray(jrows))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    b = tcore.batch_create(records.reshape(2, 8, 32), keys)
    np.testing.assert_array_equal(b.to_numpy(), tidx.to_numpy())
    assert tbic.PaperConfig.memory_bits == jbic.PaperConfig.memory_bits


def _durable(s, tmp_path):
    return tdb.BitmapDB(num_keys=4, path=str(tmp_path / "db"),
                        device="cpu")


def _stored(s, tmp_path):
    from repro_torch.store import SegmentStore, open_index
    return tdb.BitmapDB.from_index(
        open_index(SegmentStore(str(tmp_path / "st")), device="cpu"))


def _dataset(pkg, tmp_path, durable: bool):
    pipe = __import__(f"{pkg}.data.pipeline", fromlist=["x"])
    cfg = pipe.DataConfig(vocab_size=64, seq_len=8, docs_per_shard=64,
                          num_shards=2, num_attributes=32)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    return pipe.BitmapIndexedDataset(
        cfg, store_dir=str(tmp_path / pkg / "ds") if durable else None,
        **kw)


def _fabric_ids(ds, **kw):
    """Global ids of key(0) through the dataset's fabric client."""
    fc = ds.fabric(**kw)
    fut = fc.submit(tplanner.key(0))
    assert fc.drain(timeout=60)
    return fut.ids


@pytest.mark.parametrize("call", [
    lambda ds: _fabric_ids(ds),
    lambda ds: ds.select_global([tplanner.key(0)])[0],
    lambda ds: _fabric_ids(ds),
    lambda ds: ds.select_global([tplanner.key(0)])[0],
    lambda ds: _fabric_ids(ds, max_delay_ms=1.0),
], ids=["fabric", "select_global", "durable-fabric",
        "durable-select_global", "fabric-kw"])
def test_pipeline_fabric_plane_matches_reference(call, tmp_path, request):
    """The data pipeline's one query plane over every shard, in memory
    and durable, with and without the fabric's keywords: the ids equal
    the reference pipeline's ``select_global``."""
    durable = request.node.callspec.id.startswith("durable")
    ds = _dataset("repro_torch", tmp_path, durable)
    jds = _dataset("repro", tmp_path, durable)
    from repro.engine.planner import key as jkey
    try:
        got = call(ds)
        want = jds.select_global([jkey(0)])[0]
        np.testing.assert_array_equal(got, want)
        assert got.size and ds.fabric() is ds.fabric()
    finally:
        ds.close()
        jds.close()


def test_read_only_session_rejects_appends():
    idx = tbic.BICCore(device="cpu").create(np.zeros((4, 2), np.int32),
                                            np.arange(4))
    s = tdb.BitmapDB.from_index(idx)
    with pytest.raises(RuntimeError, match="read-only"):
        s.append_encoded(np.zeros((1, 2)))
    assert s.stats.counts == (4, 0, 0, 0)


# ------------------------------------------- DSL acceptance (ROADMAP A5)
# The reference suite's generators and NumPy evaluator drive both packages:
# each query is built once with the JAX package's types and translated
# into the port's, so both receive the very same expression.
import dataclasses  # noqa: E402

import test_db as jtests  # noqa: E402
from repro.engine import batch as jbatch  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro_torch.db import expr as texpr  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import policy as tpolicy  # noqa: E402


def _to_port(q):
    """The port's twin of a reference expression / predicate tree."""
    name = type(q).__name__
    if name == "Key":
        return tplanner.Key(q.index)
    if name in ("Not", "NotExpr"):
        home = tplanner if name == "Not" else texpr
        return getattr(home, name)(_to_port(q.child))
    if name in ("And", "Or", "AndExpr", "OrExpr"):
        home = tplanner if name in ("And", "Or") else texpr
        return getattr(home, name)(tuple(_to_port(c) for c in q.children))
    if name in ("Eq", "In", "Between"):
        return getattr(texpr, name)(**{f.name: getattr(q, f.name)
                                       for f in dataclasses.fields(q)})
    raise TypeError(f"not a query: {q!r}")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.mark.parametrize("seed", range(6))
def test_random_exprs_match_numpy_reference(seed):
    """The DSL acceptance property (``tests/test_db.py``'s, same seeds):
    expr -> Pred -> plan -> packed execution on the port's ``auto`` session
    equals the NumPy reference evaluation and the JAX package's rows, for
    random schemas, data and expression trees."""
    rng = np.random.default_rng(seed)
    J = repro.db
    cols = [J.Column.categorical("a", list(range(int(rng.integers(2, 6))))),
            J.Column.binned("b", edges=sorted(
                set(rng.uniform(-50, 50, int(rng.integers(3, 7)))))),
            J.Column.categorical("c", ["x", "y", "z", "w"])]
    schema = J.Schema(cols[: int(rng.integers(2, 4))])
    n = int(rng.integers(40, 220))
    rows = {}
    for c in schema.columns:
        if c.kind == "categorical":
            vals = list(c.values)
            rows[c.name] = [vals[i] for i in rng.integers(0, len(vals), n)]
        else:
            rows[c.name] = rng.uniform(c.edges[0], c.edges[-1], n).tolist()
    jdb = repro.BitmapDB(schema, backend="ref")
    jdb.ingest(rows)
    tdb_ = tdb.BitmapDB(tdb.Schema.from_json(schema.to_json()),
                        device="cpu")
    tdb_.ingest(rows)
    enc = schema.encode(rows)
    exprs = [jtests._random_expr(rng, schema, depth=int(rng.integers(0, 3)))
             for _ in range(12)]
    got = tdb_.query_many([_to_port(q) for q in exprs])
    jr, jc = jdb.query_many(exprs).materialize()
    tr, tc = got.materialize()
    np.testing.assert_array_equal(_u32(tr), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for q, res in zip(exprs, got):
        want = np.flatnonzero(jtests._ref_eval(q, enc, schema))
        np.testing.assert_array_equal(res.ids, want), q
        assert res.count == len(want)


def test_bitmapdb_end_to_end_acceptance(tmp_path):
    """``tests/test_db.py``'s end-to-end acceptance through the port: ingest
    with a Schema, stream appends past the spill threshold with path=,
    crash-recover via repro_torch.open(), serve a 1k-query mixed DSL batch
    — bit-identical to the raw engine.batch + StoredIndex paths, to the
    NumPy ground truth, and to the JAX package's answers over the same
    store directory."""
    from repro_torch.engine.runtime import StreamingIndexer
    from repro_torch.store import SegmentStore, open_index

    jschema = jtests._weather_schema()
    schema = tdb.Schema.from_json(jschema.to_json())
    rng = np.random.default_rng(11)
    path = os.path.join(str(tmp_path), "db")
    db = tdb.BitmapDB(schema, path=path, spill_records=256, device="cpu")
    total = 0
    encoded_blocks = []
    for blk in (200, 150, 300, 90, 60):   # crosses the threshold twice
        rows_blk = jtests._weather_rows(rng, blk)
        encoded_blocks.append(schema.encode(rows_blk))
        db.append(rows_blk)
        total += blk
    enc_all = np.concatenate(encoded_blocks)
    assert db.num_records == total
    store = db.store
    assert 256 <= store.durable_records < total   # segments + a WAL tail
    live_packed = db.index.packed.clone()

    # ---- crash: reopen from disk only -------------------------------
    rec = tdb.open(path, device="cpu")
    assert rec.num_records == total
    assert torch.equal(rec.index.packed, live_packed)

    # ---- serve a 1k mixed DSL batch through the facade ---------------
    jqueries = jtests._mixed_dsl_queries(jschema, 1000, seed=12)
    queries = [_to_port(q) for q in jqueries]
    rows, counts = rec.serve_step()(queries)
    assert rows.shape[0] == 1000

    # ---- raw path 1: engine.batch over the recovered contiguous index
    plans = [tplanner.plan(texpr.lower(q, schema)) for q in queries]
    want_r, want_c = tbatch.execute_many(
        rec.index.packed, plans, num_records=total, backend="ref")
    assert torch.equal(rows, want_r) and torch.equal(counts, want_c)

    # ---- raw path 2: StoredIndex (segments + extracted WAL tail) -----
    st2 = SegmentStore(path)
    si = StreamingIndexer.restore(
        st2, torch.arange(schema.num_keys, dtype=torch.int32),
        backend="ref", device="cpu")
    tail_n = si.num_records - st2.durable_records
    tail = (tpolicy.extract_packed(si.index.packed, st2.durable_records,
                                   tail_n), tail_n)
    stored = open_index(st2, tail=tail if tail_n else None, device="cpu")
    sr, sc = stored.query_many(plans, backend="ref")
    assert torch.equal(rows, sr) and torch.equal(counts, sc)
    st2.close()

    # ---- the JAX package over the same directory ---------------------
    jrec = repro.open(path, backend="ref")
    jplans = [jplanner.plan(repro.db.lower(q, jschema)) for q in jqueries]
    jr, jc = jbatch.execute_many(jrec.index.packed, jplans,
                                 num_records=total, backend="ref")
    np.testing.assert_array_equal(_u32(rows), np.asarray(jr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))

    # ---- and the numpy-reference ground truth ------------------------
    res = rec.query_many(queries[:50])
    for q, r in zip(jqueries[:50], res):
        want = np.flatnonzero(jtests._ref_eval(q, enc_all, jschema))
        np.testing.assert_array_equal(r.ids, want)


def test_quickstart_twin_runs_on_the_cpu():
    """``examples/quickstart_torch.py --device cpu`` runs to its end (its
    brute-force and recovery checks are asserts) in a fresh interpreter,
    importing neither JAX nor the JAX package."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "examples", "quickstart_torch.py")
    code = ("import runpy, sys; sys.argv = [sys.argv[1], '--device', 'cpu']; "
            "runpy.run_path(sys.argv[0], run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')); assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"        # as in this process
    out = subprocess.run([sys.executable, "-c", code, script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fabric: 3 hash shards" in out.stdout
    assert out.stdout.rstrip().endswith("quickstart OK")
