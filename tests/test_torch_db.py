"""The port's database facade (``repro_torch.db``) and BIC core against the
JAX package's, on the CPU: the schema/DSL query of
``examples/quickstart.py`` at N = 4096, plan caches, lazy result
snapshots, and the surfaces that wait for later slices."""
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


@pytest.mark.parametrize("call", [
    lambda s, p: s.explain(tplanner.key(0)),
    lambda s, p: s.serve(),
    lambda s, p: _durable(s, p).explain(tplanner.key(0)),
    lambda s, p: _durable(s, p).serve(),
    lambda s, p: _stored(s, p).serve(),
])
def test_later_slices_raise_not_implemented(call, tmp_path):
    """explain (the cost model, A5) and serve (the async service, A6) are
    not ported yet, on every kind of session: in-memory, durable, and
    read-only over a stored index."""
    s = tdb.BitmapDB(num_keys=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        call(s, tmp_path)


def test_read_only_session_rejects_appends():
    idx = tbic.BICCore(device="cpu").create(np.zeros((4, 2), np.int32),
                                            np.arange(4))
    s = tdb.BitmapDB.from_index(idx)
    with pytest.raises(RuntimeError, match="read-only"):
        s.append_encoded(np.zeros((1, 2)))
    assert s.stats.counts == (4, 0, 0, 0)
