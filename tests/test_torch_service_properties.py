"""Hypothesis property for the port's micro-batch scheduler, against the
JAX package's answers (the twin of ``tests/test_service_properties.py``):
over randomized caller counts, per-caller query lists and scheduler knobs,
every submitted query is answered exactly once, each caller's futures
resolve in its submission order, and every answer equals the reference's
sequential ``serve_step`` answer bit for bit.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro_torch import db as tdb  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402

T = 60.0          # every drain / join / result is bounded by this
PM = 12


def same(trow, tcount, jrow, jcount) -> None:
    np.testing.assert_array_equal(
        trow.contiguous().numpy().view(np.uint32), np.asarray(jrow))
    assert int(tcount) == int(jcount)


@pytest.fixture(scope="module")
def prop_dbs():
    """One 512-record session per package (the reference property's)."""
    out = []
    for pkg in (tdb, repro.db):
        schema = pkg.Schema([
            pkg.Column.categorical("a", list(range(PM // 2))),
            pkg.Column.categorical("b", list(range(PM // 2, PM)))])
        rng = np.random.default_rng(0)
        enc = np.stack([rng.integers(0, PM // 2, 512, dtype=np.int32),
                        rng.integers(PM // 2, PM, 512, dtype=np.int32)],
                       axis=1)
        d = pkg.BitmapDB(schema, backend="ref",
                         **({"device": "cpu"} if pkg is tdb else {}))
        d.append_encoded(enc)
        out.append(d)
    return out


def _pred(spec, P):
    kind, i, j = spec
    i, j = i % PM, j % PM
    if kind % 3 == 0:
        return P.key(i)
    if kind % 3 == 1:
        return P.key(i) & ~P.key(j)
    return P.key(i) | P.key(j)


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(lanes=st.lists(
    st.lists(st.tuples(st.integers(0, 2), st.integers(0, PM - 1),
                       st.integers(0, PM - 1)), min_size=1, max_size=12),
    min_size=1, max_size=4),
    max_batch=st.integers(1, 16),
    max_delay_ms=st.sampled_from([0.0, 0.5, 2.0]))
def test_scheduler_batching_invariants(prop_dbs, lanes, max_batch,
                                       max_delay_ms):
    """Over random caller counts, query lists and scheduler knobs: every
    query is answered exactly once (the global resolve sequence is a
    permutation), each caller's futures resolve in submission order, and
    every answer equals the reference's sequential serve_step answer."""
    db, jdb = prop_dbs
    jstep = jdb.serve_step()
    want = {s: jstep([_pred(s, jplanner)]) for lane in lanes for s in lane}
    svc = db.serve(max_batch=max_batch, max_delay_ms=max_delay_ms,
                   idle_after_ms=10_000.0)
    try:
        outs = [[] for _ in lanes]

        def caller(t):
            for s in lanes[t]:
                outs[t].append(svc.submit(_pred(s, tplanner)))

        threads = [threading.Thread(target=caller, args=(t,))
                   for t in range(len(lanes))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(T)
            assert not th.is_alive()
        assert svc.drain(timeout=T)
        total = sum(len(lane) for lane in lanes)
        seqs = sorted(f.resolve_seq for lane in outs for f in lane)
        assert seqs == list(range(1, total + 1))
        for t, lane in enumerate(outs):
            per = [f.resolve_seq for f in lane]
            assert per == sorted(per), "per-caller order violated"
            for s, f in zip(lanes[t], lane):
                rows, counts = want[s]
                same(*f.result(timeout=T), rows[0], counts[0])
        assert svc.metrics().served == total
    finally:
        svc.close(timeout=T)
