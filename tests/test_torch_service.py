"""The port's serving layer (``repro_torch.serve``: the async
``BitmapService``, background maintenance, resilience, the one-shot query
step) and its data pipeline, against the JAX package's, on the CPU.

The reference's service suite (``tests/test_service.py``) and scheduler
property (``tests/test_service_properties.py``) replayed through both
packages on the same seeded data: every answer a future, a step or a
pipeline returns equals the reference's for the same query (integers: no
tolerance); the standby and active watts equal the reference's model
powers for the same ``BICConfig`` and ``PowerState``; the store's crash
windows under the service end the same way in both packages.  No test
asserts a wall-clock time: they assert events, ordering and counters, and
every ``drain``, ``join``, ``wait`` and ``result`` carries a timeout.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core.bic import PaperConfig as JPaperConfig  # noqa: E402
from repro.core.elastic import ElasticScheduler as JSched  # noqa: E402
from repro.core.elastic import PowerState as JPowerState  # noqa: E402
from repro.engine import backends as jbackends  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro.store import store as jstore_impl  # noqa: E402
from repro_torch import db as tdb  # noqa: E402
from repro_torch import store as tstore  # noqa: E402
from repro_torch.engine import backends as tbackends  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.store import store as tstore_impl  # noqa: E402
from repro_torch.serve import (BitmapService, CircuitBreaker,  # noqa: E402
                               RetryPolicy, ServiceClosed, ServiceConfig,
                               ServiceOverloaded, is_transient,
                               make_bitmap_query_step)

T = 60.0          # every drain / join / wait / result is bounded by this


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def same(trow, tcount, jrow, jcount) -> None:
    np.testing.assert_array_equal(u32(trow), np.asarray(jrow))
    assert int(tcount) == int(jcount)


# ----------------------------------------------------------------- fixtures
def _schema(pkg, m: int = 16):
    half = m // 2
    return pkg.Schema([pkg.Column.categorical("a", list(range(half))),
                       pkg.Column.categorical("b", list(range(half, m)))])


def _records(rng, n: int, m: int = 16) -> np.ndarray:
    half = m // 2
    return np.stack([rng.integers(0, half, n, dtype=np.int32),
                     rng.integers(half, m, n, dtype=np.int32)], axis=1)


def _kw(pkg) -> dict:
    return {"device": "cpu"} if pkg is tdb else {}


def _mk_db(pkg, n: int = 2048, m: int = 16, seed: int = 0,
           backend: str = "ref", **kw):
    db = pkg.BitmapDB(_schema(pkg, m), backend=backend, **_kw(pkg), **kw)
    db.append_encoded(_records(np.random.default_rng(seed), n, m))
    return db


def _mk_pair(**kw):
    """The same session in both packages: (port, reference)."""
    return _mk_db(tdb, **kw), _mk_db(repro.db, **kw)


def _planner(pkg):
    return tplanner if pkg is tdb else jplanner


def _mixed_queries(pkg, seed: int, m: int, count: int) -> list:
    rng = np.random.default_rng(seed)
    col, key = pkg.col, _planner(pkg).key
    half = m // 2
    qs = []
    for i in range(count):
        fam = i % 4
        if fam == 0:
            qs.append(col("a") == int(rng.integers(0, half)))
        elif fam == 1:
            qs.append((col("a") == int(rng.integers(0, half)))
                      & ~(col("b") == int(rng.integers(half, m))))
        elif fam == 2:
            qs.append(key(int(rng.integers(0, m)))
                      | key(int(rng.integers(0, m))))
        else:
            qs.append((key(int(rng.integers(0, m)))
                       | key(int(rng.integers(0, m))))
                      & key(int(rng.integers(0, m))))
    return qs


def _both_queries(seed, count, m=16):
    return (_mixed_queries(tdb, seed, m, count),
            _mixed_queries(repro.db, seed, m, count))


def _storm(svc, queries, lanes: int) -> list[list]:
    """Submit ``queries`` from ``lanes`` threads (lane t takes every
    lanes-th query); returns each lane's futures in submission order."""
    outs: list[list] = [[] for _ in range(lanes)]

    def caller(t):
        for q in queries[t::lanes]:
            outs[t].append(svc.submit(q))

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(lanes)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(T)
        assert not th.is_alive()
    return outs


# ----------------------------------------------------- micro-batch identity
@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_threaded_storm_bit_identical_to_reference(backend):
    """Queries submitted concurrently from many threads coalesce into
    micro-batches whose answers equal the reference's sequential
    serve_step answers, and each caller's futures resolve in its
    submission order."""
    tdb_, jdb = _mk_db(tdb, backend=backend), _mk_db(repro.db)
    tq, jq = _both_queries(3, 120)
    jstep = jdb.serve_step()
    seq = [jstep([q]) for q in jq]
    with tdb_.serve(max_delay_ms=2.0, max_batch=32,
                    idle_after_ms=1000.0) as svc:
        outs = _storm(svc, tq, 4)
        assert svc.drain(timeout=T)
        m = svc.metrics()
        assert m.served == len(tq)
        assert m.batches <= len(tq)          # coalesced, not per-query
        h = svc.health()
        assert (h["degraded_waves"], h["fallback_queries"],
                h["wave_retries"], h["isolated_failures"],
                h["deadline_rejected"]) == (0, 0, 0, 0, 0)
        assert h["breaker"]["state"] == "closed"
        for t in range(4):
            seqs = [f.resolve_seq for f in outs[t]]
            assert seqs == sorted(seqs), "per-caller order violated"
            for i, f in zip(range(t, len(tq), 4), outs[t]):
                rr, cc = f.result(timeout=T)
                same(rr, cc, seq[i][0][0], seq[i][1][0])


@pytest.mark.parametrize("kind", ["db", "index", "stored"])
def test_serve_step_shim_matches_reference(kind, tmp_path):
    """make_bitmap_query_step (a one-shot service shim) over a session, an
    in-memory BitmapIndex and a StoredIndex of 4 segments: bit-identical
    to the reference's step and to the direct query_many path, including
    the empty batch; a bad query raises."""
    tq, jq = _both_queries(5, 40)
    tdb_, jdb = _mk_pair(n=512)
    if kind == "db":
        tix, jix = tdb_, jdb
    elif kind == "index":
        tix, jix = tdb_.index, jdb.index
        tq, jq = _both_queries_raw(5, 40)
    else:
        paths = []
        for pkg, store in ((tdb, tstore), (repro.db, repro.store)):
            p = str(tmp_path / pkg.__name__)
            d = pkg.BitmapDB(num_keys=16, path=p, spill_records=128,
                             **_kw(pkg))
            d.store.auto_compact = False     # keep the 4 spills apart
            rng = np.random.default_rng(0)
            for _ in range(4):
                d.append_encoded(_records(rng, 128))
            paths.append(store.open_index(store.SegmentStore(p),
                                          **_kw(pkg)))
        tix, jix = paths
        assert tix.num_segments == jix.num_segments == 4
        tq, jq = _both_queries_raw(5, 40)
    step = make_bitmap_query_step(tix)
    rows, counts = step(tq)
    jr, jc = repro.serve.step.make_bitmap_query_step(jix)(jq)
    np.testing.assert_array_equal(u32(rows), np.asarray(jr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    want_r, want_c = step.service.db.query_many(tq).materialize()
    assert torch.equal(rows, want_r) and torch.equal(counts, want_c)
    er, ec = step([])
    assert er.shape[0] == 0 and ec.shape[0] == 0
    with pytest.raises(Exception):           # bad query raises
        step([tplanner.key(999)])
    step.service.close(timeout=T)


def _both_queries_raw(seed, count, m=16):
    """Schema-free queries (raw key predicates) for both packages."""
    out = []
    for P in (tplanner, jplanner):
        rng = np.random.default_rng(seed)
        k = P.key
        out.append([(k(int(rng.integers(0, m))) | k(int(rng.integers(0, m))))
                    & ~k(int(rng.integers(0, m))) for _ in range(count)])
    return out


def test_query_many_pad_output_semantics():
    """pad_output=True pads the materialized query axis to a power of
    two; the handles still cover exactly the submitted queries,
    bit-identical to the unpadded path and to the reference."""
    tdb_, jdb = _mk_pair(n=512)
    tq, jq = _both_queries(41, 10)
    rb = tdb_.query_many(tq, pad_output=True)
    rows, counts = rb.materialize()
    assert rows.shape[0] == 16 and counts.shape[0] == 16
    want_r, want_c = tdb_.query_many(tq).materialize()
    assert torch.equal(rows[:10], want_r) and torch.equal(counts[:10],
                                                          want_c)
    jr, jc = jdb.query_many(jq, pad_output=True).materialize()
    np.testing.assert_array_equal(u32(rows[:10]), np.asarray(jr)[:10])
    assert len(rb) == 10 and len(rb.all_ids()) == 10
    for i in range(10):
        assert int(rb[i].count) == int(want_c[i])


@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_service_warmup_counts_dispatches(backend):
    """warmup makes the reference's number of dispatches for the same
    plans (one per shape, bucket size and candidate backend)."""
    counts = []
    for pkg in (tdb, repro.db):
        db = _mk_db(pkg, n=256, backend=backend)
        with db.serve(max_batch=8, idle_after_ms=10_000.0) as svc:
            qs = _mixed_queries(pkg, 43, 16, 20)
            counts.append(svc.warmup(qs))
            f = svc.submit(qs[0])
            assert int(f.count) == db.query(qs[0]).count
    assert counts[0] == counts[1] > 0


def test_future_surface():
    tdb_, jdb = _mk_pair(n=256)
    with tdb_.serve(max_delay_ms=0.5) as svc:
        f = svc.submit(tdb.col("a") == 1)
        r, c = f.result(timeout=T)
        assert f.done() and f.exception(timeout=T) is None
        want = jdb.query(repro.db.col("a") == 1)
        assert int(c) == want.count == f.count
        np.testing.assert_array_equal(f.ids, want.ids)
        assert "done" in repr(f)


# ------------------------------------------------------- drain/close/errors
def test_drain_and_close_answer_every_future_exactly_once():
    tdb_, jdb = _mk_pair(n=512)
    tq, jq = _both_queries(7, 90)
    svc = tdb_.serve(max_delay_ms=50.0, max_batch=64)
    futs = [svc.submit(q) for q in tq]
    svc.close(timeout=T)                 # close implies drain
    seqs = sorted(f.resolve_seq for f in futs)
    assert all(f.done() for f in futs), "close() dropped futures"
    assert seqs == list(range(1, len(futs) + 1)), \
        "every future answered exactly once"
    jr, jc = jdb.query_many(jq).materialize()
    for i, f in enumerate(futs):
        same(*f.result(timeout=T), jr[i], jc[i])
    with pytest.raises(ServiceClosed):
        svc.submit(tdb.col("a") == 0)
    svc.close(timeout=T)                 # idempotent
    assert svc.state == "closed"


def test_concurrent_close_and_submit():
    """close() racing submitters: every accepted submission resolves,
    every other raises ServiceClosed; a second close no-ops."""
    db = _mk_db(tdb, n=256)
    svc = db.serve(max_delay_ms=1.0, max_batch=8)
    accepted, refused = [], []

    def submitter():
        for i in range(50):
            try:
                accepted.append(svc.submit(tdb.col("a") == i % 8))
            except ServiceClosed:
                refused.append(i)

    th = threading.Thread(target=submitter)
    th.start()
    closers = [threading.Thread(target=svc.close, kwargs={"timeout": T})
               for _ in range(2)]
    for c in closers:
        c.start()
    for t_ in (th, *closers):
        t_.join(T)
        assert not t_.is_alive()
    assert len(accepted) + len(refused) == 50
    assert all(f.done() and f.exception(timeout=T) is None
               for f in accepted)
    assert svc.state == "closed"


def test_admission_reject_and_block_timeout():
    db = _mk_db(tdb, n=256)
    # a scheduler that never fires within the test window: the queue is
    # all admission control sees
    cfg = ServiceConfig(max_batch=10_000, max_delay_ms=60_000.0,
                        max_queue=4, admission="reject")
    svc = BitmapService(db, cfg)
    futs = [svc.submit(tdb.col("a") == (i % 8)) for i in range(4)]
    with pytest.raises(ServiceOverloaded) as exc:
        svc.submit(tdb.col("a") == 5)
    assert (exc.value.queue_depth, exc.value.limit,
            exc.value.admission) == (4, 4, "reject")
    assert svc.metrics().rejected == 1
    svc.close(timeout=T)                 # still answers the queued four
    assert all(f.done() for f in futs)

    cfg = ServiceConfig(max_batch=10_000, max_delay_ms=60_000.0,
                        max_queue=2, admission="block")
    svc = BitmapService(db, cfg)
    svc.submit(tdb.col("a") == 0)
    svc.submit(tdb.col("a") == 1)
    with pytest.raises(ServiceOverloaded) as exc:
        svc.submit(tdb.col("a") == 2, timeout=0.05)
    assert (exc.value.queue_depth, exc.value.limit,
            exc.value.admission) == (2, 2, "block")
    assert svc.metrics().rejected == 1
    svc.close(timeout=T)


def test_error_isolation_per_future():
    """One caller's bad query fails ITS future (the reference's exception
    type); everyone else's answers equal the reference's."""
    tdb_, jdb = _mk_pair(n=256)
    errs = []
    with tdb_.serve(max_delay_ms=20.0, max_batch=16) as svc:
        f1, fb, f2 = svc.submit_many([tdb.col("a") == 2,
                                      tplanner.key(999),
                                      tdb.col("b") == 9])
        assert svc.drain(timeout=T)
        errs.append(fb.exception(timeout=T))
        with pytest.raises(Exception):
            fb.result(timeout=T)
        jr, jc = jdb.query_many([repro.db.col("a") == 2,
                                 repro.db.col("b") == 9]).materialize()
        same(*f1.result(timeout=T), jr[0], jc[0])
        same(*f2.result(timeout=T), jr[1], jc[1])
        h = svc.health()
        assert h["isolated_failures"] == 1 and h["degraded_waves"] == 0
    with jdb.serve(max_delay_ms=20.0, max_batch=16) as jsvc:
        jfb = jsvc.submit_many([repro.db.col("a") == 2, jplanner.key(999)])[1]
        assert jsvc.drain(timeout=T)
        assert type(jfb.exception(timeout=T)) is type(errs[0])


# ------------------------------------------------------------ resilience
def test_resilience_primitives_match_reference():
    from repro.serve import resilience as jres
    from repro_torch.fault import InjectedFault
    from repro_torch.store.format import CorruptFileError
    for seed in (0, 1, 7):
        pol, jpol = RetryPolicy(), jres.RetryPolicy()
        assert list(pol.delays(seed)) == list(jpol.delays(seed))
    assert is_transient(OSError(5, "eio"))
    assert is_transient(InjectedFault("x"))
    assert not is_transient(CorruptFileError("crc"))
    # a CUDA error is a RuntimeError: never retried as transient
    assert not is_transient(RuntimeError("CUDA error: an illegal memory "
                                         "access was encountered"))
    assert not is_transient(ValueError("bad key"))
    now = [0.0]
    br = CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                        clock=lambda: now[0])
    jbr = jres.CircuitBreaker(failure_threshold=2, cooldown_s=1.0,
                              clock=lambda: now[0])
    for step in ("f", "f", "allow", "t", "allow", "f", "t", "allow", "s"):
        for b in (br, jbr):
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            elif step == "allow":
                b.allow()
        if step == "t":
            now[0] += 1.5
        assert br.snapshot() == jbr.snapshot()
    assert br.state == "closed" and br.trips == 2


@pytest.mark.parametrize("plan_kind", ["transient", "backend"])
def test_fault_ladder_matches_reference(plan_kind):
    """The self-healing ladder from the same FaultPlan JSON in both
    packages: a transient dispatch fault is retried on the preferred
    backend; a backend that keeps failing is served degraded on the
    fallback (the breaker records it).  Counters and answers agree."""
    from repro.fault import FaultInjector as JInj, FaultPlan as JPlan
    from repro_torch.fault import FaultInjector, FaultPlan, FaultSpec
    if plan_kind == "transient":
        spec = FaultSpec("engine.dispatch", "dispatch_error")
    else:
        spec = FaultSpec("engine.dispatch", "dispatch_error", count=3,
                         match=(("backend", "bulk"),))
    plan_json = FaultPlan((spec,)).to_json()
    healths, answers = [], []
    for pkg, inj, plan in ((tdb, FaultInjector, FaultPlan),
                           (repro.db, JInj, JPlan)):
        db = _mk_db(pkg, n=256, backend="bulk")
        qs = _mixed_queries(pkg, 9, 16, 6)
        with inj(plan.from_json(plan_json)):
            svc = db.serve(max_delay_ms=50.0, max_batch=16,
                           retry_base_ms=0.1)
            futs = svc.submit_many(qs)
            assert svc.drain(timeout=T)
            svc.close(timeout=T)
        h = svc.health()
        healths.append({k: h[k] for k in (
            "wave_retries", "degraded_waves", "fallback_queries",
            "isolated_failures", "deadline_rejected")})
        healths[-1]["breaker_failures"] = h["breaker"]["failures"]
        answers.append([f.result(timeout=T) for f in futs])
    assert healths[0] == healths[1]
    want = ({"wave_retries": 1, "degraded_waves": 0, "fallback_queries": 0}
            if plan_kind == "transient" else
            {"wave_retries": 2, "degraded_waves": 1, "fallback_queries": 6})
    assert {k: healths[0][k] for k in want} == want
    for (tr, tc), (jr, jc) in zip(*answers):
        same(tr, tc, jr, jc)


def test_card_session_serves_no_wave_on_a_plain_fallback():
    """On a CUDA device a plain fallback is no fallback: a backend that
    keeps failing rejects every future with its own error (per-query
    isolation) instead of being served by ``ref``; no wave runs there.
    The session here is a CPU one that names the card as its device, which
    is all the service reads to decide."""
    from repro_torch.fault import FaultInjector, FaultPlan, FaultSpec
    db = _mk_db(tdb, n=256, backend="bulk")
    db.device = torch.device("cuda")
    qs = _mixed_queries(tdb, 9, 16, 6)
    spec = FaultSpec("engine.dispatch", "dispatch_error", count=1000,
                     match=(("backend", "bulk"),))
    waves0 = tbatch.waves_by_backend()
    with FaultInjector(FaultPlan((spec,))):
        svc = db.serve(max_delay_ms=50.0, max_batch=16, retry_base_ms=0.1)
        assert svc.health()["fallback_backend"] is None
        futs = svc.submit_many(qs)
        assert svc.drain(timeout=T)
        svc.close(timeout=T)
    h = svc.health()
    assert (h["degraded_waves"], h["fallback_queries"],
            h["isolated_failures"]) == (0, 0, len(qs))
    assert h["breaker"]["failures"] == 0
    for f in futs:
        with pytest.raises(Exception, match="dispatch"):
            f.result(timeout=T)
    assert tbatch.waves_by_backend().get("ref", 0) == waves0.get("ref", 0)
    # the CPU keeps the reference's ladder; a kernel fallback stays one
    # on the card
    for device, fallback, want in (("cpu", "ref", "ref"),
                                   ("cuda", "cuda", "cuda")):
        db.device = torch.device(device)
        with db.serve(background=False, fallback_backend=fallback) as svc:
            assert svc.health()["fallback_backend"] == want


# ------------------------------------------------------------ standby cycle
def _wait_state(svc, state: str) -> None:
    deadline = time.monotonic() + T
    while svc.state != state and time.monotonic() < deadline:
        time.sleep(0.005)
    assert svc.state == state


def test_standby_transitions_and_energy_split():
    """Events: idle past idle_after_ms enters standby, a submission wakes
    it.  Rates: standby joules over standby seconds and active joules over
    busy + awake-idle seconds are the reference's model powers for the
    same BICConfig and PowerState."""
    db = _mk_db(tdb, n=256)
    jsched = JSched(1, JPaperConfig, JPowerState())
    with db.serve(max_delay_ms=0.5, idle_after_ms=5.0) as svc:
        svc.submit(tdb.col("a") == 1).result(timeout=T)
        assert svc.drain(timeout=T)
        _wait_state(svc, "standby")
        time.sleep(0.02)                 # accrue standby joules
        m = svc.metrics()
        assert m.standby_entries >= 1 and m.state == "standby"
        assert m.standby_joules > 0.0 and m.active_joules > 0.0
        assert m.standby_joules / m.standby_seconds == \
            pytest.approx(jsched.p_standby, rel=1e-9)
        assert m.active_joules / (m.busy_seconds + m.awake_idle_seconds) \
            == pytest.approx(jsched.p_active, rel=1e-9)
        assert jsched.p_standby < jsched.p_active / 1e3
        # a new submission wakes the scheduler
        svc.submit(tdb.col("a") == 2).result(timeout=T)
        assert svc.metrics().wakes >= 1
        assert svc.ledger.reconcile()["ok"]


def test_explicit_standby_and_metrics_shape():
    db = _mk_db(tdb, n=256)
    svc = db.serve(max_delay_ms=0.5, idle_after_ms=10_000.0)
    svc.submit(tdb.col("a") == 0).result(timeout=T)
    svc.standby()
    assert svc.state == "standby"
    m = svc.metrics()
    assert m.served == 1 and m.batches >= 1
    assert m.plan_cache["misses"] >= 1
    assert set(m.to_dict()) == set(
        repro.serve.service.ServiceMetrics.__dataclass_fields__)
    svc.close(timeout=T)
    assert svc.state == "closed"


def test_attach_runtime_shares_one_duty_cycle():
    """run_tick wakes a standby service for the tick and drops it back to
    standby after; the runtime's tick report charges the service ledger."""
    from repro_torch.core.bic import BICConfig
    from repro_torch.engine.runtime import MulticoreRuntime
    db = _mk_db(tdb, n=256)
    cfg = BICConfig(num_keys=16, num_records=64, words_per_record=2)
    rt = MulticoreRuntime(["cpu"], cfg)
    keys = torch.arange(16, dtype=torch.int32)
    with db.serve(idle_after_ms=10_000.0) as svc:
        with pytest.raises(RuntimeError, match="no runtime attached"):
            svc.run_tick(None, keys, 1.0)
        svc.attach_runtime(rt)
        svc.standby()
        recs = torch.from_numpy(_records(np.random.default_rng(2), 64)
                                [None])
        out = svc.run_tick(recs, keys, 1.0)
        assert len(out.indexes) == 1
        m = svc.metrics()
        assert m.wakes == 1 and m.standby_entries == 2
        assert svc.state == "standby"
        assert svc.ledger.report.batches >= 1


# ----------------------------------------------------- background maintenance
def _append_blocks(db, rng, nblocks, block, m=16):
    blocks = [_records(rng, block, m) for _ in range(nblocks)]
    for b in blocks:
        db.append_encoded(b)
    return blocks


def _rebuilt(blocks, m=16) -> np.ndarray:
    """The reference's from-scratch index of ``blocks`` (uint32 words)."""
    keys = jnp.arange(m, dtype=jnp.int32)
    return np.asarray(jbackends.get_backend("ref").create_index(
        jnp.asarray(np.concatenate(blocks)), keys))


def test_background_maintenance_spills_compacts_and_recovers(tmp_path):
    path = os.path.join(str(tmp_path), "idx")
    db = tdb.BitmapDB(_schema(tdb), path=path, spill_records=128,
                      backend="ref", device="cpu")
    svc = db.serve(max_delay_ms=1.0)
    assert svc._maint is not None
    assert db.store.auto_compact is False    # compaction is the executor's
    rng = np.random.default_rng(11)
    blocks = _append_blocks(db, rng, 16, 64)
    # serving stays correct while maintenance churns
    q = tdb.col("a") == 3
    want_ids = db.query(q).ids
    assert svc._maint_ex.flush(timeout=T)
    st = svc._maint_ex.stats()
    assert st["completed"].get("spill", 0) >= 1
    assert st["completed"].get("gc", 0) >= 1
    assert st["errors"] == 0
    assert db.store.durable_records > 0
    np.testing.assert_array_equal(svc.submit(q).ids, want_ids)
    svc.close(timeout=T)
    assert db.store.auto_compact is True     # detach restores it
    # restart: manifest + WAL recovery is bit-exact vs a full rebuild,
    # in both packages
    db2 = tdb.open(path, backend="ref", device="cpu")
    assert db2.num_records == 16 * 64
    np.testing.assert_array_equal(u32(db2.index.packed), _rebuilt(blocks))
    jdb2 = repro.open(path, backend="ref")
    np.testing.assert_array_equal(np.asarray(jdb2.index.packed),
                                  _rebuilt(blocks))
    np.testing.assert_array_equal(np.asarray(jdb2.query(
        repro.db.col("a") == 3).ids), want_ids)


def test_append_never_waits_for_a_held_spill(tmp_path, monkeypatch):
    """With background maintenance, appends do not serialize behind a
    spill: the worker is held inside the segment write (an event, not a
    clock) while every later append returns; releasing it lands the
    spills, and recovery is bit-exact."""
    gate, entered = threading.Event(), threading.Event()
    orig = tstore.SegmentStore.prepare_segment

    def held(self, *a, **kw):
        entered.set()
        assert gate.wait(T)
        return orig(self, *a, **kw)

    monkeypatch.setattr(tstore.SegmentStore, "prepare_segment", held)
    path = os.path.join(str(tmp_path), "idx")
    db = tdb.BitmapDB(_schema(tdb), path=path, spill_records=64,
                      backend="ref", capacity_words=64, device="cpu")
    svc = db.serve()
    rng = np.random.default_rng(13)
    blocks = [_records(rng, 64) for _ in range(8)]
    db.append_encoded(blocks[0])         # crosses the threshold
    assert entered.wait(T)               # the worker is inside the spill
    for b in blocks[1:]:
        db.append_encoded(b)             # returns while the spill is held
    assert not gate.is_set() and db.store.durable_records == 0
    assert db.num_records == 8 * 64
    gate.set()
    assert svc._maint_ex.flush(timeout=T)
    assert db.store.durable_records > 0  # the held spills DID land
    assert svc._maint_ex.stats()["errors"] == 0
    svc.close(timeout=T)
    db2 = tdb.open(path, backend="ref", device="cpu")
    np.testing.assert_array_equal(u32(db2.index.packed), _rebuilt(blocks))


def _crash_windows(pkg, path, window, rng_seed, monkeypatch):
    """Drive one crash window of the reference's service suite through
    ``pkg``; returns (recovered packed words, record count, gc'd names)."""
    db = pkg.BitmapDB(_schema(pkg), path=path, spill_records=None,
                      backend="ref", **_kw(pkg))
    rng = np.random.default_rng(rng_seed)
    nb = {"spill": 5, "carry": 3, "commit": 3}[window]
    blocks = _append_blocks(db, rng, nb, 64)
    si = db.indexer
    token = si.prepare_spill()
    assert token is not None             # segment file written...
    if window == "carry":
        racing = _records(rng, 48)       # appended mid-flush
        db.append_encoded(racing)
        blocks.append(racing)
        si.commit_spill(token)           # rotates + carries the block
    elif window == "commit":
        store_mod = tstore_impl if pkg is tdb else jstore_impl
        monkeypatch.setattr(store_mod, "commit",
                            lambda *a, **kw: (_ for _ in ()).throw(
                                OSError("disk full (simulated)")))
        with pytest.raises(OSError):
            si.commit_spill(token)
        si.abort_spill(token)
        monkeypatch.undo()
        racing = _records(rng, 48)       # lands in the switched generation
        db.append_encoded(racing)
        blocks.append(racing)
    # ...and the "process dies" here
    rec = pkg.open(path, backend="ref", **_kw(pkg))
    words = (u32(rec.index.packed) if pkg is tdb
             else np.asarray(rec.index.packed))
    np.testing.assert_array_equal(words, _rebuilt(blocks))
    removed = set(rec.store.gc())
    if window == "commit":
        db.snapshot()                    # live-session retry of the spill
        again = pkg.open(path, backend="ref", **_kw(pkg))
        np.testing.assert_array_equal(
            u32(again.index.packed) if pkg is tdb
            else np.asarray(again.index.packed), _rebuilt(blocks))
    if window == "carry":                # a recovery of the recovery
        again = pkg.open(path, backend="ref", **_kw(pkg))
        np.testing.assert_array_equal(
            u32(again.index.packed) if pkg is tdb
            else np.asarray(again.index.packed), _rebuilt(blocks))
    return words, rec.num_records, token[0].file in removed


@pytest.mark.parametrize("window", ["spill", "carry", "commit"])
def test_crash_windows_end_the_same_way(window, tmp_path, monkeypatch):
    """The reference's crash windows — between the background segment
    write and the manifest swap, a block racing the flush (the WAL
    carry-over), a failed manifest commit then a retry — through both
    packages: the recovered indexes are equal, bit-exact against a
    rebuild, and a prepared segment that never committed is gc fodder
    alike."""
    outs = [_crash_windows(pkg, str(tmp_path / pkg.__name__), window, 17,
                           monkeypatch)
            for pkg in (tdb, repro.db)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
    assert outs[0][2] == (window != "carry")   # prepared, never committed


# ---------------------------------------------------------- store satellites
def test_gc_inflight_guard_and_dry_run(tmp_path):
    path = os.path.join(str(tmp_path), "idx")
    db = tdb.BitmapDB(_schema(tdb), path=path, spill_records=None,
                      backend="ref", device="cpu")
    _append_blocks(db, np.random.default_rng(23), 2, 64)
    token = db.indexer.prepare_spill()
    store = db.store
    st = store.gc()                      # concurrent with the flush
    assert token[0].file in st.skipped_inflight
    assert token[0].file not in st
    db.indexer.commit_spill(token)       # file survives to become live
    assert any(s.file == token[0].file for s in store.segments)
    dry = store.gc(dry_run=True)
    assert dry.dry_run
    for name in dry:                     # nothing actually deleted
        assert os.path.exists(os.path.join(path, name))
    wet = store.gc()
    assert tuple(wet) == tuple(dry)
    for name in wet:
        assert not os.path.exists(os.path.join(path, name))
    assert wet.bytes_reclaimed == dry.bytes_reclaimed


def test_compact_stats_and_dry_run(tmp_path):
    """Four same-tier segments compact alike in both packages (the merged
    files' words equal) and the dry run touches nothing."""
    stats = []
    for pkg_store, backends in ((tstore, tbackends),
                                (repro.store, jbackends)):
        rng = np.random.default_rng(29)
        keys = np.arange(8, dtype=np.int32)
        store = pkg_store.SegmentStore(str(tmp_path / pkg_store.__name__),
                                       compact_fanout=2, auto_compact=False)
        store.ensure_keys(keys)
        at = 0
        for _ in range(4):
            rec = rng.integers(0, 8, (16, 2), dtype=np.int32)
            if pkg_store is tstore:
                packed = u32(backends.get_backend("ref").create_index(
                    torch.from_numpy(rec), torch.from_numpy(keys)))
            else:
                packed = np.asarray(backends.get_backend("ref")
                                    .create_index(jnp.asarray(rec),
                                                  jnp.asarray(keys)))
            store.write_segment(packed, 16, at)
            at += 16
        dry = store.compact(dry_run=True)
        assert dry.dry_run and dry.merges >= 1 and dry.segments_merged >= 2
        assert len(store.segments) == 4
        wet = store.compact()
        assert wet == dry.merges
        assert wet.segments_merged == dry.segments_merged
        assert wet.bytes_written > 0 and wet.bytes_reclaimed > 0
        assert store.compact() == 0      # idempotent
        stats.append((int(wet), wet.segments_merged, wet.bytes_written,
                      [(s.start_record, s.num_records)
                       for s in store.segments],
                      store.load_packed()[0].tolist()))
    assert stats[0] == stats[1]


def test_plan_cache_bounds_and_stats():
    db = _mk_db(tdb, n=256)
    db._VALUE_CACHE_LIMIT = 8            # instance override for the test
    qs = _mixed_queries(tdb, 31, 16, 40)
    for q in qs:
        db.query(q)
    st = db.cache_stats()
    assert st["value_size"] <= 8
    assert st["value_evictions"] > 0
    assert st["misses"] > 0
    before = db.cache_stats()["id_hits"]
    db.query(qs[-1])                     # the same OBJECT: identity hit
    assert db.cache_stats()["id_hits"] == before + 1
    db.replan()
    db.query(tdb.col("a") == 1)
    db.query(tdb.col("a") == 1)          # structurally equal: value hit
    assert db.cache_stats()["value_hits"] >= 1


# ------------------------------------------------------------- data pipeline
def test_pipeline_prefetch_matches_sync_and_reference():
    from repro.data.pipeline import (BitmapIndexedDataset as JDS,
                                     DataConfig as JCfg)
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    kw = dict(vocab_size=64, seq_len=8, docs_per_shard=64, num_shards=2,
              num_attributes=32)
    ds = BitmapIndexedDataset(DataConfig(**kw), device="cpu")
    jds = JDS(JCfg(**kw))
    col, jcol = tdb.col, repro.db.col
    w = (col("domain").isin([0, 1])) & ~(col("quality") == 4)
    jw = (jcol("domain").isin([0, 1])) & ~(jcol("quality") == 4)
    try:
        futs = ds.select_many_async(0, [w, col("lang") == 1])
        sync = ds.select_many(0, [w, col("lang") == 1])
        jsync = jds.select_many(0, [jw, jcol("lang") == 1])
        for f, ids, jids in zip(futs, sync, jsync):
            np.testing.assert_array_equal(f.ids, ids)
            np.testing.assert_array_equal(ids, jids)
        b1 = next(ds.batches(4, where=w, seed=3, prefetch=True))
        b2 = next(ds.batches(4, where=w, seed=3, prefetch=False))
        jb = next(jds.batches(4, where=jw, seed=3))
        for k in ("tokens", "labels"):
            assert b1[k].device.type == "cpu"
            assert torch.equal(b1[k], b2[k])
            np.testing.assert_array_equal(b1[k].numpy(), np.asarray(jb[k]))
    finally:
        ds.close()
        jds.close()


def test_pipeline_durable_shards_reopen(tmp_path):
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    cfg = DataConfig(vocab_size=64, seq_len=8, docs_per_shard=64,
                     num_shards=2, num_attributes=32)
    w = tplanner.key(9) & ~tplanner.key(20)
    a = BitmapIndexedDataset(cfg, store_dir=str(tmp_path), device="cpu")
    ids = a.select(0, where=w)
    b = BitmapIndexedDataset(cfg, store_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(b.select(0, where=w), ids)
    assert b.db(0).store.durable_records == 64

