"""The port's cost model (``repro_torch.engine.costmodel``) and the ``auto``
paths it routes, against the JAX package's, on the CPU.

The reference's cost-model tests (``tests/test_backend_sweep.py``) replayed
through both packages: under the same :class:`Calibration` — the
reference's ``pallas`` row named ``cuda`` in the port — every
:class:`Decision` is equal (backend, factoring, stacking, estimates,
terms); calibration JSON written by either package reads in the other; the
port keeps its own env var and file; ``BitmapDB.explain`` surfaces the same
decision; an ``auto`` service warms the same candidates; and a switch of the
calibration mid-traffic changes no result bit.  Answers are compared with
the reference's bit for bit (integers: no tolerance).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
from repro import store as jstore  # noqa: E402
from repro.engine import batch as jbatch  # noqa: E402
from repro.engine import costmodel as jcm  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro_torch import db as tdb  # noqa: E402
from repro_torch import store as tstore  # noqa: E402
from repro_torch.engine import backends as tbackends  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import costmodel as tcm  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402

#: the reference's backend names -> the port's
NAME = {"pallas": "cuda", "ref": "ref", "bulk": "bulk"}


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _cals(bulk_wps=4e9, ref_wps=2e9, pallas_wps=5e5, copy=1e10,
          bulk_oh=5e-5, ref_oh=4e-5, pallas_oh=2e-3):
    """The reference test's calibration, built in both packages (the
    reference's ``pallas`` row is the port's ``cuda``)."""
    out = []
    for cm, kernel in ((jcm, "pallas"), (tcm, "cuda")):
        out.append(cm.Calibration((
            ("bulk", cm.BackendProfile(bulk_wps, bulk_oh)),
            (kernel, cm.BackendProfile(pallas_wps, pallas_oh)),
            ("ref", cm.BackendProfile(ref_wps, ref_oh)),
        ), copy, "cpu", "measured"))
    return out


def _norm(d, names=NAME) -> tuple:
    """A Decision with backend names in the port's spelling."""
    return (names[d.backend], d.factor, d.stack_uniform,
            tuple((names[n], t) for n, t in d.estimates), dict(d.terms))


def _both(build):
    """``build(planner)`` for each package: the same plans in both."""
    return build(jplanner), build(tplanner)


@pytest.fixture(autouse=True)
def _no_calibration_file(tmp_path, monkeypatch):
    """Both packages on their priors unless a test installs a calibration
    (no file of a developer's machine leaks in)."""
    monkeypatch.setenv(jcm.ENV_PATH, str(tmp_path / "none-j.json"))
    monkeypatch.setenv(tcm.ENV_PATH, str(tmp_path / "none-t.json"))
    jcm.set_calibration(None)
    tcm.set_calibration(None)
    yield
    jcm.set_calibration(None)
    tcm.set_calibration(None)


# ----------------------------------------------------------- calibration
def test_calibration_json_roundtrip_and_crosses_packages(tmp_path):
    jcal, tcal = _cals()
    assert tcm.CALIBRATION_VERSION == jcm.CALIBRATION_VERSION
    again = tcm.Calibration.from_json(tcal.to_json())
    assert again == tcal
    p = tcm.save_calibration(tcal, str(tmp_path / "cal.json"))
    assert tcm.load_calibration(p) == tcal
    with open(p) as f:
        assert json.load(f)["version"] == tcm.CALIBRATION_VERSION
    # either package reads what the other wrote, field for field
    jp = jcm.save_calibration(jcal, str(tmp_path / "j.json"))
    assert tcm.load_calibration(jp).to_json() == jcal.to_json()
    assert jcm.load_calibration(p).to_json() == tcal.to_json()


def test_port_has_its_own_env_var_and_file(tmp_path, monkeypatch):
    assert tcm.ENV_PATH == "REPRO_TORCH_BITMAP_CALIBRATION"
    assert tcm.ENV_PATH != jcm.ENV_PATH
    assert tcm.DEFAULT_PATH == os.path.join(
        "results", "bitmap_calibration_torch.json")
    assert tcm.DEFAULT_PATH != jcm.DEFAULT_PATH
    monkeypatch.delenv(tcm.ENV_PATH)
    assert tcm.calibration_path() == tcm.DEFAULT_PATH
    # the reference's env var names nothing the port reads
    _, tcal = _cals(bulk_wps=7.5e9)
    ref_file = tcm.save_calibration(tcal, str(tmp_path / "ref.json"))
    monkeypatch.setenv(jcm.ENV_PATH, ref_file)
    assert tcm.calibration_path() == tcm.DEFAULT_PATH


def test_calibration_env_path_and_reset(tmp_path, monkeypatch):
    p = str(tmp_path / "cal.json")
    _, tcal = _cals(bulk_wps=7.5e9)
    tcm.save_calibration(tcal, p)
    monkeypatch.setenv(tcm.ENV_PATH, p)
    tcm.set_calibration(None)                # drop the cached calibration
    got = tcm.get_calibration("cpu")
    assert got.source == "measured"
    assert got.profile("bulk").words_per_sec == 7.5e9
    # a file measured on another device type yields that type's priors
    card = tcm.get_calibration("cuda")
    assert card.source == "default" and card.platform == "cuda"
    assert card == tcm._platform_default("cuda")


def test_calibration_per_device_type():
    """A process holding CPU and card sessions reads each device type's
    calibration; an installed one replaces only its own platform's."""
    cpu, card = tcm.get_calibration("cpu"), tcm.get_calibration("cuda")
    assert (cpu.platform, card.platform) == ("cpu", "cuda")
    assert tcm.get_calibration() is card     # no device: the card
    _, tcal = _cals(bulk_wps=9e9)
    tcm.set_calibration(tcal)
    assert tcm.get_calibration("cpu") is tcal
    assert tcm.get_calibration("cuda") is card
    assert tcm.candidates(device="cuda") == ("cuda",)
    tcm.set_calibration(None)
    assert tcm.get_calibration("cpu") == cpu


def test_cpu_priors_are_the_references():
    """The port's CPU priors carry the reference's CPU numbers, with the
    interpreted ``pallas`` row as ``cuda``: cut by CANDIDATE_CUTOFF alike."""
    jdef, tdef = jcm.get_calibration(), tcm.get_calibration("cpu")
    assert jdef.platform == "cpu" and tdef.source == jdef.source
    assert {NAME[n]: p.words_per_sec for n, p in jdef.profiles} == \
        {n: p.words_per_sec for n, p in tdef.profiles}
    assert {NAME[n]: p.dispatch_overhead_s for n, p in jdef.profiles} == \
        {n: p.dispatch_overhead_s for n, p in tdef.profiles}
    assert tdef.copy_bytes_per_sec == jdef.copy_bytes_per_sec
    assert tcm.CANDIDATE_CUTOFF == jcm.CANDIDATE_CUTOFF
    assert tcm.candidates(device="cpu") == jcm.candidates() == \
        ("bulk", "ref")


def test_candidates_cutoff_drops_the_slow_kernel_path():
    jcal, tcal = _cals()
    names = tcm.candidates(tcal)
    assert "cuda" not in names               # 5e5 wps vs 4e9: way past 32x
    assert set(names) == {"bulk", "ref"} == set(jcm.candidates(jcal))
    # within the cutoff the kernel path is a candidate in both packages
    jcal, tcal = _cals(pallas_wps=1e9)
    assert tcm.candidates(tcal) == tuple(NAME[n]
                                         for n in jcm.candidates(jcal))


@pytest.mark.parametrize("bulk_wps", [4.5e10, 4.5e11])
def test_card_candidates_are_the_kernels_alone(bulk_wps):
    """On a CUDA device ``auto`` serves on the kernels alone, whatever the
    plain rows of the card's calibration say: the model decides factoring
    and stacking there, never a plain backend."""
    card = tcm.Calibration((
        ("bulk", tcm.BackendProfile(bulk_wps, 1e-6)),
        ("cuda", tcm.BackendProfile(4.5e10, 5.3e-4)),
        ("ref", tcm.BackendProfile(bulk_wps, 1e-6)),
    ), 2.9e12, "cuda", "measured")
    assert tcm.candidates(card) == tcm.candidates(card, device="cuda") \
        == ("cuda",)
    k = tplanner.key
    wave = [tplanner.plan(k(1) & ~k(2)),
            tplanner.plan(tplanner.And(tuple(k(2 * i) | k(2 * i + 1)
                                             for i in range(8))))]
    for plans in (wave[:1], wave[1:], wave):
        for segs in (1, 8):
            d = tcm.decide(plans, num_words=1 << 15, num_segments=segs,
                           num_keys=256, cal=card)
            assert d.backend == "cuda"
            assert [n for n, _ in d.estimates] == ["cuda"]
    # the CPU still weighs every backend within the cutoff
    cpu = dataclasses.replace(card, platform="cpu")
    assert tcm.candidates(cpu) == ("bulk", "cuda", "ref")


def test_candidates_nothing_usable_falls_back_by_device():
    empty = tcm.Calibration((("pallas", tcm.BackendProfile(1e9, 1e-4)),),
                            1e10, "cpu")
    assert tcm.candidates(empty) == ("ref",)
    assert tcm.candidates(empty, device="cuda") == ("cuda",)
    d = tcm.decide([tplanner.plan(tplanner.key(0))], num_words=64,
                   cal=empty)
    assert (d.backend, d.stack_uniform) == ("ref", True)


# --------------------------------------------------------------- decisions
def _waves():
    """The reference test's waves, plus a mixed one."""
    def eight(P):
        return [P.plan(P.key(i) & ~P.key(i + 1)) for i in range(8)]

    def wide(P):                 # many clauses sharing a 3-literal prefix
        shared = P.key(0) & P.key(1) & P.key(2)
        return [P.plan(P.Or(tuple(shared & P.key(3 + i) for i in range(8))))]

    def flat(P):
        return [P.plan(P.key(i)) for i in range(6)]

    def sixteen(P):
        return [P.plan(P.key(i % 8)) for i in range(16)]

    def mixed(P):
        k = P.key
        comp = P.And(tuple(k(2 * i) | k(2 * i + 1) for i in range(8)))
        return [P.plan(k(1) | (k(2) & ~k(3))), P.plan(k(4) & ~k(4)),
                P.plan(comp), P.plan((k(5) | k(6)) & (k(7) | k(8)))]
    return {"eight": eight, "wide": wide, "flat": flat,
            "sixteen": sixteen, "mixed": mixed}


CALS = {
    "prior-like": {},
    "fast bulk": {"bulk_wps": 8e9, "ref_wps": 1e9},
    "fast ref": {"bulk_wps": 1e9, "ref_wps": 8e9},
    "fat copy": {"bulk_oh": 5e-3, "ref_oh": 5e-3, "copy": 1e12},
    "starved copy": {"bulk_oh": 1e-9, "ref_oh": 1e-9, "copy": 1e6},
    "fast kernel": {"pallas_wps": 9e10, "pallas_oh": 1e-5},
}


@pytest.mark.parametrize("cal", sorted(CALS))
@pytest.mark.parametrize("wave", sorted(_waves()))
@pytest.mark.parametrize("segments", [1, 12])
def test_decide_equals_reference(cal, wave, segments):
    jcal, tcal = _cals(**CALS[cal])
    jplans, tplans = _both(_waves()[wave])
    for nw, stats_n in ((256, None), (1 << 14, 5000)):
        kw = dict(num_words=nw, num_segments=segments, num_keys=32)
        js = ts = None
        if stats_n is not None:
            counts = np.random.default_rng(nw).integers(0, stats_n, 32)
            js = jplanner.KeyStats.from_counts(counts, stats_n)
            ts = tplanner.KeyStats.from_counts(counts, stats_n)
        want = jcm.decide(jplans, stats=js, cal=jcal, **kw)
        got = tcm.decide(tplans, stats=ts, cal=tcal, **kw)
        assert _norm(got, {n: n for n in NAME.values()}) == _norm(want)
        assert got.est_seconds == want.est_seconds


def test_decide_picks_calibrated_fastest():
    plans = [tplanner.plan(tplanner.key(i) & ~tplanner.key(i + 1))
             for i in range(8)]
    fast_bulk = tcm.decide(plans, num_words=1 << 14,
                           cal=_cals(bulk_wps=8e9, ref_wps=1e9)[1])
    assert fast_bulk.backend == "bulk"
    fast_ref = tcm.decide(plans, num_words=1 << 14,
                          cal=_cals(bulk_wps=1e9, ref_wps=8e9)[1])
    assert fast_ref.backend == "ref"
    assert dict(fast_ref.estimates)["ref"] < dict(fast_ref.estimates)["bulk"]
    assert fast_ref.terms["streamed_words"] > 0


def test_decide_memoizes_on_wave():
    plans = tuple(tplanner.plan(tplanner.key(i)) for i in range(4))
    tcal = _cals()[1]
    calls, computed = tcm._DECIDE_CALLS.value, tcm._DECIDE_COMPUTED.value
    a = tcm.decide(list(plans), num_words=4096, cal=tcal)
    b = tcm.decide(list(plans), num_words=4096, cal=tcal)
    assert a is b                            # same cached Decision object
    c = tcm.decide(list(plans), num_words=8192, cal=tcal)
    assert c is not a
    assert tcm._DECIDE_CALLS.value - calls == 3
    assert tcm._DECIDE_COMPUTED.value - computed <= 2
    # the key holds host values only: plans, stats and the calibration
    hash((plans, tcal))


def test_decide_factoring_and_stacking_tradeoffs():
    tplans = _waves()["wide"](tplanner)
    assert tcm.decide(tplans, num_words=1 << 14, cal=_cals()[1]).factor
    flat = _waves()["flat"](tplanner)
    assert not tcm.decide(flat, num_words=1 << 14, cal=_cals()[1]).factor
    sixteen = _waves()["sixteen"](tplanner)
    d = tcm.decide(sixteen, num_words=256, num_segments=12, num_keys=32,
                   cal=_cals(**CALS["fat copy"])[1])
    assert d.stack_uniform
    d2 = tcm.decide(sixteen, num_words=256, num_segments=12, num_keys=32,
                    cal=_cals(**CALS["starved copy"])[1])
    assert not d2.stack_uniform


def test_measure_calibration_tiny_smoke():
    cal = tcm.measure_calibration(num_records=1 << 12, num_keys=16,
                                  num_queries=4, reps=1,
                                  backend_names=("ref", "bulk"),
                                  probe_seconds=10.0, device="cpu")
    assert cal.source == "measured" and cal.platform == "cpu"
    assert cal.copy_bytes_per_sec > 0
    for name in ("ref", "bulk"):
        prof = cal.profile(name)
        assert prof.words_per_sec > 0 and prof.dispatch_overhead_s > 0
    # the slow-probe branch keeps the probe-sized estimate
    slow = tcm.measure_calibration(num_records=1 << 12, num_keys=16,
                                   num_queries=4, reps=1,
                                   backend_names=("cuda",),
                                   probe_seconds=0.0, device="cpu")
    assert slow.profile("cuda").words_per_sec > 0
    assert tcm.Calibration.from_json(cal.to_json()) == cal


# ------------------------------------------- auto through the batch layer
def _index(n, m, seed=7):
    rng = np.random.default_rng(seed)
    nw = (n + 31) // 32
    return rng.integers(0, 2 ** 32, (m, nw), dtype=np.uint32)


def _random_pred(rng, m, depth, P):
    if depth == 0 or rng.random() < 0.3:
        leaf = P.key(int(rng.integers(0, m)))
        return ~leaf if rng.random() < 0.4 else leaf
    children = tuple(_random_pred(rng, m, depth - 1, P)
                     for _ in range(int(rng.integers(2, 4))))
    node = P.And(children) if rng.random() < 0.5 else P.Or(children)
    return ~node if rng.random() < 0.2 else node


@pytest.mark.parametrize("cal", ["prior-like", "fast bulk", "fast ref",
                                 "fat copy"])
def test_auto_waves_match_reference(cal):
    """``auto`` under the same calibration, with stats, over one index and
    over a 3-segment chain (stacking decided by the model): the port's
    rows and counts equal the reference's, and its decision too."""
    import jax.numpy as jnp
    jcal, tcal = _cals(**CALS[cal])
    jcm.set_calibration(jcal)
    tcm.set_calibration(tcal)
    m, n = 24, 1000
    packed = _index(n, m)
    preds = _both(lambda P: [_random_pred(np.random.default_rng(i), m, 3, P)
                             for i in range(20)]
                  + [P.key(1) & ~P.key(1)])
    counts = np.bitwise_count(packed).sum(axis=1)
    js = jplanner.KeyStats.from_counts(counts, n)
    ts = tplanner.KeyStats.from_counts(counts, n)
    jr, jc = jbatch.execute_many(jnp.asarray(packed), preds[0],
                                 num_records=n, stats=js)
    tr, tc = tbatch.execute_many(
        torch.from_numpy(packed.view(np.int32)), preds[1], num_records=n,
        stats=ts)
    np.testing.assert_array_equal(u32(tr), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    parts = [(_index(n, m, seed=s), n) for s in (1, 2, 3)]
    jr, jc = jbatch.execute_many_segments(
        [(jnp.asarray(p), k) for p, k in parts], preds[0], stats=js)
    tr, tc = tbatch.execute_many_segments(
        [(torch.from_numpy(p.view(np.int32)), k) for p, k in parts],
        preds[1], stats=ts)
    np.testing.assert_array_equal(u32(tr), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jp = [jplanner.plan(p) for p in preds[0]]
    tp = [tplanner.plan(p) for p in preds[1]]
    kw = dict(num_words=packed.shape[1], num_segments=3, num_keys=m)
    assert _norm(tcm.decide(tp, stats=ts, device="cpu", **kw),
                 {k: k for k in NAME.values()}) == \
        _norm(jcm.decide(jp, stats=js, **kw))


def test_planner_execute_auto_routes_through_the_cost_model():
    tcm.set_calibration(_cals(bulk_wps=9e9, ref_wps=1e9)[1])
    packed = torch.from_numpy(_index(500, 8).view(np.int32))
    calls = tcm._DECIDE_CALLS.value
    r, c = tplanner.execute(packed, tplanner.key(1) | tplanner.key(2),
                            num_records=500)
    want_r, want_c = tplanner.execute(packed,
                                      tplanner.key(1) | tplanner.key(2),
                                      num_records=500, backend="ref")
    assert tcm._DECIDE_CALLS.value == calls + 1
    assert torch.equal(r, want_r) and int(c) == int(want_c)


# ------------------------------------------------- explain + warmup wiring
def _mk_db(pkg, n=512, m=16, backend="auto"):
    half = m // 2
    schema = pkg.Schema([pkg.Column.categorical("a", list(range(half))),
                         pkg.Column.categorical("b", list(range(half, m)))])
    rng = np.random.default_rng(0)
    kw = {"device": "cpu"} if pkg is tdb else {}
    db = pkg.BitmapDB(schema, backend=backend, **kw)
    db.append_encoded(np.stack([rng.integers(0, half, n, dtype=np.int32),
                                rng.integers(half, m, n, dtype=np.int32)],
                               axis=1))
    return db


def _explain_q(pkg):
    col = pkg.col
    return (col("a") == 1) | ((col("a") == 2) & ~(col("b") == 9))


def _norm_explain(ex) -> dict:
    out = dict(ex)
    out["plan"] = getattr(ex["plan"], "clauses", repr(ex["plan"]))
    out["backend"] = NAME.get(ex["backend"], ex["backend"])
    d = ex["decision"]
    if d is not None:
        out["decision"] = {**d, "backend": NAME[d["backend"]],
                           "estimates": {NAME[k]: v for k, v
                                         in d["estimates"].items()}}
    return out


def test_db_explain_surfaces_decision():
    db = _mk_db(tdb)
    ex = db.explain(_explain_q(tdb))
    assert ex["backend"] in tbackends.available_backends()
    assert ex["bucket_shape"] is not None
    assert ex["num_records"] == 512
    assert ex["est_matches"] is not None and ex["est_matches"] >= 0
    assert 0.0 <= ex["est_selectivity"] <= 1.0
    d = ex["decision"]
    assert d is not None and d["backend"] == ex["backend"]
    assert set(d["estimates"]) >= {"ref"}
    assert d["terms"]["streamed_words"] > 0
    # the reference's explain of the same query on the same data
    assert _norm_explain(ex) == _norm_explain(
        _mk_db(repro.db).explain(_explain_q(repro.db)))
    # a pinned session reports its pinned backend, no decision
    ex2 = _mk_db(tdb, backend="ref").explain(_explain_q(tdb))
    assert ex2["backend"] == "ref" and ex2["decision"] is None
    # contradiction short-circuits
    col = tdb.col
    ex3 = db.explain((col("a") == 1) & ~(col("a") == 1))
    assert ex3.get("fallback") == "contradiction"
    assert db.query((col("a") == 1) & ~(col("a") == 1)).count == 0


@pytest.mark.parametrize("kind", ["durable", "stored"])
def test_db_explain_on_durable_and_stored_sessions(kind, tmp_path):
    """explain over a durable session and over a read-only StoredIndex of
    3 segments equals the reference's on the same data."""
    rng = np.random.default_rng(5)
    blocks = [np.stack([rng.integers(0, 8, 96, dtype=np.int32),
                        rng.integers(8, 16, 96, dtype=np.int32)], axis=1)
              for _ in range(3)]
    exs = []
    for pkg in (tdb, repro.db):
        path = str(tmp_path / f"{pkg.__name__}")
        kw = {"device": "cpu"} if pkg is tdb else {}
        db = pkg.BitmapDB(num_keys=16, path=path, spill_records=96, **kw)
        for b in blocks:
            db.append_encoded(b)
        if kind == "stored":
            store_mod = tstore if pkg is tdb else jstore
            st = store_mod.SegmentStore(path)
            db = pkg.BitmapDB.from_index(store_mod.open_index(st, **kw))
        planner = tplanner if pkg is tdb else jplanner
        exs.append(_norm_explain(db.explain(planner.key(3) & ~planner.key(9))))
    assert exs[0] == exs[1]
    assert exs[0]["segments"] == (3 if kind == "stored" else 1)


def test_service_warmup_is_backend_keyed():
    counts = {}
    for pkg in (tdb, repro.db):
        col = pkg.col
        qs = [col("a") == 1, (col("a") == 2) & ~(col("b") == 9)]
        for backend in ("auto", "ref"):
            db = _mk_db(pkg, backend=backend)
            with db.serve(max_batch=4, idle_after_ms=10_000.0) as svc:
                counts[pkg.__name__, backend] = svc.warmup(qs)
    n_cands = len(tcm.candidates(device="cpu"))
    assert n_cands >= 2                      # bulk + ref at least, on CPU
    t = counts["repro_torch.db", "auto"], counts["repro_torch.db", "ref"]
    assert t[0] == t[1] * n_cands            # one warm pass per candidate
    assert t == (counts["repro.db", "auto"], counts["repro.db", "ref"])


def test_auto_switch_mid_traffic_is_bit_exact():
    """Flipping the calibration (hence the chosen backend) between waves
    never changes result bits — the executor caches are backend-keyed —
    and the answers are the reference's."""
    db = _mk_db(tdb, n=700)
    col = tdb.col
    q = [(col("a") == 1) | (col("b") == 9), ~(col("a") == 3)]
    # equal dispatch overheads: the words decide, so the switch is real
    tcm.set_calibration(_cals(bulk_wps=9e9, ref_wps=1e9, bulk_oh=4e-5)[1])
    assert db.explain(q[0])["backend"] == "bulk"
    r1, c1 = db.query_many(q).materialize()
    tcm.set_calibration(_cals(bulk_wps=1e9, ref_wps=9e9, bulk_oh=4e-5)[1])
    assert db.explain(q[0])["backend"] == "ref"
    r2, c2 = db.query_many(q).materialize()
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    jdb = _mk_db(repro.db, n=700, backend="ref")
    jcol = repro.db.col
    jr, jc = jdb.query_many([(jcol("a") == 1) | (jcol("b") == 9),
                             ~(jcol("a") == 3)]).materialize()
    np.testing.assert_array_equal(u32(r1), np.asarray(jr))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc))
