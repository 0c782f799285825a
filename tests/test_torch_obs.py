"""The port's observability, fault fabric and silicon energy model
(``repro_torch.obs``, ``repro_torch.fault``, ``repro_torch.core.power`` /
``elastic``) against the JAX package's twins, on the CPU.

These modules are arithmetic and bookkeeping, so the two packages must
agree exactly: every power-model function over a grid of operating points,
every ``EnergyReport`` field of a scheduler run, every schedule, the energy
ledger's numbers (same arithmetic in the same order: floats compared with
``==``), the Prometheus text of the same metric operations and the same
fault plan firing at the same occurrences.  Each package keeps its own
module globals: an injector or tracer installed in one never fires in the
other.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

from repro.core import elastic as jelastic  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.fault import FaultInjector as JInjector  # noqa: E402
from repro.fault import FaultPlan as JPlan  # noqa: E402
from repro.fault import seam as jseam  # noqa: E402
from repro.obs import energy as jenergy  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.store import format as jfmt  # noqa: E402
from repro_torch.core import bic as tbic  # noqa: E402
from repro_torch.core import elastic as telastic  # noqa: E402
from repro_torch.core import power as tpower  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine import runtime as truntime  # noqa: E402,F401
from repro_torch.fault import FaultInjector as TInjector  # noqa: E402
from repro_torch.fault import FaultPlan as TPlan  # noqa: E402
from repro_torch.fault import FaultSpec as TSpec  # noqa: E402
from repro_torch.fault import InjectedFault as TInjectedFault  # noqa: E402
from repro_torch.fault import seam as tseam  # noqa: E402
from repro_torch.obs import energy as tenergy  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.store import format as tfmt  # noqa: E402
from repro_torch.store import wal as twal  # noqa: E402,F401

VDD = (0.3, 0.4, 0.55, 0.8, 1.0, 1.2)
VBB = (0.0, -0.5, -1.0, -1.5, -2.0)


# ------------------------------------------------------------ power model
@pytest.mark.parametrize("vdd,vbb", list(itertools.product(VDD, VBB)))
def test_power_model_equal_over_grid(vdd, vbb):
    for fn in ("standby_current", "standby_power", "standby_power_per_bit"):
        assert getattr(tpower, fn)(vdd, vbb) == getattr(jpower, fn)(vdd, vbb)
    assert (tpower.standby_power(vdd, vbb, clock_gated=False)
            == jpower.standby_power(vdd, vbb, clock_gated=False))
    for fn in ("frequency", "active_power", "energy_per_cycle"):
        assert getattr(tpower, fn)(vdd) == getattr(jpower, fn)(vdd)


def test_power_model_constants_and_anchors():
    assert tpower.PAPER_ANCHORS == jpower.PAPER_ANCHORS
    assert ([dataclasses.astuple(r) for r in tpower.TABLE_I]
            == [dataclasses.astuple(r) for r in jpower.TABLE_I])
    assert tpower.MEMORY_BITS == jpower.MEMORY_BITS
    # the paper's headline: 162.9 pJ/cycle at 1.2 V, 0.31 pW/bit standby
    assert abs(tpower.energy_per_cycle(1.2) * 1e12 - 162.9) < 1.0
    assert abs(tpower.standby_power_per_bit() * 1e12 - 0.31) < 0.05


# ---------------------------------------------------------------- elastic
def _sched(pkg, cores, cfg, use_rbb):
    if pkg == "jax":
        from repro.core.bic import BICConfig
        return jelastic.ElasticScheduler(
            cores, BICConfig(**cfg), jelastic.PowerState(use_rbb=use_rbb))
    return telastic.ElasticScheduler(
        cores, tbic.BICConfig(**cfg), telastic.PowerState(use_rbb=use_rbb))


REPORT_FIELDS = ("active_joules", "standby_joules", "busy_core_seconds",
                 "idle_core_seconds", "batches", "total_joules")


@pytest.mark.parametrize("cores,cfg,use_rbb,workloads,tick", [
    (8, {}, True, [10, 0, 1000, 3], 0.01),
    (1, {}, False, [0, 0, 5], 0.5),
    (4, {"num_keys": 256, "num_records": 1 << 22, "words_per_record": 32},
     True, [2, 0, 1], 1.0),
])
def test_elastic_scheduler_run_equal(cores, cfg, use_rbb, workloads, tick):
    js, ts = (_sched(p, cores, cfg, use_rbb) for p in ("jax", "torch"))
    assert ts.batch_seconds == js.batch_seconds
    assert (ts.p_active, ts.p_standby) == (js.p_active, js.p_standby)
    jr, tr = js.run(workloads, tick), ts.run(workloads, tick)
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.total_joules > 0
    # a measured busy time and a calibrated batch time, as the runtime
    # charges them
    js.calibrate(123.4)
    ts.calibrate(123.4)
    assert ts.batch_seconds == js.batch_seconds
    a = js.account(3, tick, busy_seconds=tick / 7)
    b = ts.account(3, tick, busy_seconds=tick / 7)
    for f in REPORT_FIELDS:
        assert getattr(b, f) == getattr(a, f), f
    assert telastic.cycles_per_batch(tbic.BICConfig(**cfg)) == \
        jelastic.cycles_per_batch(__import__(
            "repro.core.bic", fromlist=["BICConfig"]).BICConfig(**cfg))


@pytest.mark.parametrize("seed", range(4))
def test_schedules_equal(seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.1, 3.0, int(rng.integers(1, 60))).tolist()
    speeds = rng.uniform(0.2, 2.0, int(rng.integers(1, 9))).tolist()
    assert telastic.lpt_schedule(costs, speeds) == \
        jelastic.lpt_schedule(costs, speeds)
    assert telastic.static_schedule(costs, speeds) == \
        jelastic.static_schedule(costs, speeds)
    assert telastic.lpt_schedule([], [1.0]) == (0.0, [])


# ---------------------------------------------------------------- ledger
def _ledger_script(energy, sched):
    led = energy.EnergyLedger(sched)
    led.charge("busy", 2.0)
    led.charge("awake_idle", 1.0)
    led.charge("standby", 10.0)
    led.charge("busy", -1.0)                    # ignored, not negative
    pjs = led.attribute([101, 102, 103, 104])
    led.charge("busy", 0.5)                     # new unattributed energy
    rep = sched.run([4, 0, 2], 0.01)
    led.charge_report(rep)
    led.note_batch()
    more = led.attribute([105])
    led.attribute_bits(1 << 20)
    return led, pjs + more


def test_energy_ledger_equal_and_reconciles():
    jl, jp = _ledger_script(jenergy, jelastic.ElasticScheduler(3))
    tl, tp = _ledger_script(tenergy, telastic.ElasticScheduler(3))
    assert tp == jp
    assert tl.per_query_pj() == jl.per_query_pj()
    for f in REPORT_FIELDS:
        assert getattr(tl.report, f) == getattr(jl.report, f), f
    tsnap = tl.snapshot(num_records=4096, num_keys=256)
    assert tsnap == jl.snapshot(num_records=4096, num_keys=256)
    rec = tl.reconcile()
    assert rec == jl.reconcile()
    # attributed + unattributed = total
    assert rec["ok"]
    assert math.isclose(rec["attributed_plus_unattributed"],
                        rec["total_joules"], rel_tol=1e-9)
    assert tsnap["indexed_bits"] == 1 << 20


# ------------------------------------------------------- tracer + metrics
def _metric_ops(metrics):
    reg = metrics.Registry()
    c = reg.counter("hits_total", "h")
    c.inc()
    c.add(4)
    reg.gauge("depth").set(2.5)
    h = reg.histogram("lat_s", (0.001, 0.01, 0.1))
    for v in (0.0005, 0.02, 0.2, 0.009):
        h.observe(v)
    r = reg.reservoir("pj", capacity=8, seed=3)
    for v in range(40):
        r.observe(float(v))
    child = metrics.Registry()
    child.counter("segments").inc(7)
    reg.attach("store", child)
    return reg


def test_prometheus_text_equal():
    treg, jreg = _metric_ops(tmetrics), _metric_ops(jmetrics)
    assert texport.prometheus_text(treg) == jexport.prometheus_text(jreg)
    assert treg.snapshot() == jreg.snapshot()
    # one process-wide registry per package, same metric names
    assert tmetrics.GLOBAL is not jmetrics.GLOBAL
    names = {n for n, _ in tmetrics.GLOBAL.collect()}
    assert {"engine_waves_total", "engine_queries_total",
            "engine_bucket_dispatches_total", "engine_executor_builds_total",
            "engine_records_indexed_total", "wal_appends_total",
            "wal_bytes_total", "wal_rotations_total"} <= names


def test_tracer_spans_equal_under_fake_clock(tmp_path):
    def run(trace, export, path):
        t = [0.0]
        tracer = trace.Tracer(clock=lambda: t[0], capacity=16)
        with tracer.span("outer", k=1):
            t[0] += 1.0
            with tracer.span("inner"):
                t[0] += 0.5
        tracer.event("tick", n=3)
        export.write_jsonl(tracer.spans(), path)
        return [(s.name, s.t0, s.t1, s.attrs, s.parent_id != 0)
                for s in tracer.spans()], open(path).read()

    a = run(ttrace, texport, tmp_path / "t.jsonl")
    b = run(jtrace, jexport, tmp_path / "j.jsonl")
    assert a == b


# --------------------------------------------------------------- fault
def test_fault_plans_serialize_across_packages():
    for seed in (7, 99):
        tp, jp = TPlan.random(seed), JPlan.random(seed)
        assert tp.to_json() == jp.to_json()
        assert TPlan.from_json(jp.to_json()) == tp
        assert JPlan.from_json(tp.to_json()) == jp


def test_injector_fires_same_occurrences_in_both(tmp_path):
    """The same plan fires at the same occurrences in both packages, and
    each package's seam is its own: an injector installed in one never
    fires in the other."""
    spec = '{"specs": [{"site": "format.write", "kind": "enospc", ' \
           '"occurrence": 2}]}'

    def run(plan_cls, injector_cls, fmt, tag):
        inj = injector_cls(plan_cls.from_json(spec))
        with inj:
            for i in range(4):
                try:
                    fmt.write_bytes_atomic(str(tmp_path / f"{tag}{i}"),
                                           b"x" * 64)
                except OSError:
                    pass
        return [(e["site"], e["kind"], e["occurrence"]) for e in inj.events]

    want = [("format.write", "enospc", 2)]
    assert run(TPlan, TInjector, tfmt, "t") == want
    assert run(JPlan, JInjector, jfmt, "j") == want
    with TInjector(TPlan.from_json(spec)) as inj:
        assert jseam.HOOK is None and tseam.HOOK is not None
        for i in range(3):                # the reference's writes
            jfmt.write_bytes_atomic(str(tmp_path / f"x{i}"), b"y")
        assert not inj.events
    with JInjector(JPlan.from_json(spec)):
        assert tseam.HOOK is None
        for i in range(3):
            tfmt.write_bytes_atomic(str(tmp_path / f"z{i}"), b"y")


# --------------------------------------- engine.dispatch seam, wave spans
def _packed(rng, m=6, nw=3):
    return torch.from_numpy(rng.integers(0, 2 ** 32, (m, nw),
                                         dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("backend", ["ref", "bulk", "cuda"])
def test_dispatch_seam_aborts_wave_and_spans_record(backend):
    rng = np.random.default_rng(3)
    packed = _packed(rng)
    k = tplanner.key
    preds = [k(0) & ~k(1), k(2), k(3) | k(4)]
    plan = TPlan((TSpec("engine.dispatch", "dispatch_error"),))
    waves = tmetrics.GLOBAL.counter("engine_waves_total").value
    with TInjector(plan) as inj:
        with pytest.raises(TInjectedFault):
            tbatch.execute_many(packed, preds, num_records=90,
                                backend=backend)
        assert inj.fired("engine.dispatch")
    assert tmetrics.GLOBAL.counter("engine_waves_total").value == waves
    tracer = ttrace.Tracer()
    ttrace.install(tracer)
    try:
        disp = tmetrics.GLOBAL.counter("engine_bucket_dispatches_total")
        before = disp.value
        tbatch.execute_many(packed, preds, num_records=90, backend=backend)
    finally:
        ttrace.uninstall(tracer)
    spans = [s for s in tracer.spans() if s.name == "bucket.dispatch"]
    assert len(spans) == 3 == disp.value - before   # three bucket shapes
    assert {s.attrs["backend"] for s in spans} == {backend}
    assert sum(s.attrs["q"] for s in spans) == 3
    assert tmetrics.GLOBAL.counter("engine_waves_total").value == waves + 1
