"""The port's multi-core runtime (``MulticoreRuntime``,
``multicore_create_index``) and the streaming indexer's durability hooks
against the JAX package, on the CPU.

The reference shards over a one-device JAX mesh; the port runs over a list
of devices (here ``["cpu"]``, or several CPU entries to drive the
round-robin assignment).  Packed words and query rows must be
bit-identical; uncalibrated energy reports must be equal field by field
(the same model arithmetic in the same order).  Calibrated reports depend
on the measured wall clock, so only their direction is checked.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

from torch_witness import (torch_lock_witness,  # noqa: E402,F401
                           torch_witness_isolation)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402,F401  (mesh API shims)
from repro.core.bic import BICConfig as JConfig  # noqa: E402
from repro.engine import backends as jbackends  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro.engine.runtime import MulticoreRuntime as JRuntime  # noqa: E402
from repro.engine.runtime import StreamingIndexer as JSI  # noqa: E402
from repro.store import SegmentStore as JStore  # noqa: E402
from repro_torch.core import elastic as telastic  # noqa: E402
from repro_torch.core.bic import BICConfig as TConfig  # noqa: E402
from repro_torch.engine import backends as tbackends  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine import runtime as truntime  # noqa: E402
from repro_torch.engine.runtime import MulticoreRuntime as TRuntime  # noqa: E402
from repro_torch.engine.runtime import StreamingIndexer as TSI  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.store import SegmentStore as TStore  # noqa: E402

REPORT_FIELDS = ("active_joules", "standby_joules", "busy_core_seconds",
                 "idle_core_seconds", "batches")


def _mesh():
    return jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _ticks(seed, sizes, n=16, w=32):
    rng = np.random.default_rng(seed)
    return [None if b == 0 else
            rng.integers(0, 256, (b, n, w), dtype=np.int32) for b in sizes]


def _keys(seed=0, m=8):
    return np.random.default_rng(seed).integers(0, 256, (m,), dtype=np.int32)


def _jt(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("sizes,n,cfg", [
    ((4, 0, 2), 16, {}),
    ((2, 0, 1), 100, {"num_keys": 8, "num_records": 100}),   # N % 32 != 0
    ((1, 3, 0, 0, 5), 40, {}),
])
def test_index_stream_matches_reference(sizes, n, cfg):
    keys = _keys()
    ticks = _ticks(1, sizes, n=n)
    jrt = JRuntime(_mesh(), cfg=JConfig(**cfg), backend="ref")
    trt = TRuntime(["cpu"], cfg=TConfig(**cfg), backend="ref")
    jout, jrep = jrt.index_stream([_jt(t) for t in ticks], jnp.asarray(keys),
                                  0.01)
    tout, trep = trt.index_stream(ticks, keys, 0.01)
    assert len(tout) == len(jout) == sum(1 for b in sizes if b)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(u32(t), np.asarray(j))
    for f in REPORT_FIELDS:
        assert getattr(trep, f) == getattr(jrep, f), f
        assert getattr(trt.report, f) == getattr(jrt.report, f), f
    assert trep.standby_joules > 0 and trep.batches == sum(sizes)
    assert trt.ledger.reconcile() == jrt.ledger.reconcile()
    assert trt.ledger.snapshot() == jrt.ledger.snapshot()


def test_run_tick_queries_match_reference():
    keys = _keys(2)
    rec = _ticks(3, (3,))[0]
    jq = [jplanner.key(0), jplanner.key(1) & ~jplanner.key(2),
          (jplanner.key(3) | jplanner.key(4)) & jplanner.key(5),
          jplanner.And(tuple(jplanner.key(i % 8) | jplanner.key((i + 3) % 8)
                             for i in range(8)))]
    tk = tplanner.key
    tq = [tk(0), tk(1) & ~tk(2), (tk(3) | tk(4)) & tk(5),
          tplanner.And(tuple(tk(i % 8) | tk((i + 3) % 8) for i in range(8)))]
    jres = JRuntime(_mesh(), backend="ref").run_tick(
        jnp.asarray(rec), jnp.asarray(keys), 0.01, queries=jq)
    for be in ("ref", "bulk", "cuda"):
        trt = TRuntime(["cpu"], backend=be)
        tres = trt.run_tick(rec, keys, 0.01, queries=tq)
        np.testing.assert_array_equal(u32(tres.indexes),
                                      np.asarray(jres.indexes))
        np.testing.assert_array_equal(u32(tres.query_rows),
                                      np.asarray(jres.query_rows))
        np.testing.assert_array_equal(tres.query_counts.numpy(),
                                      np.asarray(jres.query_counts))
        assert tres.active_cores == jres.active_cores
        for f in REPORT_FIELDS:
            assert getattr(tres.report, f) == getattr(jres.report, f)
        assert tres.measured_seconds > 0 and tres.measured_mbps > 0
    # idle ticks and query-less ticks keep the contract
    assert trt.run_tick(None, keys, 0.01, queries=tq).query_rows is None
    plain = trt.run_tick(rec, keys, 0.01)
    assert plain.query_rows is None and plain.indexes is not None


@pytest.mark.parametrize("cores,batches", [(4, 6), (3, 7), (2, 1)])
def test_non_divisible_batch_counts_round_robin(cores, batches):
    """Batch counts that do not divide the device count: every block is
    built (round-robin over the devices) and the result is the reference's
    (here several CPU entries stand in for several cards)."""
    keys = _keys(4)
    rec = _ticks(5, (batches,))[0]
    want = np.asarray(jax.vmap(
        lambda r: jbackends.get_backend("ref").create_index(
            r, jnp.asarray(keys)))(jnp.asarray(rec)))
    got = truntime.multicore_create_index(rec, keys, ["cpu"] * cores,
                                          backend="ref")
    np.testing.assert_array_equal(u32(got), want)
    wrapped = telastic.multicore_create_index(rec, keys, ["cpu"] * cores,
                                              backend="cuda")
    assert torch.equal(wrapped, got)
    trt = TRuntime(["cpu"] * cores, backend="ref")
    assert trt.num_cores == cores
    res = trt.run_tick(rec, keys, 0.01)
    assert torch.equal(res.indexes, got)


def test_calibrated_energy_tracks_measured_dispatch():
    keys = _keys(6)
    rec = _ticks(7, (2,))[0]
    rt = TRuntime(["cpu"], backend="ref", calibrate_energy=True)
    paper_bs = rt.scheduler.batch_seconds
    res = rt.run_tick(rec, keys, 0.5)
    assert res.measured_seconds > 0 and res.measured_mbps > 0
    assert rt.measured_mbps == res.measured_mbps
    assert rt.scheduler.batch_seconds != paper_bs
    assert rt.report.active_joules > 0 and rt.report.batches == 2
    assert rt.ledger.reconcile()["ok"]
    rt2 = TRuntime(["cpu"], backend="ref")
    rt2.run_tick(rec, keys, 0.5)
    assert rt2.scheduler.batch_seconds == paper_bs
    shared = TRuntime(["cpu"], backend="ref").ledger
    rt2.bind_ledger(shared)
    rt2.run_tick(rec, keys, 0.5)
    assert shared.report.batches == 2 and shared.reconcile()["ok"]


def test_runtime_checkpoint_and_restart_match_reference(tmp_path):
    keys = _keys(8)
    ticks = _ticks(9, (3, 3, 3))
    out = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        if pkg == "jax":
            mk = lambda: JRuntime(_mesh(), backend="ref",  # noqa: E731
                                  store_dir=str(root), flush_records=20)
            k, ts = jnp.asarray(keys), [jnp.asarray(t) for t in ticks]
            words = lambda idx: np.asarray(idx.packed)     # noqa: E731
            Store = JStore
        else:
            mk = lambda: TRuntime(["cpu"], backend="ref",  # noqa: E731
                                  store_dir=str(root), flush_records=20)
            k, ts = keys, ticks
            words = lambda idx: idx.to_numpy()             # noqa: E731
            Store = TStore
        rt = mk()
        for t in ts:
            res = rt.run_tick(t, k, 0.01)
            assert res.active_cores == rt.scheduler.cores_needed(3, 0.01)
        live = words(rt.core_indexes(k)[0])
        rt2 = mk()                                   # crash + restart
        rec = rt2.core_indexes(k)[0]
        assert rec.num_records == 144
        recovered = words(rec)
        rt2.run_tick(ts[0], k, 0.01)
        rt2.checkpoint()
        st = Store(str(root / "core-0"))
        out[pkg] = (live, recovered, st.durable_records, st.replay_wal(),
                    [(s.start_record, s.num_records) for s in st.segments])
    (tl, tr, td, tw, ts_), (jl, jr, jd, jw, js) = out["torch"], out["jax"]
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tl, tr)
    assert td == jd == 192 and tw == jw == [] and ts_ == js
    want = np.asarray(jbackends.get_backend("ref").create_index(
        jnp.asarray(np.concatenate([t.reshape(-1, 32) for t in ticks])),
        jnp.asarray(keys)))
    np.testing.assert_array_equal(tl, want)


def test_run_tick_replay_is_idempotent(tmp_path):
    """Re-feeding the tick that was in flight at crash time appends only
    the blocks each core had not absorbed: the (tick, blocks) watermark
    survives restart — in the port exactly as in the reference."""
    keys = _keys(10)
    t0, t1 = _ticks(11, (3, 3))
    out = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        if pkg == "jax":
            mk = lambda: JRuntime(_mesh(), backend="ref",  # noqa: E731
                                  store_dir=root, flush_records=1000)
            k, a0, a1 = jnp.asarray(keys), jnp.asarray(t0), jnp.asarray(t1)
            be = jbackends.get_backend("ref")
        else:
            mk = lambda: TRuntime(["cpu"], backend="ref",  # noqa: E731
                                  store_dir=root, flush_records=1000)
            k, a0, a1 = keys, t0, t1
            be = tbackends.get_backend("ref")
        rt = mk()
        rt.run_tick(a0, k, 0.01, tick_id=0)
        si = rt.core_indexers(k)[0]
        blk = a1[0] if pkg == "jax" else torch.from_numpy(t1[0])
        si.append_indexed(a1[0], be.create_index(
            blk, k if pkg == "jax" else torch.from_numpy(keys)), tick=1)
        assert (si.last_tick, si.absorbed_blocks(1),
                si.absorbed_blocks(0), si.absorbed_blocks(2)) == (1, 1, -1, 0)
        rt2 = mk()
        rt2.run_tick(a1, k, 0.01, tick_id=1)
        rt2.run_tick(a1, k, 0.01, tick_id=1)     # full duplicate: no-op
        idx = rt2.core_indexes(k)[0]
        out[pkg] = (idx.num_records, np.asarray(idx.packed) if pkg == "jax"
                    else idx.to_numpy())
    assert out["torch"][0] == out["jax"][0] == 96
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    rt3 = TRuntime(["cpu"], backend="ref", store_dir=str(tmp_path / "torch"))
    assert rt3.core_indexes(keys)[0].num_records == 96
    with pytest.raises(ValueError, match="different key set"):
        rt3.run_tick(t0, keys + 1, 0.01)
    with pytest.raises(RuntimeError, match="store_dir"):
        TRuntime(["cpu"]).core_indexers(keys)


# ----------------------------------------------- streaming durability hooks
def test_two_phase_spill_hooks_match_reference(tmp_path):
    """The background-spill protocol: a hook that only enqueues, then
    prepare / commit (and prepare / abort) — the resulting stores hold the
    same segments and recover to the same words in both packages."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 32, (11,), dtype=np.int32)
    blocks = [rng.integers(0, 32, (n, 5), dtype=np.int32)
              for n in (30, 25, 17)]
    out = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        if pkg == "jax":
            si = JSI(jnp.asarray(keys), backend="ref")
            si.attach_store(JStore(root), flush_records=40)
            blk = [jnp.asarray(b) for b in blocks]
        else:
            si = TSI(keys, backend="ref", device="cpu")
            si.attach_store(TStore(root), flush_records=40)
            blk = blocks
        hits = []
        si.set_spill_hook(lambda: hits.append(1))
        si.append(blk[0])
        si.append(blk[1])                    # 55 >= 40: the hook fires
        assert hits == [1] and si.store.durable_records == 0
        assert si.pending_flush_records() == 55
        tok = si.prepare_spill()
        si.abort_spill(tok)                  # abandoned: gc fodder
        tok = si.prepare_spill()
        si.commit_spill(tok)
        assert si.pending_flush_records() == 0
        si.set_spill_hook(None)
        si.append(blk[2])                    # under the threshold: no spill
        si.spill()
        Store = JStore if pkg == "jax" else TStore
        st = Store(root)
        out[pkg] = ([(s.file, s.start_record, s.num_records)
                     for s in st.segments], st.load_packed()[0])
    assert out["torch"][0] == out["jax"][0]
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])


def test_records_indexed_counter_and_append_many():
    c = tmetrics.GLOBAL.counter("engine_records_indexed_total")
    before = c.value
    keys = _keys(13)
    rec = _ticks(14, (3,))[0]
    si = TSI(keys, backend="ref", device="cpu")
    si.append_many(rec)
    assert c.value - before == 48
    want = JSI(jnp.asarray(keys), backend="ref").append_many(
        jnp.asarray(rec))
    np.testing.assert_array_equal(si.index.to_numpy(),
                                  np.asarray(want.packed))
    with pytest.raises(RuntimeError, match="no store"):
        si.spill()


def test_wal_logs_host_records_and_restore_reindexes(tmp_path, monkeypatch):
    """The WAL logs the caller's host array (cast to int32 on the host):
    appending a host block never reads the card's copy back; restore
    re-indexes the logged blocks on the session's device."""
    keys = _keys(15)
    rec = np.random.default_rng(16).integers(0, 256, (50, 32),
                                             dtype=np.uint8)
    si = TSI(keys, backend="ref", device="cpu")
    si.attach_store(TStore(str(tmp_path)), flush_records=None)
    seen = []
    real = truntime._host_i32
    monkeypatch.setattr(truntime, "_host_i32",
                        lambda r: seen.append(type(r)) or real(r))
    si.append(rec)
    assert seen == [np.ndarray]
    back = TSI.restore(TStore(str(tmp_path)), keys, backend="ref",
                       device="cpu")
    np.testing.assert_array_equal(back.index.to_numpy(),
                                  si.index.to_numpy())
    assert os.path.exists(tmp_path / "KEYS.arr")
