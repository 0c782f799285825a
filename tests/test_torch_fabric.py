"""The port's shard fabric (``repro_torch.fabric``) against the JAX
package's (``repro.fabric``), on the CPU.

The reference's acceptance suite (``tests/test_fabric.py``) replayed
through both packages on the same seeded records, schema and queries:
the wire codec, the shard map, the loopback fabric's bit-identity to one
node (hash and block partitioning, pruned and provably-empty scatter),
exactly-once appends, error isolation, the cluster manifest (gid tables,
``sync_store``, ``rebalance``), close semantics, the shared duty cycle,
the energy roll-up, the future's surface and the data pipeline's
``select_global``.  Every answer is also compared across the packages
(integers: no tolerance).  The cross-package checks follow: ``encode``
gives identical bytes in both packages, a query tree either package
encodes decodes in the other, and a cluster root either package writes
loads in the other.  No test asserts a wall-clock time; every wait,
join and result carries a timeout.
"""
import importlib
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

from torch_witness import (torch_lock_witness,  # noqa: E402,F401
                           torch_witness_isolation)

M = 16
HALF = M // 2
T = 60.0          # every wait / join / result is bounded by this


def _pkg(root: str) -> types.SimpleNamespace:
    """One package's modules under one set of names."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, db=m("db"), expr=m("db.expr"), result=m("db.result"),
        session=m("db.session"), planner=m("engine.planner"),
        envelope=m("fabric.envelope"), transport=m("fabric.transport"),
        protocol=m("fabric.protocol"), shardmap=m("fabric.shardmap"),
        client=m("fabric.client"), cluster=m("fabric.cluster"),
        service=m("serve.service"), fmt=m("store.format"),
        kw={"device": "cpu"} if root == "repro_torch" else {})


J, P = _pkg("repro"), _pkg("repro_torch")
PKGS = (J, P)


# ----------------------------------------------------------------- fixtures
def _schema(pk):
    return pk.db.Schema([pk.db.Column.categorical("a", list(range(HALF))),
                         pk.db.Column.categorical("b",
                                                  list(range(HALF, M)))])


def _records(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, HALF, n, dtype=np.int32),
                     rng.integers(HALF, M, n, dtype=np.int32)], axis=1)


def _queries(pk):
    col, key = pk.db.col, pk.planner.key
    return [col("a") == 3,
            (col("a") == 1) & ~(col("b") == 9),
            (col("a") == 2) | (col("b") == 12),
            key(0), key(5) & ~key(11),
            col("b").isin([8, 9, 10]),
            ~(col("a") == 4)]


def _db(pk, **kw):
    return pk.db.BitmapDB(_schema(pk), backend="ref", **pk.kw, **kw)


def _single_node(pk, records):
    db = _db(pk)
    db.append_encoded(records)
    return db


def _mk_fabric(pk, sm, records, *, replicas: int = 1, **kw):
    """Pre-partitioned local fabric: one (or `replicas`) BitmapDB per
    shard holding its records, gid tables from the partition."""
    parts = {s: (recs, g) for s, recs, g in sm.partition(records)}
    stores, gids = [], []
    for s in range(sm.num_shards):
        recs, g = parts.get(
            s, (np.zeros((0, records.shape[1]), np.int32),
                np.zeros(0, np.int64)))
        group = []
        for _ in range(replicas):
            db = _db(pk)
            if recs.shape[0]:
                db.append_encoded(recs)
            group.append(db)
        stores.append(group if replicas > 1 else group[0])
        gids.append(g)
    kw.setdefault("max_delay_ms", 1.0)
    return pk.client.FabricClient.local(stores, sm, gids=gids, **kw)


def _u32(row) -> np.ndarray:
    """A packed row as uint32 words (the port's tensors carry the bits in
    int32)."""
    if isinstance(row, torch.Tensor):
        return row.contiguous().numpy().view(np.uint32).reshape(-1)
    return np.asarray(row, np.uint32).reshape(-1)


def _trim(row, n: int) -> np.ndarray:
    w = (n + 31) >> 5
    out = np.zeros(w, np.uint32)
    row = _u32(row)[:w]
    out[:row.shape[0]] = row
    return out


def _sm(pk, strategy: str, n: int = 0, shards: int = 3, seed: int = 5):
    if strategy == "hash":
        return pk.shardmap.ShardMap.hashed(_schema(pk), "a", shards,
                                           seed=seed)
    return pk.shardmap.ShardMap.blocked(shards, total_records=n)


# ------------------------------------------------------------------- codec
def _all_types_env(pk):
    arr = np.random.default_rng(7).integers(0, 1 << 30, (3, 5),
                                            dtype=np.int32)
    return pk.envelope.Envelope("query", msg_id=42, trace=(123, 456),
                                payload={
        "none": None, "t": True, "f": False, "i": -7,
        "big": 2**75 + 3, "fl": 1.5, "s": "héllo", "by": b"\x00\xff",
        "l": [1, [2, "x"]], "tu": (1, 2), "nested": {"k": [None, 0.25]},
        "arr": arr, "u64": np.uint64(2**63 + 1),
        "f32": np.asarray([0.5, -2.0], np.float32)}), arr


def test_envelope_roundtrip_all_types():
    for pk in PKGS:
        env, arr = _all_types_env(pk)
        out = pk.envelope.decode(pk.envelope.encode(env))
        assert out.kind == "query" and out.msg_id == 42
        assert out.trace == (123, 456)
        p = out.payload
        assert p["none"] is None and p["t"] is True and p["f"] is False
        assert p["i"] == -7 and p["big"] == 2**75 + 3 and p["fl"] == 1.5
        assert p["s"] == "héllo" and p["by"] == b"\x00\xff"
        assert p["l"] == [1, [2, "x"]] and p["tu"] == (1, 2)
        assert p["nested"] == {"k": [None, 0.25]}
        np.testing.assert_array_equal(p["arr"], arr)
        assert p["arr"].dtype == np.int32
        assert p["u64"] == 2**63 + 1
        np.testing.assert_array_equal(
            p["f32"], np.asarray([0.5, -2.0], np.float32))


def test_envelope_rejects_corruption_and_skew():
    for pk in PKGS:
        e = pk.envelope
        frame = bytearray(e.encode(e.Envelope("ping")))
        frame[-1] ^= 0x40                   # flip a body bit -> CRC
        with pytest.raises(e.WireError):
            e.decode(bytes(frame))
        frame = bytearray(e.encode(e.Envelope("ping")))
        frame[4] ^= 0x01                    # version byte
        with pytest.raises(e.WireError):
            e.decode(bytes(frame))
        with pytest.raises(e.WireError):
            e.decode(b"\x01\x02")           # shorter than the header
        with pytest.raises(TypeError):
            e.encode(e.Envelope("x", payload={"bad": object()}))
        with pytest.raises(TypeError):
            e.encode(e.Envelope("x", payload={1: "non-str dict key"}))


def _trees(pk):
    key, pl = pk.planner.key, pk.planner
    col = pk.db.col
    preds = [key(3), pl.Not(key(1)), pl.And((key(0), pl.Not(key(2)))),
             pl.Or((key(4), pl.And((key(5), key(6)))))]
    exprs = [col("a") == 3, (col("a") == 1) & ~(col("b") == 9),
             col("b").isin([8, 9]), (col("a") == 0) | (col("a") == 2),
             col("a").between(1, 3)]
    return preds + exprs


def test_query_wire_roundtrip_rebuilds_exact_objects():
    wires = []
    for pk in PKGS:
        e = pk.envelope
        for q in _trees(pk):
            back = e.query_from_wire(e.query_to_wire(q))
            assert back == q
            assert type(back) is type(q)
        with pytest.raises(TypeError):
            e.query_to_wire({"not": "a query"})
        with pytest.raises(e.WireError):
            e.query_from_wire(["bogus-tag", 1])
        wires.append([e.query_to_wire(q) for q in _trees(pk)])
    assert wires[0] == wires[1]


# ---------------------------------------------------------------- shard map
def test_shardmap_partition_covers_every_record():
    recs = _records(500, seed=3)
    placed = []
    for pk in PKGS:
        S = pk.shardmap.ShardMap
        for sm in (S.hashed(_schema(pk), "a", 3, seed=9),
                   S.blocked(3, total_records=500)):
            parts = sm.partition(recs, start_gid=0)
            seen = np.concatenate([g for _, _, g in parts])
            assert sorted(seen.tolist()) == list(range(500))
            for s, local, g in parts:
                np.testing.assert_array_equal(local, recs[g])
                assert np.all(sm.route(local, start_gid=0) == s) \
                    or sm.strategy == "block"
            placed.append([(s, g.tolist()) for s, _, g in parts])
        # hash routing is a pure function of the key word
        sm = S.hashed(_schema(pk), "a", 3, seed=9)
        r1 = sm.route(recs)
        np.testing.assert_array_equal(r1, sm.route(recs))
        for v in range(HALF):
            ix = np.flatnonzero(recs[:, 0] == v)
            assert len(set(r1[ix].tolist())) <= 1
    assert placed[:2] == placed[2:]          # the same shard per record


def test_shardmap_owner_pruning():
    owners = []
    for pk in PKGS:
        key, pl = pk.planner.key, pk.planner
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 4, seed=1)
        for v in range(HALF):
            assert sm.owners(key(v)) == frozenset((sm.shard_of_key(v),))
        assert sm.owners(key(HALF + 1)) is None
        assert sm.owners(pl.Not(key(0))) is None
        a, b = 0, 1
        sa, sb = sm.shard_of_key(a), sm.shard_of_key(b)
        assert sm.owners(pl.Or((key(a), key(b)))) == frozenset((sa, sb))
        assert sm.owners(pl.And((key(a), key(HALF + 2)))) \
            == frozenset((sa,))
        if sa != sb:                # contradiction on the sharded column
            assert sm.owners(pl.And((key(a), key(b)))) == frozenset()
        assert pk.shardmap.ShardMap.blocked(4, block_size=8).owners(
            key(0)) is None
        owners.append([sm.shard_of_key(v) for v in range(64)])
    assert owners[0] == owners[1]


def test_shardmap_json_roundtrip():
    texts = []
    for pk in PKGS:
        S = pk.shardmap.ShardMap
        for sm in (S.hashed(_schema(pk), "b", 5, seed=77),
                   S.blocked(2, block_size=64)):
            assert S.from_json(sm.to_json()) == sm
            texts.append(sm.to_json())
        with pytest.raises(ValueError):
            S(num_shards=0)
        with pytest.raises(ValueError):
            S(num_shards=2, strategy="block", block_size=0)
    assert texts[:2] == texts[2:]
    # each package loads the other's map
    assert P.shardmap.ShardMap.from_json(texts[0]).to_json() == texts[0]


# ------------------------------------------------- loopback fabric identity
@pytest.mark.parametrize("strategy", ["hash", "block"])
def test_fabric_bit_identical_to_single_node(strategy):
    recs = _records(700, seed=11)
    answers = []
    for pk in PKGS:
        single = _single_node(pk, recs)
        got = []
        with _mk_fabric(pk, _sm(pk, strategy, 700), recs) as fc:
            assert fc.num_records == 700
            futs = [fc.submit(q) for q in _queries(pk)]
            cfuts = [fc.submit(q, count_only=True) for q in _queries(pk)]
            for q, fut, cfut in zip(_queries(pk), futs, cfuts):
                want = single.query(q)
                row, count = fut.result(timeout=T)
                assert count == want.count == cfut.result(timeout=T)[1]
                np.testing.assert_array_equal(
                    _trim(row, 700), _trim(want.rows, 700))
                np.testing.assert_array_equal(fut.ids, want.ids)
                assert cfut.result()[0] is None
                assert row.dtype == np.uint32
                got.append((_trim(row, 700).tolist(), count))
        answers.append(got)
    assert answers[0] == answers[1]


def test_fabric_pruned_scatter_touches_only_owner_shard():
    recs = _records(300, seed=2)
    served_by = []
    for pk in PKGS:
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 4, seed=3)
        with _mk_fabric(pk, sm, recs) as fc:
            v = 3
            owner = sm.shard_of_key(v)
            want = _single_node(pk, recs).query(pk.db.col("a") == v)
            fut = fc.submit(pk.db.col("a") == v)
            assert fut.count == want.count
            served = [s["served"] for s in fc.metrics()["shards"]]
            for s in range(4):
                assert served[s] == (1 if s == owner else 0)
            served_by.append((served, fut.count))
    assert served_by[0] == served_by[1]


def test_fabric_provably_empty_resolves_without_scatter():
    recs = _records(200, seed=4)
    for pk in PKGS:
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 4, seed=6)
        key = pk.planner.key
        a, b = 1, 2
        if sm.shard_of_key(a) == sm.shard_of_key(b):
            b = next(v for v in range(HALF)
                     if sm.shard_of_key(v) != sm.shard_of_key(a))
        with _mk_fabric(pk, sm, recs) as fc:
            fut = fc.submit(pk.planner.And((key(a), key(b))))
            row, count = fut.result(timeout=T)
            assert count == 0 and not row.any()
            assert fut.ids.size == 0
            assert all(s["served"] == 0 for s in fc.metrics()["shards"])


def test_fabric_append_routes_and_stays_identical():
    answers = []
    for pk in PKGS:
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 3, seed=8)
        stores = [_db(pk) for _ in range(3)]
        single = _db(pk)
        got = []
        with pk.client.FabricClient.local(stores, sm,
                                          max_delay_ms=1.0) as fc:
            total = 0
            for i in range(4):
                batch = _records(150 + 31 * i, seed=20 + i)
                total += batch.shape[0]
                assert fc.append_encoded(batch) == total
                single.append_encoded(batch)
            assert fc.num_records == total
            assert sum(p["num_records"] for p in fc.info()) == total
            for q in _queries(pk):
                want = single.query(q)
                row, count = fc.submit(q).result(timeout=T)
                assert count == want.count
                np.testing.assert_array_equal(
                    _trim(row, total), _trim(want.rows, total))
                got.append((_trim(row, total).tolist(), count))
            allg = np.concatenate([fc.gids(s) for s in range(3)])
            assert sorted(allg.tolist()) == list(range(total))
            got.append([fc.gids(s).tolist() for s in range(3)])
        answers.append(got)
    assert answers[0] == answers[1]


def test_fabric_append_rows_through_schema():
    for pk in PKGS:
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 2, seed=1)
        with pk.client.FabricClient.local([_db(pk) for _ in range(2)], sm,
                                          max_delay_ms=1.0) as fc:
            enc = _records(64, seed=5)
            fc.append({"a": enc[:, 0].tolist(), "b": enc[:, 1].tolist()})
            assert fc.num_records == 64
            assert fc.submit(pk.db.col("a") == 2).count \
                == int((enc[:, 0] == 2).sum())


# ------------------------------------------------------------- error paths
def test_wave_error_isolation_per_query():
    recs = _records(100, seed=9)
    counts = []
    for pk in PKGS:
        col, key = pk.db.col, pk.planner.key
        sm = pk.shardmap.ShardMap.blocked(2, total_records=100)
        with _mk_fabric(pk, sm, recs) as fc:
            good = fc.submit(col("a") == 1)
            bad = fc.submit(key(10_000))    # fails shard-side
            good2 = fc.submit(col("b") == 9)
            err = bad.exception(timeout=T)
            assert isinstance(err, pk.client.FabricError)
            assert "ValueError" in str(err)
            want = _single_node(pk, recs)
            assert good.count == want.query(col("a") == 1).count
            assert good2.count == want.query(col("b") == 9).count
            # an expression the schema cannot lower fails AT THE CLIENT
            with pytest.raises(KeyError):
                fc.submit(pk.expr.Eq("nope", 1))
            counts.append((good.count, good2.count))
    assert counts[0] == counts[1]


def _host(pk, db, shard_id=0):
    svc = pk.service.BitmapService(db, pk.service.ServiceConfig(
        max_delay_ms=1.0, maintenance=False))
    return pk.protocol.ServiceHost(svc, shard_id=shard_id)


def test_host_replies_error_envelope_on_garbage():
    for pk in PKGS:
        Env = pk.envelope.Envelope
        host = _host(pk, _single_node(pk, _records(32)), shard_id=7)
        t = pk.transport.LoopbackTransport(host, name="t")
        try:
            assert t.request(Env("ping"), timeout=T).payload[
                "shard_id"] == 7
            r = t.request(Env("definitely-not-a-kind"), timeout=T)
            assert r.kind == "error"
            r = t.request(Env("query", payload={
                "queries": [["bogus-tag", 1]], "count_only": False}),
                timeout=T)
            assert r.kind == "error" and "bogus" in r.payload["error"]
        finally:
            t.close()
            host.close()


def test_append_stream_gap_is_refused():
    replies = []
    for pk in PKGS:
        Env = pk.envelope.Envelope
        host = _host(pk, _db(pk))
        t = pk.transport.LoopbackTransport(host)
        try:
            recs = _records(8)
            ok = t.request(Env("append", payload={
                "stream": "s", "seq": 1, "records": recs}), timeout=T)
            assert ok.kind == "appended" and not ok.payload["duplicate"]
            dup = t.request(Env("append", payload={
                "stream": "s", "seq": 1, "records": recs}), timeout=T)
            assert dup.payload["duplicate"] \
                and dup.payload["num_records"] == 8
            gap = t.request(Env("append", payload={
                "stream": "s", "seq": 3, "records": recs}), timeout=T)
            assert gap.kind == "error" \
                and gap.payload["type"] == "GapError"
            replies.append([(r.kind, r.payload) for r in (ok, dup, gap)])
        finally:
            t.close()
            host.close()
    assert replies[0] == replies[1]


# -------------------------------------------------------- cluster manifest
def test_cluster_manifest_swap_and_gids(tmp_path):
    for pk in PKGS:
        cl = pk.cluster
        root = str(tmp_path / pk.root / "cluster")
        assert cl.load(root) is None
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 2, seed=4)
        gids0 = np.arange(0, 10, 2, dtype=np.int64)
        name = cl.save_gids(root, 0, 1, gids0)
        m = cl.ClusterManifest(
            version=1, shardmap=sm,
            shards=(cl.ShardEntry(0, ("storeA",), num_records=5,
                                  gids_file=name),
                    cl.ShardEntry(1, ("storeB", "storeC"))))
        cl.commit(root, m)
        back = cl.load(root)
        assert back == m and back.num_records == 5
        np.testing.assert_array_equal(cl.load_gids(root, back.shard(0)),
                                      gids0)
        assert cl.load_gids(root, back.shard(1)).size == 0
        m2 = m.with_shard(cl.ShardEntry(1, ("storeB",), num_records=3))
        assert m2.version == 2
        cl.commit(root, m2)
        assert cl.load(root) == m2
        assert cl.load(root).shard(0) == m.shard(0)
        with pytest.raises(KeyError):
            m2.shard(9)
    # the two roots hold the same files, byte for byte
    for name in ("CURRENT", "CLUSTER-00000001.json", "CLUSTER-00000002.json",
                 "gids-0000-00000001.arr"):
        assert ((tmp_path / "repro" / "cluster" / name).read_bytes()
                == (tmp_path / "repro_torch" / "cluster" / name)
                .read_bytes())


def test_cluster_manifest_validate_rejects_bad_membership():
    for pk in PKGS:
        cl = pk.cluster
        sm = pk.shardmap.ShardMap.blocked(2, block_size=4)
        with pytest.raises(pk.fmt.CorruptFileError):
            cl.ClusterManifest(version=1, shardmap=sm, shards=(
                cl.ShardEntry(0, ("x",)),)).validate()
        with pytest.raises(pk.fmt.CorruptFileError):
            cl.ClusterManifest(version=1, shardmap=sm, shards=(
                cl.ShardEntry(0, ("x",)),
                cl.ShardEntry(1, ()))).validate()


def _durable_store(pk, root: str, seed: int) -> int:
    """A shard store with committed segments on disk; returns its record
    count."""
    db = _db(pk, path=root, spill_records=64)
    n = 0
    for i in range(3):
        db.append_encoded(_records(64, seed=seed + i))
        n += 64
    db.store.close()
    return n


def test_sync_store_is_idempotent_segment_handoff(tmp_path):
    answers = []
    for pk in PKGS:
        src = str(tmp_path / pk.root / "src")
        dst = str(tmp_path / pk.root / "dst")
        n = _durable_store(pk, src, seed=31)
        assert pk.cluster.sync_store(src, dst) > 0
        assert pk.cluster.sync_store(src, dst) == 0     # idempotent
        a = pk.session.open_db(src, **pk.kw)
        b = pk.session.open_db(dst, **pk.kw)
        got = []
        try:
            assert a.num_records == b.num_records == n
            for q in _queries(pk):
                ra, rb = a.query(q), b.query(q)
                assert ra.count == rb.count
                np.testing.assert_array_equal(_trim(ra.rows, n),
                                              _trim(rb.rows, n))
                got.append((_trim(rb.rows, n).tolist(), rb.count))
        finally:
            a.store.close()
            b.store.close()
        answers.append(got)
    assert answers[0] == answers[1]


def test_rebalance_commits_one_manifest_version(tmp_path):
    for pk in PKGS:
        cl = pk.cluster
        base = tmp_path / pk.root
        root, srcA, srcB, new = (str(base / d)
                                 for d in ("cluster", "a", "b", "new"))
        _durable_store(pk, srcA, seed=41)
        _durable_store(pk, srcB, seed=43)
        sm = pk.shardmap.ShardMap.blocked(2, block_size=192)
        m = cl.ClusterManifest(version=1, shardmap=sm, shards=(
            cl.ShardEntry(0, (srcA,)), cl.ShardEntry(1, (srcB,))))
        cl.commit(root, m)
        m2 = cl.rebalance(root, m, 1, new)
        assert m2.version == 2
        assert m2.shard(1).replicas == (srcB, new)
        assert cl.load(root) == m2
        m3 = cl.rebalance(root, m2, 1, new, drop=srcB)
        assert m3.shard(1).replicas == (new,)
        m4 = cl.rebalance(root, m3, 1, new)
        assert m4.shard(1).replicas == (new,)


# ---------------------------------------------------------- close semantics
def test_client_close_idempotent_and_reentrant():
    recs = _records(64, seed=1)
    for pk in PKGS:
        key = pk.planner.key
        fc = _mk_fabric(pk, pk.shardmap.ShardMap.blocked(
            2, total_records=64), recs)
        assert fc.submit(key(0)).wait(T)
        fc.close()
        fc.close()                                  # no-op, no raise
        with pytest.raises(pk.service.ServiceClosed):
            fc.submit(key(0))


def test_client_close_concurrent_with_submit_storm():
    recs = _records(256, seed=12)
    for pk in PKGS:
        rng = np.random.default_rng(12)
        key = pk.planner.key
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 2, seed=2)
        fc = _mk_fabric(pk, sm, recs)
        futs = []
        flock = threading.Lock()
        stop = threading.Event()

        def submitter():
            while not stop.is_set():
                with flock:
                    k = int(rng.integers(0, M))
                try:
                    f = fc.submit(key(k))
                except pk.service.ServiceClosed:
                    return
                with flock:
                    futs.append(f)

        subs = [threading.Thread(target=submitter) for _ in range(4)]
        for s in subs:
            s.start()
        closers = [threading.Thread(target=fc.close) for _ in range(3)]
        for c in closers:
            c.start()
        stop.set()
        for t in closers + subs:
            t.join(timeout=T)
            assert not t.is_alive()
        for f in futs:
            assert f.wait(timeout=T)
            if f.exception() is not None:
                assert isinstance(f.exception(), (pk.service.ServiceClosed,
                                                  pk.client.FabricError))


def test_service_close_idempotent_and_concurrent():
    for pk in PKGS:
        key = pk.planner.key
        svc = pk.service.BitmapService(
            _single_node(pk, _records(128, seed=3)),
            pk.service.ServiceConfig(max_delay_ms=1.0, maintenance=False))
        futs = [svc.submit(key(i % M)) for i in range(32)]
        errs = []

        def closer():
            try:
                svc.close(timeout=T)
            except Exception as e:          # noqa: BLE001 — fail the test
                errs.append(e)

        cs = [threading.Thread(target=closer) for _ in range(4)]
        for c in cs:
            c.start()
        for c in cs:
            c.join(timeout=T)
            assert not c.is_alive()
        assert not errs
        for f in futs:
            assert f.wait(timeout=T)
        svc.close()                                 # still a no-op


# -------------------------------------------------------- shared duty cycle
def _runtime(pk):
    """(runtime, keys, ticks) of one package over the same records."""
    rng = np.random.default_rng(16)
    keys = rng.integers(0, 256, (8,), dtype=np.int32)
    ticks = [rng.integers(0, 256, (2, 16, 32), dtype=np.int32), None,
             rng.integers(0, 256, (1, 16, 32), dtype=np.int32)]
    if pk is J:
        import jax
        import jax.numpy as jnp
        from repro.engine.runtime import MulticoreRuntime
        mesh = jax.make_mesh((1,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
        conv = jnp.asarray
        rt = MulticoreRuntime(mesh, backend="ref")
    else:
        from repro_torch.engine.runtime import MulticoreRuntime
        conv = torch.from_numpy
        rt = MulticoreRuntime(["cpu"], backend="ref")
    return rt, conv(keys), [None if t is None else conv(t) for t in ticks]


def test_attach_runtime_shares_one_ledger_and_duty_cycle():
    for pk in PKGS:
        rt, keys, ticks = _runtime(pk)
        own_ledger = rt.ledger
        svc = pk.service.BitmapService(
            _single_node(pk, _records(128, seed=6)),
            pk.service.ServiceConfig(max_delay_ms=1.0, maintenance=False,
                                     idle_after_ms=10_000.0))
        try:
            with pytest.raises(RuntimeError):
                svc.run_tick(None, keys, 0.01)
            assert svc.attach_runtime(rt) is svc
            assert rt.ledger is svc._ledger
            assert rt.ledger is not own_ledger
            before = svc._ledger.snapshot()["total_joules"]
            for t in ticks:
                assert svc.run_tick(t, keys, tick_seconds=0.01) is not None
            assert svc._ledger.snapshot()["total_joules"] > before
            assert svc._state == "standby"
            m = svc.metrics()
            assert m.wakes >= 1 and m.standby_entries >= 1
            fut = svc.submit(pk.planner.key(0))
            assert fut.wait(T) and fut.result()[1] >= 0
        finally:
            svc.close()


def test_fabric_metrics_energy_rollup_sums_shards():
    recs = _records(200, seed=14)
    for pk in PKGS:
        sm = pk.shardmap.ShardMap.blocked(3, total_records=200)
        with _mk_fabric(pk, sm, recs) as fc:
            for q in _queries(pk):
                fc.submit(q)
            assert fc.drain(timeout=T)
            m = fc.metrics()
            assert m["served"] == len(_queries(pk))
            assert m["num_shards"] == 3 and len(m["shards"]) == 3
            per = m["energy"]["per_shard"]
            assert len(per) == 3
            total = sum(e.get("total_joules", 0.0) for e in per)
            assert m["energy"]["total_joules"] == pytest.approx(total)
            assert m["energy"]["total_joules"] > 0
            h = fc.health()
            assert not h["degraded"] and len(h["shards"]) == 3
            assert fc.drain_shards(timeout_s=T)
            stats = fc.transport_stats()
            assert [len(g) for g in stats] == [1, 1, 1]
            assert all(t["pending"] == 0 for g in stats for t in g)
            if pk is P:
                # the port's hosts report their process's waves and
                # kernel launches over the wire
                for rep in (m["shards"], h["shards"]):
                    proc = rep[0]["process"]
                    assert proc["waves_by_backend"].get("ref", 0) >= 1
                    assert "bulk_program" in proc["launches"]


def test_fabric_future_surface_matches_query_future():
    recs = _records(96, seed=15)
    for pk in PKGS:
        col = pk.db.col
        sm = pk.shardmap.ShardMap.blocked(2, total_records=96)
        single = _single_node(pk, recs)
        with _mk_fabric(pk, sm, recs) as fc:
            fut = fc.submit(col("a") == 2)
            row, count = fut.result(timeout=T)
            want = single.query(col("a") == 2)
            assert fut.done() and fut.exception() is None
            assert count == want.count == fut.count
            np.testing.assert_array_equal(fut.ids, want.ids)
            np.testing.assert_array_equal(
                pk.result.unpack_ids(_trim(fut.rows, 96), 96), want.ids)
            assert "done" in repr(fut)


# ------------------------------------------------------- data-plane routing
def test_pipeline_select_global_matches_per_shard():
    """The training pipeline's fabric plane in both packages: one
    scatter/merge over all corpus shards returns the per-shard ``select``
    loop's documents with gids offset by ``shard * docs_per_shard``, and
    the two packages return the same ids."""
    got = []
    for pk in PKGS:
        pipe = importlib.import_module(f"{pk.root}.data.pipeline")
        cfg = pipe.DataConfig(vocab_size=64, seq_len=8, docs_per_shard=128,
                              num_shards=3, num_attributes=32, seed=5)
        ds = pipe.BitmapIndexedDataset(cfg, **pk.kw)
        col, key = pk.db.col, pk.planner.key
        try:
            wheres = [col("domain").isin([0, 1]) & ~(col("quality") == 3),
                      col("lang") == 2, key(5) | key(20)]
            ids = ds.select_global(wheres)
            for q, i in zip(wheres, ids):
                want = np.concatenate(
                    [s * cfg.docs_per_shard + ds.select(s, where=q)
                     for s in range(cfg.num_shards)]).astype(np.int64)
                np.testing.assert_array_equal(i, want)
            assert ds.fabric() is ds.fabric()      # one client, cached
        finally:
            ds.close()
        assert ds._fabric is None                  # close() tears it down
        got.append([i.tolist() for i in ids])
    assert got[0] == got[1]


# ---------------------------------------------------- across the packages
def test_encode_gives_identical_bytes_across_packages():
    """Every payload type of the round-trip test, the query kinds the
    protocol sends and every reply kind: the same bytes from both
    packages, and each package decodes the other's frame."""
    (jenv, _), (tenv, _) = _all_types_env(J), _all_types_env(P)
    pairs = [(jenv, tenv)]
    for pk_pairs in zip(*[[
            pk.envelope.Envelope("query", msg_id=3, trace=(1, 2), payload={
                "queries": [pk.envelope.query_to_wire(q)
                            for q in _queries(pk)], "count_only": False}),
            pk.envelope.Envelope("append", payload={
                "stream": "c1", "seq": 4, "records": _records(33)}),
            pk.envelope.Envelope("ping").reply(
                "result", rows=np.arange(6, dtype=np.uint32).reshape(2, 3),
                counts=np.asarray([3, 0], np.int64), num_records=70,
                errors=[[1, "ValueError: x"]]),
            pk.envelope.Envelope("ping"), pk.envelope.Envelope("shutdown")]
            for pk in PKGS]):
        pairs.append(pk_pairs)
    for jenv, tenv in pairs:
        jb, tb = J.envelope.encode(jenv), P.envelope.encode(tenv)
        assert jb == tb
        assert P.envelope.encode(P.envelope.decode(jb)) == jb
        assert J.envelope.encode(J.envelope.decode(tb)) == tb
    assert P.envelope.WIRE_VERSION == J.envelope.WIRE_VERSION
    assert P.envelope.header_size() == J.envelope.header_size()


def test_query_tree_crosses_packages():
    """A query tree either package encodes decodes in the other to the
    same tree, as that package's own classes."""
    for src, dst in ((J, P), (P, J)):
        for sq, dq in zip(_trees(src), _trees(dst)):
            wire = src.envelope.decode(src.envelope.encode(
                src.envelope.Envelope("query", payload={
                    "q": src.envelope.query_to_wire(sq)}))).payload["q"]
            frame = dst.envelope.encode(dst.envelope.Envelope(
                "query", payload={"q": wire}))
            back = dst.envelope.query_from_wire(
                dst.envelope.decode(frame).payload["q"])
            assert back == dq and type(back) is type(dq)


def test_cluster_root_loads_in_either_package(tmp_path):
    for src, dst in ((J, P), (P, J)):
        root = str(tmp_path / f"{src.root}-root")
        sm = src.shardmap.ShardMap.hashed(_schema(src), "b", 2, seed=9)
        gids = np.arange(3, 30, 3, dtype=np.int64)
        name = src.cluster.save_gids(root, 1, 1, gids)
        m = src.cluster.ClusterManifest(version=1, shardmap=sm, shards=(
            src.cluster.ShardEntry(0, ("a",)),
            src.cluster.ShardEntry(1, ("b", "c"), num_records=9,
                                   gids_file=name)))
        src.cluster.commit(root, m)
        back = dst.cluster.load(root)
        assert back.to_json() == m.to_json()
        np.testing.assert_array_equal(
            dst.cluster.load_gids(root, back.shard(1)), gids)
        # a shard store the source package wrote syncs in the other
        store = str(tmp_path / f"{src.root}-store")
        n = _durable_store(src, store, seed=50)
        assert dst.cluster.sync_store(store, store + "-copy") > 0
        db = dst.session.open_db(store + "-copy", **dst.kw)
        try:
            assert db.num_records == n
        finally:
            db.store.close()


def test_port_wire_refuses_torch_tensors():
    """A tensor never crosses the wire by accident: the caller converts
    it first."""
    e = P.envelope
    with pytest.raises(e.WireError, match="torch tensor"):
        e.encode(e.Envelope("append", payload={
            "records": torch.zeros((2, 2), dtype=torch.int32)}))
    ok = e.encode(e.Envelope("append", payload={
        "records": torch.zeros((2, 2), dtype=torch.int32).numpy()}))
    assert e.decode(ok).payload["records"].dtype == np.int32


def test_host_result_rows_one_copy_equal_per_row():
    """The host's one-copy row path (stack the live rows, copy once,
    reinterpret as uint32) equals the rows taken one future at a time,
    with a failed query's slot a zero row and its error reported."""
    db = _single_node(P, _records(300, seed=19))
    svc = P.service.BitmapService(db, P.service.ServiceConfig(
        max_delay_ms=1.0, maintenance=False))
    try:
        qs = _queries(P) + [P.planner.key(10_000)]
        futs = [svc.submit(q) for q in qs]
        assert svc.drain(timeout=T)
        out = P.protocol._result_payload(futs, count_only=False)
        nw = out["rows"].shape[1]
        for qi, f in enumerate(futs[:-1]):
            row, count = f.result(timeout=T)
            np.testing.assert_array_equal(out["rows"][qi],
                                          _u32(row)[:nw])
            assert out["counts"][qi] == int(count)
        assert not out["rows"][-1].any() and out["counts"][-1] == 0
        assert [qi for qi, _ in out["errors"]] == [len(qs) - 1]
        assert out["rows"].dtype == np.uint32 and out["num_records"] == 300
        counts_only = P.protocol._result_payload(futs, count_only=True)
        assert counts_only["rows"] is None
        np.testing.assert_array_equal(counts_only["counts"], out["counts"])
    finally:
        svc.close(timeout=T)
