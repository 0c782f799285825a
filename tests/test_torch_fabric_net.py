"""The port's network-facing fabric (``repro_torch.fabric``) against the
JAX package's, on the CPU.

The reference's suite (``tests/test_fabric_net.py``) replayed through
both packages: hedged reads (the seeded permutation under a fake clock,
loser cancellation, dead replicas), primary-only writes, replicas that
differ in layout but not content, framed sockets, trace propagation
across the RPC, and network chaos from one ``FaultPlan`` JSON with each
package under its own injector (no acknowledged write lost in either).
Across the packages: a ``repro`` ``FabricClient`` drives a
``repro_torch`` ``ServiceHost`` over a loopback socket, and the reverse,
with rows and counts bit-identical to one node.  One ``slow`` test
spawns two ``repro_torch`` shard workers on the CPU.  No test asserts a
wall-clock time.
"""
import itertools
import random
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

from torch_witness import (torch_lock_witness,  # noqa: E402,F401
                           torch_witness_isolation)

from test_torch_fabric import (J, M, P, PKGS, T, _db,  # noqa: E402
                               _records, _schema, _single_node, _trim)


def _queries(pk):
    col, key = pk.db.col, pk.planner.key
    return [col("a") == 3, (col("a") == 1) & ~(col("b") == 9),
            (col("a") == 2) | (col("b") == 12), key(0),
            col("b").isin([8, 9, 10])]


# --------------------------------------------------------- scripted replicas
class ScriptedReplica:
    """Transport stub for hedging tests: replies to anything after
    ``delay`` seconds (None = never replies), with ``pk``'s futures."""

    def __init__(self, pk, name: str, delay: float | None = 0.0):
        self.pk = pk
        self.name = name
        self.delay = delay
        self.requests = 0
        self._ids = itertools.count(1)

    def send(self, env):
        self.requests += 1
        fut = self.pk.transport.ReplyFuture(next(self._ids))
        if self.delay is None:
            return fut
        reply = env.reply("pong", shard_id=0, via=self.name)
        if self.delay == 0:
            fut._resolve(reply)
        else:
            threading.Timer(self.delay,
                            lambda: fut._resolve(reply)).start()
        return fut

    def stats(self) -> dict:
        return {"name": self.name, "kind": "scripted", "pending": 0,
                "late_replies": 0}

    def close(self) -> None:
        pass


class FakeClock:
    """Monotone clock advancing a fixed step per read — hedging decisions
    become a pure function of call order."""

    def __init__(self, step: float = 0.01):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _first_done_waiter(futs, timeout):
    return next((f for f in futs if f.done()), None)


def _hedge_client(pk, replicas, **kw):
    kw.setdefault("background", False)
    kw.setdefault("waiter", _first_done_waiter)
    return pk.client.FabricClient(
        [replicas], pk.shardmap.ShardMap.blocked(1, block_size=1), **kw)


# ---------------------------------------------------------------- hedging
def test_hedge_permutation_is_seeded_and_deterministic():
    def first_receivers(pk, seed: int, n: int = 20) -> list[str]:
        replicas = [ScriptedReplica(pk, f"r{i}") for i in range(3)]
        fc = _hedge_client(pk, replicas, hedge_seed=seed,
                           clock=FakeClock(), hedge_delay_ms=1e6)
        out = []
        for _ in range(n):
            before = [r.requests for r in replicas]
            fc._shard_request(0, pk.envelope.Envelope("ping"), timeout=T)
            got = [r.name for r, b in zip(replicas, before)
                   if r.requests > b]
            assert len(got) == 1        # instant win: no hedges fired
            out.append(got[0])
        fc.close()
        return out

    draws = {}
    for pk in PKGS:
        a = first_receivers(pk, seed=5)
        assert a == first_receivers(pk, seed=5)
        assert len(set(a)) > 1              # it IS a spread, not a pin
        assert a != first_receivers(pk, seed=6)
        draws[pk.root] = a
    assert draws["repro"] == draws["repro_torch"]


def test_hedge_launches_loser_cancelled_and_counted():
    for seed in range(1000):
        order = [0, 1]
        random.Random(seed * 1_000_003 + 1).shuffle(order)
        if order == [0, 1]:
            break
    for pk in PKGS:
        dead = ScriptedReplica(pk, "dead", delay=None)
        live = ScriptedReplica(pk, "live", delay=0.0)
        fc = _hedge_client(pk, [dead, live], hedge_seed=seed,
                           clock=FakeClock(step=0.01), hedge_delay_ms=10.0)
        reply = fc._shard_request(0, pk.envelope.Envelope("ping"),
                                  timeout=T)
        assert reply.payload["via"] == "live"
        assert dead.requests == 1 and live.requests == 1
        assert (fc._hedges_launched, fc._hedge_wins,
                fc._losers_cancelled) == (1, 1, 1)
        fc.close()


def test_hedge_all_replicas_dead_times_out_and_cancels():
    for pk in PKGS:
        dead = [ScriptedReplica(pk, "d0", delay=None),
                ScriptedReplica(pk, "d1", delay=None)]
        fc = _hedge_client(pk, dead, clock=FakeClock(step=0.05),
                           hedge_delay_ms=10.0, request_retries=0)
        with pytest.raises(pk.transport.ReplyTimeout):
            fc._shard_request(0, pk.envelope.Envelope("ping"), timeout=0.5)
        assert all(r.requests == 1 for r in dead)
        assert fc._losers_cancelled == 2
        fc.close()


def test_writes_go_to_primary_only_never_hedged():
    for pk in PKGS:
        dbA, dbB = _db(pk), _db(pk)
        sm = pk.shardmap.ShardMap.blocked(1, block_size=1 << 30)
        with pk.client.FabricClient.local([[dbA, dbB]], sm,
                                          max_delay_ms=1.0,
                                          hedge_delay_ms=0.0) as fc:
            fc.append_encoded(_records(50, seed=1))
            assert dbA.num_records == 50    # primary took the write
            assert dbB.num_records == 0     # replica untouched


def test_replicas_disagree_on_layout_but_not_content(tmp_path):
    """Two replicas hold identical records in different segment layouts
    (in memory vs spilled durable segments); racing hedged reads return
    bit-identical results whichever replica wins, in both packages."""
    recs = _records(400, seed=9)
    answers = []
    for pk in PKGS:
        single = _single_node(pk, recs)
        mem = _single_node(pk, recs)
        dur = _db(pk, path=str(tmp_path / pk.root), spill_records=64)
        for i in range(0, 400, 100):
            dur.append_encoded(recs[i:i + 100])
        assert dur.num_records == mem.num_records == 400
        sm = pk.shardmap.ShardMap.blocked(1, block_size=1 << 30)
        got = []
        with pk.client.FabricClient.local(
                [[mem, dur]], sm, max_delay_ms=1.0,
                gids=[np.arange(400, dtype=np.int64)], hedge_delay_ms=0.0,
                hedge_seed=3) as fc:
            for _ in range(3):
                for q in _queries(pk):
                    row, count = fc.submit(q).result(timeout=T)
                    want = single.query(q)
                    assert count == want.count
                    np.testing.assert_array_equal(_trim(row, 400),
                                                  _trim(want.rows, 400))
                    got.append((_trim(row, 400).tolist(), count))
            assert fc.metrics()["hedges_launched"] > 0
        answers.append(got)
    assert answers[0] == answers[1]


# ----------------------------------------------------------------- sockets
def _socket_shards(host_pk, recs, sm):
    """One ``host_pk`` ServiceHost + socket server per shard of ``sm``;
    returns (hosts, servers, gids)."""
    parts = {s: (r, g) for s, r, g in sm.partition(recs)}
    hosts, servers, gids = [], [], []
    for s in range(sm.num_shards):
        r, g = parts.get(s, (np.zeros((0, 2), np.int32),
                             np.zeros(0, np.int64)))
        db = _db(host_pk)
        if r.shape[0]:
            db.append_encoded(r)
        host = host_pk.protocol.ServiceHost(
            host_pk.service.BitmapService(db, host_pk.service.ServiceConfig(
                max_delay_ms=1.0, maintenance=False)), shard_id=s)
        hosts.append(host)
        servers.append(host_pk.transport.serve_socket(host))
        gids.append(g)
    return hosts, servers, gids


def _close_shards(hosts, servers):
    for srv in servers:
        srv.close()
    for h in hosts:
        h.close()


def _drive(client_pk, servers, sm, gids, single, n: int) -> list:
    """A ``client_pk`` FabricClient over the sockets: the queries checked
    against ``single``, then an append crossing the socket; returns the
    rows and counts."""
    got = []
    fc = client_pk.client.FabricClient.connect(
        [srv.address for srv in servers], sm, schema=_schema(client_pk),
        gids=gids, max_delay_ms=1.0)
    try:
        for q, sq in zip(_queries(client_pk), _queries(single.pk)):
            row, count = fc.submit(q).result(timeout=T)
            want = single.db.query(sq)
            assert count == want.count
            np.testing.assert_array_equal(_trim(row, n),
                                          _trim(want.rows, n))
            got.append((_trim(row, n).tolist(), count))
        more = _records(64, seed=14)
        single.db.append_encoded(more)
        assert fc.append_encoded(more) == n + 64
        assert sum(p["num_records"] for p in fc.info()) == n + 64
        q, sq = client_pk.db.col("a") == 2, single.pk.db.col("a") == 2
        count = fc.submit(q).count
        assert count == single.db.query(sq).count
        got.append(count)
    finally:
        fc.close()
    return got


class _Single:
    def __init__(self, pk, recs):
        self.pk, self.db = pk, _single_node(pk, recs)


def test_socket_transport_round_trip_and_fabric_identity():
    recs = _records(300, seed=13)
    answers = []
    for pk in PKGS:
        sm = pk.shardmap.ShardMap.hashed(_schema(pk), "a", 2, seed=7)
        hosts, servers, gids = _socket_shards(pk, recs, sm)
        try:
            t = pk.transport.SocketTransport(servers[0].address)
            assert t.request(pk.envelope.Envelope("ping"),
                             timeout=T).payload["shard_id"] == 0
            t.close()
            with pytest.raises(pk.transport.TransportClosed):
                t.send(pk.envelope.Envelope("ping"))
            answers.append(_drive(pk, servers, sm, gids, _Single(pk, recs),
                                  300))
        finally:
            _close_shards(hosts, servers)
    assert answers[0] == answers[1]


@pytest.mark.parametrize("client_pkg,host_pkg", [("repro", "repro_torch"),
                                                 ("repro_torch", "repro")])
def test_client_of_one_package_drives_hosts_of_the_other(client_pkg,
                                                         host_pkg):
    """A FabricClient of one package over ServiceHosts of the other, on
    loopback sockets, hashed and blocked: rows and counts bit-identical
    to a single node, an append applied exactly once."""
    client_pk, host_pk = ((J, P) if client_pkg == "repro" else (P, J))
    recs = _records(300, seed=23)
    answers = []
    for strategy_sm in (
            lambda pk: pk.shardmap.ShardMap.hashed(_schema(pk), "a", 2,
                                                   seed=7),
            lambda pk: pk.shardmap.ShardMap.blocked(2, block_size=160)):
        hosts, servers, gids = _socket_shards(host_pk, recs,
                                              strategy_sm(host_pk))
        try:
            answers.append(_drive(client_pk, servers,
                                  strategy_sm(client_pk), gids,
                                  _Single(client_pk, recs), 300))
        finally:
            _close_shards(hosts, servers)
    assert answers[0] == answers[1]              # same rows, both maps


# ------------------------------------------------------------ trace stitch
def test_trace_propagates_across_the_rpc_boundary():
    recs = _records(128, seed=4)
    for pk in PKGS:
        obs_trace = __import__(f"{pk.root}.obs.trace", fromlist=["x"])
        tracer = obs_trace.Tracer(capacity=4096)
        obs_trace.install(tracer)
        try:
            sm = pk.shardmap.ShardMap.blocked(2, total_records=128)
            parts = {s: (r, g) for s, r, g in sm.partition(recs)}
            stores, gids = [], []
            for s in range(2):
                r, g = parts[s]
                stores.append(_single_node(pk, r))
                gids.append(g)
            with pk.client.FabricClient.local(stores, sm, gids=gids,
                                              max_delay_ms=1.0) as fc:
                fut = fc.submit(pk.db.col("a") == 1)
                fut.result(timeout=T)
                assert fc.drain(timeout=T)
            spans = tracer.spans()
            scatters = [s for s in spans if s.name == "fabric.scatter"]
            rpcs = [s for s in spans if s.name == "rpc.query"]
            assert scatters and rpcs
            assert fut.trace_id == scatters[-1].trace_id
            sc = scatters[-1]
            stitched = [r for r in rpcs if r.trace_id == sc.trace_id]
            assert len(stitched) == 2       # one per touched shard
            for r in stitched:
                assert r.parent_id == sc.span_id
        finally:
            obs_trace.uninstall(tracer)


# ------------------------------------------------------------ network chaos
def test_network_chaos_loses_no_acknowledged_writes():
    """One FaultPlan JSON, each package under its own injector: nothing
    acknowledged is lost or doubled, every count equals the clean run's,
    and both packages fire the same schedule."""
    from repro.fault import FaultInjector as JInj, FaultPlan as JPlan
    from repro_torch.fault import FaultInjector as TInj, FaultPlan as TPlan
    plan_json = JPlan.random(23, profile="network", n_faults=16,
                             max_occurrence=24, max_stall_s=0.001).to_json()
    blocks = [np.random.default_rng(100 + i).integers(0, M, (48, 2),
                                                      dtype=np.int32)
              for i in range(6)]
    outcomes = []
    for pk, inj_cls, plan_cls in ((J, JInj, JPlan), (P, TInj, TPlan)):
        plan = plan_cls.from_json(plan_json)
        assert all(s.site in ("rpc.send", "rpc.recv") for s in plan.specs)
        ref = pk.db.BitmapDB(num_keys=M, **pk.kw)
        for b in blocks:
            ref.append_encoded(b)
        key = pk.planner.key
        truth = [ref.query(key(i)).count for i in range(M)]
        sm = pk.shardmap.ShardMap(num_shards=2, strategy="hash",
                                  column_index=0, base=0, cardinality=0,
                                  seed=23)
        fc = pk.client.FabricClient.local(
            [pk.db.BitmapDB(num_keys=M, **pk.kw) for _ in range(2)], sm,
            max_delay_ms=1.0, request_timeout_s=0.5, request_retries=8,
            append_retries=10)
        inj = inj_cls(plan).install()
        try:
            acked = 0
            for b in blocks:
                acked = fc.append_encoded(b)    # returns only when acked
            final = [fc.submit(key(i)).count for i in range(M)]
            stored = sum(p["num_records"] for p in fc.info())
        finally:
            inj.uninstall()
            fc.close()
        assert acked == 6 * 48
        assert stored == acked              # nothing lost, nothing doubled
        assert final == truth
        assert inj.fired()
        assert all(e["site"] in ("rpc.send", "rpc.recv")
                   for e in inj.fired())
        outcomes.append((acked, stored, final))
    assert outcomes[0] == outcomes[1]


def test_network_chaos_same_seed_same_schedule():
    from repro.fault import FaultPlan as JPlan
    from repro_torch.fault import FaultPlan as TPlan
    for plan_cls in (JPlan, TPlan):
        p1 = plan_cls.random(47, profile="network")
        assert p1.specs == plan_cls.random(47, profile="network").specs
        assert plan_cls.from_json(p1.to_json()).specs == p1.specs
    assert (TPlan.random(47, profile="network").to_json()
            == JPlan.random(47, profile="network").to_json())


# ------------------------------------------------------------- multiprocess
@pytest.mark.slow
def test_multiprocess_shard_workers_end_to_end(tmp_path):
    """Two spawned ``repro_torch`` shard workers on the CPU behind a port
    client: the reference suite's answers, an append, and the workers'
    own counters (every wave on the session's backend) over the wire."""
    from repro_torch.fabric.worker import spawn_shards

    recs = _records(240, seed=17)
    single = _single_node(J, recs)
    sm = P.shardmap.ShardMap.hashed(_schema(P), "a", 2, seed=11)
    parts = {s: (r, g) for s, r, g in sm.partition(recs)}
    shard_records, gids = [], []
    for s in range(2):
        r, g = parts.get(s, (np.zeros((0, 2), np.int32),
                             np.zeros(0, np.int64)))
        shard_records.append(r.astype(np.uint8))    # the caller's dtype
        gids.append(g)
    art = str(tmp_path / "artifacts")
    with spawn_shards(2, schema=_schema(P), shard_records=shard_records,
                      service_config={"max_delay_ms": 1.0},
                      artifact_dir=art, device="cpu") as fleet:
        fc = P.client.FabricClient.connect(fleet.addresses, sm,
                                           schema=_schema(P), gids=gids,
                                           max_delay_ms=1.0)
        try:
            assert sum(p["num_records"] for p in fc.info()) == 240
            for q, jq in zip(_queries(P), _queries(J)):
                row, count = fc.submit(q).result(timeout=120)
                want = single.query(jq)
                assert count == want.count
                np.testing.assert_array_equal(_trim(row, 240),
                                              _trim(want.rows, 240))
            more = _records(32, seed=18)
            single.append_encoded(more)
            assert fc.append_encoded(more) == 272
            assert fc.submit(P.planner.key(2)).count \
                == single.query(J.planner.key(2)).count
            procs = [h["process"] for h in fc.health()["shards"]]
            assert len({p["pid"] for p in procs}) == 2
            for p in procs:
                assert set(p["waves_by_backend"]) <= {"auto", "bulk", "ref"}
                assert sum(p["waves_by_backend"].values()) >= 1
        finally:
            fc.close()
    for p in fleet.procs:
        assert not p.is_alive()


@pytest.mark.slow
def test_worker_that_cannot_start_fails_spawn():
    """A worker whose session cannot open reports it, and spawn_shards
    raises: there is no silent fallback child."""
    from repro_torch.fabric.worker import spawn_shards
    with pytest.raises(RuntimeError, match="failed to start"):
        spawn_shards(1, num_keys=M, device="no-such-device",
                     start_timeout_s=T)
