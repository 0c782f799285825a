"""``FabricClient`` — the existing ``submit()``/future surface, scattered
over N shard stores (the port's twin of ``repro.fabric.client``).

The client may run in a process with no card (it holds no session of its
own): the merge stays on the host in numpy, and a :class:`FabricFuture`
resolves to the reference's numpy ``uint32`` row, not to the int32
device tensor a :class:`repro_torch.serve.service.QueryFuture` holds.
The shards' sessions run wherever their ``device`` says.

The client mirrors the service's micro-batch discipline one level up:
``submit()`` enqueues and returns a :class:`FabricFuture` immediately; a
scheduler thread coalesces a wave, lowers each query to a predicate,
prunes it to its owning shards (:meth:`ShardMap.owners`), sends one
``query`` envelope per touched shard, and merges the per-shard packed
rows back into ONE global bitmap per query — bit-identical to what a
single-node :class:`~repro_torch.serve.service.BitmapService` would return for
the same data, whatever the partitioning:

  * every shard's reply is mapped through that shard's **gid table**
    (shard-local record ordinal -> global ordinal) and OR'd into the
    global row — hash partitioning interleaves records, so this is the
    general splice;
  * a shard whose gids are one contiguous, word-aligned run (the block
    strategy) short-circuits to a direct word-wise OR of its packed row
    at the right offset — the concatenation case.

**Hedged reads**: each per-shard request goes to a seeded permutation of
the shard's replicas; if the first pick has not answered within
``hedge_delay_ms``, the next replica is launched too, and the first
completed reply wins.  Losers are ``cancel()``'ed (late replies are
counted, never delivered).  The clock, the waiter, and the permutation
seed are all injectable, so winner selection is exactly reproducible
under a fake clock — that is what the hedging tests pin down.

**Exactly-once appends**: writes route by the shard map and carry a
per-(client, shard) sequence number; a timed-out append is retried with
the SAME sequence number and deduplicated server-side, so a drop or
duplicate on either leg of the exchange can delay an acknowledgement but
never lose or double-apply an acknowledged write.

**Observability roll-up**: ``metrics()`` fans a ``metrics`` envelope to
every shard and returns the per-shard dicts plus a fabric-level energy
roll-up (summed shard ledgers — each shard still reconciles locally);
traced clients stamp each scatter's span context into the envelopes, so
shard-side ``rpc.query`` spans parent under the client's wave.
"""
from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.db import expr as expr_mod
from repro_torch.fabric.envelope import Envelope, query_to_wire
from repro_torch.fabric.shardmap import ShardMap
from repro_torch.fabric.transport import ReplyTimeout
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.service import ServiceClosed

__all__ = ["FabricClient", "FabricFuture", "FabricError"]


class FabricError(RuntimeError):
    """A shard replied ``error`` (the remote exception, re-raised
    client-side with its type name in the message)."""


class FabricFuture:
    """Handle to one fabric query — the :class:`repro_torch.serve.service.
    QueryFuture` surface (``result``/``rows``/``count``/``ids``) over a
    merged global result row, held on the host as numpy ``uint32``."""

    __slots__ = ("query", "_ev", "_row", "_count", "_n", "_err",
                 "trace_id", "count_only")

    def __init__(self, query, *, count_only: bool = False):
        self.query = query
        self.count_only = count_only
        self._ev = threading.Event()
        self._row: np.ndarray | None = None
        self._count = 0
        self._n = 0
        self._err: BaseException | None = None
        self.trace_id: int | None = None

    def _resolve(self, row, count: int, n: int) -> None:
        if self._ev.is_set():
            return
        self._row, self._count, self._n = row, int(count), int(n)
        self._ev.set()

    def _reject(self, err: BaseException) -> None:
        if self._ev.is_set():
            return
        self._err = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def _ready(self, timeout: float | None = None) -> None:
        if not self._ev.wait(timeout):
            raise TimeoutError(f"query not served within {timeout}s")
        if self._err is not None:
            raise self._err

    def result(self, timeout: float | None = None):
        """(packed global row (W,) numpy uint32, count) — ``W =
        ceil(N/32)`` for the fabric's N total records (None when the
        future was submitted ``count_only``)."""
        self._ready(timeout)
        return self._row, self._count

    def exception(self, timeout: float | None = None):
        self._ev.wait(timeout)
        return self._err

    @property
    def rows(self):
        return self.result()[0]

    @property
    def count(self) -> int:
        self._ready()
        return self._count

    @property
    def ids(self) -> np.ndarray:
        from repro_torch.db.result import unpack_ids
        return unpack_ids(np.asarray(self.rows), self._n)

    def __repr__(self) -> str:
        state = ("failed" if self._err is not None
                 else "done" if self.done() else "pending")
        return f"<FabricFuture {state} {self.query!r:.60}>"


def _is_run(gids: np.ndarray) -> bool:
    """True when ``gids`` is one contiguous ascending run of ordinals."""
    return gids.size <= 1 or bool(
        gids[-1] - gids[0] == gids.size - 1 and np.all(np.diff(gids) == 1))


class _Item:
    __slots__ = ("pred", "future", "t")

    def __init__(self, pred, future, t):
        self.pred, self.future, self.t = pred, future, t


def _default_waiter(futs, timeout: float, clock) -> object | None:
    """First completed future, polling (events are per-future; the poll
    interval bounds added latency on the multi-replica path only)."""
    if len(futs) == 1:
        return futs[0] if futs[0].wait(max(timeout, 0.0)) else None
    deadline = clock() + max(timeout, 0.0)
    while True:
        for f in futs:
            if f.done():
                return f
        left = deadline - clock()
        if left <= 0:
            return None
        time.sleep(min(2e-4, left))


class FabricClient:
    """See module docstring.  ``transports`` is one replica list per
    shard (``transports[s][0]`` is the preferred primary); ``gids`` is
    one int64 global-ordinal table per shard (fresh empty fabric:
    omit)."""

    def __init__(self, transports: Sequence[Sequence], shardmap: ShardMap,
                 *, schema=None, gids: Sequence[np.ndarray] | None = None,
                 max_batch: int = 1024, max_delay_ms: float = 2.0,
                 hedge_delay_ms: float = 20.0, hedge_seed: int = 0,
                 request_timeout_s: float = 30.0,
                 request_retries: int = 2, append_retries: int = 5,
                 background: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 waiter=None, name: str = "fabric", _owned_hosts=()):
        if len(transports) != shardmap.num_shards:
            raise ValueError(f"{len(transports)} transport groups for "
                             f"{shardmap.num_shards} shards")
        self._transports = [list(g) for g in transports]
        self.shardmap = shardmap
        self.schema = schema
        self.name = name
        if gids is None:
            gids = [np.zeros(0, np.int64)] * shardmap.num_shards
        self._gids = [np.asarray(g, np.int64) for g in gids]
        # per shard: is its gid table one contiguous ascending run?  Set
        # with the table (an append recomputes it), so the merge does not
        # rescan a table of millions of gids for every row
        self._runs = [_is_run(g) for g in self._gids]
        self._total = int(sum(len(g) for g in self._gids))
        self.max_batch = max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self.hedge_delay_s = hedge_delay_ms / 1e3
        self.hedge_seed = hedge_seed
        self.request_timeout_s = request_timeout_s
        self.request_retries = request_retries
        self.append_retries = append_retries
        self.background = background
        self.clock = clock
        self.waiter = waiter or (
            lambda futs, timeout: _default_waiter(futs, timeout, clock))
        self._owned_hosts = list(_owned_hosts)
        # append streams: one monotone sequence per (client, shard)
        self._stream = f"c{os.getpid()}-{id(self):x}"
        self._next_seq = [0] * shardmap.num_shards
        self._append_lock = threading.Lock()
        # hedging accounting (metrics()): seeded per-request permutation
        self._req_ids = itertools.count(1)
        self._hedges_launched = 0
        self._hedge_wins = 0
        self._losers_cancelled = 0
        self._append_retries_done = 0
        self._served = 0
        self._stats_lock = threading.Lock()
        # client-side micro-batch scheduler (mirrors the service's)
        self._cv = threading.Condition()
        self._pending: list[_Item] = []
        self._inflight = 0
        self._openflag = True
        self._close_lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._pool = None
        self._pool_lock = threading.Lock()
        self._thread = None
        if background:
            self._thread = threading.Thread(
                target=self._run, name=f"repro-fabric-{name}",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- builders
    @classmethod
    def local(cls, stores: Sequence, shardmap: ShardMap, *,
              schema=None, gids=None, service_config=None, **kw
              ) -> "FabricClient":
        """An all-in-process fabric: each element of ``stores`` is a
        ``BitmapDB`` (or a replica list of them) to wrap in a
        ``BitmapService`` + ``ServiceHost`` + loopback transport.  The
        client owns the hosts and closes them with itself."""
        from repro_torch.fabric.protocol import ServiceHost
        from repro_torch.fabric.transport import LoopbackTransport
        from repro_torch.serve.service import BitmapService, ServiceConfig

        cfg = service_config or ServiceConfig()
        hosts, groups = [], []
        for sid, group in enumerate(stores):
            if not isinstance(group, (list, tuple)):
                group = [group]
            ts = []
            for ri, db in enumerate(group):
                svc = db if isinstance(db, BitmapService) \
                    else BitmapService(db, cfg)
                host = ServiceHost(svc, shard_id=sid)
                hosts.append(host)
                ts.append(LoopbackTransport(
                    host, name=f"shard{sid}r{ri}"))
            groups.append(ts)
        if schema is None:
            for group in stores:
                g0 = group[0] if isinstance(group, (list, tuple)) \
                    else group
                schema = getattr(getattr(g0, "db", g0), "schema", None)
                if schema is not None:
                    break
        return cls(groups, shardmap, schema=schema, gids=gids,
                   _owned_hosts=hosts, **kw)

    @classmethod
    def connect(cls, addresses: Sequence, shardmap: ShardMap, *,
                schema=None, gids=None, **kw) -> "FabricClient":
        """A fabric over running shard workers: ``addresses`` is one
        ``(host, port)`` (or a replica list of them) per shard."""
        from repro_torch.fabric.transport import SocketTransport
        groups = []
        for group in addresses:
            if isinstance(group, tuple) and len(group) == 2 \
                    and isinstance(group[1], int):
                group = [group]
            groups.append([SocketTransport(tuple(a)) for a in group])
        return cls(groups, shardmap, schema=schema, gids=gids, **kw)

    # --------------------------------------------------------------- submit
    @property
    def num_records(self) -> int:
        return self._total

    @property
    def num_shards(self) -> int:
        return self.shardmap.num_shards

    def gids(self, shard: int) -> np.ndarray:
        return self._gids[shard]

    def submit(self, query, *, timeout: float | None = None,
               count_only: bool = False) -> FabricFuture:
        """Enqueue one query; returns its future immediately.  Queries
        are schema expressions or predicate trees (pre-built plans stay
        node-local and cannot cross the fabric)."""
        pred = expr_mod.lower(query, self.schema)
        fut = FabricFuture(query, count_only=count_only)
        with self._cv:
            if not self._openflag:
                raise ServiceClosed("submit() on a closed FabricClient")
            self._pending.append(_Item(pred, fut, self.clock()))
            self._inflight += 1
            self._cv.notify_all()
        if not self.background and len(self._pending) >= self.max_batch:
            self._flush_inline()
        _ = timeout                     # admission is unbounded here
        return fut

    def submit_many(self, queries: Sequence, *, count_only: bool = False
                    ) -> list[FabricFuture]:
        return [self.submit(q, count_only=count_only) for q in queries]

    def drain(self, timeout: float | None = None) -> bool:
        if not self.background:
            self._flush_inline()
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=timeout)

    # ------------------------------------------------------------ scheduler
    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while self._openflag and not self._pending:
                        self._cv.wait()
                    if not self._pending:
                        return          # closed and drained
                    deadline = self._pending[0].t + self.max_delay_s
                    while (len(self._pending) < self.max_batch
                           and self._openflag):
                        left = deadline - self.clock()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=min(left, 0.05))
                    batch = self._pending[:self.max_batch]
                    del self._pending[:len(batch)]
                    self._cv.notify_all()
                self._execute_wave(batch)
        except BaseException as e:      # noqa: BLE001 — never hang callers
            with self._cv:
                self._openflag = False
                for it in self._pending:
                    it.future._reject(e)
                self._inflight -= len(self._pending)
                self._pending.clear()
                self._cv.notify_all()
            raise

    def _flush_inline(self) -> None:
        # serialized: concurrent one-shot flushers must not interleave
        # partial waves (the same race close() has with submit())
        with self._flush_lock:
            while True:
                with self._cv:
                    if not self._pending:
                        return
                    batch = self._pending[:self.max_batch]
                    del self._pending[:len(batch)]
                    self._cv.notify_all()
                self._execute_wave(batch)

    # ---------------------------------------------------------- the scatter
    def _execute_wave(self, batch: list[_Item]) -> None:
        tr = obs_trace.TRACER
        if tr is None:
            self._scatter(batch, None)
        else:
            with tr.span("fabric.scatter", size=len(batch)) as sp:
                for it in batch:
                    it.future.trace_id = sp.trace_id
                self._scatter(batch, sp.context)
        with self._cv:
            self._inflight -= len(batch)
            self._cv.notify_all()
        with self._stats_lock:
            self._served += len(batch)

    def _scatter(self, batch: list[_Item], trace) -> None:
        total = self._total
        width = (total + 31) >> 5
        # shard -> ([wave indexes], count_only?) — split full/count so an
        # envelope's reply shape is uniform
        per_shard: dict[tuple[int, bool], list[int]] = {}
        for wi, it in enumerate(batch):
            owners = self.shardmap.owners(it.pred)
            if owners is None:
                owners = range(self.num_shards)
            elif not owners:
                # the predicate contradicts itself on the sharded
                # column: provably empty, no scatter at all
                row = (None if it.future.count_only
                       else np.zeros(width, np.uint32))
                it.future._resolve(row, 0, total)
                continue
            for s in owners:
                per_shard.setdefault(
                    (s, it.future.count_only), []).append(wi)
        if not per_shard:
            return
        merged_rows: dict[int, np.ndarray] = {}    # wave ix -> global row
        counts = [0] * len(batch)
        parts = []
        pool = self._ensure_pool()
        for (s, count_only), wis in per_shard.items():
            env = Envelope("query", trace=trace, payload={
                "queries": [query_to_wire(batch[wi].pred) for wi in wis],
                "count_only": count_only})
            parts.append((s, count_only, wis,
                          pool.submit(self._shard_request, s, env)))
        mlock = threading.Lock()
        for s, count_only, wis, task in parts:
            try:
                reply = task.result()
            except BaseException as e:   # noqa: BLE001 — to the futures
                for wi in wis:
                    batch[wi].future._reject(e)
                continue
            p = reply.payload
            failed = {int(qi): msg for qi, msg in p.get("errors", [])}
            rows = p.get("rows")
            shard_n = min(int(p["num_records"]), len(self._gids[s]))
            run = self._runs[s] or _is_run(self._gids[s][:shard_n])
            with mlock:
                for qi, wi in enumerate(wis):
                    if qi in failed:
                        batch[wi].future._reject(FabricError(
                            f"shard {s}: {failed[qi]}"))
                        continue
                    counts[wi] += int(p["counts"][qi])
                    if not count_only:
                        out = merged_rows.get(wi)
                        if out is None:
                            out = merged_rows[wi] = np.zeros(
                                width, np.uint32)
                        self._merge_row(out, np.asarray(rows[qi]),
                                        self._gids[s], shard_n, run)
        for wi, it in enumerate(batch):
            if it.future.done():
                continue
            row = (None if it.future.count_only
                   else merged_rows.get(wi,
                                        np.zeros(width, np.uint32)))
            it.future._resolve(row, counts[wi], total)

    @staticmethod
    def _merge_row(out: np.ndarray, local: np.ndarray,
                   gids: np.ndarray, shard_n: int, run: bool) -> None:
        """OR one shard's packed result row into the global row through
        its gid table (see module docstring for the two cases); ``run``
        says whether the table's first ``shard_n`` gids are one contiguous
        ascending run."""
        if shard_n == 0:
            return
        gids = gids[:shard_n]
        nw = (shard_n + 31) >> 5
        start = int(gids[0])
        if (start & 31) == 0 and run:
            # contiguous + word-aligned: the concatenation case
            w0 = start >> 5
            out[w0:w0 + nw] |= local[:nw]
            return
        from repro_torch.db.result import unpack_ids
        ids = unpack_ids(local[:nw], shard_n)
        if ids.size == 0:
            return
        g = gids[ids]
        np.bitwise_or.at(out, g >> 5,
                         (np.uint32(1) << (g & 31).astype(np.uint32)))

    # --------------------------------------------------------- hedged reads
    def _shard_request(self, shard: int, env: Envelope,
                       *, hedge: bool = True,
                       timeout: float | None = None) -> Envelope:
        """One request to ``shard`` with retries (reads are idempotent);
        each attempt hedges across replicas."""
        timeout = self.request_timeout_s if timeout is None else timeout
        last: BaseException | None = None
        for _ in range(self.request_retries + 1):
            try:
                return self._hedged(shard, env, timeout, hedge=hedge)
            except ReplyTimeout as e:
                last = e
        raise last

    def _hedged(self, shard: int, env: Envelope, timeout: float,
                *, hedge: bool = True) -> Envelope:
        replicas = self._transports[shard]
        if not hedge:
            # writes and control envelopes go to the PRIMARY, never a
            # shuffled pick — a write landing on a random replica would
            # silently diverge the group
            order = [0]
        else:
            order = list(range(len(replicas)))
            if len(order) > 1:
                # the permutation (not the clock) is the seeded part:
                # same hedge_seed + request index -> same replica
                # order, always
                rng = random.Random(self.hedge_seed * 1_000_003
                                    + next(self._req_ids))
                rng.shuffle(order)
        clock = self.clock
        deadline = clock() + timeout
        launched: list = []
        launched_ix: list[int] = []
        win = None
        next_i = 0
        last_launch = 0.0
        while True:
            now = clock()
            if next_i < len(order) and (
                    not launched
                    or now >= last_launch + self.hedge_delay_s):
                launched.append(
                    replicas[order[next_i]].send(env))
                launched_ix.append(order[next_i])
                last_launch = now
                if next_i > 0:
                    with self._stats_lock:
                        self._hedges_launched += 1
                next_i += 1
            wait_until = deadline if next_i >= len(order) else min(
                deadline, last_launch + self.hedge_delay_s)
            win = self.waiter(launched, wait_until - now)
            if win is not None:
                break
            if clock() >= deadline and next_i >= len(order):
                for f in launched:
                    if f.cancel():
                        with self._stats_lock:
                            self._losers_cancelled += 1
                raise ReplyTimeout(
                    f"shard {shard}: no replica answered {env.kind!r} "
                    f"within {timeout}s")
        for ix, f in zip(launched_ix, launched):
            if f is win:
                if ix != order[0]:
                    with self._stats_lock:
                        self._hedge_wins += 1
            elif f.cancel():
                with self._stats_lock:
                    self._losers_cancelled += 1
        reply = win.result(0)
        if reply.kind == "error":
            raise FabricError(f"shard {shard} "
                              f"[{reply.payload.get('type')}]: "
                              f"{reply.payload.get('error')}")
        return reply

    # -------------------------------------------------------------- appends
    def append(self, rows) -> int:
        """Route schema rows to their shards; returns the new global
        record count once every touched shard acknowledged."""
        if self.schema is None:
            raise RuntimeError("append(rows) needs a schema; use "
                               "append_encoded for raw key words")
        return self.append_encoded(self.schema.encode(rows))

    def append_encoded(self, records) -> int:
        records = np.asarray(records, np.int32)
        if records.ndim != 2:
            raise ValueError(f"records must be (N, W), got "
                             f"{records.shape}")
        with self._append_lock:
            parts = self.shardmap.partition(records,
                                            start_gid=self._total)
            for shard, recs, gids in parts:
                seq = self._next_seq[shard] + 1
                self._append_one(shard, seq, recs)
                self._next_seq[shard] = seq
                self._gids[shard] = np.concatenate(
                    [self._gids[shard], gids])
                self._runs[shard] = _is_run(self._gids[shard])
            self._total += records.shape[0]
            return self._total

    def _append_one(self, shard: int, seq: int,
                    recs: np.ndarray) -> None:
        env = Envelope("append", payload={
            "stream": self._stream, "seq": seq, "records": recs})
        last: BaseException | None = None
        for attempt in range(self.append_retries + 1):
            try:
                # writes go to the primary only, never hedged (a hedged
                # write would double-apply on replica divergence); a
                # retry reuses the SAME seq -> server dedup
                self._shard_request(shard, env, hedge=False)
                return
            except ReplyTimeout as e:
                last = e
                if attempt < self.append_retries:
                    with self._stats_lock:
                        self._append_retries_done += 1
        raise last

    # ------------------------------------------------------------- controls
    def _broadcast(self, kind: str, **payload) -> list[dict]:
        out = []
        for s in range(self.num_shards):
            reply = self._shard_request(
                s, Envelope(kind, payload=payload), hedge=False)
            out.append(dict(reply.payload))
        return out

    def drain_shards(self, timeout_s: float | None = None) -> bool:
        return all(p.get("ok", False)
                   for p in self._broadcast("drain",
                                            timeout_s=timeout_s))

    def info(self) -> list[dict]:
        """Per-shard ``{shard_id, num_records, num_keys}`` straight from
        each primary — the server-side word on what is durably applied
        (the client's own ``num_records`` counter only says what was
        acknowledged to *this* client)."""
        return self._broadcast("info")

    def health(self) -> dict:
        shards = self._broadcast("health")
        return {"degraded": any(p.get("degraded") for p in shards),
                "shards": shards}

    def metrics(self) -> dict:
        """Fabric-level counters + per-shard service metrics + the
        energy roll-up (shard ledger totals summed)."""
        shards = self._broadcast("metrics")
        energy = [p.get("energy") or {} for p in shards]
        with self._stats_lock:
            mine = {
                "submitted": self._served + self._inflight,
                "served": self._served,
                "hedges_launched": self._hedges_launched,
                "hedge_wins": self._hedge_wins,
                "losers_cancelled": self._losers_cancelled,
                "append_retries": self._append_retries_done,
            }
        mine["late_replies"] = sum(
            t.stats()["late_replies"]
            for group in self._transports for t in group)
        return {
            **mine,
            "num_records": self._total,
            "num_shards": self.num_shards,
            "shards": shards,
            "energy": {
                "total_joules": sum(e.get("total_joules", 0.0)
                                    for e in energy),
                "active_joules": sum(
                    e.get("phase_joules", {}).get("busy", 0.0)
                    + e.get("phase_joules", {}).get("awake_idle", 0.0)
                    for e in energy),
                "standby_joules": sum(
                    e.get("phase_joules", {}).get("standby", 0.0)
                    for e in energy),
                "per_shard": energy,
            },
        }

    def transport_stats(self) -> list[list[dict]]:
        return [[t.stats() for t in group]
                for group in self._transports]

    # ------------------------------------------------------------ lifecycle
    def _ensure_pool(self):
        with self._pool_lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=max(2, self.num_shards),
                    thread_name_prefix=f"fabric-io-{self.name}")
            return self._pool

    def close(self, timeout: float | None = None) -> None:
        """Drain, stop the scheduler, close owned hosts and transports.
        Idempotent AND safe to call concurrently with in-flight
        ``submit()`` — a racing submit either wins admission (and its
        future resolves before teardown) or gets ``ServiceClosed``."""
        with self._close_lock:
            with self._cv:
                already = not self._openflag
                self._openflag = False
                self._cv.notify_all()
            if already:
                return
            if not self.background:
                self._flush_inline()
            if self._thread is not None:
                self._thread.join(timeout=timeout)
                self._thread = None
            with self._cv:
                # a scheduler that died early strands accepted items:
                # reject, never hang their callers
                for it in self._pending:
                    it.future._reject(ServiceClosed(
                        "FabricClient closed before this query served"))
                self._inflight -= len(self._pending)
                self._pending.clear()
                self._cv.notify_all()
            with self._pool_lock:
                if self._pool is not None:
                    self._pool.shutdown(wait=True)
                    self._pool = None
            for group in self._transports:
                for t in group:
                    t.close()
            for host in self._owned_hosts:
                host.close(timeout=timeout)

    def __enter__(self) -> "FabricClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"<FabricClient {self.name} shards={self.num_shards} "
                f"records={self._total} "
                f"{'open' if self._openflag else 'closed'}>")
