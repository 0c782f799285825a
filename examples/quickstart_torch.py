"""Quickstart of the PyTorch/CUDA port: the paper's Fig. 1/Fig. 3 flow
through the `repro_torch.db` facade, on the card.

A BIC core turns records into a key-major bitmap index so that
multi-dimensional queries become streaming bitwise passes.
`repro_torch.db` wraps that core in a database port: a `Schema` names the
key rows, `col(...)` expressions compile to fused bitmap passes, and one
`BitmapDB` session owns ingest, durability, and query serving.  The index
lives on the session's device; on the card its build and its passes run
the port's hand-written CUDA kernels.

Run:  python examples/quickstart_torch.py [--device cpu]

The default device is the card (`cuda`); `--device cpu` runs the kernels'
plain versions on the CPU.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.db import col  # noqa: E402
from repro_torch.engine import key  # noqa: E402

DOMAINS = ["web", "code", "math", "news"]
LANGS = ["en", "de", "ja"]
TEMP_EDGES = [-10.0, 0.0, 10.0, 20.0, 30.0, 45.0]


def make_rows(rng, n):
    return {
        "domain": [DOMAINS[i] for i in rng.integers(0, len(DOMAINS), n)],
        "lang": [LANGS[i] for i in rng.integers(0, len(LANGS), n)],
        "temp": rng.uniform(-10, 45, n).round(2).tolist(),
        "flagged": [bool(b) for b in rng.random(n) < 0.1],
    }


def brute(rows, i):
    """The quickstart query, evaluated by brute force per record."""
    return (rows["domain"][i] in ("code", "math")
            and rows["lang"][i] == "en"
            and 10.0 <= rows["temp"][i]
            and not rows["flagged"][i])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the index lives (default: the card)")
    dev = ap.parse_args(argv).device
    rng = np.random.default_rng(0)
    schema = repro_torch.Schema([
        repro_torch.Column.categorical("domain", DOMAINS),
        repro_torch.Column.categorical("lang", LANGS),
        repro_torch.Column.binned("temp", edges=TEMP_EDGES),
        repro_torch.Column.categorical("flagged", [False, True]),
    ])
    print(schema)

    # ---- ingest: structured rows -> streaming bitmap index -------------
    db = repro_torch.BitmapDB(schema, device=dev)
    n = 4096
    rows = make_rows(rng, n)
    db.ingest(rows)
    print(f"ingested {db.num_records} records over {db.num_keys} key rows "
          f"on {db.device}")

    # ---- query: typed expressions compile to fused bitmap passes -------
    q = (col("domain").isin(["code", "math"]) & (col("lang") == "en")
         & (col("temp") >= 10.0) & ~(col("flagged") == True))  # noqa: E712
    res = db.query(q)
    want = [i for i in range(n) if brute(rows, i)]
    assert list(res.ids) == want, "bitmap query must match brute force"
    print(f"query code|math & en & temp>=10 & ~flagged -> {res.count} "
          f"records: {[int(i) for i in res.ids[:8]]} ... "
          "(verified by brute force)")

    # raw integer key rows still work (the engine predicate surface)
    k = schema.key_of("domain", "code")
    res2 = db.query(key(k) & ~key(schema.key_of("flagged", True)))
    want2 = [i for i in range(n) if rows["domain"][i] == "code"
             and not rows["flagged"][i]]
    assert list(res2.ids) == want2, "raw predicate must match brute force"
    print(f"raw predicate key({k}) & ~flagged -> {res2.count} records "
          "(verified by brute force)")

    # ---- stats feed the planner's cheapest-first clause ordering -------
    st = db.stats
    labels = [schema.key_label(i) for i in range(3)]
    print(f"per-key selectivity stats: {labels} -> {st.counts[:3]}")

    # ---- explain: how a query WOULD run, without running it ------------
    # backend="auto" asks the cost model; on the card its one candidate is
    # the kernels (`cuda`), so there it decides factoring and stacking.
    ex = db.explain(q)
    est = {k: f"{v * 1e6:.0f}us" for k, v in ex["decision"]["estimates"]
           .items()} if ex["decision"] else {}
    print(f"explain: bucket_shape={ex['bucket_shape']} "
          f"backend={ex['backend']} est_matches={ex['est_matches']:.0f} "
          f"(actual {res.count}) candidates={est}")

    # ---- durability: spill to a store, crash, recover ------------------
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "idx")
        durable = repro_torch.BitmapDB(schema, path=path, spill_records=1024,
                                       device=dev)
        cut = n - 500                   # last 500 stay under the threshold
        durable.ingest({k2: v[:cut] for k2, v in rows.items()})
        durable.append({k2: v[cut:] for k2, v in rows.items()})
        segs = len(durable.store.segments)
        wal_blocks = len(durable.store.replay_wal())
        assert wal_blocks, "the final sub-threshold block must be WAL-only"
        # "crash": reopen from disk — manifest + WAL replay, bit-identical
        recovered = repro_torch.open(path, device=dev)
        assert recovered.num_records == n
        assert list(recovered.query(q).ids) == want
        print(f"recovered {recovered.num_records} records from {segs} "
              f"segments + a {wal_blocks}-block WAL tail; query results "
              "bit-identical")

        # ---- serving: one step function over the bucketed executor ----
        step = recovered.serve_step()
        batch = [q, col("lang") == "de", key(k),
                 col("temp").between(0, 20) & (col("domain") == "web")]
        rows_out, counts = step(batch)
        counts = [int(c) for c in counts]
        assert counts == [db.query(b).count for b in batch]
        print(f"served a {len(batch)}-query batch in bucketed dispatches: "
              f"counts={counts}")

        # ---- the service port: micro-batching + standby duty cycle ----
        # submit() from any number of threads returns a future; the
        # scheduler coalesces everything inside the delay window into ONE
        # bucketed dispatch, then duty-cycles into standby when idle —
        # the paper's operating model as an API.
        with recovered.serve(max_delay_ms=2.0, idle_after_ms=10.0) as svc:
            futs = [svc.submit(qq) for qq in batch * 8]   # 32 requests
            svc.drain()
            assert [int(f.count) for f in futs[:4]] == counts
            deadline = time.time() + 5        # idle past the threshold
            while svc.state != "standby" and time.time() < deadline:
                time.sleep(0.01)
            m = svc.metrics()
            print(f"service: {m.served} queries in {m.batches} coalesced "
                  f"batch(es), p50={m.latency_p50_ms:.2f}ms, "
                  f"state={m.state}, active={m.active_joules:.2e}J "
                  f"standby={m.standby_joules:.2e}J (the paper's silicon "
                  "model, not the card's energy)")
            assert m.state == "standby", "idle service must clock-gate"
        recovered.store.close()

    # ---- the fabric: the same query plane over N shard stores ----------
    # A ShardMap hash-partitions records by their domain key; each shard
    # is a full BitmapDB+BitmapService stack behind a transport (loopback
    # here — `repro_torch.fabric.spawn_shards` runs the identical stack as
    # worker processes on the card).  The FabricClient keeps the
    # submit()/future surface, scatters each query to the shards that can
    # own it, and merges rows on the host bit-identically.
    from repro_torch.db.expr import lower as lower_expr
    from repro_torch.fabric import FabricClient, ShardMap
    sm = ShardMap(num_shards=3, strategy="hash", column_index=0,
                  base=0, cardinality=len(DOMAINS), seed=1)
    with FabricClient.local([repro_torch.BitmapDB(schema, device=dev)
                             for _ in range(3)], sm) as fc:
        fc.append(rows)
        fut = fc.submit(q)
        assert list(fut.ids) == want, "fabric must merge bit-identically"
        served = [h["served"] for h in fc.metrics()["shards"]]
        owners = sorted(sm.owners(lower_expr(q, schema)))
        print(f"fabric: 3 hash shards served {fut.count} matches "
              f"(per-shard served={served}, query pruned to "
              f"shards {owners})")

    print("quickstart OK")


if __name__ == "__main__":
    main()
