"""The port's static analysis and runtime lock witness
(``repro_torch.analysis``) against the JAX package's (``repro.analysis``).

Every test of ``tests/test_analysis.py`` has a twin here, on synthetic
trees under ``src/repro_torch/`` with a synthetic tables file; the ``jax``
checker's test becomes the ``torch`` checker's (a host sync planted in an
``lru_cache`` executor body, a stale row of the device-bodies table).  Then
the differentials: the port's locks, seams, taxonomy and wire checkers give
the reference's ``(checker, rule, symbol)`` set on the same synthetic files;
over the real trees the port reports the reference's findings, paths
mapped, plus only its own ``torch`` rows; the two tables share their lock
ranks and span rows; both witnesses flag the same planted nestings.  The
port's witness wraps no lock of ``src/repro`` and no stdlib lock created
under a port frame, composes with an installed reference witness, and sees
the service storm, a background spill and a loopback fabric append on the
CPU with zero violations.  No test asserts a wall-clock time.
"""
import collections
import importlib.util
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once,
# and a pool of a thread a core in each spends the CPUs waiting
torch.set_num_threads(1)

from repro.analysis import locks as jlocks  # noqa: E402
from repro.analysis import run as jrun  # noqa: E402
from repro.analysis import taxonomy as jtaxonomy  # noqa: E402
from repro.analysis import witness as jwitness  # noqa: E402
from repro_torch.analysis import (Baseline, Finding, find_repo_root,  # noqa: E402
                                  run)
from repro_torch.analysis import locks as tlocks  # noqa: E402
from repro_torch.analysis import taxonomy as ttaxonomy  # noqa: E402
from repro_torch.analysis import witness as witness_mod  # noqa: E402
from repro_torch.analysis.core import (TABLES,  # noqa: E402
                                       default_baseline_path)

REPO_ROOT = find_repo_root(os.path.dirname(__file__))

_LOCKS_AND_SPANS = """\
    ## Lock hierarchy

    | rank | lock | owner | may nest inside |
    |---|---|---|---|
    | 10 | `Outer._lock` | m.py | nothing |
    | 20 | `Inner._lock` | m.py | rank 10 |

    ## Observability

    | span | scope | meaning |
    |---|---|---|
    | `query` | per query | one query |
    | `flush.*` | per flush | one flush |
    """

# The three machine-parsed tables, minimal: two ranked locks, two span
# rows, one device body.
_TABLES = textwrap.dedent("""\
    # Synthetic tables

    """) + textwrap.dedent(_LOCKS_AND_SPANS) + textwrap.dedent("""\

    ## Device bodies

    | module | body | twin of | why |
    |---|---|---|---|
    | `engine/fold.py` | `fold` | synthetic | a table row |
    """)

_FOLD = """\
    def fold(blocks):
        return blocks.sum(0)
    """


def _mk_tree(tmp_path, files: dict, tables: str = _TABLES,
             name: str = "synthetic") -> str:
    """A synthetic repo: ``files`` by repo-relative path, the tables file
    at the port's path, and the same two tables as the reference's
    ``ARCHITECTURE.md`` (for the differentials)."""
    root = tmp_path / name
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    t = root / TABLES
    t.parent.mkdir(parents=True, exist_ok=True)
    t.write_text(tables)
    (root / "ARCHITECTURE.md").write_text(
        "# Synthetic architecture\n\n" + textwrap.dedent(_LOCKS_AND_SPANS))
    return str(root)


def _port(files: dict) -> dict:
    """Synthetic files under ``src/repro_torch/`` (plus the table's body)."""
    return {"src/repro_torch/engine/fold.py": _FOLD,
            **{f"src/repro_torch/{k}": v for k, v in files.items()}}


# ------------------------------------------------------------------- locks
_LOCK_INVERSION = """\
    import threading


    class Outer:
        def __init__(self):
            self._lock = threading.Lock()


    class Inner:
        def __init__(self):
            self._lock = threading.Lock()
            self.outer = Outer()

        def bad(self):
            with self._lock:
                with self.outer._lock:
                    pass
    """

_LOCK_UNRANKED = """\
    import threading


    class Outer:
        def __init__(self):
            self._lock = threading.Lock()


    class Rogue:
        def __init__(self):
            self._lock = threading.Lock()      # not in the table
            self.outer = Outer()

        def use(self):
            with self.outer._lock:
                with self._lock:
                    pass
    """


def test_locks_flags_planted_inversion(tmp_path):
    root = _mk_tree(tmp_path, _port({"serve/m.py": _LOCK_INVERSION}))
    found = run(root, ["locks"])
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "inversion"
    assert "Inner._lock" in found[0].symbol
    assert "Outer._lock" in found[0].symbol


def test_locks_correct_order_is_clean(tmp_path):
    good = _LOCK_INVERSION.replace(
        "with self._lock:\n                with self.outer._lock:",
        "with self.outer._lock:\n                with self._lock:")
    root = _mk_tree(tmp_path, _port({"serve/m.py": good}))
    assert run(root, ["locks"]) == []


def test_locks_flags_undocumented_lock_in_nesting(tmp_path):
    root = _mk_tree(tmp_path, _port({"serve/m.py": _LOCK_UNRANKED}))
    found = run(root, ["locks"])
    assert [f.rule for f in found] == ["unranked"], \
        [f.render() for f in found]
    assert "Rogue._lock" in found[0].symbol


# ------------------------------------------------------------------- seams
_SEAMS = """\
    import os


    def bad_sync(fd):
        os.fsync(fd)


    def good_sync(fd, seam):
        seam.fire("store.sync")
        os.fsync(fd)
    """


def test_seams_flags_raw_fsync_once(tmp_path):
    root = _mk_tree(tmp_path, _port({"store/badio.py": _SEAMS}))
    found = run(root, ["seams"])
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "unseamed-io"
    assert found[0].symbol == "bad_sync:os.fsync"


def test_seams_scope_excludes_other_layers(tmp_path):
    src = """\
        import os


        def bad_sync(fd):
            os.fsync(fd)
        """
    root = _mk_tree(tmp_path, _port({"obs/sink.py": src}))
    assert run(root, ["seams"]) == []


# ------------------------------------------------------------------- torch
_EXECUTORS = """\
    import functools

    import torch


    @functools.lru_cache(maxsize=8)
    def _executor(name):
        def run(x):
            return x.sum().item()
        return run


    def _body_for(name):
        def run(x):
            return x.cpu()
        return run


    @functools.lru_cache(maxsize=8)
    def _via_helper(name):
        return _body_for(name)


    @functools.lru_cache(maxsize=8)
    def _good(name):
        def run(x):
            return x * int(x.shape[0])
        return run
    """


def test_torch_flags_host_sync_in_executor_body(tmp_path):
    root = _mk_tree(tmp_path, _port({"engine/kern.py": _EXECUTORS}))
    found = run(root, ["torch"])
    assert sorted(f.symbol for f in found) == [
        "_body_for.run:.cpu()", "_executor.run:.item()"], \
        [f.render() for f in found]
    assert {f.rule for f in found} == {"host-sync"}


def test_torch_flags_stale_body_row(tmp_path):
    tables = _TABLES.replace("| `engine/fold.py` | `fold` |",
                             "| `engine/fold.py` | `gone` |")
    root = _mk_tree(tmp_path, _port({}), tables=tables)
    found = run(root, ["torch"])
    assert [(f.rule, f.path, f.symbol) for f in found] == [
        ("stale-body", TABLES, "src/repro_torch/engine/fold.py::gone")]


def test_torch_lints_table_bodies(tmp_path):
    fold = """\
        import numpy as np
        import torch


        def fold(blocks, n):
            width = float(blocks.shape[1])
            k = torch.tensor([n, width]).to(blocks.device)
            j = torch.as_tensor([n], device=blocks.device)
            c = torch.tensor([n], device="cpu")
            return np.asarray(blocks.tolist()) * float(k.sum()) + j + c
        """
    root = _mk_tree(tmp_path, {"src/repro_torch/engine/fold.py": fold})
    found = run(root, ["torch"])
    assert sorted(f.symbol for f in found) == [
        "fold:.tolist()", "fold:float() on a tensor",
        "fold:host tensor .to()", "fold:np.asarray()",
        "fold:torch.as_tensor(device=)"], [f.render() for f in found]


def test_torch_flags_cache_hazards(tmp_path):
    src = """\
        import functools

        _SEEN = {}


        @functools.lru_cache(maxsize=8)
        def _shapes(name, dims=[1, 2]):
            return tuple(dims)


        @functools.lru_cache(maxsize=8)
        def _executor(name):
            def run(x):
                return x + _SEEN.get(name, 0)
            return run
        """
    root = _mk_tree(tmp_path, _port({"engine/kern.py": src}))
    found = run(root, ["torch"])
    assert sorted((f.rule, f.symbol) for f in found) == [
        ("cache-hazard", "_executor.run:_SEEN"),
        ("cache-hazard", "_shapes:dims")], [f.render() for f in found]


def test_torch_scope_is_the_engine(tmp_path):
    root = _mk_tree(tmp_path, _port({"serve/kern.py": _EXECUTORS}))
    assert run(root, ["torch"]) == []


# ---------------------------------------------------------------- taxonomy
_METRICS = """\
    def setup(reg):
        reg.gauge("depth")
        reg.histogram("depth")
    """

_SPANS = """\
    def probe(tr):
        with tr.span("bogus"):
            pass
        with tr.span("flush.segment"):
            pass
    """


def test_taxonomy_flags_duplicate_metric(tmp_path):
    root = _mk_tree(tmp_path, _port({"serve/m.py": _METRICS}))
    found = run(root, ["taxonomy"])
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "metric-collision"
    assert found[0].symbol == "depth"


def test_taxonomy_flags_undocumented_span(tmp_path):
    root = _mk_tree(tmp_path, _port({"serve/m.py": _SPANS}))
    found = run(root, ["taxonomy"])
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "unknown-span"
    assert found[0].symbol == "bogus"


# -------------------------------------------------------------------- wire
_HOST = """\
    class Host:
        def _on_query(self, env):
            return env.reply("result")

        def _on_flush(self, env):
            return env.reply("ok")

        def _on_ping(self, env):
            return env.reply("pong")
    """

_CLIENT = """\
    from repro_torch.fabric.envelope import Envelope


    def drive(t):
        t.request(Envelope("flush"))
        t.request(Envelope("nuke"))
        r = t.request(Envelope("query"))
        if r.kind == "result":
            return True
        return r.kind == "ok"
    """


def test_wire_flags_missing_handler(tmp_path):
    host = _HOST.split("\n\n        def _on_ping")[0] + "\n"
    root = _mk_tree(tmp_path, _port({"fabric/host.py": host,
                                     "fabric/cli.py": _CLIENT}))
    found = run(root, ["wire"])
    assert len(found) == 1, [f.render() for f in found]
    assert found[0].rule == "missing-handler"
    assert found[0].symbol == "nuke"


# ---------------------------------------------------------------- baseline
def test_baseline_requires_reason():
    with pytest.raises(ValueError):
        Baseline([{"checker": "seams", "path": "x", "rule": "r",
                   "symbol": "s", "reason": "  "}])


def test_baseline_matches_across_line_drift():
    bl = Baseline([{"checker": "seams", "path": "p.py", "rule": "r",
                    "symbol": "f:os.fsync", "reason": "known"}])
    f1 = Finding("seams", "r", "p.py", 10, "f:os.fsync", "m")
    f2 = Finding("seams", "r", "p.py", 99, "f:os.fsync", "m")
    unbase, supp, stale = bl.split([f1, f2])
    assert unbase == [] and len(supp) == 2 and stale == []


# ----------------------------------------------------------------- witness
def _rank_extremes(wit):
    by_rank = sorted(wit.ranks.items(), key=lambda kv: kv[1])
    return by_rank[0][0], by_rank[-1][0]     # outermost id, innermost id


def test_witness_flags_inverted_nesting():
    wit = witness_mod.LockWitness(REPO_ROOT)      # no install: pure logic
    outer_id, inner_id = _rank_extremes(wit)
    outer = witness_mod._Wrapped(threading.Lock(), wit, outer_id)
    inner = witness_mod._Wrapped(threading.Lock(), wit, inner_id)
    with inner:                                   # innermost rank first...
        with outer:                               # ...then outermost: bad
            pass
    assert any("rank inversion" in v for v in wit.violations())


def test_witness_accepts_documented_order():
    wit = witness_mod.LockWitness(REPO_ROOT)
    outer_id, inner_id = _rank_extremes(wit)
    outer = witness_mod._Wrapped(threading.Lock(), wit, outer_id)
    inner = witness_mod._Wrapped(threading.Lock(), wit, inner_id)
    with outer:
        with inner:
            pass
    assert wit.violations() == []


def test_witness_reset_thread_clears_stale_hold():
    wit = witness_mod.LockWitness(REPO_ROOT)
    outer_id, inner_id = _rank_extremes(wit)
    abandoned = witness_mod._Wrapped(threading.Lock(), wit, inner_id)
    abandoned.acquire()          # crash-simulation idiom: never released
    wit.reset_thread()
    other = witness_mod._Wrapped(threading.Lock(), wit, outer_id)
    with other:
        pass
    assert wit.violations() == []


# --------------------------------------------------------------- real tree
def test_real_tree_has_zero_unbaselined_findings():
    findings = run(REPO_ROOT)
    bl = Baseline.load(default_baseline_path())
    unbase, _supp, stale = bl.split(findings)
    assert unbase == [], "\n".join(f.render() for f in unbase)
    assert stale == [], f"stale baseline entries: {stale}"


def test_cli_exits_zero_on_real_tree():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout
    assert "0 stale" in proc.stdout


def test_checker_registry_rejects_unknown_name(tmp_path):
    root = _mk_tree(tmp_path, _port({"serve/m.py": "x = 1\n"}))
    with pytest.raises(KeyError):
        run(root, ["no-such-checker"])


# ---------------------------------------------------------- differentials
_SHARED = {
    "serve/inv.py": _LOCK_INVERSION,
    "serve/rogue.py": _LOCK_UNRANKED.replace("Outer", "Outer2"),
    "store/badio.py": _SEAMS,
    "obs/sink.py": "import os\n\n\ndef sync(fd):\n    os.fsync(fd)\n",
    "serve/metrics.py": _METRICS,
    "serve/spans.py": _SPANS,
    "fabric/host.py": _HOST,
    "fabric/cli.py": _CLIENT,
}


@pytest.mark.parametrize("name", ["locks", "seams", "taxonomy", "wire"])
def test_checkers_match_the_reference_on_synthetic_files(tmp_path, name):
    files = {}
    for rel, src in _SHARED.items():
        files[f"src/repro/{rel}"] = src
        files[f"src/repro_torch/{rel}"] = src.replace("repro.fabric",
                                                      "repro_torch.fabric")
    files["src/repro_torch/engine/fold.py"] = _FOLD
    root = _mk_tree(tmp_path, files)
    got = {(f.checker, f.rule, f.symbol) for f in run(root, [name])}
    want = {(f.checker, f.rule, f.symbol) for f in jrun(root, [name])}
    assert got == want
    assert got, f"the synthetic files plant nothing for {name}"


def test_real_tree_reports_the_references_findings_plus_torch_rows():
    def key(f, mapped=False):
        path = f.path.replace("src/repro/", "src/repro_torch/", 1) \
            if mapped else f.path
        return (f.checker, f.rule, path, f.symbol)
    ref = collections.Counter(key(f, True) for f in jrun(REPO_ROOT))
    port = run(REPO_ROOT)
    assert collections.Counter(key(f) for f in port
                               if f.checker != "torch") == ref
    assert sum(ref.values()) == 10
    bl = {(e["checker"], e["rule"], e["path"], e["symbol"])
          for e in Baseline.load(default_baseline_path()).entries}
    assert {key(f) for f in port if f.checker == "torch"} == \
        {k for k in bl if k[0] == "torch"}


def test_tables_share_the_references_lock_ranks_and_spans():
    with open(os.path.join(REPO_ROOT, "ARCHITECTURE.md")) as f:
        arch = f.read()
    with open(os.path.join(REPO_ROOT, TABLES)) as f:
        tables = f.read()
    jranks = jlocks.parse_hierarchy(arch)
    tranks = tlocks.parse_hierarchy(tables)
    shared = set(jranks) & set(tranks)
    assert shared == set(jranks)              # every reference row kept
    assert {k: tranks[k] for k in shared} == jranks
    assert set(tranks) - shared == {"_build._lock"}
    assert ttaxonomy.parse_span_taxonomy(tables) == \
        jtaxonomy.parse_span_taxonomy(arch)


def _nest(mod, wit, pairs):
    """Acquire each (outer, inner) id pair nested, through ``mod``'s
    proxy; the same frames for both packages."""
    for a, b in pairs:
        la = mod._Wrapped(threading.Lock(), wit, a)
        lb = mod._Wrapped(threading.Lock(), wit, b)
        with la:
            with lb:
                pass


def test_witnesses_agree_on_planted_nestings():
    jw = jwitness.LockWitness(REPO_ROOT)
    tw = witness_mod.LockWitness(REPO_ROOT)
    pairs = [("SegmentStore._lock", "StreamingIndexer._mu"),      # inverted
             ("BitmapService._cv", "FabricClient._cv"),            # same rank
             ("FabricClient._append_lock", "ServiceHost._append_lock"),
             ("StreamingIndexer._mu", "SegmentStore._lock"),
             ("Counter._lock", "Tracer._lock"),                    # inverted
             ("BitmapService._elock", "Nobody._lock")]             # unranked
    _nest(jwitness, jw, pairs)
    _nest(witness_mod, tw, pairs)
    assert tw.violations() == jw.violations()
    assert len(tw.violations()) == 4
    assert set(tw.pairs) == set(pairs)


def _factories():
    return threading.Lock, threading.RLock, threading.Condition


def _restore(factories):
    threading.Lock, threading.RLock, threading.Condition = factories


def test_witness_does_not_wrap_reference_locks():
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as tmetrics
    before = _factories()
    wit = witness_mod.LockWitness(REPO_ROOT).install()
    try:
        jc = jmetrics.Counter("x_total")
        tc = tmetrics.Counter("x_total")
    finally:
        wit.uninstall()
    assert not isinstance(jc._lock, witness_mod._Wrapped)
    assert isinstance(tc._lock, witness_mod._Wrapped)
    assert tc._lock.lock_id == "Counter._lock"
    assert _factories() == before


_FUT = """\
    import concurrent.futures
    import threading


    class Fut:
        def __init__(self):
            self._ev = threading.Event()
            self._lock = threading.Lock()
            self._fut = concurrent.futures.Future()
    """


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_witness_leaves_stdlib_locks_under_a_port_frame_unwrapped(tmp_path):
    """``threading.Event`` and ``concurrent.futures.Future`` make their
    locks one line from a port lock site: within the ±2-line tolerance of
    the port's ``Fut._lock``.  Only the lock the port line itself creates
    is wrapped.  (The reference's first-frame rule, pointed at the same
    file under ``src/repro``, wraps the Event's condition as
    ``Fut._lock``.)"""
    root = _mk_tree(tmp_path, {"src/repro_torch/fabric/fut.py": _FUT,
                               "src/repro/fabric/fut.py": _FUT,
                               "src/repro_torch/engine/fold.py": _FOLD})
    tmod = _load(os.path.join(root, "src/repro_torch/fabric/fut.py"),
                 "_synthetic_port_fut")
    wit = witness_mod.LockWitness(root).install()
    try:
        fut = tmod.Fut()
    finally:
        wit.uninstall()
    assert isinstance(fut._lock, witness_mod._Wrapped)
    assert fut._lock.lock_id == "Fut._lock"
    for inner in (fut._ev._cond, fut._ev._cond._lock, fut._fut._condition):
        assert not isinstance(inner, witness_mod._Wrapped), inner

    jmod = _load(os.path.join(root, "src/repro/fabric/fut.py"),
                 "_synthetic_ref_fut")
    before = _factories()       # a session witness (REPRO_LOCK_WITNESS=1)
    jw = jwitness.LockWitness(root).install()
    try:
        jfut = jmod.Fut()
    finally:
        jw.uninstall()
        _restore(before)
    assert getattr(jfut._ev._cond, "lock_id", None) == "Fut._lock"


def test_witness_composes_with_the_reference_witness():
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as tmetrics
    before = _factories()       # a session witness (REPRO_LOCK_WITNESS=1)
    jw = jwitness.LockWitness(REPO_ROOT).install()
    try:
        ref_factories = _factories()
        tw = witness_mod.LockWitness(REPO_ROOT).install()
        try:
            jc = jmetrics.Counter("y_total")
            tc = tmetrics.Counter("y_total")
            with jc._lock:
                pass
            with tc._lock:
                pass
        finally:
            tw.uninstall()
        assert _factories() == ref_factories
    finally:
        jw.uninstall()
        _restore(before)
    assert _factories() == before
    assert isinstance(jc._lock, jwitness._Wrapped)
    assert jc._lock.lock_id == "Counter._lock"
    assert isinstance(tc._lock, witness_mod._Wrapped)
    assert tc._lock.lock_id == "Counter._lock"
    assert jw.violations() == [] and tw.violations() == []


# ------------------------------------------------- the witness on the CPU
M, W, BLOCK = 16, 4, 96


def _blocks(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, M, (BLOCK, W), dtype=np.int32)
            for _ in range(n)]


def _wave():
    from repro_torch.engine import planner as tp
    k = tp.key
    return [k(1), k(2) & ~k(3), k(4) | k(5), (k(6) | k(7)) & k(8),
            ~k(9), k(10) & k(11) & ~k(12)]


def test_witness_over_storm_spill_and_fabric_on_the_cpu(tmp_path):
    """The service storm, a durable session whose spills run on the
    maintenance thread, and a loopback fabric's waves and exactly-once
    append, all under the installed port witness: no violation, the
    service's and store's locks wrapped, and the client's append lock
    observed held while the host's is taken (the loopback runs the host
    handler on the calling thread)."""
    from repro_torch.db import BitmapDB
    from repro_torch.engine import planner as tp
    from repro_torch.fabric import FabricClient, ShardMap
    from repro_torch.fabric.envelope import Envelope
    blocks = _blocks(7, 4)
    wave = _wave()
    wit = witness_mod.LockWitness(REPO_ROOT).install()
    try:
        db = BitmapDB(num_keys=M, device="cpu")
        for b in blocks:
            db.append_encoded(b)
        want = [tp.execute(db.index.packed, q, num_records=db.num_records,
                           backend="ref") for q in wave]
        svc = db.serve(max_batch=8, max_delay_ms=1.0)
        bad = []

        def submit():
            for _ in range(2):
                futs = [svc.submit(q) for q in wave]
                for (row, cnt), (wrow, wcnt) in zip(
                        (f.result(timeout=60) for f in futs), want):
                    if not (torch.equal(row, wrow) and int(cnt) == int(wcnt)):
                        bad.append(1)
        threads = [threading.Thread(target=submit) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert svc.drain(timeout=60)
        wrapped = {"BitmapService._cv": svc._cv,
                   "BitmapService._elock": svc._elock}
        svc.close(timeout=60)
        assert not bad

        ddb = BitmapDB(num_keys=M, path=str(tmp_path / "d"),
                       spill_records=BLOCK, device="cpu")
        dsvc = ddb.serve(maintenance=True)
        for b in blocks:
            ddb.append_encoded(b)          # the spill goes to the worker
            dsvc.submit(wave[1]).result(timeout=60)
            assert dsvc._maint_ex.flush(timeout=120)
        stats = dsvc._maint_ex.stats()
        wrapped.update({
            "MaintenanceExecutor._cv": dsvc._maint_ex._cv,
            "StreamingIndexer._mu": ddb._si._mu,
            "SegmentStore._flush_lock": ddb.store._flush_lock,
            "SegmentStore._lock": ddb.store._lock})
        dsvc.close(timeout=60)
        assert stats["completed"].get("spill", 0) >= 3 and \
            not stats["errors"], stats

        half = 2 * BLOCK
        dbs = []
        for s in range(2):
            sdb = BitmapDB(num_keys=M, device="cpu")
            for b in blocks[2 * s:2 * s + 2]:
                sdb.append_encoded(b)
            dbs.append(sdb)
        gids = [np.arange(s * half, (s + 1) * half, dtype=np.int64)
                for s in range(2)]
        fc = FabricClient.local(dbs, ShardMap.blocked(2, block_size=half),
                                gids=gids, max_batch=8, max_delay_ms=1.0)
        try:
            got = [f.result(timeout=60) for f in fc.submit_many(wave)]
            assert [int(c) for _, c in got] == [int(c) for _, c in want]
            shard = int(fc.shardmap.route(blocks[0][:1],
                                          start_gid=fc.num_records)[0])
            n = fc.append_encoded(blocks[0])
            seq = fc._next_seq[shard]
            dup = fc._shard_request(shard, Envelope("append", payload={
                "stream": fc._stream, "seq": seq,
                "records": np.asarray(blocks[0], np.int32)}), hedge=False)
            wrapped.update({"FabricClient._flush_lock": fc._flush_lock,
                            "ServiceHost._append_lock":
                                fc._owned_hosts[shard]._append_lock})
        finally:
            fc.close(timeout=60)
        assert n == 5 * BLOCK and dup.payload["duplicate"]
    finally:
        wit.uninstall()
    assert wit.violations() == []
    assert wit.pairs
    for lid, lock in wrapped.items():
        assert isinstance(lock, witness_mod._Wrapped) and \
            lock.lock_id == lid, lid
    assert ("FabricClient._append_lock", "ServiceHost._append_lock") in \
        wit.pairs


def test_cli_imports_no_jax_and_no_reference_package():
    """``python -m repro_torch.analysis`` in a fresh interpreter imports
    neither JAX nor the JAX package."""
    code = ("import sys; from repro_torch.analysis.__main__ import main; "
            "rc = main([]); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'torch')); assert not bad, bad; sys.exit(rc)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "0 finding(s)" in out.stdout
