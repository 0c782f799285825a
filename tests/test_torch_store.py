"""The port's durable store (``repro_torch.store``), its durable session
(``BitmapDB(path=)``, ``repro_torch.open``, ``snapshot``) and
segment-parallel serving (``execute_many_segments``) against the JAX
package, on the CPU.

* Formats: an array file and a WAL written by one package read back in the
  other, both ways; corruption and torn tails are detected.
* Cross-recovery: a store written by one package — with a WAL tail and an
  orphan segment — opens in the other with the same packed words, schema
  and record count.
* Crash windows (the reference's ``tests/test_store.py``), each scenario run
  through both packages from the same seeded inputs: the outcomes (packed
  words, record counts, which step raised) must be identical.
* Fault scenarios (the reference's ``tests/test_fault_chaos.py``), each run
  through both packages, each faulted by its own injector built from the
  same ``FaultPlan`` JSON: the directory, gc, the retried store and the
  injector's events must be identical.
* ``execute_many_segments``, stacked and per segment, against the
  reference's.
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

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.db import Column as JColumn  # noqa: E402
from repro.db import Schema as JSchema  # noqa: E402
from repro.engine import backends as jbackends  # noqa: E402
from repro.engine import batch as jbatch  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro.engine.runtime import StreamingIndexer as JSI  # noqa: E402
from repro.store import SegmentStore as JStore  # noqa: E402
from repro.store import format as jfmt  # noqa: E402
from repro.store import wal as jwal  # noqa: E402
from repro_torch.db import BitmapDB as TDB  # noqa: E402
from repro_torch.db import Column as TColumn  # noqa: E402
from repro_torch.db import Schema as TSchema  # noqa: E402
from repro_torch.db.session import open_db as topen  # noqa: E402
from repro_torch.engine import backends as tbackends  # noqa: E402
from repro_torch.engine import batch as tbatch  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine.runtime import StreamingIndexer as TSI  # noqa: E402
from repro_torch.fault import FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from repro_torch.store import CorruptFileError  # noqa: E402
from repro_torch.store import SegmentStore as TStore  # noqa: E402
from repro_torch.store import format as tfmt  # noqa: E402
from repro_torch.store import open_index as topen_index  # noqa: E402
from repro_torch.store import wal as twal  # noqa: E402


def u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


# ------------------------------------------------------------ formats
@pytest.mark.parametrize("writer,reader", [(jfmt, tfmt), (tfmt, jfmt)])
def test_array_file_crosses_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    arrays = {"packed": rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint32),
              "keys": np.arange(9, dtype=np.int32),
              "f": np.linspace(0, 1, 5, dtype=np.float32)}
    path = str(tmp_path / "x.seg")
    writer.write_array_file(path, arrays, meta={"segment_id": 3, "n": 7})
    out, meta = reader.read_array_file(path)
    assert meta == {"segment_id": 3, "n": 7}
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k], v)
        assert out[k].dtype == v.dtype
    # the port's int32 words reach disk as the reference's uint32 bits
    words = torch.from_numpy(arrays["packed"].view(np.int32))
    tfmt.write_array_file(str(tmp_path / "t.seg"),
                          {"packed": words.numpy().view(np.uint32)})
    jfmt.write_array_file(str(tmp_path / "j.seg"),
                          {"packed": arrays["packed"]})
    assert ((tmp_path / "t.seg").read_bytes()
            == (tmp_path / "j.seg").read_bytes())


@pytest.mark.parametrize("damage,match", [
    ("flip", "CRC"), ("truncate", None), ("junk", "magic"),
    ("stump", "preamble")])
def test_array_file_corruption_detected(tmp_path, damage, match):
    path = str(tmp_path / "x.seg")
    tfmt.write_array_file(path, {"a": np.arange(64, dtype=np.uint32)})
    raw = bytearray(open(path, "rb").read())
    if damage == "flip":
        raw[-5] ^= 0x10
    elif damage == "truncate":
        raw = raw[: len(raw) // 2]
    elif damage == "junk":
        raw = bytearray(b"JUNKJUNKJUNK")
    else:
        raw = bytearray(tfmt.ARRAY_MAGIC + b"\x01\x00")
    open(path, "wb").write(bytes(raw))
    for fmt in (tfmt, jfmt):             # both packages refuse it alike
        with pytest.raises(Exception, match=match) as ei:
            fmt.read_array_file(path)
        assert type(ei.value).__name__ == "CorruptFileError"


@pytest.mark.parametrize("writer,reader", [(jwal, twal), (twal, jwal)])
def test_wal_crosses_packages_and_torn_tail(tmp_path, writer, reader):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "wal.log")
    w = writer.WriteAheadLog(path)
    b1 = rng.integers(0, 99, (4, 3)).astype(np.int32)
    b2 = rng.integers(0, 99, (7, 3)).astype(np.int32)
    w.append_block(b1, 0)
    w.append_block(b2, 4, tick=5)
    w.close()
    got = reader.replay(path)
    assert [(s, r.shape, str(r.dtype), t) for s, r, t in got] == [
        (0, (4, 3), "int32", None), (4, (7, 3), "int32", 5)]
    np.testing.assert_array_equal(got[0][1], b1)
    np.testing.assert_array_equal(got[1][1], b2)
    with open(path, "r+b") as f:          # torn tail: cut mid-entry
        f.truncate(os.path.getsize(path) - 9)
    for mod in (twal, jwal):
        got = mod.replay(path)
        assert len(got) == 1
        np.testing.assert_array_equal(got[0][1], b1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_crosses_packages(tmp_path, writer):
    from repro.store import manifest as jman
    from repro_torch.store import manifest as tman
    w, r = (jman, tman) if writer == "jax" else (tman, jman)
    segs = tuple(w.SegmentMeta(i, f"seg-{i:08d}.seg", 64 * i, 64, 12)
                 for i in range(3))
    m = w.Manifest(version=4, segments=segs, wal_generation=3,
                   next_segment_id=5, last_tick=7, last_tick_blocks=2)
    w.commit(str(tmp_path), m)
    got = r.load(str(tmp_path))
    assert got.to_json() == m.to_json()
    assert got.durable_records == 192
    names = sorted(os.listdir(tmp_path))
    r.commit(str(tmp_path), r.Manifest(**{**got.__dict__, "version": 5}))
    assert w.load(str(tmp_path)).version == 5
    assert names == ["CURRENT", "MANIFEST-00000004.json"]


# ------------------------------------------------------- cross-recovery
M = 12
W = 3


def _schema(kind):
    cols = ("a", list(range(6))), ("b", list(range(6, 12)))
    return kind.Schema([kind.Column.categorical(n, v) for n, v in cols])


class _JKind:
    Schema, Column = JSchema, JColumn


class _TKind:
    Schema, Column = TSchema, TColumn


def _rows(rng, n):
    return {"a": rng.integers(0, 6, n).tolist(),
            "b": rng.integers(6, 12, n).tolist()}


def _crashed_store(pkg, path):
    """A durable session written by ``pkg`` that "crashes" with two
    committed segments, a WAL tail, and an orphan segment (prepared, never
    committed).  Returns the never-crashed packed words."""
    rng = np.random.default_rng(11)
    if pkg == "jax":
        db = repro.BitmapDB(_schema(_JKind), path=path, backend="ref",
                            spill_records=64)
    else:
        db = TDB(_schema(_TKind), path=path, backend="ref", spill_records=64,
                 device="cpu")
    for n in (40, 30, 50, 20, 9):        # two threshold spills, then a tail
        db.ingest(_rows(rng, n))
    db.indexer.set_spill_hook(lambda: None)     # enqueue-only
    db.ingest(_rows(rng, 70))
    token = db.indexer.prepare_spill()   # segment file written, never
    assert token is not None             # committed: the process dies
    want = (np.asarray(db.index.packed) if pkg == "jax"
            else db.index.to_numpy()).copy()
    return want, db.num_records, token[0].file


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_recovery(tmp_path, writer):
    path = str(tmp_path / "db")
    want, n, orphan = _crashed_store(writer, path)
    assert os.path.exists(os.path.join(path, orphan))
    if writer == "jax":
        db = repro_torch.open(path, backend="ref", device="cpu")
        got, schema = db.index.to_numpy(), db.schema
        assert schema == _schema(_TKind)
    else:
        db = repro.open(path, backend="ref")
        got, schema = np.asarray(db.index.packed), db.schema
        assert schema == _schema(_JKind)
    assert db.num_records == n == 219
    np.testing.assert_array_equal(got, want)
    assert len(db.store.segments) == 2 and db.store.durable_records == 140
    # the recovering package carries on: gc collects the orphan and the
    # dead WAL generations, snapshot commits the tail (under the id the
    # crashed prepare had claimed), and the other package reopens it
    removed = set(db.store.gc())
    assert {orphan, "wal-00000000.log", "wal-00000001.log"} <= removed
    assert "wal-00000002.log" not in removed      # the live generation
    db.snapshot()
    assert db.store.segments[-1].file == orphan
    assert "wal-00000002.log" in db.store.gc()
    db.store.close()
    if writer == "jax":
        again = repro.open(path, backend="ref")
        got = np.asarray(again.index.packed)
    else:
        again = repro_torch.open(path, backend="ref", device="cpu")
        got = again.index.to_numpy()
    np.testing.assert_array_equal(got, want)
    assert again.store.replay_wal() == []


def _open_errors(pkg, root):
    """The durable session's guard rails in ``pkg``: each step's error
    type, or the record count where it succeeds."""
    if pkg == "jax":
        def db(*a, **kw):
            return repro.BitmapDB(*a, backend="ref", **kw)
        opener, kind = (lambda p, **kw: repro.open(p, backend="ref", **kw),
                        _JKind)
    else:
        def db(*a, **kw):
            return TDB(*a, device="cpu", **kw)
        opener, kind = (lambda p, **kw: repro_torch.open(p, device="cpu",
                                                         **kw), _TKind)
    out = []

    def step(fn, match=None):
        try:
            r = fn()
            out.append(r)
        except Exception as e:      # the type and its message's gist
            assert match is None or match in str(e), (pkg, str(e))
            out.append(type(e).__name__)

    step(lambda: opener(str(root)), "num_keys")
    first = db(num_keys=5, path=str(root))
    first.append_encoded(np.arange(10).reshape(5, 2) % 5)
    step(lambda: db(num_keys=5, path=str(root)), "already holds")
    db(_schema(kind), path=str(root / "s"))
    step(lambda: db(kind.Schema([kind.Column.categorical("z", [1, 2])]),
                    path=str(root / "s")), "different schema")
    step(lambda: opener(str(root), num_keys=5).num_records)
    step(lambda: db(num_keys=5).snapshot(), "no store")
    return out


def test_open_requires_schema_or_num_keys(tmp_path):
    got = _open_errors("torch", tmp_path / "t")
    assert got == ["FileNotFoundError", "ValueError", "ValueError", 5,
                   "RuntimeError"]
    assert got == _open_errors("jax", tmp_path / "j")


# ------------------------------------------------------- crash windows
class Kit:
    """One package's store surface, driven the same way for both."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.Store = JStore if pkg == "jax" else TStore

    def indexer(self, keys):
        if self.pkg == "jax":
            return JSI(jnp.asarray(keys), backend="ref")
        return TSI(keys, backend="ref", device="cpu")

    def restore(self, root, keys):
        if self.pkg == "jax":
            return JSI.restore(self.Store(root), jnp.asarray(keys),
                               backend="ref")
        return TSI.restore(self.Store(root), keys, backend="ref",
                           device="cpu")

    def block(self, a):
        return jnp.asarray(a) if self.pkg == "jax" else a

    def words(self, si):
        idx = si.index
        return (np.asarray(idx.packed) if self.pkg == "jax"
                else idx.to_numpy()).copy()


def _data(seed, sizes, m=11, w=5, hi=32):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, (m,), dtype=np.int32)
    return keys, [rng.integers(0, hi, (n, w), dtype=np.int32)
                  for n in sizes]


def _rebuild(keys, blocks):
    if not blocks:
        return np.zeros((len(keys), 0), np.uint32)
    return np.asarray(jbackends.get_backend("ref").create_index(
        jnp.asarray(np.concatenate(blocks)), jnp.asarray(keys)))


def _spill_cycle(kit, root, sizes, flush):
    keys, blocks = _data(77, sizes)
    si = kit.indexer(keys)
    si.attach_store(kit.Store(root), flush_records=flush)
    for b in blocks:
        si.append(kit.block(b))
    live = kit.words(si)
    si2 = kit.restore(root, keys)
    out = {"live": live, "recovered": kit.words(si2), "n": si2.num_records}
    extra = _data(78, [21])[1][0]
    si2.append(kit.block(extra))
    out["after"] = kit.words(si2)
    out["want"] = _rebuild(keys, blocks + [extra])
    return out


def _torn_tail(kit, root):
    keys, blocks = _data(5, [11, 13])
    st = kit.Store(root)
    si = kit.indexer(keys)
    si.attach_store(st, flush_records=None)
    for b in blocks:
        si.append(kit.block(b))
    wal = st.wal_path()
    with open(wal, "r+b") as f:          # crash mid-append of block 2
        f.truncate(os.path.getsize(wal) - 7)
    si2 = kit.restore(root, keys)
    out = {"n": si2.num_records, "words": kit.words(si2),
           "want": _rebuild(keys, blocks[:1])}
    # appends after the torn-tail recovery survive the next recovery
    extra = _data(6, [9])[1][0]
    si2.append(kit.block(extra))
    si3 = kit.restore(root, keys)
    out["n3"] = si3.num_records
    out["words3"] = kit.words(si3)
    return out


def _orphan(kit, root):
    keys, blocks = _data(7, [9, 14])
    si = kit.indexer(keys)
    si.attach_store(kit.Store(root), flush_records=None)
    for b in blocks:
        si.append(kit.block(b))
    # half-flush: segment file written, manifest never committed
    kit.Store(root).prepare_segment(_rebuild(keys, blocks), 23, 0)
    si2 = kit.restore(root, keys)
    return {"n": si2.num_records, "words": kit.words(si2),
            "want": _rebuild(keys, blocks),
            "gc": sorted(kit.Store(root).gc())}


def _attach_validation(kit, root):
    keys, blocks = _data(8, [10, 11])
    st = kit.Store(root)
    si = kit.indexer(keys)
    si.attach_store(st, flush_records=None)
    si.append(kit.block(blocks[0]))
    si.spill()
    v = st.manifest.version
    si.spill()                           # nothing new: no commit
    out = {"no_commit": st.manifest.version == v}
    for tag, other in (("nonempty", keys), ("keyset", keys[:5])):
        try:
            kit.indexer(other).attach_store(st)
        except ValueError as e:
            out[tag] = "restore" in str(e) or "key set" in str(e)
    # a store with a WAL tail and zero segments cannot be claimed either
    root2 = root + "-tail"
    si = kit.indexer(keys)
    si.attach_store(kit.Store(root2), flush_records=None)
    si.append(kit.block(blocks[1]))
    try:
        kit.indexer(keys).attach_store(kit.Store(root2))
    except ValueError as e:
        out["wal_tail"] = "WAL tail" in str(e)
    out["restored"] = kit.restore(root2, keys).num_records
    return out


def _changed_keys(kit, root):
    keys, blocks = _data(9, [20])
    si = kit.indexer(keys)
    si.attach_store(kit.Store(root), flush_records=None)
    si.append(kit.block(blocks[0]))      # crash with a WAL tail
    try:
        kit.restore(root, keys + 1)
        out = {"raised": False}
    except ValueError as e:
        out = {"raised": "different key set" in str(e)}
    out["n"] = kit.restore(root, keys).num_records
    return out


def _attach_prefix(kit, root):
    keys, blocks = _data(10, [40, 9])
    si = kit.indexer(keys)
    si.append(kit.block(blocks[0]))      # in memory only, no store yet
    st = kit.Store(root)
    si.attach_store(st, flush_records=None)
    out = {"durable": st.durable_records}
    si.append(kit.block(blocks[1]))      # WAL-logged; crash here
    si2 = kit.restore(root, keys)
    out.update(n=si2.num_records, words=kit.words(si2),
               want=_rebuild(keys, blocks))
    return out


def _gc_tmp(kit, root):
    keys, blocks = _data(12, [11])
    si = kit.indexer(keys)
    si.attach_store(kit.Store(root), flush_records=None)
    si.append(kit.block(blocks[0]))
    si.spill()
    with open(os.path.join(root, "seg-00000099.seg.tmp"), "wb") as f:
        f.write(b"half-written")
    with open(os.path.join(root, "CURRENT.tmp"), "wb") as f:
        f.write(b"half")
    removed = sorted(kit.Store(root).gc())
    return {"removed": removed,
            "durable": kit.Store(root).durable_records}


def _compaction(kit, root):
    keys, blocks = _data(13, [7] * 9)
    st = kit.Store(root, compact_fanout=3)
    si = kit.indexer(keys)
    si.attach_store(st, flush_records=None)
    for b in blocks:
        si.append(kit.block(b))
        si.spill()
    out = {"segments": [(s.start_record, s.num_records)
                        for s in st.segments],
           "durable": st.durable_records}
    si2 = kit.restore(root, keys)
    out.update(words=kit.words(si2), want=_rebuild(keys, blocks))
    st2 = kit.Store(root + "-off", auto_compact=False)
    si = kit.indexer(keys)
    si.attach_store(st2, flush_records=None)
    for b in blocks[:6]:
        si.append(kit.block(b))
        si.spill()
    out["kept"] = len(st2.segments)
    out["explicit"] = int(st2.compact())
    out["compacted"] = len(st2.segments)
    return out


CRASH_WINDOWS = {
    "spill-unaligned": lambda k, r: _spill_cycle(k, r, [17, 33, 5, 64, 9],
                                                 40),
    "spill-aligned": lambda k, r: _spill_cycle(k, r, [16, 16, 16], 16),
    "wal-only": lambda k, r: _spill_cycle(k, r, [7, 3, 2], 1000),
    "oversized-block": lambda k, r: _spill_cycle(k, r, [50], 10),
    "torn-wal-tail": _torn_tail,
    "orphan-segment": _orphan,
    "attach-validation": _attach_validation,
    "changed-key-set": _changed_keys,
    "attach-spills-prefix": _attach_prefix,
    "gc-tmp-debris": _gc_tmp,
    "compaction": _compaction,
}


@pytest.mark.parametrize("window", sorted(CRASH_WINDOWS))
def test_crash_window_matches_reference(tmp_path, window):
    run = CRASH_WINDOWS[window]
    got = run(Kit("torch"), str(tmp_path / "t"))
    want = run(Kit("jax"), str(tmp_path / "j"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    # and the port is right on its own terms, not only equal
    if "want" in got:
        final = got.get("after", got.get("words", got.get("recovered")))
        np.testing.assert_array_equal(final, got["want"])
    for k in ("no_commit", "nonempty", "keyset", "wal_tail", "raised"):
        if k in got:
            assert got[k] is True, k


def test_segment_crc_detects_bit_flip(tmp_path):
    """Both packages write the same segment bytes, and both detect the
    same flipped bit."""
    from repro.store import CorruptFileError as JCorrupt
    keys, blocks = _data(14, [40])
    raw = {}
    for pkg, err in (("torch", CorruptFileError), ("jax", JCorrupt)):
        kit, root = Kit(pkg), str(tmp_path / pkg)
        st = kit.Store(root)
        si = kit.indexer(keys)
        si.attach_store(st, flush_records=None)
        si.append(kit.block(blocks[0]))
        si.spill()
        path = st.segment_path(st.segments[0])
        raw[pkg] = bytearray(open(path, "rb").read())
        flipped = bytearray(raw[pkg])
        flipped[-2] ^= 0x04
        open(path, "wb").write(bytes(flipped))
        with pytest.raises(err):
            kit.Store(root).load_packed()
    assert raw["torch"] == raw["jax"]


def test_wal_logs_int32_from_host_without_card_trip(tmp_path):
    """A durable append logs the caller's host array as int32, whatever
    its integer dtype, byte-identical to what the reference logs."""
    rec = np.random.default_rng(3).integers(0, 12, (37, 4), dtype=np.uint8)
    for pkg, root in (("torch", tmp_path / "t"), ("jax", tmp_path / "j")):
        if pkg == "torch":
            db = TDB(num_keys=M, path=str(root), spill_records=None,
                     device="cpu")
        else:
            db = repro.BitmapDB(num_keys=M, path=str(root), backend="ref",
                                spill_records=None)
        db.append_encoded(rec)
        db.store.close()
    logs = [open(tmp_path / p / "wal-00000000.log", "rb").read()
            for p in ("t", "j")]
    assert logs[0] == logs[1]
    (_, got, _), = twal.replay(str(tmp_path / "t" / "wal-00000000.log"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, rec.astype(np.int32))


# ------------------------------------------------------- fault scenarios
# Each scenario runs through both packages, each faulted by ITS OWN
# injector built from the same FaultPlan JSON; the observable outcome (the
# directory after the fault, what gc collects, the store after the retry,
# the injector's events) must be identical, and the port must also hold the
# scenario's own invariants.
class FaultKit:
    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "jax":
            from repro import fault as jfault
            self.Store, self.fmt, self.fault = JStore, jfmt, jfault
        else:
            from repro_torch import fault as tfault
            self.Store, self.fmt, self.fault = TStore, tfmt, tfault

    def injector(self, plan_json):
        return self.fault.FaultInjector(
            self.fault.FaultPlan.from_json(plan_json))


def _packed(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (M, 2), dtype=np.uint32)


def _events(inj):
    return [(e["site"], e["kind"], e["occurrence"],
             os.path.basename(e["path"])) for e in inj.events]


def _fault_write_then_retry(kit, root, plan_json, seed, log_first):
    """Fault one segment write, gc, retry: everything a caller observes."""
    store = kit.Store(root, auto_compact=False)
    packed = _packed(seed)
    if log_first:
        rng = np.random.default_rng(seed)
        store.log_block(rng.integers(0, M, (64, W), dtype=np.int32), 0)
    out = {}
    with kit.injector(plan_json) as inj:
        try:
            store.write_segment(packed, 64, 0)
            out["raised"] = None
        except OSError as e:
            out["raised"] = type(e).__name__
    out["events"] = _events(inj)
    out["listing"] = sorted(os.listdir(root))
    out["segments_after_fault"] = len(store.segments)
    out["gc"] = sorted(store.gc())
    out["listing_after_gc"] = sorted(os.listdir(root))
    meta = store.write_segment(packed, 64, 0)   # the flush lock is free
    out["meta"] = (meta.file, meta.start_record, meta.num_records)
    out["durable_records"] = store.durable_records
    out["segments"] = [(s.file, s.start_record, s.num_records)
                       for s in store.segments]
    out["words"] = np.asarray(store.read_segment(meta)).copy()
    out["gc_after_retry"] = sorted(store.gc())
    out["want_words"] = packed
    store.close()
    return out


def _both(tmp_path, scenario, *args):
    got = scenario(FaultKit("torch"), str(tmp_path / "t"), *args)
    want = scenario(FaultKit("jax"), str(tmp_path / "j"), *args)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    return got


def test_enospc_mid_prepare_clean_abort(tmp_path):
    plan = FaultPlan((FaultSpec("format.write", "enospc",
                                path_substr="seg-"),)).to_json()
    got = _both(tmp_path, _fault_write_then_retry, plan, 0, False)
    assert got["raised"] and got["events"][0][:2] == ("format.write",
                                                      "enospc")
    assert got["segments_after_fault"] == 0
    assert not [f for f in got["listing"] if f.endswith(".tmp")]
    assert not got["gc"]
    assert got["durable_records"] == 64
    np.testing.assert_array_equal(got["words"], got["want_words"])


def test_torn_segment_write_debris_collected(tmp_path):
    plan = FaultPlan((FaultSpec("format.write", "torn", path_substr="seg-",
                                torn_frac=0.4),)).to_json()
    got = _both(tmp_path, _fault_write_then_retry, plan, 1, False)
    assert got["raised"]
    debris = [f for f in got["listing"] if f.endswith(".tmp")]
    assert len(debris) == 1 and debris[0].startswith("seg-")
    assert debris[0] in got["gc"]
    assert not [f for f in got["listing_after_gc"] if f.endswith(".tmp")]
    np.testing.assert_array_equal(got["words"], got["want_words"])


def test_enospc_mid_commit_manifest_swap(tmp_path):
    plan = FaultPlan((FaultSpec("format.write", "enospc",
                                path_substr="MANIFEST"),)).to_json()
    got = _both(tmp_path, _fault_write_then_retry, plan, 2, True)
    assert got["raised"] and got["segments_after_fault"] == 0
    orphans = [f for f in got["listing"] if f.startswith("seg-")]
    assert orphans and orphans[0] in got["gc"]
    assert got["durable_records"] == 64
    assert got["meta"][0] not in got["gc_after_retry"]
    np.testing.assert_array_equal(got["words"], got["want_words"])


def test_wal_append_enospc_not_acknowledged(tmp_path):
    """An ENOSPC'd WAL append is neither acknowledged nor recovered; the
    appends around it are — and the recovered store equals the
    reference's recovery of the same faulted sequence."""
    rng = np.random.default_rng(9)
    b1, b2, b3 = (rng.integers(0, M, (96, W), dtype=np.int32)
                  for _ in range(3))
    plan_json = FaultPlan((FaultSpec("log.append", "enospc",
                                     path_substr="wal-"),)).to_json()
    root = str(tmp_path / "t")
    db = TDB(num_keys=M, path=root, spill_records=None, device="cpu")
    db.append_encoded(b1)
    with FaultInjector(FaultPlan.from_json(plan_json)) as inj:
        with pytest.raises(OSError):
            db.append_encoded(b2)
    assert db.num_records == 96          # b2 not acked, not spliced
    db.append_encoded(b3)
    db.store.close()
    db2 = topen(root, num_keys=M, device="cpu")
    assert db2.num_records == 192
    want = TDB(num_keys=M, device="cpu")
    want.append_encoded(np.concatenate([b1, b3]))
    np.testing.assert_array_equal(db2.index.to_numpy(),
                                  want.index.to_numpy())
    # the reference, faulted by ITS injector with the same plan, agrees
    from repro.fault import FaultInjector as JInj, FaultPlan as JPlan
    jroot = str(tmp_path / "j")
    jdb = repro.BitmapDB(num_keys=M, path=jroot, backend="ref",
                         spill_records=None)
    jdb.append_encoded(b1)
    with JInj(JPlan.from_json(plan_json)) as jinj:
        with pytest.raises(OSError):
            jdb.append_encoded(b2)
    jdb.append_encoded(b3)
    jdb.store.close()
    assert _events(inj) == _events(jinj)
    np.testing.assert_array_equal(
        np.asarray(repro.open(jroot, num_keys=M, backend="ref")
                   .index.packed), db2.index.to_numpy())
    db2.store.close()


def _occurrence_run(kit, root, plan_json):
    os.makedirs(root)
    inj = kit.injector(plan_json)
    raised = []
    with inj:
        for i in range(4):
            try:
                kit.fmt.write_bytes_atomic(os.path.join(root, f"f{i}"),
                                           b"x" * 64)
                raised.append(False)
            except OSError:
                raised.append(True)
    return {"events": _events(inj), "raised": raised,
            "listing": sorted(os.listdir(root))}


def test_injector_occurrence_determinism(tmp_path):
    plan = FaultPlan((FaultSpec("format.write", "enospc",
                                occurrence=2),)).to_json()
    first = _both(tmp_path / "a", _occurrence_run, plan)
    again = _both(tmp_path / "b", _occurrence_run, plan)
    assert first == again
    assert [e[:3] for e in first["events"]] == [("format.write", "enospc",
                                                 2)]
    assert first["raised"] == [False, True, False, False]
    from repro.fault import FaultPlan as JPlan
    p1, p2 = FaultPlan.random(99), FaultPlan.random(99)
    assert p1 == p2 != FaultPlan.random(100)
    assert FaultPlan.from_json(p1.to_json()) == p1
    # the same seed draws the same plan in both packages
    assert p1.to_json() == JPlan.random(99).to_json()


# --------------------------------------------- segment-parallel serving
def _random_pred(rng, kind, m, depth=3):
    if depth == 0 or rng.random() < 0.3:
        leaf = kind.key(int(rng.integers(0, m)))
        return ~leaf if rng.random() < 0.4 else leaf
    children = tuple(_random_pred(rng, kind, m, depth - 1)
                     for _ in range(int(rng.integers(2, 4))))
    node = kind.And(children) if rng.random() < 0.5 else kind.Or(children)
    return ~node if rng.random() < 0.2 else node


def _preds(kind, m, seed=5):
    rng = np.random.default_rng(seed)
    preds = [_random_pred(rng, kind, m) for _ in range(16)]
    preds.append(kind.key(0) & ~kind.key(0))           # contradiction
    # a size-guard composite (an AND of 8 two-key ORs)
    preds.append(kind.And(tuple(kind.key(2 * i) | kind.key(2 * i + 1)
                                for i in range(8))))
    return preds


@pytest.mark.parametrize("cuts", [
    (64, 64, 64), (60, 61, 60), (1, 90, 90), (32, 149), (181,),
    (96, 96, 96, 96)])
@pytest.mark.parametrize("backend", ["ref", "bulk", "cuda"])
@pytest.mark.parametrize("stack", [True, False])
def test_execute_many_segments_matches_reference(cuts, backend, stack):
    n, m = sum(cuts), 16
    rng = np.random.default_rng(n)
    records = rng.integers(0, 48, (n, 8), dtype=np.int32)
    keys = rng.integers(0, 48, (m,), dtype=np.int32)
    jparts, tparts, at = [], [], 0
    be = jbackends.get_backend("ref")
    for c in cuts:
        p = np.array(be.create_index(jnp.asarray(records[at:at + c]),
                                       jnp.asarray(keys)))
        jparts.append((jnp.asarray(p), c))
        tparts.append((torch.from_numpy(p.view(np.int32)), c))
        at += c
    want_r, want_c = jbatch.execute_many_segments(
        jparts, _preds(jplanner, m), backend="ref", stack_uniform=stack)
    got_r, got_c = tbatch.execute_many_segments(
        tparts, _preds(tplanner, m), backend=backend, stack_uniform=stack)
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # and against the port over the spliced-together index
    full = tbackends.get_backend("ref").create_index(
        torch.from_numpy(records), torch.from_numpy(keys))
    r, c = tbatch.execute_many(full, _preds(tplanner, m), num_records=n,
                               backend="ref")
    assert torch.equal(got_r, r) and torch.equal(got_c, c)


@pytest.mark.parametrize("stack", [True, False])
def test_segment_wave_seam_and_spans(stack):
    """The ``engine.dispatch`` seam aborts a segment wave before any
    bucket runs; with a tracer installed every bucket dispatch records a
    ``bucket.dispatch`` span (one per bucket stacked, one per bucket and
    segment otherwise)."""
    from repro_torch.fault import InjectedFault
    from repro_torch.obs import trace as ttrace
    rng = np.random.default_rng(6)
    parts = [(torch.from_numpy(rng.integers(0, 2 ** 32, (6, 4),
                                            dtype=np.uint32)
                               .view(np.int32)), 128) for _ in range(3)]
    k = tplanner.key
    preds = [k(0) & ~k(1), k(2), k(3) | k(4)]
    plan = FaultPlan((FaultSpec("engine.dispatch", "dispatch_error"),))
    with FaultInjector(plan) as inj:
        with pytest.raises(InjectedFault):
            tbatch.execute_many_segments(parts, preds, backend="cuda",
                                         stack_uniform=stack)
        assert len(inj.events) == 1
    tracer = ttrace.Tracer()
    ttrace.install(tracer)
    try:
        got = tbatch.execute_many_segments(parts, preds, backend="cuda",
                                           stack_uniform=stack)
    finally:
        ttrace.uninstall(tracer)
    spans = [sp for sp in tracer.spans() if sp.name == "bucket.dispatch"]
    assert len(spans) == (3 if stack else 9)
    assert all(sp.attrs.get("segments") == (3 if stack else None)
               for sp in spans)
    want = tbatch.execute_many_segments(parts, preds, backend="ref")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_stacked_launch_serves_uniform_segments_in_one_call(monkeypatch):
    """Uniform word counts on the cuda backend: one stacked bulk_program
    call per bucket covers every segment (its plain version here)."""
    from repro_torch.kernels import bitmap_ops
    calls = []
    real = bitmap_ops.bulk_program_stacked_plain

    def spy(aug, nrecs, *rest):
        calls.append(tuple(aug.shape))
        return real(aug, nrecs, *rest)

    monkeypatch.setattr(bitmap_ops, "bulk_program_stacked_plain", spy)
    rng = np.random.default_rng(4)
    parts = [(torch.from_numpy(rng.integers(0, 2 ** 32, (6, 4),
                                            dtype=np.uint32)
                               .view(np.int32)), n) for n in (128, 128, 100)]
    parts = [(p if n == 128 else p & torch.tensor([-1, -1, -1, 15],
                                                  dtype=torch.int32), n)
             for p, n in parts]
    k = tplanner.key
    preds = [k(0) & ~k(1), k(2), k(3) | k(4), k(5)]
    r, c = tbatch.execute_many_segments(parts, preds, backend="cuda")
    assert calls == [(3, 7, 4)] * 3              # three bucket shapes
    want = tbatch.execute_many_segments(parts, preds, backend="ref",
                                        stack_uniform=False)
    assert torch.equal(r, want[0]) and torch.equal(c, want[1])


def test_empty_and_stored_index_sessions(tmp_path):
    from repro.store import open_index as jopen_index
    stored = topen_index(TStore(str(tmp_path / "empty")), device="cpu")
    assert stored.num_records == 0 and stored.num_segments == 0
    k = tplanner.key
    rows, counts = stored.query_many([k(0), k(3) & ~k(1)], backend="ref")
    assert rows.shape == (2, 0) and counts.tolist() == [0, 0]
    jk = jplanner.key
    jrows, jcounts = jopen_index(JStore(str(tmp_path / "jempty"))).query_many(
        [jk(0), jk(3) & ~jk(1)], backend="ref")
    assert tuple(jrows.shape) == tuple(rows.shape)
    assert np.asarray(jcounts).tolist() == counts.tolist()
    # a spilled durable session served read-only through from_index
    db = TDB(_schema(_TKind), path=str(tmp_path / "db"), spill_records=32,
             device="cpu")
    db.store.auto_compact = False
    rng = np.random.default_rng(8)
    for _ in range(4):
        db.ingest(_rows(rng, 32))
    db.snapshot()
    col = repro_torch.col
    qs = [col("a") == 1, (col("a") == 2) | (col("b") == 7),
          ~(col("b") == 9)]
    want = db.query_many(qs).materialize()
    stored = topen_index(db.store, device="cpu")
    assert stored.num_segments == 4
    ro = TDB.from_index(stored, _schema(_TKind))
    got = ro.query_many(qs).materialize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ro.stats.counts == db.stats.counts
    with pytest.raises(TypeError, match="StoredIndex"):
        ro.index
    np.testing.assert_array_equal(stored.to_bitmap_index().to_numpy(),
                                  db.index.to_numpy())
    # the reference opens the port's store and serves the same answers
    jro = repro.BitmapDB.from_index(jopen_index(JStore(db.store.root)),
                                    _schema(_JKind), backend="ref")
    jcol = repro.col
    jqs = [jcol("a") == 1, (jcol("a") == 2) | (jcol("b") == 7),
           ~(jcol("b") == 9)]
    jr, jc = jro.query_many(jqs).materialize()
    np.testing.assert_array_equal(np.asarray(jr), u32(got[0]))
    np.testing.assert_array_equal(np.asarray(jc), got[1].numpy())
