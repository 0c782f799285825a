#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):

1. Device and build: the card's name and power limit, the torch/CUDA
   versions, and the build of every kernel under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once).
2. Each kernel against its plain-torch version on the card at ragged
   shapes (N, M, Nw off the block multiples, every operand inverted):
   bit-identical.
3. The main path at the paper's record geometry (W = 32 eight-bit words,
   M = 256 keys): ``BitmapDB(num_keys=256).append_encoded`` of 8 blocks of
   2^22 records (2^25 records, a 1 GiB live index), made from ``--seed``
   with numpy as uint8 and cast to int32 on the card; then a ``query_many``
   wave of the 64-predicate serving mix plus a size-guard composite (an AND
   of 8 two-key ORs), served once cold and then WARM_WAVES times warm (the
   warm figure is their total over their count), and one single
   ``query``.  Every kernel's launch counter is zeroed just before and read
   just after; each must be > 0.
4. The main path's answers: every row and count bit-identical to the
   port's plain ``ref`` backend on the card, and the streamed index
   identical, block by block, to a plain create_index of the same records.
5. Each kernel timed at the main path's shapes — its device time from
   ``torch.profiler`` (and the span between two CUDA events beside it) —
   next to its plain version and its bound: the larger of the bytes it
   must move over 3.35e12 B/s and the operations its function needs over
   6.7e13 op/s (the H100 SXM's published memory rate and 32-bit non-tensor
   peak), counted over this run's real work only (no pad query, pad
   literal or identity row).
6. Where the time goes: the card's busy time and idle share over one warm
   wave and over one more block append, with the top kernels by time.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and the result JSON.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_OPS = 67e12            # H100 SXM 32-bit operations outside tensor cores
M, W = 256, 32              # the paper's 32 eight-bit words: 256 key values
BLOCK = 1 << 22             # records per appended block
BLOCKS = 8                  # blocks appended: 2^25 records
WARM_WAVES = 10             # warm waves timed after the cold one


def serving_mix(planner, m: int, count: int, seed: int) -> list:
    """The serving mix of ``benchmarks/run.py``: seven plan-shape families
    over random key ids (single literals, AND chains, OR-of-AND trees,
    pure ORs)."""
    rng = np.random.default_rng(seed)
    key = planner.key

    def k() -> int:
        return int(rng.integers(0, m))

    preds = []
    for i in range(count):
        fam = i % 7
        if fam == 0:
            p = key(k())
        elif fam == 1:
            p = key(k()) & ~key(k())
        elif fam == 2:
            p = key(k()) & key(k()) & ~key(k())
        elif fam == 3:
            p = (key(k()) | key(k())) & key(k())
        elif fam == 4:
            p = (key(k()) | key(k())) & (key(k()) | key(k()))
        elif fam == 5:
            p = key(k()) | key(k()) | key(k())
        else:
            p = ((key(k()) & key(k()) & key(k())) |
                 (key(k()) & key(k()) & key(k())))
        preds.append(p)
    return preds


def event_ms(torch, fn, reps: int) -> float:
    """Median span of ``fn`` in ms between two CUDA events, over ``reps``
    runs after one warm-up.  It includes any gap in which the card waits
    for the host, so for a short kernel it measures the launch path."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(torch, fn, reps: int = 1) -> tuple[float, float, dict]:
    """(host wall ms, card busy ms, {kernel: card ms}) per run of ``fn``,
    from ``torch.profiler``'s CUDA activity over ``reps`` runs (the card's
    own kernel and copy durations, without host gaps)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / reps
    return wall, sum(by_name.values()), by_name


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def block_records(seed: int, b: int) -> np.ndarray:
    """Block ``b`` of the run: uint8 words in [0, 256), from the seed."""
    return np.random.default_rng([seed, b]).integers(
        0, 256, (BLOCK, W), dtype=np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.db import BitmapDB
    from repro_torch.engine import backends, batch, planner, policy
    from repro_torch.kernels import _build, bit_transpose, bitmap_ops
    from repro_torch.kernels import cam_match
    dev = torch.device("cuda")
    wrappers = {"cam_match": cam_match.cam_match,
                "bit_transpose": bit_transpose.bit_transpose,
                "bitmap_query": bitmap_ops.bitmap_query,
                "bulk_program": bitmap_ops.bulk_program}

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or line.startswith("---"):
            print(f"  {line.strip()}")

    # ---- 2. kernels against their plain versions, ragged shapes --------
    rng = np.random.default_rng(args.seed)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 2 ** 32, shape,
                                             dtype=np.uint32)
                                .view(np.int32)).to(dev)

    rec = torch.from_numpy(rng.integers(0, 256, (1000, 7), dtype=np.int32))
    keys37 = torch.from_numpy(rng.integers(0, 256, 37, dtype=np.int32))
    rec, keys37 = rec.to(dev), keys37.to(dev)
    x = words(1000, 3)
    rows4 = words(4, 1001)
    inv4 = torch.ones(4, dtype=torch.int32, device=dev)
    aug = torch.cat([words(13, 1001),
                     torch.full((1, 1001), -1, dtype=torch.int32,
                                device=dev)])

    def program(shape):
        sels = torch.from_numpy(rng.integers(0, 14, shape).astype(np.int32))
        invs = torch.from_numpy(rng.integers(0, 2, shape).astype(np.int32))
        post = torch.from_numpy(np.where(rng.random(shape[:3]) < 0.3, -1, 0)
                                .astype(np.int32))
        return sels.to(dev), invs.to(dev), post.to(dev)

    def bulk_pair(a, prog):
        return (bitmap_ops.bulk_program(a, *prog),
                bitmap_ops.bulk_program_plain(a, *prog))

    checks = {
        "cam_match": (cam_match.cam_match(rec, keys37),
                      cam_match.cam_match_plain(rec, keys37)),
        "bit_transpose": (bit_transpose.bit_transpose(x),
                          bit_transpose.bit_transpose_plain(x)),
        "bitmap_query": (torch.cat([t.reshape(-1) for t in
                                    bitmap_ops.bitmap_query(rows4, inv4)]),
                         torch.cat([t.reshape(-1) for t in
                                    bitmap_ops.bitmap_query_plain(rows4,
                                                                  inv4)])),
        "bulk_program": bulk_pair(aug, program((8, 4, 2, 4))),
        # past grid.y's 65535 queries, and a 16384-literal program
        "bulk_program Q=65536": bulk_pair(aug[:, :33].contiguous(),
                                          program((65536, 1, 1, 1))),
        "bulk_program G*P*L=16384": bulk_pair(aug[:, :300].contiguous(),
                                              program((2, 128, 1, 64))),
    }
    torch.cuda.synchronize()
    for name, (got, want) in checks.items():
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             "version on ragged shapes")
        print(f"check {name}: bit-identical at ragged shape "
              f"{tuple(got.shape)}")

    # ---- 3. the main path ----------------------------------------------
    t0 = time.perf_counter()
    host_blocks = [block_records(args.seed, b) for b in range(BLOCKS)]
    print(f"data: {BLOCKS} blocks x {BLOCK} records x {W} words "
          f"(uint8) made in {time.perf_counter() - t0:.2f} s")
    mix = serving_mix(planner, M, 64, args.seed + 1)
    key = planner.key
    composite = planner.And(tuple(key(2 * i) | key(2 * i + 1)
                                  for i in range(8)))
    wave = mix + [composite]
    db = BitmapDB(num_keys=M, device=dev)

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for blk in host_blocks:
        db.append_encoded(blk)             # host uint8 -> card -> int32
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, counts = db.query_many(wave).materialize()    # the cold wave
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(WARM_WAVES):
        rows, counts = db.query_many(wave).materialize()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / WARM_WAVES
    single = db.query(mix[4])
    single_count = single.count
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n = db.num_records
    print(f"main path: {n} records x {M} keys, index "
          f"{tuple(db.index.packed.shape)} words; ingest {ingest_s} s "
          f"= {n / ingest_s} records/s; wave of {len(wave)} queries "
          f"{cold_ms} ms cold, {warm_ms} ms warm (mean of {WARM_WAVES}; "
          f"{len(wave) / warm_ms * 1e3} queries/s)")
    print(f"launches on the main path: {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"kernels never launched on the main path: {missing}")

    # ---- 4. the main path's answers --------------------------------------
    rows_ref, counts_ref = db.query_many(wave, backend="ref").materialize()
    single_ref = db.query_many([mix[4]], backend="ref")[0]
    if not (torch.equal(rows, rows_ref) and torch.equal(counts, counts_ref)
            and torch.equal(single.rows, single_ref.rows)
            and single_count == single_ref.count):
        raise SystemExit("main path: rows/counts differ from the ref backend")
    if rows.shape != (len(wave), n // 32) or int(counts.min()) < 0:
        raise SystemExit(f"main path: bad result shape {tuple(rows.shape)}")
    print(f"answers: {len(wave)} rows + counts and the single query "
          f"bit-identical to the ref backend (composite count "
          f"{int(counts[-1])}, single count {single_count})")
    keys = torch.arange(M, dtype=torch.int32, device=dev)
    plain_create = backends.get_backend("ref").create_index
    for b, blk in enumerate(host_blocks):
        want = plain_create(torch.from_numpy(blk).to(dev), keys)
        got = policy.extract_packed(db.index.packed, b * BLOCK, BLOCK)
        if not torch.equal(got, want):
            raise SystemExit(f"index block {b} differs from plain "
                             "create_index")
    print(f"index: all {BLOCKS} streamed blocks bit-identical to plain "
          "create_index")

    # ---- 5. kernels at the main path's shapes ------------------------------
    rec0 = torch.from_numpy(host_blocks[0]).to(dev).to(torch.int32)
    rm = cam_match.cam_match(rec0, keys)
    aug = batch._augmented(db.index.packed)
    plans = [db._plan_for(q) for q in mix]
    buckets, _, _ = batch._partition(plans, M, dev)
    leaf = planner.plan(composite).parts[0]          # one composite pass
    sel0, inv0 = planner._plan_constants(leaf.clauses, dev)
    qrows, qinv = db.index.packed[sel0[0]], inv0[0]
    records = []

    def kernel(name, src, line, shape_s, run, plain, nbytes, ops, reps):
        got, want = run(), plain()
        if isinstance(got, (tuple, list)):
            got, want = (torch.cat([t.reshape(-1) for t in got]),
                         torch.cat([t.reshape(-1) for t in want]))
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version at {shape_s}")
        _, ms, _ = device_profile(torch, run, reps)
        _, plain_ms, _ = device_profile(torch, plain, 2)
        ev_ms = event_ms(torch, run, reps)
        if not ms:
            raise SystemExit(f"{name}: the profiler saw no device time")
        b_ms, b_by = bound(nbytes, ops)
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": line,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "event_ms": ev_ms, "shape": shape_s})
        print(f"kernel {name} at {shape_s}: {ms} ms on the card "
              f"({ev_ms} ms between events; plain {plain_ms} ms; "
              f"bound {b_ms} ms by {b_by})")

    nrec = rec0.shape[0]
    # The function needs no N*W*M compares: a 256-entry table from a word's
    # value to the packed mask of the keys it equals gives each record's
    # bits with one M/32-word OR per record word.
    print(f"cam_match design floor of this kernel's brute-force compares: "
          f"{bound(0, 2 * nrec * W * M)[0]} ms (2*N*W*M operations)")
    kernel("cam_match", "cam_match.cu", "src/repro/kernels/cam_match.py:50",
           f"records {tuple(rec0.shape)} x keys ({M},)",
           lambda: cam_match.cam_match(rec0, keys),
           lambda: cam_match.cam_match_plain(rec0, keys),
           nrec * W * 4 + M * 4 + nrec * M // 8, nrec * W * M // 32, 5)
    kernel("bit_transpose", "bit_transpose.cu",
           "src/repro/kernels/bit_transpose.py:65", f"{tuple(rm.shape)}",
           lambda: bit_transpose.bit_transpose(rm),
           lambda: bit_transpose.bit_transpose_plain(rm),
           2 * rm.numel() * 4, 0, 10)
    nw = qrows.shape[1]
    kernel("bitmap_query", "bitmap_ops.cu",
           "src/repro/kernels/bitmap_ops.py:57",
           f"rows {tuple(qrows.shape)} (one composite pass)",
           lambda: bitmap_ops.bitmap_query(qrows, qinv),
           lambda: bitmap_ops.bitmap_query_plain(qrows, qinv),
           (qrows.shape[0] + 1) * nw * 4 + 8, 3 * qrows.numel(), 20)
    # bulk_program: every bucket of the wave, timed as one wave.  Its bound
    # counts the real queries' programs only: each distinct key row the
    # wave reads once, one row written per real query, two operations per
    # literal word (xor, and), two per pass (xor, and), one per group (or).
    progs = [batch._lowered(pl)[0] for pl in plans]
    rows_read = {k for prog in progs for grp in prog for lits, _ in grp
                 for k, _ in lits}
    lits = sum(len(ls) for prog in progs for grp in prog for ls, _ in grp)
    passes = sum(len(grp) for prog in progs for grp in prog)
    groups = sum(len(prog) for prog in progs)
    nbytes = ((len(rows_read) + len(progs)) * aug.shape[1] * 4
              + 4 * (2 * lits + passes))
    ops = aug.shape[1] * (2 * lits + 2 * passes + groups)
    shapes = [tuple(b[2].shape) for b in buckets]
    kernel("bulk_program", "bitmap_ops.cu",
           "src/repro/kernels/bitmap_ops.py:110",
           f"aug {tuple(aug.shape)}, {len(buckets)} buckets (Q, G, P, L) "
           f"{shapes}, per wave",
           lambda: [bitmap_ops.bulk_program(aug, *b[2:]) for b in buckets],
           lambda: [bitmap_ops.bulk_program_plain(aug, *b[2:])
                    for b in buckets],
           nbytes, ops, 10)

    # ---- 6. where the time goes -------------------------------------------
    wall, busy, by_name = device_profile(
        torch, lambda: db.query_many(wave).materialize())
    print(f"profile warm wave: {wall:.3f} ms host wall (profiler on), "
          f"{busy:.3f} ms card busy, idle share {1 - busy / wall:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("  top device time: " + "; ".join(f"{k[:60]} {v:.4f} ms"
                                             for k, v in top))
    wall, busy, by_name = device_profile(
        torch, lambda: db.append_encoded(host_blocks[0]))
    print(f"profile one more {BLOCK}-record append: {wall:.3f} ms host wall "
          f"(profiler on), {busy:.3f} ms card busy, idle share "
          f"{1 - busy / wall:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print("  top device time: " + "; ".join(f"{k[:60]} {v:.4f} ms"
                                             for k, v in top))

    print(json.dumps({"main_path": {
        "records": n, "keys": M, "words": W, "blocks": BLOCKS,
        "ingest_s": ingest_s, "ingest_records_per_s": n / ingest_s,
        "wave_queries": len(wave), "wave_ms_cold": cold_ms,
        "wave_ms_warm": warm_ms, "warm_waves": WARM_WAVES,
        "launches": launches}}))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
