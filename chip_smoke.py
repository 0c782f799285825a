#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero and prints no result):

1. Device and build: the card's name and power limit, the torch/CUDA
   versions, and the build of every kernel under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once), with ``ptxas``'s registers and,
   for ``bit_transpose.cu`` and ``bitmap_ops.cu``, its shared memory and
   spill bytes per kernel.
2. Each kernel against its plain-torch version on the card at ragged
   shapes: the bitmap kernels (N, M, Nw off the block multiples, every
   operand inverted) bit-identical, ``bit_transpose`` also at R = 1, 31,
   33, 1023, 1025, 2^22 + 1 x Cw = 1, 3, 8, 17, at (1025, 12) and on a view
   4 bytes past a 16-byte boundary, ``bitmap_query`` at K = 1, 2, 8, 33 x
   Nw = 1, 3, 1001, 2^20, 2^20 + 3, all rows inverted and mixed, at K = 1030
   and on such a view, ``cam_match`` also with keys over the
   whole int32 range (duplicates, the key sentinel -2, records holding -1
   and values outside the 256-entry table) and at M = 300 and 4096 (16-word
   tables; two key-word ranges); the flash-attention kernels at S = 1, 63,
   65, 127, 129, 300 and 2048, head_dim 32, 64 and 128, H/KV = 1, 4 and 7,
   causal and full, against the plain version in fp32 from the same inputs:
   atol 2e-5 for fp32 inputs (the reference kernel test's); for bf16 inputs
   one bf16 ulp at the output's largest magnitude (2^-7 * max|plain|) and,
   element by element, ``tests/torch_checks.py``'s ``bf16_attn_err``: one
   bf16 ulp of the element plus 2^-12 of its output row's largest
   magnitude, sharp enough to fail P rounded to bf16 before P V.  The
   profiler must see the tensor-core kernel (``flash_fwd_wgmma``) run for
   bf16 at head_dim 128 and the CUDA-core kernel (``flash_fwd_kernel``) for
   fp32.
3. The bitmap main path at the paper's record geometry (W = 32 eight-bit
   words, M = 256 keys): ``BitmapDB(num_keys=256).append_encoded`` of 8
   blocks of 2^22 records (2^25 records, a 1 GiB live index), made from
   ``--seed`` with numpy as uint8 and cast to int32 on the card; then a
   ``query_many`` wave of the 64-predicate serving mix plus a size-guard
   composite (an AND of 8 two-key ORs), served once cold and then
   WARM_WAVES times warm (the warm figure is their total over their count),
   and one single ``query``.  Every kernel's launch counter is zeroed just
   before and read just after; each bitmap kernel must be > 0, and every
   bitmap wave, counted per resolved backend
   (``repro_torch.engine.batch.waves_by_backend``), must have run on
   ``cuda``: a wave on ``ref`` or ``bulk`` would be the plain version.
4. The bitmap path's answers: every row and count bit-identical to the
   port's plain ``ref`` backend on the card, and the streamed index
   identical, block by block, to a plain create_index of the same records.
5. Each bitmap kernel timed at the main path's shapes — its device time
   from ``torch.profiler`` (and the span between two CUDA events beside
   it) — next to its plain version and its bound: the larger of the bytes
   it must move over 3.35e12 B/s and the operations its function needs over
   6.7e13 op/s (the H100 SXM's published memory rate and 32-bit non-tensor
   peak), counted over this run's real work only (no pad query, pad
   literal or identity row).  ``bitmap_query`` is timed over a ring of
   copies four times the L2 (so its inputs come from HBM and its HBM bound
   holds); its record also keeps the L2-resident time (``l2_ms``), which
   is what the path sees.  Then, on lines outside the kernels' record and
   three rounds taken in turn: ``bitmap_query`` on aligned rows and on
   views 4 bytes past a 16-byte boundary, from HBM and L2-resident, at the
   path's pass and at 8 rows of the index (an 8-literal conjunction pass),
   and ``bit_transpose``'s 16-byte and 4-byte copies (an aligned input and
   such a view) at the path's shape.
6. Where the time goes: the card's busy time and idle share over one warm
   wave and over one more block append, with the top kernels by time.
7. The LM serving path: Qwen2-7B at its full published config (28 layers,
   d_model 3584, 28 query / 4 KV heads, head_dim 128, d_ff 18944, vocab
   152064), random weights from ``--seed`` on the card in bf16 with fp32
   norm scales; ``greedy_generate`` of LM_STEPS tokens for LM_BATCH prompts
   of LM_PROMPT random token ids (numpy, from ``--seed``), with every
   launch counter zeroed just before and read just after: the flash kernel
   must run exactly once per layer (one prefill).  Then prefill and decode
   timed apart (a CUDA synchronize around each); the flash kernel at layers
   0 and 27 (q/k/v captured by forward hooks) against its plain version
   by both bf16 checks of phase 2;
   the prefill's last-position logits against a prefill with the plain
   attention swapped in (here only: the package has no switch), in bf16
   and again with the compute dtype set to fp32, each within its LOGIT_TOL
   of their largest magnitude, with argmax equal on every batch row whose
   top-2 margin exceeds that tolerance; the kernel timed at the
   path's shape beside its plain version, ``scaled_dot_product_attention``
   (timed only, as the library yardstick) and its bound (the larger of the
   bytes of q, k, v, o over 3.35e12 B/s and the causal half's
   2*S*(S+1)*hd*B*H flops over 989e12 flop/s, the H100 SXM's dense bf16
   tensor-core peak); and the card's busy time and idle share over one
   prefill and one decode step.  In the profiled prefill the wrapper must
   count one launch per layer and the profiler must see ``flash_fwd_wgmma``
   and no ``flash_fwd_kernel``.  The fp32 logit check runs the CUDA-core
   kernel (fp32 inputs); the bf16 one, and the layer checks, the
   tensor-core kernel.

8. The durable main path at the same geometry: ``BitmapDB(num_keys=256,
   path=<temporary directory>, spill_records=2^22)`` on the card takes the
   phase-3 blocks; blocks 1-7 spill by the threshold as 7 committed
   segments (the store's auto-compaction is switched off, so that they
   stay 8 uniform segments in the end); block 8 is appended with an
   enqueue-only spill hook, ``prepare_spill()`` writes its segment file,
   and the session is dropped before ``commit_spill`` (a crash between the
   file write and the manifest swap).  ``repro_torch.open`` recovers on the
   card (7 segments + block 8 re-indexed from the WAL through
   ``cam_match`` and ``bit_transpose``; the orphan file ignored): the
   recovered index must be bit-identical to phase 3's streamed one.
   ``gc()`` must then collect the orphan and the dead WAL generations,
   ``snapshot()`` commits segment 8, and the store, opened as a
   ``StoredIndex`` of 8 segments of 2^17 words, serves phase 3's wave
   through ``BitmapDB.from_index``: once stacked (one stacked
   ``bulk_program`` launch per bucket, which its launch counter must show)
   and once per segment, every row and count bit-identical to phase 3's
   answers and to the ``ref`` backend.  Prints the durable ingest rate,
   the seconds per WAL append and per segment write (fsync included), the
   recovery seconds, the warm stacked and per-segment wave ms and the
   bytes on disk; the second append, with its threshold spill, runs under
   the profiler (card busy time and idle share); the stacked ``bulk_program`` is timed against its plain
   version and against the 2-D launch per segment.  Needs about 5.2 GiB
   free under the temporary directory (checked first; the phase fails
   with the number of bytes it needs); the directory is removed at the
   end.
9. ``MulticoreRuntime`` on the card (one H100 is one core):
   ``index_stream`` over ticks of (2, 0, 1) blocks of 2^22 records with
   ``calibrate_energy=True``, then one ``run_tick(queries=<the wave>)``,
   whose blocks must be bit-identical to phase 3's index and whose rows
   and counts must be bit-identical to ``ref`` over
   ``fold_block_indexes`` of the same tick.  Prints the measured MB/s
   (paper units: one 8-bit record word per byte) and the ``EnergyReport``:
   the paper's 65-nm SOTB silicon model charged over busy time measured on
   the H100, not the H100's energy.
10. The cost model on the card.  Phases 3-9 run ``auto`` on the port's
   ``cuda`` priors: the script points ``REPRO_TORCH_BITMAP_CALIBRATION`` at
   a file in a temporary directory that does not exist yet.  Then
   ``measure_calibration(device="cuda")`` at the main path's size (2^25
   records x 256 keys; backends ``ref``, ``bulk``, ``cuda``) is saved
   through that env var, read back and printed, profile by profile.  A
   session holding the 8 phase-3 blocks plans phase 3's wave: ``decide``
   must pick ``cuda`` for it at 2^20 words (else the phase fails and prints
   the estimates and terms); the decision over phase 8's ``StoredIndex``
   shape (8 segments x 2^17 words) and ``BitmapDB.explain`` of one
   serving-mix query and of the composite are printed; the wave, served
   again under ``auto`` with the measured calibration, must be
   bit-identical to phase 3's with ``bulk_program`` and ``bitmap_query``
   launched.
11. The service on the card (its energy is the paper's silicon model over
   busy time, not the H100's).  a: ``db.serve(max_batch=256,
   max_delay_ms=2.0, idle_after_ms=200.0)`` over that session, ``warmup``
   of the wave (seconds printed), then 8 submitter threads x 4 rounds of
   the 65-query wave (2080 queries); each thread compares every future
   with phase 3's answer as it resolves and drops it, and its resolve
   sequence must increase; prints queries/s, waves, the mean coalesced
   batch, p50/p99 latency and the active/standby joules, then profiles one
   more round (card busy time, idle share).  b: after the 200 ms idle
   timer the service must be in standby; one submission wakes it (its
   answer phase 3's), and ``make_bitmap_query_step`` over the session
   returns phase 3's rows and counts for the whole wave.  c:
   ``BitmapDB(num_keys=256, path=<temporary directory>,
   spill_records=2^22).serve(maintenance=True)`` takes phase 3's first 4
   blocks through ``append_encoded`` while 4 threads keep submitting the
   wave; every answer must equal phase 3's row cut to the record count its
   wave saw, at least 3 spills must complete in the background with no
   error, and after ``close()`` ``repro_torch.open`` must recover phase
   3's first 2^24 records bit for bit; prints each append's wall time
   beside phase 8's synchronous WAL and ``write_segment`` seconds.  Needs
   about 3.1 GiB free (checked first).  Every service phase, the one-shot
   step's own service included, fails unless the ladder counters (degraded
   waves, fallback queries, wave retries, isolated failures, deadline
   rejections) read 0, the breaker is closed and the bitmap kernels'
   launch counters are above 0 (``cam_match`` and ``bit_transpose`` too in
   11c).

Phase 2 also holds the stacked ``bulk_program`` launch against its plain
version at ``tests/torch_checks.py``'s ``STACKED_CASES`` (S = 1, 3, 8,
ragged Nw, Q past 65535, every literal inverted).  Each path (phases 3,
8, 9) is driven with every launch counter set to 0 just before it and read
just after; so is each of phases 10 and 11's runs (11b's wake and one-shot
step together).  Each of those runs also fails unless every bitmap wave it
served ran on ``cuda``, counted per backend like the launches.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and the result JSON.
"""
import argparse
import atexit
import dataclasses
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_OPS = 67e12            # H100 SXM 32-bit operations outside tensor cores
M, W = 256, 32              # the paper's 32 eight-bit words: 256 key values
BLOCK = 1 << 22             # records per appended block
BLOCKS = 8                  # blocks appended: 2^25 records
WARM_WAVES = 10             # warm waves timed after the cold one
PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core flop/s
LM_ARCH = "qwen2-7b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 32
#: kernel- vs plain-route prefill logits, as a fraction of max|logit|: in
#: bf16 each of the 28 layers rounds its attention output (2^-8 relative)
#: and the residual stream carries the difference on (measured 3.4% in the
#: first run); in fp32 the routes differ by accumulation order only.
LOGIT_TOL = {"bfloat16": 1 / 8, "float32": 1e-3}
STACKED_WAVES = 5           # warm stacked / per-segment waves timed
TICKS = (2, 0, 1)           # phase 9's ticks, in blocks of BLOCK records


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


def device_profile(torch, fn, reps: int = 1, counts: dict | None = None
                   ) -> tuple[float, float, dict]:
    """(host wall ms, card busy ms, {kernel: card ms}) per run of ``fn``,
    from ``torch.profiler``'s CUDA activity over ``reps`` runs (the card's
    own kernel and copy durations, without host gaps).  ``counts``, when
    given, receives {kernel: launches} over all ``reps`` runs."""
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
            if counts is not None:
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return wall, sum(by_name.values()), by_name


def profile(label: str, wall: float, busy: float, by_name: dict) -> dict:
    """Print one profiled run: host wall, card busy, idle share and the top
    kernels by card time; returns the numbers."""
    idle = 1 - busy / wall
    print(f"profile {label}: {wall:.3f} ms host wall (profiler on), "
          f"{busy:.3f} ms card busy, idle share {idle:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print("  top device time: " + "; ".join(f"{k[:60]} {v:.4f} ms"
                                             for k, v in top))
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": idle,
            "top": [[k[:80], v] for k, v in top]}


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS
          ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b):
    """Largest absolute difference: an int for integer tensors, a float
    (compared in fp32) for floating ones."""
    if not a.numel():
        return 0
    if a.is_floating_point():
        return float((a.float() - b.float()).abs().max())
    return int((a.long() - b.long()).abs().max())


def offset_view(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (the kernels' 4-byte path)."""
    v = t.new_empty(t.numel() + 1)[1:].view(t.shape)
    assert v.data_ptr() % 16 == 4
    return v.copy_(t)


def hbm_ring(fn, *args, l2_bytes: int, copy=lambda t: t.clone()):
    """``fn`` over a ring of ``copy``s of ``args``, at least four times the
    L2 in all, so that each call reads its inputs from HBM.  The ring keeps
    each call's result until its slot comes round again, so each call also
    writes to memory that no recent call wrote."""
    per = sum(a.numel() * a.element_size() for a in args)
    n = max(8, -(-4 * l2_bytes // per))
    copies = [[copy(a) for a in args] for _ in range(n)]
    results, calls = [None] * n, itertools.count()

    def call():
        j = next(calls) % n
        results[j] = fn(*copies[j])
        return results[j]
    return call


def in_turn(torch, fns: dict, symbol: str, reps: int, rounds: int = 3
            ) -> dict:
    """Card ms of each of ``fns`` over ``rounds`` rounds that take them in
    turn, ``reps`` calls each: {label: [(ms, ms of the kernels named
    ``symbol`` alone), ...]}."""
    out = {label: [] for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            for _ in range(3):          # the profiler now and then sees none
                _, ms, by_name = device_profile(torch, fn, reps)
                if ms:
                    break
            else:
                raise SystemExit(f"{label}: the profiler saw no device time")
            out[label].append((ms, sum(v for k, v in by_name.items()
                                       if symbol in k)))
    return out


def print_in_turn(title: str, times: dict) -> None:
    print(f"{title} (3 rounds in turn; card ms, min-max, and the kernel "
          f"alone):")
    for label, ts in times.items():
        tot, own = [t for t, _ in ts], [k for _, k in ts]
        print(f"  {label}: {min(tot)}-{max(tot)} ms (kernel alone "
              f"{min(own)}-{max(own)} ms)")


def launches_named(counts: dict, symbol: str) -> int:
    """Launches of the kernels whose profiler name contains ``symbol``."""
    return sum(n for key, n in counts.items() if symbol in key)


def attn_tol(want, dtype) -> float:
    """Kernel-vs-plain tolerance of the flash kernel: the reference test's
    atol for fp32 inputs; for bf16, one bf16 ulp at the output's largest
    magnitude (each side rounds an fp32 result to bf16 once)."""
    import torch
    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -7 * float(want.float().abs().max())


def block_records(seed: int, b: int) -> np.ndarray:
    """Block ``b`` of the run: uint8 words in [0, 256), from the seed."""
    return np.random.default_rng([seed, b]).integers(
        0, 256, (BLOCK, W), dtype=np.uint8)


def timed(obj, name: str, into: list) -> None:
    """Record the seconds of every call of ``obj.name`` into ``into`` (an
    instance attribute shadowing the method, for this run only)."""
    real = getattr(obj, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        into.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, call)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def durable(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
            read_waves, kernel, records, repro_torch, BitmapDB, batch,
            open_index, bitmap_ops, planner) -> dict:
    """Phase 8 (see the module docstring); returns its synchronous WAL
    append and segment write seconds for phase 11c."""
    words_per_seg = BLOCK // 32
    seg_bytes = M * words_per_seg * 4
    # the WAL holds int32 records, every generation until gc; one segment
    # per block; the crashed prepare's orphan; manifests and slack
    need = BLOCKS * BLOCK * W * 4 + (BLOCKS + 1) * seg_bytes + (64 << 20)
    root = tempfile.mkdtemp(prefix="chip_smoke_store-")
    free = shutil.disk_usage(root).free
    if free < need:
        shutil.rmtree(root)
        raise SystemExit(f"durable path: needs {need} bytes free under "
                         f"{root}, {free} are")
    try:
        return _durable(torch, dev, host_blocks, wave, p3, zero_counts,
                        read_counts, read_waves, kernel, records, repro_torch,
                        BitmapDB, batch, open_index, bitmap_ops, planner,
                        root, need, free)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _durable(torch, dev, host_blocks, wave, p3, zero_counts,
             read_counts, read_waves, kernel, records, repro_torch, BitmapDB,
             batch, open_index, bitmap_ops, planner, root, need,
             free) -> dict:
    n_all = BLOCKS * BLOCK
    wal_s, prep_s, seg_s = [], [], []
    zero_counts()
    t0 = time.perf_counter()
    ddb = BitmapDB(num_keys=M, path=root, spill_records=BLOCK, device=dev)
    # fanout-4 compaction would merge each 4 spilled 2^22-record segments
    # into one; off, the store keeps the 8 uniform segments served below
    ddb.store.auto_compact = False
    timed(ddb.store, "log_block", wal_s)
    timed(ddb.store, "prepare_segment", prep_s)
    timed(ddb.store, "write_segment", seg_s)
    append_prof = None
    for i, blk in enumerate(host_blocks[:-1]):
        if i == 1:                         # one append + its spill, traced
            append_prof = profile(
                "durable append of one block with its threshold spill",
                *device_profile(torch, lambda: ddb.append_encoded(blk)))
        else:
            ddb.append_encoded(blk)        # each reaches the threshold
    hooked = []
    ddb.indexer.set_spill_hook(lambda: hooked.append(1))   # enqueue only
    ddb.append_encoded(host_blocks[-1])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_launches = read_counts("cam_match", "bit_transpose")
    committed = len(ddb.store.segments)
    token = ddb.indexer.prepare_spill()    # block 8's segment file
    orphan = token[0].file
    peak_bytes = dir_bytes(root)
    if committed != BLOCKS - 1 or hooked != [1] or ddb.num_records != n_all:
        raise SystemExit(f"durable path: {committed} segments committed, "
                         f"hook calls {hooked}, {ddb.num_records} records")
    del ddb, token                         # dies before commit_spill
    gc.collect()
    print(f"durable ingest: {BLOCKS} appends of {BLOCK} records in "
          f"{ingest_s} s = {n_all / ingest_s} records/s (synchronized; "
          f"{committed} threshold spills inline); WAL append {wal_s} s "
          f"each; segment write (file + fsync) {prep_s} s each, with the "
          f"manifest commit and WAL rotation {seg_s} s each (append 2 of "
          f"{BLOCKS} under the profiler); launches "
          f"{ingest_launches}; crashed with orphan {orphan} on disk, "
          f"{peak_bytes} bytes in the store")

    zero_counts()
    t0 = time.perf_counter()
    rdb = repro_torch.open(root, num_keys=M, device=dev)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    rec_launches = read_counts("cam_match", "bit_transpose")
    if (rdb.num_records != n_all or len(rdb.store.segments) != BLOCKS - 1
            or min(rec_launches.values()) < 1
            or not os.path.exists(os.path.join(root, orphan))):
        raise SystemExit(f"recovery: {rdb.num_records} records, "
                         f"{len(rdb.store.segments)} segments, launches "
                         f"{rec_launches}")
    if not torch.equal(rdb.index.packed, p3["packed"]):
        raise SystemExit("recovery: the recovered index differs from phase "
                         "3's streamed index")
    print(f"recovery: repro_torch.open in {recover_s} s: {BLOCKS - 1} "
          f"segments + block {BLOCKS} re-indexed from the WAL (launches "
          f"{rec_launches}); index bit-identical to phase 3's streamed "
          f"index")
    rdb.store.auto_compact = False
    removed = set(rdb.store.gc())
    dead = {f"wal-{g:08d}.log" for g in range(BLOCKS - 1)}
    if orphan not in removed or not dead <= removed:
        raise SystemExit(f"gc: removed {sorted(removed)}, want the orphan "
                         f"{orphan} and {sorted(dead)}")
    t0 = time.perf_counter()
    rdb.snapshot()                         # commits segment 8
    snap_s = time.perf_counter() - t0
    removed2 = set(rdb.store.gc())
    if (len(rdb.store.segments) != BLOCKS
            or f"wal-{BLOCKS - 1:08d}.log" not in removed2):
        raise SystemExit(f"snapshot: {len(rdb.store.segments)} segments, "
                         f"gc removed {sorted(removed2)}")
    final_bytes = dir_bytes(root)
    print(f"gc: collected the orphan {orphan} and {len(dead)} dead WAL "
          f"generations ({len(removed)} files); snapshot() committed "
          f"segment {BLOCKS} in {snap_s} s; gc after it removed "
          f"{sorted(removed2)}; {final_bytes} bytes on disk (peak "
          f"{peak_bytes}; {free} free before, {need} checked)")
    del rdb
    gc.collect()

    stored = open_index(repro_torch.store.SegmentStore(root), device=dev)
    shapes = {tuple(p.shape) for p, _ in stored.parts}
    if stored.num_segments != BLOCKS or shapes != {(M, BLOCK // 32)}:
        raise SystemExit(f"stored index: {stored.num_segments} segments of "
                         f"{shapes}")
    sdb = BitmapDB.from_index(stored)
    plans = [sdb._plan_for(q) for q in wave]
    buckets, _, _ = batch._partition(plans, M, dev)
    zero_counts()
    rows_s, counts_s = sdb.query_many(wave).materialize()
    torch.cuda.synchronize()
    stacked_launches = read_counts("bulk_program_stacked", "bulk_program",
                                   "bitmap_query")
    stacked_waves = read_waves("stored index, auto wave")
    zero_counts()
    rows_p, counts_p = batch.execute_many_segments(
        stored.parts, plans, backend="cuda", stack_uniform=False)
    torch.cuda.synchronize()
    per_launches = read_counts("bulk_program_stacked", "bulk_program",
                               "bitmap_query")
    per_waves = read_waves("stored index, per-segment wave")
    rows_r, counts_r = batch.execute_many_segments(stored.parts, plans,
                                                   backend="ref")
    print(f"stored index: {BLOCKS} segments x {tuple(shapes)[0]} words; "
          f"{len(buckets)} buckets; launches, stacked wave "
          f"{stacked_launches}, per-segment wave {per_launches}; waves per "
          f"backend {stacked_waves}, {per_waves}")
    if (stacked_launches["bulk_program_stacked"] != len(buckets)
            or stacked_launches["bulk_program"]
            or per_launches["bulk_program"] != len(buckets) * BLOCKS
            or per_launches["bulk_program_stacked"]):
        raise SystemExit("segment waves: want one stacked bulk_program "
                         "launch per bucket stacked, one 2-D launch per "
                         "bucket and segment per segment")
    for label, (r_, c_) in (("stacked", (rows_s, counts_s)),
                            ("per segment", (rows_p, counts_p)),
                            ("ref", (rows_r, counts_r))):
        if not (torch.equal(r_, p3["rows"]) and torch.equal(c_,
                                                            p3["counts"])):
            raise SystemExit(f"segment wave ({label}): rows/counts differ "
                             "from phase 3's answers")
    print(f"segment waves: stacked, per segment and ref — all {len(wave)} "
          "rows and counts bit-identical to phase 3's answers")

    def wave_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STACKED_WAVES):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STACKED_WAVES

    stacked_ms = wave_ms(lambda: sdb.query_many(wave).materialize())
    per_ms = wave_ms(lambda: batch.execute_many_segments(
        stored.parts, plans, backend="cuda", stack_uniform=False))
    print(f"segment waves warm (mean of {STACKED_WAVES}, synchronized): "
          f"stacked {stacked_ms} ms, per segment {per_ms} ms")
    prof = profile("warm stacked segment wave", *device_profile(
        torch, lambda: sdb.query_many(wave).materialize()))

    # the stacked kernel at the path's shape, beside its plain version and
    # the 2-D launch once per segment; bound as bulk_program's, per segment
    aug_s = torch.empty((BLOCKS, M + 1, BLOCK // 32), dtype=torch.int32,
                        device=dev)
    aug_s[:, :M] = torch.stack([p for p, _ in stored.parts])
    aug_s[:, M] = -1
    nrecs = torch.full((BLOCKS,), BLOCK, dtype=torch.int32, device=dev)
    progs = [batch._lowered(pl)[0] for pl in plans
             if not isinstance(pl, planner.CompositePlan)]
    rows_read = {k for prog in progs for grp in prog for lits, _ in grp
                 for k, _ in lits}
    lits = sum(len(ls) for prog in progs for grp in prog for ls, _ in grp)
    passes = sum(len(grp) for prog in progs for grp in prog)
    groups = sum(len(prog) for prog in progs)
    nw = aug_s.shape[2]
    nbytes = (BLOCKS * (len(rows_read) + len(progs)) * nw * 4 + 4 * BLOCKS
              + 4 * (2 * lits + passes))
    ops = BLOCKS * nw * (2 * lits + 2 * passes + groups)
    kernel("bulk_program_stacked", "bitmap_ops.cu",
           "src/repro/kernels/bitmap_ops.py:110",
           f"aug {tuple(aug_s.shape)}, {len(buckets)} buckets (Q, G, P, L) "
           f"{[tuple(b[2].shape) for b in buckets]}, per wave",
           lambda: [bitmap_ops.bulk_program_stacked(aug_s, nrecs, *b[2:])
                    for b in buckets],
           lambda: [bitmap_ops.bulk_program_stacked_plain(aug_s, nrecs,
                                                          *b[2:])
                    for b in buckets],
           nbytes, ops, 10, count=stacked_launches["bulk_program_stacked"])
    per_seg = [aug_s[i] for i in range(BLOCKS)]
    two_d = device_profile(torch, lambda: [
        bitmap_ops.bulk_program(a, *b[2:]) for a in per_seg
        for b in buckets], 10)[1]
    records[-1]["per_segment_2d_ms"] = two_d
    print(f"  the 2-D launch once per segment over the same wave: {two_d} "
          f"ms on the card ({len(buckets) * BLOCKS} launches)")
    print(json.dumps({"durable_path": {
        "records": n_all, "blocks": BLOCKS, "ingest_s": ingest_s,
        "ingest_records_per_s": n_all / ingest_s, "wal_append_s": wal_s,
        "segment_file_s": prep_s, "segment_write_commit_s": seg_s,
        "recover_s": recover_s, "snapshot_s": snap_s,
        "bytes_peak": peak_bytes, "bytes_final": final_bytes,
        "stacked_wave_ms": stacked_ms, "per_segment_wave_ms": per_ms,
        "stacked_launches": stacked_launches,
        "per_segment_launches": per_launches, "buckets": len(buckets),
        "waves": {"stacked": stacked_waves, "per_segment": per_waves},
        "append_profile": append_prof, "profile": prof}}))
    del aug_s, per_seg, stored, sdb, rows_s, rows_p, rows_r
    batch._AUG_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"wal_append_s": wal_s, "segment_file_s": prep_s,
            "segment_write_commit_s": seg_s}


def runtime_path(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
                 read_waves, truntime, BICConfig, batch, policy) -> None:
    """Phase 9 (see the module docstring)."""
    keys = torch.arange(M, dtype=torch.int32, device=dev)
    cfg = BICConfig(num_keys=M, num_records=BLOCK, words_per_record=W)
    rt = truntime.MulticoreRuntime([dev], cfg, calibrate_energy=True)
    nxt = iter(range(BLOCKS))

    def tick(b):                           # b blocks, uint8 on the card
        if b == 0:
            return None
        return torch.from_numpy(np.stack([host_blocks[next(nxt)]
                                          for _ in range(b)])).to(dev)

    ticks = [tick(b) for b in TICKS]
    zero_counts()
    outs, rep = rt.index_stream(ticks, keys, 1.0)
    torch.cuda.synchronize()
    b = 0
    for out in outs:
        for blk in out:
            want = policy.extract_packed(p3["packed"], b * BLOCK, BLOCK)
            if not torch.equal(blk, want):
                raise SystemExit(f"index_stream: block {b} differs from "
                                 "phase 3's index")
            b += 1
    stream_mbps = rt.measured_mbps
    qtick = tick(2)
    res = rt.run_tick(qtick, keys, 1.0, queries=wave)
    torch.cuda.synchronize()
    launches = read_counts("cam_match", "bit_transpose", "bulk_program",
                           "bitmap_query")
    waves = read_waves("runtime path")
    for i, blk in enumerate(res.indexes):  # the query tick's own build
        want = policy.extract_packed(p3["packed"], (b + i) * BLOCK, BLOCK)
        if not torch.equal(blk, want):
            raise SystemExit(f"run_tick: block {b + i} differs from phase "
                             "3's index")
    idx = truntime.fold_block_indexes(res.indexes, BLOCK)
    want_r, want_c = batch.execute_many(idx.packed, wave,
                                        num_records=idx.num_records,
                                        backend="ref")
    if not (torch.equal(res.query_rows, want_r)
            and torch.equal(res.query_counts, want_c)):
        raise SystemExit("run_tick: rows/counts differ from ref over "
                         "fold_block_indexes of the tick")
    missing = [k for k, v in launches.items() if not v]
    if missing:
        raise SystemExit(f"runtime path: kernels never launched {missing}")
    report = {f: getattr(rt.report, f) for f in (
        "active_joules", "standby_joules", "busy_core_seconds",
        "idle_core_seconds", "batches", "total_joules")}
    print(f"runtime path: index_stream over ticks {TICKS} x {BLOCK} records "
          f"on 1 core (the card), {b} blocks bit-identical to phase 3's; "
          f"measured {stream_mbps} MB/s over the stream (EWMA), "
          f"{res.measured_mbps} MB/s in the query tick ({res.measured_seconds}"
          f" s; paper units: one 8-bit record word per byte); run_tick of "
          f"{len(wave)} queries bit-identical to ref, its blocks {b + 1}-"
          f"{b + 2} to phase 3's index; launches {launches}; waves per "
          f"backend {waves}")
    print(f"energy (the paper's 65-nm SOTB silicon model charged over busy "
          f"time measured on the H100, not the H100's energy): stream "
          f"{rep}, runtime total {report}; ledger "
          f"{rt.ledger.snapshot(num_records=b * BLOCK + 2 * BLOCK, num_keys=M)}")
    print(json.dumps({"runtime_path": {
        "ticks": list(TICKS), "block_records": BLOCK,
        "stream_mbps_ewma": stream_mbps, "query_tick_mbps": res.measured_mbps,
        "query_tick_s": res.measured_seconds, "active_cores":
        res.active_cores, "launches": launches, "waves": waves,
        "energy_model_report": report,
        "energy_note": "65-nm SOTB silicon model over busy time measured on "
                       "the H100; not the H100's energy"}}))


SERVICE_ROUNDS = 4          # phase 11a: rounds of the wave per submitter
SERVICE_THREADS = 8         # phase 11a submitters
DURABLE_THREADS = 4         # phase 11c submitters
DURABLE_BLOCKS = 4          # phase 11c: blocks appended under service
#: the trouble counters of the service's fallback ladder: each must stay 0
#: on the measured path (a wave served by ``ref`` or isolated per query
#: would hide the kernels)
LADDER = ("degraded_waves", "fallback_queries", "wave_retries",
          "isolated_failures", "deadline_rejected")


def ladder_clean(svc, label: str) -> dict:
    """The service's ladder counters and breaker; fails unless every
    counter is 0 and the breaker closed."""
    h = svc.health()
    got = {k: h[k] for k in LADDER}
    got["breaker"] = h["breaker"]["state"]
    if any(got[k] for k in LADDER) or got["breaker"] != "closed":
        raise SystemExit(f"{label}: the service served around a failure "
                         f"{got}")
    return got


def cost_model_path(torch, dev, host_blocks, wave, mix, composite, p3,
                    zero_counts, read_counts, read_waves, costmodel, BitmapDB,
                    seed: int):
    """Phase 10 (see the module docstring); returns the 2^25-record
    session phase 11 serves."""
    t0 = time.perf_counter()
    cal = costmodel.measure_calibration(
        device=dev, num_records=BLOCKS * BLOCK, num_keys=M,
        backend_names=("ref", "bulk", "cuda"), seed=seed)
    measure_s = time.perf_counter() - t0
    path = costmodel.save_calibration(cal)       # through the env var
    costmodel.set_calibration(None)
    if costmodel.get_calibration(dev) != cal:
        raise SystemExit(f"cost model: {path} did not load back")
    print(f"cost model: measure_calibration(device=cuda, num_records="
          f"{BLOCKS * BLOCK}, num_keys={M}) in {measure_s} s, saved to "
          f"{path} (${costmodel.ENV_PATH}); copy {cal.copy_bytes_per_sec} "
          f"B/s; candidates {costmodel.candidates(device=dev)}")
    for name, prof in cal.profiles:
        print(f"  profile {name}: {prof.words_per_sec} words/s, "
              f"{prof.dispatch_overhead_s} s per dispatch")
    db = BitmapDB(num_keys=M, device=dev)
    for blk in host_blocks:
        db.append_encoded(blk)
    plans = [db._plan_for(q) for q in wave]
    nw = BLOCKS * BLOCK // 32
    dec = costmodel.decide(plans, num_words=nw, num_keys=M, stats=db.stats,
                           device=dev)
    print(f"decide, phase 3's wave of {len(wave)} at {nw} words: "
          f"{dec.backend} (factor {dec.factor}); estimates "
          f"{dict(dec.estimates)}; terms {dict(dec.terms)}")
    if dec.backend != "cuda":
        raise SystemExit("cost model: auto does not pick cuda for phase 3's "
                         f"wave: estimates {dict(dec.estimates)}, terms "
                         f"{dict(dec.terms)}")
    dec8 = costmodel.decide(plans, num_words=BLOCK // 32,
                            num_segments=BLOCKS, num_keys=M, stats=db.stats,
                            device=dev)
    print(f"decide, the same wave over phase 8's StoredIndex ({BLOCKS} "
          f"segments x {BLOCK // 32} words): {dec8.backend}, stack "
          f"{dec8.stack_uniform}; estimates {dict(dec8.estimates)}")
    for label, q in (("one serving-mix query", mix[4]),
                     ("the composite", composite)):
        ex = db.explain(q)
        print(f"explain {label}: backend {ex['backend']}, bucket "
              f"{ex['bucket_shape']}, fallback {ex.get('fallback')}, "
              f"est_matches {ex['est_matches']}, decision "
              f"{ex['decision']}")
    zero_counts()
    rows, counts = db.query_many(wave).materialize()
    torch.cuda.synchronize()
    launches = read_counts("bulk_program", "bitmap_query")
    waves = read_waves("cost model, the auto wave")
    if not (torch.equal(rows, p3["rows"]) and torch.equal(counts,
                                                          p3["counts"])):
        raise SystemExit("cost model: the wave under auto differs from "
                         "phase 3's answers")
    if min(launches.values()) < 1:
        raise SystemExit(f"cost model: the auto wave launched {launches}")
    print(f"auto wave under the measured calibration: {len(wave)} rows and "
          f"counts bit-identical to phase 3's; launches {launches}; waves "
          f"per backend {waves}")
    print(json.dumps({"cost_model": {
        "measure_s": measure_s, "platform": cal.platform,
        "copy_bytes_per_sec": cal.copy_bytes_per_sec,
        "profiles": {n: dataclasses.asdict(p) for n, p in cal.profiles},
        "wave_decision": {"backend": dec.backend, "factor": dec.factor,
                          "estimates": dict(dec.estimates)},
        "segments_decision": {"backend": dec8.backend,
                              "stack_uniform": dec8.stack_uniform,
                              "estimates": dict(dec8.estimates)},
        "auto_wave_launches": launches, "auto_wave_waves": waves}}))
    del rows, counts
    return db


def _submitters(n: int, body) -> tuple[list, list, list]:
    """``n`` threads (not started) running ``body(t, seqs, bad)``; returns
    (threads, the resolve sequences each appends to, the failures list)."""
    import threading
    seqs, bad = [[] for _ in range(n)], []

    def run(t):
        try:
            body(t, seqs[t], bad)
        except BaseException as e:        # noqa: BLE001 — reported below
            bad.append((t, repr(e)))
    threads = [threading.Thread(target=run, args=(t,)) for t in range(n)]
    return threads, seqs, bad


def service_path(torch, dev, db, host_blocks, wave, mix, p3, zero_counts,
                 read_counts, read_waves, repro_torch, BitmapDB, tstep,
                 policy, records, sync_times: dict) -> None:
    """Phase 11 (see the module docstring)."""
    # ---- 11a. the storm
    svc = db.serve(max_batch=256, max_delay_ms=2.0, idle_after_ms=200.0)
    t0 = time.perf_counter()
    warm = svc.warmup(wave)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"service: warmup {warm} dispatches in {warm_s} s (candidates "
          f"{repro_torch.engine.costmodel.candidates(device=dev)})")
    p3_rows, p3_counts = p3["rows"], p3["counts"].tolist()

    def storm(rounds: int) -> tuple[float, list, list]:
        """SERVICE_THREADS submitters, ``rounds`` rounds of the wave each,
        every future compared with phase 3's answer as it resolves and
        then dropped; returns (seconds, resolve sequences, failures)."""
        def body(t, seqs, bad):
            for r in range(rounds):
                futs = [(i, svc.submit(q)) for i, q in enumerate(wave)]
                for i, f in futs:
                    row, cnt = f.result(timeout=600)
                    if not (torch.equal(row, p3_rows[i])
                            and int(cnt) == p3_counts[i]):
                        bad.append((t, r, i))
                    seqs.append(f.resolve_seq)
                del futs
        threads, seqs, bad = _submitters(SERVICE_THREADS, body)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        if any(th.is_alive() for th in threads):
            raise SystemExit("service storm: a submitter hung")
        return time.perf_counter() - t0, seqs, bad

    zero_counts()
    storm_s, seqs, bad = storm(SERVICE_ROUNDS)
    if not svc.drain(timeout=600):
        raise SystemExit("service storm: the drain hung")
    torch.cuda.synchronize()
    launches = read_counts("bulk_program", "bitmap_query")
    waves = read_waves("service storm")
    n_q = SERVICE_THREADS * SERVICE_ROUNDS * len(wave)
    m = svc.metrics()
    ladder = ladder_clean(svc, "service storm")
    if bad or m.served != n_q or any(s != sorted(s) for s in seqs):
        raise SystemExit(f"service storm: {len(bad)} answers differ from "
                         f"phase 3's ({bad[:5]}), served {m.served} of "
                         f"{n_q}, or a thread's futures resolved out of "
                         "order")
    if min(launches.values()) < 1:
        raise SystemExit(f"service storm: launches {launches}")
    for rec in records:
        if rec["name"] in launches:
            rec["service_launches"] = {"11a": launches[rec["name"]]}
    print(f"service storm: {SERVICE_THREADS} threads x {SERVICE_ROUNDS} "
          f"rounds of the {len(wave)}-query wave = {n_q} queries in "
          f"{storm_s} s = {n_q / storm_s} queries/s; all bit-identical to "
          f"phase 3's answers, each thread's futures in order; served "
          f"{m.served} in {m.batches} waves (mean coalesced batch "
          f"{m.batch_mean}, max {m.batch_max}); latency p50 "
          f"{m.latency_p50_ms} ms, p99 {m.latency_p99_ms} ms, mean "
          f"{m.latency_mean_ms} ms; ladder {ladder}; launches {launches}; "
          f"waves per backend {waves}")
    print(f"service energy (the paper's 65-nm SOTB silicon model charged "
          f"over busy time on the H100, not the H100's energy): active "
          f"{m.active_joules} J over {m.busy_seconds} s busy + "
          f"{m.awake_idle_seconds} s awake idle, standby {m.standby_joules} "
          f"J over {m.standby_seconds} s; {m.energy_per_query_j} J/query")
    # where the time goes: one more round of every submitter, profiled
    sec = {}

    def one_round():
        sec["s"], _, sec["bad"] = storm(1)
    round_prof = profile(f"one storm round ({SERVICE_THREADS} x {len(wave)} "
                         "queries through the service)",
                         *device_profile(torch, one_round))
    if sec["bad"] or not svc.drain(timeout=600):
        raise SystemExit(f"service storm, profiled round: answers differ "
                         f"from phase 3's {sec['bad'][:5]}")
    storm_m = {"queries": n_q, "storm_s": storm_s, "round_profile":
               round_prof,
               "queries_per_s": n_q / storm_s, "served": m.served,
               "batches": m.batches, "batch_mean": m.batch_mean,
               "batch_max": m.batch_max, "p50_ms": m.latency_p50_ms,
               "p99_ms": m.latency_p99_ms, "mean_ms": m.latency_mean_ms,
               "warmup_dispatches": warm, "warmup_s": warm_s,
               "launches": launches, "waves": waves, "ladder": ladder,
               "active_j": m.active_joules, "standby_j": m.standby_joules,
               "busy_s": m.busy_seconds,
               "awake_idle_s": m.awake_idle_seconds}

    # ---- 11b. standby, wake, and the one-shot step
    t0 = time.perf_counter()
    while svc.state != "standby" and time.perf_counter() - t0 < 30:
        time.sleep(0.01)
    m = svc.metrics()
    if svc.state != "standby" or m.standby_entries < 1:
        raise SystemExit(f"standby: state {svc.state}, entries "
                         f"{m.standby_entries} after {time.perf_counter() - t0}"
                         " s idle")
    time.sleep(0.05)                       # accrue standby time
    zero_counts()                          # the wake and the one-shot step
    row, cnt = svc.submit(mix[4]).result(timeout=120)
    m = svc.metrics()
    if not (torch.equal(row, p3_rows[4]) and int(cnt) == p3_counts[4]) \
            or m.wakes < 1:
        raise SystemExit(f"wake: answer differs from phase 3's or wakes "
                         f"{m.wakes}")
    ladder_clean(svc, "standby")
    svc.close(timeout=300)
    print(f"standby: entered after the idle timer (entries "
          f"{m.standby_entries}), woken by one submission (wakes "
          f"{m.wakes}), its answer phase 3's; active {m.active_joules} J "
          f"over {m.busy_seconds + m.awake_idle_seconds} s = "
          f"{m.active_joules / (m.busy_seconds + m.awake_idle_seconds)} W, "
          f"standby {m.standby_joules} J over {m.standby_seconds} s = "
          f"{m.standby_joules / m.standby_seconds} W (silicon model)")
    step = tstep.make_bitmap_query_step(db)
    rows, counts = step(wave)
    torch.cuda.synchronize()
    step_launches = read_counts("bulk_program", "bitmap_query")
    step_waves = read_waves("wake and make_bitmap_query_step")
    step_ladder = ladder_clean(step.service, "make_bitmap_query_step")
    if not (torch.equal(rows, p3_rows) and torch.equal(counts, p3["counts"])
            ) or min(step_launches.values()) < 1:
        raise SystemExit(f"make_bitmap_query_step: rows/counts differ from "
                         f"phase 3's or launches {step_launches}")
    step.service.close(timeout=60)
    print(f"make_bitmap_query_step: the {len(wave)}-query wave "
          f"bit-identical to phase 3's; ladder {step_ladder}; launches "
          f"(with the wake) {step_launches}; waves per backend "
          f"{step_waves}")
    del rows, counts, step, svc, db
    repro_torch.engine.batch._AUG_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11c. durable under service
    n_dur = DURABLE_BLOCKS * BLOCK
    need = (n_dur * W * 4 + 2 * DURABLE_BLOCKS * M * (BLOCK // 32) * 4
            + (64 << 20))
    root = tempfile.mkdtemp(prefix="chip_smoke_service-")
    free = shutil.disk_usage(root).free
    try:
        if free < need:
            raise SystemExit(f"durable service: needs {need} bytes free "
                             f"under {root}, {free} are")
        durable_m = _durable_service(
            torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
            read_waves, repro_torch, BitmapDB, policy, root, records,
            sync_times)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    durable_m.update(need_bytes=need, free_bytes=free)
    print(json.dumps({"service_path": {"storm": storm_m,
                                       "durable": durable_m}}))


def _durable_service(torch, dev, host_blocks, wave, p3, zero_counts,
                     read_counts, read_waves, repro_torch, BitmapDB, policy,
                     root, records, sync_times: dict) -> dict:
    import threading
    ddb = BitmapDB(num_keys=M, path=root, spill_records=BLOCK, device=dev)
    svc = ddb.serve(maintenance=True)
    p3_rows = p3["rows"]
    done = threading.Event()
    widths = set()

    def serve(t, seqs, bad):
        last = False
        while not last:
            last = done.is_set()           # one more round after the ends
            futs = [(i, svc.submit(q)) for i, q in enumerate(wave)]
            for i, f in futs:
                row, cnt = f.result(timeout=600)
                nw = row.shape[0]          # the words the wave's view held
                want = p3_rows[i][:nw]
                if not (nw * 32 <= f._n and torch.equal(row, want)
                        and int(cnt) == int(policy.popcount(want).sum())):
                    bad.append((t, i, nw, f._n))
                widths.add(nw)
                seqs.append(f.resolve_seq)
            del futs

    threads, seqs, bad = _submitters(DURABLE_THREADS, serve)
    zero_counts()
    for th in threads:
        th.start()
    append_s = []
    for blk in host_blocks[:DURABLE_BLOCKS]:
        t0 = time.perf_counter()
        ddb.append_encoded(blk)            # the spill goes to the worker
        append_s.append(time.perf_counter() - t0)
    done.set()
    for th in threads:
        th.join(900)
    if any(th.is_alive() for th in threads) or not svc.drain(timeout=600):
        raise SystemExit("durable service: a submitter or the drain hung")
    if not svc._maint_ex.flush(timeout=900):
        raise SystemExit("durable service: maintenance did not flush")
    torch.cuda.synchronize()
    launches = read_counts("cam_match", "bit_transpose", "bulk_program",
                           "bitmap_query")
    waves = read_waves("durable service")
    m = svc.metrics()
    st = svc._maint_ex.stats()
    ladder = ladder_clean(svc, "durable service")
    svc.close(timeout=600)
    spills = st["completed"].get("spill", 0)
    if bad or any(s != sorted(s) for s in seqs):
        raise SystemExit(f"durable service: {len(bad)} answers differ from "
                         f"phase 3's masked rows ({bad[:5]}) or a thread's "
                         "futures resolved out of order")
    if spills < 3 or st["errors"] or min(launches.values()) < 1:
        raise SystemExit(f"durable service: {spills} spills, {st['errors']} "
                         f"maintenance errors, launches {launches}")
    for rec in records:
        if rec["name"] in launches:
            rec.setdefault("service_launches", {})["11c"] = \
                launches[rec["name"]]
    print(f"durable service: {DURABLE_BLOCKS} appends of {BLOCK} records "
          f"with the spill in the background, append wall (host, "
          f"unsynchronized) {append_s} s, beside phase 8's synchronous WAL "
          f"append {sync_times['wal_append_s']} s and segment write + "
          f"commit {sync_times['segment_write_commit_s']} s per block; "
          f"{DURABLE_THREADS} submitters served {m.served} queries in "
          f"{m.batches} waves over record counts "
          f"{sorted(w * 32 for w in widths)}, every answer phase 3's row "
          f"masked to its wave's count; latency p50 {m.latency_p50_ms} ms, "
          f"p99 {m.latency_p99_ms} ms; maintenance {st['completed']}, "
          f"{st['errors']} errors, last {st['last']}; ladder {ladder}; "
          f"launches {launches}; waves per backend {waves}")
    del ddb, svc
    gc.collect()
    t0 = time.perf_counter()
    rdb = repro_torch.open(root, num_keys=M, device=dev)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    want = p3["packed"][:, :DURABLE_BLOCKS * BLOCK // 32]
    if rdb.num_records != DURABLE_BLOCKS * BLOCK or not torch.equal(
            rdb.index.packed, want):
        raise SystemExit("durable service: the recovered index differs from "
                         f"phase 3's first {DURABLE_BLOCKS * BLOCK} records")
    print(f"durable service: repro_torch.open after close in {recover_s} s "
          f"({len(rdb.store.segments)} segments): index bit-identical to "
          f"phase 3's first {DURABLE_BLOCKS * BLOCK} records")
    del rdb
    gc.collect()
    return {"append_s": append_s, "served": m.served, "batches": m.batches,
            "p50_ms": m.latency_p50_ms, "p99_ms": m.latency_p99_ms,
            "maintenance": st["completed"], "spills": spills,
            "launches": launches, "waves": waves, "ladder": ladder,
            "recover_s": recover_s,
            "record_counts_seen": sorted(w * 32 for w in widths)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    # phases 3-9 run on the port's "cuda" priors (no calibration file);
    # phase 10 measures one and saves it here, through the port's env var
    cal_dir = tempfile.mkdtemp(prefix="chip_smoke_calibration-")
    atexit.register(shutil.rmtree, cal_dir, True)
    os.environ["REPRO_TORCH_BITMAP_CALIBRATION"] = os.path.join(
        cal_dir, "bitmap_calibration_torch.json")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_checks import (STACKED_CASES, any_int32_cam_inputs,
                              bf16_attn_err, stacked_program_inputs)
    import repro_torch
    from repro_torch.core.bic import BICConfig
    from repro_torch.db import BitmapDB
    from repro_torch.engine import backends, batch, planner, policy
    from repro_torch.engine import runtime as truntime
    from repro_torch.store import open_index
    from repro_torch.kernels import _build, attention, bit_transpose
    from repro_torch.kernels import bitmap_ops, cam_match
    dev = torch.device("cuda")
    wrappers = {"cam_match": cam_match.cam_match,
                "bit_transpose": bit_transpose.bit_transpose,
                "bitmap_query": bitmap_ops.bitmap_query,
                "bulk_program": bitmap_ops.bulk_program}
    # every counted wrapper: all are set to 0 before each path is driven
    counted = {**wrappers,
               "bulk_program_stacked": bitmap_ops.bulk_program_stacked,
               "flash_attention_fwd": attention.flash_attention_fwd}

    wave_base = {}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0
        wave_base.clear()
        wave_base.update(batch.waves_by_backend())
        torch.cuda.synchronize()

    def read_counts(*names):
        return {name: counted[name].launches for name in names}

    def read_waves(label):
        """The bitmap waves per resolved backend since zero_counts(); fails
        unless there was one and every one ran on the kernels."""
        waves = {n: v - wave_base.get(n, 0)
                 for n, v in batch.waves_by_backend().items()
                 if v != wave_base.get(n, 0)}
        if set(waves) != {"cuda"}:
            raise SystemExit(f"{label}: waves per backend {waves}; every "
                             "wave must run on the kernels (cuda)")
        return waves

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    src = None
    for line in report.splitlines():
        if line.startswith("---"):
            src = line[4:].strip()
        if ("registers" in line or line.startswith("---") or (
                src in ("bit_transpose.cu", "bitmap_ops.cu")
                and ("Compiling entry" in line or "spill" in line))):
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

    def cam_pair(n, w, m):
        r, k = (torch.from_numpy(a).to(dev)
                for a in any_int32_cam_inputs(rng, n, w, m))
        return cam_match.cam_match(r, k), cam_match.cam_match_plain(r, k)

    def bulk_pair(a, prog):
        return (bitmap_ops.bulk_program(a, *prog),
                bitmap_ops.bulk_program_plain(a, *prog))

    def transpose_pair(t):
        return (bit_transpose.bit_transpose(t),
                bit_transpose.bit_transpose_plain(t))

    def query_pair(rows, inv):          # rows and count, as one tensor
        return tuple(torch.cat([t.reshape(-1) for t in f(rows, inv)])
                     for f in (bitmap_ops.bitmap_query,
                               bitmap_ops.bitmap_query_plain))

    checks = {
        "cam_match": (cam_match.cam_match(rec, keys37),
                      cam_match.cam_match_plain(rec, keys37)),
        # outlier keys; M = 300 (16-word tables), 4096 (two key-word ranges)
        "cam_match int32 keys W=32 M=300": cam_pair(1000, 32, 300),
        "cam_match int32 keys W=32 M=4096": cam_pair(1000, 32, 4096),
        "cam_match int32 keys W=500 M=37": cam_pair(333, 500, 37),
        "bit_transpose": transpose_pair(x),
        "bitmap_query": query_pair(rows4, inv4),
        "bulk_program": bulk_pair(aug, program((8, 4, 2, 4))),
        # past grid.y's 65535 queries, and a 16384-literal program
        "bulk_program Q=65536": bulk_pair(aug[:, :33].contiguous(),
                                          program((65536, 1, 1, 1))),
        "bulk_program G*P*L=16384": bulk_pair(aug[:, :300].contiguous(),
                                              program((2, 128, 1, 64))),
    }
    # the shapes the redesigned bit_transpose and bitmap_query split on:
    # ragged R and Cw, K past the staged flags, Nw % 4 != 0, and views 4
    # bytes past a 16-byte boundary (bit_transpose's 4-byte copies)
    for r_, cw_ in [*itertools.product((1, 31, 33, 1023, 1025, BLOCK + 1),
                                       (1, 3, 8, 17)), (1025, 12)]:
        checks[f"bit_transpose R={r_} Cw={cw_}"] = transpose_pair(
            words(r_, cw_))
    checks["bit_transpose view"] = transpose_pair(offset_view(words(3000, 8)))
    for k_, nw_, allinv in [*itertools.product(
            (1, 2, 8, 33), (1, 3, 1001, 1 << 20, (1 << 20) + 3),
            (True, False)), (1030, 4100, False)]:
        inv = (torch.ones(k_, dtype=torch.int32, device=dev) if allinv else
               torch.from_numpy(rng.integers(0, 2, k_).astype(np.int32))
               .to(dev))
        checks[f"bitmap_query K={k_} Nw={nw_} "
               f"{'all inverted' if allinv else 'mixed'}"] = query_pair(
            words(k_, nw_), inv)
    checks["bitmap_query view"] = query_pair(
        offset_view(words(3, 4096)),
        torch.tensor([0, 1, 0], dtype=torch.int32, device=dev))
    # the stacked launch: S = 1, 3, 8, ragged Nw and tails, Q past 65535,
    # every literal inverted (the card tests' cases)
    for s_, m_, nw_, shape_, lits_ in STACKED_CASES:
        args_ = [torch.from_numpy(a).to(dev) for a in stacked_program_inputs(
            rng, s_, m_, nw_, shape_, lits_)]
        checks[f"bulk_program_stacked S={s_} M={m_} Nw={nw_} {shape_} "
               f"{lits_}"] = (bitmap_ops.bulk_program_stacked(*args_),
                              bitmap_ops.bulk_program_stacked_plain(*args_))
    torch.cuda.synchronize()
    for name, (got, want) in checks.items():
        if not torch.equal(got, want):
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             "version on ragged shapes")
        print(f"check {name}: bit-identical at ragged shape "
              f"{tuple(got.shape)}")
    del checks
    worst = {}                  # (dtype, hd, check) -> (err / tol, case)
    seqs, groups = (1, 63, 65, 127, 129, 300, 2048), (1, 4, 7)
    for seq, hd, g, causal, dt in itertools.product(
            seqs, (32, 64, 128), groups, (True, False),
            (torch.float32, torch.bfloat16)):
        kvh = 2
        fq, fk, fv = (torch.from_numpy(rng.standard_normal((2, seq, heads, hd))
                                       .astype(np.float32)).to(dev, dt)
                      for heads in (kvh * g, kvh, kvh))
        got = attention.flash_attention_fwd(fq, fk, fv, causal=causal)
        want = attention.flash_attention_fwd_plain(
            fq.float(), fk.float(), fv.float(), causal=causal)
        torch.cuda.synchronize()
        case = f"S={seq} hd={hd} H/KV={g} causal={causal}"
        ratios = {"max": max_abs_err(got, want) / attn_tol(want, dt)}
        if dt == torch.bfloat16:
            ratios["element"] = bf16_attn_err(got, want)
        for check, ratio in ratios.items():
            if not ratio <= 1:
                raise SystemExit(f"flash_attention_fwd: kernel disagrees with "
                                 f"its plain version at {case} {dt}: {check} "
                                 f"check err/tol {ratio}")
            key = (str(dt), hd, check)
            worst[key] = max(worst.get(key, (0.0, "")), (ratio, case))
    for (dt, hd, check), (ratio, case) in sorted(worst.items()):
        print(f"check flash_attention_fwd {dt} hd={hd}: "
              f"{len(seqs) * len(groups) * 2} ragged cases within the {check} "
              f"tolerance, worst err/tol {ratio} at {case}")
    # the profiler must see the kernel the C entry picks
    for dt, want in ((torch.bfloat16, "flash_fwd_wgmma"),
                     (torch.float32, "flash_fwd_kernel")):
        fq, fk, fv = (torch.from_numpy(rng.standard_normal((2, 300, heads, 128))
                                       .astype(np.float32)).to(dev, dt)
                      for heads in (8, 2, 2))
        seen = {}
        device_profile(torch, lambda: attention.flash_attention_fwd(
            fq, fk, fv, causal=True), 1, seen)
        if launches_named(seen, want) != 1 or launches_named(
                seen, "flash_fwd") != 1:
            raise SystemExit(f"flash_attention_fwd {dt} hd=128: profiler saw "
                             f"{seen}, want one {want} launch")
        print(f"check flash_attention_fwd {dt} hd=128: the profiler saw one "
              f"{want} launch")

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

    zero_counts()
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
    waves = read_waves("main path")
    n = db.num_records
    print(f"main path: {n} records x {M} keys, index "
          f"{tuple(db.index.packed.shape)} words; ingest {ingest_s} s "
          f"= {n / ingest_s} records/s; wave of {len(wave)} queries "
          f"{cold_ms} ms cold, {warm_ms} ms warm (mean of {WARM_WAVES}; "
          f"{len(wave) / warm_ms * 1e3} queries/s)")
    print(f"launches on the main path: {launches}; waves per backend "
          f"{waves}")
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
    # phases 8 and 9 hold their answers against phase 3's (phase 6 appends
    # one more block to this session)
    p3 = {"packed": db.index.packed.clone(), "rows": rows, "counts": counts}

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

    def kernel(name, src, line, shape_s, run, plain, nbytes, ops, reps, *,
               count, tol=0, peak_ops=PEAK_OPS, library=None):
        """Check ``run`` against ``plain`` (within ``tol``), time both and
        ``library`` (one PyTorch call of the same function, or None), and
        add the kernel's record; ``count`` is its main-path launch count."""
        got, want = run(), plain()
        if isinstance(got, (tuple, list)):
            got, want = (torch.cat([t.reshape(-1) for t in got]),
                         torch.cat([t.reshape(-1) for t in want]))
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if not err <= tol:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version at {shape_s}: {err} > {tol}")
        _, ms, _ = device_profile(torch, run, reps)
        _, plain_ms, _ = device_profile(torch, plain, 2)
        ev_ms = event_ms(torch, run, reps)
        lib_ms = (device_profile(torch, library, reps)[1]
                  if library is not None else None)
        if not ms or lib_ms == 0:
            raise SystemExit(f"{name}: the profiler saw no device time")
        b_ms, b_by = bound(nbytes, ops, peak_ops)
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": line,
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "event_ms": ev_ms, "shape": shape_s})
        print(f"kernel {name} at {shape_s}: {ms} ms on the card "
              f"({ev_ms} ms between events; plain {plain_ms} ms; "
              f"library {lib_ms} ms; bound {b_ms} ms by {b_by})")

    nrec = rec0.shape[0]
    # The function needs no N*W*M compares: a 256-entry table from a word's
    # value to the packed mask of the keys it equals gives each record's
    # bits with one M/32-word OR per record word.
    kernel("cam_match", "cam_match.cu", "src/repro/kernels/cam_match.py:50",
           f"records {tuple(rec0.shape)} x keys ({M},)",
           lambda: cam_match.cam_match(rec0, keys),
           lambda: cam_match.cam_match_plain(rec0, keys),
           nrec * W * 4 + M * 4 + nrec * M // 8, nrec * W * M // 32, 5,
           count=launches["cam_match"])
    kernel("bit_transpose", "bit_transpose.cu",
           "src/repro/kernels/bit_transpose.py:65", f"{tuple(rm.shape)}",
           lambda: bit_transpose.bit_transpose(rm),
           lambda: bit_transpose.bit_transpose_plain(rm),
           2 * rm.numel() * 4, 0, 10, count=launches["bit_transpose"])
    # On the path the planner has just gathered bitmap_query's rows, so
    # they sit in L2; a ring of copies past the L2 times it from HBM, where
    # its HBM bound holds.  The record also keeps the L2-resident time.
    nw, l2 = qrows.shape[1], torch.cuda.get_device_properties(0).L2_cache_size
    bq, bq_plain = bitmap_ops.bitmap_query, bitmap_ops.bitmap_query_plain
    kernel("bitmap_query", "bitmap_ops.cu",
           "src/repro/kernels/bitmap_ops.py:57",
           f"rows {tuple(qrows.shape)} (one composite pass), from HBM",
           hbm_ring(bq, qrows, qinv, l2_bytes=l2),
           hbm_ring(bq_plain, qrows, qinv, l2_bytes=l2),
           (qrows.shape[0] + 1) * nw * 4 + 8, 3 * qrows.numel(), 20,
           count=launches["bitmap_query"])
    records[-1]["l2_ms"] = device_profile(torch, lambda: bq(qrows, qinv),
                                          20)[1]
    # informational: bitmap_query on aligned rows and on views 4 bytes past
    # a 16-byte boundary, from HBM and from L2, at the path's pass and at an
    # 8-literal conjunction pass
    rows8 = db.index.packed[torch.arange(8, device=dev) * 29 % M]
    inv8 = torch.tensor([0, 1] * 4, dtype=torch.int32, device=dev)
    for rows_, inv_ in ((qrows, qinv), (rows8, inv8)):
        off = offset_view(rows_)
        if not (torch.equal(torch.cat([t.reshape(-1) for t in bq(off, inv_)]),
                            torch.cat([t.reshape(-1) for t in
                                       bq_plain(rows_, inv_)]))):
            raise SystemExit(f"bitmap_query disagrees with its plain "
                             f"version at {tuple(rows_.shape)}")
        k_ = rows_.shape[0]
        b_ms, b_by = bound((k_ + 1) * nw * 4 + 4 * k_ + 4, 3 * rows_.numel())
        print_in_turn(
            f"bitmap_query at rows {tuple(rows_.shape)}, bound {b_ms} ms by "
            f"{b_by}", in_turn(torch, {
                "aligned, from HBM": hbm_ring(bq, rows_, inv_, l2_bytes=l2),
                "view +4 bytes, from HBM": hbm_ring(
                    bq, rows_, inv_, l2_bytes=l2, copy=offset_view),
                "aligned, L2-resident": lambda: bq(rows_, inv_),
                "view +4 bytes, L2-resident": lambda: bq(off, inv_)},
                "bitmap_query_kernel", 20))
    del rows8, off
    # informational: bit_transpose's 16-byte and 4-byte copies
    rm_off = offset_view(rm)
    if not torch.equal(bit_transpose.bit_transpose(rm_off),
                       bit_transpose.bit_transpose(rm)):
        raise SystemExit("bit_transpose: the 4-byte copies disagree")
    print_in_turn(f"bit_transpose at {tuple(rm.shape)}", in_turn(torch, {
        "16-byte copies": lambda: bit_transpose.bit_transpose(rm),
        "4-byte copies": lambda: bit_transpose.bit_transpose(rm_off)},
        "bit_transpose_kernel", 10))
    del rm_off
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
           nbytes, ops, 10, count=launches["bulk_program"])

    # ---- 6. where the time goes -------------------------------------------
    profile("warm wave", *device_profile(
        torch, lambda: db.query_many(wave).materialize()))
    append = device_profile(torch, lambda: db.append_encoded(host_blocks[0]))
    profile(f"one more {BLOCK}-record append", *append)
    print("  index-build kernels in the append: " + "; ".join(
        f"{sym} {sum(ms for k, ms in append[2].items() if sym in k)} ms"
        for sym in ("cam_match_kernel", "bit_transpose_kernel")))
    print(json.dumps({"main_path": {
        "records": n, "keys": M, "words": W, "blocks": BLOCKS,
        "ingest_s": ingest_s, "ingest_records_per_s": n / ingest_s,
        "wave_queries": len(wave), "wave_ms_cold": cold_ms,
        "wave_ms_warm": warm_ms, "warm_waves": WARM_WAVES,
        "launches": launches}}))

    # ---- 7. the LM serving path: Qwen2-7B prefill + decode ----------------
    del db, rows, counts, rows_ref, counts_ref, single, single_ref, aug
    del buckets, rm, rec0, qrows
    batch._AUG_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparam = sum(p.numel() for p in params.parameters())
    print(f"lm: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}): {nparam} parameters "
          f"(config: {cfg.param_count()}), {torch.cuda.memory_allocated()} "
          f"bytes on the card, made in {init_s} s")
    prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    flash_fn = attention.flash_attention_fwd
    zero_counts()
    t0 = time.perf_counter()
    gen = tstep.greedy_generate(params, cfg, prompts, steps=LM_STEPS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    lm_launches = {name: fn.launches for name, fn in wrappers.items()}
    lm_launches["flash_attention_fwd"] = flash_fn.launches
    print(f"lm path: greedy_generate B={LM_BATCH} prompt {LM_PROMPT} "
          f"steps {LM_STEPS}: {gen_s} s (first run), launches {lm_launches}")
    if flash_fn.launches != cfg.num_layers:
        raise SystemExit(f"flash_attention_fwd launched {flash_fn.launches} "
                         f"times in one prefill, want {cfg.num_layers}")
    if gen.shape != (LM_BATCH, LM_STEPS) or not (
            0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size):
        raise SystemExit(f"lm path: bad tokens {tuple(gen.shape)}")

    # prefill and decode timed apart; layers 0 and L-1 captured by hooks
    prefill = tstep.make_prefill_step(cfg, max_len=LM_PROMPT + LM_STEPS)
    decode = tstep.make_decode_step(cfg)
    captured = {}

    def capture(i):
        def hook(module, inputs, output):
            captured[i] = (*inputs, output)
        return hook

    last = cfg.num_layers - 1
    hooks = [params.layers[i].attn_core.register_forward_hook(capture(i))
             for i in (0, last)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for h in hooks:
        h.remove()
    kernel_logits = logits[:, -1, :cfg.vocab_size].float()
    toks = [kernel_logits.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(LM_STEPS - 1):
        logits, cache = decode(params, {"tokens": toks[-1][:, None],
                                        "cache": cache})
        toks.append(logits[:, -1, :cfg.vocab_size].argmax(-1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (LM_STEPS - 1)
    tok_s = LM_BATCH * LM_STEPS / ((prefill_ms
                                    + decode_ms * (LM_STEPS - 1)) / 1e3)
    same = int((torch.stack(toks, 1) == gen).sum())
    print(f"lm timing: prefill {prefill_ms} ms ({LM_BATCH} x {LM_PROMPT} "
          f"tokens), decode {decode_ms} ms/step, {tok_s} generated tokens/s; "
          f"{same}/{gen.numel()} tokens equal to the first run's")

    # the kernel against its plain version at the captured layers
    layer_err = {}
    for i, (cq, ck, cv, cout) in captured.items():
        want = attention.flash_attention_fwd_plain(
            cq.float(), ck.float(), cv.float(), causal=True)
        err, tol = max_abs_err(cout, want), attn_tol(want, cout.dtype)
        elem = bf16_attn_err(cout, want)
        if not (err <= tol and elem <= 1):
            raise SystemExit(f"flash_attention_fwd at layer {i}: {err} > {tol}"
                             f" or element err/tol {elem} > 1")
        layer_err[i] = (err, tol, elem)
    print(f"lm check: flash kernel vs plain at layers 0 and {last} "
          f"(q {tuple(captured[0][0].shape)}, bf16): (max err, its tol, "
          f"element err/tol) {layer_err}")

    # The same prefill with the plain attention swapped in (here only), in
    # the path's bf16 and, for a sharp comparison, with COMPUTE_DTYPE set
    # to fp32 (the weights are cast at use, as the reference does).
    def route_logits(dtype, plain):
        kernel_route = tflash.flash_attention
        if plain:
            tflash.flash_attention = (
                lambda q, k, v, *, causal, **kw:
                attention.flash_attention_fwd_plain(q, k, v, causal=causal))
        tmodel.COMPUTE_DTYPE = dtype
        try:
            out, _ = prefill(params, {"tokens": prompts})
        finally:
            tflash.flash_attention = kernel_route
            tmodel.COMPUTE_DTYPE = torch.bfloat16
        return out[:, -1, :cfg.vocab_size].float()

    logit_checks = {}
    for name, frac in LOGIT_TOL.items():
        dt = getattr(torch, name)
        got = (kernel_logits if dt == torch.bfloat16
               else route_logits(dt, plain=False))
        want = route_logits(dt, plain=True)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        tol = frac * float(want.abs().max())
        top2 = want.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > tol
        agree = got.argmax(-1) == want.argmax(-1)
        if not (err <= tol and bool(agree[decided].all())
                and bool(torch.isfinite(got).all())):
            raise SystemExit(f"lm check {name}: kernel-route logits differ from "
                             f"the plain route: {err} > {tol} or argmax "
                             f"{agree.tolist()} on decided rows "
                             f"{decided.tolist()}")
        logit_checks[name] = {"err": err, "tol": tol,
                                 "argmax_agree": int(agree.sum()),
                                 "rows_decided": int(decided.sum())}
        print(f"lm check {name}: last-position logits, kernel vs plain route: "
              f"max err {err} <= {tol} ({frac} of max "
              f"{float(want.abs().max())}); argmax agrees on "
              f"{int(agree.sum())}/{LM_BATCH} rows ({int(decided.sum())} "
              f"rows with a top-2 margin above the tolerance)")
    del got, want

    # the kernel at the path's shape, beside its plain version and SDPA
    fq, fk, fv, _ = captured[0]
    B_, S_, H_, hd_ = fq.shape
    sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (fq, fk, fv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_err = max_abs_err(sdpa(sq, sk, sv, is_causal=True,
                                enable_gqa=True).transpose(1, 2),
                           captured[0][3])
    print(f"library yardstick scaled_dot_product_attention vs the kernel at "
          f"layer 0: max err {sdpa_err}")
    nbytes = 2 * (fq.numel() + fk.numel() + fv.numel() + fq.numel())
    flops = 2 * S_ * (S_ + 1) * hd_ * B_ * H_
    kernel("flash_attention_fwd", "attention.cu",
           "src/repro/kernels/attention.py:67",
           f"q {tuple(fq.shape)}, k/v {tuple(fk.shape)}, causal, bf16",
           lambda: attention.flash_attention_fwd(fq, fk, fv, causal=True),
           lambda: attention.flash_attention_fwd_plain(fq, fk, fv,
                                                       causal=True),
           nbytes, flops, 5, count=lm_launches["flash_attention_fwd"],
           tol=attn_tol(captured[0][3], torch.bfloat16), peak_ops=PEAK_BF16,
           library=lambda: sdpa(sq, sk, sv, is_causal=True, enable_gqa=True))

    # where the time goes: one prefill, one decode step.  The prefill must
    # launch the flash kernel once per layer (the wrapper's count), all on
    # the tensor cores: the profiler sees flash_fwd_wgmma, never
    # flash_fwd_kernel.
    seen = {}
    flash_fn.launches = 0
    lm_prof = {"prefill": profile(
        f"one prefill ({LM_BATCH} x {LM_PROMPT})", *device_profile(
            torch, lambda: prefill(params, {"tokens": prompts}), 1, seen))}
    flash_kernels = {sym: launches_named(seen, sym)
                     for sym in ("flash_fwd_wgmma", "flash_fwd_kernel")}
    print(f"lm check: the profiled prefill launched the flash wrapper "
          f"{flash_fn.launches} times; the profiler saw {flash_kernels}")
    if (flash_fn.launches != cfg.num_layers or flash_kernels["flash_fwd_kernel"]
            or not flash_kernels["flash_fwd_wgmma"]):
        raise SystemExit(f"prefill: want {cfg.num_layers} flash launches, all "
                         f"tensor-core, saw {flash_fn.launches} and "
                         f"{flash_kernels}")
    lm_prof["prefill"]["flash_kernels"] = flash_kernels
    logits, cache = prefill(params, {"tokens": prompts})
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    lm_prof["decode"] = profile("one decode step", *device_profile(
        torch, lambda: decode(params, {"tokens": nxt, "cache": cache})))
    print(json.dumps({"lm_path": {
        "arch": cfg.name, "params": nparam, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "steps": LM_STEPS, "init_s": init_s,
        "greedy_first_s": gen_s, "prefill_ms": prefill_ms,
        "decode_ms_per_step": decode_ms, "generated_tokens_per_s": tok_s,
        "launches": lm_launches, "logit_checks": logit_checks,
        "profile": lm_prof}}))

    # ---- 8. the durable main path ------------------------------------------
    del params, cache, logits, prefill, decode, captured, fq, fk, fv, sq, sk
    del sv, kernel_logits, prompts, gen
    gc.collect()
    torch.cuda.empty_cache()
    sync_times = durable(torch, dev, host_blocks, wave, p3, zero_counts,
                         read_counts, read_waves, kernel, records,
                         repro_torch, BitmapDB, batch, open_index,
                         bitmap_ops, planner)

    # ---- 9. MulticoreRuntime on the card ---------------------------------
    runtime_path(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
                 read_waves, truntime, BICConfig, batch, policy)

    # ---- 10. the cost model on the card ----------------------------------
    from repro_torch.engine import costmodel
    from repro_torch.serve import step as tstep
    sdb = cost_model_path(torch, dev, host_blocks, wave, mix, composite, p3,
                          zero_counts, read_counts, read_waves, costmodel,
                          BitmapDB, args.seed)

    # ---- 11. the service on the card -------------------------------------
    service_path(torch, dev, sdb, host_blocks, wave, mix, p3, zero_counts,
                 read_counts, read_waves, repro_torch, BitmapDB, tstep,
                 policy, records, sync_times)

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
