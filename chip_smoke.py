#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--mesh-only [--mesh-phases 19,...,24]]

Phases (any failure exits non-zero and prints no result; ``--mesh-only``
runs phase 1, then phase 19 beside an unsharded step of 13a's
configuration, phase 20 beside an unsharded run of phase 7's cell,
phase 21 beside stand-ins for 16a, 17a, 17b and 17c
(``family_references``), phase 22 beside the same step of 13a's
configuration and phases 23 and 24 beside their own unsharded references
(``ssm_references``), for a run on several cards; ``--mesh-phases`` runs
only the ones it names):

1. Device and build: the card's name and power limit, the torch/CUDA
   versions, and the build of every kernel under ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once), with ``ptxas``'s registers and,
   for ``bit_transpose.cu``, ``bitmap_ops.cu`` and the tensor-core flash
   kernels of ``attention.cu``, the kernel's name, shared memory and spill
   bytes.
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
   65, 127, 129, 300 and 2048, head_dim 32, 64, 128 and 256, H/KV = 1, 4
   and 7, causal and full, against the plain version in fp32 from the same
   inputs: atol 2e-5 for fp32 inputs (the reference kernel test's); for
   bf16 inputs
   one bf16 ulp at the output's largest magnitude (2^-7 * max|plain|) and,
   element by element, ``tests/torch_checks.py``'s ``bf16_attn_err``: one
   bf16 ulp of the element plus 2^-12 of its output row's largest
   magnitude, sharp enough to fail P rounded to bf16 before P V.  The C
   entry must launch the tensor-core kernel (``flash_fwd_wgmma``) for
   bf16 at head_dim 128 and 256 and the CUDA-core kernel
   (``flash_fwd_kernel``) for fp32 at both, once and no other (the
   launches it counts at each kernel's launch site,
   ``attention.kernel_launches``), and the profiler must see no other
   flash kernel.
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
   from ``torch.profiler`` (for ``cam_match``, ``bit_transpose`` and
   ``bitmap_query``, one kernel a call, its time over the launches whose
   profiler records carry a time, and that count; and the span between two CUDA events
   beside it) — next to its plain version and its bound: the larger of the bytes
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
   such a view) at the path's shape.  Beside ``bulk_program``'s record
   (row 4, the unmasked form the TPU kernel computes), the same way: the
   counted form the path launches and the plain tail mask + popcount over
   row 4's rows; the wave's buckets ((G, P, L), real and padded Q,
   distinct rows D, row gathers) and the per-bucket read-once floor, (sum
   D + sum padded Q) x Nw x 4 bytes over 3.35e12 B/s.  Every bucket must
   take the staged route in the C entry's plan (``bulk_program_plan``),
   and over a wave of each form the profiler must see no
   ``bulk_gather_kernel`` (it can miss launches, up to all of a session's:
   the count of ``bulk_staged_kernel`` it saw is printed).
6. Where the time goes: the card's busy time and idle share over one warm
   wave and over one more block append, with the top kernels by time; the
   warm wave's elementwise and reduction launches; and the bucket path
   alone, through the ``cuda`` backend's ``run_program``, which must make
   one counted launch a bucket with the plain tail mask and popcount made
   to raise, and, under the profiler, show ``bulk_staged_kernel`` launches
   and memsets only.
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
   (timed only, as the library yardstick; both by CUDA events around 10
   back-to-back calls) and its bound (the larger of the
   bytes of q, k, v, o over 3.35e12 B/s and the causal half's
   2*S*(S+1)*hd*B*H flops over 989e12 flop/s, the H100 SXM's dense bf16
   tensor-core peak); and the card's busy time and idle share over one
   prefill and one decode step.  In the profiled prefill the wrapper must
   count one launch per layer, the C entry launch ``flash_fwd_wgmma``
   alone, and the profiler see no ``flash_fwd_kernel``.  The fp32 logit
   check runs the CUDA-core kernel (fp32 inputs); the bf16 one, and the
   layer checks, the tensor-core kernel.

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
   the profiler (card busy time and idle share); the stacked
   ``bulk_program`` is timed against its plain version and against the
   2-D launch per segment, and, as in phase 5, beside its counted form,
   the plain popcount and the per-bucket read-once floor (both forms on
   ``bulk_staged_kernel`` only, as in phase 5).  Needs about 5.2 GiB
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

12. The shard fabric on the card (``repro_torch.fabric``): the 8 phase-3
   blocks split by ``ShardMap.blocked(4, block_size=2^23)`` (word-aligned,
   so the merge concatenates).  a: ``FabricClient.local`` over 4
   ``BitmapDB(device="cuda")`` sessions in this process, each behind a
   ``BitmapService(max_batch=256, max_delay_ms=2.0)``; phase 3's wave
   through ``submit_many`` (the composite as its predicate tree, so every
   shard lowers it to ``bitmap_query`` again) once cold, 3 times warm and 3
   times count-only, then phase 11a's storm (8 threads x 4 rounds) through
   the fabric, then one wave profiled (card busy time, idle share, top card
   operations).  Every merged row and count must be bit-identical to phase
   3's.  b: ``spawn_shards(4, device="cuda")`` starts 4 worker processes on
   the one card, each ingesting its 2 blocks at spawn (uint8, cast on the
   card); ``FabricClient.connect`` over their sockets runs the same waves
   and storm with the same check; then one exactly-once append of block 0
   under the next seq, the same envelope resent (it must come back
   ``duplicate=True``), and ``info()`` must total 9 x 2^22 records; the
   fleet is closed and every worker must have exited.  Each shard's
   ``health()`` and ``metrics()``, read over the wire, must show the ladder
   counters at 0 and the breaker closed; 12a's launches and waves per
   backend are this process's (zeroed before, read after), 12b's are the
   workers' own, reported in their ``health()`` (``process``: waves per
   backend and launch counters, differenced over the waves and storm) and
   must show every wave on ``cuda`` and the bitmap kernels launched, and the
   append ``cam_match`` and ``bit_transpose`` in its worker.  Prints the
   wave ms (full and count-only), storm queries/s, p50/p99 (submit to
   result, as each submitter sees it), the mean coalesced batch per shard
   and the spawn seconds.

13. The training path on the card.  a: Qwen2-7B at its published width
   (d_model 3584, 28 query / 4 KV heads, head_dim 128, d_ff 18944, vocab
   152064, untied head) with ``num_layers`` cut from 28 to 8 (the cut and
   its reason printed: fp32 master weights, gradients and AdamW moments
   take 16 B a parameter, 16 x 7.6e9 > 80 GB), random fp32 masters from
   ``--seed``, ``remat="full"``.  Batches of 4 x 2048 tokens come from
   ``BitmapIndexedDataset(DataConfig(seq_len=2048, vocab_size=152064, ...),
   device="cuda")`` under ``examples/train_lm.py``'s selection (``key(3) &
   key(18) & ~key(25)``); every launch counter is zeroed before the
   pipeline builds its first batch and read after (the shards' ingest must
   launch ``cam_match`` and ``bit_transpose``, the selection
   ``bitmap_query`` or ``bulk_program``, every wave on ``cuda``).  On
   ROUTE_BATCHES batches the loss and layer 0's ``wq``/``wk``/``wv``
   gradients are held against the same with the plain attention forward
   and backward swapped in (here only), within ROUTE_TOL; layer 7's
   gradients are printed beside them, to show how the routes' difference
   grows with depth.  Then the counters are zeroed again
   around one ``make_train_step`` step, which must launch the forward
   kernel twice a layer (forward and recompute) and the backward kernel
   once a layer, and never the plain versions (that step runs under the
   profiler; the C entry must launch 8 of each tensor-core backward kernel
   and none of the CUDA-core pair, and the profiler see none of that pair
   and no more than those; so must the profiled step below; when the
   profiler records nothing or misses launches the next step, counted
   alike, is profiled, up to three); forward hooks
   capture q, k, v, the output and dout at layers 0 and 7, and the
   backward kernel there is held against its plain version by phase 2's
   backward check, on the step's dout times the power of two that brings
   its RMS nearest 1 (``unit_rms``: exact, and the gradients scale by it
   exactly; at the step's own scale they are so small that ``bwd_tol``'s
   2e-4 floor would pass a kernel that wrote zeros), max|plain| printed
   beside each tolerance.  Then TRAIN_STEPS more steps on that first
   batch (memorized, as in the reference's learning test: the synthetic
   corpus is uniform random tokens, so fresh batches move the loss by less
   than their noise): every loss finite, the last below the first.
   Prints the step ms and tokens/s, the share of 989e12 flop/s the model's
   flops reach (6 N T for the products, 2 N_layers T for the recompute,
   attention's causal forward, recompute and 2.5x backward), the peak
   ``max_memory_allocated``, one AdamW update's card time, one profiled
   step (busy, idle share, top kernels, card time by kernel group), and
   each backward kernel's profiler ms a launch at layer 0's shape, then
   the backward kernel's record: its ms at layer 0's shape (dq, dk and dv
   each within its own ``bwd_tol``, on the unit-RMS dout) beside its
   plain version, its bound (the larger of 2.5 x the causal
   forward's flops over 989e12 flop/s and the bytes of q, k, v, o, dout,
   lse, dq, dk, dv over 3.35e12 B/s) and ``scaled_dot_product_attention``'s
   backward (timed only, the port never calls it; both by CUDA events
   around 10 back-to-back calls).  b: ``train_loop`` of
   ``examples/train_lm_torch.py``'s ~100M-parameter config for 4 steps
   (checkpoints every 2), then a fresh model restarted from the step-2
   checkpoint runs steps 3-4: its step must be the unbroken run's, its
   parameters within 2 lr a step and its AdamW moments within
   RESTART_MOMENT_TOL of each tensor's largest magnitude (bit-identity of
   all three printed); the card's last checkpoint (parameters, moments and
   step) must restore into ``repro_torch`` on the CPU bit for bit.

14. The static analysis and the runtime lock witness
   (``repro_torch.analysis``), after phase 13 has freed its model (phase
   3's rows, counts and index wait on the host meanwhile).  a:
   ``repro_torch.analysis.run`` over this checkout must leave no finding
   outside the committed baseline and no stale baseline entry; the
   findings per checker are printed.  b: ``repro_torch.analysis.witness``
   is installed, then fresh objects are built (a lock made before the
   install stays unwrapped): a ``BitmapDB(num_keys=256, device="cuda")``
   takes the 8 phase-3 blocks and ``serve(max_batch=256,
   max_delay_ms=2.0)`` answers 8 submitters x 1 round of the wave; 11c's
   durable session runs again (4 blocks appended while 4 threads submit,
   at least 3 background spills, recovery, the free disk checked first);
   ``FabricClient.local`` over 4 shards of 2^23 records serves the wave
   once, then takes one exactly-once append and its resend (acknowledged
   ``duplicate=True``).  Every answer must be phase 3's (cut to the
   records its wave saw), the ladder counters 0, every wave on ``cuda``
   and the bitmap kernels' launch counters above 0 in each run.  After
   ``uninstall()`` the witness must hold no violation of the rank table of
   ``src/repro_torch/analysis/TABLES.md``; every observed (outer, inner)
   pair is printed with its first site.  The run fails if the witness was
   vacuous: each of ``WITNESS_LOCKS`` must be a wrapped lock carrying its
   id, and some ``FabricClient`` lock must have been held while a
   shard-side lock (``SHARD_LOCKS``) was taken (the loopback transport
   runs the host handler on the calling thread).  c: the phase's wall
   time, and the storm's queries/s under the witness beside phase 11a's;
   no timed phase runs under the witness.
15. Sliding windows, offsets and the VLM prefix (ROADMAP A10.2), after
   phase 14.  a: Gemma3-4B at its published config (34 layers, d_model
   2560, 8 query / 4 KV heads x 256, d_ff 10240, vocab 262144, GeGLU,
   qk-norm, tied head, window 1024 on every layer but each 6th), random
   bf16 weights from ``--seed``, ``greedy_generate`` of WIN_STEPS tokens
   for WIN_BATCH prompts of WIN_PROMPT = 4096 tokens (the window covers
   under half of a causal row; the decode positions are past it on every
   local layer), every counter zeroed around it: one flash launch a layer
   (34) and the plain versions made to raise.  Prefill and decode timed;
   layers 0 (local), 5 (global) and 33 captured by hooks with the window
   each was given, the kernel there held against its plain version by
   both bf16 checks of phase 2; the prefill's last-position logits against
   the plain route (``plain_routes``, which must receive every layer's
   window) in bf16 and fp32 as in phase 7; the card's busy time and idle
   share over one prefill (whose C entry must launch ``flash_fwd_wgmma``
   alone, once a layer, and whose profile must show no
   ``flash_fwd_kernel``: bf16 at head_dim 256 runs on the tensor cores)
   and one decode step; row 5w
   (the kernel at
   layer 0's shape beside its plain version, SDPA under the window's
   boolean mask, whose kernels are printed, and its bound: the allowed
   pairs x 4 hd flops over 989e12 flop/s against the bytes of q, k, v, o);
   and the kernel at layer 0 beside layer 5 at the same shape, a ratio
   near the allowed pairs' 0.44 when whole tiles outside the window are
   skipped (0.52 on an H100: the run fails above 0.72, halfway to the 1.0
   of a kernel that only masks).  b: Qwen2-VL-7B at its published config, 4 prompts of 2048
   positions whose first 1024 are the visual prefix (fp32 standard normal
   x 0.02 from ``--seed``) with M-RoPE positions on a 32 x 32 grid
   (``torch_checks.grid_positions``; text token j at 32 + j in every
   stream), 32 greedy steps (decode positions pos0 + arange, the
   reference's): 28 flash launches a prefill, the logits against the
   plain route as in a, and the grid must move them past the fp32 route
   tolerance against three equal streams.  c: one windowed training step
   at Gemma3's width, its 34 layers cut to 6 (one local:global period;
   16 B a parameter of fp32 state is 62 GB at 34 layers before
   activations), remat full, 2 x 4096 tokens: the loss and layer 0's
   wq/wk/wv gradients against the plain route within ROUTE_TOL, one step
   counted (12 forward and 6 backward launches, no plain version), one
   timed with its peak memory, one profiled (the C entry launching the
   tensor-core backward pair once a layer and never the CUDA-core pair,
   which the profiler must not see either), the backward kernel at layers 0 and 5
   against its plain version on the step's unit-RMS dout, and row 5bw (the
   backward at layer 0's shape beside its plain version, SDPA's backward
   under the same mask and its bound: 2.5x the forward's flops against the
   bytes of q, k, v, o, dout, lse, dq, dk, dv).
16. The MoE, SSM and hybrid families (ROADMAP A10.3, serving), after phase
   15, each at its published config with random bf16 weights from
   ``--seed``, ``greedy_generate`` of FAMILY_STEPS = 32 tokens for 4
   prompts of 2048 (every counter zeroed around it, the flash wrappers'
   plain versions made to raise), prefill and decode timed, the peak
   memory over those runs, the card's busy time and idle share over one
   prefill and one decode step with the top device operations.  a:
   Qwen2-MoE-A2.7B (24 layers, d_model 2048, 16/16 heads x 128, 60
   experts top-4 of width 1408 plus 4 shared, untied head): 24 flash
   launches a prefill (``flash_fwd_wgmma``); the kernel at layers 0 and 23
   against its plain version by both bf16 checks of phase 2; the
   assignments the capacity dropped per layer (T = 8192, C = 688);
   layer 0's captured MoE input through ``moe_ffn`` in fp32 against its
   per-token dense form (each token the sum over its kept experts of gate
   x expert MLP, every expert applied to every token, ``keep`` from a
   running count of each expert's assignments) within MOE_DENSE_TOL, at
   the config's capacity factor and at MOE_TIGHT_FACTOR; the logits
   against the plain route as in phase 7, with the (token, slot) routings
   that differ between the two routes counted per layer and printed (a
   bf16 route can flip an expert choice near a tie); the kernel at layer
   0's shape beside its plain version and SDPA (record ``flash_attention_fwd
   moe``).  b: Mamba2-2.7B (64 layers, d_model 2560, 80 heads x 64,
   d_state 128, chunk 128, tied head): no flash launch; ``ssd_chunked``
   against the step-by-step ``ssd_sequential`` at layer 0's captured
   input in fp32 within SSD_TOL; a prefill of 2047 tokens plus one decode
   step against a prefill of 2048, the last-position logits within
   STEP_TOL with argmax equal on decided rows (the conv and SSM caches
   carried on the card).  c: Hymba-1.5B (32 layers, d_model 1600, 25/5
   heads x 64 beside 50 SSM heads, window 1024 but on layers 0, 16 and
   31, d_ff 5504): 32 flash launches a prefill; the kernel at layers 1
   (local) and 16 (global) against its plain version; the logits against
   the plain route (which must receive every layer's window); the S - 1
   plus one step check of b; the kernel at layer 1's shape beside its
   plain version and SDPA under the window's boolean mask (record
   ``flash_attention_fwd hybrid``).  The S - 1 check is not made for the
   MoE: there the capacity drops make a prefill and its continuation
   differ by design.
17. The rest of ROADMAP A10.3, after phase 16: the encoder-decoder served
   and trained, and training of the MoE, SSM and hybrid families, each at
   its published width with random weights from ``--seed`` (fp32 master
   weights and AdamW moments in training, 16 B a parameter), the card
   freed between the parts, every figure printed beside the card's name
   and power limit.  a: Whisper-small (12 + 12 layers, d_model 768, 12
   heads x 64) serving 8 segments of 1500 frames (fp32 standard normal x
   0.02; the log-mel frontend is a stub, as in the reference) with
   224-token prompts and 32 greedy steps through ``family_serving``: 36
   flash launches a prefill (12 encoder, 12 self, 12 cross), no plain
   version; prefill and decode timed, busy and idle, the peak memory; the
   kernel against its plain version at decoder layer 0's self-attention,
   the encoder's layer 0 and decoder layer 0's cross-attention (both
   bidirectional, Skv = 1500); the logits and the encoder's output against
   the plain route within LOGIT_TOL in bf16 and fp32; a prefill of 223
   plus one decode step against the prefill of 224 (``step_check``); rows
   5e and 5x (the forward at the encoder's and the cross-attention's
   shapes beside its plain version, SDPA without a mask, and the bound
   4 B H Sq Skv hd / 989e12).  b-e: ``family_training``: on
   TRAIN_ROUTE_BATCHES batches the loss and chosen gradients by three
   routes, split as 13a splits them (kernels; forward kernel with the
   plain backward; plain): the loss kernel vs plain within ROUTE_TOL, the
   gradients kernel vs the mixed route (the backward kernel's share)
   within ROUTE_TOL and, in b and c, kernel vs plain too; every gradient
   finite; one counted step (two forward launches and one backward launch
   a flash module, no plain version), with both kernels held against
   their plain versions at the flash modules it captures
   (``check_captured``); TRAIN_TIMED steps timed (median), tokens/s, the
   peak memory, one step profiled.  b: Whisper-small at full depth, 8 x
   (1500 frames, 448 tokens), layer 0's enc_wq, wq and xattn_wq
   gradients, the encoder's, self- and cross-attention of layer 0
   captured; rows 5be and 5bx (the backward at
   the encoder's and the cross-attention's training shapes on the step's
   unit-RMS dout, beside SDPA's backward; bound 2.5x the forward's flops).
   c: Qwen2-MoE-A2.7B cut to MOE_TRAIN_LAYERS = 4 of 24 layers (2.9e9
   parameters at 24 layers; 16 B each is 46.5 GB, plus the 64 stored for
   60 experts), 4 x 2048: two runs of the loss and backward from the same
   state bit-identical, the drops per layer, and after the steps, with the
   model freed, layer 0's MoE gradients at its captured input against its
   per-token dense form's (``dense_moe``, differentiated) within
   MOE_GRAD_TOL at the config's capacity factor and at MOE_TIGHT_FACTOR;
   layer 0's wq, wk, wv, its attention captured.
   d: Mamba2-2.7B at full depth unless its fp32 state passes
   TRAIN_STATE_SHARE of the card (a cut is printed), 2 x 2048: the chunked
   SSD's gradients (x, dt, B, C) at layer 0's captured input cut to
   SSD_GRAD_SEQ positions against ``ssd_sequential``'s autograd within
   SSD_GRAD_TOL (``ssd_grad_check``).  e: Hymba-1.5B at full depth, 2 x
   2048: the windowed backward at head_dim 64 on its 29 local layers (the
   profiled step must show no CUDA-core backward kernel; layer 1, local,
   and the middle, global, layer captured), the SSD check of d and layer
   0's wq, wk, wv held kernel vs mixed route in bf16 and kernel vs plain
   route in fp32 within FP32_ROUTE_TOL, not kernel vs plain in bf16: at
   Hymba's shape the forward's bf16 rounding alone (mixed vs plain, no
   backward kernel) moves them past ROUTE_TOL, so kernel vs plain is
   printed there.
18. The dry run (``repro_torch.launch.dryrun``), held against the card.
   a: all 40 cells (10 architectures x 4 shapes) on the one-card mesh,
   each step traced on the meta device in DRYRUN_JOBS worker processes,
   and their argument bytes on 16x16 and 2x16x16: one table of status or
   skip reason, per-device argument GB per mesh, flops (and the model
   flops), the one-card temp and ``fits_card`` (the predicted peak,
   ``dryrun.PEAK_BOUND`` over, within 80 GB).  b: every cell that fits,
   run once on the card with its arguments made from ``--seed`` in the
   traced dtypes (decode at pos = S - 1): the arguments' bytes equal to
   the dry run's, ``max_memory_allocated`` over what was resident before
   within ``dryrun.PEAK_BOUND`` of the predicted peak (arguments + temp),
   the flash launches equal to the traced calls, the non-attention flops
   (``dryrun.FlopCount``: ``FlopCounterMode``'s formulas without its
   module tracker, which keeps the activations alive) equal to the
   trace's, a finite output; the step's wall time printed only.  A kind
   (train, prefill, decode) with no cell that fits is named.  c: the
   configurations that phases 13a, 15c, 16a-c and 17a-e ran (as cut:
   depth, batch, sequence, cache length), traced in the same workers
   while b runs.  Each phase read one of its steps' peak alone
   (``step_alone``: a train phase its first timed step, a serving phase
   one more prefill): the bytes of that step's arguments equal to the
   trace's, and the step's peak over what was allocated before it within
   ``dryrun.PEAK_BOUND`` of the traced temp.  The phase's whole peak is
   printed and held too, against the memory resident before it, what it
   held beside its step (the data pipeline, captures; measured) and the
   step's arguments and temp, and the peak of its window before that
   step (a train phase of 17 also after its set-up and route checks, and
   after its first, hooked step) is printed beside the step's.  The phase's seconds are printed.
19. Training across cards (``torch.distributed``), after phase 18.  First
   the number of cards, the mesh and whether a cross-card collective can
   run (not on one card: every group holds one rank).  a: one NCCL rank a
   card (``chip_smoke.py --mesh-rank``, fresh interpreters) trains 13a's
   configuration (Qwen2-7B's width at 8 layers, 4 x 2048, remat full,
   13a's seed) on the (n, 1) (data, model) device mesh as DTensors: each
   rank builds 13a's ``BitmapIndexedDataset`` on its card (the bitmap
   kernels must run) and its first batch must be 13a's; the loss within
   1e-3 (relative) and layer 0's wq/wk/wv gradients within 1/16 (L2) of
   13a's kernel route; one counted step with 16 forward and 8 backward
   flash launches on each rank and the plain attention made to raise; 3
   timed steps (median), tokens/s and rank 0's peak beside 13a's; the
   loss's all-reduces over groups of more than one rank counted.  With 4
   cards or more, the published 28 layers on the (n/2, 2) mesh too.  c:
   the sharded parameters and step, written once by rank 0, restored into
   the unsharded model on rank 0's card and held against the gathered
   shards bit for bit (the moments stay out: ``store.format`` builds the
   whole file in host memory three times over); needs 1.25 x 11.8 GB free
   disk, checked first.  b, beside c: ``python -m repro_torch.launch.train
   --demo --steps 4 --ckpt-every 2 --coordinator 127.0.0.1:<port>
   --num-hosts 1 --host-id 0`` on the card; then its step-4 checkpoint
   removed (a death after step 2's) and the same command again: it must
   resume from step 2 and end within 1e-6 (relative) of the whole run's
   final loss.  The flash records gain ``mesh_launches`` (19a's step, rank
   0) and the bitmap ones ``mesh_data_launches``.
20. Serving across cards, after phase 19, under the reference's
   ``serve_tp`` rules (``fsdp`` mapped to None: TP-only weights, bf16).
   b's unsharded side first, in this process: Command-R+-104B at its
   published width (d_model 12288, 96 / 8 heads of 128, d_ff 33792, vocab
   256000, tied head, the parallel block) cut to 8 of its 64 layers (31.5
   GB of bf16 weights), phase 7's serving path and checks (4 prompts of
   2048 from ``--seed``, ``greedy_generate`` of 32 steps with 8 flash
   launches and no plain attention, prefill and decode timed, the kernel
   at layers 0 and 7 against its plain version, the kernel- vs
   plain-route logits in bf16 and fp32), and row 5c: the kernel at its
   prefill shape (q (4, 2048, 96, 128), k/v (4, 2048, 8, 128)) and at one
   rank's quarter on (1, 4) (24 and 2 heads), beside its plain version,
   SDPA and its bound, by CUDA events around back-to-back calls.  Then one
   NCCL rank a card (``chip_smoke.py --serve-rank``, fresh interpreters)
   runs each job on its device mesh: a, phase 7's cell (Qwen2-7B, 4 x 2048,
   32 greedy steps, its seed) on the (n, 1) mesh, its prefill's
   last-position logits within phase 7's bf16 LOGIT_TOL of phase 7's,
   argmax and the first generated token equal on decided rows,
   bit-identity printed; b, 20b's 8 layers on the (1, n) mesh ((1, 1) on
   one card) against the unsharded run the same way.  Each job builds the
   model by ``init_params(mesh=)`` and a cache by ``init_cache(mesh=)``,
   and holds the allocator's bytes for each against the dry run's
   per-device argument bytes (``launch.dryrun.serve_arg_bytes``:
   ``shard_bytes`` under ``serve_tp``), within the allocator's rounding
   (SERVE_ALLOC_SLACK a tensor); ``greedy_generate`` runs with the flash
   counter zeroed just before and read just after, the plain attention
   made to raise, one flash launch a layer on each rank; then prefill ms,
   decode ms a step, and each rank's peak and allocated bytes.  With 4
   cards or more, also the published 64 layers on (1, n) (51.9 GB of
   weights a card at n = 4; timed, no reference) and a on (n/2, 2).  The
   flash records gain ``tp_serve_launches`` (b's first job, rank 0).  The
   phase's seconds are printed.
21. The MoE and the encoder-decoder across cards, after phase 20: one
   NCCL rank a card (``--serve-rank`` with phase 21's jobs,
   ``family_job``), each job on its (data, model) device mesh, against
   references kept by phases 16a, 17a, 17b and 17c.  a: Qwen2-MoE-A2.7B
   at its published width and depth (24 layers, 60 experts top-4 and 4
   shared) served under ``serve_tp``, 16a's 4 x 2048 prompts and 32
   greedy steps, on (1, n) (on four cards expert-parallel, 15 experts a
   rank) and, with 4 cards, (n/2, 2); b: Whisper-small, 17a's cell (8 x
   (1500 frames, 224 tokens), 32 steps), on the same meshes.  Each holds
   the allocator's bytes after ``init_params(mesh=)`` and
   ``init_cache(mesh=)`` against ``dryrun.serve_arg_bytes``
   (SERVE_ALLOC_SLACK a tensor; Whisper's ``xk``/``xv`` caches too), one
   flash launch a flash module in the counted ``greedy_generate`` (24;
   36) with the plain attention made to raise, the logits as phase 20
   holds them (``held_logits``) and, on one card, the logits, ids and
   every layer's routing the unsharded run's bit for bit; the routings
   that differ from 16a's are counted per layer and printed (bf16 partial
   sums over ``model`` may flip them; not bounded); prefill and decode
   timed with a synchronize around each, rank 0's card busy time and idle
   share over one of each, each rank's peak and allocated bytes.  c:
   17c's cell (Qwen2-MoE at 4 layers, 4 x 2048, remat full, fp32 state)
   on (n, 1): the loss within 1e-3 and layer 0's q/k/v gradients and
   expert-weight gradients (experts 0-3) within 1/16 (L2) of 17c's, with
   the compute dtype bf16 and again fp32 (in bf16 the expert weights
   are held only when no layer routed otherwise than 17c did: a flip
   moves a token between experts, and past the capacity the tokens after
   it; the flips are printed), two bf16 runs of the loss and backward
   bit-identical, each layer's drops in an fp32 forward at capacity
   factors 1.25 and 0.5 equal to 17c's wherever every layer up to it
   routed as 17c did (on one card: every layer), one counted step
   (8 forward and 4 backward flash launches on each rank, no plain
   attention), 3 timed steps beside 17c's; with 4 cards also the
   published 24 layers on (n/2, 2), its per-card fp32 state reckoned by
   ``shard_bytes`` on the abstract mesh beside the measured peak, with
   finite, falling losses.  d: 17b's cell (Whisper-small at full depth, 8
   x (1500, 448)) on (n, 1) and, with 4 cards, (n/2, 2): the loss and
   layer 0's encoder, self- and cross-attention q gradients against 17b's
   the same way, 72 forward and 36 backward flash launches a step.  The
   kernel records of 16a, 17a, 17b and 17c gain rows at one (1, 4) rank's
   heads (Qwen2-MoE 4 of 16, Whisper's encoder 3 of 12, forward and
   backward) beside SDPA and the bound; the MoE flash records gain
   ``family_mesh_launches`` (rank 0's first job and first MoE train job).
   The phase's seconds are printed.
22. ``ulysses_attn`` and ``seq_sharded`` across cards, after phase 21.
   a: Granite-20B at its published width (d_model 6144, 48 / 1 heads of
   128, d_ff 24576, vocab 49152, gelu, tied head: MQA, whose one KV head
   divides no ``model`` axis) cut to 8 of its 52 layers, unsharded in
   this process first through phase 7's path and checks (4 prompts of
   2048 from ``--seed``, a 32-step ``greedy_generate`` with one flash
   launch a layer and no plain attention, the kernel at layers 0 and 7
   against its plain version, the kernel- vs plain-route logits in bf16
   and fp32).  Then one NCCL rank a card (``--serve-rank`` with phase
   22's jobs, ``sp_job``) under ``serve_tp``: on one card the (1, 1) mesh
   with ``ulysses_attn``, whose logits and ids must be the unsharded
   run's bit for bit; with 4 cards or more the 8 layers on (1, n) without
   and with ``ulysses_attn`` in the same ranks, each held against the
   unsharded run by ``held_logits``, then the published 52 layers on
   (1, n) both ways (~10 GB of bf16 weights a card; SP_FULL_STEPS greedy
   and decode steps).  Each job holds the allocator's bytes against
   ``dryrun.serve_arg_bytes`` (SERVE_ALLOC_SLACK a tensor) and prints
   prefill ms, decode ms a step, rank 0's flash time in one prefill
   (CUDA events around each wrapper call, its launch counter), the
   collectives of one prefill (``CommDebugMode``) and each rank's peak.
   b: 13a's configuration (Qwen2-7B's width at 8 layers, 4 x 2048, remat
   full, 13a's seed and first batch) with ``seq_sharded`` and
   ``ulysses_attn``: on one card on (1, 1), the loss and layer 0's q/k/v
   gradients 13a's bit for bit; with 4 cards on (n/2, 2) and (1, n)
   within 1e-3 (loss, relative) and 1/16 (gradients, L2) of 13a's; every
   job one counted step (16 forward and 8 backward flash launches on each
   rank, the plain attention made to raise) and 3 timed steps; then the
   published 28 layers on (n/2, 2) without and with both options in the
   same ranks, their first losses within 1e-3 (relative), step ms and
   each rank's peak printed both ways.  Rows 5u and 5bu, after the ranks
   (not under ``--mesh-only``): the forward kernel at a (1, 4) rank's
   Ulysses shard of 22a (layer 0's q cut to 512 positions at q_offset 0
   and 1536 against its k/v (4, 2048, 1, 128), causal) and the backward
   kernel at a (2, 2) rank's shard of 22b (q (2, 1024, 28, 128), k/v (2,
   2048, 4, 128), standard normal from ``--seed``, dout at unit RMS, at
   q_offset 0 and 1024), each against its plain version, beside SDPA
   under the same boolean mask and the bound (allowed pairs x 4 hd flops,
   2.5 x that backward, over 989e12 flop/s, or the bytes, k and v read
   only at the keys the mask allows, if more); the backward's dK and dV
   past the shard's last query must be exactly 0.  Their ``launches``
   are rank 0's in 22a's Ulysses job and 22b's first job.  The phase's
   seconds are printed.
23. The SSM and hybrid families across cards, after phase 22: unsharded
   references on this card first (``ssm_references``: 16b's, 16c's,
   17d's and 17e's cells, at the published depths with 4 cards or more,
   else cut to SSM_ONE_CARD_LAYERS = 4 layers to keep the script in its
   time limit), then one NCCL rank a card (``--serve-rank`` with phase
   23's jobs, ``family_job``), each job on its (data, model) device mesh.
   a: Mamba2-2.7B (published: 64 layers, d_inner 5120, 80 SSM heads,
   d_state 128) served under ``serve_tp``, 16b's 4 x 2048 prompts and 32
   greedy steps, on (1, n); b: Hymba-1.5B (32 layers, 25 / 5 heads of 64,
   50 SSM heads), 16c's cell, on (1, n) and, with 4 cards, (n/2, 2).
   Each as 21a holds its job (the allocator's bytes against
   ``dryrun.serve_arg_bytes``, one flash launch an attention layer on
   each rank in the counted ``greedy_generate``, none for Mamba2, the
   plain attention made to raise, the logits by ``held_logits``), and the
   ``conv`` and ``ssm`` caches of the first, middle and last layers after
   the prefill within LOGIT_TOL's bf16 share of their largest magnitude
   (layer 0's within SSM_LAYER0_CACHE_TOL = 1/64 of it); on one card
   the logits, ids and those caches the unsharded run's bit for bit.  c: 17d's cell (Mamba2, 2 x 2048, remat full, fp32 state),
   d: 17e's (Hymba), each on (n, 1) and, with 4 cards, on (n/2, 2)
   instead: the loss within 1e-3 and layer 0's gradients (c: the SSM's
   ``in_proj``, ``conv_w``, ``A_log``, ``out_proj``; d: q/k/v, ``in_proj``,
   ``conv_w``, ``out_proj``) within 1/16 (L2) of the unsharded run's with
   the compute dtype bf16, and within SSM_FP32_GRAD_TOL = 1e-3 with fp32
   (a bf16 gradient held only where the
   unsharded run's own bf16 gradient lies within 1/16 of its fp32 one,
   else printed: a rounding order of its own moves it that far; Hymba's
   forward kernel's bf16 rounding alone moved 17e's by 0.0647), and on
   one card all of them the unsharded run's bit for bit; two bf16 runs
   bit-identical; one counted step (two forward and one backward flash
   launch an attention layer on each rank, no plain attention) and 3
   timed steps beside the unsharded run's; the per-card state reckoned by
   ``shard_bytes``.  Rows 5hr and 5bhr (made in 16c and 17e): both flash
   kernels at a (2, 2) rank's shard of Hymba (half the batch, every head:
   25 and 5 divide no ``model`` axis; layer 1's window of 1024) beside
   their plain versions, SDPA under the window's boolean mask and the
   bound; their ``ssm_mesh_launches`` are rank 0's in b's last job and
   d's job.  Phase 23 prints, beside each job, rank 0's flash time in one
   Hymba prefill and the collectives (``CommDebugMode``) of one prefill
   and of one train step.
24. The sequence options on the SSM and hybrid families, in the same
   launch of ranks as phase 23 and against its unsharded references
   (``family_job`` with phase 22's option letters, ``hs:DxM:layers:u``):
   a: Hymba-1.5B served with ``ulysses_attn`` (each rank runs its slice of
   the queries, at q_offset = its rank x the local Sq, against every key,
   under the window on the local layers; decode keeps the plain cached
   attention); b: 17d's cell (Mamba2) and c: 17e's (Hymba) trained with
   ``seq_sharded`` (the carry split by sequence over ``model``, gathered
   whole before each branch, the Mamba2 mixer's too, and each branch's
   partial sums reduce-scattered back); on one card at
   SSM_ONE_CARD_LAYERS on (1, 1), Hymba also trained with both options,
   each bit for bit the option-free unsharded run (logits, ids, caches,
   loss, layer 0's gradients in bf16 and fp32); with 4 cards at the
   published depths a on (1, n) and b, c on (n/2, 2), held by phase 23's
   checks.  Each job prints its figures beside phase 23's job of the same
   kind and mesh: rank 0's flash ms in one prefill, prefill and decode
   ms, step ms, each rank's peak, and the collectives of one prefill or
   one step.  Rows 5hu and 5bhu, after the ranks (not under
   ``--mesh-only``): the forward kernel at a (1, 4) rank's Ulysses shard
   of Hymba's prefill (16c's layer 1, a local one, captured in the
   reference's run: q cut to 512 positions at q_offset 0 and 1536 against
   its k/v (4, 2048, 5, 64), window 1024) and the backward kernel at a
   (2, 2) rank's shard of 24c with both options (q (1, 1024, 25, 64), k/v
   (1, 2048, 5, 64), window 1024, standard normal from ``--seed``, dout at
   unit RMS, at q_offset 0 and 1024), as rows 5u and 5bu; their
   ``launches`` are rank 0's in 24a's job and in 24c's last.  The phases'
   seconds are printed.

Phase 2 also holds the stacked ``bulk_program`` launch against its plain
version at ``tests/torch_checks.py``'s ``STACKED_CASES`` (S = 1, 3, 8,
ragged Nw, Q past 65535, every literal inverted, D past the staged
route's cap), every ``bulk_program`` form (2-D and stacked, unmasked and
counted) at ``COUNTED_CASES`` and ``STACKED_CASES``, the counted 2-D form
at record counts 0, 1, 32 Nw - 5, 32 Nw and mid-word, each case on the
route of the C entry's plan (``bulk_program_plan``, held against its
mirror in ``tests/torch_checks.py``; the counted and uncounted forms must
agree) and under the profiler, which must see no kernel of the other
route (``bulk_staged_kernel``, ``bulk_gather_kernel``; it can miss
launches, so the count it saw on the route is printed, not required);
the cases of each launch cover both routes: the gather route at M = 4096
with every row selected, at G*P*L = 8192 and at 512 literals over
M = 500),
and the flash backward
kernel (``flash_attention_bwd``) and the forward's lse against their plain
versions at ``tests/torch_checks.py``'s ``FLASH_BWD_CASES`` (S = 1, 63,
200, 1000, 2048, head_dim 64 and 128 with H/KV = 1 and 7, head_dim 256
with H/KV = 1 and 2, causal and full, fp32 and bf16): the lse within
1e-5, dq, dk, dv within its ``bwd_tol`` (atol 2e-4, the reference's
gradient tolerance, for fp32; one bf16 ulp at the output's largest
magnitude plus that atol for bf16), and two launches
on the same inputs bit-identical, and once more at phase 13a's shape (B =
4, S = 2048, H = 28, KV = 4, hd = 128, causal, bf16) on standard-normal
inputs, max|plain| printed beside each tolerance; the C entry must
launch each kernel of the tensor-core pair (``flash_bwd_dq_wgmma``,
``flash_bwd_dkdv_wgmma``) once for bf16 at head_dim 64, 128 and 256, and
of the CUDA-core pair (``flash_bwd_dq_kernel``, ``flash_bwd_dkdv_kernel``)
for fp32 (at 128 and 256) and for bf16 at head_dim 32, and no other
kernel (its counts at the launch sites), and the profiler must see no
kernel of the other pair and no more launches than the call made, in
each of up to three sessions of one call; what it saw of the pair's own
kernels is printed (it loses records: the dq kernel's in every session
of some runs).  Both flash kernels, bidirectional, at
Whisper's shapes (``tests/torch_checks.py``'s ``ENCDEC_FLASH_CASES``:
batch 8, 12/12 heads of 64, Sq = Skv = 1500 and Sq = 224, 448 against
Skv = 1500, fp32 and bf16) through ``flash_mask_ratios``, each case one
forward and two backward launches by the counters, and for bf16 no
CUDA-core kernel in the profiler's record (``check_flash_encdec``).  Then
both flash kernels under a mask, at
``tests/torch_checks.py``'s ``FLASH_WINDOW_CASES`` (S = 63, 200, 1000,
2048 x window 1, 64, 100, 1024 x head_dim 64, 128, 256 x H/KV 1 and 7 (2
at 256) x fp32 and bf16, causal) and ``FLASH_OFFSET_CASES`` (a chunk of
queries against a longer cache with and without a window, one decode
position, kv_len < Skv causal and full, cross attention, rows that see no
key, the Ulysses shards: 512 of 2048 queries at q_offset 0, 512 and
1536, and 1536 under a window of 1024; each at head_dim 64, 128, 256 in
fp32 and bf16), through ``flash_mask_ratios``: the forward within
``attn_tol`` and, for bf16, ``bf16_attn_err``, the lse within 1e-5, dq,
dk, dv within ``bwd_tol``, two backward launches bit-identical and dK and
dV exactly 0 at every key no query sees; the C entries must launch the
tensor-core forward and backward kernels for bf16 under a window at
head_dim 64, 128 and 256 and the CUDA-core ones for fp32 at 256, and the
profiler must see none of the other route's.  Each
path (phases 3, 8, 9) is driven with every launch counter set to 0 just
before it and read just after; so is each of phases 10, 11 and 12a's runs
(11b's wake and one-shot step together).  Each of those runs also fails
unless every bitmap wave it served ran on ``cuda``, counted per backend
like the launches.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and the result JSON.
"""
import argparse
import atexit
import contextlib
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
TRAIN_ARCH = "qwen2-7b"
TRAIN_LAYERS = 8            # phase 13a: Qwen2-7B's 28 layers cut to 8
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 6             # phase 13a: steps after the counted one
STATE_BYTES_PER_PARAM = 16  # fp32 master, gradient, AdamW m and v
CARD_BYTES = 80e9
#: kernel- vs plain-attention route at full width, bf16: the loss to 1e-3
#: of itself (a mean over 8192 tokens; read 4e-6 to 1.9e-5), and each of
#: layer 0's wq/wk/wv gradients to 1/16 of its norm in the L2 norm of the
#: difference (read 0.0239-0.0240 on three batches, 0.025-0.041 at layer
#: 7).  Nearly all of it is the two forwards rounding attention's output
#: to bf16 at other elements (the route with the forward kernel and the
#: plain backward reads the same against the plain route); the backward
#: kernel's own share is 0.0003 at layer 7 and 0.011 at layer 0.
ROUTE_TOL = {"loss": 1e-3, "grad": 1 / 16}
#: the backward kernels of each route of ``flash_attention_bwd_launch``
#: (bf16 at head_dim 64 / 128 / 256 on the tensor cores, the rest on the
#: CUDA cores), as the profiler names them
BWD_KERNELS = {"tensor cores": ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma"),
               "CUDA cores": ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")}
ROUTE_BATCHES = 3           # phase 13a: batches of the route comparison
#: the kernel that ``torch.cuda._sleep`` launches: ``device_profile``'s
#: marker
PROFILE_MARKER = "spin_kernel"
RESTART_STEPS = (4, 2)      # phase 13b: steps, and the checkpoint restarted
#: phase 13b: a restarted run's AdamW moments against the unbroken run's,
#: as a fraction of each tensor's largest magnitude.  Two steps after a
#: restart that lost the moments, m differs from the unbroken run's by
#: about b1^2 of its value; a reduction summed in another order moves it
#: by fp32 rounding (about 1e-7 of its value).
RESTART_MOMENT_TOL = 1e-3
WIN_ARCH = "gemma3-4b"      # phase 15a and c: sliding windows, head_dim 256
#: phase 15a: prompts of 4096, so that the window (1024) covers under half
#: of a causal row, and 32 greedy steps past the window on every local layer
WIN_BATCH, WIN_PROMPT, WIN_STEPS = 4, 4096, 32
VLM_ARCH = "qwen2-vl-7b"    # phase 15b: M-RoPE and the visual prefix
VLM_BATCH, VLM_PROMPT = 4, 2048
WIN_TRAIN_LAYERS = 6        # phase 15c: Gemma3's 34 layers cut to 6
WIN_TRAIN_BATCH = 2         # phase 15c: batches of 2 x WIN_PROMPT tokens
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS = 4, 2048, 32
MOE_ARCH = "qwen2-moe-a2.7b"    # 16a: capacity dispatch, shared experts
SSM_ARCH = "mamba2-2.7b"        # 16b: attention-free SSD at 64 layers
HYBRID_ARCH = "hymba-1.5b"      # 16c: parallel attention and SSM heads
#: rows 5hr and 5bhr: Hymba's flash kernels at a (2, 2) rank's shard (half
#: the batch, every head: 25 / 5 divide no ``model`` axis)
HYBRID_RANK = "hybrid (2, 2) rank"
#: phase 23 on fewer than 4 cards: Mamba2's and Hymba's depth, cut to keep
#: the script in its time limit (Hymba's layers 0, 2, 3 global, 1 local),
#: the references recomputed at it
SSM_ONE_CARD_LAYERS = 4
#: 16a: the MoE layer at layer 0's captured input against its per-token
#: dense form, both in fp32 (the same products summed in other orders),
#: as a fraction of the dense form's largest magnitude; at the config's
#: capacity factor and at MOE_TIGHT_FACTOR, where the capacity drops many
#: assignments
MOE_DENSE_TOL = 1e-4
MOE_TIGHT_FACTOR = 0.5
#: 16b: ``ssd_chunked`` against the step-by-step ``ssd_sequential`` at
#: layer 0's captured input in fp32 (the reference's own test holds 64
#: steps to 1e-5 absolute; here 2048), y and the final state each within
#: this fraction of the oracle's largest magnitude
SSD_TOL = 1e-4
#: 16b and 16c: a prefill of S - 1 tokens plus one decode step against a
#: prefill of S, bf16 last-position logits: the chunked and recurrent SSD,
#: the full and stepped conv (and for Hymba the kernel and the plain decode
#: attention) round to bf16 at other places in every layer, as phase 7's
#: two attention routes do; its bf16 route tolerance
STEP_TOL = LOGIT_TOL["bfloat16"]
ENCDEC_ARCH = "whisper-small"   # 17a and b: the encoder-decoder
#: 17a: 8 segments of 1500 frames (30 s each, Whisper's window), its
#: 224-token previous-text prompt limit, 32 greedy steps
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS = 8, 224, 32
ENCDEC_TRAIN_SEQ = 448      # 17b: Whisper's text context
MOE_TRAIN_LAYERS = 4        # 17c: Qwen2-MoE-A2.7B's 24 layers cut to 4
MOE_TRAIN_BATCH = 4         # 17c: batches of 4 x FAMILY_TRAIN_SEQ
SSM_TRAIN_BATCH = 2         # 17d and e: batches of 2 x FAMILY_TRAIN_SEQ
FAMILY_TRAIN_SEQ = 2048
TRAIN_ROUTE_BATCHES = 2     # phase 17: batches of the route comparison
TRAIN_TIMED = 3             # phase 17: steps timed (the median is kept)
#: 17d and e: the fp32 training state (16 B/param) may take this share of
#: the card before the depth is cut (the rest holds the activations)
TRAIN_STATE_SHARE = 0.75
#: 17c: layer 0's MoE gradients at its captured input against the per-token
#: dense form's, fp32 (the same products summed in other orders, through
#: the router's softmax and 60 experts), each within this fraction of the
#: dense form's largest magnitude of that gradient
MOE_GRAD_TOL = 1e-3
#: 17d and e: the chunked SSD's gradients (x, dt, B, C) at layer 0's
#: captured input cut to SSD_GRAD_SEQ positions against the step-by-step
#: oracle's autograd, fp32, each within this fraction of the oracle's
#: largest magnitude of that gradient (the repaired form reads ~1e-5 on the
#: CPU at 512 positions; the reference's form gives NaN at chunk 128)
SSD_GRAD_SEQ = 512
SSD_GRAD_TOL = 1e-3
#: 17e: the loss and layer 0's gradients with the compute dtype fp32, kernel
#: vs plain attention route, relative (the L2 norm of the difference for a
#: gradient): the same products summed in other orders (read 1e-5)
FP32_ROUTE_TOL = 1e-3
#: the card's ``nvidia-smi`` name and power limit, set by main(): printed
#: beside phase 17's figures
CARD = {"smi": ""}
#: phase 18c's record of each phase that reads a peak (13a, 15c, 16a-c,
#: 17a-e): label -> the step it ran (config as cut, kind, batch, sequence,
#: cache length, token dtype, parameter dtype) and its memory: ``resident``
#: (allocated before the phase made anything), ``peak``
#: (``max_memory_allocated`` over its window), ``end`` (allocated when it
#: read the peak: the step's arguments and what the phase holds beside
#: them), ``args`` (the step's arguments' bytes) and one step's own peak
#: (``step_alone``)
PHASE_PEAKS = {}
#: phase 18: the phases whose peaks 18c predicts, by PHASE_PEAKS label
PEAK_PHASES = {"13a": "13a", "15c": "15c", "16a": "moe lm", "16b": "ssm lm",
               "16c": "hybrid lm", "17a": "whisper lm",
               "17b": "whisper train", "17c": "moe train",
               "17d": "ssm train", "17e": "hybrid train"}
#: phase 18a: worker processes tracing the cells (the card machine has 8
#: cores; the main process runs 18b meanwhile)
DRYRUN_JOBS = 7


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


def event_ms(torch, fn, reps: int, back_to_back: bool = False) -> float:
    """Card ms per run of ``fn`` from CUDA events, after one warm-up.  By
    default the median span of ``reps`` runs, each waited for: it includes
    any gap in which the card waits for the host, so for a short kernel it
    measures the launch path.  ``back_to_back``: the events around ``reps``
    runs queued one after another (the host runs ahead of the card), over
    ``reps``; no capture can miss part of the work."""
    fn()
    torch.cuda.synchronize()
    if back_to_back:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
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


def device_profile(torch, fn, reps: int = 1, counts: dict | None = None,
                   timed: dict | None = None) -> tuple[float, float, dict]:
    """(host wall ms, card busy ms, {kernel: card ms}) per run of ``fn``,
    from ``torch.profiler``'s CUDA activity over ``reps`` runs (the card's
    own kernel and copy durations, without host gaps).  ``counts``, when
    given, receives {kernel: launches} over all ``reps`` runs, from every
    card record (also one without device time).  ``timed``, when given,
    receives {kernel: [records that carry device time, their card ms]}
    over all ``reps`` runs: the profiler drops some launches' records and
    keeps others without their time (PERF.md section 7).  The
    profiler can miss a session's first kernel, so a session starts with
    a marker kernel (``torch.cuda._sleep``'s, left out of the readings)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for ev in prof.key_averages():
        if PROFILE_MARKER in ev.key:
            continue
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / reps
        # a launch counts as the card tests count it: every card record,
        # also one that carries no device time
        if counts is not None and (
                us or ev.device_type == torch.autograd.DeviceType.CUDA):
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    for ev in prof.events() if timed is not None else ():
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        if us and PROFILE_MARKER not in ev.name:
            got = timed.setdefault(ev.name, [0, 0.0])
            got[0] += 1
            got[1] += us / 1e3
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


def route_launches(torch, attention, fn):
    """(``fn()``, {flash kernel: launches over it}) as the C entries count
    them where they launch each kernel: the route the calls took, which
    does not hang on the profiler's records (it loses some, PERF.md
    section 7)."""
    torch.cuda.synchronize()
    attention.kernel_launches(reset=True)
    out = fn()
    torch.cuda.synchronize()
    return out, attention.kernel_launches(reset=True)


def bucket_table(buckets, m: int, segments: int = 1) -> tuple[list, float]:
    """Per bucket of ``batch._partition``: (G, P, L), real and padded Q,
    distinct operand rows D (the identity row M excluded) and row gathers
    (selectors off row M); and the per-bucket read-once floor's bytes a
    word, (sum D + sum padded Q) x 4 x ``segments``."""
    table, words = [], 0
    for shape, idxs, sels, _, _ in buckets:
        sel = sels.cpu().reshape(-1)
        off = sel[sel != m]
        d = int(off.unique().numel())
        table.append({"shape": list(shape), "q": len(idxs),
                      "q_padded": int(sels.shape[0]), "distinct_rows": d,
                      "row_gathers": int(off.numel())})
        words += d + int(sels.shape[0])
    return table, 4.0 * words * segments


def route_seen(label: str, seen: dict, route: str, launches: int) -> str:
    """Hold ``bulk_routes_seen``'s reading of ``launches`` launches against
    ``route``, the route of the C entry's plan: the profiler must see no
    kernel of the other route.  It can miss launches, up to all of a
    session's (it does not invent them), so fewer than ``launches`` on the
    route are reported, not failed."""
    if seen[route] > launches or any(n for r, n in seen.items()
                                     if r != route):
        raise SystemExit(f"{label}: the profiler saw {seen} launches, want "
                         f"{launches} on the {route} route only")
    return f"the profiler saw {seen[route]} of {launches} on it"


def staged_wave(label: str, forms: dict, aug, buckets) -> None:
    """Every bucket of ``buckets`` over ``aug`` (stacked when 3-D) must
    take the staged route in the C entry's plan, counted or not, and each
    of ``forms`` (label -> one wave of launches, one a bucket) must show
    the profiler no ``bulk_gather_kernel``."""
    from torch_checks import bulk_plan_route, bulk_routes_seen
    stacked = aug.dim() == 3
    s = aug.shape[0] if stacked else 1
    m, nw = aug.shape[-2] - 1, aug.shape[-1]
    plans = {bulk_plan_route(s, m, nw, tuple(b[2].shape), stacked=stacked,
                             counted=c) for b in buckets for c in (0, 1)}
    if plans != {"staged"}:
        raise SystemExit(f"{label}: the wave's plans take the routes "
                         f"{plans}, want the staged route only")
    for form, fn in forms.items():
        seen = route_seen(f"{label} {form}",
                          bulk_routes_seen(fn, len(buckets)), "staged",
                          len(buckets))
        print(f"{label} {form}: every bucket on the staged route ({seen})")


def bulk_beside(torch, label: str, forms: dict, rows, plain_mask,
                floor_bytes: float, record: dict) -> None:
    """Phases 5 and 8, beside row 4 or 4b: ``forms`` (label -> one wave of
    launches) and the plain tail mask + popcount over the row record's
    ``rows``, taken in turn; their least card ms, the kernels' own, and the
    per-bucket read-once floor go into ``record``.  A form's round read
    below the record's bound lost launches in the profiler (no wave of
    this work takes less): it is dropped, and a form left with none
    fails."""
    floor_ms = floor_bytes / PEAK_BYTES * 1e3
    times = in_turn(torch, {**forms, "plain tail mask + popcount over its "
                            "rows": lambda: [plain_mask(r) for r in rows]},
                    "bulk_", 10)
    print_in_turn(f"{label} beside its record (per-bucket read-once floor "
                  f"{floor_ms} ms)", times)
    for form in forms:
        kept = [t for t in times[form] if t[1] >= record["bound_ms"]]
        if not kept:
            raise SystemExit(f"{label} {form}: every round read below the "
                             f"bound: {times[form]}")
        if len(kept) < len(times[form]):
            print(f"  {form}: {len(times[form]) - len(kept)} round(s) read "
                  f"below the bound {record['bound_ms']} ms dropped")
        times[form] = kept
    record["read_once_floor_ms"] = floor_ms
    record["beside"] = {k: {"card_ms": min(t for t, _ in v),
                            "kernel_ms": min(k_ for _, k_ in v)}
                        for k, v in times.items()}


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
    from repro_torch.engine import policy
    table, floor_bytes = bucket_table(buckets, M, BLOCKS)
    for row in table:
        print(f"  bucket {row}")
    forms = {
        "row 4b, staged": lambda: [
            bitmap_ops.bulk_program_stacked(aug_s, nrecs, *b[2:])
            for b in buckets],
        "counted, staged": lambda: [
            bitmap_ops.bulk_program_stacked_counted(aug_s, nrecs, *b[2:])
            for b in buckets]}
    staged_wave("bulk_program_stacked", forms, aug_s, buckets)
    rows4b = [bitmap_ops.bulk_program_stacked(aug_s, nrecs, *b[2:])
              for b in buckets]
    bulk_beside(torch, "bulk_program_stacked", forms, rows4b,
                lambda r: policy.popcount(r).sum(dim=-1, dtype=torch.int32),
                nw * floor_bytes, records[-1])
    records[-1]["buckets"] = table
    del rows4b
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
    return ladder_of(svc.health(), label)


def ladder_of(h: dict, label: str) -> dict:
    """The ladder counters and breaker of one ``health()`` dict (a
    service's, or a shard's read over the wire); fails unless every
    counter is 0 and the breaker closed."""
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
                 policy, records, sync_times: dict) -> dict:
    """Phase 11 (see the module docstring); returns 11a's storm
    metrics."""
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
    durable_m = durable_service(torch, dev, host_blocks, wave, p3,
                                zero_counts, read_counts, read_waves,
                                repro_torch, BitmapDB, policy, records,
                                sync_times)
    print(json.dumps({"service_path": {"storm": storm_m,
                                       "durable": durable_m}}))
    return storm_m


def durable_service(torch, dev, host_blocks, wave, p3, zero_counts,
                    read_counts, read_waves, repro_torch, BitmapDB, policy,
                    records, sync_times: dict, label: str = "durable service",
                    keep: dict | None = None) -> dict:
    """Phase 11c (and 14b's durable session) in a temporary directory,
    after checking its free disk; ``keep`` receives the session's locks."""
    n_dur = DURABLE_BLOCKS * BLOCK
    need = (n_dur * W * 4 + 2 * DURABLE_BLOCKS * M * (BLOCK // 32) * 4
            + (64 << 20))
    root = tempfile.mkdtemp(prefix="chip_smoke_service-")
    free = shutil.disk_usage(root).free
    try:
        if free < need:
            raise SystemExit(f"{label}: needs {need} bytes free under "
                             f"{root}, {free} are")
        out = _durable_service(
            torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
            read_waves, repro_torch, BitmapDB, policy, root, records,
            sync_times, label, keep)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(need_bytes=need, free_bytes=free)
    return out


def _durable_service(torch, dev, host_blocks, wave, p3, zero_counts,
                     read_counts, read_waves, repro_torch, BitmapDB, policy,
                     root, records, sync_times: dict, label: str,
                     keep: dict | None) -> dict:
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
        raise SystemExit(f"{label}: a submitter or the drain hung")
    if not svc._maint_ex.flush(timeout=900):
        raise SystemExit(f"{label}: maintenance did not flush")
    torch.cuda.synchronize()
    launches = read_counts("cam_match", "bit_transpose", "bulk_program",
                           "bitmap_query")
    waves = read_waves(label)
    m = svc.metrics()
    st = svc._maint_ex.stats()
    ladder = ladder_clean(svc, label)
    if keep is not None:
        keep.update({"MaintenanceExecutor._cv": svc._maint_ex._cv,
                     "StreamingIndexer._mu": ddb._si._mu,
                     "SegmentStore._flush_lock": ddb.store._flush_lock,
                     "SegmentStore._lock": ddb.store._lock})
    svc.close(timeout=600)
    spills = st["completed"].get("spill", 0)
    if bad or any(s != sorted(s) for s in seqs):
        raise SystemExit(f"{label}: {len(bad)} answers differ from "
                         f"phase 3's masked rows ({bad[:5]}) or a thread's "
                         "futures resolved out of order")
    if spills < 3 or st["errors"] or min(launches.values()) < 1:
        raise SystemExit(f"{label}: {spills} spills, {st['errors']} "
                         f"maintenance errors, launches {launches}")
    for rec in records:
        if rec["name"] in launches:
            rec.setdefault("service_launches", {})["11c"] = \
                launches[rec["name"]]
    print(f"{label}: {DURABLE_BLOCKS} appends of {BLOCK} records "
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
        raise SystemExit(f"{label}: the recovered index differs from "
                         f"phase 3's first {DURABLE_BLOCKS * BLOCK} records")
    print(f"{label}: repro_torch.open after close in {recover_s} s "
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


FABRIC_SHARDS = 4           # phase 12: shards of BLOCKS / 4 blocks each
FABRIC_WARM_WAVES = 3       # phase 12: warm fabric waves timed


def process_delta(before: dict, after: dict, label: str) -> tuple[dict, dict]:
    """(waves per backend, launches) of one shard's process between two
    ``process`` records read over the wire; fails unless there was a wave
    and every one ran on the kernels (cuda)."""
    waves = {n: v - before["waves_by_backend"].get(n, 0)
             for n, v in after["waves_by_backend"].items()
             if v != before["waves_by_backend"].get(n, 0)}
    if set(waves) != {"cuda"}:
        raise SystemExit(f"{label}: process {after['pid']} waves per backend "
                         f"{waves}; every wave must run on the kernels")
    return waves, {n: v - before["launches"][n]
                   for n, v in after["launches"].items()}


def fabric_wave(fc, wave, p3_rows, p3_counts, label: str,
                count_only: bool = False) -> float:
    """One wave through the fabric, every merged row and count held
    against phase 3's; returns its wall ms (submit to the last result)."""
    t0 = time.perf_counter()
    futs = fc.submit_many(wave, count_only=count_only)
    out = [f.result(timeout=600) for f in futs]
    ms = (time.perf_counter() - t0) * 1e3
    bad = [i for i, (row, cnt) in enumerate(out)
           if cnt != p3_counts[i] or not (
               row is None if count_only
               else row.dtype == np.uint32 and np.array_equal(row,
                                                              p3_rows[i]))]
    if bad:
        raise SystemExit(f"{label}: fabric answers {bad[:5]} differ from "
                         "phase 3's")
    return ms


def fabric_storm(fc, wave, p3_rows, p3_counts, label: str) -> dict:
    """SERVICE_THREADS submitters x SERVICE_ROUNDS rounds of the wave
    through the fabric, every merged row and count held against phase 3's;
    latency is submit to result as each submitter sees it (it waits on its
    futures in order)."""
    def body(t, lat, bad):
        for r in range(SERVICE_ROUNDS):
            futs = [(i, time.perf_counter(), fc.submit(q))
                    for i, q in enumerate(wave)]
            for i, t0, f in futs:
                row, cnt = f.result(timeout=600)
                lat.append((time.perf_counter() - t0) * 1e3)
                if cnt != p3_counts[i] or not np.array_equal(row,
                                                             p3_rows[i]):
                    bad.append((t, r, i))
            del futs
    before = [(m["served"], m["batches"]) for m in fc.metrics()["shards"]]
    threads, lats, bad = _submitters(SERVICE_THREADS, body)
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    if any(th.is_alive() for th in threads):
        raise SystemExit(f"{label}: a submitter hung")
    storm_s = time.perf_counter() - t0
    n_q = SERVICE_THREADS * SERVICE_ROUNDS * len(wave)
    lat = np.concatenate([np.asarray(x) for x in lats])
    if bad or lat.size != n_q:
        raise SystemExit(f"{label}: {len(bad)} answers differ from phase "
                         f"3's ({bad[:5]}) or {lat.size} of {n_q} served")
    after = [(m["served"], m["batches"]) for m in fc.metrics()["shards"]]
    batch = [(a[0] - b[0]) / max(a[1] - b[1], 1)
             for a, b in zip(after, before)]
    return {"queries": n_q, "storm_s": storm_s, "queries_per_s":
            n_q / storm_s, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_batch_per_shard": batch}


def fabric_path(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
                read_waves, BitmapDB, records) -> None:
    """Phase 12 (see the module docstring)."""
    t_phase = time.perf_counter()
    from repro_torch.fabric import FabricClient, ShardMap, spawn_shards
    from repro_torch.fabric.envelope import Envelope
    from repro_torch.serve.service import ServiceConfig
    per = BLOCKS // FABRIC_SHARDS
    sm = ShardMap.blocked(FABRIC_SHARDS, block_size=per * BLOCK)
    gids = [np.arange(s * per * BLOCK, (s + 1) * per * BLOCK, dtype=np.int64)
            for s in range(FABRIC_SHARDS)]
    p3_rows = p3["rows"].cpu().numpy().view(np.uint32)
    p3_counts = p3["counts"].tolist()
    cfg = {"max_batch": 256, "max_delay_ms": 2.0}
    bitmap = ("cam_match", "bit_transpose", "bulk_program", "bitmap_query")
    out = {}

    def waves_and_storm(fc, label: str) -> dict:
        cold = fabric_wave(fc, wave, p3_rows, p3_counts, label)
        warm = [fabric_wave(fc, wave, p3_rows, p3_counts, label)
                for _ in range(FABRIC_WARM_WAVES)]
        counts_only = [fabric_wave(fc, wave, p3_rows, p3_counts, label,
                                   count_only=True)
                       for _ in range(FABRIC_WARM_WAVES)]
        r = {"wave_ms_cold": cold, "wave_ms_warm": warm,
             "count_only_wave_ms": counts_only}
        print(f"{label}: the {len(wave)}-query wave over {FABRIC_SHARDS} "
              f"shards, every merged row and count bit-identical to phase "
              f"3's: cold {cold} ms, warm {warm} ms; count-only {counts_only}"
              " ms")
        return r

    def storm(fc, label: str) -> dict:
        r = fabric_storm(fc, wave, p3_rows, p3_counts, label)
        print(f"{label} storm: {SERVICE_THREADS} threads x {SERVICE_ROUNDS} "
              f"rounds = {r['queries']} queries in {r['storm_s']} s = "
              f"{r['queries_per_s']} queries/s, all bit-identical to phase "
              f"3's; latency (submit to result, as each submitter sees it) "
              f"p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms; mean coalesced "
              f"batch per shard {r['mean_batch_per_shard']}")
        return r

    def shard_reports(fc, label: str) -> tuple[list, list]:
        """Every shard's health and metrics over the wire, ladder-checked."""
        health = fc.health()["shards"]
        metrics = fc.metrics()["shards"]
        for h, m in zip(health, metrics):
            ladder_of(h, f"{label}, shard {h['shard_id']}")
            ladder_of(m["health"], f"{label}, shard {m['shard_id']}")
        return health, metrics

    # ---- 12a. loopback: four card sessions in this process
    zero_counts()
    dbs = []
    for s in range(FABRIC_SHARDS):
        db = BitmapDB(num_keys=M, device=dev)
        for blk in host_blocks[s * per:(s + 1) * per]:
            db.append_encoded(blk)
        dbs.append(db)
    fc = FabricClient.local(dbs, sm, gids=gids,
                            service_config=ServiceConfig(**cfg), **cfg)
    try:
        out["loopback"] = waves_and_storm(fc, "fabric loopback")
        out["loopback"]["storm"] = storm(fc, "fabric loopback")
        out["loopback"]["wave_profile"] = profile(
            f"one fabric wave ({len(wave)} queries, {FABRIC_SHARDS} loopback "
            "shards)", *device_profile(torch, lambda: fabric_wave(
                fc, wave, p3_rows, p3_counts, "fabric loopback, profiled")))
        torch.cuda.synchronize()
        launches = read_counts(*bitmap)
        waves = read_waves("fabric loopback")
        health, metrics = shard_reports(fc, "fabric loopback")
    finally:
        fc.close(timeout=300)
    if min(launches.values()) < 1:
        raise SystemExit(f"fabric loopback: launches {launches}")
    for rec in records:
        if rec["name"] in launches:
            rec["fabric_launches"] = {"12a": launches[rec["name"]]}
    out["loopback"].update(
        launches=launches, waves=waves,
        process_over_the_wire=health[0]["process"],
        shard_latency_p50_ms=[m["latency_p50_ms"] for m in metrics],
        shard_batch_mean=[m["batch_mean"] for m in metrics])
    print(f"fabric loopback: launches {launches} (ingest of {BLOCKS} blocks "
          f"into {FABRIC_SHARDS} sessions, then every wave); waves per "
          f"backend {waves}; over the wire every shard's ladder is 0 and its "
          f"breaker closed; the process record a shard reports "
          f"{health[0]['process']}")
    del dbs, fc
    gc.collect()
    torch.cuda.empty_cache()

    # where a fabric wave's host time goes: one shard's reply through the
    # codec, and the host OR of one wave's rows into the global rows
    from repro_torch.fabric.envelope import decode, encode
    nw = per * BLOCK // 32
    reply = Envelope("ping").reply(
        "result", rows=np.ascontiguousarray(p3_rows[:, :nw]),
        counts=np.zeros(len(wave), np.int64), num_records=per * BLOCK,
        errors=[])
    codec = {"encode_s": [], "decode_s": [], "merge_s": []}
    for _ in range(3):
        t0 = time.perf_counter()
        frame = encode(reply)
        codec["encode_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = decode(frame).payload["rows"]
        codec["decode_s"].append(time.perf_counter() - t0)
        merged = np.zeros((len(wave), BLOCKS * BLOCK // 32), np.uint32)
        t0 = time.perf_counter()
        for s in range(FABRIC_SHARDS):
            for qi in range(len(wave)):
                FabricClient._merge_row(merged[qi], back[qi], gids[s],
                                        per * BLOCK, True)
        codec["merge_s"].append(time.perf_counter() - t0)
    codec["frame_bytes"] = len(frame)
    del frame, back, merged
    out["loopback"]["host_codec"] = codec
    print(f"fabric host work: one shard's reply ({len(wave)} rows of {nw} "
          f"words, {codec['frame_bytes']} bytes) encode {codec['encode_s']} "
          f"s, decode {codec['decode_s']} s; the OR merge of one wave "
          f"({FABRIC_SHARDS} x {len(wave)} rows) {codec['merge_s']} s")

    # ---- 12b. four shard processes on the one card
    t0 = time.perf_counter()
    fleet = spawn_shards(
        FABRIC_SHARDS, num_keys=M, service_config=cfg, device="cuda",
        shard_records=[np.concatenate(host_blocks[s * per:(s + 1) * per])
                       for s in range(FABRIC_SHARDS)])
    spawn_s = time.perf_counter() - t0
    print(f"fabric processes: spawn_shards({FABRIC_SHARDS}, device=cuda) up "
          f"in {spawn_s} s, each worker having ingested its {per} blocks "
          f"(uint8, cast on the card); pids {[p.pid for p in fleet.procs]}")
    try:
        fc = FabricClient.connect(fleet.addresses, sm, gids=gids, **cfg)
        try:
            before, _ = shard_reports(fc, "fabric processes, after spawn")
            ingest = [{k: b["process"]["launches"][k]
                       for k in ("cam_match", "bit_transpose")}
                      for b in before]
            if min(min(d.values()) for d in ingest) < 1:
                raise SystemExit(f"fabric processes: the ingest at spawn "
                                 f"launched {ingest}")
            out["processes"] = waves_and_storm(fc, "fabric processes")
            out["processes"]["storm"] = storm(fc, "fabric processes")
            health, metrics = shard_reports(fc, "fabric processes")
            per_shard = [process_delta(b["process"], h["process"],
                                       f"fabric processes, shard {s}")
                         for s, (b, h) in enumerate(zip(before, health))]
            launches = {n: sum(d[1][n] for d in per_shard) for n in bitmap}
            if min(launches[n] for n in ("bulk_program", "bitmap_query")) < 1:
                raise SystemExit(f"fabric processes: launches {launches}")
            for s, (w, n) in enumerate(per_shard):
                print(f"fabric processes, shard {s} (pid "
                      f"{health[s]['process']['pid']}): waves per backend "
                      f"{w}; launches {n}; ladder "
                      f"{ladder_of(health[s], 'fabric processes')}; "
                      f"service p50 {metrics[s]['latency_p50_ms']} ms, "
                      f"batch mean {metrics[s]['batch_mean']}")
            # one exactly-once append: block 0 again under the next seq,
            # then the same envelope resent, which must be a duplicate
            shard = int(sm.route(host_blocks[0][:1],
                                 start_gid=fc.num_records)[0])
            t0 = time.perf_counter()
            n = fc.append_encoded(host_blocks[0])
            append_s = time.perf_counter() - t0
            seq = fc._next_seq[shard]
            dup = fc._shard_request(shard, Envelope("append", payload={
                "stream": fc._stream, "seq": seq,
                "records": np.asarray(host_blocks[0], np.int32)}),
                hedge=False)
            total = sum(p["num_records"] for p in fc.info())
            want = (BLOCKS + 1) * BLOCK
            if not dup.payload["duplicate"] or n != want or total != want:
                raise SystemExit(f"fabric processes: exactly-once append: "
                                 f"duplicate {dup.payload}, client {n}, "
                                 f"shards {total}, want {want}")
            after = fc.health()["shards"]
            ladder_of(after[shard], "fabric processes, append")
            app = {k: after[shard]["process"]["launches"][k]
                   - health[shard]["process"]["launches"][k]
                   for k in ("cam_match", "bit_transpose")}
            if min(app.values()) < 1:
                raise SystemExit(f"fabric processes: the append launched "
                                 f"{app}")
            # every worker's counters started at 0 when it spawned
            lifetime = {n: sum(h["process"]["launches"][n] for h in after)
                        for n in bitmap}
            for rec in records:
                if rec["name"] in lifetime:
                    rec.setdefault("fabric_launches", {})["12b"] = \
                        lifetime[rec["name"]]
            print(f"fabric processes: exactly-once append of block 0 to "
                  f"shard {shard} (seq {seq}) in {append_s} s, the resent "
                  f"seq acknowledged duplicate={dup.payload['duplicate']}; "
                  f"info() totals {total} records = {BLOCKS + 1} x {BLOCK}; "
                  f"the append launched {app} in that worker; the workers' "
                  f"launches since spawn (ingest {ingest}, waves, storm, "
                  f"append) {lifetime}")
        finally:
            fc.close(timeout=300)
    finally:
        fleet.close(timeout=120)
    alive = [p.pid for p in fleet.procs if p.is_alive()]
    if alive:
        raise SystemExit(f"fabric processes: workers {alive} did not exit")
    print(f"fabric processes: the fleet closed, all {FABRIC_SHARDS} workers "
          f"exited (codes {[p.exitcode for p in fleet.procs]})")
    out["processes"].update(
        spawn_s=spawn_s, launches=launches, append_s=append_s,
        ingest_launches=ingest, lifetime_launches=lifetime,
        per_shard=[{"waves": w, "launches": n} for w, n in per_shard],
        shard_latency_p50_ms=[m["latency_p50_ms"] for m in metrics],
        shard_batch_mean=[m["batch_mean"] for m in metrics])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fabric: phase 12 took {out['phase_s']} s")
    print(json.dumps({"fabric_path": out}))


def bwd_errors(got, want, dtype) -> dict:
    """Each of dq, dk, dv held to its own ``bwd_tol``: its max abs error,
    its tolerance, the largest magnitude of the plain version's output
    (which sets the tolerance's ulp term; the reader sees the check has
    teeth where it is well above 2e-4) and err/tol."""
    from torch_checks import bwd_tol
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err, tol = max_abs_err(a, b), bwd_tol(b, dtype)
        out[name] = {"err": err, "tol": tol,
                     "want_max": float(b.float().abs().max()),
                     "err/tol": err / tol}
    return out


def check_flash_backward(torch, dev, rng, attention) -> None:
    """Phase 2's backward checks (see the module docstring)."""
    from torch_checks import FLASH_BWD_CASES, bwd_tol, flash_bwd_inputs
    worst, n_cases = {}, {}
    for seq, hd, g, causal, dt in FLASH_BWD_CASES:
        q, k, v, dout = flash_bwd_inputs(rng, seq, hd, g, dt, dev)
        out, lse = attention.flash_attention_fwd(q, k, v, causal=causal,
                                                 return_lse=True)
        got = attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                            causal=causal)
        again = attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal=causal)
        _, want_lse = attention.flash_attention_fwd_plain(
            q.float(), k.float(), v.float(), causal=causal, return_lse=True)
        want = attention.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
            causal=causal)
        torch.cuda.synchronize()
        case = f"S={seq} hd={hd} H/KV={g} causal={causal} {dt}"
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise SystemExit(f"flash_attention_bwd: two launches on the same "
                             f"inputs differ at {case}")
        ratios = {"lse": max_abs_err(lse, want_lse) / 1e-5}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            ratios[name] = max_abs_err(a, b) / bwd_tol(b, dt)
        for name, ratio in ratios.items():
            if not ratio <= 1:
                raise SystemExit(f"flash_attention_bwd: {name} disagrees with "
                                 f"the plain version at {case}: err/tol "
                                 f"{ratio}")
            key = (str(dt), hd, name)
            worst[key] = max(worst.get(key, (0.0, "")), (ratio, case))
            n_cases[key] = n_cases.get(key, 0) + 1
    for key, (ratio, case) in sorted(worst.items()):
        dt, hd, name = key
        print(f"check flash_attention_bwd {dt} hd={hd} {name}: "
              f"{n_cases[key]} ragged cases within tolerance, "
              f"worst err/tol {ratio} at {case}; two launches bit-identical")
    # the training path's shape (phase 13a: B = 4, S = 2048, H = 28, KV =
    # 4, hd = 128, causal, bf16) on standard-normal inputs, where the
    # outputs' ulp term rules bwd_tol
    q, k, v, dout = flash_bwd_inputs(rng, TRAIN_SEQ, 128, 7, torch.bfloat16,
                                     dev, batch=TRAIN_BATCH, kv=4)
    out, lse = attention.flash_attention_fwd(q, k, v, causal=True,
                                             return_lse=True)
    got = attention.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    again = attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=True)
    want = attention.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
        causal=True)
    torch.cuda.synchronize()
    errs = bwd_errors(got, want, torch.bfloat16)
    case = f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal, bf16"
    if not (all(torch.equal(a, b) for a, b in zip(got, again))
            and all(e["err/tol"] <= 1 for e in errs.values())):
        raise SystemExit(f"flash_attention_bwd at the training shape {case}: "
                         f"{errs}, or two launches differ")
    print(f"check flash_attention_bwd at the training shape {case}, unit "
          f"scale: {errs}; two launches bit-identical")
    del q, k, v, dout, out, lse, got, again, want
    # in each of up to three sessions of one call (a session that recorded
    # fewer than the two launches is taken again) the C entry must launch
    # each kernel of the pair it picks once and no other kernel (its count
    # at the launch site), and the profiler must see no kernel of the
    # other pair and no more than those launches.  The profiler loses
    # records (PERF.md section 7: the dq kernel's, in every session of
    # some runs, while the card tests saw it), so what it saw of the
    # pair's own kernels is printed
    for dt, hd, route in ((torch.bfloat16, 128, "tensor cores"),
                          (torch.bfloat16, 64, "tensor cores"),
                          (torch.bfloat16, 256, "tensor cores"),
                          (torch.float32, 128, "CUDA cores"),
                          (torch.float32, 256, "CUDA cores"),
                          (torch.bfloat16, 32, "CUDA cores")):
        q, k, v, dout = flash_bwd_inputs(rng, 300, hd, 7, dt, dev)
        out, lse = attention.flash_attention_fwd(q, k, v, causal=True,
                                                 return_lse=True)
        pair = BWD_KERNELS[route]
        union, clean = set(), True
        for _ in range(3):
            seen = {}
            _, launched = route_launches(torch, attention, lambda: (
                device_profile(torch, lambda: attention.flash_attention_bwd(
                    q, k, v, out, lse, dout, causal=True), 1, seen)))
            got = {n: launches_named(seen, n)
                   for both in BWD_KERNELS.values() for n in both}
            union |= {n for n in pair if got[n]}
            clean = clean and all(got[n] <= 1 for n in pair) and (
                launches_named(seen, "flash_bwd") == sum(got[n] for n in pair))
            if launched != {n: int(n in pair) for n in attention.KERNELS}:
                raise SystemExit(f"flash_attention_bwd {dt} hd={hd}: the C "
                                 f"entry launched {launched}, want one "
                                 f"launch each of {pair}")
            if launches_named(seen, "flash_bwd") >= 2:
                break
        if not clean:
            raise SystemExit(f"flash_attention_bwd {dt} hd={hd}: profiler "
                             f"saw {seen}, want one launch each of {pair}")
        print(f"check flash_attention_bwd {dt} hd={hd}: the C entry launched "
              f"one each of {pair} ({route}); over its sessions the "
              f"profiler saw {sorted(union)} of them and no kernel of the "
              f"other pair")


#: the kernels of each route of the two C entries under a window, as the
#: profiler names them: bf16 at head_dim 64 / 128 / 256 (Gemma3's) on the
#: tensor cores, fp32 on the CUDA cores
MASK_KERNELS = {
    "tensor cores": ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                     "flash_bwd_dkdv_wgmma"),
    "CUDA cores": ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkdv_kernel")}


def check_flash_masked(torch, dev, rng, attention) -> None:
    """Phase 2's windowed and offset checks (see the module docstring)."""
    from torch_checks import (FLASH_OFFSET_CASES, FLASH_WINDOW_CASES,
                              flash_bwd_inputs, flash_mask_ratios)
    cases = [(f"S={s_} window={w_} hd={hd} H/KV={g}", hd, dt,
              (s_, hd, g, dt), {"skv": None},
              {"causal": True, "window": w_})
             for s_, w_, hd, g, dt in FLASH_WINDOW_CASES]
    for sq, skv, qo, kl, w_, causal in FLASH_OFFSET_CASES:
        for hd, dt in itertools.product((64, 128, 256),
                                        (torch.float32, torch.bfloat16)):
            g = 2 if hd == 256 else 7
            cases.append((f"Sq={sq} Skv={skv} q_offset={qo} kv_len={kl} "
                          f"window={w_} causal={causal} hd={hd} H/KV={g}",
                          hd, dt, (sq, hd, g, dt), {"skv": skv},
                          {"causal": causal, "window": w_, "q_offset": qo,
                           "kv_len": kl}))
    worst, n_cases = {}, {}
    for case, hd, dt, shape, extra, mask in cases:
        q, k, v, dout = flash_bwd_inputs(rng, *shape, dev, **extra)
        ratios = flash_mask_ratios(attention, q, k, v, dout, **mask)
        torch.cuda.synchronize()
        for name, ratio in ratios.items():
            if not ratio <= 1:
                raise SystemExit(f"flash kernels under a mask: {name} "
                                 f"err/tol {ratio} at {case} {dt} (repeat: "
                                 f"two backward launches differ)")
            key = (str(dt), hd, name)
            worst[key] = max(worst.get(key, (0.0, "")), (ratio, case))
            n_cases[key] = n_cases.get(key, 0) + 1
    for (dt, hd, name), (ratio, case) in sorted(worst.items()):
        print(f"check flash under a mask {dt} hd={hd} {name}: "
              f"{n_cases[dt, hd, name]} windowed and offset cases within "
              f"tolerance, worst err/tol {ratio} at {case}")
    # under a window the C entries pick each route's kernels: in each of
    # up to three sessions of the forward and of the backward alone (phase
    # 2's unmasked shape) they must launch each of the route's kernels once
    # and no other (their counts at the launch sites), and the profiler
    # must see none of the other route's.  It loses kernel records, up to
    # all of a session's (PERF.md section 7; it lost this forward's in
    # every session of two runs of phase 2 while the card tests saw it), so
    # what it saw of the route's own kernels is printed
    for hd, dt, route in ((64, torch.bfloat16, "tensor cores"),
                          (128, torch.bfloat16, "tensor cores"),
                          (256, torch.bfloat16, "tensor cores"),
                          (256, torch.float32, "CUDA cores")):
        q, k, v, dout = flash_bwd_inputs(rng, 300, hd, 2, dt, dev)
        out, lse = attention.flash_attention_fwd(q, k, v, causal=True,
                                                 window=64, return_lse=True)
        calls = {"forward": lambda: attention.flash_attention_fwd(
            q, k, v, causal=True, window=64),
                 "backward": lambda: attention.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=True, window=64)}
        for (what, fn), want in zip(calls.items(), (
                MASK_KERNELS[route][:1], MASK_KERNELS[route][1:])):
            got = dict.fromkeys((n for names in MASK_KERNELS.values()
                                 for n in names), 0)
            for _ in range(3):
                seen = {}
                _, launched = route_launches(
                    torch, attention, lambda: device_profile(torch, fn, 1,
                                                             seen))
                if launched != {n: int(n in want) for n in launched}:
                    raise SystemExit(f"flash {what} under a window, {dt} "
                                     f"hd={hd}: the C entry launched "
                                     f"{launched}, want one each of {want}")
                for n in got:
                    got[n] += launches_named(seen, n)
                if all(got[n] for n in want):
                    break
            others = {n: c for n, c in got.items() if n not in want and c}
            if others:
                raise SystemExit(f"flash {what} under a window, {dt} "
                                 f"hd={hd}: the profiler saw {others}, "
                                 f"kernels of the route other than "
                                 f"{route}'s {want}")
            print(f"check flash {what} under a window, {dt} hd={hd}: the C "
                  f"entry launched one each of {want} ({route}) and no "
                  f"other; the profiler saw no kernel of the other route "
                  f"and, of {want}, {[got[n] for n in want]} launches in "
                  f"sessions of one call (last session's kernels: "
                  f"{sorted(seen)[:4]})")


def check_flash_encdec(torch, dev, rng, attention) -> None:
    """Phase 2's Whisper cases (see the module docstring): both flash
    kernels, bidirectional, at ``torch_checks.ENCDEC_FLASH_CASES``, each
    case one forward and two backward launches by the wrappers' counters;
    the profiler must see no kernel of the CUDA-core route for bf16 (head
    dim 64: the tensor cores)."""
    from torch_checks import (ENCDEC_FLASH_CASES, ENCDEC_FLASH_SHAPE,
                              flash_bwd_inputs, flash_mask_ratios)
    sh = ENCDEC_FLASH_SHAPE
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd
    for sq, skv, dt in ENCDEC_FLASH_CASES:
        q, k, v, dout = flash_bwd_inputs(rng, sq, sh["hd"], sh["g"], dt, dev,
                                         batch=sh["batch"], kv=sh["kv"],
                                         skv=skv)
        case = (f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, bidirectional, "
                f"{dt}")
        f0, b0 = fwd.launches, bwd.launches
        ratios = flash_mask_ratios(attention, q, k, v, dout, causal=False)
        torch.cuda.synchronize()
        launched = (fwd.launches - f0, bwd.launches - b0)
        if launched != (1, 2) or not all(r <= 1 for r in ratios.values()):
            raise SystemExit(f"flash kernels at Whisper's shape {case}: "
                             f"err/tol {ratios} (repeat: two backward "
                             f"launches differ); launches (forward, "
                             f"backward) {launched}, want (1, 2)")
        print(f"check flash at Whisper's shape {case}: err/tol {ratios}; "
              f"launches (forward, backward) {launched}")
        if dt != torch.bfloat16:
            continue
        out, lse = fwd(q, k, v, causal=False, return_lse=True)
        got = dict.fromkeys((n for names in MASK_KERNELS.values()
                             for n in names), 0)
        for _ in range(3):              # the profiler now and then misses
            seen = {}
            device_profile(torch, lambda: (
                fwd(q, k, v, causal=False),
                bwd(q, k, v, out, lse, dout, causal=False)), 1, seen)
            for n in got:
                got[n] += launches_named(seen, n)
            if all(got[n] for n in MASK_KERNELS["tensor cores"]):
                break
        others = {n: got[n] for n in MASK_KERNELS["CUDA cores"] if got[n]}
        if others:
            raise SystemExit(f"flash at Whisper's shape {case}: the profiler "
                             f"saw {others}, kernels of the CUDA-core route")
        print(f"check flash at Whisper's shape {case}: no CUDA-core kernel; "
              f"of {MASK_KERNELS['tensor cores']} the profiler saw "
              f"{[got[n] for n in MASK_KERNELS['tensor cores']]} launches")
        del q, k, v, dout, out, lse


def check_step_backward(seen: dict, launched: dict, layers: int,
                        label: str) -> dict:
    """The backward kernels of one train step: the C entry must have
    launched (``launched``, {kernel: launches} as it counts them) one a
    layer of each tensor-core kernel and none of the CUDA-core pair, and
    the profiler (``seen``, {kernel: launches}) must see none of the
    CUDA-core pair and no more than those; it loses records (PERF.md
    section 7), so what it saw of the tensor-core pair is printed.  Else
    the run fails."""
    got = {n: launches_named(seen, n)
           for pair in BWD_KERNELS.values() for n in pair}
    got["kernels seen"] = sum(seen.values())
    if (any(launched[n] != layers for n in BWD_KERNELS["tensor cores"])
            or any(launched[n] for n in BWD_KERNELS["CUDA cores"])
            or any(got[n] > layers for n in BWD_KERNELS["tensor cores"])
            or any(got[n] for n in BWD_KERNELS["CUDA cores"])):
        raise SystemExit(f"train {label}: the C entry launched {launched}, "
                         f"the profiler saw backward launches {got}; want "
                         f"{layers} of each of {BWD_KERNELS['tensor cores']}"
                         f" and none else")
    print(f"train {label}: the C entry launched {layers} of each of "
          f"{BWD_KERNELS['tensor cores']} and none of the CUDA-core pair; "
          f"the profiler saw backward launches {got}")
    return got


def backward_launch_ms(torch, attention, args, reps: int = 10) -> dict:
    """Card ms a launch of each backward kernel (profiler names holding
    ``flash_bwd``) over ``reps`` calls of ``flash_attention_bwd(*args)``:
    its card time over the launches the profiler saw (it can miss some),
    and that count."""
    seen = {}
    _, _, by_name = device_profile(
        torch, lambda: attention.flash_attention_bwd(*args, causal=True),
        reps, seen)
    return {k: {"ms": v * reps / seen[k], "launches": seen[k]}
            for k, v in by_name.items() if "flash_bwd" in k}


def plain_routes(torch, attention, kernel_forward: bool = False,
                 windows: list | None = None):
    """Plain stand-ins for ``models.flash``'s two entries, the comparison
    routes of phases 7, 13a and 15 (here only: the package has no switch):
    (serving forward, training vjp).  Both forward the mask arguments
    (``window``, ``q_offset``, ``kv_len``) and append each call's window
    to ``windows``.  The vjp runs the plain backward after the plain
    forward or, with ``kernel_forward``, after the forward kernel."""
    fwd = (attention.flash_attention_fwd if kernel_forward
           else attention.flash_attention_fwd_plain)

    class PlainVJP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, mask):
            out, lse = fwd(q, k, v, causal=causal, return_lse=True, **mask)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.mask = causal, mask
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return (*attention.flash_attention_bwd_plain(
                q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
                **ctx.mask), None, None)

    def mask_of(window, q_offset, kv_len):
        if windows is not None:
            windows.append(window)
        return {"window": window, "q_offset": q_offset, "kv_len": kv_len}

    def serve(q, k, v, *, causal, window=None, q_offset=0, kv_len=None):
        return attention.flash_attention_fwd_plain(
            q, k, v, causal=causal, **mask_of(window, q_offset, kv_len))

    def vjp(q, k, v, *, causal, window=None, q_offset=0, kv_len=None,
            **options):
        return PlainVJP.apply(q, k, v, causal,
                              mask_of(window, q_offset, kv_len))
    return serve, vjp


@contextlib.contextmanager
def swapped(tflash, serve=None, vjp=None):
    """``models.flash``'s serving and training entries replaced (those
    given) for the block's duration."""
    saved = tflash.flash_attention, tflash.flash_attention_vjp
    tflash.flash_attention = serve or saved[0]
    tflash.flash_attention_vjp = vjp or saved[1]
    try:
        yield
    finally:
        tflash.flash_attention, tflash.flash_attention_vjp = saved


@contextlib.contextmanager
def no_plain_attention(attention):
    """The flash wrappers' plain versions made to raise for the block's
    duration: a call on the card that is not a kernel launch fails."""
    saved = (attention.flash_attention_fwd_plain,
             attention.flash_attention_bwd_plain)

    def refuse(*args, **kwargs):
        raise SystemExit("a flash wrapper ran its plain version on the card")
    attention.flash_attention_fwd_plain = refuse
    attention.flash_attention_bwd_plain = refuse
    try:
        yield
    finally:
        (attention.flash_attention_fwd_plain,
         attention.flash_attention_bwd_plain) = saved


def training_path(torch, dev, seed: int, zero_counts, counted, read_waves,
                  kernel, records) -> dict:
    """Phase 13a (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    from repro_torch.engine.planner import key
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import (OptimConfig, apply_updates,
                                         init_opt_state)
    from repro_torch.train.step import TrainConfig, make_train_step
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    need = STATE_BYTES_PER_PARAM * full.param_count()
    print(f"train cut: {full.name} at its published width with num_layers "
          f"{full.num_layers} -> {TRAIN_LAYERS}: fp32 master weights, "
          f"gradients and AdamW moments take {STATE_BYTES_PER_PARAM} B/param, "
          f"{STATE_BYTES_PER_PARAM} x {full.param_count()} = {need} B > "
          f"{CARD_BYTES} B on the card; at {TRAIN_LAYERS} layers "
          f"{STATE_BYTES_PER_PARAM * cfg.param_count()} B")
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev,
                                dtype=torch.float32)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    opt = init_opt_state(params, ocfg)
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in params.parameters())
    print(f"train: {nparam} parameters (config {cfg.param_count()}), fp32 "
          f"masters and moments on the card in {time.perf_counter() - t0} s,"
          f" {torch.cuda.memory_allocated()} bytes allocated")

    # the data plane: the shards' ingest and the selection on the card
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      num_shards=4, num_attributes=32, seed=seed)
    zero_counts()
    t0 = time.perf_counter()
    ds = BitmapIndexedDataset(dcfg, device=dev)
    stream = ds.batches(TRAIN_BATCH, where=key(3) & key(18) & ~key(25),
                        seed=seed)
    first = next(stream)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    data_launches = {n: fn.launches for n, fn in counted.items()}
    waves = read_waves("train data")
    selected = sum(len(ds.select(s, where=key(3) & key(18) & ~key(25)))
                   for s in range(dcfg.num_shards))
    print(f"train data: BitmapIndexedDataset of {dcfg.num_shards} x "
          f"{dcfg.docs_per_shard} documents of {TRAIN_SEQ + 1} tokens, "
          f"{selected} selected by key(3) & key(18) & ~key(25); first batch "
          f"in {data_s} s; launches {data_launches}; waves per backend "
          f"{waves}")
    if (not data_launches["cam_match"] or not data_launches["bit_transpose"]
            or not (data_launches["bitmap_query"]
                    + data_launches["bulk_program"])):
        raise SystemExit(f"train data: the bitmap kernels did not run "
                         f"({data_launches})")
    if first["tokens"].shape != (TRAIN_BATCH, TRAIN_SEQ):
        raise SystemExit(f"train data: batch {tuple(first['tokens'].shape)}")

    # the loss and the q/k/v gradients of layers 0 and L-1, kernel route
    # against the plain route (not counted), on ROUTE_BATCHES batches: the
    # first and the next ones of the stream.  A third route, the forward
    # kernel with the plain backward, splits the difference into the
    # backward's share (kernel vs mixed: the same forward) and the
    # forward's (mixed vs plain: the same backward)
    from torch_checks import bwd_tol, unit_rms
    last = cfg.num_layers - 1
    names = [(i, n) for i in (0, last) for n in ("wq", "wk", "wv")]
    vjps = {"kernel": None,
            "mixed": plain_routes(torch, attention, kernel_forward=True)[1],
            "plain": plain_routes(torch, attention)[1]}

    def route(batch, which: str):
        with swapped(tflash, vjp=vjps[which]):
            params.requires_grad_(True)
            loss, _ = tmodel.lm_loss(params, cfg, batch)
            loss.backward()
        grads = {(i, n): getattr(params.layers[i], n).grad.clone()
                 for i, n in names}
        params.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    def rel(a, b):
        (a_loss, a_grads), (b_loss, b_grads) = a, b
        err = {"loss": abs(a_loss - b_loss) / abs(b_loss)}
        for i, n in names:
            err[f"layer{i}.{n}"] = float((a_grads[i, n] - b_grads[i, n])
                                         .norm() / b_grads[i, n].norm())
        return err
    route_errs, fails = [], []
    for b_i in range(ROUTE_BATCHES):
        batch = first if b_i == 0 else next(stream)
        got = {which: route(batch, which) for which in vjps}
        torch.cuda.synchronize()
        err = {"kernel_vs_plain": rel(got["kernel"], got["plain"]),
               "kernel_vs_mixed": rel(got["kernel"], got["mixed"]),
               "mixed_vs_plain": rel(got["mixed"], got["plain"])}
        print(f"train check, batch {b_i}: loss kernel route "
              f"{got['kernel'][0]}, plain route {got['plain'][0]}; relative "
              f"differences {err} (tolerances {ROUTE_TOL}, on kernel vs "
              f"plain, the loss and layer 0)")
        if b_i == 0:                    # phase 19a's unsharded reference
            mesh_ref = {"tokens": first["tokens"].cpu(),
                        "labels": first["labels"].cpu(),
                        "loss": got["kernel"][0],
                        "grads": {n: got["kernel"][1][0, n].cpu()
                                  for n in ("wq", "wk", "wv")}}
        e = err["kernel_vs_plain"]
        if not (e["loss"] <= ROUTE_TOL["loss"] and all(
                e[f"layer0.{n}"] <= ROUTE_TOL["grad"]
                for n in ("wq", "wk", "wv"))
                and np.isfinite(got["kernel"][0])):
            fails.append(b_i)
        route_errs.append(err)
        del got
    route_err = route_errs[0]["kernel_vs_plain"]
    if fails:
        raise SystemExit(f"train check: the kernel route differs from the "
                         f"plain route on batches {fails}")

    # one counted step: 2 forward launches per layer (forward + remat
    # recompute) and one backward launch, the plain versions never run;
    # layers 0 and L-1 captured (q, k, v, out and dout) on the first call
    step = make_train_step(cfg, TrainConfig(ocfg))
    captured = {}

    def capture(i):
        def hook(module, inputs, output):
            if i in captured:
                return                      # the recompute under remat
            captured[i] = [t.detach() for t in inputs] + [output.detach()]
            output.register_hook(lambda g: captured[i].append(g.detach()))
        return hook
    hooks = [params.layers[i].attn_core.register_forward_hook(capture(i))
             for i in (0, last)]
    # The step runs under the profiler, which now and then records
    # nothing or misses launches: then the next step (the same batch) is
    # profiled, up to three steps, each counted alike, and a step that
    # nothing recorded fails; the plain versions raise meanwhile
    losses, first_s = [], None
    try:
        with no_plain_attention(attention):
            for attempt in range(3):
                zero_counts()
                first_seen, res = {}, []
                t0 = time.perf_counter()
                _, first_launched = route_launches(
                    torch, attention, lambda: device_profile(
                        torch, lambda: res.append(step(params, opt, first)),
                        1, first_seen))
                params, opt, m = res[0]
                first_s = first_s or time.perf_counter() - t0
                losses.append(float(m["loss"]))
                step_launches = {n: fn.launches for n, fn in counted.items()}
                print(f"train step {attempt + 1}: under the profiler, loss "
                      f"{losses[-1]}, launches {step_launches}, no plain "
                      f"attention, {sum(first_seen.values())} card kernels "
                      f"recorded")
                if (step_launches["flash_attention_fwd"] != 2 * cfg.num_layers
                        or step_launches["flash_attention_bwd"]
                        != cfg.num_layers):
                    raise SystemExit(f"train step: want {2 * cfg.num_layers} "
                                     f"forward and {cfg.num_layers} backward "
                                     f"kernel launches, saw {step_launches}")
                if all(launches_named(first_seen, n) >= cfg.num_layers
                       for n in BWD_KERNELS["tensor cores"]):
                    break
    finally:
        for h in hooks:
            h.remove()
    print(f"train step 1: {first_s} s (first, under the profiler)")
    if not first_seen:
        raise SystemExit("train: the profiler recorded no kernel in three "
                         "counted steps")
    bwd_seen = [check_step_backward(first_seen, first_launched,
                                    cfg.num_layers, f"step {len(losses)}")]

    # the backward kernel at the captured layers, by the bf16 check, on
    # the step's dout brought to unit RMS by a power of two (exact; the
    # gradients scale by it exactly): at the step's own scale they are so
    # small that bwd_tol's absolute 2e-4 would pass zeros
    layer_err = {}
    for i, (cq, ck, cv, cout, cdout) in captured.items():
        out, lse = attention.flash_attention_fwd(cq, ck, cv, causal=True,
                                                 return_lse=True)
        if not torch.equal(out, cout):
            raise SystemExit(f"train check: layer {i}'s forward is not the "
                             "step's")
        udout = unit_rms(cdout)
        got = attention.flash_attention_bwd(cq, ck, cv, out, lse, udout,
                                            causal=True)
        want = attention.flash_attention_bwd_plain(
            cq.float(), ck.float(), cv.float(), out.float(), lse,
            udout.float(), causal=True)
        errs = bwd_errors(got, want, cq.dtype)
        errs["dout scaled by"] = float((udout.float().abs().max()
                                        / cdout.float().abs().max()))
        if not all(e["err/tol"] <= 1 for n, e in errs.items()
                   if n in ("dq", "dk", "dv")):
            raise SystemExit(f"flash_attention_bwd at layer {i}: {errs}")
        layer_err[i] = errs
        del got, want, udout
    print(f"train check: backward kernel vs plain at layers 0 and {last} "
          f"(q {tuple(captured[0][0].shape)}, bf16, dout at unit RMS): "
          f"{layer_err}")

    # the steps, on the first batch again: finite losses that fall.  The
    # synthetic corpus is uniform random tokens, so on fresh batches the
    # loss can only lose the initial logits' excess over ln V, a few
    # hundredths of a nat in six steps at this learning rate (inside the
    # noise between batches); on a fixed batch, memorized as in the
    # reference's learning test, it falls by nats.
    times, alone = [], {}
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (step_alone(torch, alone) if i == 0
              else contextlib.nullcontext()):
            params, opt, m = step(params, opt, first)
        losses.append(float(m["loss"]))       # waits for the step
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model flops: 6 N T for the products (the embedding gather is none),
    # 2 N_layers T for the remat recompute, and attention's causal half:
    # forward, recompute and the backward's 2.5x
    n_layers = sum(p.numel() for p in params.layers.parameters())
    n_prod = nparam - params.embed.numel()
    attn = (2 * TRAIN_SEQ * (TRAIN_SEQ + 1) * cfg.head_dim * TRAIN_BATCH
            * cfg.num_heads * cfg.num_layers)
    flops = 6 * n_prod * tokens + 2 * n_layers * tokens + 4.5 * attn
    peak = max(alone["carried"], torch.cuda.max_memory_allocated())
    note_peak(torch, "13a", cfg, "train", TRAIN_BATCH, TRAIN_SEQ, resident,
              peak, (params, opt, first), alone,
              token_dtype=first["tokens"].dtype)
    print(f"train steps: losses {losses}; step {step_s * 1e3} ms (median of "
          f"{TRAIN_STEPS}; {[t * 1e3 for t in times]}), {tokens / step_s} "
          f"tokens/s, {flops} model flops a step = "
          f"{flops / step_s / PEAK_BF16} of 989e12 flop/s; peak "
          f"{peak} bytes allocated")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"train steps: losses {losses} not finite and "
                         "falling")

    # the optimizer alone: one AdamW update over every parameter (zero
    # gradients; it consumes them, so the update is timed once)
    named = dict(params.named_parameters())
    grads = {k: torch.zeros_like(p) for k, p in named.items()}
    torch.cuda.synchronize()
    _, adamw_ms, _ = device_profile(
        torch, lambda: apply_updates(named, grads, opt, ocfg))
    del grads, named
    print(f"train: one AdamW update of {nparam} fp32 parameters: "
          f"{adamw_ms} ms of card time")

    # where the time goes: one step profiled
    batch = next(stream)
    for _ in range(3):                  # the profiler now and then sees none
        seen = {}
        (wall, busy, by_name), launched = route_launches(
            torch, attention, lambda: device_profile(
                torch, lambda: step(params, opt, batch), 1, seen))
        if seen:
            break
    prof = profile("one train step", wall, busy, by_name)
    bwd_seen.append(check_step_backward(seen, launched, cfg.num_layers,
                                        "the profiled step"))
    bwd_ms = sum(v for k_, v in by_name.items() if "flash_bwd" in k_)
    groups = {"flash backward kernel": ("flash_bwd",),
              "flash forward kernel": ("flash_fwd",),
              "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass"),
              "elementwise and reductions": ("elementwise", "reduce",
                                             "Reduce")}
    split = dict.fromkeys(groups, 0.0)
    split["other"] = 0.0
    for k_, v in by_name.items():
        g_ = next((g for g, keys in groups.items()
                   if any(x in k_ for x in keys)), "other")
        split[g_] += v
    prof["split_ms"] = split
    print("  by group: " + "; ".join(f"{g} {v} ms" for g, v in split.items()))

    # the backward kernel at the path's shape, beside its plain version and
    # the library's backward (SDPA, timed only)
    cq, ck, cv, cout, cdout = captured[0]
    cdout = unit_rms(cdout)             # as the layer check, for bwd_tol
    out, lse = attention.flash_attention_fwd(cq, ck, cv, causal=True,
                                             return_lse=True)
    B_, S_, H_, hd_ = cq.shape
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (cq, ck, cv))
    so = torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, is_causal=True, enable_gqa=True)
    sdo = cdout.transpose(1, 2).contiguous()
    nbytes = (2 * (4 * cq.numel() + 4 * ck.numel()) + 4 * lse.numel())
    fwd_flops = 2 * S_ * (S_ + 1) * hd_ * B_ * H_
    want = attention.flash_attention_bwd_plain(cq, ck, cv, out, lse, cdout,
                                               causal=True)
    bwd_launch = backward_launch_ms(torch, attention,
                                    (cq, ck, cv, out, lse, cdout))
    print(f"train: backward kernels at layer 0's shape, the profiler's card "
          f"ms a launch over 10 calls: {bwd_launch}")
    kernel("flash_attention_bwd", "attention.cu",
           "src/repro/models/flash.py:262",
           f"q {tuple(cq.shape)}, k/v {tuple(ck.shape)}, causal, bf16",
           lambda: attention.flash_attention_bwd(cq, ck, cv, out, lse, cdout,
                                                 causal=True),
           lambda: attention.flash_attention_bwd_plain(cq, ck, cv, out, lse,
                                                       cdout, causal=True),
           nbytes, 2.5 * fwd_flops, 10,
           count=step_launches["flash_attention_bwd"],
           tol=[bwd_tol(w, torch.bfloat16) for w in want],
           peak_ops=PEAK_BF16,
           library=lambda: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                               retain_graph=True))
    del want, so, sq, sk, sv, sdo
    rec = records[-1]
    print(f"train: backward kernel {rec['ms']} ms against its bound "
          f"{rec['bound_ms']} ms ({rec['bound_ms'] / rec['ms']} of it) and "
          f"SDPA's backward {rec['library_ms']} ms; {cfg.num_layers} "
          f"launches a step = {bwd_ms} ms of the profiled step's "
          f"{prof['busy_ms']} ms busy")
    for r in records:
        if r["name"] == "flash_attention_fwd":
            r["train_launches"] = step_launches["flash_attention_fwd"]
    out_rec = {"arch": cfg.name, "layers": cfg.num_layers,
               "params": nparam, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
               "data_s": data_s, "data_launches": data_launches,
               "route_err": route_err, "route_errs": route_errs,
               "first_step_s": first_s,
               "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
               "tokens_per_s": tokens / step_s, "model_flops": flops,
               "flops_share_of_989e12": flops / step_s / PEAK_BF16,
               "peak_bytes": peak, "losses": losses,
               "launches": step_launches, "profile": prof,
               "bwd_ms_in_step": bwd_ms, "bwd_launch": bwd_launch,
               "bwd_kernels_seen": bwd_seen, "adamw_ms": adamw_ms}
    print(json.dumps({"train_path": out_rec}))
    out_rec["mesh_reference"] = mesh_ref
    del params, opt, ds, stream, first, batch, captured, out, lse
    gc.collect()
    torch.cuda.empty_cache()
    return out_rec


def flash_modules(params) -> int:
    """The model's flash-attention modules (``FlashAttention``: a decoder
    layer's self- and cross-attention, an encoder layer's): one kernel
    launch each a prefill, two (forward and remat recompute) and one
    backward launch each a train step under remat."""
    from repro_torch.models.flash import FlashAttention
    return sum(isinstance(m, FlashAttention) for m in params.modules())


def note_peak(torch, label: str, cfg, kind: str, batch: int, seq: int,
              resident: int, peak: int, args: tuple, alone: dict,
              **step) -> None:
    """Keep a phase's step and memory for phase 18c (``PHASE_PEAKS``):
    ``args`` are the measured step's arguments (the model, and the
    optimizer state and batch, or the prefill's inputs), ``alone`` its
    :func:`step_alone` record."""
    from repro_torch.launch.dryrun import tree_bytes
    args = tuple(dict(a.named_parameters()) if isinstance(
        a, torch.nn.Module) else a for a in args)
    PHASE_PEAKS[label] = {"cfg": cfg, "kind": kind, "batch": batch,
                          "seq": seq, "resident": resident, "peak": peak,
                          "end": torch.cuda.memory_allocated(),
                          "args": tree_bytes(args), **alone, **step}


@contextlib.contextmanager
def step_alone(torch, alone: dict):
    """Read the card's peak around one step alone, for phase 18c:
    ``alone`` gets the peak of the phase's window so far (``carried``,
    read before the reset: the phase's peak is then ``max(carried,
    max_memory_allocated())``), the bytes allocated before the step
    (``before``) and the step's peak over them (``step_peak``)."""
    torch.cuda.synchronize()
    alone["carried"] = torch.cuda.max_memory_allocated()
    alone["before"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    yield alone
    torch.cuda.synchronize()
    alone["step_peak"] = torch.cuda.max_memory_allocated() - alone["before"]


def lm_serving(torch, tstep, attention, params, cfg, batch: dict,
               steps: int, zero_counts, counted, label: str, layers
               ) -> dict:
    """One LM serving path (phases 7 and 15): ``greedy_generate`` of
    ``steps`` tokens for ``batch`` (its tokens and any other prefill
    inputs), every counter zeroed just before and read just after with
    the flash wrappers' plain versions made to raise: the flash kernel
    must run once an attention layer (one prefill; none for an SSM model).
    Then the prefill and the decode
    steps timed apart (a CUDA synchronize around each), the flash module
    of each of ``layers`` captured by a hook as (q, k, v, window, out).
    Returns the path's numbers, its step functions and captures."""
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    B, S = tokens.shape
    fwd = counted["flash_attention_fwd"]
    zero_counts()
    t0 = time.perf_counter()
    with no_plain_attention(attention):
        gen = tstep.greedy_generate(params, cfg, tokens, steps=steps,
                                    **extra)
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    print(f"{label} path: greedy_generate B={B} prompt {S} steps {steps}: "
          f"{gen_s} s (first run), launches {launches}, no plain attention")
    attn_layers = flash_modules(params)
    if fwd.launches != attn_layers:
        raise SystemExit(f"{label}: flash_attention_fwd launched "
                         f"{fwd.launches} times in one prefill, want "
                         f"{attn_layers} (one an attention layer: encoder, "
                         f"self and cross)")
    if gen.shape != (B, steps) or not (
            0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size):
        raise SystemExit(f"{label} path: bad tokens {tuple(gen.shape)}")

    prefill = tstep.make_prefill_step(cfg, max_len=S + steps)
    decode = tstep.make_decode_step(cfg)
    captured = {}

    def capture(i):
        def hook(module, args, kwargs, output):
            captured[i] = (*args, kwargs.get("window"), output)
        return hook
    hooks = [params.layers[i].attn_core.register_forward_hook(
        capture(i), with_kwargs=True) for i in layers]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for h in hooks:
        h.remove()
    kernel_logits = logits[:, -1, :cfg.vocab_size].float()
    toks = [kernel_logits.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = decode(params, {"tokens": toks[-1][:, None],
                                        "cache": cache})
        toks.append(logits[:, -1, :cfg.vocab_size].argmax(-1))
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    tok_s = B * steps / ((prefill_ms + decode_ms * (steps - 1)) / 1e3)
    same = int((torch.stack(toks, 1) == gen).sum())
    print(f"{label} timing: prefill {prefill_ms} ms ({B} x {S} tokens), "
          f"decode {decode_ms} ms/step, {tok_s} generated tokens/s; "
          f"{same}/{gen.numel()} tokens equal to the first run's "
          f"[{CARD['smi']}]")
    return {"gen_s": gen_s, "gen": gen, "launches": launches,
            "prefill": prefill, "decode": decode, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "tok_s": tok_s,
            "kernel_logits": kernel_logits, "captured": captured}


def check_layers(attention, captured: dict, windows: list, label: str
                 ) -> dict:
    """The flash kernel at the captured layers ((q, k, v, window, out))
    against its plain version under the window each was given, which must
    be the model's (``windows``), by both bf16 checks of phase 2."""
    from torch_checks import attn_tol, bf16_attn_err
    layer_err = {}
    for i, (cq, ck, cv, w, cout) in captured.items():
        if w != windows[i]:
            raise SystemExit(f"{label}: layer {i} attended with window {w}, "
                             f"want {windows[i]}")
        want = attention.flash_attention_fwd_plain(
            cq.float(), ck.float(), cv.float(), causal=True, window=w)
        err, tol = max_abs_err(cout, want), attn_tol(want, cout.dtype)
        elem = bf16_attn_err(cout, want)
        if not (err <= tol and elem <= 1):
            raise SystemExit(f"flash_attention_fwd at layer {i} (window "
                             f"{w}): {err} > {tol} or element err/tol "
                             f"{elem} > 1")
        layer_err[i] = {"window": w, "err": err, "tol": tol,
                        "element": elem}
    print(f"{label}: flash kernel vs plain at layers {sorted(captured)} (q "
          f"{tuple(next(iter(captured.values()))[0].shape)}, bf16): "
          f"{layer_err}")
    return layer_err


def logit_route_checks(torch, tmodel, tflash, attention, cfg, prefill,
                       params, batch, kernel_logits, label: str,
                       windows: list | None = None) -> dict:
    """A prefill's last-position logits by the kernel route (bf16:
    ``kernel_logits``) against the same prefill with the plain attention
    swapped in (``plain_routes``, which must receive each layer's window),
    in bf16 and again with the compute dtype set to fp32 (the weights are
    cast at use, as the reference does): within LOGIT_TOL of their largest
    magnitude, with argmax equal on every batch row whose top-2 margin
    exceeds that tolerance.  ``windows``: the windows the plain route must
    receive, one a flash call in order (default each layer's)."""
    windows = tmodel.layer_windows(cfg) if windows is None else windows

    def route_logits(dtype, plain):
        seen = []
        with compute_dtype(tmodel, dtype), swapped(tflash, serve=plain_routes(
                torch, attention, windows=seen)[0] if plain else None):
            out, _ = prefill(params, batch)
        if plain and seen != windows:
            raise SystemExit(f"{label}: the plain route received the "
                             f"windows {seen}, want {windows}")
        return out[:, -1, :cfg.vocab_size].float()

    checks = {}
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
            raise SystemExit(f"{label} {name}: kernel-route logits differ "
                             f"from the plain route: {err} > {tol} or argmax "
                             f"{agree.tolist()} on decided rows "
                             f"{decided.tolist()}")
        checks[name] = {"err": err, "tol": tol,
                        "argmax_agree": int(agree.sum()),
                        "rows_decided": int(decided.sum())}
        print(f"{label} {name}: last-position logits, kernel vs plain route: "
              f"max err {err} <= {tol} ({frac} of max "
              f"{float(want.abs().max())}); argmax agrees on "
              f"{int(agree.sum())}/{got.shape[0]} rows ({int(decided.sum())} "
              f"rows with a top-2 margin above the tolerance)")
    return checks


def sdpa_beside(torch, q, k, v, keep):
    """``scaled_dot_product_attention`` of the model-layout q (B, S, H, hd)
    and k/v (B, S, KV, hd) under the boolean mask ``keep`` (S, S), the
    library yardstick (timed only; the port never calls it): a callable,
    with k and v broadcast to the H query heads beforehand, and the
    backend SDPA picks for these inputs (``torch._fused_sdp_choice``)
    beside the kernels the profiler saw it launch (it can miss them);
    (None, the error) if SDPA refuses the inputs."""
    g = q.shape[2] // k.shape[2]
    sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))

    def run():
        return torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=keep)
    try:
        run()
    except RuntimeError as exc:
        return None, f"refused: {exc}"[:200]
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(sq, sk, sv,
                                                     keep)).name
    except (AttributeError, ImportError, RuntimeError, TypeError,
            ValueError) as exc:
        backend = f"not known ({exc})"[:120]
    seen = {}
    device_profile(torch, run, 1, seen)
    return run, {"backend": backend,
                 "kernels": sorted(seen, key=lambda n: -seen[n])[:3]}


def window_serving(torch, dev, seed: int, zero_counts, counted, kernel
                   ) -> dict:
    """Phase 15a (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    from torch_checks import attn_tol
    cfg = get_config(WIN_ARCH)
    windows = tmodel.layer_windows(cfg)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in params.parameters())
    print(f"window lm: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window}, global layers "
          f"{[i for i, w in enumerate(windows) if w is None]}): {nparam} "
          f"parameters, made in {time.perf_counter() - t0} s")
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (WIN_BATCH, WIN_PROMPT))).to(dev)
    # a local, the first global and the last layer captured; the decode
    # positions are past the window on every local layer
    lm = lm_serving(torch, tstep, attention, params, cfg,
                    {"tokens": prompts}, WIN_STEPS, zero_counts, counted,
                    "window lm", (0, cfg.global_every - 1,
                                  cfg.num_layers - 1))
    prefill, decode, captured = lm["prefill"], lm["decode"], lm["captured"]
    layer_err = check_layers(attention, captured, windows, "window lm check")
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, prefill, params,
        {"tokens": prompts}, lm["kernel_logits"], "window lm check")

    # row 5w: the kernel at layer 0's shape (local), beside its plain
    # version, SDPA under the same boolean mask and its bound; then layer 0
    # beside the global layer at the same shape
    fq, fk, fv, w0, fo = captured[0]
    gq, gk, gv, gw, _ = captured[cfg.global_every - 1]
    B_, S_, H_, hd_ = fq.shape
    keep = attention.allowed(S_, S_, causal=True, window=w0, device=dev)
    pairs = int(keep.sum())
    library, sdpa_kernels = sdpa_beside(torch, fq, fk, fv, keep)
    print(f"window lm: SDPA under the window's boolean mask: {sdpa_kernels}")
    kernel("flash_attention_fwd window", "attention.cu",
           "src/repro/kernels/attention.py:67",
           f"q {tuple(fq.shape)}, k/v {tuple(fk.shape)}, causal, window "
           f"{w0}, bf16",
           lambda: attention.flash_attention_fwd(fq, fk, fv, causal=True,
                                                 window=w0),
           lambda: attention.flash_attention_fwd_plain(fq, fk, fv,
                                                       causal=True,
                                                       window=w0),
           2 * (2 * fq.numel() + fk.numel() + fv.numel()),
           4 * hd_ * pairs * B_ * H_, 10,
           count=lm["launches"]["flash_attention_fwd"],
           tol=attn_tol(fo, torch.bfloat16), peak_ops=PEAK_BF16,
           library=library)
    local_ms = event_ms(torch, lambda: attention.flash_attention_fwd(
        fq, fk, fv, causal=True, window=w0), 10, back_to_back=True)
    global_ms = event_ms(torch, lambda: attention.flash_attention_fwd(
        gq, gk, gv, causal=True, window=gw), 10, back_to_back=True)
    pair_ratio = pairs / (S_ * (S_ + 1) // 2)
    print(f"window lm: the kernel at layer 0 (window {w0}) {local_ms} ms "
          f"beside the global layer {cfg.global_every - 1} {global_ms} ms at "
          f"the same shape: ratio {local_ms / global_ms} (allowed pairs "
          f"{pairs} per (b, h), {pair_ratio} of the causal half; 1.0 would "
          f"mean the kernel only masks)")
    # a loose check that the kernel skips the tiles the window rules out:
    # halfway between the allowed pairs' share and masking alone
    if local_ms / global_ms > (1 + pair_ratio) / 2:
        raise SystemExit(f"window lm: a local layer takes {local_ms / global_ms}"
                         f" of a global one's time, more than "
                         f"{(1 + pair_ratio) / 2}: the kernel does not skip "
                         f"the tiles outside the window")

    # where the time goes: one prefill, one decode step.  At head_dim 256
    # the C entry must launch only the tensor-core forward in the prefill,
    # one a layer (its count at the launch site), and the profiler must
    # never see flash_fwd_kernel (what it saw of the tensor-core forward
    # is printed: it loses records, PERF.md section 7)
    for _ in range(3):          # the profiler now and then misses launches
        seen = {}
        reading, launched = route_launches(
            torch, attention, lambda: device_profile(torch, lambda: prefill(
                params, {"tokens": prompts}), 1, seen))
        prof = {"prefill": profile(
            f"one windowed prefill ({WIN_BATCH} x {WIN_PROMPT})", *reading)}
        if launches_named(seen, "flash_fwd") >= cfg.num_layers:
            break
    flash_kernels = {sym: launches_named(seen, sym)
                     for sym in ("flash_fwd_wgmma", "flash_fwd_kernel")}
    print(f"window lm check: the C entry launched {launched} in the "
          f"profiled prefill; the profiler saw {flash_kernels}")
    if (launched != {n: cfg.num_layers * (n == "flash_fwd_wgmma")
                     for n in attention.KERNELS}
            or flash_kernels["flash_fwd_kernel"]):
        raise SystemExit(f"window lm: want the prefill's {cfg.num_layers} "
                         f"flash launches on the tensor cores (bf16 at "
                         f"head_dim {cfg.head_dim}), the C entry launched "
                         f"{launched}, the profiler saw {flash_kernels}")
    prof["prefill"]["flash_kernels"] = flash_kernels
    logits, cache = prefill(params, {"tokens": prompts})
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    prof["decode"] = profile("one windowed decode step", *device_profile(
        torch, lambda: decode(params, {"tokens": nxt, "cache": cache})))
    out = {"arch": cfg.name, "params": nparam, "batch": WIN_BATCH,
           "prompt": WIN_PROMPT, "steps": WIN_STEPS,
           "greedy_first_s": lm["gen_s"], "prefill_ms": lm["prefill_ms"],
           "decode_ms_per_step": lm["decode_ms"],
           "launches": lm["launches"], "layer_checks": layer_err,
           "logit_checks": logit_checks, "local_ms": local_ms,
           "global_ms": global_ms, "local_over_global": local_ms / global_ms,
           "pair_ratio": pair_ratio, "sdpa_kernels": sdpa_kernels,
           "profile": prof}
    print(json.dumps({"window_lm_path": out}))
    del params, cache, logits, captured, fq, fk, fv, gq, gk, gv, library, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vlm_serving(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phase 15b (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    from torch_checks import grid_positions
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in params.parameters())
    print(f"vlm: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model},"
          f" {cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
          f"M-RoPE sections {cfg.mrope_sections}, visual prefix "
          f"{cfg.visual_prefix}): {nparam} parameters, made in "
          f"{time.perf_counter() - t0} s")
    rng = np.random.default_rng(seed)
    side = int(round(cfg.visual_prefix ** 0.5))
    batch = {
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT))).to(dev),
        "visual": torch.from_numpy((rng.standard_normal(
            (VLM_BATCH, cfg.visual_prefix, cfg.d_model)) * 0.02)
            .astype(np.float32)).to(dev),
        "mrope_positions": torch.from_numpy(grid_positions(
            VLM_BATCH, VLM_PROMPT, cfg.visual_prefix, side)).to(dev)}
    print(f"vlm: {VLM_BATCH} prompts of {VLM_PROMPT} positions, the "
          f"first {cfg.visual_prefix} a visual prefix in a {side} x {side} "
          f"M-RoPE grid; decode positions pos0 + arange in all three "
          f"streams")
    lm = lm_serving(torch, tstep, attention, params, cfg, batch, WIN_STEPS,
                    zero_counts, counted, "vlm", ())
    prefill, kernel_logits = lm["prefill"], lm["kernel_logits"]
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, prefill, params, batch,
        kernel_logits, "vlm check")
    # the grid must reach the logits: three equal streams give others
    flat = dict(batch, mrope_positions=torch.arange(
        VLM_PROMPT, device=dev)[None, None].expand(3, VLM_BATCH, VLM_PROMPT))
    flat_logits = prefill(params, flat)[0][:, -1, :cfg.vocab_size].float()
    moved = max_abs_err(kernel_logits, flat_logits)
    floor = LOGIT_TOL["float32"] * float(kernel_logits.abs().max())
    print(f"vlm check: grid positions against three equal streams move the "
          f"last-position logits by up to {moved} (must exceed {floor}, the "
          f"fp32 route tolerance)")
    if not moved > floor:
        raise SystemExit("vlm: the M-RoPE grid positions do not reach the "
                         "logits")
    out = {"arch": cfg.name, "params": nparam, "batch": VLM_BATCH,
           "prompt": VLM_PROMPT, "visual_prefix": cfg.visual_prefix,
           "steps": WIN_STEPS, "greedy_first_s": lm["gen_s"],
           "prefill_ms": lm["prefill_ms"],
           "decode_ms_per_step": lm["decode_ms"],
           "launches": lm["launches"], "logit_checks": logit_checks,
           "grid_vs_equal_streams": moved}
    print(json.dumps({"vlm_path": out}))
    del params, batch, flat, kernel_logits, flat_logits, lm, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return out


def window_training(torch, dev, seed: int, zero_counts, counted, kernel
                    ) -> dict:
    """Phase 15c (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    from torch_checks import bwd_tol, unit_rms
    full = get_config(WIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=WIN_TRAIN_LAYERS,
                              remat="full")
    windows = tmodel.layer_windows(cfg)
    print(f"window train cut: {full.name} at its published width with "
          f"num_layers {full.num_layers} -> {WIN_TRAIN_LAYERS}, one "
          f"local:global period (windows {windows}): fp32 master weights, "
          f"gradients and AdamW moments take {STATE_BYTES_PER_PARAM} B/param,"
          f" {STATE_BYTES_PER_PARAM} x {full.param_count()} = "
          f"{STATE_BYTES_PER_PARAM * full.param_count()} B before "
          f"activations; at {WIN_TRAIN_LAYERS} layers "
          f"{STATE_BYTES_PER_PARAM * cfg.param_count()} B")
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = tmodel.init_params(cfg, seed=seed, device=dev,
                                dtype=torch.float32)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    opt = init_opt_state(params, ocfg)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WIN_TRAIN_BATCH, WIN_PROMPT))).to(dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}

    # the loss and layer 0's q/k/v gradients, kernel route against the
    # plain route (which must receive each layer's window)
    names = ("wq", "wk", "wv")

    def route(plain: bool):
        seen = []
        with swapped(tflash, vjp=plain_routes(
                torch, attention, windows=seen)[1] if plain else None):
            params.requires_grad_(True)
            loss, _ = tmodel.lm_loss(params, cfg, batch)
            loss.backward()
        if plain and (seen[:cfg.num_layers] != windows
                      or len(seen) != 2 * cfg.num_layers):
            raise SystemExit(f"window train: the plain route received the "
                             f"windows {seen}, want {windows} (forward) "
                             f"and again (the remat recompute)")
        grads = {n: getattr(params.layers[0], n).grad.clone() for n in names}
        params.zero_grad(set_to_none=True)
        return float(loss.detach()), grads
    (k_loss, k_grads), (p_loss, p_grads) = route(False), route(True)
    torch.cuda.synchronize()
    route_err = {"loss": abs(k_loss - p_loss) / abs(p_loss)}
    for n in names:
        route_err[f"layer0.{n}"] = float((k_grads[n] - p_grads[n]).norm()
                                         / p_grads[n].norm())
    print(f"window train check: loss kernel route {k_loss}, plain route "
          f"{p_loss}; relative differences {route_err} (tolerances "
          f"{ROUTE_TOL})")
    if not (route_err["loss"] <= ROUTE_TOL["loss"] and all(
            route_err[f"layer0.{n}"] <= ROUTE_TOL["grad"] for n in names)
            and np.isfinite(k_loss)):
        raise SystemExit("window train: the kernel route differs from the "
                         "plain route")
    del k_grads, p_grads

    # one counted step, then one timed; layers 0 (local) and the global one
    # captured (q, k, v, window, out and dout) on the first call
    step = make_train_step(cfg, TrainConfig(ocfg))
    captured = {}

    def capture(i):
        def hook(module, args, kwargs, output):
            if i in captured:
                return                      # the recompute under remat
            captured[i] = ([t.detach() for t in args]
                           + [kwargs.get("window"), output.detach()])
            output.register_hook(lambda g: captured[i].append(g.detach()))
        return hook
    layers = (0, cfg.global_every - 1)
    hooks = [params.layers[i].attn_core.register_forward_hook(
        capture(i), with_kwargs=True) for i in layers]
    zero_counts()
    try:
        with no_plain_attention(attention):
            params, opt, m = step(params, opt, batch)
            first_loss = float(m["loss"])
    finally:
        for h in hooks:
            h.remove()
    launches = {n: fn.launches for n, fn in counted.items()}
    print(f"window train step 1: loss {first_loss}, launches {launches}, "
          f"no plain attention")
    if (launches["flash_attention_fwd"] != 2 * cfg.num_layers
            or launches["flash_attention_bwd"] != cfg.num_layers):
        raise SystemExit(f"window train step: want {2 * cfg.num_layers} "
                         f"forward and {cfg.num_layers} backward launches, "
                         f"saw {launches}")
    alone = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with step_alone(torch, alone):
        params, opt, m = step(params, opt, batch)
    second_loss = float(m["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = max(alone["carried"], torch.cuda.max_memory_allocated())
    note_peak(torch, "15c", cfg, "train", WIN_TRAIN_BATCH, WIN_PROMPT,
              resident, peak, (params, opt, batch), alone,
              token_dtype=batch["tokens"].dtype)
    print(f"window train step 2: {step_ms} ms ({WIN_TRAIN_BATCH} x "
          f"{WIN_PROMPT} tokens, remat full), loss {second_loss}; peak "
          f"{peak} bytes allocated")
    if not (np.isfinite(first_loss) and np.isfinite(second_loss)):
        raise SystemExit("window train: a loss is not finite")
    # one more step under the profiler: at bf16 and head_dim 256 the C
    # entry must launch the tensor-core backward pair, one a layer each,
    # and never the CUDA-core pair (its count at the launch site); the
    # profiler must never see the CUDA-core pair (what it saw of the
    # tensor-core pair is printed: it loses records, PERF.md section 7)
    for _ in range(3):                  # the profiler now and then misses
        seen = {}                       # some or all of the launches
        reading, launched = route_launches(
            torch, attention, lambda: device_profile(
                torch, lambda: step(params, opt, batch), 1, seen))
        got = {n: launches_named(seen, n)
               for pair in BWD_KERNELS.values() for n in pair}
        if all(got[n] for n in BWD_KERNELS["tensor cores"]):
            break
    print(f"window train check: the C entry launched {launched}, the "
          f"profiler saw backward launches {got} in a profiled step")
    prof = profile("one windowed train step", *reading)
    prof["flash_ms_a_launch"] = {
        n: sum(ms for k, ms in reading[2].items() if n in k)
        / max(1, launches_named(seen, n))
        for n in ("flash_fwd_wgmma",) + BWD_KERNELS["tensor cores"]}
    print(f"window train: card ms a launch in the profiled step "
          f"{prof['flash_ms_a_launch']}")
    if (any(launched[n] != cfg.num_layers
            for n in BWD_KERNELS["tensor cores"])
            or any(launched[n] for n in BWD_KERNELS["CUDA cores"])
            or any(got[n] for n in BWD_KERNELS["CUDA cores"])):
        raise SystemExit(f"window train: want the backward on the tensor "
                         f"cores (bf16 at head_dim {cfg.head_dim}), one "
                         f"launch a layer, the C entry launched {launched}, "
                         f"the profiler saw {got}")

    # the backward kernel at the captured layers against its plain
    # version, on the step's dout brought to unit RMS (exact)
    layer_err = {}
    for i, (cq, ck, cv, w, cout, cdout) in captured.items():
        if w != windows[i]:
            raise SystemExit(f"window train: layer {i} attended with window "
                             f"{w}, want {windows[i]}")
        out, lse = attention.flash_attention_fwd(cq, ck, cv, causal=True,
                                                 window=w, return_lse=True)
        if not torch.equal(out, cout):
            raise SystemExit(f"window train: layer {i}'s forward is not the "
                             "step's")
        udout = unit_rms(cdout)
        got = attention.flash_attention_bwd(cq, ck, cv, out, lse, udout,
                                            causal=True, window=w)
        want = attention.flash_attention_bwd_plain(
            cq.float(), ck.float(), cv.float(), out.float(), lse,
            udout.float(), causal=True, window=w)
        errs = bwd_errors(got, want, cq.dtype)
        if not all(e["err/tol"] <= 1 for e in errs.values()):
            raise SystemExit(f"flash_attention_bwd at layer {i} (window "
                             f"{w}): {errs}")
        layer_err[i] = {"window": w, **errs}
        del got, want, udout, out, lse
    print(f"window train check: backward kernel vs plain at layers {layers} "
          f"(q {tuple(captured[0][0].shape)}, bf16, dout at unit RMS): "
          f"{layer_err}")

    # row 5bw: the backward kernel at layer 0's shape (local), beside its
    # plain version, SDPA's backward under the same boolean mask (timed
    # only) and its bound
    cq, ck, cv, w0, _, cdout = captured[0]
    udout = unit_rms(cdout)
    out, lse = attention.flash_attention_fwd(cq, ck, cv, causal=True,
                                             window=w0, return_lse=True)
    B_, S_, H_, hd_ = cq.shape
    keep = attention.allowed(S_, S_, causal=True, window=w0, device=dev)
    pairs = int(keep.sum())
    want = attention.flash_attention_bwd_plain(cq, ck, cv, out, lse, udout,
                                               causal=True, window=w0)
    g = H_ // ck.shape[2]
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_() for t in (
        cq, ck.repeat_interleave(g, dim=2), cv.repeat_interleave(g, dim=2)))
    library = None
    try:
        so = torch.nn.functional.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=keep)
        sdo = udout.transpose(1, 2).contiguous()
        library = lambda: torch.autograd.grad(  # noqa: E731
            so, (sq, sk, sv), sdo, retain_graph=True)
        library()
    except RuntimeError as exc:
        library = None
        print(f"window train: SDPA's backward refused the inputs: {exc}"[
            :300])
    kernel("flash_attention_bwd window", "attention.cu",
           "src/repro/models/flash.py:262",
           f"q {tuple(cq.shape)}, k/v {tuple(ck.shape)}, causal, window "
           f"{w0}, bf16",
           lambda: attention.flash_attention_bwd(cq, ck, cv, out, lse, udout,
                                                 causal=True, window=w0),
           lambda: attention.flash_attention_bwd_plain(
               cq, ck, cv, out, lse, udout, causal=True, window=w0),
           2 * (4 * cq.numel() + 4 * ck.numel()) + 4 * lse.numel(),
           2.5 * 4 * hd_ * pairs * B_ * H_, 10,
           count=launches["flash_attention_bwd"],
           tol=[bwd_tol(x, torch.bfloat16) for x in want],
           peak_ops=PEAK_BF16, library=library)
    out_rec = {"arch": cfg.name, "layers": cfg.num_layers,
               "batch": WIN_TRAIN_BATCH, "seq": WIN_PROMPT,
               "route_err": route_err, "launches": launches,
               "losses": [first_loss, second_loss], "step_ms": step_ms,
               "peak_bytes": peak, "layer_checks": layer_err,
               "profile": prof}
    print(json.dumps({"window_train_path": out_rec}))
    del params, opt, batch, captured, want, library, sq, sk, sv, out, lse
    gc.collect()
    torch.cuda.empty_cache()
    return out_rec


def family_serving(torch, dev, seed: int, zero_counts, counted, arch: str,
                   layers_of, label: str, batch: int = FAMILY_BATCH,
                   prompt: int = FAMILY_PROMPT, steps: int = FAMILY_STEPS,
                   layers: int | None = None) -> dict:
    """Phase 16's (and 17a's) serving run of one model at its published
    config: random bf16 weights from ``seed``, ``batch`` prompts of
    ``prompt`` tokens (an encoder-decoder's with ``enc_frames`` frame
    embeddings each, fp32 standard normal x 0.02 from ``seed``),
    ``lm_serving`` (``greedy_generate`` of ``steps`` tokens counted,
    prefill and decode timed, the flash module of each layer of
    ``layers_of(cfg)`` captured), the peak memory over it, and the card's
    busy time and idle share over one prefill and one decode step.
    ``layers``: the depth cut to that many layers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparam = sum(p.numel() for p in params.parameters())
    print(f"{label}: {cfg.name} ({cfg.num_layers} layers, block {cfg.block}, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
          f"x {cfg.head_dim}, d_ff {cfg.d_ff}, moe {cfg.moe}, ssm {cfg.ssm}, "
          f"window {cfg.sliding_window}, vocab {cfg.vocab_size}): {nparam} "
          f"parameters (config: {cfg.param_count()}), "
          f"{torch.cuda.memory_allocated()} bytes on the card, made in "
          f"{init_s} s")
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt))).to(dev)
    inputs = {"tokens": prompts}
    if cfg.enc_dec:
        inputs["frames"] = torch.from_numpy((rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)) * 0.02).astype(
                np.float32)).to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = lm_serving(torch, tstep, attention, params, cfg, inputs, steps,
                    zero_counts, counted, label, layers_of(cfg))
    peak = torch.cuda.max_memory_allocated()
    alone = {}                  # the prefill once more, its peak alone
    with step_alone(torch, alone):
        lm["prefill"](params, inputs)
    note_peak(torch, label, cfg, "prefill", batch, prompt, resident, peak,
              (params, inputs), alone, max_len=prompt + steps,
              token_dtype=prompts.dtype, param_dtype=tmodel.COMPUTE_DTYPE)
    print(f"{label}: peak memory over greedy_generate, prefill and decode "
          f"{peak} bytes [{CARD['smi']}]")
    prefill, decode = lm["prefill"], lm["decode"]
    prof = {"prefill": profile(
        f"{label}: one prefill ({batch} x {prompt})",
        *device_profile(torch, lambda: prefill(params, inputs)))}
    logits, cache = prefill(params, inputs)
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    prof["decode"] = profile(f"{label}: one decode step", *device_profile(
        torch, lambda: decode(params, {"tokens": nxt, "cache": cache})))
    del logits, cache, nxt
    record = {"arch": cfg.name, "params": nparam, "batch": batch,
              "prompt": prompt, "steps": steps,
              "init_s": init_s, "greedy_first_s": lm["gen_s"],
              "prefill_ms": lm["prefill_ms"],
              "decode_ms_per_step": lm["decode_ms"],
              "generated_tokens_per_s": lm["tok_s"],
              "launches": lm["launches"], "peak_bytes": peak,
              "profile": prof}
    return {"cfg": cfg, "params": params, "prompts": prompts,
            "inputs": inputs, "lm": lm, "record": record}


def step_check(torch, tmodel, cfg, params, prompts, label: str,
               extra: dict | None = None) -> dict:
    """A prefill of S - 1 tokens plus one decode step (the conv, SSM, KV
    and cross-attention caches carried on the card) against a prefill of
    S: the last-position logits within STEP_TOL of their largest
    magnitude, the argmax equal on every row whose top-2 margin exceeds
    it.  ``extra``: more prefill inputs (an encoder-decoder's frames)."""
    S, V = prompts.shape[1], cfg.vocab_size
    extra = extra or {}
    want = tmodel.model_forward(params, cfg, prompts, mode="prefill",
                                **extra)[0]
    _, cache = tmodel.model_forward(params, cfg, prompts[:, :-1],
                                    mode="prefill", max_len=S, **extra)
    got = tmodel.model_forward(params, cfg, prompts[:, -1:], cache=cache,
                               mode="decode")[0]
    want, got = want[:, -1, :V].float(), got[:, -1, :V].float()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    tol = STEP_TOL * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    agree = got.argmax(-1) == want.argmax(-1)
    print(f"{label}: prefill of {S - 1} + one decode step vs a prefill of "
          f"{S}: max err {err} <= {tol} ({STEP_TOL} of max "
          f"{float(want.abs().max())}); argmax agrees on {int(agree.sum())}/"
          f"{got.shape[0]} rows ({int(decided.sum())} decided)")
    if not (err <= tol and bool(agree[decided].all())
            and bool(torch.isfinite(got).all())):
        raise SystemExit(f"{label}: the decode step after a prefill of "
                         f"{S - 1} differs from the prefill of {S}")
    return {"err": err, "tol": tol, "argmax_agree": int(agree.sum()),
            "rows_decided": int(decided.sum())}


def routed(tmoe, run, calls: list) -> None:
    """Run ``run()`` with every ``moe_ffn`` call's routing appended to
    ``calls`` (one an MoE layer, in order; kept if ``run`` fails): the
    chosen experts (T, k) and ``keep`` (T*k,), and for the first call its
    arguments (x, p, spec, act)."""
    saved = tmoe.moe_ffn

    def recording(x, p, spec, act="silu"):
        T = x.shape[0] * x.shape[1]
        _, experts = tmoe.route(x.reshape(T, -1), p["router"], spec)
        keep = tmoe.dispatch(experts, spec.num_experts, tmoe._capacity(
            T, spec.top_k, spec.num_experts, spec.capacity_factor))[1]
        calls.append({"experts": experts, "keep": keep,
                      "args": None if calls else (x, p, spec, act)})
        return saved(x, p, spec, act)
    tmoe.moe_ffn = recording
    try:
        run()
    finally:
        tmoe.moe_ffn = saved


def dense_moe(torch, tmoe, mlp, x, p, spec, act):
    """The MoE layer's per-token dense form: each token's sum over its kept
    experts of gate x expert MLP, each expert's MLP applied to every token.
    The routing is ``route``'s; ``keep`` comes from a running count of each
    expert's assignments in token order (not ``dispatch``'s sort).
    Returns (out, dropped assignments)."""
    B, S, d = x.shape
    T, E, k = B * S, spec.num_experts, spec.top_k
    xf = x.reshape(T, d)
    gates, experts = tmoe.route(xf, p["router"], spec)
    onehot = torch.nn.functional.one_hot(experts.reshape(-1), E)
    rank = (onehot.cumsum(0) - 1).gather(1, experts.reshape(-1, 1))
    C = tmoe._capacity(T, k, E, spec.capacity_factor)
    keep = (rank < C).view(T, k)
    weight = torch.zeros((T, E), dtype=xf.dtype, device=x.device)
    weight.scatter_(1, experts, gates * keep)
    out = torch.zeros_like(xf)
    for e in range(E):
        out += weight[:, e:e + 1] * mlp(xf, {"w_in": p["w_in"][e],
                                            "w_gate": p["w_gate"][e],
                                            "w_out": p["w_out"][e]}, act)
    out = out.view(B, S, d)
    if "shared_w_in" in p:
        out = out + torch.sigmoid(x @ p["shared_gate"]) * mlp(
            x, {"w_in": p["shared_w_in"], "w_gate": p["shared_w_gate"],
                "w_out": p["shared_w_out"]}, act)
    return out, int((~keep).sum())


def moe_serving(torch, dev, seed: int, zero_counts, counted, kernel,
                refs: dict) -> dict:
    """Phase 16a (see the module docstring); ``refs["ms"]`` gets phase
    21a's reference."""
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.models.layers import mlp
    run = family_serving(torch, dev, seed, zero_counts, counted, MOE_ARCH,
                         lambda cfg: (0, cfg.num_layers - 1), "moe lm")
    cfg, params, prompts, lm = (run[k] for k in ("cfg", "params", "prompts",
                                                 "lm"))
    layer_err = check_layers(attention, lm["captured"],
                             tmodel.layer_windows(cfg), "moe lm check")

    # one more kernel-route prefill with every layer's routing recorded and
    # layer 0's MoE input kept: the buffer route against the dense form
    kernel_calls = []
    routed(tmoe, lambda: lm["prefill"](params, {"tokens": prompts}),
           kernel_calls)
    dropped = [int((~c["keep"]).sum()) for c in kernel_calls]
    T, m = FAMILY_BATCH * FAMILY_PROMPT, cfg.moe
    print(f"moe lm: assignments dropped by the capacity per layer (bf16 "
          f"kernel-route prefill, T = {T}, top {m.top_k}, C = "
          f"{tmoe._capacity(T, m.top_k, m.num_experts, m.capacity_factor)}):"
          f" {dropped}")
    refs["ms"] = serve_family_ref(torch, cfg, run, [
        c["experts"].cpu() for c in kernel_calls])
    x0, p0, spec, act = kernel_calls[0]["args"]
    x0 = x0.float()
    p0 = {k: v.float() for k, v in p0.items()}
    dense_checks = {}
    for factor in (spec.capacity_factor, MOE_TIGHT_FACTOR):
        sp = dataclasses.replace(spec, capacity_factor=factor)
        got = tmoe.moe_ffn(x0, p0, sp, act)
        want, drops = dense_moe(torch, tmoe, mlp, x0, p0, sp, act)
        torch.cuda.synchronize()
        err, tol = max_abs_err(got, want), MOE_DENSE_TOL * float(
            want.abs().max())
        dense_checks[factor] = {"err": err, "tol": tol, "dropped": drops}
        print(f"moe lm check: layer 0's MoE (fp32, capacity factor {factor}:"
              f" {drops} of {x0.shape[0] * x0.shape[1] * sp.top_k} "
              f"assignments dropped) vs its per-token dense form: max err "
              f"{err} <= {tol}")
        if not err <= tol:
            raise SystemExit(f"moe lm: the MoE layer differs from its dense "
                             f"form at capacity factor {factor}: {err} > "
                             f"{tol}")
    del x0, p0, got, want

    # the logits against the plain attention route; the routing flips
    # between the routes counted per layer (bf16: the kernel-route prefill
    # above against the plain route's; fp32: the two fp32 prefills)
    L = cfg.num_layers
    route_calls, checks = [], {}

    def flips_of(a, b):
        return [int((x["experts"] != y["experts"]).sum())
                for x, y in zip(a, b)]

    try:
        routed(tmoe, lambda: checks.update(logit_route_checks(
            torch, tmodel, tflash, attention, cfg, lm["prefill"], params,
            {"tokens": prompts}, lm["kernel_logits"], "moe lm check")),
            route_calls)
    finally:
        flips = {"bfloat16": flips_of(kernel_calls, route_calls[:L]),
                 "float32": flips_of(route_calls[L:2 * L],
                                     route_calls[2 * L:3 * L])}
        print(f"moe lm check: (token, slot) routings that differ between "
              f"the kernel and the plain attention route, per layer: "
              f"{flips}")
    del kernel_calls, route_calls

    # the kernel at layer 0's shape and at one (1, 4) rank's heads beside
    # its plain version and SDPA
    fq, fk, fv, _, fo = lm["captured"][0]
    for label, heads in (("moe", (cfg.num_heads, cfg.num_kv_heads)),
                         ("moe (1, 4) rank", RANK_HEADS["moe"])):
        flash_fwd_row(torch, attention, kernel, label, (fq, fk, fv, fo),
                      True, heads, lm["launches"]["flash_attention_fwd"])
    out = dict(run["record"], layer_checks=layer_err,
               dropped_per_layer=dropped, dense_checks={
                   str(k): v for k, v in dense_checks.items()},
               route_flips=flips, logit_checks=checks)
    print(json.dumps({"moe_lm_path": out}))
    del run, params, lm, fq, fk, fv, fo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_serving(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phase 16b (see the module docstring)."""
    from repro_torch.models import model as tmodel
    from repro_torch.models import ssm as tssm
    run = family_serving(torch, dev, seed, zero_counts, counted, SSM_ARCH,
                         lambda cfg: (), "ssm lm")
    cfg, params, prompts, lm = (run[k] for k in ("cfg", "params", "prompts",
                                                 "lm"))
    # ssd_chunked against the step-by-step oracle at layer 0's input
    captured = []
    saved = tssm.ssd_chunked

    def capture(*args, **kwargs):
        if not captured:
            captured.append((args, kwargs))
        return saved(*args, **kwargs)
    tssm.ssd_chunked = capture
    try:
        lm["prefill"](params, {"tokens": prompts})
    finally:
        tssm.ssd_chunked = saved
    args, kwargs = captured[0]
    args = [a.float() for a in args]
    t0 = time.perf_counter()
    y_c, h_c = tssm.ssd_chunked(*args, chunk=kwargs["chunk"])
    y_s, h_s = tssm.ssd_sequential(*args)
    torch.cuda.synchronize()
    ssd = {}
    for name, got, want in (("y", y_c, y_s), ("state", h_c, h_s)):
        err, tol = max_abs_err(got, want), SSD_TOL * float(want.abs().max())
        ssd[name] = {"err": err, "tol": tol}
        if not err <= tol:
            raise SystemExit(f"ssm lm: ssd_chunked's {name} differs from "
                             f"ssd_sequential's at layer 0: {err} > {tol}")
    print(f"ssm lm check: ssd_chunked vs ssd_sequential at layer 0's input "
          f"(x {tuple(args[0].shape)}, B/C {tuple(args[3].shape)}, chunk "
          f"{kwargs['chunk']}, fp32; {time.perf_counter() - t0} s): {ssd}")
    del captured, args, y_c, h_c, y_s, h_s
    steps = step_check(torch, tmodel, cfg, params, prompts, "ssm lm check")
    out = dict(run["record"], ssd_check=ssd, step_check=steps)
    print(json.dumps({"ssm_lm_path": out}))
    del run, params, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hybrid_serving(torch, dev, seed: int, zero_counts, counted, kernel
                   ) -> dict:
    """Phase 16c (see the module docstring)."""
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from torch_checks import attn_tol
    # a local layer and the middle (global) one
    run = family_serving(torch, dev, seed, zero_counts, counted, HYBRID_ARCH,
                         lambda cfg: (1, cfg.num_layers // 2), "hybrid lm")
    cfg, params, prompts, lm = (run[k] for k in ("cfg", "params", "prompts",
                                                 "lm"))
    windows = tmodel.layer_windows(cfg)
    layer_err = check_layers(attention, lm["captured"], windows,
                             "hybrid lm check")
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, lm["prefill"], params,
        {"tokens": prompts}, lm["kernel_logits"], "hybrid lm check")
    steps = step_check(torch, tmodel, cfg, params, prompts,
                       "hybrid lm check")

    # the kernel at layer 1's shape (a local layer) beside its plain version
    # and SDPA under the window's boolean mask
    fq, fk, fv, w1, fo = lm["captured"][1]
    B_, S_, H_, hd_ = fq.shape
    keep = attention.allowed(S_, S_, causal=True, window=w1, device=dev)
    pairs = int(keep.sum())
    library, sdpa_kernels = sdpa_beside(torch, fq, fk, fv, keep)
    print(f"hybrid lm: SDPA under the window's boolean mask: {sdpa_kernels}")
    kernel("flash_attention_fwd hybrid", "attention.cu",
           "src/repro/kernels/attention.py:67",
           f"q {tuple(fq.shape)}, k/v {tuple(fk.shape)}, causal, window "
           f"{w1}, bf16",
           lambda: attention.flash_attention_fwd(fq, fk, fv, causal=True,
                                                 window=w1),
           lambda: attention.flash_attention_fwd_plain(fq, fk, fv,
                                                       causal=True,
                                                       window=w1),
           2 * (2 * fq.numel() + fk.numel() + fv.numel()),
           4 * hd_ * pairs * B_ * H_, 10,
           count=lm["launches"]["flash_attention_fwd"],
           tol=attn_tol(fo, torch.bfloat16), peak_ops=PEAK_BF16,
           library=library)
    # row 5hr: the same at a (2, 2) rank's shard (half the batch)
    b2 = B_ // 2
    rq, rk, rv = (t[:b2].contiguous() for t in (fq, fk, fv))
    library_r, _ = sdpa_beside(torch, rq, rk, rv, keep)
    kernel(f"flash_attention_fwd {HYBRID_RANK}", "attention.cu",
           "src/repro/kernels/attention.py:67",
           f"q {tuple(rq.shape)}, k/v {tuple(rk.shape)}, causal, window "
           f"{w1}, bf16",
           lambda: attention.flash_attention_fwd(rq, rk, rv, causal=True,
                                                 window=w1),
           lambda: attention.flash_attention_fwd_plain(rq, rk, rv,
                                                       causal=True,
                                                       window=w1),
           2 * (2 * rq.numel() + rk.numel() + rv.numel()),
           4 * hd_ * pairs * b2 * H_, 10,
           count=lm["launches"]["flash_attention_fwd"],
           tol=attn_tol(fo[:b2], torch.bfloat16), peak_ops=PEAK_BF16,
           library=library_r)
    del rq, rk, rv, library_r
    out = dict(run["record"], layer_checks=layer_err,
               logit_checks=logit_checks, step_check=steps,
               sdpa_kernels=sdpa_kernels)
    print(json.dumps({"hybrid_lm_path": out}))
    del run, params, lm, fq, fk, fv, fo, library
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_batch(torch, dev, cfg, seed: int, i: int, batch: int, seq: int
                 ) -> dict:
    """Phase 17's training batch ``i``: ``batch`` x ``seq`` random tokens
    from ``seed``, labels rolled by one; an encoder-decoder's fp32 frames
    standard normal x 0.02."""
    r = np.random.default_rng(seed + 1000 * (i + 1))
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size,
                                         (batch, seq))).to(dev)
    b = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.enc_dec:
        b["frames"] = torch.from_numpy((r.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)) * 0.02).astype(
                np.float32)).to(dev)
    return b


def family_training(torch, dev, seed: int, zero_counts, counted, arch: str,
                    label: str, *, batch: int, seq: int, route_names,
                    layers: int | None = None, capture=(),
                    hold_plain: bool = True, fp32_route: bool = False,
                    before_opt=None) -> dict:
    """One training run of phase 17 at ``arch``'s published width (depth
    cut to ``layers`` if given), remat full, fp32 master weights and AdamW
    moments from ``seed``, batches of ``batch`` x ``seq`` random tokens
    (an encoder-decoder's with fp32 frames, standard normal x 0.02):

    * on TRAIN_ROUTE_BATCHES batches the loss and the gradients
      ``route_names`` by three routes, as phase 13a splits them: the
      kernels; the forward kernel with the plain backward ("mixed"); the
      plain attention (``plain_routes``, which must receive each flash
      call's window, in the forward and again in the remat recompute).
      The loss, kernel vs plain, within ROUTE_TOL; each gradient, kernel
      vs mixed (the backward kernel's share: the same forward) within
      ROUTE_TOL in the L2 norm of the difference, and kernel vs plain too
      unless ``hold_plain`` is False (then printed: where the forward's
      bf16 rounding alone, mixed vs plain, moves the gradient past
      ROUTE_TOL, the plain route is no oracle at that bound); every
      gradient of the kernel route finite (a model without attention runs
      the kernel route alone);
    * with ``fp32_route``, on the first batch the loss and ``route_names``
      with the compute dtype fp32, kernel vs plain route, within
      FP32_ROUTE_TOL (accumulation order only);
    * ``before_opt(params, cfg, batches)``, before the AdamW moments take
      their memory, for the caller's own checks (its dict joins the record);
    * one counted step (every counter zeroed just before and read just
      after, the flash wrappers' plain versions made to raise): two forward
      launches (forward and recompute) and one backward launch a flash
      module; the flash modules named in ``capture`` (name -> module getter)
      record their first call's q, k, v, mask, out and the out's gradient,
      and both kernels are held there against their plain versions
      (``check_captured``);
    * TRAIN_TIMED steps timed (median), tokens/s, the peak memory, and one
      step profiled (busy time, idle share, the time by kernel group; at
      head_dim 64 / 128 / 256 no backward kernel of the CUDA-core pair)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    full = get_config(arch)
    cfg = dataclasses.replace(full, remat="full",
                              num_layers=layers or full.num_layers)
    need = STATE_BYTES_PER_PARAM * cfg.param_count()
    if cfg.num_layers != full.num_layers:
        print(f"{label} cut: {full.name} at its published width with "
              f"num_layers {full.num_layers} -> {cfg.num_layers}: fp32 master"
              f" weights, gradients and AdamW moments take "
              f"{STATE_BYTES_PER_PARAM} B/param, {STATE_BYTES_PER_PARAM} x "
              f"{full.param_count()} = {STATE_BYTES_PER_PARAM * full.param_count()}"
              f" B at full depth, {need} B at {cfg.num_layers} layers, of "
              f"{CARD_BYTES} B on the card")
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev,
                                dtype=torch.float32)
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in params.parameters())
    n_attn = flash_modules(params)
    print(f"{label}: {cfg.name} ({cfg.num_layers} layers"
          f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_dec else ''}, "
          f"block {cfg.block}, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads x {cfg.head_dim}, moe {cfg.moe}, ssm "
          f"{cfg.ssm}, window {cfg.sliding_window}): {nparam} parameters "
          f"(config {cfg.param_count()}), {need} B of fp32 training state "
          f"at {STATE_BYTES_PER_PARAM} B/param; {n_attn} flash modules; "
          f"batches of {batch} x {seq}, remat full; made in "
          f"{time.perf_counter() - t0} s")

    batches = [family_batch(torch, dev, cfg, seed, i, batch, seq)
               for i in range(TRAIN_ROUTE_BATCHES)]

    # the windows each flash call receives, in forward order: the encoder's
    # layers, then each decoder layer's self-attention and cross-attention
    want_windows = [None] * (cfg.enc_layers if cfg.enc_dec else 0)
    for w in tmodel.layer_windows(cfg):
        want_windows += ([w] if cfg.block != "ssm" else []) + (
            [None] if cfg.enc_dec else [])
    if len(want_windows) != n_attn:
        raise SystemExit(f"{label}: {n_attn} flash modules, {want_windows}")

    vjps = {"kernel": None,
            "mixed": plain_routes(torch, attention, kernel_forward=True)[1],
            "plain": None}

    def route(b, which: str, dtype=torch.bfloat16):
        seen = []
        vjp = (plain_routes(torch, attention, windows=seen)[1]
               if which == "plain" else vjps[which])
        with compute_dtype(tmodel, dtype), swapped(tflash, vjp=vjp):
            params.requires_grad_(True)
            loss, _ = tmodel.lm_loss(params, cfg, b)
            loss.backward()
        if which == "plain" and (seen[:n_attn] != want_windows
                                 or len(seen) != 2 * n_attn):
            raise SystemExit(f"{label}: the plain route received the windows "
                             f"{seen}, want {want_windows} (forward) and "
                             f"again (the remat recompute)")
        grads = {n: params.get_parameter(n).grad.clone()
                 for n in route_names}
        bad = [] if which != "kernel" else [
            n for n, p in params.named_parameters()
            if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
        no_grad = sum(p.grad is None for p in params.parameters())
        params.zero_grad(set_to_none=True)
        return float(loss.detach()), grads, bad, no_grad

    def rel(a, b):
        err = {"loss": abs(a[0] - b[0]) / abs(b[0])}
        for n in route_names:
            err[n] = float((a[1][n] - b[1][n]).norm() / b[1][n].norm())
        return err

    route_errs = []
    for b_i, b in enumerate(batches):
        got = {"kernel": route(b, "kernel")}
        bad, no_grad = got["kernel"][2:]
        print(f"{label} check, batch {b_i}: kernel-route loss "
              f"{got['kernel'][0]}; {nparam} parameters' gradients, "
              f"{len(bad)} with a NaN or inf {bad[:4]}, {no_grad} tensors "
              f"given none")
        if bad or not np.isfinite(got["kernel"][0]):
            raise SystemExit(f"{label}: a gradient or the loss is not "
                             f"finite: {bad}")
        if not n_attn:
            continue
        got.update((w, route(b, w)) for w in ("mixed", "plain"))
        torch.cuda.synchronize()
        err = {"kernel_vs_plain": rel(got["kernel"], got["plain"]),
               "kernel_vs_mixed": rel(got["kernel"], got["mixed"]),
               "mixed_vs_plain": rel(got["mixed"], got["plain"])}
        print(f"{label} check, batch {b_i}: loss kernel route "
              f"{got['kernel'][0]}, plain route {got['plain'][0]}; relative "
              f"differences {err} (tolerances {ROUTE_TOL}: the loss kernel "
              f"vs plain, the gradients kernel vs mixed"
              f"{' and kernel vs plain' if hold_plain else ''})")
        held = [err["kernel_vs_mixed"]] + (
            [err["kernel_vs_plain"]] if hold_plain else [])
        if not (err["kernel_vs_plain"]["loss"] <= ROUTE_TOL["loss"]
                and all(e[n] <= ROUTE_TOL["grad"] for e in held
                        for n in route_names)):
            raise SystemExit(f"{label}: the kernel route differs from the "
                             f"plain or mixed route on batch {b_i}")
        route_errs.append(err)
        del got
    fp32_err = None
    if fp32_route:
        fp32_err = rel(route(batches[0], "kernel", torch.float32),
                       route(batches[0], "plain", torch.float32))
        print(f"{label} check, fp32 compute, batch 0: kernel vs plain route "
              f"relative differences {fp32_err} (tolerance "
              f"{FP32_ROUTE_TOL})")
        if not all(e <= FP32_ROUTE_TOL for e in fp32_err.values()):
            raise SystemExit(f"{label}: in fp32 the kernel route differs "
                             f"from the plain route")
    extra = before_opt(params, cfg, batches) if before_opt else {}
    checks_peak = torch.cuda.max_memory_allocated()    # the route checks'

    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, TrainConfig(ocfg))
    captured = {}

    def hook_of(name):
        def hook(module, args, kwargs, output):
            if name in captured:
                return                      # the recompute under remat
            captured[name] = {
                "qkv": [t.detach() for t in args], "out": output.detach(),
                "mask": {"causal": kwargs.get("causal", True),
                         "window": kwargs.get("window")}}
            output.register_hook(
                lambda g: captured[name].update(dout=g.detach()))
        return hook
    hooks = [get(params).register_forward_hook(hook_of(name),
                                               with_kwargs=True)
             for name, get in dict(capture).items()]
    zero_counts()
    try:
        with no_plain_attention(attention):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batches[0])
            losses = [float(m["loss"])]
            first_s = time.perf_counter() - t0
    finally:
        for h in hooks:
            h.remove()
    first_peak = torch.cuda.max_memory_allocated()    # + the first step
    launches = {n: fn.launches for n, fn in counted.items()}
    print(f"{label} step 1: {first_s} s (first), loss {losses[0]}, launches "
          f"{launches}, no plain attention")
    if (launches["flash_attention_fwd"] != 2 * n_attn
            or launches["flash_attention_bwd"] != n_attn):
        raise SystemExit(f"{label} step: want {2 * n_attn} forward and "
                         f"{n_attn} backward kernel launches, saw {launches}")
    layer_checks = check_captured(torch, attention, captured, label)
    times, alone = [], {}
    for i in range(TRAIN_TIMED):
        b = batches[(i + 1) % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (step_alone(torch, alone) if i == 0
              else contextlib.nullcontext()):
            params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))         # waits for the step
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak = max(alone["carried"], torch.cuda.max_memory_allocated())
    note_peak(torch, label, cfg, "train", batch, seq, resident, peak,
              (params, opt, batches[1 % len(batches)]), alone,
              checks_peak=checks_peak, first_peak=first_peak,
              token_dtype=batches[0]["tokens"].dtype)
    tokens = batch * seq
    print(f"{label} steps: losses {losses}; step {step_s * 1e3} ms (median "
          f"of {TRAIN_TIMED}: {[x * 1e3 for x in times]}), {tokens / step_s} "
          f"tokens/s ({batch} x {seq} decoder tokens a step); peak {peak} "
          f"bytes allocated [{CARD['smi']}]")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{label}: losses {losses} not finite")
    for _ in range(3):                  # the profiler now and then sees none
        seen = {}
        wall, busy, by_name = device_profile(
            torch, lambda: step(params, opt, batches[0]), 1, seen)
        if seen:
            break
    prof = profile(f"{label}: one train step [{CARD['smi']}]", wall, busy,
                   by_name)
    groups = {"flash backward kernel": ("flash_bwd",),
              "flash forward kernel": ("flash_fwd",),
              "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass", "sm90"),
              "elementwise and reductions": ("elementwise", "reduce",
                                             "Reduce")}
    split = dict.fromkeys(groups, 0.0)
    split["other"] = 0.0
    for k_, v in by_name.items():
        g_ = next((g for g, keys in groups.items()
                   if any(x in k_ for x in keys)), "other")
        split[g_] += v
    prof["split_ms"] = split
    bwd_seen = {n: launches_named(seen, n)
                for pair in BWD_KERNELS.values() for n in pair}
    print(f"  by group: " + "; ".join(f"{g} {v} ms" for g, v in split.items())
          + f"; backward kernels seen {bwd_seen}")
    if n_attn and cfg.head_dim in (64, 128, 256) and any(
            bwd_seen[n] for n in BWD_KERNELS["CUDA cores"]):
        raise SystemExit(f"{label}: bf16 at head_dim {cfg.head_dim} must run "
                         f"the tensor-core backward, the profiler saw "
                         f"{bwd_seen}")
    record = {"card": CARD["smi"], "arch": cfg.name,
              "layers": cfg.num_layers,
              "published_layers": full.num_layers, "params": nparam,
              "state_bytes": need, "batch": batch, "seq": seq,
              "route_errs": route_errs, "fp32_route_err": fp32_err,
              "layer_checks": layer_checks, "launches": launches,
              "first_step_s": first_s, "step_ms": step_s * 1e3,
              "step_ms_all": [x * 1e3 for x in times],
              "tokens_per_s": tokens / step_s, "peak_bytes": peak,
              "losses": losses, "profile": prof,
              "bwd_kernels_seen": bwd_seen, **extra}
    return {"cfg": cfg, "params": params, "opt": opt, "batches": batches,
            "captured": captured, "record": record, "n_attn": n_attn}


def check_captured(torch, attention, captured: dict, label: str) -> dict:
    """Both flash kernels at each flash module captured in a train step
    (``family_training``'s ``capture``): the forward kernel must give the
    step's output again and agree with its plain version by both bf16
    checks of phase 2; the backward kernel, on the step's dout brought to
    unit RMS by a power of two (exact), with its plain version within
    ``bwd_tol``."""
    from torch_checks import attn_tol, bf16_attn_err, unit_rms
    out_checks = {}
    for name, c in captured.items():
        (cq, ck, cv), mask = c["qkv"], c["mask"]
        out, lse = attention.flash_attention_fwd(cq, ck, cv, return_lse=True,
                                                 **mask)
        want = attention.flash_attention_fwd_plain(
            cq.float(), ck.float(), cv.float(), **mask)
        err, tol = max_abs_err(out, want), attn_tol(want, out.dtype)
        elem = bf16_attn_err(out, want)
        udout = unit_rms(c["dout"])
        got = attention.flash_attention_bwd(cq, ck, cv, out, lse, udout,
                                            **mask)
        grads = attention.flash_attention_bwd_plain(
            cq.float(), ck.float(), cv.float(), out.float(), lse,
            udout.float(), **mask)
        errs = bwd_errors(got, grads, cq.dtype)
        same = torch.equal(out, c["out"])
        out_checks[name] = {"mask": mask, "q": list(cq.shape),
                            "kv": list(ck.shape), "forward_err": err,
                            "forward_tol": tol, "element": elem,
                            "same_as_step": same, **errs}
        if not (same and err <= tol and elem <= 1 and all(
                e["err/tol"] <= 1 for e in errs.values())):
            raise SystemExit(f"{label}: the flash kernels at the captured "
                             f"{name} attention: {out_checks[name]}")
        del out, lse, want, got, grads, udout
    if out_checks:
        print(f"{label} check: both flash kernels vs plain at the captured "
              f"layers (bf16, dout at unit RMS): {out_checks}")
    return out_checks


def ssd_grad_check(torch, params, cfg, batch: dict, label: str, seed: int
                   ) -> dict:
    """The chunked SSD's gradients with respect to x, dt, B and C at layer
    0's captured inputs (one forward of ``batch``), cut to SSD_GRAD_SEQ
    positions, against ``ssd_sequential``'s autograd in fp32, each within
    SSD_GRAD_TOL of the oracle's largest magnitude of that gradient, all
    finite (the reference's form gives NaN here)."""
    from repro_torch.models import model as tmodel
    from repro_torch.models import ssm as tssm
    captured = []
    saved = tssm.ssd_chunked

    def capture(*args, **kwargs):
        if not captured:
            captured.append(([a.detach().float().clone() for a in args],
                             kwargs))
        return saved(*args, **kwargs)
    tssm.ssd_chunked = capture
    try:
        with torch.no_grad():
            tmodel.lm_loss(params, cfg, batch)
    finally:
        tssm.ssd_chunked = saved
    (x, dt, A, B_, C_, D), kwargs = captured[0]
    S = SSD_GRAD_SEQ
    x, dt, B_, C_ = (a[:, :S].contiguous() for a in (x, dt, B_, C_))
    r = np.random.default_rng(seed)
    gy = torch.from_numpy(r.standard_normal(x.shape).astype(
        np.float32)).to(x.device)
    gh = torch.from_numpy(r.standard_normal(
        (x.shape[0], x.shape[2], x.shape[3], B_.shape[-1])).astype(
            np.float32)).to(x.device)

    def grads_of(fn, **kw):
        args = [a.clone().requires_grad_(i in (0, 1, 3, 4))
                for i, a in enumerate((x, dt, A, B_, C_, D))]
        y, h = fn(*args, **kw)
        ((y * gy).sum() + (h * gh).sum()).backward()
        return [args[i].grad for i in (0, 1, 3, 4)]
    t0 = time.perf_counter()
    got = grads_of(tssm.ssd_chunked, chunk=kwargs["chunk"])
    want = grads_of(tssm.ssd_sequential)
    torch.cuda.synchronize()
    out = {}
    for name, a, b in zip(("x", "dt", "B", "C"), got, want):
        err, tol = max_abs_err(a, b), SSD_GRAD_TOL * float(b.abs().max())
        finite = bool(torch.isfinite(a).all())
        out[name] = {"err": err, "tol": tol, "finite": finite}
        if not (finite and err <= tol):
            raise SystemExit(f"{label}: ssd_chunked's gradient with respect "
                             f"to {name} differs from ssd_sequential's: "
                             f"{err} > {tol} or not finite")
    print(f"{label} check: ssd_chunked's gradients vs ssd_sequential's "
          f"autograd at layer 0's input (x {tuple(x.shape)}, B/C "
          f"{tuple(B_.shape)}, chunk {kwargs['chunk']}, fp32; "
          f"{time.perf_counter() - t0} s): {out}")
    return out


def encdec_serving(torch, dev, seed: int, zero_counts, counted, kernel,
                   records, refs: dict) -> dict:
    """Phase 17a (see the module docstring); ``refs["ws"]`` gets phase
    21b's reference."""
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from torch_checks import attn_tol, bf16_attn_err
    run = family_serving(torch, dev, seed, zero_counts, counted, ENCDEC_ARCH,
                         lambda cfg: (0,), "whisper lm", batch=ENCDEC_BATCH,
                         prompt=ENCDEC_PROMPT, steps=ENCDEC_STEPS)
    cfg, params, prompts, inputs, lm = (run[k] for k in (
        "cfg", "params", "prompts", "inputs", "lm"))
    n_attn = flash_modules(params)
    if n_attn != cfg.enc_layers + 2 * cfg.num_layers:
        raise SystemExit(f"whisper lm: {n_attn} flash modules")
    refs["ws"] = serve_family_ref(torch, cfg, run)
    layer_err = check_layers(attention, lm["captured"],
                             tmodel.layer_windows(cfg), "whisper lm check")
    # one more prefill with the encoder's layer 0 and decoder layer 0's
    # cross-attention captured: the kernel against its plain version there
    captured = {}

    def capture(name):
        def hook(module, args, kwargs, output):
            captured[name] = (*args, kwargs.get("causal"), output)
        return hook
    hooks = [params.enc_layers[0].attn_core.register_forward_hook(
        capture("encoder"), with_kwargs=True),
        params.layers[0].xattn_core.register_forward_hook(
        capture("cross"), with_kwargs=True)]
    try:
        lm["prefill"](params, inputs)
    finally:
        for h in hooks:
            h.remove()
    for name, (cq, ck, cv, causal, cout) in captured.items():
        want = attention.flash_attention_fwd_plain(
            cq.float(), ck.float(), cv.float(), causal=False)
        err, tol = max_abs_err(cout, want), attn_tol(want, cout.dtype)
        elem = bf16_attn_err(cout, want)
        if causal is not False or not (err <= tol and elem <= 1):
            raise SystemExit(f"whisper lm: the {name} attention at layer 0 "
                             f"(causal {causal}): {err} > {tol} or element "
                             f"err/tol {elem} > 1")
        layer_err[name] = {"err": err, "tol": tol, "element": elem}
        print(f"whisper lm check: the {name} attention at layer 0 (q "
              f"{tuple(cq.shape)}, k/v {tuple(ck.shape)}, bidirectional, "
              f"bf16): kernel vs plain max err {err} <= {tol}, element "
              f"err/tol {elem}")
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, lm["prefill"], params,
        inputs, lm["kernel_logits"], "whisper lm check",
        windows=[None] * n_attn)

    # the encoder's output by the two routes, bf16 and fp32
    def encoded(dtype, plain):
        seen = []
        with torch.no_grad(), compute_dtype(tmodel, dtype), swapped(
                tflash, serve=plain_routes(
                    torch, attention, windows=seen)[0] if plain else None):
            out = tmodel._encoder(params, cfg, inputs["frames"], train=False)
        if plain and seen != [None] * cfg.enc_layers:
            raise SystemExit(f"whisper lm: the plain encoder route received "
                             f"{seen}")
        return out.float()
    enc_checks = {}
    for name, frac in LOGIT_TOL.items():
        dt = getattr(torch, name)
        got, want = encoded(dt, False), encoded(dt, True)
        err, tol = max_abs_err(got, want), frac * float(want.abs().max())
        enc_checks[name] = {"err": err, "tol": tol}
        print(f"whisper lm check {name}: the encoder's output, kernel vs "
              f"plain route: max err {err} <= {tol} ({frac} of max "
              f"{float(want.abs().max())})")
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise SystemExit(f"whisper lm {name}: the encoder's output "
                             f"differs between the routes: {err} > {tol}")
        del got, want
    steps = step_check(torch, tmodel, cfg, params, prompts,
                       "whisper lm check", extra={"frames": inputs["frames"]})

    # rows 5e and 5x: the kernel at the encoder's and the cross-attention's
    # prefill shapes, and the encoder at one (1, 4) rank's heads, beside its
    # plain version and SDPA (no mask)
    whole = (cfg.num_heads, cfg.num_kv_heads)
    for label, name, heads in (("encoder", "encoder", whole),
                               ("cross", "cross", whole),
                               ("encoder (1, 4) rank", "encoder",
                                RANK_HEADS["whisper"])):
        cq, ck, cv, _, cout = captured[name]
        flash_fwd_row(torch, attention, kernel, label, (cq, ck, cv, cout),
                      False, heads, lm["launches"]["flash_attention_fwd"])
        if heads == whole:
            records[-1]["prefill_launches"] = n_attn
    out = dict(run["record"], card=CARD["smi"], layer_checks=layer_err,
               logit_checks=logit_checks, encoder_checks=enc_checks,
               step_check=steps, flash_launches_per_prefill=n_attn)
    print(json.dumps({"whisper_lm_path": out}))
    del run, params, lm, captured, inputs, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_training(torch, dev, seed: int, zero_counts, counted, kernel,
                    records, refs: dict) -> dict:
    """Phase 17b (see the module docstring); ``refs["wt"]`` gets phase
    21d's reference."""
    from repro_torch.kernels import attention
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe

    def before_opt(params, cfg, batches):
        refs["wt"] = train_family_ref(torch, tmodel, tmoe, params, cfg,
                                      batches[0], FAMILY_GRADS["wt"])
        return {}
    run = family_training(
        torch, dev, seed, zero_counts, counted, ENCDEC_ARCH, "whisper train",
        batch=ENCDEC_BATCH, seq=ENCDEC_TRAIN_SEQ,
        route_names=("enc_layers.0.enc_wq", "layers.0.wq",
                     "layers.0.xattn_wq"),
        capture={"encoder": lambda p: p.enc_layers[0].attn_core,
                 "self": lambda p: p.layers[0].attn_core,
                 "cross": lambda p: p.layers[0].xattn_core},
        before_opt=before_opt)
    refs["wt"].update(step_ms=run["record"]["step_ms"],
                      peak=run["record"]["peak_bytes"])
    launches = run["record"]["launches"]
    del run["params"], run["opt"], run["batches"]
    gc.collect()
    torch.cuda.empty_cache()
    # rows 5be and 5bx: the backward kernel at the encoder's and the
    # cross-attention's training shapes on the step's dout brought to unit
    # RMS (exact), beside its plain version and SDPA's backward
    for name in ("encoder", "cross"):
        flash_bwd_row(torch, attention, kernel, records, name,
                      run["captured"][name], None,
                      launches["flash_attention_bwd"])
    flash_bwd_row(torch, attention, kernel, records, "encoder (1, 4) rank",
                  run["captured"]["encoder"], RANK_HEADS["whisper"],
                  launches["flash_attention_bwd"])
    for r in records:
        if r["name"] in ("flash_attention_fwd encoder",
                         "flash_attention_fwd cross"):
            r["train_launches"] = launches["flash_attention_fwd"]
    out = run["record"]
    print(json.dumps({"whisper_train_path": out}))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_training(torch, dev, seed: int, zero_counts, counted, kernel,
                 records, refs: dict) -> dict:
    """Phase 17c (see the module docstring); ``refs["mt"]`` gets phase
    21c's reference."""
    from repro_torch.kernels import attention
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.models.layers import mlp
    held = {}

    def before_opt(params, cfg, batches):
        # two runs of the same loss and backward from the same state
        def grads_of(b):
            params.requires_grad_(True)
            loss, _ = tmodel.lm_loss(params, cfg, b)
            loss.backward()
            g = {n: p.grad for n, p in params.named_parameters()}
            params.zero_grad(set_to_none=True)
            return loss.detach(), g
        l1, g1 = grads_of(batches[0])
        l2, g2 = grads_of(batches[0])
        differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]

        print(f"moe train check: two runs of the loss and backward from the "
              f"same state: losses {float(l1)} and {float(l2)}, "
              f"{len(g1) - len(differ)}/{len(g1)} gradients bit-identical "
              f"{differ[:6]}")
        if differ or not torch.equal(l1, l2):
            raise SystemExit(f"moe train: gradients differ between two runs: "
                             f"{differ}")
        del g1, g2
        refs["mt"] = train_family_ref(torch, tmodel, tmoe, params, cfg,
                                      batches[0], FAMILY_GRADS["mt"])
        # the drops per layer and layer 0's MoE input, from one forward
        calls = []
        with torch.no_grad():
            routed(tmoe, lambda: tmodel.lm_loss(params, cfg, batches[0]),
                   calls)
        dropped = [int((~c["keep"]).sum()) for c in calls]
        x, p, spec, act = calls[0]["args"]
        held.update(x=x.detach().float().clone(), spec=spec, act=act,
                    p={k: v.detach().float().clone() for k, v in p.items()})
        T, m = x.shape[0] * x.shape[1], cfg.moe
        print(f"moe train: assignments dropped by the capacity per layer (T "
              f"= {T}, top {m.top_k}, C = "
              f"{tmoe._capacity(T, m.top_k, m.num_experts, m.capacity_factor)}"
              f"): {dropped}")
        return {"dropped_per_layer": dropped, "grads_bit_identical": True}

    run = family_training(
        torch, dev, seed, zero_counts, counted, MOE_ARCH, "moe train",
        batch=MOE_TRAIN_BATCH, seq=FAMILY_TRAIN_SEQ,
        layers=MOE_TRAIN_LAYERS,
        route_names=("layers.0.wq", "layers.0.wk", "layers.0.wv"),
        capture={"layer 0": lambda p: p.layers[0].attn_core},
        before_opt=before_opt)
    out = run["record"]
    refs["mt"].update(step_ms=out["step_ms"], peak=out["peak_bytes"])
    flash_bwd_row(torch, attention, kernel, records, "moe (1, 4) rank",
                  run["captured"]["layer 0"], RANK_HEADS["moe"],
                  out["launches"]["flash_attention_bwd"])
    del run
    gc.collect()
    torch.cuda.empty_cache()
    # layer 0's MoE gradients against its per-token dense form's, fp32
    x0, p0, spec, act = held["x"], held["p"], held["spec"], held["act"]
    gy = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(x0.shape)).astype(np.float32)).to(dev)

    def grads_of(fn):
        x = x0.clone().requires_grad_()
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        (fn(x, p) * gy).sum().backward()
        return {"x": x.grad, **{k: v.grad for k, v in p.items()}}
    dense_checks = {}
    for factor in (spec.capacity_factor, MOE_TIGHT_FACTOR):
        sp = dataclasses.replace(spec, capacity_factor=factor)
        t0 = time.perf_counter()
        got = grads_of(lambda x, p: tmoe.moe_ffn(x, p, sp, act))
        drops = []
        want = grads_of(lambda x, p: drops.append(dense_moe(
            torch, tmoe, mlp, x, p, sp, act)) or drops[-1][0])
        torch.cuda.synchronize()
        errs = {"dropped": drops[0][1]}
        for name, w in want.items():
            errs[name] = max_abs_err(got[name], w) / max(
                float(w.abs().max()), 1e-30)
        dense_checks[factor] = errs
        print(f"moe train check: layer 0's MoE gradients (fp32, capacity "
              f"factor {factor}, {drops[0][1]} assignments dropped) vs its "
              f"per-token dense form's, max err over max|dense| per tensor: "
              f"{errs} (tolerance {MOE_GRAD_TOL}; "
              f"{time.perf_counter() - t0} s)")
        if not all(e <= MOE_GRAD_TOL for n, e in errs.items()
                   if n != "dropped"):
            raise SystemExit(f"moe train: the MoE gradients differ from the "
                             f"dense form's at capacity factor {factor}")
        del got, want
    out["dense_grad_checks"] = {str(k): v for k, v in dense_checks.items()}
    print(json.dumps({"moe_train_path": out}))
    del held, x0, p0, gy
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssm_train_layers(full) -> int:
    """Phase 17d's and 17e's depth: the published one, cut until the fp32
    training state takes at most TRAIN_STATE_SHARE of the card."""
    layers = full.num_layers
    while STATE_BYTES_PER_PARAM * dataclasses.replace(
            full, num_layers=layers).param_count() > TRAIN_STATE_SHARE * \
            CARD_BYTES:
        layers -= 1
    return layers


def ssm_serve_ref(torch, tmodel, run: dict) -> dict:
    """Phase 23a's or b's reference from 16b's or 16c's run:
    :func:`serve_family_ref` and the SSM caches after one more prefill of
    its prompts (:func:`ssm_caches`)."""
    cfg, params, lm = run["cfg"], run["params"], run["lm"]
    _, cache = lm["prefill"](params, {"tokens": run["prompts"]})
    ref = serve_family_ref(torch, cfg, run)
    ref["caches"] = ssm_caches(tmodel, cache, cfg)
    return ref


def ssm_training(torch, dev, seed: int, zero_counts, counted, arch: str,
                 label: str, route_names=(), capture=(), kernel=None,
                 records=None) -> dict:
    """Phase 17d (Mamba2) and 17e (Hymba): see the module docstring.  With
    attention (Hymba) the gradients are held kernel vs mixed route and in
    fp32 kernel vs plain route, not kernel vs plain in bf16: there the
    forward's bf16 rounding alone moves layer 0's gradients past ROUTE_TOL
    (mixed vs plain 0.0647 on batch 0 of a first card run, with the
    backward kernel's share 0.023 and fp32 kernel vs plain 1e-5).  With
    ``kernel``, the backward kernel's row at a (2, 2) rank's shard of the
    first captured flash module (row 5bhr)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    full = get_config(arch)
    layers = ssm_train_layers(full)
    held = {}

    def before_opt(params, cfg, batches):
        held["ssd"] = ssd_grad_check(torch, params, cfg, batches[0], label,
                                     seed)
        return {}
    run = family_training(
        torch, dev, seed, zero_counts, counted, arch, label,
        batch=SSM_TRAIN_BATCH, seq=FAMILY_TRAIN_SEQ, route_names=route_names,
        layers=layers if layers != full.num_layers else None,
        capture=capture, hold_plain=False, fp32_route=bool(route_names),
        before_opt=before_opt)
    out = dict(run["record"], ssd_grad_check=held["ssd"])
    if kernel is not None and capture:
        flash_bwd_row(torch, attention, kernel, records, HYBRID_RANK,
                      run["captured"][next(iter(dict(capture)))], None,
                      out["launches"]["flash_attention_bwd"],
                      batch=SSM_TRAIN_BATCH // 2)
    print(json.dumps({f"{label.split()[0]}_train_path": out}))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def restart_path(torch, dev, seed: int) -> dict:
    """Phase 13b (see the module docstring)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import train_lm_torch as example
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import (OptimConfig, init_opt_state,
                                         learning_rate)
    from repro_torch.train import loop
    from repro_torch.train.step import TrainConfig
    total, at = RESTART_STEPS
    dcfg = DataConfig(vocab_size=example.CFG.vocab_size, seq_len=256,
                      docs_per_shard=512, num_shards=4, num_attributes=32,
                      seed=seed)
    ds = BitmapIndexedDataset(dcfg, device=dev)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    tcfg = TrainConfig(ocfg)

    def batches(start):
        return ds.batches(8, where=example.SELECTION, seed=seed,
                          start_step=start)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        whole, resumed = os.path.join(root, "whole"), os.path.join(root,
                                                                   "resumed")
        t0 = time.perf_counter()
        a = loop.train_loop(example.CFG, tcfg, loop.LoopConfig(
            total_steps=total, ckpt_dir=whole, ckpt_every=at, log_every=1),
            batches, seed=seed, device=dev)
        whole_s = time.perf_counter() - t0
        ckpt_bytes = dir_bytes(os.path.join(whole, f"step-{total:08d}"))
        shutil.copytree(os.path.join(whole, f"step-{at:08d}"),
                        os.path.join(resumed, f"step-{at:08d}"))
        b = loop.train_loop(example.CFG, tcfg, loop.LoopConfig(
            total_steps=total, ckpt_dir=resumed, ckpt_every=at, log_every=1),
            batches, seed=seed + 1, device=dev)
        lr_max = float(learning_rate(ocfg, torch.arange(1, total + 1)).max())
        tol = 2 * (total - at) * lr_max
        pairs = {"params": [(p.detach(), q.detach()) for p, q in zip(
            a["params"].parameters(), b["params"].parameters())]}
        for mom in ("m", "v"):
            pairs[mom] = [(a["opt"][mom][k], b["opt"][mom][k])
                          for k in a["opt"][mom]]
        diff = {what: max(float((p - q).abs().max()) for p, q in ps)
                for what, ps in pairs.items()}
        moment_ratio = {mom: max(
            float((p - q).abs().max()) / max(float(q.abs().max()), 1e-30)
            for p, q in pairs[mom]) for mom in ("m", "v")}
        identical = {what: all(torch.equal(p, q) for p, q in ps)
                     for what, ps in pairs.items()}
        steps = (int(a["opt"]["step"]), int(b["opt"]["step"]))
        print(f"train restart: {total} steps of {example.CFG.name} "
              f"({example.CFG.param_count()} parameters) in {whole_s} s, "
              f"checkpoints of {ckpt_bytes} bytes; restarted from step {at} "
              f"in a fresh model (seed {seed + 1}): steps {steps}; params "
              f"max |diff| {diff['params']} (tolerance {tol}: a near-zero "
              f"gradient element whose sign differs moves its Adam update by "
              f"2 lr a step); moments max |diff| over each tensor's largest "
              f"magnitude {moment_ratio} (tolerance {RESTART_MOMENT_TOL}); "
              f"bit-identical {identical}; final losses {a['final_loss']} "
              f"and {b['final_loss']}")
        if not (steps == (total, total) and diff["params"] <= tol
                and all(r <= RESTART_MOMENT_TOL
                        for r in moment_ratio.values())
                and np.isfinite(a["final_loss"])):
            raise SystemExit("train restart: the restarted run differs")
        # a checkpoint written on the card restores in the port on the CPU
        cpu = tmodel.init_params(example.CFG, seed=seed, device="cpu",
                                 dtype=torch.float32)
        opt = init_opt_state(cpu, ocfg)
        state, step = ckpt.restore_checkpoint(
            whole, loop.checkpoint_state(cpu, opt))
        loop.load_checkpoint_state(cpu, opt, state)
        same = all(torch.equal(p.detach().cpu(), q) for p, q in zip(
            a["params"].parameters(), cpu.parameters())) and all(
            torch.equal(a["opt"][mom][k].cpu(), opt[mom][k])
            for mom in ("m", "v") for k in opt[mom])
        print(f"train restart: the card's step-{step} checkpoint restored "
              f"into repro_torch on the CPU, parameters and moments "
              f"bit-identical {same}")
        if step != total or not same or int(opt["step"]) != total:
            raise SystemExit("train restart: the card's checkpoint does not "
                             "restore on the CPU")
        out = {"steps": total, "restart_at": at, "whole_s": whole_s,
               "ckpt_bytes": ckpt_bytes, "max_abs_diff": diff,
               "moment_ratio": moment_ratio, "tolerance": tol,
               "bit_identical": identical}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        ds.close()
    print(json.dumps({"restart_path": out}))
    return out


#: phase 14: the locks that must be wrapped by the port's witness (each a
#: ``witness._Wrapped`` carrying this id), so that the witness was not
#: vacuous
WITNESS_LOCKS = ("BitmapService._cv", "BitmapService._elock",
                 "MaintenanceExecutor._cv", "StreamingIndexer._mu",
                 "SegmentStore._flush_lock", "SegmentStore._lock",
                 "FabricClient._flush_lock", "ServiceHost._append_lock")
#: phase 14: shard-side locks; a FabricClient lock held while one of these
#: is taken is the loopback nesting only the runtime witness can see
SHARD_LOCKS = ("ServiceHost._append_lock", "BitmapService._close_lock",
               "BitmapService._flush_lock", "BitmapService._cv",
               "BitmapService._elock", "MaintenanceExecutor._cv",
               "SegmentStore._flush_lock", "StreamingIndexer._mu",
               "SegmentStore._lock")


def witness_path(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
                 read_waves, repro_torch, BitmapDB, policy, sync_times: dict,
                 storm_11a: dict) -> None:
    """Phase 14 (see the module docstring)."""
    import collections
    t_phase = time.perf_counter()
    from repro_torch import analysis
    from repro_torch.analysis import witness
    from repro_torch.analysis.core import default_baseline_path
    from repro_torch.fabric import FabricClient, ShardMap
    from repro_torch.fabric.envelope import Envelope
    from repro_torch.serve.service import ServiceConfig

    # ---- 14a. the static analysis of the checkout
    t0 = time.perf_counter()
    findings = analysis.run(ROOT)
    unbase, supp, stale = analysis.Baseline.load(
        default_baseline_path()).split(findings)
    per_checker = collections.Counter(f.checker for f in findings)
    print(f"analysis: {len(findings)} findings in "
          f"{time.perf_counter() - t0} s, per checker {dict(per_checker)}: "
          f"{len(unbase)} unbaselined, {len(supp)} baselined, {len(stale)} "
          f"stale baseline entries")
    if unbase or stale:
        raise SystemExit("analysis: " + "; ".join(
            [f.render() for f in unbase] + [str(e) for e in stale]))

    # ---- 14b. the witness over the concurrent paths, at full size
    p3_rows, p3_counts = p3["rows"], p3["counts"].tolist()
    bitmap = ("bulk_program", "bitmap_query")
    wrapped, out = {}, {}
    wit = witness.install(ROOT)
    try:
        # 1. the service storm over a fresh 2^25-record session
        db = BitmapDB(num_keys=M, device=dev)
        for blk in host_blocks:
            db.append_encoded(blk)
        svc = db.serve(max_batch=256, max_delay_ms=2.0)
        wrapped.update({"BitmapService._cv": svc._cv,
                        "BitmapService._elock": svc._elock})

        def body(t, seqs, bad):
            futs = [(i, svc.submit(q)) for i, q in enumerate(wave)]
            for i, f in futs:
                row, cnt = f.result(timeout=600)
                if not (torch.equal(row, p3_rows[i])
                        and int(cnt) == p3_counts[i]):
                    bad.append((t, i))
                seqs.append(f.resolve_seq)
        zero_counts()
        threads, seqs, bad = _submitters(SERVICE_THREADS, body)
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        storm_s = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or \
                not svc.drain(timeout=600):
            raise SystemExit("witness storm: a submitter or the drain hung")
        torch.cuda.synchronize()
        n_q = SERVICE_THREADS * len(wave)
        if bad or svc.metrics().served != n_q or \
                any(s != sorted(s) for s in seqs):
            raise SystemExit(f"witness storm: answers differ from phase 3's "
                             f"{bad[:5]} or futures resolved out of order")
        launches = read_counts(*bitmap)
        if min(launches.values()) < 1:
            raise SystemExit(f"witness storm: launches {launches}")
        out["storm"] = {"queries": n_q, "storm_s": storm_s,
                        "queries_per_s": n_q / storm_s,
                        "ladder": ladder_clean(svc, "witness storm"),
                        "launches": launches,
                        "waves": read_waves("witness storm")}
        svc.close(timeout=300)
        del svc, db
        repro_torch.engine.batch._AUG_CACHE.clear()
        gc.collect()
        print(f"witness storm: {SERVICE_THREADS} threads x 1 round of the "
              f"{len(wave)}-query wave over a fresh {BLOCKS * BLOCK}-record "
              f"session, every answer phase 3's: {n_q} queries in {storm_s}"
              f" s = {out['storm']['queries_per_s']} queries/s under the "
              f"witness (phase 11a, 4 rounds without it: "
              f"{storm_11a['queries_per_s']} queries/s); ladder "
              f"{out['storm']['ladder']}; launches {launches}; waves per "
              f"backend {out['storm']['waves']}")

        # 2. the durable session with background spills (11c's)
        out["durable"] = durable_service(
            torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
            read_waves, repro_torch, BitmapDB, policy, [], sync_times,
            label="witness durable service", keep=wrapped)
        gc.collect()

        # 3. the loopback fabric over 4 shards, one wave and one
        #    exactly-once append with its resend
        per = BLOCKS // FABRIC_SHARDS
        sm = ShardMap.blocked(FABRIC_SHARDS, block_size=per * BLOCK)
        gids = [np.arange(s * per * BLOCK, (s + 1) * per * BLOCK,
                          dtype=np.int64) for s in range(FABRIC_SHARDS)]
        cfg = {"max_batch": 256, "max_delay_ms": 2.0}
        zero_counts()
        dbs = []
        for s in range(FABRIC_SHARDS):
            sdb = BitmapDB(num_keys=M, device=dev)
            for blk in host_blocks[s * per:(s + 1) * per]:
                sdb.append_encoded(blk)
            dbs.append(sdb)
        fc = FabricClient.local(dbs, sm, gids=gids,
                                service_config=ServiceConfig(**cfg), **cfg)
        try:
            wave_ms = fabric_wave(fc, wave,
                                  p3_rows.cpu().numpy().view(np.uint32),
                                  p3_counts, "witness fabric")
            shard = int(sm.route(host_blocks[0][:1],
                                 start_gid=fc.num_records)[0])
            n = fc.append_encoded(host_blocks[0])
            seq = fc._next_seq[shard]
            dup = fc._shard_request(shard, Envelope("append", payload={
                "stream": fc._stream, "seq": seq,
                "records": np.asarray(host_blocks[0], np.int32)}),
                hedge=False)
            total = sum(p["num_records"] for p in fc.info())
            want = (BLOCKS + 1) * BLOCK
            if not dup.payload["duplicate"] or n != want or total != want:
                raise SystemExit(f"witness fabric: exactly-once append: "
                                 f"duplicate {dup.payload}, client {n}, "
                                 f"shards {total}, want {want}")
            for h in fc.health()["shards"]:
                ladder_of(h, f"witness fabric, shard {h['shard_id']}")
            wrapped.update({"FabricClient._flush_lock": fc._flush_lock,
                            "ServiceHost._append_lock":
                                fc._owned_hosts[shard]._append_lock})
            torch.cuda.synchronize()
            launches = read_counts("cam_match", "bit_transpose", *bitmap)
            if min(launches.values()) < 1:
                raise SystemExit(f"witness fabric: launches {launches}")
            out["fabric"] = {"wave_ms": wave_ms, "append_shard": shard,
                             "launches": launches,
                             "waves": read_waves("witness fabric")}
        finally:
            fc.close(timeout=300)
        del dbs, fc
        gc.collect()
        torch.cuda.empty_cache()
        print(f"witness fabric: the wave over {FABRIC_SHARDS} loopback "
              f"shards bit-identical to phase 3's in {wave_ms} ms; block 0 "
              f"appended to shard {shard} (seq {seq}), the resent seq "
              f"acknowledged duplicate={dup.payload['duplicate']}, info() "
              f"totals {total}; launches {out['fabric']['launches']}; waves "
              f"per backend {out['fabric']['waves']}")
    finally:
        witness.uninstall()
    violations = wit.violations()
    pairs = sorted(wit.pairs.items())
    for (outer, inner), (fn, line, held) in pairs:
        print(f"  witness pair {outer} -> {inner}: first at "
              f"{os.path.relpath(fn, ROOT)}:{line} (held "
              f"{' -> '.join(held)})")
    bare = [lid for lid in WITNESS_LOCKS
            if not (isinstance(wrapped.get(lid), witness._Wrapped)
                    and wrapped[lid].lock_id == lid)]
    client = [(a, b) for (a, b), _ in pairs
              if a.startswith("FabricClient.") and b in SHARD_LOCKS]
    phase_s = time.perf_counter() - t_phase
    print(f"witness: {len(pairs)} observed (outer, inner) pairs, "
          f"{len(violations)} violations; the {len(WITNESS_LOCKS)} named "
          f"locks wrapped: {not bare}; client-to-shard nestings {client}; "
          f"phase 14 took {phase_s} s")
    if violations or bare or not client:
        raise SystemExit(f"witness: violations {violations}, locks not "
                         f"wrapped {bare}, client-to-shard nestings {client}")
    out.update(phase_s=phase_s, pairs=len(pairs), findings=dict(per_checker),
               baselined=len(supp),
               client_to_shard=[list(p) for p in client])
    print(json.dumps({"witness_path": out}))


def dryrun_cost(arch: str, shape_name: str) -> int:
    """A rank for phase 18a's queue, most expensive first: the SSM and
    hybrid train and prefill cells walk their SSD chunk loop per layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES
    cfg, kind = get_config(arch), SHAPES[shape_name].kind
    return (kind == "train") * 2 + (kind == "prefill") + \
        (cfg.block != "attn") * 3


def card_cell(torch, dev, dryrun, cell: dict, seed: int, zero_counts,
              counted) -> dict:
    """Phase 18b: one cell that 18a says fits the card, run for real: its
    arguments made from ``seed`` in the traced dtypes (parameters normal x
    0.02, optimizer state and cache zero, decode at pos = S - 1), the step
    run once under ``dryrun.FlopCount`` (``FlopCounterMode``'s formulas)
    with the launch counters zeroed, timed (printed only).  Fails unless
    the arguments' bytes are the cell's, the peak over what was resident
    before is within ``dryrun.PEAK_BOUND`` of the prediction, the flash
    launches are the traced calls, the non-attention flops are the
    trace's and the output (logits, or a train step's loss) is finite."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.shapes import SHAPES
    from torch_checks import STEP_FILLS, materialize
    label = f"{cell['arch']} {cell['shape']}"
    cfg, shape = get_config(cell["arch"]), SHAPES[cell["shape"]]
    mesh = dryrun.card_mesh()
    with set_mesh(mesh):
        fn, args, _, _, accum = dryrun.build_step_and_specs(cfg, shape, mesh)
    if shape.kind == "train":           # the whole step: every microbatch
        fn = dryrun.train_fn(cfg, accum)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    real = [materialize(a, dev, gen, cfg.vocab_size, f)
            for a, f in zip(args, STEP_FILLS[shape.kind])]
    torch.cuda.synchronize()
    arg_bytes = dryrun.tree_bytes(real)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with dryrun.FlopCount() as fc:
        out = fn(*real)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    launches = {n: counted[n].launches for n in cell["flash_calls"]}
    logits = out[0] if shape.kind != "train" else out[2]["loss"]
    finite = bool(torch.isfinite(logits).all())
    del out, logits, real
    gc.collect()
    torch.cuda.empty_cache()
    predicted = cell["peak_bytes"]
    rec = {"cell": label, "argument_bytes": arg_bytes,
           "predicted_peak": predicted, "peak": peak,
           "peak_over_predicted": peak / predicted,
           "launches": launches, "traced_calls": cell["flash_calls"],
           "flops": fc.flops,
           "traced_matmul_flops": cell["matmul_flops"], "wall_s": wall_s}
    print(f"dryrun 18b {label}: arguments {arg_bytes} B (dry run "
          f"{cell['memory']['argument_size_in_bytes']}); peak {peak} B over "
          f"{resident} resident, predicted {predicted} (args + temp "
          f"{cell['memory']['temp_size_in_bytes']}): ratio "
          f"{peak / predicted}; flash launches {launches}, traced "
          f"{cell['flash_calls']}; non-attention flops {rec['flops']}, "
          f"traced {cell['matmul_flops']}; step {wall_s} s under the counter "
          f"(printed only) "
          f"[{CARD['smi']}]")
    if arg_bytes != cell["memory"]["argument_size_in_bytes"]:
        raise SystemExit(f"{label}: arguments {arg_bytes} B, the dry run "
                         f"says {cell['memory']['argument_size_in_bytes']}")
    if abs(peak - predicted) > dryrun.PEAK_BOUND * predicted:
        raise SystemExit(f"{label}: peak {peak} B outside "
                         f"{dryrun.PEAK_BOUND} of the predicted {predicted}")
    if launches != cell["flash_calls"]:
        raise SystemExit(f"{label}: flash launches {launches}, traced "
                         f"{cell['flash_calls']}")
    if rec["flops"] != cell["matmul_flops"]:
        raise SystemExit(f"{label}: {rec['flops']} non-attention flops on "
                         f"the card, {cell['matmul_flops']} traced")
    if not finite:
        raise SystemExit(f"{label}: the step's output is not finite")
    return rec


def dryrun_path(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phase 18 (see the module docstring)."""
    import concurrent.futures
    import multiprocessing
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES
    t18 = time.perf_counter()
    card = dryrun.card_mesh()
    cells = sorted(((a, s) for a in ARCHS for s in SHAPES),
                   key=lambda c: -dryrun_cost(*c))
    phases = {ph: PHASE_PEAKS[lab] for ph, lab in PEAK_PHASES.items()
              if lab in PHASE_PEAKS}
    missing = sorted(set(PEAK_PHASES) - set(phases))
    if missing:
        raise SystemExit(f"dryrun 18c: phases {missing} recorded no peak")
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(DRYRUN_JOBS,
                                                mp_context=ctx) as ex:
        card_futs = {c: ex.submit(dryrun.run_cell_or_error, *c, card)
                     for c in cells}
        peak_futs = {ph: ex.submit(
            dryrun.config_peak, r["cfg"], r["kind"], r["batch"], r["seq"],
            max_len=r.get("max_len"),
            param_dtype=r.get("param_dtype", torch.float32),
            token_dtype=r["token_dtype"]) for ph, r in phases.items()}
        # 18a: the production meshes' argument bytes here meanwhile
        prod = {}
        for m in (make_production_mesh(), make_production_mesh(
                multi_pod=True)):
            for a, s_ in cells:
                prod[a, s_, m.name] = dryrun.run_cell(a, s_, m)
        # 18b: each cell that fits runs for real as soon as its trace is
        # back, while the workers trace the rest and 18c
        print(f"dryrun 18b: {torch.cuda.memory_allocated()} B allocated "
              f"before the cells")
        res, runs, t18b = {}, [], 0.0
        for f in concurrent.futures.as_completed(card_futs.values()):
            c = f.result()
            res[c["arch"], c["shape"]] = c
            if c["status"] == "error":
                raise SystemExit(f"dryrun {c['arch']} {c['shape']}: "
                                 f"{c['error']}\n{c['traceback']}")
            if c.get("fits_card"):
                t0 = time.perf_counter()
                runs.append(card_cell(torch, dev, dryrun, c, seed,
                                      zero_counts, counted))
                t18b += time.perf_counter() - t0
        t18a = time.perf_counter() - t18
        print(f"dryrun 18a: {len(res)} cells on the one-card mesh (traced on "
              f"meta, {DRYRUN_JOBS} workers) and on 16x16 and 2x16x16 "
              f"(argument bytes), with 18b's runs, in {t18a} s")
        print("  arch, shape: status | argument GB on card / 16x16 / "
              "2x16x16 | flops (model flops) | temp GB on card | fits_card")
        for a in ARCHS:
            for s_ in SHAPES:
                c = res[a, s_]
                if c["status"] == "skipped":
                    print(f"  {a}, {s_}: skipped ({c['reason']})")
                    continue
                gb = [x["memory"]["argument_size_in_bytes"] / 1e9 for x in (
                    c, prod[a, s_, "16x16"], prod[a, s_, "2x16x16"])]
                print(f"  {a}, {s_}: ok | {gb[0]} / {gb[1]} / {gb[2]} | "
                      f"{c['flops']} ({c['model_flops']}) | "
                      f"{c['memory']['temp_size_in_bytes'] / 1e9} | "
                      f"{c['fits_card']}")
        fits = [c for c in res.values() if c.get("fits_card")]
        kinds = {SHAPES[c["shape"]].kind for c in fits}
        print(f"dryrun 18a: {len(fits)} cells fit the card (the predicted "
              f"peak, {dryrun.PEAK_BOUND} over, within {dryrun.CARD_BYTES} "
              f"B): "
              f"{[(c['arch'], c['shape']) for c in fits]}; no cell of kind "
              f"{sorted({'train', 'prefill', 'decode'} - kinds)} fits")
        peaks = {ph: f.result() for ph, f in peak_futs.items()}
    # 18c: the earlier phases' steps and peaks against the dry run's
    bound = dryrun.PEAK_BOUND
    held_rows = []
    for ph, r in phases.items():
        p_ = peaks[ph]
        held = r["end"] - r["resident"] - p_["argument_bytes"]
        predicted = r["resident"] + held + p_["argument_bytes"] + p_["temp"]
        row = {"phase": ph, "args": r["args"],
               "traced_args": p_["argument_bytes"], "before": r["before"],
               "step_peak": r["step_peak"], "temp": p_["temp"],
               "temp_ratio": r["step_peak"] / p_["temp"],
               "resident": r["resident"], "held": held,
               "predicted": predicted, "peak": r["peak"],
               "ratio": r["peak"] / predicted, "carried": r["carried"],
               "checks_peak": r.get("checks_peak"),
               "first_peak": r.get("first_peak")}
        held_rows.append(row)
        step_top = r["before"] + r["step_peak"]
        where = ("before that step" if r["carried"] >= r["peak"] else
                 "by that step" if step_top >= r["peak"] else "after it")
        steps_17 = ("" if r.get("checks_peak") is None else
                    f", its set-up and route checks {r['checks_peak']}, "
                    f"then its first (hooked) step {r['first_peak']}")
        print(f"dryrun 18c {ph} ({r['cfg'].name}, {r['cfg'].num_layers} "
              f"layers, {r['kind']} {r['batch']} x {r['seq']}"
              f"{', cache ' + str(r['max_len']) if r.get('max_len') else ''}"
              f"): arguments {r['args']} B, the dry run's "
              f"{p_['argument_bytes']}; one step alone {r['step_peak']} B "
              f"over the {r['before']} allocated before it, traced temp "
              f"{p_['temp']}: ratio {row['temp_ratio']}; the phase: resident "
              f"{r['resident']} + held {held} (measured) + arguments + temp "
              f"= {predicted} B predicted, measured {r['peak']}: ratio "
              f"{row['ratio']}; the phase's peak set {where} (the step "
              f"reached {step_top}, the phase before it {r['carried']}"
              f"{steps_17}) [{CARD['smi']}]")
    bad = [h for h in held_rows if h["args"] != h["traced_args"]
           or abs(h["temp_ratio"] - 1) > bound
           or abs(h["ratio"] - 1) > bound or h["held"] < 0]
    total = time.perf_counter() - t18
    print(f"phase 18 took {total} s (18a {t18a} s, 18b {t18b} s)")
    if bad:
        raise SystemExit(f"dryrun 18c: arguments unlike the dry run's, or a "
                         f"step's temp or a phase's peak outside {bound} of "
                         f"the prediction (or the phase holding less than "
                         f"its arguments): {bad}")
    out = {"cells": len(res), "fits": [r["cell"] for r in runs],
           "card_runs": runs, "phase_peaks": held_rows, "phase_s": total,
           "dryrun_18a_s": t18a, "card": CARD["smi"]}
    print(json.dumps({"dryrun_path": out}))
    return out


# ---------------------------------------------------------------- phase 19
#: phase 19a: the loss within 1e-3 (relative) of 13a's unsharded loss and
#: layer 0's wq/wk/wv gradients within 1/16 (L2) of 13a's, 13a's own
#: route tolerances (the same kernels; only the sums' order may differ)
MESH_TOL = ROUTE_TOL
MESH_TIMED = 3              # phase 19a: steps timed (the median is kept)
MESH_FULL_LAYERS = 28       # 19a on 4 cards or more: the published depth
MESH_DEMO_STEPS = (4, 2)    # 19b: the launcher's steps, and its cadence
#: 19b: the restarted launcher's final loss against the whole run's
#: (relative): the same steps from the same state and data, on the same
#: kernels, so bit-identical is expected
MESH_RESTART_TOL = 1e-6
#: 19c: the parameters of 19a's 8 layers, fp32, and their checkpoint's
#: free disk with room to spare
MESH_CKPT_SLACK = 1.25


def _mesh_cmd(rank: int, world: int, port: int, work: str, shape: tuple,
              layers: int, seed: int, restore: bool) -> list:
    return [sys.executable, os.path.abspath(__file__), "--mesh-rank",
            str(rank), "--mesh-world", str(world), "--mesh-port", str(port),
            "--mesh-work", work, "--mesh-shape", "x".join(map(str, shape)),
            "--mesh-layers", str(layers), "--seed", str(seed)] + (
                ["--mesh-restore"] if restore else [])


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_processes(cmds: list) -> list:
    """Start every command at once, from the repository root with ``src``
    on the path."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    return [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for c in cmds]


def wait_processes(procs: list, label: str, timeout: float = 900) -> list:
    """Wait for every process and return their standard outputs; a failure
    of any stops the others and fails the phase."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode:
                raise SystemExit(f"{label}: a process exited with "
                                 f"{p.returncode}:\n{out[-3000:]}\n"
                                 f"{err[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def bits_equal(torch, a, b) -> bool:
    """Whether two tensors hold the same bits (dtype, shape and every
    element, NaN patterns too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.itemsize == 4:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def mesh_rank(args) -> int:
    """One rank of phase 19a (``--mesh-rank``): joins the NCCL group of
    ``--mesh-world`` ranks, one a card, and trains 13a's configuration at
    ``--mesh-layers`` on the ``--mesh-shape`` (data x model) device mesh;
    rank 0 writes its record to ``--mesh-work``/rank0.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    from repro_torch.engine.planner import key
    from repro_torch.kernels import attention, bit_transpose, bitmap_ops
    from repro_torch.kernels import cam_match
    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.loop import distribute_batch
    from repro_torch.train.step import TrainConfig, make_train_step
    rank, world = args.mesh_rank, args.mesh_world
    shape = tuple(int(s) for s in args.mesh_shape.split("x"))
    dev = init_distributed(f"127.0.0.1:{args.mesh_port}", world, rank,
                           device="cuda", local_rank=rank)
    counted = {"cam_match": cam_match.cam_match,
               "bit_transpose": bit_transpose.bit_transpose,
               "bitmap_query": bitmap_ops.bitmap_query,
               "bulk_program": bitmap_ops.bulk_program,
               "flash_attention_fwd": attention.flash_attention_fwd,
               "flash_attention_bwd": attention.flash_attention_bwd}

    def zero():
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()

    def launches():
        torch.cuda.synchronize()
        return {n: fn.launches for n, fn in counted.items()}
    # the loss's own all-reduces over groups of more than one rank: the
    # cross-card collectives a run of one card cannot make
    cross = {"all_reduce": 0}
    all_reduce = dist.all_reduce

    def counting_all_reduce(t, *a, group=None, **kw):
        if dist.get_world_size(group) > 1:
            cross["all_reduce"] += 1
        return all_reduce(t, *a, group=group, **kw)
    dist.all_reduce = counting_all_reduce
    try:
        mesh = make_device_mesh(shape, ("data", "model"), dev)
        out = {"rank": rank, "world": world, "mesh": mesh.name,
               "mesh_axes": dict(mesh.shape), "device": str(dev),
               "card": torch.cuda.get_device_name(dev)}
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  num_layers=args.mesh_layers)
        ref = torch.load(os.path.join(args.mesh_work, "ref13a.pt"))
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = tmodel.init_params(cfg, seed=args.seed, mesh=mesh,
                                    dtype=torch.float32)
        ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
        opt = init_opt_state(params, ocfg)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["local_bytes"] = torch.cuda.memory_allocated(dev)
        # 13a's data on every rank: the same deterministic stream
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          num_shards=4, num_attributes=32, seed=args.seed)
        zero()
        ds = BitmapIndexedDataset(dcfg, device=dev)
        first = next(ds.batches(TRAIN_BATCH, where=key(3) & key(18)
                                & ~key(25), seed=args.seed))
        out["data_launches"] = data = launches()
        if not (data["cam_match"] and data["bit_transpose"]
                and data["bitmap_query"] + data["bulk_program"]):
            raise SystemExit(f"mesh rank {rank}: the bitmap kernels did not "
                             f"run for the data ({data})")
        if not (torch.equal(first["tokens"].cpu(), ref["tokens"])
                and torch.equal(first["labels"].cpu(), ref["labels"])):
            raise SystemExit(f"mesh rank {rank}: the data stream's first "
                             "batch is not 13a's")
        batch = distribute_batch(first, mesh)
        del ds

        # the loss and layer 0's q/k/v gradients against 13a's
        params.requires_grad_(True)
        loss, _ = tmodel.lm_loss(params, cfg, batch)
        loss.backward()
        got_loss = float(tmodel.full_tensor(loss.detach()))
        grads = {n: tmodel.full_tensor(getattr(params.layers[0], n).grad)
                 .cpu() for n in ("wq", "wk", "wv")}
        params.zero_grad(set_to_none=True)
        err = {"loss": abs(got_loss - ref["loss"]) / abs(ref["loss"])}
        for n, g in grads.items():
            w = ref["grads"][n]
            err[f"layer0.{n}"] = float((g - w).norm() / w.norm())
        out["loss"], out["ref_loss"], out["errors"] = got_loss, ref["loss"], \
            err
        if args.mesh_layers == TRAIN_LAYERS and not (
                err["loss"] <= MESH_TOL["loss"]
                and all(err[f"layer0.{n}"] <= MESH_TOL["grad"]
                        for n in ("wq", "wk", "wv"))):
            raise SystemExit(f"mesh rank {rank}: the sharded loss and "
                             f"gradients differ from 13a's: {err} "
                             f"(tolerances {MESH_TOL})")
        del grads, loss

        # one counted step, then MESH_TIMED timed ones
        step = make_train_step(cfg, TrainConfig(ocfg))
        zero()
        before = dict(cross)
        with no_plain_attention(attention):
            params, opt, m = step(params, opt, batch)
            out["step_launches"] = n_ = launches()
        out["step_cross_card_all_reduces"] = (cross["all_reduce"]
                                              - before["all_reduce"])
        losses = [float(m["loss"])]
        if (n_["flash_attention_fwd"] != 2 * cfg.num_layers
                or n_["flash_attention_bwd"] != cfg.num_layers):
            raise SystemExit(f"mesh rank {rank}: want {2 * cfg.num_layers} "
                             f"forward and {cfg.num_layers} backward flash "
                             f"launches a step, saw {n_}")
        times = []
        with no_plain_attention(attention):
            for _ in range(MESH_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))     # waits for the step
                times.append(time.perf_counter() - t0)
        step_s = statistics.median(times)
        if rank == 0:                   # the parent may start 19b now
            open(os.path.join(args.mesh_work, "timed"), "w").close()
        out.update(losses=losses, step_ms=step_s * 1e3,
                   step_ms_all=[t * 1e3 for t in times],
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   cross_card_all_reduces=cross["all_reduce"])
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"mesh rank {rank}: losses {losses} not finite "
                             "and falling")

        if args.mesh_restore:
            # 19c: the parameters and step of this state, written by rank 0
            # from the gathered shards, restored into the unsharded model
            # on rank 0's card and held against the shards, bit for bit
            steps = int(opt["step"])
            del opt, m
            gc.collect()
            torch.cuda.empty_cache()
            named = {n: p.detach() for n, p in params.named_parameters()}
            path = os.path.join(args.mesh_work, "ckpt")
            t0 = time.perf_counter()
            ckpt.save_checkpoint(path, steps, {
                "params": tmodel.stack_layers(cfg, named, ckpt.LayerStack),
                "opt": {"step": torch.tensor(steps, dtype=torch.int32)}})
            out["save_s"] = time.perf_counter() - t0
            same, restored_step = True, None
            if rank == 0:
                t0 = time.perf_counter()
                plain = tmodel.init_params(cfg, seed=args.seed + 1,
                                           device=dev, dtype=torch.float32)
                pn = {n: p.detach() for n, p in plain.named_parameters()}
                state, restored_step = ckpt.restore_checkpoint(path, {
                    "params": tmodel.stack_layers(cfg, pn, ckpt.LayerStack),
                    "opt": {"step": torch.zeros((), dtype=torch.int32)}})
                with torch.no_grad():
                    for n, t in tmodel.unstack_layers(
                            cfg, state["params"]).items():
                        pn[n].copy_(t)
                del state
                out["restore_s"] = time.perf_counter() - t0
                out["restored_step"] = restored_step
            for n, p in named.items():              # every rank gathers
                whole = tmodel.full_tensor(p)
                if rank == 0:
                    same = same and bits_equal(torch, whole, pn[n])
                del whole
            out["ckpt_bytes"] = (dir_bytes(os.path.join(
                path, f"step-{steps:08d}")) if rank == 0 else None)
            out["restore_bit_identical"] = same
            out["restore_tensors"] = len(named)
            if rank == 0 and not (same and restored_step == steps):
                raise SystemExit(f"mesh restore: the unsharded model differs "
                                 f"from the sharded one (bit-identical "
                                 f"{same}, step {restored_step} of {steps})")
        if rank == 0:
            with open(os.path.join(args.mesh_work, "rank0.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    return 0


def mesh_reference(torch, dev, seed: int) -> dict:
    """Phase 19's reference without phases 2-18 (``--mesh-only``): 13a's
    configuration unsharded on the card, its first batch's loss and layer
    0's q/k/v gradients (the kernel route), and MESH_TIMED steps after a
    first, timed as 13a's (median) with their peak."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    from repro_torch.engine.planner import key
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = tmodel.init_params(cfg, seed=seed, device=dev,
                                dtype=torch.float32)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    opt = init_opt_state(params, ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      num_shards=4, num_attributes=32, seed=seed)
    first = next(BitmapIndexedDataset(dcfg, device=dev).batches(
        TRAIN_BATCH, where=key(3) & key(18) & ~key(25), seed=seed))
    params.requires_grad_(True)
    loss, _ = tmodel.lm_loss(params, cfg, first)
    loss.backward()
    ref = {"tokens": first["tokens"].cpu(), "labels": first["labels"].cpu(),
           "loss": float(loss.detach()),
           "grads": {n: getattr(params.layers[0], n).grad.cpu()
                     for n in ("wq", "wk", "wv")}}
    params.zero_grad(set_to_none=True)
    del loss
    step = make_train_step(cfg, TrainConfig(ocfg))
    params, opt, m = step(params, opt, first)
    times = []
    for _ in range(MESH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, first)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    out = {"mesh_reference": ref, "step_ms": step_s * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"mesh reference: 13a's configuration unsharded, loss "
          f"{ref['loss']}, step {out['step_ms']} ms (median of {MESH_TIMED}; "
          f"{[t * 1e3 for t in times]}), peak {out['peak_bytes']} bytes")
    del params, opt, m, first, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launcher_loss(out: str) -> float:
    line = [ln for ln in out.splitlines() if "final loss:" in ln]
    if len(line) != 1:
        raise SystemExit(f"launcher: no single final loss in:\n{out[-2000:]}")
    return float(line[0].rsplit(":", 1)[1])


def mesh_training(torch, seed: int, train_rec: dict, records: list) -> dict:
    """Phase 19 (see the module docstring)."""
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    shape = (n, 1)
    print(f"mesh: {n} card(s), one NCCL rank a card; 19a's mesh (data "
          f"{n}, model 1); cross-card collectives: " + (
              "none can run: every group holds one rank, one card" if n == 1
              else f"the data group spans {n} cards"))
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh-")
    atexit.register(shutil.rmtree, work, True)
    torch.save(train_rec["mesh_reference"], os.path.join(work, "ref13a.pt"))
    from repro_torch.configs import get_config
    cfg_bytes = 4 * dataclasses.replace(
        get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS).param_count()
    free = shutil.disk_usage(work).free
    if free < MESH_CKPT_SLACK * cfg_bytes:
        raise SystemExit(f"mesh: 19c needs {MESH_CKPT_SLACK} x {cfg_bytes} "
                         f"bytes free under {work}, has {free}")

    # 19a: 13a's configuration on the (n, 1) mesh; 19b's runs of the
    # launcher start once 19a's steps are timed, beside 19c.  19b: the
    # launcher in cluster mode on the card, whole; then its last checkpoint
    # removed, as if it had died after step ``every``'s, and the same
    # command again: it resumes from there
    port = free_port()
    steps, every = MESH_DEMO_STEPS
    whole = os.path.join(work, "launcher")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--demo",
            "--steps", str(steps), "--ckpt-every", str(every), "--num-hosts",
            "1", "--host-id", "0", "--ckpt-dir", whole]
    t0 = time.perf_counter()
    ranks = start_processes([_mesh_cmd(r, n, port, work, shape,
                                       TRAIN_LAYERS, seed, True)
                             for r in range(n)])
    launchers, marker = [], os.path.join(work, "timed")
    try:
        while (not os.path.exists(marker)
               and all(p.poll() is None for p in ranks)):
            time.sleep(0.2)
        if os.path.exists(marker):
            t_19b = time.perf_counter()
            launchers = start_processes([base + [
                "--coordinator", f"127.0.0.1:{free_port()}"]])
            (out_whole,) = wait_processes(launchers, "19b")
            shutil.rmtree(os.path.join(whole, f"step-{steps:08d}"))
            launchers = start_processes([base + [
                "--coordinator", f"127.0.0.1:{free_port()}"]])
        wait_processes(ranks, "19a")
        wall_19a = time.perf_counter() - t0
        if not launchers:
            raise SystemExit("19a: the ranks ended before their steps were "
                             "timed")
        (out_resumed,) = wait_processes(launchers, "19b restart")
        wall_19b = time.perf_counter() - t_19b
    finally:
        for p in ranks + launchers:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(os.path.join(work, "rank0.json")) as f:
        a = json.load(f)
    print(f"19a: Qwen2-7B at {TRAIN_LAYERS} layers on the {a['mesh']} mesh "
          f"({a['mesh_axes']}) of {n} card(s) ({a['card']}): loss "
          f"{a['loss']} against 13a's {a['ref_loss']}; relative differences "
          f"{a['errors']} (tolerances {MESH_TOL}); one step's launches on "
          f"rank 0 {a['step_launches']}, no plain attention; data launches "
          f"{a['data_launches']}; losses {a['losses']}; step {a['step_ms']} "
          f"ms (median of {MESH_TIMED}; {a['step_ms_all']}) against 13a's "
          f"{train_rec['step_ms']} ms, {a['tokens_per_s']} tokens/s against "
          f"{train_rec['tokens_per_s']}, peak {a['peak_bytes']} bytes "
          f"allocated on rank 0 against 13a's {train_rec['peak_bytes']}; "
          f"the loss's all-reduces over more than one rank: "
          f"{a['cross_card_all_reduces']} (one step: "
          f"{a['step_cross_card_all_reduces']}); {wall_19a} s with the "
          f"ranks' start")
    print(f"19c: the parameters of 19a's sharded state ({a['restore_tensors']}"
          f" tensors, {a['ckpt_bytes']} bytes on disk, written by rank 0 in "
          f"{a['save_s']} s) restored into the unsharded model on the card "
          f"in {a['restore_s']} s (beside 19b): step "
          f"{a['restored_step']}, bit-identical {a['restore_bit_identical']}")
    l_whole, l_resumed = launcher_loss(out_whole), launcher_loss(out_resumed)
    rel_19b = abs(l_resumed - l_whole) / abs(l_whole)
    print(f"19b: python -m repro_torch.launch.train --demo --steps {steps} "
          f"--ckpt-every {every} --coordinator 127.0.0.1:<port> --num-hosts "
          f"1 --host-id 0 on the card: final loss {l_whole}; with its "
          f"step-{steps} checkpoint removed, the same command resumed from "
          f"step {every} and ended at {l_resumed}: relative difference "
          f"{rel_19b} (tolerance {MESH_RESTART_TOL}), bit-identical "
          f"{l_resumed == l_whole}; {wall_19b} s for the two runs")
    if (f"resumed from step {every}" not in out_resumed
            or rel_19b > MESH_RESTART_TOL or "mesh of cuda" not in out_whole):
        raise SystemExit(f"19b: the restarted launcher did not resume from "
                         f"step {every} or missed the whole run's loss:\n"
                         f"{out_resumed[-2000:]}")
    full = None
    if n >= 4:
        port = free_port()
        wait_processes(start_processes([
            _mesh_cmd(r, n, port, work, (n // 2, 2), MESH_FULL_LAYERS, seed,
                      False) for r in range(n)]), "19a at full depth")
        with open(os.path.join(work, "rank0.json")) as f:
            full = json.load(f)
        print(f"19a at the published {MESH_FULL_LAYERS} layers on the "
              f"{full['mesh']} mesh: losses {full['losses']}, step "
              f"{full['step_ms']} ms, {full['tokens_per_s']} tokens/s, peak "
              f"{full['peak_bytes']} bytes on rank 0, launches "
              f"{full['step_launches']}, the loss's cross-card all-reduces "
              f"{full['cross_card_all_reduces']}")

    for r in records:
        if r["name"] in ("flash_attention_fwd", "flash_attention_bwd"):
            r["mesh_launches"] = a["step_launches"][r["name"]]
        if r["name"] in a["data_launches"] and r["name"] in (
                "cam_match", "bit_transpose", "bulk_program"):
            r["mesh_data_launches"] = a["data_launches"][r["name"]]
    out = {"cards": n, "mesh_19a": a, "full_depth": full,
           "launcher": {"whole": l_whole, "resumed": l_resumed,
                        "rel": rel_19b, "s": wall_19b},
           "step_ms_13a": train_rec["step_ms"],
           "peak_13a": train_rec["peak_bytes"],
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"mesh_path": out}))
    print(f"phase 19 took {out['phase_s']} s")
    return out


# ---------------------------------------------------------------- phase 20
SERVE_BIG_ARCH = "command-r-plus-104b"
SERVE_BIG_LAYERS = 8        # 20b: 8 of the 64 layers, 31.5 GB of bf16 weights
SERVE_BIG_FULL = 64         # 20b on 4 cards or more: the published depth
#: 20: the allocator's bytes of a tensor against its dry-run bytes: each
#: request rounded up to 512 bytes, and a large block left whole when less
#: than 1 MiB (the caching allocator's small-block size) would remain
SERVE_ALLOC_SLACK = (1 << 20) + 512


def serve_record(torch, prompts, lm: dict) -> dict:
    """What phase 20 holds a sharded serving run against, on the host:
    the prompts, the greedy ids, the prefill's last-position logits
    (fp32, the real vocabulary), the prefill and decode times and the peak
    since the run's last reset."""
    return {"prompts": prompts.cpu(), "gen": lm["gen"].cpu(),
            "logits": lm["kernel_logits"].cpu(),
            "prefill_ms": lm["prefill_ms"], "decode_ms": lm["decode_ms"],
            "peak": torch.cuda.max_memory_allocated()}


def serve_prompts(torch, cfg, seed: int):
    """Phase 7's prompts for ``cfg``: LM_BATCH x LM_PROMPT ids from
    ``seed``."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)))


def serve_reference(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phase 20's reference without phases 2-19 (``--mesh-only``): phase
    7's cell unsharded on the card through ``lm_serving``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = tmodel.init_params(cfg, seed=seed, device=dev)
    prompts = serve_prompts(torch, cfg, seed).to(dev)
    lm = lm_serving(torch, tstep, attention, params, cfg,
                    {"tokens": prompts}, LM_STEPS, zero_counts, counted, "lm",
                    ())
    out = serve_record(torch, prompts, lm)
    del params, lm, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def big_serving(torch, dev, seed: int, zero_counts, counted, kernel) -> dict:
    """Phase 20b's unsharded side (see the module docstring); ``kernel``
    (the records' maker) is None under ``--mesh-only``, which times no
    row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    from torch_checks import COMMAND_R_FLASH_SHAPES, attn_tol
    cfg = dataclasses.replace(get_config(SERVE_BIG_ARCH),
                              num_layers=SERVE_BIG_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"command-r+ lm: {cfg.name} at {cfg.num_layers} of its 64 layers "
          f"(d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
          f"x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}): "
          f"{torch.cuda.memory_allocated()} bytes on the card, made in "
          f"{init_s} s")
    prompts = serve_prompts(torch, cfg, seed).to(dev)
    lm = lm_serving(torch, tstep, attention, params, cfg, {"tokens": prompts},
                    LM_STEPS, zero_counts, counted, "command-r+ lm",
                    (0, cfg.num_layers - 1))
    out = serve_record(torch, prompts, lm)
    out["launches"] = lm["launches"]["flash_attention_fwd"]
    layer_err = check_layers(attention, lm["captured"],
                             tmodel.layer_windows(cfg), "command-r+ lm check")
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, lm["prefill"], params,
        {"tokens": prompts}, lm["kernel_logits"], "command-r+ lm check")
    fq, fk, fv, _, fo = lm["captured"][0]
    if kernel is not None:
        # row 5c: the kernel at the prefill's shape and at one rank's
        # quarter of the heads on (1, 4), beside its plain version and SDPA
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for label, (h, kv) in COMMAND_R_FLASH_SHAPES.items():
            q, k, v = fq[:, :, :h], fk[:, :, :kv], fv[:, :, :kv]
            q, k, v = (t.contiguous() for t in (q, k, v))
            sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            B_, S_, _, hd_ = q.shape
            want = fo[:, :, :h]
            kernel(f"flash_attention_fwd {label}", "attention.cu",
                   "src/repro/kernels/attention.py:67",
                   f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal, bf16",
                   lambda: attention.flash_attention_fwd(q, k, v,
                                                         causal=True),
                   lambda: attention.flash_attention_fwd_plain(
                       q, k, v, causal=True),
                   2 * (2 * q.numel() + k.numel() + v.numel()),
                   2 * S_ * (S_ + 1) * hd_ * B_ * h, 10, count=out["launches"],
                   tol=attn_tol(want, torch.bfloat16), peak_ops=PEAK_BF16,
                   library=lambda: sdpa(sq, sk, sv, is_causal=True,
                                        enable_gqa=True))
            del q, k, v, sq, sk, sv, want
    print(json.dumps({"command_r_lm_path": {
        "arch": cfg.name, "layers": cfg.num_layers, "init_s": init_s,
        "prefill_ms": lm["prefill_ms"], "decode_ms_per_step": lm["decode_ms"],
        "launches": lm["launches"], "layer_checks": layer_err,
        "logit_checks": logit_checks, "peak_bytes": out["peak"],
        "card": CARD["smi"]}}))
    del params, lm, prompts, fq, fk, fv, fo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_cmd(rank: int, world: int, port: int, work: str, jobs: list,
               seed: int) -> list:
    return [sys.executable, os.path.abspath(__file__), "--serve-rank",
            str(rank), "--serve-world", str(world), "--serve-port", str(port),
            "--serve-work", work, "--serve-jobs", ",".join(jobs), "--seed",
            str(seed)]


def held_logits(torch, got, want, label: str) -> dict:
    """Last-position logits (B, V) of a sharded run against an unsharded
    one's: within phase 7's bf16 LOGIT_TOL of the reference's largest
    magnitude, argmax equal on every row whose top-2 margin exceeds that
    tolerance; bit-identity reported."""
    err = max_abs_err(got, want)
    tol = LOGIT_TOL["bfloat16"] * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    agree = got.argmax(-1) == want.argmax(-1)
    if not (err <= tol and bool(agree[decided].all())
            and bool(torch.isfinite(got).all())):
        raise SystemExit(f"{label}: logits differ from the unsharded run's: "
                         f"{err} > {tol} or argmax {agree.tolist()} on "
                         f"decided rows {decided.tolist()}")
    return {"err": err, "tol": tol, "decided": decided.tolist(),
            "argmax_agree": int(agree.sum()),
            "bit_identical": bits_equal(torch, got, want)}


def serve_job(torch, dev, job: str, seed: int, refs: dict) -> dict:
    """One phase-20 job on this rank: ``kind:DxM[:layers]`` (a: phase 7's
    cell; b: Command-R+ at ``layers``) on the (D, M) device mesh."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh, make_device_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    kind, shape_s, *rest = job.split(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    cfg = get_config(LM_ARCH if kind == "a" else SERVE_BIG_ARCH)
    if kind == "b":
        cfg = dataclasses.replace(cfg, num_layers=int(rest[0]))
    ref = refs.get(kind) if kind == "a" or (
        cfg.num_layers == SERVE_BIG_LAYERS) else None
    label = f"20{kind} {cfg.name} at {cfg.num_layers} layers on {shape_s}"
    mesh = make_device_mesh(shape, ("data", "model"), dev)
    names = mesh.axis_names
    prompts = (ref["prompts"] if ref else serve_prompts(torch, cfg, seed)
               ).to(dev)
    B, S = prompts.shape
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, mesh=mesh)
    torch.cuda.synchronize()
    out = {"job": job, "mesh": mesh.name, "card": torch.cuda.get_device_name(
        dev), "init_s": time.perf_counter() - t0}
    param_bytes = torch.cuda.memory_allocated(dev) - base
    cache = tmodel.init_cache(cfg, B, S + LM_STEPS, mesh=mesh)
    torch.cuda.synchronize()
    cache_bytes = torch.cuda.memory_allocated(dev) - base - param_bytes
    want = dryrun.serve_arg_bytes(cfg, AbstractMesh(shape, names), B,
                                  S + LM_STEPS)
    n_params = sum(1 for _ in params.parameters())
    out["bytes"] = {"params": param_bytes, "cache": cache_bytes,
                    "dryrun": want, "params_slack": n_params *
                    SERVE_ALLOC_SLACK, "cache_slack": 2 * SERVE_ALLOC_SLACK}
    if not (0 <= param_bytes - want["params"] <= n_params * SERVE_ALLOC_SLACK
            and 0 <= cache_bytes - want["cache"] <= 2 * SERVE_ALLOC_SLACK):
        raise SystemExit(f"{label}: the allocator holds {param_bytes} bytes "
                         f"of parameters and {cache_bytes} of cache, the dry "
                         f"run says {want} (slack {SERVE_ALLOC_SLACK} a "
                         f"tensor)")
    del cache

    # the counted run: greedy_generate through the entry point
    fwd = attention.flash_attention_fwd
    fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_attention(attention):
        gen = tstep.greedy_generate(params, cfg, prompts, steps=LM_STEPS)
        torch.cuda.synchronize()
    out["gen_s"] = time.perf_counter() - t0
    out["launches"] = fwd.launches
    if fwd.launches != cfg.num_layers or gen.shape != (B, LM_STEPS):
        raise SystemExit(f"{label}: {fwd.launches} flash launches in one "
                         f"greedy run (want {cfg.num_layers}, one a layer), "
                         f"ids {tuple(gen.shape)}")

    # prefill and decode timed apart
    prefill = tstep.make_prefill_step(cfg, max_len=S + LM_STEPS)
    decode = tstep.make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    last = logits.full_tensor()[:, -1, :cfg.vocab_size].float()
    toks = [last.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(LM_STEPS - 1):
        logits, cache = decode(params, {"tokens": toks[-1][:, None],
                                        "cache": cache})
        toks.append(tstep.next_ids(logits, cfg))
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / (LM_STEPS - 1)
    out["tokens_equal_to_greedy"] = int((torch.stack(toks, 1) == gen).sum())
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["allocated_bytes"] = torch.cuda.memory_allocated(dev)
    # where the time goes: the card's busy time and idle share over one
    # prefill and one more decode step (the cache has room for it), and
    # the host's top operators by their own time over one prefill
    step = {"tokens": toks[-1][:, None], "cache": cache}
    out["profile"] = {
        "prefill": profile(f"{label}, one prefill", *device_profile(
            torch, lambda: prefill(params, {"tokens": prompts}))),
        "decode": profile(f"{label}, one decode step", *device_profile(
            torch, lambda: decode(params, step)))}
    out["host_top"] = host_top(torch, lambda: prefill(params,
                                                      {"tokens": prompts}))
    if ref is not None:
        want_logits = ref["logits"].to(dev)
        out["logits"] = held_logits(torch, last, want_logits, label)
        decided = torch.tensor(out["logits"]["decided"], device=dev)
        first = gen[:, 0] == ref["gen"].to(dev)[:, 0]
        out["first_token_agree"] = int(first.sum())
        out["tokens_equal_to_reference"] = int(
            (gen == ref["gen"].to(dev)).sum())
        if not bool(first[decided].all()):
            raise SystemExit(f"{label}: the first generated token differs "
                             f"from the unsharded run's on a decided row: "
                             f"{first.tolist()}, decided {decided.tolist()}")
    del params, cache, logits, gen, toks, last, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_top(torch, fn, n: int = 6) -> list:
    """The host's top ``n`` operators by their own time (ms) over one run
    of ``fn``, from ``torch.profiler``'s CPU activity."""
    from torch.profiler import ProfilerActivity, profile as host_profile
    torch.cuda.synchronize()
    with host_profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key[:60], e.self_cpu_time_total / 1e3, e.count]
            for e in top[:n]]


def serve_rank(args) -> int:
    """One rank of phase 20, 21, 22, 23 or 24 (``--serve-rank``): joins
    the NCCL group of ``--serve-world`` ranks, one a card, sets the
    ``serve_tp`` rules and runs each of ``--serve-jobs`` in turn
    (:func:`serve_job`, :func:`family_job` for phase 21's, 23's and 24's
    kinds, :func:`sp_job` for phase 22's); every rank writes its records
    to ``--serve-work``/serve-rank<r>.json after each job."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from repro_torch.launch.dryrun import serve_tp_rules
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.parallel.sharding import set_rules
    rank, world = args.serve_rank, args.serve_world
    dev = init_distributed(f"127.0.0.1:{args.serve_port}", world, rank,
                           device="cuda", local_rank=rank)
    refs = torch.load(os.path.join(args.serve_work, "serve_refs.pt"))
    try:
        set_rules(serve_tp_rules())
        out = []
        for job in args.serve_jobs.split(","):      # written job by job
            kind = job.split(":")[0]
            out.append((family_job if kind in FAMILY_JOBS else sp_job
                        if kind in SP_JOBS else serve_job)(
                torch, dev, job, args.seed, refs))
            with open(os.path.join(args.serve_work,
                                   f"serve-rank{rank}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_serving(torch, seed: int, lm7: dict, big: dict, records: list,
                 t_phase: float) -> dict:
    """Phase 20's ranks (see the module docstring), after ``big_serving``;
    ``t_phase``: when the phase began."""
    n = torch.cuda.device_count()
    jobs = [f"a:{n}x1", f"b:1x{n}:{SERVE_BIG_LAYERS}"]
    if n >= 4:
        jobs += [f"b:1x{n}:{SERVE_BIG_FULL}", f"a:{n // 2}x2"]
    print(f"serve mesh: {n} card(s), one NCCL rank a card, serve_tp rules; "
          f"jobs {jobs}")
    work = tempfile.mkdtemp(prefix="chip_smoke_serve-")
    atexit.register(shutil.rmtree, work, True)
    torch.save({"a": lm7, "b": big}, os.path.join(work, "serve_refs.pt"))
    t0 = time.perf_counter()
    port = free_port()
    wait_processes(start_processes([_serve_cmd(r, n, port, work, jobs, seed)
                                    for r in range(n)]), "20")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"serve-rank{r}.json")) as f:
            ranks.append(json.load(f))
    for i, job in enumerate(jobs):
        a = ranks[0][i]
        ref = lm7 if job.startswith("a") else big
        held = a.get("logits")
        print(f"20{job[0]} {job} on the {a['mesh']} mesh ({a['card']}): "
              f"{a['launches']} flash launches in one greedy run on rank 0 "
              f"(each rank: {[rk[i]['launches'] for rk in ranks]}), no plain "
              f"attention; prefill {a['prefill_ms']} ms, decode "
              f"{a['decode_ms']} ms/step"
              + (f" against the unsharded run's {ref['prefill_ms']} ms and "
                 f"{ref['decode_ms']} ms/step; logits {held} (tolerance "
                 f"{LOGIT_TOL['bfloat16']} of max), first token equal on "
                 f"{a['first_token_agree']}/{LM_BATCH} rows, "
                 f"{a['tokens_equal_to_reference']}/{LM_BATCH * LM_STEPS} "
                 f"greedy ids equal; peak {a['peak_bytes']} bytes on rank 0 "
                 f"against {ref['peak']}" if held else
                 f"; peak {a['peak_bytes']} bytes on rank 0")
              + f"; per rank peak {[rk[i]['peak_bytes'] for rk in ranks]}, "
              f"allocated {[rk[i]['allocated_bytes'] for rk in ranks]}; "
              f"bytes against the dry run {a['bytes']}; init {a['init_s']} s"
              f"; rank 0's card busy / idle share: prefill "
              f"{a['profile']['prefill']['busy_ms']} ms / "
              f"{a['profile']['prefill']['idle_share']}, decode step "
              f"{a['profile']['decode']['busy_ms']} ms / "
              f"{a['profile']['decode']['idle_share']}; the host's top "
              f"operators in one prefill (ms, calls) {a['host_top']} "
              f"[{CARD['smi']}]")
    first_b = next(i for i, j in enumerate(jobs) if j.startswith("b"))
    for r in records:
        if r["name"] == "flash_attention_fwd":
            r["tp_serve_launches"] = ranks[0][first_b]["launches"]
    out = {"cards": n, "jobs": jobs, "ranks": ranks, "wall_s": wall,
           "lm7": {k: lm7[k] for k in ("prefill_ms", "decode_ms", "peak")},
           "big": {k: big[k] for k in ("prefill_ms", "decode_ms", "peak")},
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"serve_mesh_path": out}))
    print(f"phase 20 took {out['phase_s']} s ({wall} s of ranks)")
    return out


# ---------------------------------------------------------------- phase 21
#: 21c on four cards or more: Qwen2-MoE-A2.7B's published depth
MOE_FULL_LAYERS = 24
#: 21c: layer 0's expert-weight gradients held against 17c's over experts
#: 0 .. FAMILY_EXPERTS - 1 (the whole three tensors are 2.1 GB of fp32)
FAMILY_EXPERTS = 4
#: the gradients phase 21's training jobs hold against phase 17's
FAMILY_GRADS = {"mt": ("layers.0.wq", "layers.0.wk", "layers.0.wv",
                       "layers.0.moe_w_in", "layers.0.moe_w_gate",
                       "layers.0.moe_w_out"),
                "wt": ("enc_layers.0.enc_wq", "layers.0.wq",
                       "layers.0.xattn_wq"),
                "st": ("layers.0.ssm_in_proj", "layers.0.ssm_conv_w",
                       "layers.0.ssm_A_log", "layers.0.ssm_out_proj"),
                "ht": ("layers.0.wq", "layers.0.wk", "layers.0.wv",
                       "layers.0.ssm_in_proj", "layers.0.ssm_conv_w",
                       "layers.0.ssm_out_proj")}
#: the model of each job kind of phases 21 and 23
FAMILY_ARCH = {"ms": MOE_ARCH, "mt": MOE_ARCH, "ws": ENCDEC_ARCH,
               "wt": ENCDEC_ARCH, "ss": SSM_ARCH, "st": SSM_ARCH,
               "hs": HYBRID_ARCH, "ht": HYBRID_ARCH}
#: phase 23's kinds: on one card bit for bit the unsharded runs' (logits,
#: ids, caches, the loss and gradients)
EXACT_ON_ONE = ("ss", "hs", "st", "ht")
#: phase 23 across cards: layer 0's conv and SSM caches within this share
#: of their largest magnitude (read up to 0.0046 of it on four cards, one
#: bf16 step; deeper layers carry the route noise on, and keep
#: LOGIT_TOL's), and the fp32 gradients within this L2 share (read
#: 1.8e-5 to 4.3e-5): far below what a wrong split or reduction moves
SSM_LAYER0_CACHE_TOL = 1 / 64
SSM_FP32_GRAD_TOL = 1e-3
#: the heads (query, KV) of one (1, 4) rank's shard: the per-rank rows of
#: 16a/17c (Qwen2-MoE, 16 of 16) and 17a/17b (Whisper's encoder, 12 of 12)
RANK_HEADS = {"moe": (4, 4), "whisper": (3, 3)}


def expert_cut(name: str, g):
    """An expert weight's gradient cut to its first FAMILY_EXPERTS
    experts; another gradient whole."""
    return g[:FAMILY_EXPERTS] if ".moe_w_" in name else g


def dispatched(tmoe, run) -> list:
    """Run ``run()`` with each ``dispatch`` call's experts (T, k) kept on
    the host and its dropped assignments counted, one an MoE layer in
    order (on a mesh every rank sees the whole batch's routing)."""
    calls, saved = [], tmoe.dispatch

    def recording(experts, num_experts, capacity):
        pos, keep = saved(experts, num_experts, capacity)
        calls.append({"experts": experts.cpu(),
                      "dropped": int((~keep).sum())})
        return pos, keep
    tmoe.dispatch = recording
    try:
        run()
    finally:
        tmoe.dispatch = saved
    return calls


@contextlib.contextmanager
def compute_dtype(tmodel, dtype):
    """The model's compute dtype set to ``dtype`` inside the block."""
    saved = tmodel.COMPUTE_DTYPE
    tmodel.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        tmodel.COMPUTE_DTYPE = saved


def drops_by_factor(torch, tmoe, tmodel, params, cfg, batch) -> dict:
    """Each MoE layer's routing and drops in one fp32 forward of ``batch``
    (no autograd; a bf16 rounding flips routings between batch splits,
    fp32 next to never) at capacity factors ``cfg``'s and
    MOE_TIGHT_FACTOR, the layers' spec swapped for the run: factor ->
    :func:`dispatched`."""
    out = {}
    for factor in (cfg.moe.capacity_factor, MOE_TIGHT_FACTOR):
        spec = dataclasses.replace(cfg.moe, capacity_factor=factor)
        saved = [layer.cfg for layer in params.layers]
        for layer in params.layers:
            layer.cfg = dataclasses.replace(layer.cfg, moe=spec)
        try:
            with torch.no_grad(), compute_dtype(tmodel, torch.float32):
                out[factor] = dispatched(
                    tmoe, lambda: tmodel.lm_loss(params, cfg, batch))
        finally:
            for layer, c in zip(params.layers, saved):
                layer.cfg = c
    return out


def cache_layers(cfg) -> list:
    """The layers whose SSM caches phase 23 holds: the first, the middle
    and the last."""
    return sorted({0, cfg.num_layers // 2, cfg.num_layers - 1})


def ssm_caches(tmodel, cache: dict, cfg) -> dict:
    """The ``conv`` and ``ssm`` caches of :func:`cache_layers`, whole (a
    DTensor's gathered: every rank calls this), on the host."""
    return {f"{nm} {i}": tmodel.full_tensor(cache[nm][i]).cpu()
            for nm in ("conv", "ssm") for i in cache_layers(cfg)}


def held_caches(torch, got: dict, want: dict, label: str, exact: bool
                ) -> dict:
    """A sharded run's SSM caches (:func:`ssm_caches`) against the
    unsharded run's: each within LOGIT_TOL's bf16 share of its largest
    magnitude (layer 0's within SSM_LAYER0_CACHE_TOL's), and with
    ``exact`` (one card) bit for bit."""
    out = {}
    for k, w in want.items():
        err = max_abs_err(got[k].float(), w.float())
        frac = (SSM_LAYER0_CACHE_TOL if k.endswith(" 0")
                else LOGIT_TOL["bfloat16"])
        out[k] = {"err": err, "tol": frac * float(w.float().abs().max()),
                  "bit_identical": bits_equal(torch, got[k], w)}
    bad = {k: v for k, v in out.items() if not v["err"] <= v["tol"]
           or exact and not v["bit_identical"]}
    if bad:
        raise SystemExit(f"{label}: the SSM caches differ from the "
                         f"unsharded run's{' bits' if exact else ''}: {bad}")
    return out


def serve_family_ref(torch, cfg, run: dict, experts=None) -> dict:
    """What phase 21a/b holds a sharded serving run against, on the host,
    from a ``family_serving`` run: the prompts (and frames), the greedy
    ids, the timed prefill's last-position logits, the times and peak,
    and (an MoE) each layer's routing in a kernel-route prefill."""
    lm, rec = run["lm"], run["record"]
    out = {"prompts": run["prompts"].cpu(), "gen": lm["gen"].cpu(),
           "logits": lm["kernel_logits"].cpu(), "steps": rec["steps"],
           "prefill_ms": lm["prefill_ms"], "decode_ms": lm["decode_ms"],
           "peak": rec["peak_bytes"], "experts": experts}
    if cfg.enc_dec:
        out["frames"] = run["inputs"]["frames"].cpu()
    return out


def loss_and_grads(torch, tmodel, tmoe, params, cfg, batch: dict, names,
                   dtype, keep_local: bool = False) -> dict:
    """One loss and backward on ``batch`` (the kernel route) with the
    compute dtype ``dtype``, on the host: the loss, the gradients
    ``names`` (:func:`expert_cut`; whole: a DTensor's gathered) and each
    MoE layer's routing in the forward; with ``keep_local`` also every
    gradient's local shard (on the card), for a bit-identity check."""
    out = {}

    def run():
        params.requires_grad_(True)
        loss, _ = tmodel.lm_loss(params, cfg, batch)
        loss.backward()
        out["loss"] = float(tmodel.full_tensor(loss.detach()))
    with compute_dtype(tmodel, dtype):
        calls = dispatched(tmoe, run)
    out["experts"] = [c["experts"] for c in calls[:cfg.num_layers]]
    out["grads"] = {n: expert_cut(n, tmodel.full_tensor(
        params.get_parameter(n).grad)).float().cpu() for n in names}
    if keep_local:
        out["local"] = {n: getattr(p.grad, "to_local", lambda: p.grad)()
                        .clone() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return out


def train_family_ref(torch, tmodel, tmoe, params, cfg, batch: dict, names
                     ) -> dict:
    """What phase 21c/d holds a sharded training run against, on the host:
    ``batch`` and :func:`loss_and_grads` in bf16 and in fp32 (an MoE's
    drops too, :func:`drops_by_factor`)."""
    out = {"batch": {k: v.cpu() for k, v in batch.items()},
           "layers": cfg.num_layers}
    for dt in (torch.bfloat16, torch.float32):
        out[str(dt).split(".")[-1]] = loss_and_grads(
            torch, tmodel, tmoe, params, cfg, batch, names, dt)
    if cfg.moe is not None:
        out["routing"] = drops_by_factor(torch, tmoe, tmodel, params, cfg,
                                         batch)
    return out


def flash_fwd_row(torch, attention, kernel, label: str, captured,
                  causal: bool, heads: tuple, count: int) -> None:
    """The forward kernel's record at a captured layer's (q, k, v, out)
    cut to ``heads`` (query, KV: one rank's shard), beside its plain
    version, SDPA and its bound."""
    from torch_checks import attn_tol
    h, kv = heads
    q, k, v, o = (t[:, :, :n].contiguous() for t, n in zip(
        captured, (h, kv, kv, h)))
    B_, Sq, _, hd_ = q.shape
    Skv = k.shape[1]
    sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = {"enable_gqa": True} if h != kv else {}
    kernel(f"flash_attention_fwd {label}", "attention.cu",
           "src/repro/kernels/attention.py:67",
           f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
           f"{'causal' if causal else 'bidirectional'}, bf16",
           lambda: attention.flash_attention_fwd(q, k, v, causal=causal),
           lambda: attention.flash_attention_fwd_plain(q, k, v,
                                                       causal=causal),
           2 * (2 * q.numel() + k.numel() + v.numel()),
           (2 * Sq * (Sq + 1) if causal else 4 * Sq * Skv) * hd_ * B_ * h,
           10, count=count, tol=attn_tol(o, torch.bfloat16),
           peak_ops=PEAK_BF16,
           library=lambda: sdpa(sq, sk, sv, is_causal=causal, **gqa))


def flash_bwd_row(torch, attention, kernel, records: list, label: str,
                  c: dict, heads, count: int, batch: int | None = None
                  ) -> None:
    """The backward kernel's record at a flash module's first training
    call (``c``: its q, k, v, mask and the out's gradient, brought to unit
    RMS: exact), cut to ``heads`` (query, KV) unless None and to the first
    ``batch`` rows unless None, under the call's window, beside its plain
    version, SDPA's backward (under the window's boolean mask) and its
    bound (allowed pairs x 4 hd flops a head, 2.5 x that)."""
    from torch_checks import bwd_tol, unit_rms
    cq, ck, cv = c["qkv"]
    dout = c["dout"]
    if heads is not None:
        h, kv = heads
        cq, ck, cv, dout = (t[:, :, :n].contiguous() for t, n in zip(
            (cq, ck, cv, dout), (h, kv, kv, h)))
    if batch is not None:
        cq, ck, cv, dout = (t[:batch].contiguous()
                            for t in (cq, ck, cv, dout))
    causal, window = c["mask"]["causal"], c["mask"].get("window")
    udout = unit_rms(dout)
    out, lse = attention.flash_attention_fwd(cq, ck, cv, causal=causal,
                                             window=window, return_lse=True)
    B_, Sq, H_, hd_ = cq.shape
    Skv = ck.shape[1]
    want = attention.flash_attention_bwd_plain(cq, ck, cv, out, lse, udout,
                                               causal=causal, window=window)
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (cq, ck, cv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = {"enable_gqa": True} if H_ != ck.shape[2] else {}
    if window is None:
        so = sdpa(sq, sk, sv, is_causal=causal, **gqa)
        fwd_ops = (2 * Sq * (Sq + 1) if causal else 4 * Sq * Skv) * hd_ \
            * B_ * H_
    else:
        keep = attention.allowed(Sq, Skv, causal=causal, window=window,
                                 device=cq.device)
        so = sdpa(sq, sk, sv, attn_mask=keep, **gqa)
        fwd_ops = 4 * int(keep.sum()) * hd_ * B_ * H_
    sdo = udout.transpose(1, 2).contiguous()
    kernel(f"flash_attention_bwd {label}", "attention.cu",
           "src/repro/models/flash.py:262",
           f"q {tuple(cq.shape)}, k/v {tuple(ck.shape)}, "
           f"{'causal' if causal else 'bidirectional'}"
           f"{f', window {window}' if window else ''}, bf16",
           lambda: attention.flash_attention_bwd(cq, ck, cv, out, lse,
                                                 udout, causal=causal,
                                                 window=window),
           lambda: attention.flash_attention_bwd_plain(
               cq, ck, cv, out, lse, udout, causal=causal, window=window),
           2 * (4 * cq.numel() + 4 * ck.numel()) + 4 * lse.numel(),
           2.5 * fwd_ops, 10, count=count,
           tol=[bwd_tol(w, torch.bfloat16) for w in want],
           peak_ops=PEAK_BF16,
           library=lambda: torch.autograd.grad(so, (sq, sk, sv), sdo,
                                               retain_graph=True))
    records[-1]["train_launches"] = count


def family_references(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phase 21's references without phases 2-20 (``--mesh-only``): 16a's
    and 17a's serving runs (``family_serving``; 16a's routing from one
    more prefill), and 17b's and 17c's first batch's loss and gradients
    (17c's drops too) and TRAIN_TIMED timed steps after a first."""
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    refs = {}
    for kind, arch, label, kw in (
            ("ms", MOE_ARCH, "moe lm", {}),
            ("ws", ENCDEC_ARCH, "whisper lm", {
                "batch": ENCDEC_BATCH, "prompt": ENCDEC_PROMPT,
                "steps": ENCDEC_STEPS})):
        run = family_serving(torch, dev, seed, zero_counts, counted, arch,
                             lambda cfg: (), label, **kw)
        experts = None
        if kind == "ms":
            experts = [c["experts"] for c in dispatched(
                tmoe, lambda: run["lm"]["prefill"](run["params"],
                                                   run["inputs"]))]
        refs[kind] = serve_family_ref(torch, run["cfg"], run, experts)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    for kind, arch, layers, batch, seq in (
            ("mt", MOE_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH,
             FAMILY_TRAIN_SEQ),
            ("wt", ENCDEC_ARCH, None, ENCDEC_BATCH, ENCDEC_TRAIN_SEQ)):
        full = get_config(arch)
        cfg = dataclasses.replace(full, remat="full",
                                  num_layers=layers or full.num_layers)
        torch.cuda.reset_peak_memory_stats()
        params = tmodel.init_params(cfg, seed=seed, device=dev,
                                    dtype=torch.float32)
        b0 = family_batch(torch, dev, cfg, seed, 0, batch, seq)
        ref = train_family_ref(torch, tmodel, tmoe, params, cfg, b0,
                               FAMILY_GRADS[kind])
        ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
        opt = init_opt_state(params, ocfg)
        step = make_train_step(cfg, TrainConfig(ocfg))
        params, opt, m = step(params, opt, b0)
        times = []
        for _ in range(TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b0)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        ref.update(step_ms=statistics.median(times) * 1e3,
                   peak=torch.cuda.max_memory_allocated())
        print(f"family reference {kind}: {cfg.name} at {cfg.num_layers} "
              f"layers unsharded, loss {ref['bfloat16']['loss']} (fp32 "
              f"{ref['float32']['loss']}), step {ref['step_ms']}"
              f" ms (median of {TRAIN_TIMED}), peak {ref['peak']} bytes")
        refs[kind] = ref
        del params, opt, m, step, b0
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def ssm_references(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phases 23's and 24's references, unsharded on this card: 16b's and
    16c's serving cells (``family_serving``, :func:`ssm_serve_ref`; 16c's
    layer 1, a local one, captured as (q, k, v, window, out) on the host
    under ``hs_captured``, for rows 5hu), and 17d's and 17e's first
    batch's loss and gradients (``train_family_ref``) and TRAIN_TIMED
    timed steps after a first, at the published depths
    (:func:`ssm_train_layers`) with 4 cards or more, else at
    SSM_ONE_CARD_LAYERS."""
    cut = None if torch.cuda.device_count() >= 4 else SSM_ONE_CARD_LAYERS
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    refs = {}
    for kind, arch, label in (("ss", SSM_ARCH, "23a ssm lm reference"),
                              ("hs", HYBRID_ARCH,
                               "23b hybrid lm reference")):
        run = family_serving(torch, dev, seed, zero_counts, counted, arch,
                             lambda cfg: (1,) if cfg.block == "hybrid"
                             else (), label, layers=cut)
        refs[kind] = ssm_serve_ref(torch, tmodel, run)
        if kind == "hs":            # layer 1 (local), for rows 5hu
            refs["hs_captured"] = tuple(
                t.cpu() if hasattr(t, "cpu") else t
                for t in run["lm"]["captured"][1])
        del run
        gc.collect()
        torch.cuda.empty_cache()
    for kind, arch in (("st", SSM_ARCH), ("ht", HYBRID_ARCH)):
        full = get_config(arch)
        cfg = dataclasses.replace(full, remat="full",
                                  num_layers=cut or ssm_train_layers(full))
        torch.cuda.reset_peak_memory_stats()
        params = tmodel.init_params(cfg, seed=seed, device=dev,
                                    dtype=torch.float32)
        b0 = family_batch(torch, dev, cfg, seed, 0, SSM_TRAIN_BATCH,
                          FAMILY_TRAIN_SEQ)
        ref = train_family_ref(torch, tmodel, tmoe, params, cfg, b0,
                               FAMILY_GRADS[kind])
        ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
        opt = init_opt_state(params, ocfg)
        step = make_train_step(cfg, TrainConfig(ocfg))
        params, opt, m = step(params, opt, b0)
        times = []
        for _ in range(TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b0)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        ref.update(step_ms=statistics.median(times) * 1e3,
                   peak=torch.cuda.max_memory_allocated())
        print(f"ssm reference {kind}: {cfg.name} at {cfg.num_layers} layers "
              f"unsharded, loss {ref['bfloat16']['loss']} (fp32 "
              f"{ref['float32']['loss']}), step {ref['step_ms']} ms (median "
              f"of {TRAIN_TIMED}), peak {ref['peak']} bytes")
        refs[kind] = ref
        del params, opt, m, step, b0
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def train_state_bytes(cfg, mesh) -> int:
    """Per-card bytes of fp32 parameters, gradients and both AdamW moments
    (4 x the parameters' ``shard_bytes``) under the calling thread's rules
    on the abstract ``mesh``."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.sharding import logical_spec, shard_bytes
    logical = tmodel.param_logical(cfg)
    with set_mesh(mesh):
        return 4 * sum(shard_bytes(t, logical_spec(t.shape, logical[k]),
                                   mesh)
                       for k, t in tmodel.abstract_params(cfg).items())


def flips_of(torch, got: list, want: list) -> list:
    """Per MoE layer, the (token, slot) routings that differ."""
    return [int((a != b).sum()) for a, b in zip(got, want)]


def family_serve_job(torch, dev, kind: str, shape: tuple, mesh, seed: int,
                     ref: dict, label: str, layers: int = 0,
                     opts: dict | None = None) -> dict:
    """Phase 21a (``ms``, Qwen2-MoE-A2.7B), 21b (``ws``, Whisper-small),
    23a (``ss``, Mamba2-2.7B) or 23b (``hs``, Hymba-1.5B), or 24a (``hs``
    with ``opts``, the sequence options' config fields) on this rank
    under ``serve_tp``: the allocator's bytes against the dry run's, the
    counted greedy run, the routing's flips (MoE), prefill and decode
    timed and profiled, the logits and ids (and the SSM's conv and state
    caches after the prefill, :func:`held_caches`) held against 16a's,
    17a's, 16b's or 16c's (bit for bit on one card); for phases 23 and 24
    also the flash kernel's time in one prefill (one launch an attention
    layer) and that prefill's collectives."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.serve import step as tstep
    cfg = dataclasses.replace(get_config(FAMILY_ARCH[kind]), **(opts or {}))
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    prompts = ref["prompts"].to(dev)
    extra = {"frames": ref["frames"].to(dev)} if cfg.enc_dec else {}
    B, S = prompts.shape
    steps = ref["steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, mesh=mesh)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    param_bytes = torch.cuda.memory_allocated(dev) - base
    cache = tmodel.init_cache(cfg, B, S + steps, mesh=mesh)
    torch.cuda.synchronize()
    cache_bytes = torch.cuda.memory_allocated(dev) - base - param_bytes
    want = dryrun.serve_arg_bytes(cfg, AbstractMesh(shape, mesh.axis_names),
                                  B, S + steps)
    n_params = sum(1 for _ in params.parameters())
    n_caches = sum(1 for k in cache if k != "pos")
    out["bytes"] = {"params": param_bytes, "cache": cache_bytes,
                    "dryrun": want, "slack_a_tensor": SERVE_ALLOC_SLACK}
    if not (0 <= param_bytes - want["params"] <= n_params * SERVE_ALLOC_SLACK
            and 0 <= cache_bytes - want["cache"]
            <= n_caches * SERVE_ALLOC_SLACK):
        raise SystemExit(f"{label}: the allocator holds {param_bytes} bytes "
                         f"of parameters and {cache_bytes} of cache, the dry "
                         f"run says {want} (slack {SERVE_ALLOC_SLACK} a "
                         f"tensor)")
    del cache

    # the counted run: greedy_generate through the entry point
    n_attn = flash_modules(params)
    fwd = attention.flash_attention_fwd
    fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_attention(attention):
        gen = tstep.greedy_generate(params, cfg, prompts, steps=steps,
                                    **extra)
        torch.cuda.synchronize()
    out["gen_s"] = time.perf_counter() - t0
    out["launches"] = fwd.launches
    if fwd.launches != n_attn or gen.shape != (B, steps):
        raise SystemExit(f"{label}: {fwd.launches} flash launches in one "
                         f"greedy run (want {n_attn}, one a flash module), "
                         f"ids {tuple(gen.shape)}")
    prefill = tstep.make_prefill_step(cfg, max_len=S + steps)
    decode = tstep.make_decode_step(cfg)
    inputs = {"tokens": prompts, **extra}
    if cfg.moe is not None:
        calls = dispatched(tmoe, lambda: prefill(params, inputs))
        out["route_flips"] = flips_of(torch, [c["experts"] for c in calls],
                                      ref["experts"])
        out["dropped"] = [c["dropped"] for c in calls]
        del calls

    # prefill and decode timed apart, synchronized
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    if "caches" in ref:
        out["caches"] = held_caches(torch, ssm_caches(tmodel, cache, cfg),
                                    ref["caches"], label, mesh.size == 1)
    last = logits.full_tensor()[:, -1, :cfg.vocab_size].float()
    toks = [last.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = decode(params, {"tokens": toks[-1][:, None],
                                        "cache": cache})
        toks.append(tstep.next_ids(logits, cfg))
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["allocated_bytes"] = torch.cuda.memory_allocated(dev)
    step = {"tokens": toks[-1][:, None], "cache": cache}
    if kind in EXACT_ON_ONE:
        out["flash_ms"], out["flash_launches"] = flash_prefill_ms(
            torch, attention, lambda: prefill(params, inputs))
        if out["flash_launches"] != n_attn:
            raise SystemExit(f"{label}: {out['flash_launches']} flash "
                             f"launches in one prefill, want {n_attn}")
    out["profile"] = {
        "prefill": profile(f"{label}, one prefill", *device_profile(
            torch, lambda: prefill(params, inputs))),
        "decode": profile(f"{label}, one decode step", *device_profile(
            torch, lambda: decode(params, step)))}
    if kind in EXACT_ON_ONE:
        # the last pass over these modules: CommDebugMode (torch 2.11) can
        # leave its forward hooks on modules it saw, which fail on a later
        # pass (phase 22 counts last too)
        out["prefill_comm"] = comm_counts(torch,
                                          lambda: prefill(params, inputs))
    out["logits"] = held_logits(torch, last, ref["logits"].to(dev), label)
    decided = torch.tensor(out["logits"]["decided"], device=dev)
    want_gen = ref["gen"].to(dev)
    first = gen[:, 0] == want_gen[:, 0]
    out["first_token_agree"] = int(first.sum())
    out["tokens_equal_to_reference"] = int((gen == want_gen).sum())
    if not bool(first[decided].all()):
        raise SystemExit(f"{label}: the first generated token differs from "
                         f"the unsharded run's on a decided row: "
                         f"{first.tolist()}, decided {decided.tolist()}")
    if mesh.size == 1 and not (out["logits"]["bit_identical"]
                               and torch.equal(gen, want_gen)
                               and not any(out.get("route_flips", []))):
        raise SystemExit(f"{label}: on one card the logits, ids and routing "
                         f"must be the unsharded run's bit for bit: "
                         f"{out['logits']}, ids equal "
                         f"{out['tokens_equal_to_reference']}/{gen.numel()}, "
                         f"flips {out.get('route_flips')}")
    del params, cache, logits, gen, toks, last, prompts, inputs, step
    return out


def family_train_checks(torch, tmodel, tmoe, params, cfg, batch: dict,
                        kind: str, ref: dict, mesh, label: str) -> dict:
    """21c/d and 23c/d at the reference's depth: two bf16 runs of the
    loss and backward bit-identical; the loss within MESH_TOL and layer
    0's gradients within its L2 bound of the unsharded run's, in bf16 and
    in fp32; in bf16 an expert weight's gradient is held only when no
    layer routed otherwise than 17c did (a flip moves a token between
    experts and, past the capacity, the tokens after it), and in phase 23
    a gradient only where the unsharded run's own bf16 gradient lies
    within the bound of its fp32 one (``bf16_noise``: Hymba's forward
    kernel's bf16 rounding alone moved 17e's by 0.0647), printed always,
    and its fp32 gradients within SSM_FP32_GRAD_TOL;
    for phase 23 on one card the loss and gradients in both dtypes the
    unsharded run's bit for bit; the MoE's drops at both capacity factors
    (fp32) equal to 17c's wherever every layer up to that one routed as
    17c did (on one card: every layer)."""
    names = FAMILY_GRADS[kind]
    runs = [loss_and_grads(torch, tmodel, tmoe, params, cfg, batch, names,
                           torch.bfloat16, keep_local=True) for _ in (0, 1)]
    same = runs[0]["loss"] == runs[1]["loss"] and all(
        bits_equal(torch, g, runs[1]["local"][n])
        for n, g in runs[0]["local"].items())
    got = {"bfloat16": runs[0], "float32": loss_and_grads(
        torch, tmodel, tmoe, params, cfg, batch, names, torch.float32)}
    del runs
    out = {"bit_identical": same, "errors": {}, "route_flips": {},
           "loss": got["bfloat16"]["loss"],
           "ref_loss": ref["bfloat16"]["loss"]}
    bad = [] if same else ["two bf16 runs differ"]
    exact = mesh.size == 1 and kind in EXACT_ON_ONE
    out["bit_identical_to_reference"] = {}
    # the unsharded run's own bf16 rounding: its bf16 gradients against its
    # fp32 ones
    out["bf16_noise"] = noise = {n: float(
        (ref["bfloat16"]["grads"][n] - ref["float32"]["grads"][n]).norm()
        / ref["float32"]["grads"][n].norm()) for n in names}
    for dt, g in got.items():
        w = ref[dt]
        flips = flips_of(torch, g["experts"], w["experts"])
        err = {"loss": abs(g["loss"] - w["loss"]) / abs(w["loss"])}
        for n in names:
            err[n] = float((g["grads"][n] - w["grads"][n]).norm()
                           / w["grads"][n].norm())
        out["errors"][dt], out["route_flips"][dt] = err, flips
        # bf16: an expert weight only where no routing flipped; in phase
        # 23 a gradient only where the unsharded run's own bf16 rounding
        # stays within the tolerance (a rounding order of its own moves
        # it that far)
        held = [n for n in err if n == "loss" or dt == "float32" or (
            ".moe_w_" not in n or not any(flips)) and (
            kind not in EXACT_ON_ONE or noise[n] <= MESH_TOL["grad"])]
        grad_tol = (SSM_FP32_GRAD_TOL if kind in EXACT_ON_ONE
                    and dt == "float32" else MESH_TOL["grad"])
        bad += [f"{dt} {n} {err[n]}" for n in held if err[n] > (
            MESH_TOL["loss"] if n == "loss" else grad_tol)]
        same_bits = g["loss"] == w["loss"] and all(
            bits_equal(torch, g["grads"][n], w["grads"][n]) for n in names)
        out["bit_identical_to_reference"][dt] = same_bits
        if exact and not same_bits:
            bad.append(f"{dt}: on one card the loss and gradients must be "
                       f"the unsharded run's bit for bit")
    if cfg.moe is not None:
        routing = drops_by_factor(torch, tmoe, tmodel, params, cfg, batch)
        out["drops"] = {}
        for factor, calls in routing.items():
            want = ref["routing"][factor]
            flips = flips_of(torch, [c["experts"] for c in calls],
                             [c["experts"] for c in want])
            got_d = [c["dropped"] for c in calls]
            want_d = [c["dropped"] for c in want]
            alike = np.cumsum(flips) == 0
            out["drops"][str(factor)] = {"mesh": got_d, "17c": want_d,
                                         "flips": flips}
            if (mesh.size == 1 and not alike.all()) or any(
                    a != b for a, b, a_ in zip(got_d, want_d, alike) if a_):
                bad.append(f"drops at capacity factor {factor}")
    if bad:
        raise SystemExit(f"{label}: against phase 17's run: {bad} "
                         f"(tolerances {MESH_TOL}); {out}")
    return out


def family_train_job(torch, dev, kind: str, shape: tuple, mesh,
                     layers: int, seed: int, ref: dict, label: str,
                     opts: dict | None = None) -> dict:
    """Phase 21c (``mt``, Qwen2-MoE-A2.7B at ``layers``) or d (``wt``,
    Whisper-small), 23c/d (``st``, ``ht``) or 24b/c (those with ``opts``,
    the sequence options' config fields) on this rank under the default
    rules, remat full, fp32 state: the per-card state reckoned by
    ``shard_bytes``; at the phase-17 cell's depth
    :func:`family_train_checks`; one counted step; TRAIN_TIMED timed steps
    and one profiled; for phases 23 and 24 the collectives of one more
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.train.loop import distribute_batch
    from repro_torch.train.step import TrainConfig, make_train_step
    set_rules(DEFAULT_RULES)
    full = get_config(FAMILY_ARCH[kind])
    cfg = dataclasses.replace(full, remat="full",
                              num_layers=layers or full.num_layers,
                              **(opts or {}))
    out = {"layers": cfg.num_layers, "reckoned_state_bytes":
           train_state_bytes(cfg, AbstractMesh(shape, mesh.axis_names))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, mesh=mesh,
                                dtype=torch.float32)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    batch = distribute_batch({k: v.to(dev) for k, v in ref["batch"].items()},
                             mesh)
    n_attn = flash_modules(params)
    if cfg.num_layers == ref["layers"]:
        out.update(family_train_checks(torch, tmodel, tmoe, params, cfg,
                                       batch, kind, ref, mesh, label))
    gc.collect()
    torch.cuda.empty_cache()

    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, TrainConfig(ocfg))
    counted = {"flash_attention_fwd": attention.flash_attention_fwd,
               "flash_attention_bwd": attention.flash_attention_bwd}
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_attention(attention):
        params, opt, m = step(params, opt, batch)
        losses = [float(m["loss"])]
    out["first_step_s"] = time.perf_counter() - t0
    out["launches"] = n_ = {k: fn.launches for k, fn in counted.items()}
    if (n_["flash_attention_fwd"] != 2 * n_attn
            or n_["flash_attention_bwd"] != n_attn):
        raise SystemExit(f"{label}: want {2 * n_attn} forward and {n_attn} "
                         f"backward flash launches a step ({n_attn} flash "
                         f"modules), saw {out['launches']}")
    times = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))         # waits for the step
        times.append(time.perf_counter() - t0)
    out.update(losses=losses, step_ms=statistics.median(times) * 1e3,
               step_ms_all=[t * 1e3 for t in times],
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               allocated_bytes=torch.cuda.memory_allocated(dev))
    out["profile"] = profile(f"{label}, one train step", *device_profile(
        torch, lambda: step(params, opt, batch)))
    if kind in EXACT_ON_ONE:              # the last pass, as in serving
        out["step_comm"] = comm_counts(torch, lambda: step(params, opt,
                                                           batch))
    if not all(np.isfinite(losses)) or (
            cfg.num_layers != ref["layers"] and not losses[-1] < losses[0]):
        raise SystemExit(f"{label}: losses {losses} not finite"
                         + ("" if cfg.num_layers == ref["layers"]
                            else " and falling"))
    del params, opt, m, step, batch
    return out


def family_job(torch, dev, job: str, seed: int, refs: dict) -> dict:
    """One phase-21, 23 or 24 job on this rank: ``kind:DxM[:layers[:flags]]``
    (ms, ws, ss, hs: serving; mt, wt, st, ht: training; ``layers`` empty
    for the published depth; ``flags``, phase 24's sequence options, as
    phase 22's: u ``ulysses_attn``, s ``seq_sharded``) on the (D, M)
    device mesh."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.parallel.sharding import get_rules, set_rules
    kind, shape_s, layers, flags = (job.split(":") + ["", ""])[:4]
    shape = tuple(int(x) for x in shape_s.split("x"))
    mesh = make_device_mesh(shape, ("data", "model"), dev)
    label = f"{job_part(job)} {job}"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rules = get_rules()
    layers, opts = int(layers or 0), sp_options(flags)
    try:
        if kind in ("ms", "ws", "ss", "hs"):
            out = family_serve_job(torch, dev, kind, shape, mesh, seed,
                                   refs[kind], label, layers, opts)
        else:
            out = family_train_job(torch, dev, kind, shape, mesh, layers,
                                   seed, refs[kind], label, opts)
    finally:
        set_rules(rules)
    out.update(job=job, mesh=mesh.name, card=torch.cuda.get_device_name(dev),
               job_s=time.perf_counter() - t0, options=sorted(opts))
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: the job kinds of phases 21 and 23, by their part of the phase
FAMILY_JOBS = {"ms": "21a", "ws": "21b", "mt": "21c", "wt": "21d",
               "ss": "23a", "hs": "23b", "st": "23c", "ht": "23d"}
#: phase 24's job kinds (phase 23's with the sequence options), by their
#: part of the phase
SSM_SP_JOBS = {"hs": "24a", "st": "24b", "ht": "24c"}
#: rows 5hu and 5bhu: Hymba's Ulysses shards of one rank (query positions,
#: and the offsets of rank 0 and of the last) of 24a on (1, 4) and of 24c
#: with both options on (2, 2)
HYBRID_SP_ROWS = {"5hu": (512, (0, 1536)), "5bhu": (1024, (0, 1024))}


def job_part(job: str) -> str:
    """A phase-21, 23 or 24 job's part of its phase: phase 24's when the
    job names sequence options, else its kind's."""
    kind, *rest = job.split(":")
    return SSM_SP_JOBS[kind] if len(rest) > 2 and rest[2] else \
        FAMILY_JOBS[kind]


def family_jobs(phase: int, n: int) -> list:
    """Phase 21's, 23's or 24's jobs on ``n`` cards."""
    if phase == 24:
        if n >= 4:
            return [f"hs:1x{n}::u", f"st:{n // 2}x2::s", f"ht:{n // 2}x2::s"]
        cut = SSM_ONE_CARD_LAYERS
        return [f"hs:1x{n}:{cut}:u", f"st:{n}x1:{cut}:s",
                f"ht:{n}x1:{cut}:s", f"ht:{n}x1:{cut}:us"]
    if phase == 23:
        if n >= 4:
            return [f"ss:1x{n}", f"hs:1x{n}", f"hs:{n // 2}x2",
                    f"st:{n // 2}x2", f"ht:{n // 2}x2"]
        cut = f":{SSM_ONE_CARD_LAYERS}"
        return [f"ss:1x{n}{cut}", f"hs:1x{n}{cut}", f"st:{n}x1{cut}",
                f"ht:{n}x1{cut}"]
    jobs = [f"ms:1x{n}", f"ws:1x{n}"]
    if n >= 4:
        jobs += [f"ms:{n // 2}x2", f"ws:{n // 2}x2"]
    jobs.append(f"mt:{n}x1:{MOE_TRAIN_LAYERS}")
    if n >= 4:
        jobs.append(f"mt:{n // 2}x2:{MOE_FULL_LAYERS}")
    jobs.append(f"wt:{n}x1")
    if n >= 4:
        jobs.append(f"wt:{n // 2}x2")
    return jobs


def families_across_cards(torch, seed: int, refs: dict, records: list,
                          t_phase: float, phase=21, kernel=None) -> dict:
    """Phase 21, 23 or 24, or 23 and 24 (``phase`` a tuple) in one launch
    (see the module docstring): the MoE and the encoder-decoder, or the
    SSM and hybrid families without and with the sequence options, served
    and trained on device meshes, one NCCL rank a card (``--serve-rank``
    with the phases' jobs, :func:`family_jobs`); phase 24's jobs printed
    beside phase 23's of the same kind and mesh.  With phase 24 and
    ``kernel`` (the records' maker) rows 5hu and 5bhu after the ranks."""
    phases = phase if isinstance(phase, tuple) else (phase,)
    n = torch.cuda.device_count()
    jobs = [j for p in phases for j in family_jobs(p, n)]
    what = "families" if phases == (21,) else "ssm"
    captured = refs.pop("hs_captured", None)
    print(f"{what} mesh: {n} card(s), one NCCL rank a card; jobs {jobs}")
    work = tempfile.mkdtemp(prefix=f"chip_smoke_{what}-")
    atexit.register(shutil.rmtree, work, True)
    torch.save(refs, os.path.join(work, "serve_refs.pt"))
    t0 = time.perf_counter()
    port = free_port()
    try:
        wait_processes(start_processes([_serve_cmd(r, n, port, work, jobs,
                                                   seed) for r in range(n)]),
                       "/".join(map(str, phases)), timeout=1500)
    except SystemExit:
        rank0 = os.path.join(work, "serve-rank0.json")
        if os.path.exists(rank0):           # the jobs rank 0 finished
            with open(rank0) as f:
                print(json.dumps({f"{what}_mesh_done": json.load(f)}))
        raise
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"serve-rank{r}.json")) as f:
            ranks.append(json.load(f))

    def plain_twin(i: int) -> dict | None:
        """Rank 0's record of the option-free job of job i's kind and
        mesh (phase 23's), if this launch ran one."""
        kind, shape_s = jobs[i].split(":")[:2]
        for j, other in enumerate(jobs):
            parts = (other.split(":") + ["", ""])[:4]
            if parts[:2] == [kind, shape_s] and not parts[3]:
                return ranks[0][j]
        return None
    for i, job in enumerate(jobs):
        a = ranks[0][i]
        kind = job.split(":")[0]
        ref = refs[kind]
        twin = plain_twin(i) if a.get("options") else None
        per_rank = (f"per rank peak {[rk[i]['peak_bytes'] for rk in ranks]},"
                    f" allocated {[rk[i]['allocated_bytes'] for rk in ranks]}")
        options = (f", options {a['options']}" if a.get("options") else "")
        if kind in ("ms", "ws", "ss", "hs"):
            beside = (f"; without the options (phase 23's job) prefill "
                      f"{twin['prefill_ms']} ms, decode {twin['decode_ms']}"
                      f" ms/step, rank 0's flash {twin['flash_ms']} ms, peak"
                      f" {twin['peak_bytes']} bytes" if twin else "")
            flash = (f"rank 0's flash kernel in one prefill {a['flash_ms']} "
                     f"ms over {a['flash_launches']} launches; one "
                     f"prefill's collectives (CommDebugMode) "
                     f"{a['prefill_comm']}; " if "flash_ms" in a else "")
            print(f"{job_part(job)} {job} on the {a['mesh']} mesh "
                  f"({a['card']}){options}: {a['launches']} flash launches "
                  f"in one greedy run on each rank "
                  f"{[rk[i]['launches'] for rk in ranks]}, no plain "
                  f"attention; prefill {a['prefill_ms']} ms, decode "
                  f"{a['decode_ms']} ms/step against the unsharded run's "
                  f"{ref['prefill_ms']} ms and {ref['decode_ms']} ms/step"
                  f"{beside}; {flash}"
                  f"logits {a['logits']} (tolerance {LOGIT_TOL['bfloat16']} "
                  f"of max), first token equal on {a['first_token_agree']}/"
                  f"{len(a['logits']['decided'])} rows, "
                  f"{a['tokens_equal_to_reference']} greedy ids equal; "
                  + (f"routings that differ from one card's per layer "
                     f"{a['route_flips']}, drops {a['dropped']}; "
                     if kind == "ms" else "")
                  + (f"SSM caches after the prefill {a['caches']}; "
                     if "caches" in a else "")
                  + f"peak {a['peak_bytes']} bytes on rank 0 against "
                  f"{ref['peak']}; {per_rank}; bytes against the dry run "
                  f"{a['bytes']}; rank 0's card busy / idle share: prefill "
                  f"{a['profile']['prefill']['busy_ms']} ms / "
                  f"{a['profile']['prefill']['idle_share']}, decode step "
                  f"{a['profile']['decode']['busy_ms']} ms / "
                  f"{a['profile']['decode']['idle_share']}; job "
                  f"{a['job_s']} s [{CARD['smi']}]")
        else:
            fp32_tol = (f", fp32 gradients {SSM_FP32_GRAD_TOL}"
                        if kind in EXACT_ON_ONE else "")
            held = (f"loss {a['loss']} against phase 17's {a['ref_loss']}, "
                    f"relative differences by compute dtype {a['errors']} "
                    f"(tolerances {MESH_TOL}{fp32_tol}), routings that "
                    f"differ from "
                    f"phase 17's per layer {a['route_flips']}, two bf16 "
                    f"runs bit-identical {a['bit_identical']}, bit-identical"
                    f" to phase 17's by dtype "
                    f"{a['bit_identical_to_reference']}, phase 17's own "
                    f"bf16 against fp32 gradients {a['bf16_noise']} (bf16 "
                    f"held where that is within the bound); "
                    if "loss" in a else
                    "no phase-17 reference at this depth; ")
            drops = (f"drops (fp32) by capacity factor {a['drops']}; "
                     if "drops" in a else "")
            beside = (f" and without the options (phase 23's job) "
                      f"{twin['step_ms']} ms, peak {twin['peak_bytes']} "
                      f"bytes, one step's collectives {twin['step_comm']}"
                      if twin else "")
            comm = (f"one step's collectives (CommDebugMode) "
                    f"{a['step_comm']}; " if "step_comm" in a else "")
            print(f"{job_part(job)} {job} on the {a['mesh']} mesh "
                  f"({a['card']}), {a['layers']} layers{options}: {held}"
                  f"{drops}launches a step {a['launches']}, no plain "
                  f"attention; losses {a['losses']}; step {a['step_ms']} ms "
                  f"(median of {TRAIN_TIMED}; {a['step_ms_all']}) against "
                  f"the unsharded run's {ref['step_ms']} ms{beside}; {comm}"
                  f"state reckoned "
                  f"{a['reckoned_state_bytes']} bytes a card (shard_bytes, "
                  f"fp32 parameters, gradients and moments), peak "
                  f"{a['peak_bytes']} bytes on rank 0 against the unsharded "
                  f"{ref['peak']}; {per_rank}; rank 0's card busy / idle "
                  f"share over a step {a['profile']['busy_ms']} ms / "
                  f"{a['profile']['idle_share']}; job {a['job_s']} s "
                  f"[{CARD['smi']}]")

    def last_job(prefix: str, flags: str = "") -> int | None:
        """The index of the last job of ``prefix`` with exactly
        ``flags``."""
        hits = [i for i, j in enumerate(jobs) if j.startswith(prefix)
                and (j.split(":") + ["", ""])[3] == flags]
        return hits[-1] if hits else None
    if 21 in phases:
        serve0 = ranks[0][0]["launches"]
        train0 = ranks[0][jobs.index(f"mt:{n}x1:{MOE_TRAIN_LAYERS}")][
            "launches"]
        for r in records:
            if r["name"].startswith("flash_attention_fwd moe"):
                r["family_mesh_launches"] = serve0
            if r["name"].startswith("flash_attention_bwd moe"):
                r["family_mesh_launches"] = train0["flash_attention_bwd"]
    if 23 in phases:
        # rows 5hr and 5bhr: a rank's launches in Hymba's last serving job
        # and in its training job
        serve0 = ranks[0][last_job("hs:")]["launches"]
        train0 = ranks[0][last_job("ht:")]["launches"]
        for r in records:
            if r["name"] == f"flash_attention_fwd {HYBRID_RANK}":
                r["ssm_mesh_launches"] = serve0
            if r["name"] == f"flash_attention_bwd {HYBRID_RANK}":
                r["ssm_mesh_launches"] = train0["flash_attention_bwd"]
    counts = None
    if 24 in phases:
        # rows 5hu and 5bhu: rank 0's launches in 24a's job and in 24c's
        # last (on one card: both options)
        both = last_job("ht:", "us")
        counts = {"5hu": ranks[0][last_job("hs:", "u")]["launches"],
                  "5bhu": ranks[0][last_job("ht:", "s") if both is None
                                   else both]["launches"][
                      "flash_attention_bwd"]}
        if kernel is not None:
            fq, fk, fv, window, fo = captured
            ulysses_rows(torch, torch.device("cuda"), seed, kernel,
                         (fq, fk, fv, fo), counts, names=("5hu", "5bhu"),
                         rows=HYBRID_SP_ROWS, tag="hybrid ulysses",
                         window=window, bwd_heads=(64, 5, 5, 1))
    del captured
    out = {"cards": n, "jobs": jobs, "ranks": ranks, "wall_s": wall,
           "row_launches": counts, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({f"{what}_mesh_path": out}))
    print(f"phase {' and '.join(map(str, phases))} took {out['phase_s']} s "
          f"({wall} s of ranks)")
    return out


# ---------------------------------------------------------------- phase 22
SP_ARCH = "granite-20b"
SP_LAYERS = 8               # 22a: 8 of Granite-20B's 52 layers, 6.6 GB bf16
SP_FULL = 52                # 22a on 4 cards or more: the published depth
#: 22a at the published depth: greedy steps of the counted run and decode
#: steps timed (decode is host-bound on DTensor dispatch: PERF.md section 5)
SP_FULL_STEPS = 4
#: phase 22's job kinds (``--serve-rank``), by the letter of their part
SP_JOBS = {"us": "a", "ut": "b"}
#: a phase-22 job's option letters: the config fields each sets
SP_FLAGS = {"u": "ulysses_attn", "s": "seq_sharded"}
#: rows 5u and 5bu: the Ulysses shards of one rank (query positions, and
#: the offsets of ranks 0 and the last) of 22a on (1, 4) and of 22b on
#: (2, 2)
SP_ROWS = {"5u": (512, (0, 1536)), "5bu": (1024, (0, 1024))}


def sp_options(flags: str) -> dict:
    """The config fields of a phase-22 job's option letters (``-``:
    none)."""
    return {SP_FLAGS[f]: True for f in flags if f != "-"}


def sp_serve_reference(torch, dev, seed: int, zero_counts, counted) -> dict:
    """Phase 22a's unsharded side, in this process: Granite-20B at its
    published width cut to SP_LAYERS layers, phase 7's serving path and
    checks (``lm_serving``, ``check_layers`` at the first and last layer,
    ``logit_route_checks``); returns what the ranks are held against
    (``serve_record``), the flash launches of the counted run and layer
    0's capture (q, k, v, out) on the host, for rows 5u."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    cfg = dataclasses.replace(get_config(SP_ARCH), num_layers=SP_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"granite lm: {cfg.name} at {cfg.num_layers} of its {SP_FULL} "
          f"layers (d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.mlp_act}, tied head): "
          f"{torch.cuda.memory_allocated()} bytes on the card, made in "
          f"{init_s} s")
    prompts = serve_prompts(torch, cfg, seed).to(dev)
    lm = lm_serving(torch, tstep, attention, params, cfg, {"tokens": prompts},
                    LM_STEPS, zero_counts, counted, "granite lm",
                    (0, cfg.num_layers - 1))
    out = serve_record(torch, prompts, lm)
    out["launches"] = lm["launches"]["flash_attention_fwd"]
    layer_err = check_layers(attention, lm["captured"],
                             tmodel.layer_windows(cfg), "granite lm check")
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, lm["prefill"], params,
        {"tokens": prompts}, lm["kernel_logits"], "granite lm check")
    fq, fk, fv, _, fo = lm["captured"][0]
    out["captured"] = tuple(t.cpu() for t in (fq, fk, fv, fo))
    print(json.dumps({"granite_lm_path": {
        "arch": cfg.name, "layers": cfg.num_layers, "init_s": init_s,
        "prefill_ms": lm["prefill_ms"], "decode_ms_per_step": lm["decode_ms"],
        "launches": lm["launches"], "layer_checks": layer_err,
        "logit_checks": logit_checks, "peak_bytes": out["peak"],
        "card": CARD["smi"]}}))
    del params, lm, prompts, fq, fk, fv, fo
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ulysses_rows(torch, dev, seed: int, kernel, captured, counts: dict,
                 names=("5u", "5bu"), rows=SP_ROWS, tag: str = "ulysses",
                 window=None, bwd_heads=(128, 7, 4, 2)) -> None:
    """Rows 5u and 5bu (or, with ``names``, ``rows``, ``tag``, ``window``
    and ``bwd_heads``, 5hu and 5bhu): the forward kernel at a (1, 4) rank's
    Ulysses shard of 22a (layer 0's captured (q, k, v, out), q cut to
    ``rows``' positions at each offset, against the captured k, v whole)
    and the backward kernel at a (2, 2) rank's shard of 22b
    (standard-normal inputs from ``seed`` at ``bwd_heads``' head_dim, query
    heads a KV head, KV heads and batch; dout at unit RMS), each under
    ``window`` beside its plain version, SDPA under the same boolean mask
    (k and v broadcast to the query heads) and its bound: the allowed
    pairs x 4 hd flops (2.5 x that backward) over 989e12 flop/s, or the
    bytes, where k and v count only the keys the shard's mask allows (the
    backward still writes dK and dV whole), if more.  The backward's dK and
    dV must be exactly zero at every key past the shard's last query.  ``counts``: each row's launches on its phase's path (rank
    0's)."""
    from repro_torch.kernels import attention
    from torch_checks import attn_tol, bwd_tol, flash_bwd_inputs, unit_rms
    fq, fk, fv, fo = (t.to(dev) for t in captured)
    sq_, offsets = rows[names[0]]
    k, v = fk.contiguous(), fv.contiguous()
    win = f", window {window}" if window else ""
    for off in offsets:
        q = fq[:, off:off + sq_].contiguous()
        B_, Sq, H_, hd_ = q.shape
        keep = attention.allowed(Sq, k.shape[1], causal=True, q_offset=off,
                                 window=window, device=dev)
        library, info = sdpa_beside(torch, q, k, v, keep)
        kv_used = k.numel() // k.shape[1] * int(keep.any(0).sum())
        kernel(f"flash_attention_fwd {tag} q_offset {off}", "attention.cu",
               "src/repro/kernels/attention.py:67",
               f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal{win}, "
               f"q_offset {off}, bf16",
               lambda: attention.flash_attention_fwd(
                   q, k, v, causal=True, window=window, q_offset=off),
               lambda: attention.flash_attention_fwd_plain(
                   q, k, v, causal=True, window=window, q_offset=off),
               2 * (2 * q.numel() + 2 * kv_used),
               4 * hd_ * int(keep.sum()) * B_ * H_, 10,
               count=counts[names[0]],
               tol=attn_tol(fo[:, off:off + sq_], torch.bfloat16),
               peak_ops=PEAK_BF16, library=library)
        print(f"row {names[0]} q_offset {off}: SDPA {info}")
        del q, keep, library
    del fq, fk, fv, fo, k, v

    sq_, offsets = rows[names[1]]
    hd, g, kv, batch = bwd_heads
    rng = np.random.default_rng(seed)
    q, k, v, dout = flash_bwd_inputs(rng, sq_, hd, g, torch.bfloat16, dev,
                                     batch=batch, kv=kv, skv=2 * sq_)
    udout = unit_rms(dout)
    for off in offsets:
        out, lse = attention.flash_attention_fwd(q, k, v, causal=True,
                                                 window=window, q_offset=off,
                                                 return_lse=True)
        got = attention.flash_attention_bwd(q, k, v, out, lse, udout,
                                            causal=True, window=window,
                                            q_offset=off)
        torch.cuda.synchronize()
        past = off + sq_                # keys past the shard's last query
        if got[1][:, past:].any() or got[2][:, past:].any():
            raise SystemExit(f"row {names[1]} q_offset {off}: dK or dV is "
                             f"not zero past the last query ({past})")
        B_, Sq, H_, hd_ = q.shape
        keep = attention.allowed(Sq, k.shape[1], causal=True, q_offset=off,
                                 window=window, device=dev)
        want = attention.flash_attention_bwd_plain(q, k, v, out, lse, udout,
                                                   causal=True, window=window,
                                                   q_offset=off)
        kv_used = k.numel() // k.shape[1] * int(keep.any(0).sum())
        g = H_ // k.shape[2]
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k.repeat_interleave(g, dim=2),
                                v.repeat_interleave(g, dim=2)))
        library = None
        try:
            so = torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=keep)
            sdo = udout.transpose(1, 2).contiguous()
            library = lambda: torch.autograd.grad(  # noqa: E731
                so, (sq, sk, sv), sdo, retain_graph=True)
            library()
        except RuntimeError as exc:
            library = None
            print(f"row {names[1]}: SDPA's backward refused the inputs: "
                  f"{exc}"[:300])
        kernel(f"flash_attention_bwd {tag} q_offset {off}", "attention.cu",
               "src/repro/models/flash.py:262",
               f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal{win}, "
               f"q_offset {off}, bf16, dK and dV past key {past} exactly 0",
               lambda: attention.flash_attention_bwd(
                   q, k, v, out, lse, udout, causal=True, window=window,
                   q_offset=off),
               lambda: attention.flash_attention_bwd_plain(
                   q, k, v, out, lse, udout, causal=True, window=window,
                   q_offset=off),
               2 * (4 * q.numel() + 2 * kv_used + 2 * k.numel())
               + 4 * lse.numel(),
               2.5 * 4 * hd_ * int(keep.sum()) * B_ * H_, 10,
               count=counts[names[1]],
               tol=[bwd_tol(x, torch.bfloat16) for x in want],
               peak_ops=PEAK_BF16, library=library)
        del out, lse, got, want, keep, library, sq, sk, sv
    del q, k, v, dout, udout
    gc.collect()
    torch.cuda.empty_cache()


def flash_prefill_ms(torch, attention, run) -> tuple[float, int]:
    """The flash kernel's card time over one ``run()`` (a prefill) on this
    rank: the sum of CUDA-event spans around each wrapper call, and the
    launches its counter saw (the wrapper counts on the module's name,
    which the timing wrapper holds meanwhile)."""
    fwd = attention.flash_attention_fwd
    spans = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fwd(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out
    before = timed.launches = fwd.launches
    attention.flash_attention_fwd = timed
    try:
        run()
    finally:
        attention.flash_attention_fwd = fwd
        fwd.launches = timed.launches
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans), fwd.launches - before


def comm_counts(torch, run) -> dict:
    """``CommDebugMode``'s collective counts over one ``run()``."""
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        run()
    torch.cuda.synchronize()
    return {str(k): v for k, v in comm.get_comm_counts().items()}


def sp_serve_job(torch, dev, shape: tuple, mesh, layers: int, opts: dict,
                 seed: int, ref: dict, label: str) -> dict:
    """Phase 22a on this rank under ``serve_tp``: Granite-20B at ``layers``
    with ``opts``: the allocator's bytes against the dry run's, the counted
    greedy run (one flash launch a layer, no plain attention), prefill and
    decode timed, the flash kernel's time in one prefill, ``CommDebugMode``'s
    counts of one prefill, each rank's peak; at SP_LAYERS the logits held
    against the unsharded run's (bit for bit on one card)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as tmodel
    from repro_torch.serve import step as tstep
    cfg = dataclasses.replace(get_config(SP_ARCH), num_layers=layers, **opts)
    steps = LM_STEPS if layers == SP_LAYERS else SP_FULL_STEPS
    ref = ref if layers == SP_LAYERS else None
    prompts = (ref["prompts"] if ref else serve_prompts(torch, cfg, seed)
               ).to(dev)
    B, S = prompts.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, mesh=mesh)
    torch.cuda.synchronize()
    out = {"layers": layers, "options": sorted(opts),
           "init_s": time.perf_counter() - t0}
    param_bytes = torch.cuda.memory_allocated(dev) - base
    cache = tmodel.init_cache(cfg, B, S + steps, mesh=mesh)
    torch.cuda.synchronize()
    cache_bytes = torch.cuda.memory_allocated(dev) - base - param_bytes
    want = dryrun.serve_arg_bytes(cfg, AbstractMesh(shape, mesh.axis_names),
                                  B, S + steps)
    n_params = sum(1 for _ in params.parameters())
    out["bytes"] = {"params": param_bytes, "cache": cache_bytes,
                    "dryrun": want, "slack_a_tensor": SERVE_ALLOC_SLACK}
    if not (0 <= param_bytes - want["params"] <= n_params * SERVE_ALLOC_SLACK
            and 0 <= cache_bytes - want["cache"] <= 2 * SERVE_ALLOC_SLACK):
        raise SystemExit(f"{label}: the allocator holds {param_bytes} bytes "
                         f"of parameters and {cache_bytes} of cache, the dry "
                         f"run says {want} (slack {SERVE_ALLOC_SLACK} a "
                         f"tensor)")
    del cache

    # the counted run: greedy_generate through the entry point
    fwd = attention.flash_attention_fwd
    fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_attention(attention):
        gen = tstep.greedy_generate(params, cfg, prompts, steps=steps)
        torch.cuda.synchronize()
    out["gen_s"] = time.perf_counter() - t0
    out["launches"] = fwd.launches
    if fwd.launches != layers or gen.shape != (B, steps):
        raise SystemExit(f"{label}: {fwd.launches} flash launches in one "
                         f"greedy run (want {layers}, one a layer), ids "
                         f"{tuple(gen.shape)}")

    # prefill and decode timed apart, synchronized
    prefill = tstep.make_prefill_step(cfg, max_len=S + steps)
    decode = tstep.make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    last = logits.full_tensor()[:, -1, :cfg.vocab_size].float()
    toks = [last.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        logits, cache = decode(params, {"tokens": toks[-1][:, None],
                                        "cache": cache})
        toks.append(tstep.next_ids(logits, cfg))
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    del cache, logits
    out["flash_ms"], out["flash_launches"] = flash_prefill_ms(
        torch, attention, lambda: prefill(params, {"tokens": prompts}))
    out["prefill_comm"] = comm_counts(
        torch, lambda: prefill(params, {"tokens": prompts}))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["allocated_bytes"] = torch.cuda.memory_allocated(dev)
    if ref is not None:
        out["logits"] = held_logits(torch, last, ref["logits"].to(dev),
                                    label)
        want_gen = ref["gen"].to(dev)
        out["tokens_equal_to_reference"] = int((gen == want_gen).sum())
        if mesh.size == 1 and not (out["logits"]["bit_identical"]
                                   and torch.equal(gen, want_gen)):
            raise SystemExit(f"{label}: on one card the logits and ids must "
                             f"be the unsharded run's bit for bit: "
                             f"{out['logits']}, ids equal "
                             f"{out['tokens_equal_to_reference']}/"
                             f"{gen.numel()}")
    del params, gen, toks, last, prompts
    return out


def sp_train_job(torch, dev, shape: tuple, mesh, layers: int, opts: dict,
                 seed: int, ref: dict, label: str) -> dict:
    """Phase 22b on this rank under the default rules: 13a's configuration
    at ``layers`` with ``opts`` (fp32 state, remat full, 13a's seed) on
    13a's first batch: at TRAIN_LAYERS the loss and layer 0's wq, wk, wv
    gradients against 13a's (bit for bit on one card, else within
    MESH_TOL); one counted step (two forward and one backward flash
    launch a layer, no plain attention); MESH_TIMED timed steps and the
    rank's peak."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.train.loop import distribute_batch
    from repro_torch.train.step import TrainConfig, make_train_step
    set_rules(DEFAULT_RULES)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=layers,
                              **opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tmodel.init_params(cfg, seed=seed, mesh=mesh,
                                dtype=torch.float32)
    torch.cuda.synchronize()
    out = {"layers": layers, "options": sorted(opts),
           "init_s": time.perf_counter() - t0}
    batch = distribute_batch({k: ref[k].to(dev) for k in ("tokens",
                                                           "labels")}, mesh)
    if layers == TRAIN_LAYERS:
        params.requires_grad_(True)
        loss, _ = tmodel.lm_loss(params, cfg, batch)
        loss.backward()
        got = float(tmodel.full_tensor(loss.detach()))
        grads = {n: tmodel.full_tensor(getattr(params.layers[0], n).grad)
                 .cpu() for n in ("wq", "wk", "wv")}
        params.zero_grad(set_to_none=True)
        params.requires_grad_(False)
        err = {"loss": abs(got - ref["loss"]) / abs(ref["loss"])}
        for n, g in grads.items():
            w = ref["grads"][n]
            err[f"layer0.{n}"] = float((g - w).norm() / w.norm())
        same = got == ref["loss"] and all(
            bits_equal(torch, g, ref["grads"][n]) for n, g in grads.items())
        out.update(loss=got, ref_loss=ref["loss"], errors=err,
                   bit_identical=same)
        if (mesh.size == 1 and not same) or not (
                err["loss"] <= MESH_TOL["loss"]
                and all(err[f"layer0.{n}"] <= MESH_TOL["grad"]
                        for n in ("wq", "wk", "wv"))):
            raise SystemExit(f"{label}: the loss and gradients against 13a's"
                             f": {err}, bit-identical {same} (tolerances "
                             f"{MESH_TOL}; bit for bit on one card)")
        del loss, grads
    gc.collect()
    torch.cuda.empty_cache()

    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, decay_steps=100)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, TrainConfig(ocfg))
    counted = {"flash_attention_fwd": attention.flash_attention_fwd,
               "flash_attention_bwd": attention.flash_attention_bwd}
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    with no_plain_attention(attention):
        params, opt, m = step(params, opt, batch)
        losses = [float(m["loss"])]
    out["launches"] = n_ = {k: fn.launches for k, fn in counted.items()}
    if (n_["flash_attention_fwd"] != 2 * layers
            or n_["flash_attention_bwd"] != layers):
        raise SystemExit(f"{label}: want {2 * layers} forward and {layers} "
                         f"backward flash launches a step, saw {n_}")
    times = []
    for _ in range(MESH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))         # waits for the step
        times.append(time.perf_counter() - t0)
    out.update(losses=losses, step_ms=statistics.median(times) * 1e3,
               step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(
                   times),
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               allocated_bytes=torch.cuda.memory_allocated(dev))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"{label}: losses {losses} not finite and falling")
    del params, opt, m, step, batch
    return out


def sp_job(torch, dev, job: str, seed: int, refs: dict) -> dict:
    """One phase-22 job on this rank: ``kind:DxM:layers:options`` (us:
    serving Granite-20B, ut: training 13a's configuration; options of
    SP_FLAGS, ``-`` for none) on the (D, M) device mesh."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.parallel.sharding import get_rules, set_rules
    kind, shape_s, layers, flags = job.split(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    mesh = make_device_mesh(shape, ("data", "model"), dev)
    label = f"22{SP_JOBS[kind]} {job}"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rules = get_rules()
    try:
        out = (sp_serve_job if kind == "us" else sp_train_job)(
            torch, dev, shape, mesh, int(layers), sp_options(flags), seed,
            refs[kind], label)
    finally:
        set_rules(rules)
    out.update(job=job, mesh=mesh.name, card=torch.cuda.get_device_name(dev),
               job_s=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_jobs(n: int) -> list:
    """Phase 22's jobs on ``n`` cards: on one card (or two or three) the
    (1, 1) mesh with the options; with 4 or more 22a's 8 layers on (1, n)
    without and with ``ulysses_attn``, then its 52 both ways, and 22b's
    8 layers on (n/2, 2) and (1, n) with both options, then the published
    28 on (n/2, 2) without and with them, each pair in the same ranks."""
    if n < 4:
        return [f"us:1x1:{SP_LAYERS}:u", f"ut:1x1:{TRAIN_LAYERS}:us"]
    return [f"us:1x{n}:{SP_LAYERS}:-", f"us:1x{n}:{SP_LAYERS}:u",
            f"us:1x{n}:{SP_FULL}:-", f"us:1x{n}:{SP_FULL}:u",
            f"ut:{n // 2}x2:{TRAIN_LAYERS}:us", f"ut:1x{n}:{TRAIN_LAYERS}:us",
            f"ut:{n // 2}x2:{MESH_FULL_LAYERS}:-",
            f"ut:{n // 2}x2:{MESH_FULL_LAYERS}:us"]


def sequence_parallel(torch, dev, seed: int, zero_counts, counted, kernel,
                      train_ref: dict, records: list) -> dict:
    """Phase 22 (see the module docstring): ``ulysses_attn`` and
    ``seq_sharded`` on device meshes, one NCCL rank a card
    (``--serve-rank`` with phase 22's jobs), after 22a's unsharded run in
    this process; ``train_ref``: 13a's first batch, loss and layer 0's
    q/k/v gradients; ``kernel`` (the records' maker) is None under
    ``--mesh-only``, which times no row."""
    t_phase = time.perf_counter()
    serve_ref = sp_serve_reference(torch, dev, seed, zero_counts, counted)
    captured = serve_ref.pop("captured")
    n = torch.cuda.device_count()
    world = n if n >= 4 else 1
    jobs = sp_jobs(world)
    print(f"sequence options: {n} card(s), {world} NCCL rank(s), one a "
          f"card; jobs {jobs}")
    work = tempfile.mkdtemp(prefix="chip_smoke_sp-")
    atexit.register(shutil.rmtree, work, True)
    torch.save({"us": serve_ref, "ut": train_ref},
               os.path.join(work, "serve_refs.pt"))
    t0 = time.perf_counter()
    port = free_port()
    wait_processes(start_processes([_serve_cmd(r, world, port, work, jobs,
                                               seed) for r in range(world)]),
                   "22")
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"serve-rank{r}.json")) as f:
            ranks.append(json.load(f))
    for i, job in enumerate(jobs):
        a = ranks[0][i]
        per_rank = (f"per rank peak {[rk[i]['peak_bytes'] for rk in ranks]},"
                    f" allocated {[rk[i]['allocated_bytes'] for rk in ranks]}")
        if job.startswith("us"):
            held = (f"logits {a['logits']} (tolerance "
                    f"{LOGIT_TOL['bfloat16']} of max), "
                    f"{a['tokens_equal_to_reference']}/"
                    f"{LM_BATCH * LM_STEPS} greedy ids equal; "
                    if "logits" in a else "no unsharded reference; ")
            print(f"22a {job} on the {a['mesh']} mesh ({a['card']}), "
                  f"options {a['options']}: {held}{a['launches']} flash "
                  f"launches in one greedy run on each rank "
                  f"{[rk[i]['launches'] for rk in ranks]}, no plain "
                  f"attention; prefill {a['prefill_ms']} ms, decode "
                  f"{a['decode_ms']} ms/step against the unsharded run's "
                  f"{serve_ref['prefill_ms']} ms and "
                  f"{serve_ref['decode_ms']} ms/step; rank 0's flash kernel "
                  f"in one prefill {a['flash_ms']} ms over "
                  f"{a['flash_launches']} launches; one prefill's "
                  f"collectives (CommDebugMode) {a['prefill_comm']}; "
                  f"{per_rank}; bytes against the dry run {a['bytes']}; job "
                  f"{a['job_s']} s [{CARD['smi']}]")
        else:
            held = (f"loss {a['loss']} against 13a's {a['ref_loss']}, "
                    f"relative differences {a['errors']} (tolerances "
                    f"{MESH_TOL}), bit-identical {a['bit_identical']}; "
                    if "loss" in a else "no 13a reference at this depth; ")
            print(f"22b {job} on the {a['mesh']} mesh ({a['card']}), "
                  f"{a['layers']} layers, options {a['options']}: {held}"
                  f"launches a step {a['launches']}, no plain attention; "
                  f"losses {a['losses']}; step {a['step_ms']} ms (median of "
                  f"{MESH_TIMED}; {a['step_ms_all']}), {a['tokens_per_s']} "
                  f"tokens/s; {per_rank}; job {a['job_s']} s "
                  f"[{CARD['smi']}]")
    full = [i for i, j in enumerate(jobs)
            if j.startswith(f"ut:{world // 2}x2:{MESH_FULL_LAYERS}:")]
    if full:
        l0, l1 = (ranks[0][i]["losses"][0] for i in full)
        rel = abs(l1 - l0) / abs(l0)
        print(f"22b at the published {MESH_FULL_LAYERS} layers: first loss "
              f"{l1} with both options against {l0} without, relative "
              f"{rel}; step {ranks[0][full[1]]['step_ms']} ms against "
              f"{ranks[0][full[0]]['step_ms']} ms, rank 0's peak "
              f"{ranks[0][full[1]]['peak_bytes']} against "
              f"{ranks[0][full[0]]['peak_bytes']} bytes")
        if rel > MESH_TOL["loss"]:
            raise SystemExit(f"22b: the losses with and without the options "
                             f"differ by {rel} (tolerance "
                             f"{MESH_TOL['loss']})")
    serve_u = next(i for i, j in enumerate(jobs)
                   if j.startswith("us") and j.endswith(f"{SP_LAYERS}:u"))
    train_u = next(i for i, j in enumerate(jobs) if j.startswith("ut"))
    counts = {"5u": ranks[0][serve_u]["launches"],
              "5bu": ranks[0][train_u]["launches"]["flash_attention_bwd"]}
    if kernel is not None:
        ulysses_rows(torch, dev, seed, kernel, captured, counts)
    del captured
    out = {"cards": n, "jobs": jobs, "ranks": ranks, "wall_s": wall,
           "unsharded": {k: serve_ref[k] for k in ("prefill_ms", "decode_ms",
                                                   "peak")},
           "row_launches": counts, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"sequence_parallel_path": out}))
    print(f"phase 22 took {out['phase_s']} s ({wall} s of ranks)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-only", action="store_true",
                    help="phase 1, then phases 19-24 beside their "
                    "unsharded references (for a run on several cards)")
    ap.add_argument("--mesh-phases", default="19,20,21,22,23,24",
                    help="with --mesh-only: which of phases 19-24 to run "
                    "(comma-separated)")
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
    from torch_checks import (COUNTED_CASES, STACKED_CASES,
                              any_int32_cam_inputs, attn_tol, bf16_attn_err,
                              bulk_counted_inputs, bulk_plan_route,
                              bulk_routes_seen, record_cuts,
                              stacked_program_inputs)
    import repro_torch
    from repro_torch.core.bic import BICConfig
    from repro_torch.db import BitmapDB
    from repro_torch.engine import backends, batch, planner, policy
    from repro_torch.engine import runtime as truntime
    from repro_torch.store import open_index
    from repro_torch.kernels import _build, attention, bit_transpose
    from repro_torch.kernels import bitmap_ops, cam_match
    from repro_torch.kernels import ref as kref
    dev = torch.device("cuda")
    wrappers = {"cam_match": cam_match.cam_match,
                "bit_transpose": bit_transpose.bit_transpose,
                "bitmap_query": bitmap_ops.bitmap_query,
                "bulk_program": bitmap_ops.bulk_program}
    # every counted wrapper: all are set to 0 before each path is driven
    counted = {**wrappers,
               "bulk_program_stacked": bitmap_ops.bulk_program_stacked,
               "flash_attention_fwd": attention.flash_attention_fwd,
               "flash_attention_bwd": attention.flash_attention_bwd}

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
    CARD["smi"] = smi
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    src = entry = None
    for line in report.splitlines():
        if line.startswith("---"):
            src, entry = line[4:].strip(), ""
        if "Compiling entry" in line:
            entry = line
        named = (src in ("bit_transpose.cu", "bitmap_ops.cu")
                 or (src == "attention.cu" and "wgmma" in entry))
        if ("registers" in line or line.startswith("---") or (
                named and ("Compiling entry" in line or "spill" in line))):
            print(f"  {line.strip()}")

    if args.mesh_only:
        phases = {int(p) for p in args.mesh_phases.split(",")}
        if not phases or not phases <= {19, 20, 21, 22, 23, 24}:
            raise SystemExit(f"--mesh-phases: want some of 19-24, got "
                             f"{args.mesh_phases}")
        train_rec = (mesh_reference(torch, dev, args.seed)
                     if phases & {19, 22} else None)
        if 19 in phases:
            mesh_training(torch, args.seed, train_rec, [])
            gc.collect()
            torch.cuda.empty_cache()
        if 20 in phases:
            t20 = time.perf_counter()
            lm7 = serve_reference(torch, dev, args.seed, zero_counts,
                                  counted)
            mesh_serving(torch, args.seed, lm7, big_serving(
                torch, dev, args.seed, zero_counts, counted, None), [], t20)
            gc.collect()
            torch.cuda.empty_cache()
        if 21 in phases:
            t21 = time.perf_counter()
            families_across_cards(torch, args.seed, family_references(
                torch, dev, args.seed, zero_counts, counted), [], t21)
            gc.collect()
            torch.cuda.empty_cache()
        if 22 in phases:
            sequence_parallel(torch, dev, args.seed, zero_counts, counted,
                              None, train_rec["mesh_reference"], [])
            gc.collect()
            torch.cuda.empty_cache()
        if phases & {23, 24}:
            t23 = time.perf_counter()
            families_across_cards(torch, args.seed, ssm_references(
                torch, dev, args.seed, zero_counts, counted), [], t23,
                tuple(sorted(phases & {23, 24})))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    # every bulk_program form, each case on the route of the C entry's plan
    # (held against its mirror; the profiler must see no kernel of the
    # other route): the counted forms at record counts 0, 1, 32 Nw - 5,
    # 32 Nw and mid-word (rows and counts as one tensor)
    routes = {"2-D": set(), "stacked": set()}

    def flat(pair):
        return torch.cat([t.reshape(-1) for t in pair])

    def plan_route(case, stacked, s_, m_, nw_, shape_):
        """The route of a case's counted and uncounted forms, which must
        agree."""
        got = {bulk_plan_route(s_, m_, nw_, shape_, stacked=stacked,
                               counted=c) for c in (False, True)}
        if len(got) != 1:
            raise SystemExit(f"bulk_program {case}: the forms' plans take "
                             f"the routes {got}, want one")
        return got.pop()

    def check_case(kind, case, route, forms):
        """Run ``forms`` (name -> (kernel call, plain version)) under the
        profiler: it must see no kernel of a route other than ``route``,
        and each call must equal its plain version."""
        got = {}
        seen = route_seen(f"bulk_program {case}", bulk_routes_seen(
            lambda: got.update({name: fn() for name, (fn, _) in
                                forms.items()}), len(forms)),
            route, len(forms))
        routes[kind].add(route)
        for name, (_, plain) in forms.items():
            if not torch.equal(got[name], plain()):
                raise SystemExit(f"{name} {case}: kernel disagrees with "
                                 "its plain version")
            print(f"check {name} {case}: bit-identical at ragged shape "
                  f"{tuple(got[name].shape)} on the {route} route ({seen})")

    for m_, nw_, shape_, lits_ in COUNTED_CASES:
        args_ = [torch.from_numpy(a).to(dev) for a in bulk_counted_inputs(
            rng, m_, nw_, shape_, lits_)]
        forms = {"bulk_program": (
            lambda: bitmap_ops.bulk_program(*args_),
            lambda: bitmap_ops.bulk_program_plain(*args_))}
        for n_ in record_cuts(nw_):
            forms[f"bulk_program_counted n={n_}"] = (
                lambda n_=n_: flat(bitmap_ops.bulk_program_counted(
                    args_[0], n_, *args_[1:])),
                lambda n_=n_: flat(bitmap_ops.bulk_program_counted_plain(
                    args_[0], n_, *args_[1:])))
        case_ = f"M={m_} Nw={nw_} {shape_} {lits_}"
        check_case("2-D", case_,
                   plan_route(case_, False, 1, m_, nw_, shape_), forms)
    for s_, m_, nw_, shape_, lits_ in STACKED_CASES:
        args_ = [torch.from_numpy(a).to(dev) for a in stacked_program_inputs(
            rng, s_, m_, nw_, shape_, lits_)]
        case_ = f"S={s_} M={m_} Nw={nw_} {shape_} {lits_}"
        check_case("stacked", case_,
                   plan_route(case_, True, s_, m_, nw_, shape_), {
                       "bulk_program_stacked": (
                           lambda: bitmap_ops.bulk_program_stacked(*args_),
                           lambda: bitmap_ops.bulk_program_stacked_plain(
                               *args_)),
                       "bulk_program_stacked_counted": (
                           lambda: flat(
                               bitmap_ops.bulk_program_stacked_counted(
                                   *args_)),
                           lambda: flat(
                               bitmap_ops.bulk_program_stacked_counted_plain(
                                   *args_)))})
    if any(r != {"staged", "gather"} for r in routes.values()):
        raise SystemExit(f"bulk_program routes covered: {routes}, want both "
                         "routes of each launch")
    worst = {}                  # (dtype, hd, check) -> (err / tol, case)
    seqs, groups = (1, 63, 65, 127, 129, 300, 2048), (1, 4, 7)
    for seq, hd, g, causal, dt in itertools.product(
            seqs, (32, 64, 128, 256), groups, (True, False),
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
    # the C entry must launch the kernel of its route once and no other
    # (its count at the launch site); the profiler must see no other flash
    # kernel either (it loses records, PERF.md section 7: what it saw of
    # the route's own is printed)
    for dt, hd, want in ((torch.bfloat16, 128, "flash_fwd_wgmma"),
                         (torch.bfloat16, 256, "flash_fwd_wgmma"),
                         (torch.float32, 128, "flash_fwd_kernel"),
                         (torch.float32, 256, "flash_fwd_kernel")):
        fq, fk, fv = (torch.from_numpy(rng.standard_normal((2, 300, heads, hd))
                                       .astype(np.float32)).to(dev, dt)
                      for heads in (8, 2, 2))
        for _ in range(3):              # the profiler now and then misses
            seen = {}                   # the launch
            _, launched = route_launches(torch, attention, lambda: (
                device_profile(torch, lambda: attention.flash_attention_fwd(
                    fq, fk, fv, causal=True), 1, seen)))
            if launches_named(seen, "flash_fwd"):
                break
        if (launched != {n: int(n == want) for n in attention.KERNELS}
                or launches_named(seen, "flash_fwd") > launches_named(
                    seen, want) or launches_named(seen, want) > 1):
            raise SystemExit(f"flash_attention_fwd {dt} hd={hd}: the C entry "
                             f"launched {launched}, the profiler saw {seen}; "
                             f"want one {want} launch and no other")
        print(f"check flash_attention_fwd {dt} hd={hd}: the C entry launched "
              f"one {want}; the profiler saw {launches_named(seen, want)} of "
              f"it and no other flash kernel")
    check_flash_backward(torch, dev, rng, attention)
    check_flash_masked(torch, dev, rng, attention)
    check_flash_encdec(torch, dev, rng, attention)

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
               count, tol=0, peak_ops=PEAK_OPS, library=None, symbol=None):
        """Check ``run`` against ``plain`` (within ``tol``; a kernel with
        several outputs, each within its own entry of ``tol``), time both and
        ``library`` (one PyTorch call of the same function, or None), and
        add the kernel's record; ``count`` is its main-path launch count.
        With a library, the kernel, its plain version and the library are
        timed alike, by CUDA events around back-to-back calls (the
        profiler has seen part of SDPA's backward only, and a quarter of
        the backward kernel).  Without one, by the profiler's card time,
        held against the bound and, for the kernel, against back-to-back
        events; with ``symbol``, the one kernel a call launches, the
        kernel's time is its time a launch the profiler timed."""
        got, want = run(), plain()
        if not isinstance(got, (tuple, list)):
            got, want = (got,), (want,)
        if not isinstance(tol, (tuple, list)):
            tol = (tol,) * len(got)
        torch.cuda.synchronize()
        errs = [max_abs_err(a, b) for a, b in zip(got, want)]
        err = max(errs)
        # the plain outputs' largest magnitudes, beside the tolerances
        want_max = [float(b.float().abs().max()) if b.numel() else 0.0
                    for b in want]
        if not all(e <= t for e, t in zip(errs, tol)):
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version at {shape_s}: errors {errs}, "
                             f"tolerances {tol}, max|plain| {want_max}")
        b_ms, b_by = bound(nbytes, ops, peak_ops)

        def card_ms(fn, n, what, b2b=0.0, symbol=None):
            """The profiler's card time, and the launches of ``symbol`` it
            timed of the ``n``.  With ``symbol`` the kernel's part is its
            time over the launches whose records carry a time: the
            profiler drops records and keeps some without their time
            (PERF.md section 7), and the count says how many it timed.
            Without, a reading below half of ``b2b`` (back-to-back
            events, when they exceed 0.1 ms, past a launch's host cost)
            is a partial capture.  A reading below the bound is one too.
            A partial capture is taken again, then fails."""
            for _ in range(3):
                timed = {}
                got_ms = device_profile(torch, fn, n, timed=timed)[1]
                kept = n
                if symbol:
                    kept = sum(c for k, (c, _) in timed.items() if symbol in k)
                    part = sum(t for k, (_, t) in timed.items() if symbol in k)
                    got_ms += part / kept - part / n if kept else -got_ms
                    if got_ms >= b_ms:
                        return got_ms, kept
                elif got_ms >= b_ms and (b2b < 0.1 or got_ms >= 0.5 * b2b):
                    return got_ms, kept
                print(f"{name}: the profiler saw {got_ms} ms of {what} "
                      f"(bound {b_ms} ms, back-to-back events {b2b} ms); "
                      f"profiling again")
            raise SystemExit(f"{name}: the profiler saw {got_ms} ms of "
                             f"{what}, a partial capture (bound {b_ms} ms, "
                             f"back-to-back events {b2b} ms)")
        ev_ms = event_ms(torch, run, reps)
        b2b_ms = event_ms(torch, run, reps, back_to_back=True)
        kept = None
        if library is None:
            (ms, kept), lib_ms = card_ms(run, reps, "the kernel", b2b_ms,
                                         symbol), None
            plain_ms = card_ms(plain, 2, "the plain version")[0]
        else:
            ms = b2b_ms
            plain_ms = event_ms(torch, plain, 2, back_to_back=True)
            lib_ms = event_ms(torch, library, reps, back_to_back=True)
            if not min(ms, plain_ms, lib_ms) >= b_ms:
                raise SystemExit(f"{name}: kernel {ms} ms, plain {plain_ms} "
                                 f"ms or library {lib_ms} ms below the "
                                 f"bound {b_ms} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": line,
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "event_ms": ev_ms, "b2b_ms": b2b_ms,
            "profiled_launches": None if kept is None else [kept, reps],
            "shape": shape_s, "errs": errs, "tols": list(tol),
            "want_max": want_max})
        print(f"kernel {name} at {shape_s}: errors {errs}, tolerances "
              f"{list(tol)}, max|plain| {want_max}")
        print(f"kernel {name} at {shape_s}: {ms} ms on the card "
              f"({'back-to-back events' if library else 'profiler'}"
              f"{f', {kept} of {reps} launches timed' if symbol else ''}; "
              f"{b2b_ms} ms a call back to back, {ev_ms} ms between events "
              f"around one call; plain {plain_ms} ms; library {lib_ms} ms; "
              f"bound {b_ms} ms by {b_by})")

    nrec = rec0.shape[0]
    # The function needs no N*W*M compares: a 256-entry table from a word's
    # value to the packed mask of the keys it equals gives each record's
    # bits with one M/32-word OR per record word.
    kernel("cam_match", "cam_match.cu", "src/repro/kernels/cam_match.py:50",
           f"records {tuple(rec0.shape)} x keys ({M},)",
           lambda: cam_match.cam_match(rec0, keys),
           lambda: cam_match.cam_match_plain(rec0, keys),
           nrec * W * 4 + M * 4 + nrec * M // 8, nrec * W * M // 32, 5,
           count=launches["cam_match"], symbol="cam_match_kernel")
    kernel("bit_transpose", "bit_transpose.cu",
           "src/repro/kernels/bit_transpose.py:65", f"{tuple(rm.shape)}",
           lambda: bit_transpose.bit_transpose(rm),
           lambda: bit_transpose.bit_transpose_plain(rm),
           2 * rm.numel() * 4, 0, 10, count=launches["bit_transpose"],
           symbol="bit_transpose_kernel")
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
           count=launches["bitmap_query"], symbol="bitmap_query_kernel")
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
    # beside row 4: the counted form (what the path launches) and the plain
    # mask + popcount that it replaces on the path
    table, floor_bytes = bucket_table(buckets, M)
    for row in table:
        print(f"  bucket {row}")
    forms = {
        "row 4, staged": lambda: [bitmap_ops.bulk_program(aug, *b[2:])
                                  for b in buckets],
        "counted, staged": lambda: [
            bitmap_ops.bulk_program_counted(aug, n, *b[2:])
            for b in buckets]}
    staged_wave("bulk_program", forms, aug, buckets)
    rows4 = [bitmap_ops.bulk_program(aug, *b[2:]) for b in buckets]
    bulk_beside(torch, "bulk_program", forms, rows4,
                lambda r: policy.mask_tail(r, n), aug.shape[1] * floor_bytes,
                records[-1])
    records[-1]["buckets"] = table
    del rows4

    # ---- 6. where the time goes -------------------------------------------
    seen = {}
    prof = profile("warm wave", *device_profile(
        torch, lambda: db.query_many(wave).materialize(), 1, seen))
    print(f"  warm wave: {launches_named(seen, 'elementwise')} elementwise "
          f"and {launches_named(seen, 'reduce')} reduction launches (the "
          "composite's pass; the reorder)")
    # the bucket path alone: one counted launch a bucket (its counter),
    # with the plain tail mask and popcount made to raise; then under the
    # profiler, which must see no kernel but bulk_staged_kernel and the
    # count memsets (it can miss launches: up to three sessions until it
    # sees one a bucket; the count it saw is printed)
    cuda_run = backends.get_backend("cuda").run_program
    plain_fns = [(mod, fn) for mod in (policy, kref)
                 for fn in ("popcount", "tail_mask", "mask_tail")
                 if hasattr(mod, fn)]
    saved = [getattr(mod, fn) for mod, fn in plain_fns]

    def plain_on_card(*args, **kwargs):
        raise SystemExit("bucket path: a plain tail mask or popcount ran "
                         "on the card")

    launched = bitmap_ops.bulk_program.launches
    try:
        for mod, fn in plain_fns:
            setattr(mod, fn, plain_on_card)
        for b in buckets:
            cuda_run(aug, n, *b[2:])
        torch.cuda.synchronize()
    finally:
        for (mod, fn), was in zip(plain_fns, saved):
            setattr(mod, fn, was)
    if bitmap_ops.bulk_program.launches - launched != len(buckets):
        raise SystemExit(f"bucket path: {bitmap_ops.bulk_program.launches}"
                         f" - {launched} bulk_program launches for "
                         f"{len(buckets)} buckets")
    for _ in range(3):
        seen = {}
        bucket_ms = device_profile(torch, lambda: [
            cuda_run(aug, n, *b[2:]) for b in buckets], 1, seen)[1]
        if launches_named(seen, "bulk_staged_kernel") >= len(buckets):
            break
    other = {k: v for k, v in seen.items() if "bulk_staged_kernel" not in k
             and "memset" not in k.lower()}
    if other:
        raise SystemExit(f"bucket path: the profiler saw {seen}; want "
                         f"bulk_staged_kernel launches and memsets only")
    print(f"bucket path of the wave ({len(buckets)} buckets, one counted "
          f"launch each, no plain mask or popcount): {bucket_ms} ms on the "
          f"card, kernels {seen} (the profiler saw "
          f"{launches_named(seen, 'bulk_staged_kernel')} of {len(buckets)} "
          f"launches)")
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
        "launches": launches, "warm_wave_profile": prof,
        "bucket_path_ms": bucket_ms}}))

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
    torch.cuda.reset_peak_memory_stats()        # phase 20 reads phase 7's
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
    prompts = serve_prompts(torch, cfg, args.seed).to(dev)
    # greedy generation counted, then prefill and decode timed apart;
    # layers 0 and L-1 captured by hooks
    lm = lm_serving(torch, tstep, attention, params, cfg,
                    {"tokens": prompts}, LM_STEPS, zero_counts, counted,
                    "lm", (0, cfg.num_layers - 1))
    prefill, decode, captured = lm["prefill"], lm["decode"], lm["captured"]
    kernel_logits = lm["kernel_logits"]
    lm7 = serve_record(torch, prompts, lm)
    layer_err = check_layers(attention, captured,
                             tmodel.layer_windows(cfg), "lm check")

    # the same prefill with the plain attention swapped in (here only)
    logit_checks = logit_route_checks(
        torch, tmodel, tflash, attention, cfg, prefill, params,
        {"tokens": prompts}, kernel_logits, "lm check")

    # the kernel at the path's shape, beside its plain version and SDPA
    fq, fk, fv, _, fo = captured[0]
    B_, S_, H_, hd_ = fq.shape
    sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (fq, fk, fv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_err = max_abs_err(sdpa(sq, sk, sv, is_causal=True,
                                enable_gqa=True).transpose(1, 2), fo)
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
           nbytes, flops, 10, count=lm["launches"]["flash_attention_fwd"],
           tol=attn_tol(fo, torch.bfloat16), peak_ops=PEAK_BF16,
           library=lambda: sdpa(sq, sk, sv, is_causal=True, enable_gqa=True))

    # where the time goes: one prefill, one decode step.  The prefill must
    # launch the flash kernel once per layer (the wrapper's count), all on
    # the tensor cores: the C entry launches flash_fwd_wgmma alone (its
    # count at the launch site), and the profiler never sees
    # flash_fwd_kernel (what it saw of flash_fwd_wgmma is printed: it
    # loses records, PERF.md section 7).
    flash_fn = attention.flash_attention_fwd
    for _ in range(3):          # the profiler now and then misses launches
        seen = {}
        flash_fn.launches = 0
        reading, launched = route_launches(
            torch, attention, lambda: device_profile(
                torch, lambda: prefill(params, {"tokens": prompts}), 1, seen))
        lm_prof = {"prefill": profile(
            f"one prefill ({LM_BATCH} x {LM_PROMPT})", *reading)}
        if launches_named(seen, "flash_fwd") >= cfg.num_layers:
            break
    flash_kernels = {sym: launches_named(seen, sym)
                     for sym in ("flash_fwd_wgmma", "flash_fwd_kernel")}
    print(f"lm check: the profiled prefill launched the flash wrapper "
          f"{flash_fn.launches} times, the C entry {launched}; the profiler "
          f"saw {flash_kernels}")
    if (flash_fn.launches != cfg.num_layers
            or launched != {n: cfg.num_layers * (n == "flash_fwd_wgmma")
                            for n in attention.KERNELS}
            or flash_kernels["flash_fwd_kernel"]):
        raise SystemExit(f"prefill: want {cfg.num_layers} flash launches, all "
                         f"tensor-core, saw {flash_fn.launches}, "
                         f"{launched} and {flash_kernels}")
    lm_prof["prefill"]["flash_kernels"] = flash_kernels
    logits, cache = prefill(params, {"tokens": prompts})
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    lm_prof["decode"] = profile("one decode step", *device_profile(
        torch, lambda: decode(params, {"tokens": nxt, "cache": cache})))
    print(json.dumps({"lm_path": {
        "arch": cfg.name, "params": nparam, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "steps": LM_STEPS, "init_s": init_s,
        "greedy_first_s": lm["gen_s"], "prefill_ms": lm["prefill_ms"],
        "decode_ms_per_step": lm["decode_ms"],
        "generated_tokens_per_s": lm["tok_s"], "launches": lm["launches"],
        "layer_checks": layer_err, "logit_checks": logit_checks,
        "profile": lm_prof}}))

    # ---- 8. the durable main path ------------------------------------------
    del params, cache, logits, prefill, decode, captured, fq, fk, fv, fo, sq
    del sk, sv, kernel_logits, prompts, lm
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
    storm_11a = service_path(torch, dev, sdb, host_blocks, wave, mix, p3,
                             zero_counts, read_counts, read_waves,
                             repro_torch, BitmapDB, tstep, policy, records,
                             sync_times)

    # ---- 12. the shard fabric on the card ---------------------------------
    fabric_path(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
                read_waves, BitmapDB, records)

    # ---- 13. the training path on the card --------------------------------
    # phase 3's answers wait on the host for phase 14
    p3_host = {k: p3[k].cpu() for k in ("rows", "counts", "packed")}
    del sdb, p3
    batch._AUG_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train: {torch.cuda.memory_allocated()} bytes still allocated "
          "after phase 12")
    train_rec = training_path(torch, dev, args.seed, zero_counts, counted,
                              read_waves, kernel, records)
    restart_path(torch, dev, args.seed)

    # ---- 14. the analysis and the lock witness on the card ---------------
    gc.collect()
    torch.cuda.empty_cache()
    p3 = {k: v.to(dev) for k, v in p3_host.items()}
    del p3_host
    witness_path(torch, dev, host_blocks, wave, p3, zero_counts, read_counts,
                 read_waves, repro_torch, BitmapDB, policy, sync_times,
                 storm_11a)
    del p3

    # ---- 15. sliding windows and the VLM prefix on the card --------------
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    window_serving(torch, dev, args.seed, zero_counts, counted, kernel)
    vlm_serving(torch, dev, args.seed, zero_counts, counted)
    window_training(torch, dev, args.seed, zero_counts, counted, kernel)
    print(f"phase 15 took {time.perf_counter() - t15} s")

    # ---- 16. the MoE, SSM and hybrid families on the card ----------------
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    refs = {}                       # phase 21's references
    moe_serving(torch, dev, args.seed, zero_counts, counted, kernel, refs)
    ssm_serving(torch, dev, args.seed, zero_counts, counted)
    hybrid_serving(torch, dev, args.seed, zero_counts, counted, kernel)
    print(f"phase 16 took {time.perf_counter() - t16} s")

    # ---- 17. the encoder-decoder, and training the families --------------
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    encdec_serving(torch, dev, args.seed, zero_counts, counted, kernel,
                   records, refs)
    encdec_training(torch, dev, args.seed, zero_counts, counted, kernel,
                    records, refs)
    moe_training(torch, dev, args.seed, zero_counts, counted, kernel,
                 records, refs)
    ssm_training(torch, dev, args.seed, zero_counts, counted, SSM_ARCH,
                 "ssm train")
    ssm_training(torch, dev, args.seed, zero_counts, counted, HYBRID_ARCH,
                 "hybrid train", ("layers.0.wq", "layers.0.wk", "layers.0.wv"),
                 {"layer 1 (local)": lambda p: p.layers[1].attn_core,
                  "layer 16 (global)": lambda p: p.layers[16].attn_core},
                 kernel=kernel, records=records)
    print(f"phase 17 took {time.perf_counter() - t17} s")

    # ---- 18. the dry run, held against the card --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_path(torch, dev, args.seed, zero_counts, counted)

    # ---- 19. the multi-card training path ---------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    mesh_training(torch, args.seed, train_rec, records)

    # ---- 20. serving across cards ----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    mesh_serving(torch, args.seed, lm7, big_serving(
        torch, dev, args.seed, zero_counts, counted, kernel), records, t20)

    # ---- 21. the MoE and the encoder-decoder across cards ----------------
    gc.collect()
    torch.cuda.empty_cache()
    families_across_cards(torch, args.seed, refs, records,
                          time.perf_counter())

    # ---- 22. ulysses_attn and seq_sharded across cards --------------------
    gc.collect()
    torch.cuda.empty_cache()
    sequence_parallel(torch, dev, args.seed, zero_counts, counted, kernel,
                      train_rec["mesh_reference"], records)

    # ---- 23, 24. the SSM and hybrid families across cards, without and
    # with the sequence options (one launch of ranks) ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    families_across_cards(torch, args.seed, ssm_references(
        torch, dev, args.seed, zero_counts, counted), records, t23,
        (23, 24), kernel)

    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--serve-rank" in sys.argv:
        ap_ = argparse.ArgumentParser()
        for a_, t_ in (("--serve-rank", int), ("--serve-world", int),
                       ("--serve-port", int), ("--serve-work", str),
                       ("--serve-jobs", str), ("--seed", int)):
            ap_.add_argument(a_, type=t_, required=True)
        sys.exit(serve_rank(ap_.parse_args()))
    if "--mesh-rank" in sys.argv:
        ap_ = argparse.ArgumentParser()
        for a_, t_ in (("--mesh-rank", int), ("--mesh-world", int),
                       ("--mesh-port", int), ("--mesh-work", str),
                       ("--mesh-shape", str), ("--mesh-layers", int),
                       ("--seed", int)):
            ap_.add_argument(a_, type=t_, required=True)
        ap_.add_argument("--mesh-restore", action="store_true")
        sys.exit(mesh_rank(ap_.parse_args()))
    sys.exit(main())
