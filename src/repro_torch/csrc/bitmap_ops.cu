// Fused bitmap query execution: bitmap_query and bulk_program.
//
// ---- bitmap_query -------------------------------------------------------
// rows (K, Nw) uint32, invert (K,) int32 -> result (Nw,) uint32 =
// AND over k of (invert_k ? ~rows_k : rows_k), and its popcount added into
// count (one int32, zeroed by the caller).
//
// Replaces the TPU kernel src/repro/kernels/bitmap_ops.py::bitmap_query
// (_query_kernel), which carries the popcount across its sequential grid in
// an SMEM scalar.  Hopper blocks run in parallel and in no order, so here
// each block reduces its popcounts with warp reductions and adds them once
// into the count with an integer atomicAdd: integer addition is exact in
// any order, so the count is deterministic.
//
// Bound on Hopper: memory, (K + 1) * Nw * 4 bytes.  On the serving path the
// rows were just gathered (planner: packed[sel]) and sit in L2, so at one
// 2^20-word row the time is launch ramp and load latency, not the HBM rate.
// Design: fat blocks, one wave at that size.  A block of 256 threads
// covers QW = 4096 words, 16 per thread, THREADS apart (each load of a warp
// is one coalesced 128-byte run); the grid is ceil(Nw / QW) blocks.  The K
// invert flags go to shared memory as xor masks once per block (in chunks
// of QFLAGS rows for larger K).  A thread issues the loads of four rows
// before it folds them, without bounds checks in every block but the last.
// These are 4-byte loads, so any contiguous view and any Nw take the same
// path: a 16-byte (uint4) instance for aligned rows measured no faster on
// the card at the serving path's pass (PERF.md).  One atomicAdd per block:
// 256 at Nw = 2^20.
//
// ---- bulk_program -------------------------------------------------------
// aug (S, M+1, Nw) uint32 (all-ones identity row at M of every segment;
// S = 1 for the 2-D launch), sels/invs (Q, G, P, L) int32, post (Q, G, P)
// uint32 xor masks -> rows (S, Q, Nw) uint32: OR over g of AND over p of
// [(AND over l of aug[s, sel] ^ (inv ? ~0 : 0)) ^ post].  Four forms share
// one C entry (bulk_program_launch): the 2-D rows with tails NOT masked
// (the TPU kernel's function); the stacked rows, segment s masked past
// nrecs[s]; and the counted twin of each, masked past the record count
// (2-D: num_records) with counts (S, Q) int32, the popcount of each row.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_ops.py::bulk_program
// (_bulk_kernel), which holds a whole (M+1, BN) word tile of the index in
// VMEM and serves every query of the bucket from it; its callers then mask
// the tail and popcount (src/repro/engine/bulk.py::run_program_pallas),
// which the counted forms fuse into the epilogue.  The stacked launch
// replaces the reference's segment-stacked executor, which vmaps the bucket
// body over the segment axis (src/repro/engine/batch.py:155-165).
//
// Bound on Hopper: memory, the distinct operand rows a bucket reads plus
// S * Q * Nw * 4 bytes written.  A Hopper block has at most 227 KB of
// shared memory, far less than the TPU's (M+1, BN) tile at M = 256, but a
// bucket reads only its D distinct rows (D <= 51 on the serving mix), so
// the redesign stages those alone.
//
// Staged route (bulk_staged_kernel).  The grid is word-tile-major: a CTA
// owns one segment, one chunk of the bucket's queries and every nstrips-th
// word tile from its strip on, so the CTAs sweep the rows side by side.
// The query axis is chunked only as far as it takes to give each resident
// CTA of the card work (a one-tile bucket of Q = 65536 runs on all SMs) or
// to fit a chunk's program (4096 literals) and count partials (1024
// queries) in shared memory.  A prologue reads the chunk's program from
// device memory, builds a map from row id to shared-memory slot (an
// open-addressing hash of the distinct selectors; the identity row M gets
// no slot), picks the tile width from D (the widest power of two up to
// 512 words with two stages of D + 1 rows in 88 KB: two CTAs an SM) and
// rewrites the program as 16-bit literals: the row's word offset in a
// stage and an inversion bit.  A literal on row M reads an all-ones row
// kept at the end of each stage, so the fold has no branch.  The D rows'
// words of each tile are copied into a two-stage ring by cp.async (16-byte
// copies for 16-byte aligned rows with Nw % 4 == 0, 4-byte copies
// otherwise; words past Nw are not copied), tile k + 1 in flight while
// tile k folds, one barrier a tile.  So each distinct row of a chunk is
// read from device memory once per tile, whatever the number of queries
// that select it.  A warp folds 128 consecutive words (4 a lane, one
// 16-byte shared-memory load a literal) of QPI = 4 queries at once, their
// programs in lockstep (4 independent loads in flight): literal -> pass ->
// group in registers, then one 16-byte store per lane and query (the
// fold's latency, not the copies, bounded a version that folded one query
// a warp with a branch on the identity row).  The epilogue masks the tail
// (stacked, counted; only a tile that reaches past the record count pays
// for it), stores, and adds the warp's popcounts into the query's count
// partial in shared memory; each CTA adds its partials into counts with
// one integer atomicAdd per query (zeroed by the C entry on the stream).
// Integer addition is exact in any order: counts are deterministic.  A
// selector outside [0, M] (a caller error: the batch layer checks key
// ranges on the host) folds as the identity row.
//
// Gather route (bulk_gather_kernel): the original body, each literal's
// words gathered from device memory, a block serving THREADS * WPT words
// of one query.  The C entry takes it by shape, when G * P * L exceeds the
// staged program's 4096 literals, or when min(M, chunk queries x G * P *
// L), the most distinct rows a chunk can select, exceeds the 351 rows (and
// the all-ones row) that two stages of 32-word tiles hold.  It adds the
// masked, counted epilogue (one atomicAdd per block).  Its blocks run
// word-major: the queries of one word range are adjacent, so L2 serves a
// row shared by several queries.
//
// This file owns the staged route's constants and plan; its C entry
// bulk_program_plan reports the plan bulk_program_launch takes for a
// bucket on the current device.  tests/torch_checks.py mirrors them for
// the numpy model of the schedule, and the card checks hold that mirror
// against bulk_program_plan.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WPT = 4;          // bulk_program, gather: words per thread
constexpr int QV = 16;          // bitmap_query: words per thread per row
constexpr int QW = THREADS * QV;        // bitmap_query: words per block
constexpr int QFLAGS = 1024;    // bitmap_query: flags staged per chunk
constexpr int MAX_DEVICES = 64;

// A thread's words of row a: w0 + j THREADS + threadIdx.x, j < QV; past nw
// they read as zero (FULL: the whole block lies inside nw, no checks).
template <bool FULL>
__device__ __forceinline__ void query_load(uint32_t (&v)[QV],
                                           const uint32_t* __restrict__ a,
                                           long long nw, long long w0) {
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const long long i = w0 + threadIdx.x + (long long)j * THREADS;
    v[j] = FULL || i < nw ? __ldg(a + i) : 0u;
  }
}

// Fold rows [k0, k0 + kc) into acc.  The pair loop, unrolled twice, issues
// four rows' loads before it folds them.
template <bool FULL>
__device__ __forceinline__ void query_fold(
    uint32_t (&acc)[QV], const uint32_t* __restrict__ rows,
    const uint32_t* flip, long long k0, int kc, long long nw, long long w0) {
  uint32_t va[QV], vb[QV];
  int kk = 0;
#pragma unroll 2
  for (; kk + 1 < kc; kk += 2) {
    query_load<FULL>(va, rows + (k0 + kk) * nw, nw, w0);
    query_load<FULL>(vb, rows + (k0 + kk + 1) * nw, nw, w0);
    const uint32_t fa = flip[kk], fb = flip[kk + 1];
#pragma unroll
    for (int j = 0; j < QV; ++j) acc[j] &= (va[j] ^ fa) & (vb[j] ^ fb);
  }
  if (kk < kc) {
    query_load<FULL>(va, rows + (k0 + kk) * nw, nw, w0);
#pragma unroll
    for (int j = 0; j < QV; ++j) acc[j] &= va[j] ^ flip[kk];
  }
}

__global__ void __launch_bounds__(THREADS)
bitmap_query_kernel(const uint32_t* __restrict__ rows,
                    const int32_t* __restrict__ invert,
                    uint32_t* __restrict__ out, int32_t* __restrict__ count,
                    long long k, long long nw) {
  __shared__ uint32_t flip[QFLAGS];
  __shared__ unsigned warp_sums[THREADS / 32];
  const bool staged = k <= QFLAGS;      // all flags staged once per block
  if (staged)
    for (int i = threadIdx.x; i < k; i += THREADS)
      flip[i] = invert[i] ? 0xffffffffu : 0u;
  const long long w0 = (long long)blockIdx.x * QW;
  uint32_t acc[QV];
#pragma unroll
  for (int j = 0; j < QV; ++j) acc[j] = 0xffffffffu;
  for (long long k0 = 0; k0 < k; k0 += QFLAGS) {
    const int kc = (int)(k - k0 < QFLAGS ? k - k0 : QFLAGS);
    if (!staged) {
      __syncthreads();                  // the last chunk's flags are read
      for (int i = threadIdx.x; i < kc; i += THREADS)
        flip[i] = invert[k0 + i] ? 0xffffffffu : 0u;
    }
    __syncthreads();
    if (w0 + QW <= nw)
      query_fold<true>(acc, rows, flip, k0, kc, nw, w0);
    else
      query_fold<false>(acc, rows, flip, k0, kc, nw, w0);
  }
  unsigned local = 0;
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const long long i = w0 + threadIdx.x + (long long)j * THREADS;
    if (i < nw) {
      out[i] = acc[j];
      local += __popc(acc[j]);
    }
  }
  local = __reduce_add_sync(0xffffffffu, local);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    unsigned v = lane < THREADS / 32 ? warp_sums[lane] : 0u;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v) atomicAdd(count, (int32_t)v);
  }
}

// ---- bulk_program: the staged route ------------------------------------
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;               // ring stages
constexpr int TW_LG = 9;                // widest word tile: 512 words
constexpr int QPI = 4;                  // queries a warp folds at once
constexpr int RING_BYTES = 88 << 10;    // STAGES x (D + 1) rows x tile
constexpr int DCAP = RING_BYTES / (STAGES * 32 * 4) - 1;  // at 32 words
constexpr int HBITS = 10;
constexpr int HCAP = 1 << HBITS;        // hash slots, about 3 DCAP
constexpr int PROG_LITS = 4096;         // a chunk's literals
constexpr int QCAP = 1024;              // a chunk's queries
constexpr uint16_t IDENT = 0x7fff;      // prologue: a literal on row M
constexpr uint16_t INV = 0x8000;        // inverted-literal flag
constexpr int STAGED_SMEM = RING_BYTES + HCAP * 4 + DCAP * 4 + QCAP * 4
                            + 16 + HCAP * 2 + PROG_LITS * 2;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The hash slot of row id key (>= 0), inserting it when new.  The table
// never fills: the C entry takes this route only when a chunk selects at
// most DCAP distinct rows.
__device__ __forceinline__ int hash_insert(int* hkey, int key) {
  unsigned h = ((unsigned)key * 2654435761u) >> (32 - HBITS);
  for (;;) {
    const int cur = ((volatile int*)hkey)[h];
    if (cur == key) return (int)h;
    if (cur == -1) {
      const int prev = atomicCAS(hkey + h, -1, key);
      if (prev == -1 || prev == key) return (int)h;
    }
    h = (h + 1) & (HCAP - 1);
  }
}

// Tail mask of word w for n records.
__device__ __forceinline__ uint32_t tail(uint32_t v, long long n,
                                         long long w) {
  const long long left = n - w * 32;
  return left >= 32 ? v : left <= 0 ? 0u : v & ((1u << left) - 1u);
}

// Sum v over the block into *dst with one atomicAdd (all threads call).
__device__ __forceinline__ void block_count(unsigned v, int32_t* dst) {
  __shared__ unsigned warp_sums[WARPS];
  v = __reduce_add_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned t = lane < WARPS ? warp_sums[lane] : 0u;
    t = __reduce_add_sync(0xffffffffu, t);
    if (lane == 0 && t) atomicAdd(dst, (int32_t)t);
  }
}

// V consecutive words at p (16-byte aligned for V = 4, 8-byte for 2).
template <int V>
__device__ __forceinline__ void load_v(uint32_t (&x)[V], const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 t = *(const uint4*)p;
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = *(const uint2*)p;
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 4)
    *(uint4*)p = make_uint4(x[0], x[1], x[2], x[3]);
  else if constexpr (V == 2)
    *(uint2*)p = make_uint2(x[0], x[1]);
  else
    *p = x[0];
}

// Fold ring tile `tile` (D rows and the all-ones row x tw words, words
// [w0, w0 + tw) of the row) for the chunk's qn queries.  A literal is its
// row's word offset in the stage (the all-ones row's for row M), its top
// bit the inversion, so the fold has no branch.  A warp item is 32 V
// consecutive words of QPI queries, V per lane, whose programs (one bucket
// shape) run in lockstep: each lane has QPI independent loads in flight a
// literal.  MASK: zero the words past n records (only a tile that reaches
// past them pays for it); COUNTED: add each query's popcount into qcount.
// vec_out: rows of out are 16-byte aligned.
template <int V, bool MASK, bool COUNTED>
__device__ __forceinline__ void fold_tile(
    const uint32_t* tile, int tw, const uint16_t* prog,
    const uint32_t* __restrict__ post, uint32_t* __restrict__ out,
    int* qcount, int qn, int g, int p, int l, long long nw, long long w0,
    long long n, bool vec_out) {
  constexpr int SW = 32 * V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int segs = tw / SW, gpl = g * p * l, gp = g * p;
  const int items = (qn + QPI - 1) / QPI * segs;
  const bool cut = MASK && (w0 + tw) * 32 > n;
  for (int it = warp; it < items; it += WARPS) {
    const int qb = it / segs * QPI;
    const int wb = (it % segs) * SW + lane * V;
    const uint16_t* qp[QPI];
#pragma unroll
    for (int j = 0; j < QPI; ++j)       // a query past the chunk: row 0's
      qp[j] = prog + (qb + j < qn ? qb + j : 0) * gpl;  // program, unstored
    uint32_t res[QPI][V];
#pragma unroll
    for (int j = 0; j < QPI; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) res[j][k] = 0;
    for (int gi = 0; gi < g; ++gi) {
      uint32_t grp[QPI][V];
#pragma unroll
      for (int j = 0; j < QPI; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) grp[j][k] = 0xffffffffu;
      for (int pi = 0; pi < p; ++pi) {
        uint32_t acc[QPI][V];
#pragma unroll
        for (int j = 0; j < QPI; ++j)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[j][k] = 0xffffffffu;
        const int base = (gi * p + pi) * l;
#pragma unroll 2
        for (int li = 0; li < l; ++li) {
#pragma unroll
          for (int j = 0; j < QPI; ++j) {
            const uint32_t v = qp[j][base + li];
            const uint32_t flip = 0u - (v >> 15);
            uint32_t x[V];
            load_v<V>(x, tile + (v & IDENT) + wb);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[j][k] &= x[k] ^ flip;
          }
        }
#pragma unroll
        for (int j = 0; j < QPI; ++j) {
          const uint32_t pm = __ldg(post + (qb + j < qn ? qb + j : 0) * gp
                                    + gi * p + pi);
#pragma unroll
          for (int k = 0; k < V; ++k) grp[j][k] &= acc[j][k] ^ pm;
        }
      }
#pragma unroll
      for (int j = 0; j < QPI; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) res[j][k] |= grp[j][k];
    }
    const long long w = w0 + wb;
#pragma unroll
    for (int j = 0; j < QPI; ++j) {
      if (qb + j >= qn) break;
      if (cut) {
#pragma unroll
        for (int k = 0; k < V; ++k) res[j][k] = tail(res[j][k], n, w + k);
      }
      uint32_t* o = out + (qb + j) * nw + w;
      unsigned cnt = 0;
      if (vec_out && w + V <= nw) {
        store_v<V>(o, res[j]);
#pragma unroll
        for (int k = 0; k < V; ++k) cnt += __popc(res[j][k]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (w + k < nw) {
            o[k] = res[j][k];
            cnt += __popc(res[j][k]);
          }
      }
      if (COUNTED) {
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (lane == 0 && cnt) atomicAdd(qcount + qb + j, (int)cnt);
      }
    }
  }
}

// STACKED: aug is (S, M+1, Nw) and segment s is masked past nrecs[s];
// otherwise S = 1 and, when COUNTED, the rows are masked past nrec.
// COUNTED: counts (S, Q) receive each row's popcount.  Block b serves
// chunk b % nchunks, strip (b / nchunks) % nstrips, segment
// b / (nchunks * nstrips).  vec: aug's rows are 16-byte aligned (aug
// 16-byte aligned, Nw % 4 == 0), and so are out's.
template <bool STACKED, bool COUNTED>
__global__ void __launch_bounds__(THREADS, 2)
bulk_staged_kernel(const uint32_t* __restrict__ aug,
                   const int32_t* __restrict__ nrecs, long long nrec,
                   const int32_t* __restrict__ sels,
                   const int32_t* __restrict__ invs,
                   const uint32_t* __restrict__ post,
                   uint32_t* __restrict__ out, int32_t* __restrict__ counts,
                   long long nw, long long nq, int m, int g, int p, int l,
                   long long qc, long long nchunks, long long nstrips,
                   bool vec) {
  constexpr bool MASK = STACKED || COUNTED;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring = (uint32_t*)smem;
  int* hkey = (int*)(smem + RING_BYTES);
  int* rowlist = hkey + HCAP;
  int* qcount = rowlist + DCAP;
  int* nd = qcount + QCAP;
  uint16_t* hslot = (uint16_t*)(nd + 4);
  uint16_t* prog = hslot + HCAP;
  const int tid = threadIdx.x;

  long long b = blockIdx.x;
  const long long chunk = b % nchunks;
  b /= nchunks;
  const long long strip = b % nstrips;
  const long long s = b / nstrips;
  const long long q0 = chunk * qc;
  const int qn = (int)(nq - q0 < qc ? nq - q0 : qc);
  const int gpl = g * p * l;
  const int nlit = qn * gpl;
  aug += s * (long long)(m + 1) * nw;

  // prologue: the chunk's distinct rows, slots and slot program
  for (int i = tid; i < HCAP; i += THREADS) hkey[i] = -1;
  if (COUNTED)
    for (int i = tid; i < qn; i += THREADS) qcount[i] = 0;
  if (tid == 0) nd[0] = 0;
  __syncthreads();
  const int32_t* csel = sels + q0 * gpl;
  const int32_t* cinv = invs + q0 * gpl;
  for (int i = tid; i < nlit; i += THREADS) {
    const int sel = __ldg(csel + i);
    const uint16_t flag = __ldg(cinv + i) ? INV : 0;
    prog[i] = (uint16_t)(flag | ((unsigned)sel < (unsigned)m
                                 ? hash_insert(hkey, sel) : IDENT));
  }
  __syncthreads();
  for (int i = tid; i < HCAP; i += THREADS) {
    const int key = hkey[i];
    if (key >= 0) {
      const int slot = atomicAdd(nd, 1);
      hslot[i] = (uint16_t)slot;
      rowlist[slot] = key;
    }
  }
  __syncthreads();
  // the tile width from D, never wider than the row needs; a stage holds
  // the D rows and an all-ones row (row M's literals read it)
  const int d = nd[0];
  int lg = TW_LG;
  while (lg > 5 && (long long)STAGES * (d + 1) * (4LL << lg) > RING_BYTES)
    --lg;
  while (lg > 5 && (1LL << (lg - 1)) >= nw) --lg;
  const int tw = 1 << lg;
  const uint16_t ones = (uint16_t)(d * tw);
  for (int i = tid; i < nlit; i += THREADS) {
    const uint16_t v = prog[i];
    prog[i] = (uint16_t)((v & INV) | ((v & IDENT) == IDENT
                                      ? ones : hslot[v & IDENT] * tw));
  }
  for (int i = tid; i < STAGES * tw; i += THREADS)
    ring[((i >> lg) * (d + 1) + d) * tw + (i & (tw - 1))] = 0xffffffffu;
  __syncthreads();
  // this CTA's tiles: strip, strip + nstrips, ... (the CTAs of a bucket
  // sweep the rows side by side, as the gather route's blocks do)
  const long long ntiles = (nw + tw - 1) / tw;
  const long long nt = strip < ntiles
                       ? (ntiles - strip + nstrips - 1) / nstrips : 0;

  // copy the words of the D rows of this CTA's k-th tile into its ring
  // stage
  auto issue = [&](long long k) {
    const long long w0 = (strip + k * nstrips) * tw;
    uint32_t* dst = ring + (long long)(k % STAGES) * (d + 1) * tw;
    if (vec) {
      const int lc = lg - 2;                    // 16-byte chunks a row
      for (int c = tid; c < (d << lc); c += THREADS) {
        const int r = c >> lc, j = (c & ((1 << lc) - 1)) << 2;
        if (w0 + j < nw)
          cp_async16(dst + r * tw + j, aug + (long long)rowlist[r] * nw
                                           + w0 + j);
      }
    } else {
      for (int c = tid; c < (d << lg); c += THREADS) {
        const int r = c >> lg, j = c & (tw - 1);
        if (w0 + j < nw)
          cp_async4(dst + r * tw + j, aug + (long long)rowlist[r] * nw
                                          + w0 + j);
      }
    }
  };

  uint32_t* orow = out + (s * nq + q0) * nw;
  const uint32_t* cpost = post + q0 * g * p;
  long long n = nrec;
  if (STACKED) n = __ldg(nrecs + s);
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nt) issue(k);
    cp_async_commit();
  }
  for (long long k = 0; k < nt; ++k) {
    cp_async_wait<STAGES - 2>();                // this thread's tile k copies
    __syncthreads();    // all of tile k landed; all done folding tile k - 1
    if (k + STAGES - 1 < nt) issue(k + STAGES - 1);   // tile k - 1's stage
    cp_async_commit();
    const uint32_t* tile = ring + (long long)(k % STAGES) * (d + 1) * tw;
    const long long w0 = (strip + k * nstrips) * tw;
    if (tw >= 128)
      fold_tile<4, MASK, COUNTED>(tile, tw, prog, cpost, orow, qcount, qn,
                                  g, p, l, nw, w0, n, vec);
    else if (tw == 64)
      fold_tile<2, MASK, COUNTED>(tile, tw, prog, cpost, orow, qcount, qn,
                                  g, p, l, nw, w0, n, vec);
    else
      fold_tile<1, MASK, COUNTED>(tile, tw, prog, cpost, orow, qcount, qn,
                                  g, p, l, nw, w0, n, vec);
  }
  if (COUNTED) {
    __syncthreads();
    int32_t* c = counts + s * nq + q0;
    for (int i = tid; i < qn; i += THREADS)
      if (qcount[i]) atomicAdd(c + i, qcount[i]);
  }
}

// ---- bulk_program: the gather route ------------------------------------
// STACKED and COUNTED as the staged kernel.  Each segment has nq * bpq
// blocks; block j serves query j % nq, word block j / nq (word-major).
template <bool STACKED, bool COUNTED>
__global__ void __launch_bounds__(THREADS)
bulk_gather_kernel(const uint32_t* __restrict__ aug,
                   const int32_t* __restrict__ nrecs, long long nrec,
                   const int32_t* __restrict__ sels,
                   const int32_t* __restrict__ invs,
                   const uint32_t* __restrict__ post,
                   uint32_t* __restrict__ out, int32_t* __restrict__ counts,
                   long long nw, long long bpq, long long nq, int m, int g,
                   int p, int l) {
  long long bid = blockIdx.x;
  const long long s = bid / (nq * bpq);
  bid -= s * nq * bpq;
  aug += s * (long long)(m + 1) * nw;
  const long long q = bid % nq;
  const long long wblk = bid / nq;
  const long long w0 = wblk * (long long)(THREADS * WPT) + threadIdx.x;
  const long long gpl = (long long)g * p * l, gp = (long long)g * p;
  const int32_t* q_sel = sels + q * gpl;
  const int32_t* q_inv = invs + q * gpl;
  const uint32_t* q_post = post + q * gp;
  uint32_t res[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) res[k] = 0;
  for (int gi = 0; gi < g; ++gi) {
    uint32_t grp[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) grp[k] = 0xffffffffu;
    for (int pi = 0; pi < p; ++pi) {
      const long long base = ((long long)gi * p + pi) * l;
      uint32_t acc[WPT];
#pragma unroll
      for (int k = 0; k < WPT; ++k) acc[k] = 0xffffffffu;
      for (int li = 0; li < l; ++li) {
        const int32_t sel = __ldg(q_sel + base + li);
        const uint32_t flip = __ldg(q_inv + base + li) ? 0xffffffffu : 0u;
        if (sel == m) {                 // the all-ones identity row
#pragma unroll
          for (int k = 0; k < WPT; ++k) acc[k] &= ~flip;
          continue;
        }
        const uint32_t* row = aug + (long long)sel * nw;
#pragma unroll
        for (int k = 0; k < WPT; ++k) {
          const long long w = w0 + k * THREADS;
          acc[k] &= (w < nw ? row[w] : 0u) ^ flip;
        }
      }
      const uint32_t pm = __ldg(q_post + gi * p + pi);
#pragma unroll
      for (int k = 0; k < WPT; ++k) grp[k] &= acc[k] ^ pm;
    }
#pragma unroll
    for (int k = 0; k < WPT; ++k) res[k] |= grp[k];
  }
  long long n = nrec;
  if (STACKED) n = __ldg(nrecs + s);
  uint32_t* o = out + (s * nq + q) * nw;
  unsigned cnt = 0;
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const long long w = w0 + k * THREADS;
    if (w >= nw) continue;
    const uint32_t v = STACKED || COUNTED ? tail(res[k], n, w) : res[k];
    o[w] = v;
    cnt += __popc(v);
  }
  if (COUNTED) block_count(cnt, counts + s * nq + q);
}

// Resident CTAs of a staged instance on the current device (cached per
// device; the first call also lifts its dynamic shared-memory limit).
template <bool STACKED, bool COUNTED>
cudaError_t staged_ctas(int* ctas) {
  static int cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && cache[dev]) {
    *ctas = cache[dev];
    return cudaSuccess;
  }
  auto kern = bulk_staged_kernel<STACKED, COUNTED>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           STAGED_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                    STAGED_SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *ctas = sms * per_sm;
  if (dev < MAX_DEVICES) cache[dev] = *ctas;
  return cudaSuccess;
}

// The staged plan of a bucket for `ctas` resident CTAs: query chunks of qc
// and strips of word tiles.  False when the bucket takes the gather route.
bool staged_plan(long long s, long long m, long long nw, long long q,
                 long long gpl, long long ctas, long long* qc,
                 long long* nchunks, long long* nstrips) {
  if (gpl > PROG_LITS) return false;
  const long long cap = QCAP < PROG_LITS / gpl ? QCAP : PROG_LITS / gpl;
  const long long tiles = (nw + (1 << TW_LG) - 1) >> TW_LG;  // widest
  long long chunks = (q + cap - 1) / cap;
  if (s * tiles * chunks < ctas) {          // too little work: split queries
    const long long want = (ctas + s * tiles - 1) / (s * tiles);
    chunks = want < q ? (want > chunks ? want : chunks) : q;
  }
  *qc = (q + chunks - 1) / chunks;
  *nchunks = (q + *qc - 1) / *qc;
  const long long want = (ctas + s * *nchunks - 1) / (s * *nchunks);
  *nstrips = want < tiles ? want : tiles;
  const long long most = *qc * gpl < m ? *qc * gpl : m;  // distinct rows
  return most <= DCAP;
}

// The plan of a bucket on the current device, as bulk_launch takes it:
// plan = {1 staged / 0 gather, resident CTAs, qc, chunks, strips}.
template <bool STACKED, bool COUNTED>
int plan_of(long long s, long long m, long long nw, long long q,
            long long gpl, long long* plan) {
  int ctas = 0;
  const cudaError_t e = staged_ctas<STACKED, COUNTED>(&ctas);
  if (e != cudaSuccess) return (int)e;
  plan[1] = ctas;
  plan[0] = staged_plan(s, m, nw, q, gpl, ctas, plan + 2, plan + 3,
                        plan + 4);
  return (int)cudaSuccess;
}

template <bool STACKED, bool COUNTED>
int gather_launch(const uint32_t* aug, const int32_t* nrecs, long long nrec,
                  const int32_t* sels, const int32_t* invs,
                  const uint32_t* post, uint32_t* out, int32_t* counts,
                  long long s, long long nw, long long q, int m, int g, int p,
                  int l, cudaStream_t stream) {
  const long long span = (long long)THREADS * WPT;      // words per block
  const long long bpq = (nw + span - 1) / span;         // blocks per query
  if (q > 0x7fffffffLL / bpq || s > 0x7fffffffLL / (q * bpq))
    return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)(s * q * bpq);
  bulk_gather_kernel<STACKED, COUNTED><<<grid, THREADS, 0, stream>>>(
      aug, nrecs, nrec, sels, invs, post, out, counts, nw, bpq, q, m, g, p,
      l);
  return (int)cudaGetLastError();
}

// The staged route when the bucket's shape allows it, else the gather
// route.
template <bool STACKED, bool COUNTED>
int bulk_launch(const uint32_t* aug, const int32_t* nrecs, long long nrec,
                const int32_t* sels, const int32_t* invs,
                const uint32_t* post, uint32_t* out, int32_t* counts,
                long long s, long long m1, long long nw, long long q,
                long long g, long long p, long long l, cudaStream_t stream) {
  const int m = (int)(m1 - 1);
  long long plan[5] = {0, 0, 0, 0, 0};
  const int e = plan_of<STACKED, COUNTED>(s, m, nw, q, g * p * l, plan);
  if (e != (int)cudaSuccess) return e;
  const long long qc = plan[2], nchunks = plan[3], nstrips = plan[4];
  if (!plan[0])
    return gather_launch<STACKED, COUNTED>(aug, nrecs, nrec, sels, invs,
                                           post, out, counts, s, nw, q, m,
                                           (int)g, (int)p, (int)l, stream);
  if (s * nchunks > 0x7fffffffLL / nstrips)
    return (int)cudaErrorInvalidConfiguration;
  const bool vec = (uintptr_t)aug % 16 == 0 && (uintptr_t)out % 16 == 0
                   && nw % 4 == 0;
  bulk_staged_kernel<STACKED, COUNTED>
      <<<(unsigned)(s * nchunks * nstrips), THREADS, STAGED_SMEM, stream>>>(
          aug, nrecs, nrec, sels, invs, post, out, counts, nw, q, m, (int)g,
          (int)p, (int)l, qc, nchunks, nstrips, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bitmap_query_launch(const void* rows, const void* invert,
                                   void* out, void* count, long long k,
                                   long long nw, void* stream) {
  if (nw == 0) return (int)cudaGetLastError();
  bitmap_query_kernel<<<(unsigned)((nw + QW - 1) / QW), THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)invert, (uint32_t*)out,
      (int32_t*)count, k, nw);
  return (int)cudaGetLastError();
}

// Every form of bulk_program: nrecs null for the 2-D launch (S = 1),
// counts null for the uncounted forms (whose 2-D rows are not masked);
// nrec is the 2-D counted form's record count.  The route is picked by
// shape (bulk_launch).
extern "C" int bulk_program_launch(const void* aug, const void* nrecs,
                                   const void* sels, const void* invs,
                                   const void* post, void* out, void* counts,
                                   long long nrec, long long s, long long m1,
                                   long long nw, long long q, long long g,
                                   long long p, long long l, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (counts != nullptr && s * q > 0) {
    const cudaError_t e = cudaMemsetAsync(counts, 0, s * q * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (s == 0 || nw == 0 || q == 0) return (int)cudaGetLastError();
  const uint32_t* a = (const uint32_t*)aug;
  const int32_t* nr = (const int32_t*)nrecs;
  const int32_t *se = (const int32_t*)sels, *iv = (const int32_t*)invs;
  const uint32_t* po = (const uint32_t*)post;
  uint32_t* o = (uint32_t*)out;
  int32_t* c = (int32_t*)counts;
  if (nrecs != nullptr) {
    if (counts != nullptr)
      return bulk_launch<true, true>(a, nr, 0, se, iv, po, o, c, s, m1, nw, q,
                                     g, p, l, st);
    return bulk_launch<true, false>(a, nr, 0, se, iv, po, o, nullptr, s, m1,
                                    nw, q, g, p, l, st);
  }
  if (counts != nullptr)
    return bulk_launch<false, true>(a, nullptr, nrec, se, iv, po, o, c, 1, m1,
                                    nw, q, g, p, l, st);
  return bulk_launch<false, false>(a, nullptr, 0, se, iv, po, o, nullptr, 1,
                                   m1, nw, q, g, p, l, st);
}

// The plan bulk_program_launch takes for a bucket of S segments of M+1
// rows of Nw words and G * P * L = gpl literals a query, on the current
// device: plan (5 int64) = {1 staged / 0 gather route, resident CTAs, chunk
// queries qc, chunks, strips} (the last three meaningful on the staged
// route).  Launches nothing.
extern "C" int bulk_program_plan(long long s, long long m1, long long nw,
                                 long long q, long long gpl,
                                 long long stacked, long long counted,
                                 void* plan) {
  long long* out = (long long*)plan;
  const long long m = m1 - 1;
  if (stacked)
    return counted ? plan_of<true, true>(s, m, nw, q, gpl, out)
                   : plan_of<true, false>(s, m, nw, q, gpl, out);
  return counted ? plan_of<false, true>(1, m, nw, q, gpl, out)
                 : plan_of<false, false>(1, m, nw, q, gpl, out);
}
