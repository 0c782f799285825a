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
// aug (M+1, Nw) uint32 (all-ones identity row at M), sels/invs (Q, G, P, L)
// int32, post (Q, G, P) uint32 xor masks -> rows (Q, Nw) uint32:
// OR over g of AND over p of [(AND over l of aug[sel] ^ (inv ? ~0 : 0))
// ^ post].  Tail bits past the record count are not masked here.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_ops.py::bulk_program
// (_bulk_kernel), which holds a whole (M+1, BN) word tile of the index in
// VMEM and gathers every literal from it.  A Hopper block has at most
// 227 KB of shared memory, far less than that tile at M = 256, so the
// gathers go to device memory instead.
//
// Bound on Hopper: memory, the distinct operand rows a bucket reads plus
// Q * Nw * 4 bytes written.  A thread serves WPT words of one query, THREADS
// apart, so neighbouring threads read neighbouring words of the same
// operand row (each gather is coalesced) and every selector load feeds WPT
// independent gathers in flight.  The query axis is folded into grid.x
// (blocks [q * bpq, (q + 1) * bpq) serve query q), so a bucket of any Q
// launches: grid.y would stop at 65535.  The program is read from device
// memory as it is used: all threads of a block read the same selector, a
// broadcast that L1 serves, so a program of any G*P*L runs without a
// shared-memory cap.  A literal on the identity row M (the all-ones row of
// the contract: pad literals, pad groups, pad queries) is folded without a
// load.  Literals, post masks, passes and groups fold in registers, one
// store per result word.  A row shared by several queries of a bucket is
// read again by each (L2 catches part of that).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WPT = 4;          // bulk_program: words per thread
constexpr int QV = 16;          // bitmap_query: words per thread per row
constexpr int QW = THREADS * QV;        // bitmap_query: words per block
constexpr int QFLAGS = 1024;    // bitmap_query: flags staged per chunk

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

__global__ void bulk_program_kernel(const uint32_t* __restrict__ aug,
                                    const int32_t* __restrict__ sels,
                                    const int32_t* __restrict__ invs,
                                    const uint32_t* __restrict__ post,
                                    uint32_t* __restrict__ out,
                                    long long nw, long long bpq, int m,
                                    int g, int p, int l) {
  const long long q = blockIdx.x / bpq;
  const long long w0 =
      (blockIdx.x % bpq) * (long long)(THREADS * WPT) + threadIdx.x;
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
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const long long w = w0 + k * THREADS;
    if (w < nw) out[q * nw + w] = res[k];
  }
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

extern "C" int bulk_program_launch(const void* aug, const void* sels,
                                   const void* invs, const void* post,
                                   void* out, long long m1, long long nw,
                                   long long q, long long g, long long p,
                                   long long l, void* stream) {
  if (nw == 0 || q == 0) return (int)cudaGetLastError();
  const long long span = (long long)THREADS * WPT;      // words per block
  const long long bpq = (nw + span - 1) / span;         // blocks per query
  if (q > 0x7fffffffLL / bpq) return (int)cudaErrorInvalidConfiguration;
  bulk_program_kernel<<<(unsigned)(q * bpq), THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)aug, (const int32_t*)sels, (const int32_t*)invs,
      (const uint32_t*)post, (uint32_t*)out, nw, bpq, (int)(m1 - 1), (int)g,
      (int)p, (int)l);
  return (int)cudaGetLastError();
}
