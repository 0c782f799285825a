// cam_match: records (N, W) int32 x keys (M,) int32 -> record-major match
// bits (N, ceil(M/32)) uint32, packed LSB-first along the key axis.
//
// Replaces the TPU kernel src/repro/kernels/cam_match.py::cam_match
// (_cam_match_kernel), which ORs per-word equality over a VMEM tile of
// 256 records x 1024 keys and packs the bool matrix with a weighted sum.
//
// Bound on Hopper: the function is bounded by bytes, N*W*4 + N*M/8 moved.
// It needs no N*W*M compares: a table from a word's value to the packed
// mask of the keys it equals gives a record's bits with N*W*M/32 ORs in
// all.  This brute-force design does compare every word with every key
// (2*N*W*M integer operations, about 5x the byte time at W = 32, M = 256),
// so its own floor is operations and shared-memory loads; a table-lookup
// kernel is later perf work.
//
// Design: a block stages a tile of REC_TILE records in shared memory with
// coalesced loads; each warp owns one 32-key word j, lane i holds key
// 32*j + i in a register and ORs its W equality tests for one record, and
// __ballot_sync turns the 32 lanes' answers into that record's packed word
// directly (lane i -> bit i, the LSB-first order of ref.pack_bits).  Record
// words are read from shared memory at one address per warp (a broadcast,
// no bank conflicts).  Ragged edges are masked by bounds: records past N
// are never stored, keys past M are forced to no-match (the same bits as
// padding with the key sentinel).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // key words per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void cam_match_kernel(const int32_t* __restrict__ records,
                                 const int32_t* __restrict__ keys,
                                 uint32_t* __restrict__ out,
                                 long long n, int w, long long m,
                                 long long mw, int rec_tile) {
  extern __shared__ int32_t tile[];   // rec_tile x w record words
  const long long r0 = (long long)blockIdx.x * rec_tile;
  const int rows = (int)min((long long)rec_tile, n - r0);
  const int32_t* src = records + r0 * w;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) tile[i] = src[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.y * WARPS + warp;   // key word
  if (j >= mw) return;                 // whole warp: j is warp-uniform
  const long long k = j * 32 + lane;
  const bool valid = k < m;
  const int32_t key = valid ? keys[k] : 0;

  uint32_t mine = 0;                   // lane t: word of record base + t
  for (int r = 0; r < rows; ++r) {
    const int32_t* rec = tile + r * w;
    bool hit = false;
#pragma unroll 8
    for (int x = 0; x < w; ++x) hit |= (rec[x] == key);
    const uint32_t word = __ballot_sync(FULL, hit && valid);
    const int t = r & 31;
    if (t == lane) mine = word;
    if (t == 31 || r == rows - 1) {
      const long long rec_idx = r0 + (r - t) + lane;
      if (lane <= t) out[rec_idx * mw + j] = mine;
    }
  }
}

}  // namespace

extern "C" int cam_match_launch(const void* records, const void* keys,
                                void* out, long long n, long long w,
                                long long m, void* stream) {
  const long long mw = (m + 31) / 32;
  if (n == 0 || mw == 0) return (int)cudaGetLastError();
  // records per block: up to 64, while the tile fits 48 KB of shared memory
  int rec_tile = 64;
  if (w > 0 && w * rec_tile * 4 > 48 * 1024) rec_tile = (int)((48 * 1024) / (w * 4));
  if (rec_tile < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + rec_tile - 1) / rec_tile),
            (unsigned)((mw + WARPS - 1) / WARPS));
  size_t smem = (size_t)rec_tile * (size_t)w * sizeof(int32_t);
  cam_match_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)records, (const int32_t*)keys, (uint32_t*)out, n,
      (int)w, m, mw, rec_tile);
  return (int)cudaGetLastError();
}
