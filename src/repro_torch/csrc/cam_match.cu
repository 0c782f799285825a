// cam_match: records (N, W) int32 x keys (M,) int32 -> record-major match
// bits (N, ceil(M/32)) uint32, packed LSB-first along the key axis.
//
// Replaces the TPU kernel src/repro/kernels/cam_match.py::cam_match
// (_cam_match_kernel), which ORs per-word equality over a VMEM tile of
// 256 records x 1024 keys and packs the bool matrix with a weighted sum.
//
// Bound on Hopper: bytes.  The function moves N*W*4 + N*M/8 bytes and needs
// only N*W*M/32 ORs: at the main path's (2^22, 32) x 256 that is 0.20 ms at
// 3.35 TB/s against 0.03 ms of ORs at 6.7e13 op/s.  A brute-force design that
// compares every word with every key (2*N*W*M operations) has its own floor
// of ~1 ms there, so this kernel does not compare: it looks up.
//
// Design: the paper's words are 8 bits, so a table of T = 256 entries maps a
// word's value x to the packed mask of the keys equal to x.  grid.y splits the
// key words into ranges of RW = 4*RW4 words (at most 32); each block builds its
// range's table in shared memory once, with atomicOr from the keys, and walks
// record tiles in a grid-stride loop.  Keys outside [0, T) (any other int32
// value, the key sentinel -2 included) go to a short outlier list in shared
// memory, counted with a shared atomicAdd; only a block whose list is non-empty
// compares record words with it, so the semantics stay exact for every int32
// key and record value (the record sentinel -1 is out of the table's range and
// equals no listed key).  Keys past M set no bit.
//
// What bounds the design is shared memory: each record word reads a whole table
// entry (M/8 bytes), at random rows.  Where it fits (M <= 256: 64 KB) the table
// is kept in 8 copies interleaved 16 bytes by 16 bytes, copy k in bank quad k
// alone, and thread t reads copy t % 8: the 16-byte table reads of a quarter
// warp never conflict (the random rows of one copy collide in the quads).
// Larger ranges keep one copy with an odd row stride.  Per tile
// of 256 records the block stages up to 32 words of each record in shared
// memory (rows padded to 36 words: 16-byte stores and per-record 16-byte reads
// without conflicts); when rows are whole and 16-byte aligned, the next tile's
// records are loaded into registers with coalesced 16-byte loads while this
// tile is looked up.  Each thread ORs its record's table entries in
// registers, and the block writes the tile's output rows through shared
// memory as one coalesced span.  __launch_bounds__(R, 1) lets ptxas keep the
// accumulators and the prefetched records in registers (without the minimum
// it trades them to the stack for occupancy).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 256;                // table entries: 8-bit words
constexpr int R = 256;                // records per tile = threads per block
constexpr int WC = 32;                // record words staged per pass
constexpr int TS = WC + 4;            // staged row stride (words): 16-byte
                                      // rows, 8 rows over all 8 bank quads

// Table layout for ranges of RW4 uint4 per entry: REP copies interleaved
// uint4 by uint4, so that copy k lies in bank quad k alone and the 8
// threads of a quarter warp (copies tid % 8) never conflict, when the
// copies fit (RW4 <= 2: 64 KB); else one copy with an odd row stride, so
// random rows at least spread over all 8 quads.
template <int RW4>
struct Table {
  static constexpr int REP = RW4 <= 2 ? 8 : 1;
  static constexpr int ROW = REP == 8 ? RW4 : (RW4 | 1);   // uint4 per row
  static constexpr int UINT4S = T * ROW * REP;
  // uint4 index of chunk c of entry v in copy k
  __device__ static int at(int v, int c, int k) {
    return (v * ROW + c) * REP + (REP == 8 ? k : 0);
  }
};

// OR the table entry of word v into acc (this thread reads copy k);
// outlier hits go to the thread's staging row ``mine`` (a runtime index
// into acc would move acc out of registers).
template <int RW4>
__device__ __forceinline__ void look(int32_t v, uint32_t (&acc)[4 * RW4],
                                     const uint4* table, int k,
                                     const int32_t* okey, const int32_t* obit,
                                     int nout, uint32_t* mine) {
  if ((uint32_t)v < (uint32_t)T) {
#pragma unroll
    for (int c = 0; c < RW4; ++c) {
      const uint4 t4 = table[Table<RW4>::at(v, c, k)];
      acc[4 * c + 0] |= t4.x; acc[4 * c + 1] |= t4.y;
      acc[4 * c + 2] |= t4.z; acc[4 * c + 3] |= t4.w;
    }
  }
  for (int o = 0; o < nout; ++o)
    if (v == okey[o]) mine[obit[o] >> 5] |= 1u << (obit[o] & 31);
}

// This thread's share of tile tt's records (whole 16-byte rows of w4
// uint4), coalesced: pre[j] holds uint4 number tid + j*R of the tile.
__device__ __forceinline__ void fetch(uint4 (&pre)[WC / 4],
                                      const int32_t* records, long long n,
                                      int w, int w4, long long tt, int tid) {
  const long long r0 = tt * R;
  const int total = (int)min((long long)R, n - r0) * w4;
  const uint4* src = reinterpret_cast<const uint4*>(records + r0 * w);
#pragma unroll
  for (int j = 0; j < WC / 4; ++j)
    if (tid + j * R < total) pre[j] = src[tid + j * R];
}

template <int RW4>
__global__ void __launch_bounds__(R, 1)
cam_match_kernel(const int32_t* __restrict__ records,
                 const int32_t* __restrict__ keys, uint32_t* __restrict__ out,
                 long long n, int w, long long m, int mw, int vec) {
  using Tab = Table<RW4>;
  constexpr int RW = 4 * RW4;         // key words of this range
  constexpr int OS = RW + 1;          // output staging stride (words)
  extern __shared__ uint4 smem4[];
  uint4* table = smem4;                                      // Tab::UINT4S
  int32_t* okey = reinterpret_cast<int32_t*>(table + Tab::UINT4S);  // RW*32
  int32_t* obit = okey + RW * 32;                            // RW*32
  int32_t* tile = obit + RW * 32;                            // R x TS
  uint32_t* ost = reinterpret_cast<uint32_t*>(tile + R * TS);   // R x OS
  __shared__ int n_out;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * RW;                 // first key word
  const int cw = min(RW, mw - j0);                // key words written
  const long long kbeg = (long long)j0 * 32;
  const long long kend = min(m, kbeg + (long long)RW * 32);

  uint32_t* tab = reinterpret_cast<uint32_t*>(table);
  for (int i = tid; i < Tab::UINT4S * 4; i += R) tab[i] = 0u;
  if (tid == 0) n_out = 0;
  __syncthreads();
  for (long long k = kbeg + tid; k < kend; k += R) {
    const int32_t key = keys[k];
    const int local = (int)(k - kbeg);            // bit index in the range
    if ((uint32_t)key < (uint32_t)T) {
      for (int r = 0; r < Tab::REP; ++r)
        atomicOr(&tab[Tab::at(key, local >> 7, r) * 4 + ((local >> 5) & 3)],
                 1u << (local & 31));
    } else {
      const int slot = atomicAdd(&n_out, 1);
      okey[slot] = key;
      obit[slot] = local;
    }
  }
  __syncthreads();
  const int nout = n_out;

  uint32_t* mine = ost + tid * OS;      // this thread's output staging row
  const int copy = tid & 7;             // the table copy this thread reads
  uint32_t acc[RW];

  // Rows of at most WC words, 16-byte aligned: one pass per tile, and the
  // next tile's records wait in registers while this tile is looked up.
  const bool whole = vec && w <= WC;
  const int w4 = w >> 2;
  const long long tiles = (n + R - 1) / R;
  uint4 pre[WC / 4];
  if (whole && blockIdx.x < tiles)
    fetch(pre, records, n, w, w4, blockIdx.x, tid);

  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const long long r0 = tt * R;
    const int rows = (int)min((long long)R, n - r0);
#pragma unroll
    for (int c = 0; c < RW; ++c) acc[c] = 0u;

    for (int c0 = 0; c0 < w; c0 += WC) {
      const int wc = min(WC, w - c0);
      __syncthreads();                  // last pass's tile reads are done
      if (whole) {
#pragma unroll
        for (int j = 0; j < WC / 4; ++j) {
          const int i = tid + j * R;
          if (i < rows * w4) {
            const int r = i / w4;
            *reinterpret_cast<uint4*>(tile + r * TS + (i - r * w4) * 4) =
                pre[j];
          }
        }
        if (tt + gridDim.x < tiles)
          fetch(pre, records, n, w, w4, tt + gridDim.x, tid);
      } else {
        for (int i = tid; i < rows * wc; i += R) {
          const int r = i / wc, c = i - r * wc;
          tile[r * TS + c] = records[(r0 + r) * w + c0 + c];
        }
      }
      __syncthreads();
      if (nout > 0 && c0 == 0)
        for (int c = 0; c < RW; ++c) mine[c] = 0u;
      if (tid < rows) {
        const int32_t* rec = tile + tid * TS;
        int x = 0;
#pragma unroll 2
        for (; x + 4 <= wc; x += 4) {
          const int4 v = *reinterpret_cast<const int4*>(rec + x);
          look<RW4>(v.x, acc, table, copy, okey, obit, nout, mine);
          look<RW4>(v.y, acc, table, copy, okey, obit, nout, mine);
          look<RW4>(v.z, acc, table, copy, okey, obit, nout, mine);
          look<RW4>(v.w, acc, table, copy, okey, obit, nout, mine);
        }
        for (; x < wc; ++x)
          look<RW4>(rec[x], acc, table, copy, okey, obit, nout, mine);
      }
    }

#pragma unroll
    for (int c = 0; c < RW; ++c)
      mine[c] = acc[c] | (nout > 0 ? mine[c] : 0u);
    __syncthreads();
    for (int i = tid; i < rows * cw; i += R) {
      const int r = i / cw, c = i - r * cw;
      out[(r0 + r) * mw + j0 + c] = ost[r * OS + c];
    }
  }
}

template <int RW4>
int launch(const void* records, const void* keys, void* out, long long n,
           long long w, long long m, int mw, cudaStream_t stream) {
  constexpr int RW = 4 * RW4;
  const size_t smem = sizeof(uint4) * Table<RW4>::UINT4S
                      + 2 * sizeof(int32_t) * RW * 32 + sizeof(int32_t) * R * TS
                      + sizeof(uint32_t) * R * (RW + 1);
  auto kernel = cam_match_kernel<RW4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (n + R - 1) / R;
  const long long ranges = (mw + RW - 1) / RW;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  // a few resident blocks per SM in all: each builds its table once
  const long long cap = (long long)sms * 8 / ranges + 1;
  const long long bx = tiles < cap ? tiles : cap;
  const int vec = (w % 4 == 0) && ((uintptr_t)records % 16 == 0);
  kernel<<<dim3((unsigned)bx, (unsigned)ranges), R, smem, stream>>>(
      (const int32_t*)records, (const int32_t*)keys, (uint32_t*)out, n,
      (int)w, m, mw, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cam_match_launch(const void* records, const void* keys,
                                void* out, long long n, long long w,
                                long long m, void* stream) {
  const long long mw = (m + 31) / 32;
  if (n == 0 || mw == 0) return (int)cudaGetLastError();
  if (w < 0 || mw > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (w == 0) {                       // no words: no record matches a key
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * n * mw, st);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }
  // range width: the key words, rounded up to 4, 8, 16 or at most 32
  if (mw <= 4) return launch<1>(records, keys, out, n, w, m, (int)mw, st);
  if (mw <= 8) return launch<2>(records, keys, out, n, w, m, (int)mw, st);
  if (mw <= 16) return launch<4>(records, keys, out, n, w, m, (int)mw, st);
  return launch<8>(records, keys, out, n, w, m, (int)mw, st);
}
