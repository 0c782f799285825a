// bit_transpose: packed (R, Cw) uint32 for a logical R x (32 Cw) bit matrix
// -> packed (32 Cw, ceil(R/32)) uint32, bit (r, c) moving to bit (c, r).
// Rows past R read as zero.
//
// Replaces the TPU kernel src/repro/kernels/bit_transpose.py::bit_transpose
// (_bit_transpose_kernel, _transpose32), which transposes each 32x32 bit
// tile with a 5-round butterfly of masked shifts over sublane rolls.
//
// Bound on Hopper: memory.  It reads and writes R*32*Cw/8 bytes each way and
// does a few operations per word, so the least time is 2*R*Cw*4 / 3.35e12 s
// (0.080 ms for one 2^22-record block at Cw = 8).
//
// Design.  A work item is 1024 input rows (32 row tiles) x 8 column words:
// 32 KB, one contiguous stretch at Cw = 8.  A persistent grid (as many
// 256-thread CTAs as fit the card at once, 64 KB of shared memory each)
// walks the items through a two-stage shared-memory ring: while one item is
// transposed and stored, the next one is in flight by cp.async, 16 bytes a
// thread where the input allows it (base 16-byte aligned, Cw % 4 == 0) and
// 4 bytes a thread otherwise, rows and columns past the edge zero-filled
// by the copy itself.
//
// The transpose is the reference's butterfly run across the lanes of a warp
// (one word per lane, five __shfl_xor_sync rounds), not one tile per thread
// in 32 registers: a thread that owns a tile must read 32 rows of one
// column, and with a row of 8 words in shared memory those reads can reach
// only 8 of the 32 banks however the words of a row are permuted, while 16
// bytes a lane from consecutive rows reach all of them.  Lane i of warp w
// reads row 32*tr + i of its row tile tr as two uint4 (row i of the 8 tiles
// (tr, c), c = 0..7) and runs 8 butterflies side by side; a round is one
// shuffle, one funnel-shift rotate and one masked select (LOP3), 15 warp
// instructions per tile in all against 160 for the 32 ballots per tile this
// replaced.  The two 16-byte chunks of a row are stored swapped on every
// other group of 4 rows (chunk' = chunk ^ ((row >> 2) & 1)), so each
// quarter-warp's eight uint4 reads cover the 32 banks once.
//
// Lane b ends with output word b of its 8 tiles.  The words go back into
// the stage they came from (everyone has read it by then), output row
// o = 32 c + b holding tile tr at word (tr ^ b) of its 32: the writes of a
// warp and the reads of one output row both land on 32 distinct banks.
// Each warp then stores whole output rows, 32 consecutive tiles, as
// 128-byte runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILES = 32;               // row tiles per item (1024 rows)
constexpr int ROWS = TILES * 32;
constexpr int COLS = 8;                 // column words per item
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TPW = TILES / WARPS;      // row tiles per warp
constexpr int STAGE = ROWS * COLS;      // words per ring stage (32 KB)
constexpr int SMEM = 2 * STAGE * 4;     // the two-stage ring, bytes
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy item (row0, col0) of the input into a ring stage: word (lr, c) of
// the item at lr * COLS + 4 * ((c / 4) ^ ((lr >> 2) & 1)) + c % 4.
template <bool VEC>
__device__ __forceinline__ void load_item(uint32_t* st,
                                          const uint32_t* __restrict__ in,
                                          long long r, long long cw,
                                          long long row0, long long col0) {
  if (VEC) {                            // 16-byte chunks, 8 per thread
    for (int q = threadIdx.x; q < ROWS * 2; q += THREADS) {
      const int lr = q >> 1, h = q & 1;
      const long long gr = row0 + lr, gc = col0 + 4 * h;
      const bool ok = gr < r && gc < cw;
      const uint32_t* src = ok ? in + gr * cw + gc : in;
      const uint32_t* dst = st + lr * COLS + ((h ^ ((lr >> 2) & 1)) << 2);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(shared_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  } else {                              // 4-byte words, 32 per thread
    for (int q = threadIdx.x; q < STAGE; q += THREADS) {
      const int lr = q >> 3, c = q & 7;
      const long long gr = row0 + lr, gc = col0 + c;
      const bool ok = gr < r && gc < cw;
      const uint32_t* src = ok ? in + gr * cw + gc : in;
      const uint32_t* dst =
          st + lr * COLS + ((((c >> 2) ^ (lr >> 2)) & 1) << 2) + (c & 3);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(shared_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
}

// Mask of butterfly round k (partner distance 16 >> k): the bits a row with
// index bit (16 >> k) set takes from its partner.
__device__ __forceinline__ constexpr unsigned round_mask(int k) {
  return k == 0 ? 0x0000ffffu : k == 1 ? 0x00ff00ffu : k == 2 ? 0x0f0f0f0fu
       : k == 3 ? 0x33333333u : 0x55555555u;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
bit_transpose_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, long long r, long long cw,
                     long long rw, long long ncb, long long items) {
  extern __shared__ __align__(16) uint32_t ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Round k pairs lane i with lane i ^ j (j = 16 >> k).  The reference's
  // "up" row (bit j of i clear) takes bits ~m of its partner shifted up by
  // j, the "down" row bits m shifted down by j; a rotate by j or 32 - j
  // followed by the mask does either (the wrapped bits fall outside it).
  unsigned take[5];
  int rot[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 16 >> k;
    const bool up = (lane & j) == 0;
    take[k] = up ? ~round_mask(k) : round_mask(k);
    rot[k] = up ? j : 32 - j;
  }

  long long it = blockIdx.x;
  load_item<VEC>(ring, in, r, cw, (it / ncb) * ROWS, (it % ncb) * COLS);
  cp_async_commit();
  for (int s = 0; it < items; it += gridDim.x, s ^= 1) {
    uint32_t* st = ring + s * STAGE;
    const long long nxt = it + gridDim.x;
    if (nxt < items)
      load_item<VEC>(ring + (s ^ 1) * STAGE, in, r, cw, (nxt / ncb) * ROWS,
                     (nxt % ncb) * COLS);
    cp_async_commit();                  // (an empty group past the end)
    cp_async_wait_one();                // this item's copies have landed
    __syncthreads();

    uint32_t x[TPW][COLS];              // lane i: row i of 8 tiles per tr
    const int sw = (lane >> 2) & 1;
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const uint4* row = reinterpret_cast<const uint4*>(
          st + ((warp * TPW + t) * 32 + lane) * COLS);
      const uint4 lo = row[sw], hi = row[sw ^ 1];
      x[t][0] = lo.x; x[t][1] = lo.y; x[t][2] = lo.z; x[t][3] = lo.w;
      x[t][4] = hi.x; x[t][5] = hi.y; x[t][6] = hi.z; x[t][7] = hi.w;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const uint32_t p = __shfl_xor_sync(FULL, x[t][c], 16 >> k);
          const uint32_t q = __funnelshift_l(p, p, rot[k]);
          x[t][c] = (x[t][c] & ~take[k]) | (q & take[k]);
        }
      }
    }
    __syncthreads();                    // every lane has read the stage

    // lane b holds output word b of tile (tr, c): output row o = 32 c + b
    // of the item, word (tr ^ b) of that row in the stage
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const int tr = warp * TPW + t;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        st[(c * 32 + lane) * 32 + (tr ^ lane)] = x[t][c];
    }
    __syncthreads();

    const long long col0 = (it % ncb) * COLS;
    const long long tile = (it / ncb) * TILES + lane;
    for (int o = warp; o < COLS * 32; o += WARPS) {
      const long long gc = col0 + (o >> 5);
      if (gc < cw && tile < rw)
        out[(gc * 32 + (o & 31)) * rw + tile] = st[o * 32 + (lane ^ (o & 31))];
    }
    __syncthreads();                    // the stage is free for item + 2
  }
}

// CTAs of one instance resident on the card at once (cached per device;
// the first call also lifts the instance's dynamic shared-memory limit).
template <bool VEC>
cudaError_t resident_ctas(int* ctas) {
  static int cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && cache[dev]) {
    *ctas = cache[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(bit_transpose_kernel<VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bit_transpose_kernel<VEC>, THREADS, SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *ctas = sms * per_sm;
  if (dev < MAX_DEVICES) cache[dev] = *ctas;
  return cudaSuccess;
}

}  // namespace

extern "C" int bit_transpose_launch(const void* in, void* out, long long r,
                                    long long cw, void* stream) {
  if (r == 0 || cw == 0) return (int)cudaGetLastError();
  const long long rw = (r + 31) / 32;
  const long long ncb = (cw + COLS - 1) / COLS;
  const long long items = (r + ROWS - 1) / ROWS * ncb;
  const bool vec = (uintptr_t)in % 16 == 0 && cw % 4 == 0;
  int ctas = 0;
  const cudaError_t e = vec ? resident_ctas<true>(&ctas)
                            : resident_ctas<false>(&ctas);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(items < ctas ? items : ctas);
  if (vec)
    bit_transpose_kernel<true><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, r, cw, rw, ncb, items);
  else
    bit_transpose_kernel<false><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, r, cw, rw, ncb, items);
  return (int)cudaGetLastError();
}
