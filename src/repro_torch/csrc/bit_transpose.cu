// bit_transpose: packed (R, Cw) uint32 for a logical R x (32 Cw) bit matrix
// -> packed (32 Cw, ceil(R/32)) uint32, bit (r, c) moving to bit (c, r).
// Rows past R read as zero.
//
// Replaces the TPU kernel src/repro/kernels/bit_transpose.py::bit_transpose
// (_bit_transpose_kernel, _transpose32), which transposes each 32x32 bit
// tile with a 5-round butterfly of masked shifts over sublane rolls.
//
// Bound on Hopper: memory.  It reads and writes R*32*Cw/8 bytes each way and
// does a few operations per word, so the least time is 2*R*Cw*4 / 3.35e12 s.
//
// Design: one block covers 32 row tiles (1024 input rows) x 8 column words.
// Its input (1024 rows x 8 words = 32 KB at Cw = 8, a contiguous stretch)
// is staged in shared memory with coalesced loads; warp c then transposes
// the 32 tiles of column word c: lane i takes the word of row 32*tr + i and
// 32 __ballot_sync((x >> b) & 1) calls give the 32 output words of bit
// column b, lane b keeping its own (one instruction per bit row instead of
// the butterfly's five rounds).  Each lane ends with the 32 consecutive
// output words of one output row, which go back through shared memory so
// that the stores are 128-byte runs of one output row, coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILES = 32;             // row tiles per block (1024 rows)
constexpr int COLS = 8;               // column words per block = warps
constexpr int ROWS = TILES * 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(COLS * 32)
bit_transpose_kernel(const uint32_t* __restrict__ in,
                     uint32_t* __restrict__ out, long long r, long long cw) {
  // phase 1 layout: [ROWS][COLS + 1]; phase 3 reuses it as
  // [COLS][32][TILES + 1] (8448 <= 9216 words)
  __shared__ uint32_t s[ROWS * (COLS + 1)];
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long col0 = (long long)blockIdx.y * COLS;
  const long long rw = (r + 31) / 32;
  const long long tr0 = (long long)blockIdx.x * TILES;

  for (int i = threadIdx.x; i < ROWS * COLS; i += blockDim.x) {
    const int lr = i / COLS, lc = i % COLS;
    const long long gr = row0 + lr, gc = col0 + lc;
    s[lr * (COLS + 1) + lc] = (gr < r && gc < cw) ? in[gr * cw + gc] : 0u;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t res[TILES];                 // lane b: output row 32*(col0+warp)+b
#pragma unroll
  for (int tr = 0; tr < TILES; ++tr) {
    const uint32_t x = s[(tr * 32 + lane) * (COLS + 1) + warp];
    uint32_t mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t word = __ballot_sync(FULL, (x >> b) & 1u);
      if (lane == b) mine = word;
    }
    res[tr] = mine;
  }
  __syncthreads();

#pragma unroll
  for (int tr = 0; tr < TILES; ++tr)
    s[(warp * 32 + lane) * (TILES + 1) + tr] = res[tr];
  __syncthreads();

  // coalesced store: warp-wide runs of TILES consecutive words of one
  // output row; 8 warps cover the block's 8 x 32 output rows
  for (int orow = warp; orow < COLS * 32; orow += COLS) {
    const long long gc = col0 + orow / 32;
    const long long tr = tr0 + lane;
    if (gc < cw && tr < rw)
      out[(gc * 32 + orow % 32) * rw + tr] = s[orow * (TILES + 1) + lane];
  }
}

}  // namespace

extern "C" int bit_transpose_launch(const void* in, void* out, long long r,
                                    long long cw, void* stream) {
  if (r == 0 || cw == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((r + ROWS - 1) / ROWS),
            (unsigned)((cw + COLS - 1) / COLS));
  bit_transpose_kernel<<<grid, COLS * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, r, cw);
  return (int)cudaGetLastError();
}
