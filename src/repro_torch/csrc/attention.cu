// flash_attention_fwd: online-softmax attention forward, causal or full,
// scale 1/sqrt(hd), fp32 accumulation.  q (B, S, H, hd), k/v (B, S, KV, hd)
// contiguous, fp32 or bf16 -> o (B, S, H, hd) in q's dtype.  Query head h
// reads KV head h / (H / KV) (the (KV, g) grouping of the reference's GQA),
// straight from k/v: no broadcast copy.  The (BH, S, hd) entry of the
// reference is the case B = BH, H = KV = 1.
//
// Replaces the TPU kernel src/repro/kernels/attention.py::flash_attention_fwd
// (_flash_fwd_kernel), which walks a sequential (q block, kv block) grid with
// its running max / denominator / accumulator in VMEM scratch and pads S to
// the block multiples.
//
// Bound on Hopper: operations.  At the serving path's prefill shape (B = 4,
// S = 2048, H = 28, KV = 4, hd = 128, causal, bf16) the function needs
// 2*S*(S+1)*hd*B*H ~ 1.2e11 flops against ~134 MB of q, k, v, o: 0.12 ms
// on the tensor cores (989 TFLOP/s bf16) against 0.04 ms of bytes.
//
// Two kernels, chosen inside flash_attention_fwd_launch by type and shape:
//
// * flash_fwd_wgmma (bf16, head_dim 64 or 128: every full config the port
//   serves).  The products run on the tensor
//   cores.  One CTA of 288 threads per (b*h, 128-query tile), the longest
//   causal tiles first across all heads: two consumer warpgroups own 64
//   query rows each, one producer warp issues TMA copies
//   (cp.async.bulk.tensor with mbarrier completion, 128-byte swizzle) of the
//   Q tile once and of 128-key K and V tiles into a two-stage ring, so the
//   next tile's copy overlaps this tile's products; keys past S are
//   zero-filled by the copy and masked.  S = Q K^T is wgmma m64n128k16 with
//   both operands in shared memory (K-major); the 1/sqrt(hd) scale (times
//   log2 e, for exp2) multiplies the fp32 scores, never bf16 q.  Online
//   softmax runs on the accumulator registers (row max and sum by shuffles
//   within the 4 threads that share a row); NEG_INF masks only the diagonal
//   and ragged tiles, and causal loops stop at the diagonal.  O += P V takes
//   P from registers as wgmma's A operand, against V read from shared
//   memory MN-major (transposed).  The reference multiplies fp32 P by V, and
//   P rounded to bf16 alone would err by up to 2^-9 * sum p|v| / l, about
//   as much as the output's own bf16 rounding; so P goes in as a pair of
//   bf16 fragments, hi = bf16(p) and lo = bf16(p - hi), two wgmmas into
//   the same fp32 accumulators, which carry p to 2^-17 relative (half again
//   the tensor-core work of S and P V in bf16 alone).  O is rescaled by
//   exp2(m_old - m_new) in registers.  The output is O / max(l, 1e-37),
//   rounded once to bf16.
// * flash_fwd_kernel (fp32 inputs, and bf16 at head_dim 8/16/32/256).  The
//   products run as fp32 FMAs on the CUDA cores (67 TFLOP/s
//   peak), which keeps fp32 inputs within the reference test's atol of 2e-5
//   (TF32 or bf16 tiles would not).  One block of 256 threads per (b*h,
//   64-query tile), the longest causal tiles first.  The scaled Q tile
//   stays in shared memory as fp32; a loop over KV tiles (64 keys for
//   hd <= 64, 32 above) stages K and V as fp32 and, per tile: S = Q K^T in a
//   4 x (BK/16) register tile per thread (rows 4*ty.., cols tx + 16*j),
//   float4 shared loads with rows padded by 4 floats (conflict-free); mask
//   (key >= S, and key > query when causal) to NEG_INF, never -inf, so no
//   row can become NaN; row max and sum by shuffles within the 16 threads
//   that share a row; P through shared memory; O += P V into a
//   4 x ceil(hd/16) fp32 accumulator whose rows are the thread's score rows,
//   so the rescale by exp(m_old - m_new) needs no exchange.  Causal tiles
//   stop at the diagonal (the skipped keys would each add exp(NEG_INF - m) =
//   0).  Queries past S are neither loaded nor stored, keys past S are
//   loaded as zeros and masked.  The output is acc / max(d, 1e-37), rounded
//   once to the output type.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // queries per block
constexpr int THREADS = 256;           // 16 x 16: ty owns 4 rows, tx columns
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -0.7f * FLT_MAX;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, int nq, int causal, float scale) {
  constexpr int QS = HD + 4;           // padded row strides, 16-byte aligned
  constexpr int VS = HD;
  constexpr int PS = BK + 4;
  constexpr int NC = BK / 16;          // score columns per thread
  constexpr int NJ = (HD + 15) / 16;   // output columns per thread
  constexpr int H4 = HD / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x QS, scaled q
  float* Ks = Qs + BQ * QS;                      // BK x QS
  float* Vs = Ks + BK * QS;                      // BK x VS
  float* Ps = Vs + BK * VS;                      // BQ x PS probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * BQ;
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * HD;   // between positions
  const long long kstride = (long long)KV * HD;
  const T* qb = q + (b * S * H + h) * HD;
  const T* kb = k + (b * S * KV + kvh) * HD;
  const T* vb = v + (b * S * KV + kvh) * HD;
  T* ob = o + (b * S * H + h) * HD;

  for (int i = tid; i < BQ * H4; i += THREADS) {
    const int r = i / H4, c = (i % H4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) {
      x = load4(qb + (q0 + r) * qstride + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * QS + c) = x;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                   // last tile's K, V, P reads are done
    for (int i = tid; i < BK * H4; i += THREADS) {
      const int r = i / H4, c = (i % H4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (k0 + r < S) {
        x = load4(kb + (k0 + r) * kstride + c);
        y = load4(vb + (k0 + r) * kstride + c);
      }
      *reinterpret_cast<float4*>(Ks + r * QS + c) = x;
      *reinterpret_cast<float4*>(Vs + r * VS + c) = y;
    }
    __syncthreads();

    float s[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kc[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(Qs + (ty * 4 + i) * QS + d);
#pragma unroll
      for (int j = 0; j < NC; ++j) kc[j] = load4(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kc[j].x, t);
          t = fmaf(qa[i].y, kc[j].y, t);
          t = fmaf(qa[i].z, kc[j].z, t);
          t = fmaf(qa[i].w, kc[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = expf(s[i][j] - mnew);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(Ps + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (HD >= 16 || c < HD) {
          const float v0 = Vs[(kk + 0) * VS + c], v1 = Vs[(kk + 1) * VS + c];
          const float v2 = Vs[(kk + 2) * VS + c], v3 = Vs[(kk + 3) * VS + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float t = acc[i][j];
            t = fmaf(pa[i].x, v0, t);
            t = fmaf(pa[i].y, v1, t);
            t = fmaf(pa[i].z, v2, t);
            t = fmaf(pa[i].w, v3, t);
            acc[i][j] = t;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (HD >= 16 || c < HD) store1(ob + r * qstride + c, acc[i][j] / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, long long B,
           long long S, long long H, long long KV, long long causal,
           cudaStream_t stream) {
  constexpr int BK = HD <= 64 ? 64 : 32;
  const size_t smem = sizeof(float) * (size_t)(BQ * (HD + 4) + BK * (HD + 4)
                                               + BK * HD + BQ * (BK + 4));
  auto kernel = flash_fwd_kernel<T, HD, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (S + BQ - 1) / BQ;
  const long long blocks = B * H * nq;
  if (blocks > 0x7fffffffLL || S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)S, (int)H, (int)KV,
      (int)nq, (int)causal, (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             long long B, long long S, long long H, long long KV,
             long long hd, long long causal, cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, B, S, H, KV, causal, st);
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, st);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- flash_fwd_wgmma: the bf16 tensor-core kernel ----------------------

constexpr int TC_BQ = 128;             // queries per CTA: 2 warpgroups x 64
constexpr int TC_BK = 128;             // keys per K/V tile
constexpr int TC_STAGES = 2;           // K/V ring depth
constexpr int TC_CONSUMERS = 256;      // two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;   // + one producer warp
constexpr int BOX = 64;                // bf16 columns per 128-byte TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Spin until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout SW128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers an async wgmma reads or writes at this point of the
// program, so the compiler moves no access to them across the fences.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Columns (x, y) of P as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) * B (128 x 16, smem), both
// K-major, 128-byte swizzled; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 128,
// smem, MN-major, 128-byte swizzled).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64,
// smem, MN-major, 128-byte swizzled).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

// Shared memory: the Q tile (HD/64 column boxes of TC_BQ rows x 128 bytes),
// then TC_STAGES x (K tile, V tile) of HD/64 boxes of TC_BK rows each, then
// the mbarriers: Q full, K full and V full per stage, stage empty.
template <int HD>
struct TcLayout {
  static constexpr int NB = HD / BOX;
  static constexpr uint32_t QBOX = TC_BQ * 128, KBOX = TC_BK * 128;
  static constexpr uint32_t QBYTES = NB * QBOX, KVBYTES = NB * KBOX;
  static constexpr uint32_t BARS = QBYTES + TC_STAGES * 2 * KVBYTES;
  static constexpr size_t SMEM = 1024 + BARS + 8 * (1 + 3 * TC_STAGES);
};

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int H, int KV, int BH,
                int nq, int causal, float scale_log2) {
  using L = TcLayout<HD>;
  constexpr int NO = HD / 2;           // O accumulators per thread
  constexpr int NS = TC_BK / 2;        // score accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = sq + L::BARS;
  const uint32_t qfull = bars;
  auto kfull = [&](int s) { return bars + 8u * (1 + s); };
  auto vfull = [&](int s) { return bars + 8u * (1 + TC_STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * TC_STAGES + s); };
  auto kbuf = [&](int s) { return sq + L::QBYTES + 2u * s * L::KVBYTES; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * TC_BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int kend = causal ? min(S, q0 + TC_BQ) : S;
  const int nk = (kend + TC_BK - 1) / TC_BK;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {           // the producer warp: one thread
    if (tid == TC_CONSUMERS) {
      mbar_expect_tx(qfull, L::QBYTES);
      for (int c = 0; c < L::NB; ++c)
        tma_load(sq + c * L::QBOX, &tq, qfull, c * BOX, h, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int s = it % TC_STAGES;
        if (it >= TC_STAGES) mbar_wait(empty(s), ((it / TC_STAGES) - 1) & 1);
        const uint32_t kb = kbuf(s), vb = kb + L::KVBYTES;
        mbar_expect_tx(kfull(s), L::KVBYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load(kb + c * L::KBOX, &tk, kfull(s), c * BOX, kvh, it * TC_BK,
                   b);
        mbar_expect_tx(vfull(s), L::KVBYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load(vb + c * L::KBOX, &tv, vfull(s), c * BOX, kvh, it * TC_BK,
                   b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64*wg .. + 63; this thread
  // holds rows qrow and qrow + 8, columns 8n + ccol and + 1 of each 8-block
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qrow = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int ccol = 2 * (lane & 3);
  const uint32_t qa = sq + wg * 64 * 128;
  float acc[NO], s[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  mbar_wait(qfull, 0);

  for (int it = 0; it < nk; ++it) {
    const int st = it % TC_STAGES;
    const uint32_t ph = (it / TC_STAGES) & 1;
    const uint32_t kb = kbuf(st), vb = kb + L::KVBYTES;
    const int k0 = it * TC_BK;

    // S = Q K^T: HD/16 steps of 16 columns (32 bytes) within the boxes
    mbar_wait(kfull(st), ph);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n128(s, sw128_desc(qa + (kk >> 2) * L::QBOX + off, 16, 1024),
                    sw128_desc(kb + (kk >> 2) * L::KBOX + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale to the log2 domain; mask only the diagonal and ragged tiles
    const bool edge = k0 + TC_BK > S
                      || (causal && k0 + TC_BK - 1 > q0 + 64 * wg);
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * n + ccol + (e & 1);
          const int row = qrow + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) x = NEG_INF;
        }
        s[4 * n + e] = x;
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P in bf16 pairs hi (p) and lo (pl): [2n + i] holds row qrow + 8i,
    // columns 8n + ccol, +1
    uint32_t p[NS / 2], pl[NS / 2];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
      const float a0 = exp2f(s[4 * n] - m0), a1 = exp2f(s[4 * n + 1] - m0);
      const float b0 = exp2f(s[4 * n + 2] - m1), b1 = exp2f(s[4 * n + 3] - m1);
      sum0 += a0 + a1;
      sum1 += b0 + b1;
      split_bf16(a0, a1, p[2 * n], pl[2 * n]);
      split_bf16(b0, b1, p[2 * n + 1], pl[2 * n + 1]);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n) {
      acc[4 * n] *= c0;
      acc[4 * n + 1] *= c0;
      acc[4 * n + 2] *= c1;
      acc[4 * n + 3] *= c1;
    }

    // O += (P hi + P lo) V: TC_BK/16 steps of 16 keys (2048 bytes of V
    // rows); the A fragments of step kk are p[4kk .. 4kk+3] and pl[...]
    // (score blocks 2kk, 2kk+1)
    mbar_wait(vfull(st), ph);
    fence_regs(acc);
    fence_regs(p);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(vb + kk * 16 * 128, L::KBOX, 1024);
      const uint32_t hi[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                              p[4 * kk + 3]};
      const uint32_t lo[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                              pl[4 * kk + 3]};
      wgmma_pv<HD>(acc, lo, dv);
      wgmma_pv<HD>(acc, hi, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  const float r0 = 1.f / fmaxf(l0, 1e-37f), r1 = 1.f / fmaxf(l1, 1e-37f);
  const long long ostride = (long long)H * HD;
  __nv_bfloat16* ob = o + ((long long)b * S * H + h) * HD + ccol;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qrow + 8 * i;
    if (row >= S) continue;
    const float r = i ? r1 : r0;
    __nv_bfloat16* dst = ob + row * ostride;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc[4 * n + 2 * i] * r, acc[4 * n + 2 * i + 1] * r);
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda at link time).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 (B, S, heads, hd) tensor as a 4-D TMA map whose box is `rows`
// positions x one head x 64 columns (128 bytes), 128-byte swizzled; rows
// past S read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, long long B, long long S,
                long long heads, long long hd, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(hd * 2),
                                 (cuuint64_t)(heads * hd * 2),
                                 (cuuint64_t)(S * heads * hd * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 long long B, long long S, long long H, long long KV,
                 long long causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, HD, TC_BQ)
      || !tensor_map(&tk, k, B, S, KV, HD, TC_BK)
      || !tensor_map(&tv, v, B, S, KV, HD, TC_BK))
    return (int)cudaErrorInvalidValue;
  const size_t smem = TcLayout<HD>::SMEM;
  auto kernel = flash_fwd_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (S + TC_BQ - 1) / TC_BQ;
  const long long blocks = B * H * nq;
  if (blocks > 0x7fffffffLL || S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  kernel<<<(unsigned)blocks, TC_THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (int)S, (int)H, (int)KV, (int)(B * H),
      (int)nq, (int)causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, long long B,
    long long S, long long H, long long KV, long long hd, long long causal,
    long long bf16, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // both kernels read 16-byte pieces (TMA boxes, float4 / 8-byte loads)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // bf16 at head_dim 64 / 128 goes to the tensor cores
  if (bf16 && hd == 128)
    return launch_wgmma<128>(q, k, v, o, B, S, H, KV, causal, st);
  if (bf16 && hd == 64)
    return launch_wgmma<64>(q, k, v, o, B, S, H, KV, causal, st);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal, st)
              : dispatch<float>(q, k, v, o, B, S, H, KV, hd, causal, st);
}
