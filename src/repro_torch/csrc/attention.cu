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
// on the tensor cores (989 TFLOP/s bf16) against 0.04 ms of bytes.  This
// kernel does its products on the CUDA cores in fp32 FMAs (67 TFLOP/s peak),
// so its own floor is ~15x the function's; mma/wgmma tiles are later work.
//
// Design: one block of 256 threads per (b*h, 64-query tile), the longest
// causal tiles first.  The scaled Q tile stays in shared memory as fp32; a
// loop over KV tiles (64 keys for hd <= 64, 32 above) stages K and V as fp32
// and, per tile: S = Q K^T in a 4 x (BK/16) register tile per thread (rows
// 4*ty.., cols tx + 16*j), float4 shared loads with rows padded by 4 floats
// (conflict-free); mask (key >= S, and key > query when causal) to NEG_INF,
// never -inf, so no row can become NaN; row max and sum by shuffles within
// the 16 threads that share a row; P through shared memory; O += P V into a
// 4 x ceil(hd/16) fp32 accumulator whose rows are the thread's score rows, so
// the rescale by exp(m_old - m_new) needs no exchange.  Causal tiles stop at
// the diagonal (the skipped keys would each add exp(NEG_INF - m) = 0).
// Ragged edges are masked by bounds: queries past S are neither loaded nor
// stored, keys past S are loaded as zeros and masked.  The output is
// acc / max(d, 1e-37), rounded once to the output type.
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

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, long long B,
    long long S, long long H, long long KV, long long hd, long long causal,
    long long bf16, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal, st)
              : dispatch<float>(q, k, v, o, B, S, H, KV, hd, causal, st);
}
