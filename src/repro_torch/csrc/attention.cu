// flash_attention_fwd: online-softmax attention forward, causal or full,
// scale 1/sqrt(hd), fp32 accumulation.  q (B, Sq, H, hd), k/v (B, Skv, KV,
// hd) contiguous, fp32 or bf16 -> o (B, Sq, H, hd) in q's dtype.  Query
// head h reads KV head h / (H / KV) (the (KV, g) grouping of the
// reference's GQA), straight from k/v: no broadcast copy.  The (BH, S, hd)
// entry of the reference is the case B = BH, H = KV = 1.
//
// The mask is the reference's (src/repro/models/flash.py _block_ok): key k
// is allowed for query q when k < kv_len and, under the causal mask only,
// q + q_offset - window < k <= q + q_offset (a sliding window below each
// query's absolute position; window 2^30 is unbounded).  The C entries
// clip kv_len to Skv and clamp the window to Sq + q_offset, past which it
// masks nothing, so the kernels' 32-bit sums cannot overflow.  Every
// kernel walks only the key tiles its query tile can see (key_range: from
// the first row's window edge to the last row's diagonal) and, in the
// backward's dK/dV launches, only the query tiles that can see its key
// tile (query_range); tiles that straddle an edge take the masked path,
// the others run unmasked.  Under a window of 1024 at S = 4096 a local
// layer reads 34 of the 64-query tile's 32-key tiles where the causal
// mask alone reads up to 128.  A row that sees no key (kv_len <= q +
// q_offset - window) is written as zeros with an lse of NEG_INF (the
// plain version's choice; the reference averages V over its padded
// chunk there): its exponentials take 0, not the running max, as their
// reference point while every score is NEG_INF (row_ref).  On an
// unwindowed call with q_offset 0 and kv_len Skv the kernels compute
// what they computed before the mask took these arguments, bit for bit.
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
//
// Both forward kernels also write lse (B, H, S) fp32 = m + ln(l), the
// natural-log normalizer of the scaled scores, when the caller passes a
// pointer (training); prefill passes null and writes nothing more.
//
// flash_attention_bwd: dq, dk, dv of the same attention from (q, k, v, o,
// lse, dout), in q's dtype with fp32 accumulation.  Not a TPU kernel: it
// replaces the plain-JAX backward of flash_attention_vjp
// (src/repro/models/flash.py::_flash_bwd_dense, under custom_vjp), and
// computes what it computes: delta = rowsum(dout * o) from o as stored,
// p = exp(s - lse) recomputed from q, k and the fp32 scale, dv = p^T dout,
// ds = p (dout v^T - delta), dq = ds k * scale, dk = ds^T q * scale.
// Bound on Hopper: operations.  At the training path's shape (B = 4,
// S = 2048, H = 28, KV = 4, hd = 128, causal, bf16) it needs five products
// of the causal half, 2.5x the forward's flops (~3.0e11): 0.30 ms on the
// tensor cores, against ~0.2 GB of q, k, v, o, dout, lse, dq, dk, dv.
// Both pairs below are two launches with no floating-point atomics: every
// output element is summed by one thread in a fixed order, and the GQA sum
// over a group stays inside one CTA, so two runs are bit-identical.  Both
// launches recompute S and dP: seven products of the causal half where
// five are needed.  The C entry picks the pair by type and shape, as the
// forward's does; a failure of either is returned, never retried on the
// other.
//
// * flash_bwd_dq_wgmma + flash_bwd_dkdv_wgmma (bf16, head_dim 64 or 128).
//   The products run on the tensor cores.  CTAs of 384 threads: two
//   consumer warpgroups and a producer warpgroup, one warp of which issues
//   TMA copies (128-byte swizzle, mbarrier completion) into a ring of
//   BW_STAGES = 3 tiles; setmaxnreg hands the producer's registers to the
//   consumers (240 a thread; ptxas sizes three warpgroups at 168, where the
//   dK/dV kernel spilled and serialized its wgmmas).  Keys and queries
//   past S are zero-filled by the copies and get p = 0; only diagonal and
//   ragged tiles are masked, and a warpgroup skips a tile wholly above its
//   diagonal.
//   dq: one CTA per (b, h, 128-query tile), the longest causal tiles first;
//   each consumer warpgroup owns 64 query rows.  It computes delta of its
//   rows from o and dout (and writes it for the second launch); the Q and
//   dO tiles are copied once, 64-key K and V tiles stream through the ring
//   up to the diagonal.  Per tile S = Q K^T, then dP = dO V^T, as wgmma
//   m64n64k16 with both operands in shared memory (K-major); P = exp2(S
//   scale log2 e - lse log2 e) is computed while dP's product runs (the
//   scale multiplies the fp32 scores, never bf16 q); dS = P (dP - delta);
//   dQ += dS K takes dS from registers as wgmma's A operand against K read
//   MN-major, as the forward's P V reads V.
//   dkdv: one CTA per (b, KV head, 128-key tile), K and V copied once and
//   kept; each consumer warpgroup owns 64 keys.  The producer streams the
//   64-query Q and dO tiles of the g query heads of the group, each head's
//   from the diagonal down, and its lanes write each tile's lse (times
//   log2 e) and delta rows beside them.  The consumers compute transposed:
//   S^T = K Q^T, then dP^T = V dO^T, from shared memory; P^T and dS^T in
//   registers (lse and delta per column); dV += P^T dO and dK += dS^T Q
//   with A from registers, dO and Q read MN-major; dK is scaled once at
//   the end.  Load balance: at the training shape the grid is 4 x 4 x 16 =
//   256 CTAs for 132 SMs, and key tile 0 carries 16x the query tiles of
//   key tile 15; the grid runs key tile 0 first (longest first) rather
//   than taking 64-key CTAs, which would stream each Q and dO tile once
//   per warpgroup instead of once per two.
//   Precision: no operand is split: P and dS enter their products as
//   bf16 alone, where the reference multiplies them in fp32.  As bf16
//   alone every FLASH_BWD_CASES case stays within bwd_tol: the worst
//   err/tol of chip_smoke.py's phase 2 check reads 0.653 at head_dim 128
//   and 0.630 at 64 (H100 80GB HBM3, 700 W).  Carried as bf16 hi + lo
//   pairs, as the forward carries P (an earlier build of these kernels,
//   since removed), it read 0.449 and 0.384, but the dQ, dV and dK
//   products doubled and the pair took 1.27 ms instead of 1.06 at the
//   training shape; a tolerance that ever needs the split can bring it
//   back in to_frags and mma_rs_k64.
// * flash_bwd_dq_kernel + flash_bwd_dkdv_kernel (fp32 inputs, and bf16 at
//   head_dim 8/16/32/256): fp32 FMAs on the CUDA cores (67 TFLOP/s peak, so
//   ~4.5 ms at best at the shape above), which keeps fp32 within the
//   reference's gradient atol of 2e-4.  flash_bwd_dq_kernel: one 256-thread
//   block per (b, h, 64-query tile), longest causal tiles first; it stages
//   q * scale and dout in shared memory as fp32, computes delta of its rows
//   (and writes it for the second launch), then walks the key tiles up to
//   the diagonal: S and dP = dout V^T in 4 x 4 register tiles (the
//   forward's float4 layout), dS through shared memory, dQ += dS K into a
//   4 x hd/16 accumulator.  flash_bwd_dkdv_kernel: one block per (b, KV
//   head, 64-key tile), K and V staged once; it walks the g query heads of
//   the group and, for each, the query tiles from the diagonal down,
//   recomputing S, P and dS per tile as above and adding dV += P^T dout and
//   dK += dS^T (q * scale) into its keys' accumulators.  Fully masked
//   causal tiles are skipped on both sides; elements past S or above the
//   diagonal have p = 0.  head_dim 256 takes 32 x 32 tiles to fit shared
//   memory.
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

// The mask of every kernel here (the reference's models/flash.py
// _block_ok): key k is allowed for the query at absolute position qabs =
// q + q_offset when k < kvlen and, under the causal mask only, qabs -
// window < k <= qabs.  The C entries clip kvlen to Skv and clamp window to
// Sq + q_offset (past that it masks nothing), so no sum here overflows.
__device__ __forceinline__ bool allowed(int k, int qabs, int causal,
                                        int window, int kvlen) {
  return k < kvlen && (!causal || (k <= qabs && k > qabs - window));
}

// The reference point of a row's exponentials: its running max, or 0 while
// every score so far is masked (NEG_INF), so that masked scores give
// exp(NEG_INF) = 0 and a row with no allowed key ends with l = 0 (output 0,
// lse NEG_INF) instead of averaging its masked keys.
__device__ __forceinline__ float row_ref(float m) {
  return m == NEG_INF ? 0.f : m;
}

// [kbeg, kend): the keys that the query rows [q0, q0 + rows) (cut at Sq) can
// see, kbeg rounded down to a multiple of the key tile ``tile``: every
// allowed key of every row, and whole tiles outside skipped.  Under the
// causal mask: from the first row's window edge to the last row's
// diagonal; otherwise all kvlen keys.  Empty (kend <= kbeg) when no row
// sees a key.
__device__ __forceinline__ void key_range(int q0, int rows, int Sq,
                                          int causal, int window, int qoff,
                                          int kvlen, int tile, int& kbeg,
                                          int& kend) {
  kbeg = 0;
  kend = kvlen;
  if (causal) {
    kend = min(kvlen, min(q0 + rows, Sq) + qoff);
    kbeg = max(0, q0 + qoff - window + 1) / tile * tile;
  }
}

// [qbeg, qend): the query rows that can see a key of [k0, k0 + keys): under
// the causal mask q + q_offset >= k0 and q + q_offset - window < k0 + keys
// - 1, qbeg rounded down to a multiple of the query tile ``tile``; all Sq
// rows otherwise; none when k0 >= kvlen.
__device__ __forceinline__ void query_range(int k0, int keys, int Sq,
                                            int causal, int window, int qoff,
                                            int kvlen, int tile, int& qbeg,
                                            int& qend) {
  qbeg = 0;
  qend = k0 < kvlen ? Sq : 0;
  if (causal && k0 < kvlen) {
    qend = min(Sq, k0 + keys - 1 - qoff + window);
    qbeg = max(0, k0 - qoff) / tile * tile;
  }
}

// The mask's integers as the kernels take them, from the C entry's
// arguments: kv_len clipped to [0, Skv], window clamped to [1, Sq +
// q_offset].
struct Mask {
  int skv, causal, window, qoff, kvlen;
};

// Checks the C entry's mask arguments (window >= 1, q_offset >= 0, Skv >= 1,
// positions within int32 with room for a tile) and fills ``mk``.
bool make_mask(long long Sq, long long Skv, long long causal,
               long long window, long long q_offset, long long kv_len,
               Mask& mk) {
  const long long lim = 0x7fffffffLL - 1024;
  if (Skv < 1 || window < 1 || q_offset < 0 || Sq > lim || Skv > lim
      || Sq + q_offset + Skv > lim)
    return false;
  mk.skv = (int)Skv;
  mk.causal = causal ? 1 : 0;
  mk.window = (int)(window < Sq + q_offset ? window : Sq + q_offset);
  mk.qoff = (int)q_offset;
  mk.kvlen = (int)(kv_len < 0 ? 0 : (kv_len > Skv ? Skv : kv_len));
  return true;
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                 int nq, int causal, int window, int qoff, int kvlen,
                 float scale) {
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
  const T* qb = q + (b * Sq * H + h) * HD;
  const T* kb = k + (b * Skv * KV + kvh) * HD;
  const T* vb = v + (b * Skv * KV + kvh) * HD;
  T* ob = o + (b * Sq * H + h) * HD;

  for (int i = tid; i < BQ * H4; i += THREADS) {
    const int r = i / H4, c = (i % H4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
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

  // the key tiles the tile's rows can see: up to the last row's diagonal
  // and down to the first row's window edge (whole tiles outside skipped)
  int kbeg, kend;
  key_range(q0, BQ, Sq, causal, window, qoff, kvlen, BK, kbeg, kend);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                   // last tile's K, V, P reads are done
    for (int i = tid; i < BK * H4; i += THREADS) {
      const int r = i / H4, c = (i % H4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (k0 + r < Skv) {
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
      const int qabs = q0 + ty * 4 + i + qoff;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (!allowed(k0 + tx + 16 * j, qabs, causal, window, kvlen))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mnew);
      const float mref = row_ref(mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = expf(s[i][j] - mref);
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
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (HD >= 16 || c < HD) store1(ob + r * qstride + c, acc[i][j] / den);
    }
    // natural-log lse of the scaled scores, as the backward recomputes p;
    // NEG_INF for a row with no allowed key (l = 0: its output is 0)
    if (lse != nullptr && tx == 0)
      lse[bh * Sq + r] = l[i] > 0.f ? m[i] + logf(den) : NEG_INF;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           long long B, long long S, long long H, long long KV,
           const Mask& mk, cudaStream_t stream) {
  constexpr int BK = HD <= 64 ? 64 : 32;
  const size_t smem = sizeof(float) * (size_t)(BQ * (HD + 4) + BK * (HD + 4)
                                               + BK * HD + BQ * (BK + 4));
  auto kernel = flash_fwd_kernel<T, HD, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (S + BQ - 1) / BQ;
  const long long blocks = B * H * nq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, (int)S, mk.skv,
      (int)H, (int)KV, (int)nq, mk.causal, mk.window, mk.qoff, mk.kvlen,
      (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             long long B, long long S, long long H, long long KV,
             long long hd, const Mask& mk, cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, o, lse, B, S, H, KV, mk, st);
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, KV, mk, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, KV, mk, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, KV, mk, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, KV, mk, st);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, S, H, KV, mk, st);
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
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
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
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
                int H, int KV, int BH, int nq, int causal, int window,
                int qoff, int kvlen, float scale_log2) {
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
  int kbeg, kend;
  key_range(q0, TC_BQ, Sq, causal, window, qoff, kvlen, TC_BK, kbeg, kend);
  const int nk = kend > kbeg ? (kend - kbeg + TC_BK - 1) / TC_BK : 0;

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
        const int k0 = kbeg + it * TC_BK;
        mbar_expect_tx(kfull(s), L::KVBYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load(kb + c * L::KBOX, &tk, kfull(s), c * BOX, kvh, k0, b);
        mbar_expect_tx(vfull(s), L::KVBYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load(vb + c * L::KBOX, &tv, vfull(s), c * BOX, kvh, k0, b);
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
  // absolute positions of the warpgroup's first and last rows (cut at Sq)
  const int qa0 = q0 + 64 * wg + qoff;
  const int qa1 = min(q0 + 64 * wg + 64, Sq) - 1 + qoff;
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
    const int k0 = kbeg + it * TC_BK;

    // S = Q K^T: HD/16 steps of 16 columns (32 bytes) within the boxes
    mbar_wait(kfull(st), ph);
    if (k0 >= kvlen
        || (causal && (k0 > qa1 || k0 + TC_BK - 1 <= qa0 - window))) {
      // no key of the tile is allowed for any row of this warpgroup: the
      // tile would add exp(NEG_INF - m) = 0 to every row (a sliding
      // window's edge; never under the plain causal mask)
      mbar_wait(vfull(st), ph);
      mbar_arrive(empty(st));
      continue;
    }
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
    wgmma_wait<0>();
    fence_regs(s);

    // scale to the log2 domain; mask only the tiles on the diagonal, on
    // the window's edge and past kv_len
    const bool edge = k0 + TC_BK > kvlen
                      || (causal && (k0 + TC_BK - 1 > qa0
                                     || k0 <= qa1 - window));
#pragma unroll
    for (int n = 0; n < NS / 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * n + ccol + (e & 1);
          const int row = qrow + 8 * (e >> 1);
          if (!allowed(col, row + qoff, causal, window, kvlen)) x = NEG_INF;
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
    const float e0 = row_ref(m0), e1 = row_ref(m1);
    // P in bf16 pairs hi (p) and lo (pl): [2n + i] holds row qrow + 8i,
    // columns 8n + ccol, +1
    uint32_t p[NS / 2], pl[NS / 2];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
      const float a0 = exp2f(s[4 * n] - e0), a1 = exp2f(s[4 * n + 1] - e0);
      const float b0 = exp2f(s[4 * n + 2] - e1), b1 = exp2f(s[4 * n + 3] - e1);
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
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  const float r0 = 1.f / fmaxf(l0, 1e-37f), r1 = 1.f / fmaxf(l1, 1e-37f);
  // natural-log lse of the scaled scores: m is in the log2 domain; NEG_INF
  // for a row with no allowed key (l = 0: its output is 0)
  if (lse != nullptr && (lane & 3) == 0) {
    constexpr float LN2 = 0.69314718055994531f;
    float* lb = lse + (long long)bh * Sq;
    if (qrow < Sq)
      lb[qrow] = l0 > 0.f ? m0 * LN2 + logf(fmaxf(l0, 1e-37f)) : NEG_INF;
    if (qrow + 8 < Sq)
      lb[qrow + 8] = l1 > 0.f ? m1 * LN2 + logf(fmaxf(l1, 1e-37f)) : NEG_INF;
  }
  const long long ostride = (long long)H * HD;
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * HD + ccol;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qrow + 8 * i;
    if (row >= Sq) continue;
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

// Make the primary context of the runtime's current device current in this
// thread, as encoding a tensor map needs: a thread that has made no CUDA
// call (autograd's, a fresh Python thread) has no current context.  The
// wrapper sets the device before the call (kernels/_build.py::launch), and
// cudaSetDevice makes that device's primary context current (CUDA 12).
cudaError_t bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
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
                 float* lse, long long B, long long S, long long H,
                 long long KV, const Mask& mk, cudaStream_t stream) {
  const size_t smem = TcLayout<HD>::SMEM;
  auto kernel = flash_fwd_wgmma<HD>;
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, HD, TC_BQ)
      || !tensor_map(&tk, k, B, mk.skv, KV, HD, TC_BK)
      || !tensor_map(&tv, v, B, mk.skv, KV, HD, TC_BK))
    return (int)cudaErrorInvalidValue;
  const long long nq = (S + TC_BQ - 1) / TC_BQ;
  const long long blocks = B * H * nq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  kernel<<<(unsigned)blocks, TC_THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, (int)S, (int)H, (int)KV,
      (int)(B * H), (int)nq, mk.causal, mk.window, mk.qoff, mk.kvlen,
      scale_log2);
  return (int)cudaGetLastError();
}

// ---- flash backward: flash_bwd_dq_kernel, flash_bwd_dkdv_kernel ---------

// s[i][j] = A[rows ty*RQ + i] . B[rows tx + 16 j] over HD columns (row
// stride QS), in fp32 FMAs: the thread's RQ x RK tile of A B^T.
template <int HD, int QS, int RQ, int RK>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float (&s)[RQ][RK]) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[RQ], c[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) a[i] = load4(A + (ty * RQ + i) * QS + d);
#pragma unroll
    for (int j = 0; j < RK; ++j) c[j] = load4(Bm + (tx + 16 * j) * QS + d);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, c[j].x, t);
        t = fmaf(a[i].y, c[j].y, t);
        t = fmaf(a[i].z, c[j].z, t);
        t = fmaf(a[i].w, c[j].w, t);
        s[i][j] = t;
      }
  }
}

// rows [r0, r0 + R) of a (B, S, heads, HD) tensor at ``base`` (position
// stride ``stride``) into shared memory as fp32 times ``mul``, rows past S
// as zeros.
template <typename T, int HD, int QS, int R>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      long long stride, int r0, int S,
                                      float mul, int tid) {
  constexpr int H4 = HD / 4;
  for (int i = tid; i < R * H4; i += THREADS) {
    const int r = i / H4, c = (i % H4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      x = load4(base + (r0 + r) * stride + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * QS + c) = x;
  }
}

// p of one score element: exp(s - lse), 0 where masked (a query past Sq,
// or a key the mask does not allow it: past kv_len, or, under the causal
// mask, after its query or at or below its window's edge).
__device__ __forceinline__ float prob(float s, float lse, int row, int col,
                                      int Sq, const Mask& mk) {
  const bool masked = row >= Sq
                      || !allowed(col, row + mk.qoff, mk.causal, mk.window,
                                  mk.kvlen);
  return masked ? 0.f : expf(s - lse);
}

// One block per (b, h, query tile of TQ): delta of its rows (written for
// the dK/dV launch), then dQ over the key tiles up to the diagonal.
template <typename T, int HD, int TQ, int TK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ delta, int Sq,
                    int H, int KV, int nq, Mask mk, float scale) {
  constexpr int QS = HD + 4, PS = TK + 4;
  constexpr int RQ = TQ / 16, RK = TK / 16, NJ = (HD + 15) / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // TQ x QS, q * scale
  float* Ds = Qs + TQ * QS;                      // TQ x QS, dout
  float* Ks = Ds + TQ * QS;                      // TK x QS
  float* Vs = Ks + TK * QS;                      // TK x QS
  float* Ss = Vs + TK * QS;                      // TQ x PS, dS
  float* Ls = Ss + TQ * PS;                      // TQ lse
  float* Es = Ls + TQ;                           // TQ delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long BH = (long long)gridDim.x / nq;
  const long long bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * TQ;   // longest first
  const long long b = bh / H;
  const int h = (int)(bh % H);
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * HD, kstride = (long long)KV * HD;
  const long long qbase = (b * Sq * H + h) * HD;
  const long long kbase = (b * mk.skv * KV + kvh) * HD;

  stage<T, HD, QS, TQ>(Qs, q + qbase, qstride, q0, Sq, scale, tid);
  stage<T, HD, QS, TQ>(Ds, dout + qbase, qstride, q0, Sq, 1.f, tid);
  __syncthreads();
  // delta = rowsum(dout * out), out as stored; 16 threads share a row
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    float acc = 0.f;
    if (q0 + r < Sq)
      for (int c = 4 * tx; c < HD; c += 64) {
        const float4 a = load4(o + qbase + (q0 + r) * qstride + c);
        const float4 d = load4(Ds + r * QS + c);
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
        acc = fmaf(a.z, d.z, acc);
        acc = fmaf(a.w, d.w, acc);
      }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (tx == 0) {
      const bool in = q0 + r < Sq;
      Es[r] = acc;
      Ls[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
      if (in) delta[bh * Sq + q0 + r] = acc;
    }
  }

  float acc[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int kbeg, kend;
  key_range(q0, TQ, Sq, mk.causal, mk.window, mk.qoff, mk.kvlen, TK, kbeg,
            kend);
  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    __syncthreads();                   // last tile's K, V, dS reads are done
    stage<T, HD, QS, TK>(Ks, k + kbase, kstride, k0, mk.skv, 1.f, tid);
    stage<T, HD, QS, TK>(Vs, v + kbase, kstride, k0, mk.skv, 1.f, tid);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    tile_dot<HD, QS, RQ, RK>(Qs, Ks, ty, tx, s);
    tile_dot<HD, QS, RQ, RK>(Ds, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = prob(s[i][j], Ls[r], q0 + r, k0 + tx + 16 * j, Sq,
                             mk);
        Ss[r * PS + tx + 16 * j] = p * (dp[i][j] - Es[r]);
      }
    }
    __syncthreads();
    // dQ += dS K
#pragma unroll 2
    for (int kk = 0; kk < TK; kk += 4) {
      float4 pa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pa[i] = load4(Ss + (ty * RQ + i) * PS + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (HD >= 16 || c < HD) {
          const float k0v = Ks[(kk + 0) * QS + c], k1v = Ks[(kk + 1) * QS + c];
          const float k2v = Ks[(kk + 2) * QS + c], k3v = Ks[(kk + 3) * QS + c];
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            float t = acc[i][j];
            t = fmaf(pa[i].x, k0v, t);
            t = fmaf(pa[i].y, k1v, t);
            t = fmaf(pa[i].z, k2v, t);
            t = fmaf(pa[i].w, k3v, t);
            acc[i][j] = t;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (HD >= 16 || c < HD)
        store1(dq + qbase + r * qstride + c, acc[i][j] * scale);
    }
  }
}

// One block per (b, KV head, key tile of TK): dK and dV of its keys, summed
// over the g query heads of the group and every query tile at or below the
// diagonal, in that fixed order (no atomics: two runs are bit-identical).
template <typename T, int HD, int TQ, int TK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const T* __restrict__ dout, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int H, int KV, int nk,
                      Mask mk, float scale) {
  constexpr int QS = HD + 4, PS = TK + 4;
  constexpr int RQ = TQ / 16, RK = TK / 16, NJ = (HD + 15) / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // TQ x QS, q * scale
  float* Ds = Qs + TQ * QS;                      // TQ x QS, dout
  float* Ks = Ds + TQ * QS;                      // TK x QS
  float* Vs = Ks + TK * QS;                      // TK x QS
  float* Ps = Vs + TK * QS;                      // TQ x PS, P
  float* Ss = Ps + TQ * PS;                      // TQ x PS, dS
  float* Ls = Ss + TQ * PS;                      // TQ lse
  float* Es = Ls + TQ;                           // TQ delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long BKV = (long long)gridDim.x / nk;
  const long long bkv = blockIdx.x % BKV;
  const int k0 = (int)(blockIdx.x / BKV) * TK;   // causal: longest first
  const long long b = bkv / KV;
  const int kvh = (int)(bkv % KV), g = H / KV;
  const long long qstride = (long long)H * HD, kstride = (long long)KV * HD;
  const long long kbase = (b * mk.skv * KV + kvh) * HD;

  stage<T, HD, QS, TK>(Ks, k + kbase, kstride, k0, mk.skv, 1.f, tid);
  stage<T, HD, QS, TK>(Vs, v + kbase, kstride, k0, mk.skv, 1.f, tid);

  float dka[RK][NJ], dva[RK][NJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  // the query tiles that can see a key of this tile: from its first key's
  // diagonal to its last key's window edge
  int qbeg, qend;
  query_range(k0, TK, Sq, mk.causal, mk.window, mk.qoff, mk.kvlen, TQ, qbeg,
              qend);
  for (int gi = 0; gi < g; ++gi) {
    const int h = kvh * g + gi;
    const long long bh = b * H + h;
    const long long qbase = (b * Sq * H + h) * HD;
    for (int q0 = qbeg; q0 < qend; q0 += TQ) {
      __syncthreads();                 // last tile's Q, dO, P, dS reads done
      stage<T, HD, QS, TQ>(Qs, q + qbase, qstride, q0, Sq, scale, tid);
      stage<T, HD, QS, TQ>(Ds, dout + qbase, qstride, q0, Sq, 1.f, tid);
      for (int r = tid; r < TQ; r += THREADS) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
        Es[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[RQ][RK], dp[RQ][RK];
      tile_dot<HD, QS, RQ, RK>(Qs, Ks, ty, tx, s);
      tile_dot<HD, QS, RQ, RK>(Ds, Vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty * RQ + i;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int c = tx + 16 * j;
          const float p = prob(s[i][j], Ls[r], q0 + r, k0 + c, Sq, mk);
          Ps[r * PS + c] = p;
          Ss[r * PS + c] = p * (dp[i][j] - Es[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T (q * scale): this thread's keys
      // ty*RK .. + RK - 1, columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < TQ; ++r) {
        float pr[RK], sr[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = Ps[r * PS + ty * RK + i];
          sr[i] = Ss[r * PS + ty * RK + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          if (HD >= 16 || c < HD) {
            const float dov = Ds[r * QS + c], qv = Qs[r * QS + c];
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              dva[i][j] = fmaf(pr[i], dov, dva[i][j]);
              dka[i][j] = fmaf(sr[i], qv, dka[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = k0 + ty * RK + i;
    if (r >= mk.skv) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (HD >= 16 || c < HD) {
        store1(dk + kbase + r * kstride + c, dka[i][j]);
        store1(dv + kbase + r * kstride + c, dva[i][j]);
      }
    }
  }
}

// Both backward launches: dQ (and delta) first, then dK / dV, which read
// delta.  Tiles of 64 x 64 (32 x 32 at head_dim 256, for shared memory).
template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, long long B, long long S, long long H,
               long long KV, const Mask& mk, cudaStream_t stream) {
  constexpr int TB = HD > 128 ? 32 : 64;
  constexpr int QS = HD + 4, PS = TB + 4;
  const size_t smem_dq = sizeof(float) * ((size_t)4 * TB * QS + TB * PS
                                          + 2 * TB);
  const size_t smem_kv = sizeof(float) * ((size_t)4 * TB * QS + 2 * TB * PS
                                          + 2 * TB);
  auto kdq = flash_bwd_dq_kernel<T, HD, TB, TB>;
  auto kkv = flash_bwd_dkdv_kernel<T, HD, TB, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const long long nt = (S + TB - 1) / TB;
  const long long nkt = (mk.skv + TB - 1) / TB;
  if (B * H * nt > 0x7fffffffLL || B * KV * nkt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)HD));
  kdq<<<(unsigned)(B * H * nt), THREADS, smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, lse,
      (const T*)dout, (T*)dq, delta, (int)S, (int)H, (int)KV, (int)nt, mk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<(unsigned)(B * KV * nkt), THREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, delta, (const T*)dout,
      (T*)dk, (T*)dv, (int)S, (int)H, (int)KV, (int)nkt, mk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* delta, long long B, long long S, long long H,
                 long long KV, long long hd, const Mask& mk,
                 cudaStream_t st) {
  switch (hd) {
#define BWD(HD)                                                             \
  case HD:                                                                  \
    return launch_bwd<T, HD>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, \
                             H, KV, mk, st);
    BWD(8) BWD(16) BWD(32) BWD(64) BWD(128) BWD(256)
#undef BWD
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- flash backward on the tensor cores: flash_bwd_dq_wgmma and
// flash_bwd_dkdv_wgmma (bf16, head_dim 64 and 128) ------------------------

constexpr int BW_Q = 128;              // dq: queries per CTA, 2 x 64
constexpr int BW_K = 64;               // dq: keys per K/V tile
constexpr int BW_KEYS = 128;           // dkdv: keys per CTA, 2 x 64
constexpr int BW_QT = 64;              // dkdv: queries per Q/dO tile
constexpr int BW_STAGES = 3;           // ring depth of both kernels
constexpr float LOG2E = 1.4426950408889634f;
// Both kernels run two consumer warpgroups and a producer warpgroup of
// which one warp works: ptxas sizes registers for 3 warpgroups (168 a
// thread), and setmaxnreg hands the producer's to the consumers, which
// would spill at 168 (the accumulators alone take 128 at head_dim 128).
constexpr int BW_THREADS = TC_CONSUMERS + 128;
constexpr int BW_PRODUCER_REGS = 24;   // setmaxnreg: the producer warpgroup
constexpr int BW_CONSUMER_REGS = 240;  // and each consumer thread

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) * B (64 x 16, smem), both
// K-major, 128-byte swizzled; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) = A B^T over HD columns: A's 64 rows at a, B's 64 rows at b,
// each HD/64 boxes of 128-byte rows (box strides abox, bbox), K-major.
template <int HD>
__device__ __forceinline__ void mma_ss_hd(float (&d)[32], uint32_t a,
                                          uint32_t abox, uint32_t b,
                                          uint32_t bbox) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss_n64(d, sw128_desc(a + (kk >> 2) * abox + off, 16, 1024),
                 sw128_desc(b + (kk >> 2) * bbox + off, 16, 1024), kk > 0);
  }
}

// A 64 x 64 accumulator tile (this thread: rows r and r + 8) as the bf16
// A fragments of a product whose k runs over its 64 columns: [2n + i]
// holds row r + 8i, columns 8n + ccol and + 1.
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&f)[16]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(x[4 * n + 2 * i], x[4 * n + 2 * i + 1]);
      f[2 * n + i] = *reinterpret_cast<const uint32_t*>(&h);
    }
}

// D (64 x HD) += A (64 x 64, the fragments f) * B (64 x HD): B's 64 rows at
// b, HD/64 boxes of 64 rows x 128 bytes (box stride ``box``), read
// MN-major, 16 rows (2048 bytes) a step.
template <int HD>
__device__ __forceinline__ void mma_rs_k64(float (&d)[HD / 2],
                                           const uint32_t (&f)[16],
                                           uint32_t b, uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                           f[4 * kk + 3]};
    wgmma_pv<HD>(d, a, sw128_desc(b + kk * 16 * 128, box, 1024));
  }
}

// acc plus the dot product of two 16-byte words of 8 bf16 values each
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* c = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(a[j]), w = __bfloat1622float2(c[j]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// Shared memory of both kernels (offsets from a 1024-byte aligned base).
// dq: the Q and dO tiles (HD/64 boxes of BW_Q rows x 128 bytes each), then
// BW_STAGES x (K tile, V tile) of HD/64 boxes of BW_K rows, then the
// mbarriers: Q/dO full, per stage full and empty.  dkdv: the K and V tiles
// (boxes of BW_KEYS rows), then BW_STAGES x (Q tile, dO tile) of boxes of
// BW_QT rows, then BW_STAGES x (lse * log2 e, delta) rows of BW_QT floats,
// then the mbarriers: K/V full, per stage full and empty.
template <int HD>
struct BwLayout {
  static constexpr int NB = HD / BOX;
  static constexpr uint32_t QBOX = BW_Q * 128, KBOX = BW_K * 128;
  static constexpr uint32_t DQ_Q = NB * QBOX, DQ_KV = NB * KBOX;
  static constexpr uint32_t DQ_BARS = 2 * DQ_Q + BW_STAGES * 2 * DQ_KV;
  static constexpr size_t DQ_SMEM = 1024 + DQ_BARS + 8 * (1 + 2 * BW_STAGES);
  static constexpr uint32_t KVBOX = BW_KEYS * 128, QTBOX = BW_QT * 128;
  static constexpr uint32_t KV_KV = NB * KVBOX, KV_Q = NB * QTBOX;
  static constexpr uint32_t KV_ROWS = 2 * KV_KV + BW_STAGES * 2 * KV_Q;
  static constexpr uint32_t KV_BARS = KV_ROWS + BW_STAGES * 2 * BW_QT * 4;
  static constexpr size_t KV_SMEM = 1024 + KV_BARS + 8 * (1 + 2 * BW_STAGES);
};

// One CTA per (b, h, BW_Q-query tile), the longest causal tiles first:
// delta of its rows (written for the dK/dV launch), then dQ over the key
// tiles up to the diagonal.
template <int HD>
__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                   int Sq, int H, int KV, int BH, int nq, Mask mk,
                   float scale, float scale_log2) {
  using L = BwLayout<HD>;
  constexpr int NA = HD / 2;           // dQ accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + L::DQ_Q;
  const uint32_t bars = sq + L::DQ_BARS;
  const uint32_t qfull = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + BW_STAGES + s); };
  auto kbuf = [&](int s) { return sq + 2u * L::DQ_Q + 2u * s * L::DQ_KV; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BW_Q;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int causal = mk.causal, window = mk.window, kvlen = mk.kvlen;
  int kbeg, kend;
  key_range(q0, BW_Q, Sq, causal, window, mk.qoff, kvlen, BW_K, kbeg, kend);
  const int nk = kend > kbeg ? (kend - kbeg + BW_K - 1) / BW_K : 0;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {           // the producer: one thread works
    setmaxnreg_dec<BW_PRODUCER_REGS>();
    if (tid == TC_CONSUMERS) {
      mbar_expect_tx(qfull, 2 * L::DQ_Q);
      for (int c = 0; c < L::NB; ++c) {
        tma_load(sq + c * L::QBOX, &tq, qfull, c * BOX, h, q0, b);
        tma_load(sdo + c * L::QBOX, &tdo, qfull, c * BOX, h, q0, b);
      }
      for (int it = 0; it < nk; ++it) {
        const int s = it % BW_STAGES;
        if (it >= BW_STAGES) mbar_wait(empty(s), ((it / BW_STAGES) - 1) & 1);
        const uint32_t kb = kbuf(s), vb = kb + L::DQ_KV;
        const int k0 = kbeg + it * BW_K;
        mbar_expect_tx(full(s), 2 * L::DQ_KV);
        for (int c = 0; c < L::NB; ++c) {
          tma_load(kb + c * L::KBOX, &tk, full(s), c * BOX, kvh, k0, b);
          tma_load(vb + c * L::KBOX, &tv, full(s), c * BOX, kvh, k0, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<BW_CONSUMER_REGS>();
    // consumers: warpgroup wg owns query rows q0 + 64*wg .. + 63; this thread
    // holds rows qrow and qrow + 8, columns 8n + ccol and + 1 of each 8-block
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int qrow = q0 + 64 * wg + 16 * warp + (lane >> 2);
    const int ccol = 2 * (lane & 3);
    const long long qstride = (long long)H * HD;
    const long long qbase = ((long long)b * Sq * H + h) * HD;
    // absolute positions of the warpgroup's first and last rows (cut at Sq)
    const int qa0 = q0 + 64 * wg + mk.qoff;
    const int qa1 = min(q0 + 64 * wg + 64, Sq) - 1 + mk.qoff;
    // delta = rowsum(dout * out) of rows qrow and qrow + 8 (out as stored):
    // the 4 threads of a row take a quarter of its columns each
    float dl[2], l2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qrow + 8 * i;
      float acc = 0.f;
      if (row < Sq) {
        const long long at = qbase + row * qstride + (lane & 3) * (HD / 4);
#pragma unroll
        for (int j = 0; j < HD / 32; ++j)
          acc = dot8(__ldg(reinterpret_cast<const uint4*>(o + at) + j),
                     __ldg(reinterpret_cast<const uint4*>(dout + at) + j), acc);
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      acc += __shfl_xor_sync(FULL, acc, 2);
      dl[i] = acc;
      l2[i] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : 0.f;
      if ((lane & 3) == 0 && row < Sq) delta[(long long)bh * Sq + row] = acc;
    }

    const uint32_t qa = sq + wg * 64 * 128, da = sdo + wg * 64 * 128;
    float acc[NA], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(qfull, 0);

    for (int it = 0; it < nk; ++it) {
      const int st = it % BW_STAGES;
      const uint32_t ph = (it / BW_STAGES) & 1;
      const uint32_t kb = kbuf(st), vb = kb + L::DQ_KV;
      const int k0 = kbeg + it * BW_K;
      mbar_wait(full(st), ph);
      if (k0 >= kvlen                // no key allowed for this warpgroup's
          || (causal && (k0 > qa1    // rows: past them, or below the window
                         || k0 + BW_K - 1 <= qa0 - window))) {
        mbar_arrive(empty(st));
        continue;
      }
      // S = Q K^T, then dP = dO V^T (both operands in shared memory): P is
      // computed while dP's product runs
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_ss_hd<HD>(s, qa, L::QBOX, kb, L::KBOX);
      wgmma_commit();
      mma_ss_hd<HD>(dp, da, L::QBOX, vb, L::KBOX);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P = exp2(S scale log2 e - lse log2 e) in place of S, masked on the
      // diagonal, window-edge, kv_len and ragged tiles only; then dS = P
      // (dP - delta) in place of dP
      const bool edge = k0 + BW_K > kvlen || q0 + 64 * wg + 64 > Sq
                        || (causal && (k0 + BW_K - 1 > qa0
                                       || k0 <= qa1 - window));
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[4 * n + e], scale_log2, -l2[e >> 1]));
          if (edge) {
            const int col = k0 + 8 * n + ccol + (e & 1);
            const int row = qrow + 8 * (e >> 1);
            if (row >= Sq || !allowed(col, row + mk.qoff, causal, window,
                                      kvlen))
              p = 0.f;
          }
          s[4 * n + e] = p;
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);

      // dQ += dS K: dS from registers, K read MN-major
      uint32_t ds[16];
      to_frags(dp, ds);
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
      mma_rs_k64<HD>(acc, ds, kb, L::KBOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds);
      mbar_arrive(empty(st));
    }

    __nv_bfloat16* qb = dq + qbase + ccol;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qrow + 8 * i;
      if (row >= Sq) continue;
      __nv_bfloat16* dst = qb + row * qstride;
#pragma unroll
      for (int n = 0; n < NA / 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
            acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
    }
  }
}

// One CTA per (b, KV head, BW_KEYS-key tile), key tile 0 (the longest under
// the causal mask) first: dK and dV of its keys, summed over the g query
// heads of the group and their query tiles from the diagonal down, in that
// fixed order, inside the CTA (no atomics: two runs are bit-identical).
template <int HD>
__global__ void __launch_bounds__(BW_THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int H, int KV,
                     int BKV, Mask mk, float scale, float scale_log2) {
  using L = BwLayout<HD>;
  constexpr int NA = HD / 2;           // dK and dV accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + L::KV_KV;
  float* rows = reinterpret_cast<float*>(
      smem_raw + (sk + L::KV_ROWS - smem_u32(smem_raw)));
  const uint32_t bars = sk + L::KV_BARS;
  const uint32_t kvfull = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + BW_STAGES + s); };
  auto qbuf = [&](int s) { return sk + 2u * L::KV_KV + 2u * s * L::KV_Q; };

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x % BKV;
  const int k0 = (int)(blockIdx.x / BKV) * BW_KEYS;
  const int b = bkv / KV, kvh = bkv % KV, g = H / KV;
  const int causal = mk.causal, window = mk.window, kvlen = mk.kvlen;
  const int qoff = mk.qoff;
  // the query tiles that can see a key of this tile: from its first key's
  // diagonal to its last key's window edge
  int qstart, qend;
  query_range(k0, BW_KEYS, Sq, causal, window, qoff, kvlen, BW_QT, qstart,
              qend);
  const int ntq = qend > qstart ? (qend - qstart + BW_QT - 1) / BW_QT : 0;
  const int n_it = g * ntq;

  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1 + 32);      // the copies, and each producer lane
      mbar_init(empty(s), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {           // the producer: its first warp works
    setmaxnreg_dec<BW_PRODUCER_REGS>();
    if (tid < TC_CONSUMERS + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_expect_tx(kvfull, 2 * L::KV_KV);
        for (int c = 0; c < L::NB; ++c) {
          tma_load(sk + c * L::KVBOX, &tk, kvfull, c * BOX, kvh, k0, b);
          tma_load(sv + c * L::KVBOX, &tv, kvfull, c * BOX, kvh, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % BW_STAGES;
        const int h = kvh * g + it / ntq, q0 = qstart + (it % ntq) * BW_QT;
        const long long bh = (long long)b * H + h;
        if (it >= BW_STAGES) mbar_wait(empty(s), ((it / BW_STAGES) - 1) & 1);
        if (lane == 0) {
          const uint32_t qb = qbuf(s), db = qb + L::KV_Q;
          mbar_expect_tx(full(s), 2 * L::KV_Q);
          for (int c = 0; c < L::NB; ++c) {
            tma_load(qb + c * L::QTBOX, &tq, full(s), c * BOX, h, q0, b);
            tma_load(db + c * L::QTBOX, &tdo, full(s), c * BOX, h, q0, b);
          }
        }
        // the tile's lse (log2 domain) and delta rows, zero past S
        float* lr = rows + s * 2 * BW_QT;
        for (int j = lane; j < BW_QT; j += 32) {
          const int r = q0 + j;
          lr[j] = r < Sq ? lse[bh * Sq + r] * LOG2E : 0.f;
          lr[BW_QT + j] = r < Sq ? delta[bh * Sq + r] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    setmaxnreg_inc<BW_CONSUMER_REGS>();
    // consumers: warpgroup wg owns keys k0 + 64*wg .. + 63 (kmin ..); this
    // thread holds keys krow and krow + 8, query columns 8n + ccol and + 1
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int kmin = k0 + 64 * wg;
    const int krow = kmin + 16 * warp + (lane >> 2);
    const int ccol = 2 * (lane & 3);
    const uint32_t ka = sk + wg * 64 * 128, va = sv + wg * 64 * 128;
    float dka[NA], dva[NA], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(kvfull, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % BW_STAGES;
      const uint32_t ph = (it / BW_STAGES) & 1;
      const uint32_t qb = qbuf(st), db = qb + L::KV_Q;
      const int q0 = qstart + (it % ntq) * BW_QT;
      mbar_wait(full(st), ph);
      if (kmin >= kvlen              // no pair allowed: every key past kv_len,
          || (causal && (q0 + BW_QT - 1 + qoff < kmin  // every query before
                         || kmin + 63 <= q0 + qoff - window))) {  // or past
        mbar_arrive(empty(st));      // every key's window
        continue;
      }
      // S^T = K Q^T, then dP^T = V dO^T (both operands in shared memory):
      // P^T is computed while dP^T's product runs
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_ss_hd<HD>(s, ka, L::KVBOX, qb, L::QTBOX);
      wgmma_commit();
      mma_ss_hd<HD>(dp, va, L::KVBOX, db, L::QTBOX);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T = exp2(S^T scale log2 e - lse log2 e) in place of S^T, then
      // dS^T = P^T (dP^T - delta) in place of dP^T; lse and delta are per
      // column (query), from the tile's rows in shared memory
      const float* lr = rows + st * 2 * BW_QT;
      const bool edge = q0 + BW_QT > Sq || kmin + 64 > kvlen
                        || (causal && (kmin + 63 > q0 + qoff
                                       || kmin <= q0 + BW_QT - 1 + qoff
                                                      - window));
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * n + ccol);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          float p = exp2f(fmaf(s[4 * n + e], scale_log2, -(c ? l2.y : l2.x)));
          if (edge) {
            const int col = q0 + 8 * n + ccol + c, row = krow + 8 * (e >> 1);
            if (col >= Sq || !allowed(row, col + qoff, causal, window, kvlen))
              p = 0.f;
          }
          s[4 * n + e] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(lr + BW_QT + 8 * n + ccol);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n + e] =
              s[4 * n + e] * (dp[4 * n + e] - (e & 1 ? d2.y : d2.x));
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q read
      // MN-major
      uint32_t pf[16], sf[16];
      to_frags(s, pf);
      to_frags(dp, sf);
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pf);
      fence_regs(sf);
      wgmma_fence();
      mma_rs_k64<HD>(dva, pf, db, L::QTBOX);
      mma_rs_k64<HD>(dka, sf, qb, L::QTBOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pf);
      fence_regs(sf);
      mbar_arrive(empty(st));
    }

    const long long kstride = (long long)KV * HD;
    const long long koff = ((long long)b * mk.skv * KV + kvh) * HD + ccol;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = krow + 8 * i;
      if (row >= mk.skv) continue;
      __nv_bfloat16* dkr = dk + koff + row * kstride;
      __nv_bfloat16* dvr = dv + koff + row * kstride;
#pragma unroll
      for (int n = 0; n < NA / 4; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * n) = __floats2bfloat162_rn(
            dka[4 * n + 2 * i] * scale, dka[4 * n + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * n) = __floats2bfloat162_rn(
            dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
      }
    }
  }
}

// Both tensor-core backward launches: dQ (and delta), then dK / dV.
template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     void* dq, void* dk, void* dv, float* delta, long long B,
                     long long S, long long H, long long KV, const Mask& mk,
                     cudaStream_t stream) {
  using L = BwLayout<HD>;
  auto kdq = flash_bwd_dq_wgmma<HD>;
  auto kkv = flash_bwd_dkdv_wgmma<HD>;
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tdo, tk, tv, tk2, tv2, tq2, tdo2;
  if (!tensor_map(&tq, q, B, S, H, HD, BW_Q)
      || !tensor_map(&tdo, dout, B, S, H, HD, BW_Q)
      || !tensor_map(&tk, k, B, mk.skv, KV, HD, BW_K)
      || !tensor_map(&tv, v, B, mk.skv, KV, HD, BW_K)
      || !tensor_map(&tk2, k, B, mk.skv, KV, HD, BW_KEYS)
      || !tensor_map(&tv2, v, B, mk.skv, KV, HD, BW_KEYS)
      || !tensor_map(&tq2, q, B, S, H, HD, BW_QT)
      || !tensor_map(&tdo2, dout, B, S, H, HD, BW_QT))
    return (int)cudaErrorInvalidValue;
  const long long nq = (S + BW_Q - 1) / BW_Q;
  const long long nkt = (mk.skv + BW_KEYS - 1) / BW_KEYS;
  if (B * H * nq > 0x7fffffffLL || B * KV * nkt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const double scale = 1.0 / sqrt((double)HD);
  const float scale_log2 = (float)(1.4426950408889634 * scale);
  kdq<<<(unsigned)(B * H * nq), BW_THREADS, L::DQ_SMEM, stream>>>(
      tq, tdo, tk, tv, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      lse, (__nv_bfloat16*)dq, delta, (int)S, (int)H, (int)KV, (int)(B * H),
      (int)nq, mk, (float)scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<(unsigned)(B * KV * nkt), BW_THREADS, L::KV_SMEM, stream>>>(
      tk2, tv2, tq2, tdo2, lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, (int)S, (int)H, (int)KV, (int)(B * KV), mk,
      (float)scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long S, long long Skv, long long H, long long KV,
    long long hd, long long causal, long long window, long long q_offset,
    long long kv_len, long long bf16, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Mask mk;
  if (!make_mask(S, Skv, causal, window, q_offset, kv_len, mk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;              // (B, H, S) fp32, or null: not written
  // both kernels read 16-byte pieces (TMA boxes, float4 / 8-byte loads)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // bf16 at head_dim 64 / 128 goes to the tensor cores
  if (bf16 && hd == 128)
    return launch_wgmma<128>(q, k, v, o, l, B, S, H, KV, mk, st);
  if (bf16 && hd == 64)
    return launch_wgmma<64>(q, k, v, o, l, B, S, H, KV, mk, st);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, l, B, S, H, KV, hd, mk, st)
              : dispatch<float>(q, k, v, o, l, B, S, H, KV, hd, mk, st);
}

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, long long B, long long S, long long Skv, long long H,
    long long KV, long long hd, long long causal, long long window,
    long long q_offset, long long kv_len, long long bf16, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Mask mk;
  if (!make_mask(S, Skv, causal, window, q_offset, kv_len, mk))
    return (int)cudaErrorInvalidValue;
  // the kernels read 16-byte (fp32) or 8-byte (bf16) pieces
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o
       | (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv
       | (uintptr_t)lse | (uintptr_t)delta) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* e = (float*)delta;
  // bf16 at head_dim 64 / 128 goes to the tensor cores
  if (bf16 && hd == 128)
    return launch_bwd_wgmma<128>(q, k, v, o, l, dout, dq, dk, dv, e, B, S, H,
                                 KV, mk, st);
  if (bf16 && hd == 64)
    return launch_bwd_wgmma<64>(q, k, v, o, l, dout, dq, dk, dv, e, B, S, H,
                                KV, mk, st);
  return bf16 ? dispatch_bwd<__nv_bfloat16>(q, k, v, o, l, dout, dq, dk, dv, e,
                                            B, S, H, KV, hd, mk, st)
              : dispatch_bwd<float>(q, k, v, o, l, dout, dq, dk, dv, e, B, S,
                                    H, KV, hd, mk, st);
}
