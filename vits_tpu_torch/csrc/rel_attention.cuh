// VITS windowed relative-position self-attention with an online softmax:
//
//   s[i, j] = q_i . k_j + (|j - i| <= w ? q_i . rel_k[j - i + w] : 0)
//             + (j < len ? 0 : finfo(float32).min)
//   out_i   = sum_j p[i, j] v_j + sum_{|r - w| <= w} p[i, i + r - w] rel_v[r]
//
// q arrives pre-scaled by 1/sqrt(d). With a non-null lse the kernel also
// writes each query row's logsumexp m + log(l), the residual the backward
// (rel_attention_bwd.cu) rebuilds the probabilities from. Replaces
// vits_tpu/ops/pallas/attention.py::flash_rel_attention (_attn_kernel). The key
// mask is the module's finite additive finfo.min, never -inf: a padding row
// (len = 0) then gets a uniform softmax over its keys and stays finite, like
// the JAX module and kernel; -inf would give 0/0 = NaN, and a later multiply by
// the zero mask does not clear NaN.
//
// What bounds it on an H100: latency. At the encoder's shapes (H=2, d=96,
// L <= 512) the whole attention is under 0.2 GFLOP per row, a few us of FFMA,
// and nothing quadratic touches device memory, so the time is the chain of
// dependent steps each warp walks. The design cuts that chain:
// - One block per (batch, head, 16-query tile) with up to 8 warps that split
//   the keys: warp w takes 16-key steps w, w + 8, ..., each with its own
//   online-softmax state (m, l, acc), merged once through shared memory at the
//   end. There is no block barrier inside the key loop.
// - Each warp streams its K and V steps through its own two-stage cp.async
//   buffer (the next step lands while this one computes; __syncwarp only).
// - The products are register-tiled FFMA: for q.k a lane holds 4 queries x 2
//   keys over float4 columns (rows padded to 8 + 4 floats: conflict-free), for
//   p.v 4 queries x 4 columns per 32, the probabilities moving by shuffles
//   within 8-lane groups. FFMA and not 3xTF32 MMA: the work is a few us at the
//   FFMA rate, so the tensor cores would shorten no part of the chain that
//   matters.
// - The loop stops at ceil(len / 16) steps for a row with len > 0. That is
//   exact: a key at or past len scores s + finfo.min, which rounds to finfo.min
//   in fp32, and exp(finfo.min - m) is exactly 0 because m comes from a valid
//   key. A len = 0 row walks all L keys and keeps its uniform weights.
// - The window terms cost no pass of their own. The rel-key logits q_i .
//   rel_k[r] (16 x (2w + 1) per block) are one dot a thread before the loop.
//   The lane that scores a window key keeps its final logit in shared memory;
//   after its loop each warp adds p rel_v[r] for the window keys it walked to
//   its own accumulators, p = exp(x - m_w) in the warp's softmax units, which
//   the merge rescales as it rescales the rest of the warp's sum.
// - Precision tiers (the template's M, common.cuh TierMode): every product
//   of the JAX kernel's dots (q.rel_k, q.k, p.v and the window weights'
//   rel_v term) is an fma_tier<M>: fp32 at kExact, both operands rounded to
//   bf16 at kFast (Mosaic's DEFAULT on fp32 operands), the bf16x3 split at
//   kHigh. The softmax and the merge stay fp32.
// - bf16 storage (T, the bf16 training tier): q, k, v and the tables are read
//   as bf16 and widened to fp32 where they are staged (K and V by plain loads,
//   8 values a 16-byte load, in place of cp.async), as the JAX kernel upcasts
//   its blocks (attention.py:38-95); everything after is the fp32 kernel. The
//   output is written as bf16, lse as fp32.
// - Any head width up to kMaxD and window up to kMaxW, as the JAX kernel takes
//   any d and w (its blocks are the whole d and 2w + 1). A lane owns 4 x 4 * NC
//   accumulators, NC <= 4 column groups of 32; a wider head (d > 128) is cut
//   into CH = 2 column chunks, one block each: every chunk block walks the
//   same keys (its scores and softmax over the whole d, the same bits in each)
//   and stages, accumulates and writes only its chunk's columns of V and the
//   output. The window's logits (2w + 1 per query) are per-block shared
//   arrays, so the window costs shared memory and not lanes; the tables are
//   read from device memory (L1/L2) and never staged.
//
// The kernel's templates live here; each tier's instantiations are compiled in a
// translation unit of its own (rel_attention.cu: exact and the entry point;
// rel_attention_fast.cu: fast on fp32 and bf16; rel_attention_high.cu: high), so
// that the build's nvcc processes share them.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTQ = 16;         // queries per block
constexpr int kTK = 16;         // keys per warp step
constexpr int kMaxWarps = 8;
constexpr int kMaxD = 256;      // head_dim ceiling: CH * NC * 32 columns, CH <= 2, NC <= 4
constexpr int kMaxW = 32;       // window ceiling: 2w + 1 <= 65 relative offsets
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3.402823466e+38f;  // finfo(float32).min

// K and Q row stride: d rounded up to 8, plus 4, so that the 8 rows a quarter
// warp reads as float4 at one column fall on 32 distinct banks.
inline __host__ __device__ int qk_stride(int d) { return (d + 7) / 8 * 8 + 4; }

// Fixed shared memory (floats): Q tile, rel_k logits, per-warp m and l, per-warp
// merge scales, the window keys' logits (kTQ * nr: a multiple of 16, so the
// stages after them stay 16-byte aligned).
inline __host__ __device__ int fixed_floats(int d, int nr) {
  return kTQ * qk_stride(d) + kTQ * nr + 3 * kMaxWarps * kTQ + kTQ * nr;
}

// Columns [c0, c0 + n) of rows [j0, j0 + kTK) of a bf16 (L, d) head into fp32
// rows of stride rs (zero past L), by one warp: 8 values a 16-byte load when
// vec (d % 8 == 0, aligned; c0 and n are then multiples of 8).
__device__ __forceinline__ void load_rows(float* dst, const __nv_bfloat16* src, int j0, int L,
                                          int d, int c0, int n, int rs, int vec, int lane) {
  src += c0;
  if (vec) {
    const int d8 = n >> 3;
    for (int idx = lane; idx < kTK * d8; idx += 32) {
      const int r = idx / d8, c = (idx - r * d8) * 8;
      float* o = dst + r * rs + c;
      if (j0 + r < L) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(j0 + r) * d + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          o[2 * e] = f.x;
          o[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = 0.f;
      }
    }
  } else {
    for (int idx = lane; idx < kTK * n; idx += 32) {
      const int r = idx / n, c = idx - r * n;
      dst[r * rs + c] = j0 + r < L ? ldf(src + (size_t)(j0 + r) * d + c) : 0.f;
    }
  }
}

// Rows [j0, j0 + kTK), columns [c0, c0 + n) of an fp32 (L, d) head into rows
// of stride rs (zero past L), by one warp's cp.async: 16 bytes a copy when vec
// (d % 4 == 0, aligned; c0 and n are then multiples of 4), else 4.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int j0, int L, int d,
                                          int c0, int n, int rs, int vec, int lane) {
  src += c0;
  if (vec) {
    const int d4 = n >> 2;
    for (int idx = lane; idx < kTK * d4; idx += 32) {
      const int r = idx / d4, c = (idx - r * d4) * 4;
      const bool in = j0 + r < L;
      cp_async16_zfill(dst + r * rs + c, src + (in ? (size_t)(j0 + r) * d + c : 0), in ? 16 : 0);
    }
  } else {
    for (int idx = lane; idx < kTK * n; idx += 32) {
      const int r = idx / n, c = idx - r * n;
      const bool in = j0 + r < L;
      cp_async4_zfill(dst + r * rs + c, src + (in ? (size_t)(j0 + r) * d + c : 0), in ? 4 : 0);
    }
  }
}

// NC: the float4 column groups a lane owns in p.v (ceil(d / 32) / CH); CH: the
// column chunks of the output, one block each. T: the storage of q, k, v, the
// tables and out (fp32 or bf16).
template <int NC, int CH, int M, class T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rel_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ rel_k,
                         const T* __restrict__ rel_v, const int* __restrict__ lengths,
                         T* __restrict__ out, float* __restrict__ lse, int H, int L,
                         int d, int w, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nr = 2 * w + 1;
  const int dp = qk_stride(d);  // Q and K rows
  constexpr int dv = 32 * NC;   // V rows (the chunk's columns): every column a lane reads exists
  const int chunk = CH == 1 ? 0 : blockIdx.x % CH;
  const int c0 = chunk * dv;                      // the chunk's first column
  const int ncols = d - c0 < dv ? d - c0 : dv;    // ... and its columns inside d
  const int nw = blockDim.x >> 5;
  const int stage = kTK * (dp + dv);  // K and V of one step
  float* qs = smem;                   // kTQ x dp, zero-padded
  float* rl = qs + kTQ * dp;          // kTQ x nr: q_i . rel_k[r]
  float* ms = rl + kTQ * nr;          // kMaxWarps x kTQ: each warp's running max
  float* ls = ms + kMaxWarps * kTQ;   // ... and running sum
  float* sc = ls + kMaxWarps * kTQ;   // kMaxWarps x kTQ: exp(m_w - m) / l
  float* xw = sc + kMaxWarps * kTQ;   // kTQ x nr: the window keys' final logits
  float* kv = xw + kTQ * nr;          // per warp: 2 stages of (K kTK x dp, V kTK x dv)

  const int q0 = (CH == 1 ? blockIdx.x : blockIdx.x / CH) * kTQ;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + blockIdx.y) * L * d;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  T* oh = out + head;
  float* lseh = lse ? lse + ((size_t)b * H + blockIdx.y) * L : nullptr;
  const int len = lengths[b];
  const int nk = len > 0 ? min(len, L) : L;  // keys that can weigh anything
  const int steps = (nk + kTK - 1) / kTK;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 3, kg = lane & 7;  // 4 groups of 4 queries; key / column group
  float* kvw = kv + warp * 2 * stage;

  for (int idx = tid; idx < kTQ * dp; idx += blockDim.x) {
    const int r = idx / dp, c = idx - r * dp;
    qs[idx] = c < d && q0 + r < L ? ldf(qh + (size_t)(q0 + r) * d + c) : 0.f;
  }
  // padding columns of K and V are never copied: they stay zero
  for (int idx = tid; idx < nw * 2 * stage; idx += blockDim.x) kv[idx] = 0.f;
  // a window key no step walks (past the sequence, or at or past len) weighs 0
  for (int idx = tid; idx < kTQ * nr; idx += blockDim.x) xw[idx] = -INFINITY;
  __syncthreads();
  for (int task = tid; task < kTQ * nr; task += blockDim.x) {  // one dot a thread
    const int qi = task % kTQ, r = task / kTQ;
    rl[qi * nr + r] = dot_rel<M>(qs + qi * dp, rel_k + (size_t)r * d, d);
  }
  __syncthreads();  // the last block barrier before the merge

  auto issue = [&](int step, int slot) {
    float* ks = kvw + slot * stage;
    float* vs = ks + kTK * dp;
    const int j0 = step * kTK;
    load_rows(ks, kh, j0, L, d, 0, d, dp, vec, lane);       // K: every column (the scores)
    load_rows(vs, vh, j0, L, d, c0, ncols, dv, vec, lane);  // V: the chunk's columns
    cp_async_commit();
  };

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = -INFINITY;
    l[u] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[u][e] = 0.f;
  }
  const int dq4 = (d + 7) / 8 * 2;  // float4 columns of a padded Q/K row
  int slot = 0;
  if (warp < steps) issue(warp, 0);
  for (int step = warp; step < steps; step += nw) {
    if (step + nw < steps)
      issue(step + nw, slot ^ 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const float* ks = kvw + slot * stage;
    const float* vs = ks + kTK * dp;
    const int j0 = step * kTK;

    // scores: lane (qg, kg) holds queries qg*4 + u against keys kg and kg + 8
    float s[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u][0] = s[u][1] = 0.f;
#pragma unroll 4
    for (int c4 = 0; c4 < dq4; ++c4) {
      const float4 k0 = *reinterpret_cast<const float4*>(ks + kg * dp + 4 * c4);
      const float4 k1 = *reinterpret_cast<const float4*>(ks + (kg + 8) * dp + 4 * c4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (qg * 4 + u) * dp + 4 * c4);
        s[u][0] = fma_tier<M>(qv.x, k0.x, s[u][0]);
        s[u][0] = fma_tier<M>(qv.y, k0.y, s[u][0]);
        s[u][0] = fma_tier<M>(qv.z, k0.z, s[u][0]);
        s[u][0] = fma_tier<M>(qv.w, k0.w, s[u][0]);
        s[u][1] = fma_tier<M>(qv.x, k1.x, s[u][1]);
        s[u][1] = fma_tier<M>(qv.y, k1.y, s[u][1]);
        s[u][1] = fma_tier<M>(qv.z, k1.z, s[u][1]);
        s[u][1] = fma_tier<M>(qv.w, k1.w, s[u][1]);
      }
    }
    // relative logits, key mask, and the online softmax of each query row
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qi = qg * 4 + u;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + kg + 8 * e;
        const int delta = j - (q0 + qi);
        const bool win = delta >= -w && delta <= w;
        float x = s[u][e];
        if (win) x += rl[qi * nr + delta + w];
        if (j < L)
          x += j < len ? 0.f : kNeg;
        else
          x = -INFINITY;  // past the sequence: no weight at all
        if (win) xw[qi * nr + delta + w] = x;  // this lane's pair: one writer
        s[u][e] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[u], mx);  // finite: every step holds a key < L
      const float alpha = expf(m[u] - m_new);
      s[u][0] = expf(s[u][0] - m_new);
      s[u][1] = expf(s[u][1] - m_new);
      float sum = s[u][0] + s[u][1];
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[u] = l[u] * alpha + sum;
      m[u] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * NC; ++e) acc[u][e] *= alpha;
    }
    // p.v: lane (qg, kg) holds queries qg*4 + u at columns 4*kg + 32*n + (0..3)
#pragma unroll
    for (int jj = 0; jj < kTK; ++jj) {
      float p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = __shfl_sync(kFull, s[u][jj >> 3], (lane & 24) | (jj & 7));
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + jj * dv + 4 * kg + 32 * n);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u][4 * n + 0] = fma_tier<M>(p[u], vv.x, acc[u][4 * n + 0]);
          acc[u][4 * n + 1] = fma_tier<M>(p[u], vv.y, acc[u][4 * n + 1]);
          acc[u][4 * n + 2] = fma_tier<M>(p[u], vv.z, acc[u][4 * n + 2]);
          acc[u][4 * n + 3] = fma_tier<M>(p[u], vv.w, acc[u][4 * n + 3]);
        }
      }
    }
    __syncwarp();  // this stage is consumed before it is refilled
    slot ^= 1;
  }
  cp_async_wait<0>();
  __syncwarp();

  // the rel_v term of the window keys this warp walked, in its softmax units:
  // p = exp(x - m_w) for key j = i + r - w of a step this warp took
  // (steps warp, warp + nw, ...; its xw entries are its own lanes' writes)
  for (int r = 0; r < nr; ++r) {
    float p[4];
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = q0 + qg * 4 + u + r - w, step = j / kTK;
      const bool mine = j >= 0 && j < L && step < steps && step % nw == warp;
      p[u] = mine ? expf(xw[(qg * 4 + u) * nr + r] - m[u]) : 0.f;
      any |= mine;
    }
    if (!__any_sync(kFull, any)) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * kg + 32 * n + e;
        const float rv = c < d ? ldf(rel_v + (size_t)r * d + c) : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u][4 * n + e] = fma_tier<M>(p[u], rv, acc[u][4 * n + e]);
      }
    }
  }

  // merge: each warp's state to shared memory (acc over its own stage buffers)
  float* accw = kvw;  // kTQ x dv
  if (kg == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ms[warp * kTQ + qg * 4 + u] = m[u];
      ls[warp * kTQ + qg * 4 + u] = l[u];
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float4*>(accw + (qg * 4 + u) * dv + 4 * kg + 32 * n) =
          make_float4(acc[u][4 * n], acc[u][4 * n + 1], acc[u][4 * n + 2], acc[u][4 * n + 3]);
  __syncthreads();
  if (tid < kTQ) {
    float mm = -INFINITY;
    for (int wi = 0; wi < nw; ++wi) mm = fmaxf(mm, ms[wi * kTQ + tid]);
    float ll = 0.f;
    for (int wi = 0; wi < nw; ++wi) ll += ls[wi * kTQ + tid] * expf(ms[wi * kTQ + tid] - mm);
    for (int wi = 0; wi < nw; ++wi) sc[wi * kTQ + tid] = expf(ms[wi * kTQ + tid] - mm) / ll;
    if (lseh && chunk == 0 && q0 + tid < L) lseh[q0 + tid] = mm + logf(ll);
  }
  __syncthreads();
  for (int idx = tid; idx < kTQ * ncols; idx += blockDim.x) {
    const int qi = idx / ncols, cl = idx - qi * ncols, c = c0 + cl;
    const int i = q0 + qi;
    if (i >= L) break;  // idx only grows, and i with it
    float o = 0.f;
    for (int wi = 0; wi < nw; ++wi)
      o = fmaf(kv[wi * 2 * stage + qi * dv + cl], sc[wi * kTQ + qi], o);
    stf(oh + (size_t)i * d + c, o);
  }
}

template <int NC, int CH, int M, class T>
cudaError_t launch(const T* q, const T* k, const T* v, const T* rel_k, const T* rel_v,
                   const int* lengths, T* out, float* lse, int B, int H, int L, int d, int w,
                   cudaStream_t stream) {
  const int per_warp = 2 * kTK * (qk_stride(d) + 32 * NC);  // two stages of K and V
  const int fixed = fixed_floats(d, 2 * w + 1);
  int nw = (kMaxSmemBytes / static_cast<int>(sizeof(float)) - fixed) / per_warp;
  nw = nw < kMaxWarps ? nw : kMaxWarps;
  if (nw < 1) return cudaErrorInvalidValue;
  const int smem = (fixed + nw * per_warp) * static_cast<int>(sizeof(float));
  cudaError_t err = vk_set_smem(rel_attention_kernel<NC, CH, M, T>, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 && reinterpret_cast<size_t>(v) % 16 == 0;
  const dim3 grid((L + kTQ - 1) / kTQ * CH, H, B);
  rel_attention_kernel<NC, CH, M, T><<<grid, nw * 32, smem, stream>>>(
      q, k, v, rel_k, rel_v, lengths, out, lse, H, L, d, w, vec);
  return cudaGetLastError();
}

template <int M, class T>
cudaError_t launch_mode(const void* q_, const void* k_, const void* v_, const void* rel_k_,
                        const void* rel_v_, const int* lengths, void* out_, float* lse, int B,
                        int H, int L, int d, int w, cudaStream_t s) {
  const T *q = static_cast<const T*>(q_), *k = static_cast<const T*>(k_);
  const T *v = static_cast<const T*>(v_), *rel_k = static_cast<const T*>(rel_k_);
  const T* rel_v = static_cast<const T*>(rel_v_);
  T* out = static_cast<T*>(out_);
  switch ((d + 31) / 32) {  // column groups of 32: up to 4 in one block, else two chunks
    case 1:
      return launch<1, 1, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case 2:
      return launch<2, 1, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case 3:
      return launch<3, 1, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case 4:
      return launch<4, 1, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case 5:
    case 6:
      return launch<3, 2, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    default:
      return launch<4, 2, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
  }
}

}  // namespace

namespace attn_fwd {
// launch_mode at one tier and storage type, in its own translation unit.
#define VK_ATTN_FWD_ARGS                                                                     \
  const void *q, const void *k, const void *v, const void *rel_k, const void *rel_v,        \
      const int *lengths, void *out, float *lse, int B, int H, int L, int d, int w,           \
      cudaStream_t s
cudaError_t exact(VK_ATTN_FWD_ARGS);
cudaError_t fast(VK_ATTN_FWD_ARGS);
cudaError_t fast16(VK_ATTN_FWD_ARGS);
cudaError_t high(VK_ATTN_FWD_ARGS);
}  // namespace attn_fwd
