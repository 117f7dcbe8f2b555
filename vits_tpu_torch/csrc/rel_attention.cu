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
// - The rel_v term needs the final weights of the 2w+1 keys around each
//   query: after the merge the block recomputes those few scores (one warp
//   per (query, r), lanes over d) and weights them with the merged m and l.
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
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTQ = 16;         // queries per block
constexpr int kTK = 16;         // keys per warp step
constexpr int kMaxWarps = 8;
constexpr int kMaxR = 32;       // 2w + 1 <= 32
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3.402823466e+38f;  // finfo(float32).min

// K and Q row stride: d rounded up to 8, plus 4, so that the 8 rows a quarter
// warp reads as float4 at one column fall on 32 distinct banks.
inline __host__ __device__ int qk_stride(int d) { return (d + 7) / 8 * 8 + 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Fixed shared memory (floats): Q tile, rel_k logits, per-warp m and l, merged
// m and l, per-warp merge scales, window weights.
inline __host__ __device__ int fixed_floats(int d) {
  return kTQ * qk_stride(d) + kTQ * kMaxR + 2 * kMaxWarps * kTQ + 2 * kTQ +
         kMaxWarps * kTQ + kTQ * kMaxR;
}

// Rows [j0, j0 + kTK) of a bf16 (L, d) head into fp32 rows of stride rs (zero
// past L), by one warp: 8 values a 16-byte load when vec (d % 8 == 0, aligned).
__device__ __forceinline__ void load_rows16(float* dst, const __nv_bfloat16* src, int j0, int L,
                                            int d, int rs, int vec, int lane) {
  if (vec) {
    const int d8 = d >> 3;
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
    for (int idx = lane; idx < kTK * d; idx += 32) {
      const int r = idx / d, c = idx - r * d;
      dst[r * rs + c] = j0 + r < L ? ldf(src + (size_t)(j0 + r) * d + c) : 0.f;
    }
  }
}

// NC = ceil(d / 32): the float4 column groups a lane owns in p.v. T: the storage
// of q, k, v, the tables and out (fp32 or bf16).
template <int NC, int M, class T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    rel_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ rel_k,
                         const T* __restrict__ rel_v, const int* __restrict__ lengths,
                         T* __restrict__ out, float* __restrict__ lse, int H, int L,
                         int d, int w, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nr = 2 * w + 1;
  const int dp = qk_stride(d);  // Q and K rows
  constexpr int dv = 32 * NC;   // V rows: every column a lane reads exists
  const int nw = blockDim.x >> 5;
  const int stage = kTK * (dp + dv);  // K and V of one step
  float* qs = smem;                   // kTQ x dp, zero-padded
  float* rl = qs + kTQ * dp;          // kTQ x kMaxR: q_i . rel_k[r]
  float* ms = rl + kTQ * kMaxR;       // kMaxWarps x kTQ: each warp's running max
  float* ls = ms + kMaxWarps * kTQ;   // ... and running sum
  float* mt = ls + kMaxWarps * kTQ;   // kTQ merged max
  float* lt = mt + kTQ;               // kTQ merged sum
  float* sc = lt + kTQ;               // kMaxWarps x kTQ: exp(m_w - m) / l
  float* pw = sc + kMaxWarps * kTQ;   // kTQ x kMaxR: final weights of the window keys
  float* kv = pw + kTQ * kMaxR;       // per warp: 2 stages of (K kTK x dp, V kTK x dv)

  const int q0 = blockIdx.x * kTQ;
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
  __syncthreads();
  for (int task = warp; task < kTQ * nr; task += nw) {
    const int qi = task / nr, r = task - qi * nr;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s = fma_tier<M>(qs[qi * dp + c], ldf(rel_k + r * d + c), s);
    s = warp_sum(s);
    if (lane == 0) rl[qi * kMaxR + r] = s;
  }
  __syncthreads();  // the last block barrier before the merge

  auto issue = [&](int step, int slot) {
    float* ks = kvw + slot * stage;
    float* vs = ks + kTK * dp;
    const int j0 = step * kTK;
    if constexpr (sizeof(T) == 2) {
      load_rows16(ks, kh, j0, L, d, dp, vec, lane);
      load_rows16(vs, vh, j0, L, d, dv, vec, lane);
    } else if (vec) {
      const int d4 = d >> 2;
      for (int idx = lane; idx < kTK * d4; idx += 32) {
        const int r = idx / d4, c = (idx - r * d4) * 4;
        const bool in = j0 + r < L;
        const size_t off = in ? (size_t)(j0 + r) * d + c : 0;
        cp_async16_zfill(ks + r * dp + c, kh + off, in ? 16 : 0);
        cp_async16_zfill(vs + r * dv + c, vh + off, in ? 16 : 0);
      }
    } else {
      for (int idx = lane; idx < kTK * d; idx += 32) {
        const int r = idx / d, c = idx - r * d;
        const bool in = j0 + r < L;
        const size_t off = in ? (size_t)(j0 + r) * d + c : 0;
        cp_async4_zfill(ks + r * dp + c, kh + off, in ? 4 : 0);
        cp_async4_zfill(vs + r * dv + c, vh + off, in ? 4 : 0);
      }
    }
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
        float x = s[u][e];
        if (delta >= -w && delta <= w) x += rl[qi * kMaxR + delta + w];
        if (j < L)
          x += j < len ? 0.f : kNeg;
        else
          x = -INFINITY;  // past the sequence: no weight at all
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
    mt[tid] = mm;
    lt[tid] = ll;
    for (int wi = 0; wi < nw; ++wi) sc[wi * kTQ + tid] = expf(ms[wi * kTQ + tid] - mm) / ll;
    if (lseh && q0 + tid < L) lseh[q0 + tid] = mm + logf(ll);
  }
  __syncthreads();
  // the final weights of the keys i + r - w, for the rel_v term
  for (int task = warp; task < kTQ * nr; task += nw) {
    const int qi = task / nr, r = task - qi * nr;
    const int i = q0 + qi, j = i + r - w;
    float p = 0.f;
    if (i < L && j >= 0 && j < L) {
      float x = 0.f;
      for (int c = lane; c < d; c += 32)
        x = fma_tier<M>(qs[qi * dp + c], ldf(kh + (size_t)j * d + c), x);
      x = warp_sum(x) + rl[qi * kMaxR + r];
      if (j >= len) x += kNeg;
      p = expf(x - mt[qi]) / lt[qi];
    }
    if (lane == 0) pw[qi * kMaxR + r] = p;
  }
  __syncthreads();
  for (int idx = tid; idx < kTQ * d; idx += blockDim.x) {
    const int qi = idx / d, c = idx - qi * d;
    const int i = q0 + qi;
    if (i >= L) break;  // idx only grows, and i with it
    float o = 0.f;
    for (int wi = 0; wi < nw; ++wi)
      o = fmaf(kv[wi * 2 * stage + qi * dv + c], sc[wi * kTQ + qi], o);
    for (int r = 0; r < nr; ++r) o = fma_tier<M>(pw[qi * kMaxR + r], ldf(rel_v + r * d + c), o);
    stf(oh + (size_t)i * d + c, o);
  }
}

template <int NC, int M, class T>
cudaError_t launch(const T* q, const T* k, const T* v, const T* rel_k, const T* rel_v,
                   const int* lengths, T* out, float* lse, int B, int H, int L, int d, int w,
                   cudaStream_t stream) {
  const int per_warp = 2 * kTK * (qk_stride(d) + 32 * NC);  // two stages of K and V
  const int fixed = fixed_floats(d);
  int nw = (kMaxSmemBytes / static_cast<int>(sizeof(float)) - fixed) / per_warp;
  nw = nw < kMaxWarps ? nw : kMaxWarps;
  if (nw < 1) return cudaErrorInvalidValue;
  const int smem = (fixed + nw * per_warp) * static_cast<int>(sizeof(float));
  cudaError_t err = vk_set_smem(rel_attention_kernel<NC, M, T>, smem);
  if (err != cudaSuccess) return err;
  const int vec = d % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  reinterpret_cast<size_t>(k) % 16 == 0 && reinterpret_cast<size_t>(v) % 16 == 0;
  const dim3 grid((L + kTQ - 1) / kTQ, H, B);
  rel_attention_kernel<NC, M, T><<<grid, nw * 32, smem, stream>>>(q, k, v, rel_k, rel_v, lengths,
                                                               out, lse, H, L, d, w, vec);
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
  switch ((d + 31) / 32) {
    case 1:
      return launch<1, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case 2:
      return launch<2, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case 3:
      return launch<3, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    default:
      return launch<4, M>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
  }
}

}  // namespace

// mode: the tier of the products (TierMode); bf16: q, k, v, the tables and out
// are bf16 storage (the kFast tier only), else fp32.
VK_EXPORT int vk_rel_attention(const void* q, const void* k, const void* v, const void* rel_k,
                               const void* rel_v, const int* lengths, void* out, float* lse,
                               int B, int H, int L, int d, int w, int mode, int bf16,
                               void* stream) {
  const int nr = 2 * w + 1;
  if (d < 1 || d > 128 || w < 0 || nr > kMaxR || L < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mode == kFast ? launch_mode<kFast, __nv_bfloat16>(q, k, v, rel_k, rel_v, lengths, out,
                                                             lse, B, H, L, d, w, s)
                         : cudaErrorInvalidValue;
  switch (mode) {
    case kExact:
      return launch_mode<kExact, float>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w,
                                        s);
    case kFast:
      return launch_mode<kFast, float>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case kHigh:
      return launch_mode<kHigh, float>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    default:
      return cudaErrorInvalidValue;
  }
}
