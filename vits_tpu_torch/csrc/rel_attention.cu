// VITS windowed relative-position self-attention, one (batch, head, 16-query
// tile) per block, with an online softmax over 32-key chunks:
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
// What bounds it on an H100: at the encoder's shapes (H=2, d=96, L <= 512) the
// whole attention is under 0.2 GFLOP per row, so the kernel is bound by
// latency: few blocks (L/16 x H x B) and one __syncthreads pair per 32-key
// chunk. Nothing quadratic touches device memory: each block reads its Q tile
// once and K/V once per chunk; the rel_k logits are one (16, 2w+1) product per
// block, and the rel_v weights are gathered from the chunk's probabilities with
// warp shuffles.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kQPerWarp = 4;
constexpr int kTQ = kWarps * kQPerWarp;  // queries per block
constexpr int kTK = 32;                  // keys per chunk: one per lane
constexpr int kMaxDPerLane = 4;          // head_dim <= 128
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3.402823466e+38f;  // finfo(float32).min

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
    rel_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ rel_k,
                         const float* __restrict__ rel_v, const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ lse, int H, int L,
                         int d, int w) {
  extern __shared__ float smem[];
  const int nr = 2 * w + 1;
  const int dk = d + 1;  // padded K rows: lanes read one channel of 32 different keys
  float* qs = smem;             // kTQ x d
  float* ks = qs + kTQ * d;     // kTK x dk
  float* vs = ks + kTK * dk;    // kTK x d
  float* rks = vs + kTK * d;    // nr x d
  float* rvs = rks + nr * d;    // nr x d
  float* rl = rvs + nr * d;     // kTQ x nr: q_i . rel_k[r]
  const int q0 = blockIdx.x * kTQ;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + blockIdx.y) * L * d;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  float* oh = out + head;
  float* lseh = lse ? lse + ((size_t)b * H + blockIdx.y) * L : nullptr;
  const int len = lengths[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < kTQ * d; idx += blockDim.x) {
    const int r = idx / d;
    qs[idx] = q0 + r < L ? qh[(size_t)(q0 + r) * d + idx - r * d] : 0.f;
  }
  for (int idx = tid; idx < nr * d; idx += blockDim.x) {
    rks[idx] = rel_k[idx];
    rvs[idx] = rel_v[idx];
  }
  __syncthreads();
  for (int idx = tid; idx < kTQ * nr; idx += blockDim.x) {
    const int qi = idx / nr;
    const int r = idx - qi * nr;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(qs[qi * d + c], rks[r * d + c], s);
    rl[idx] = s;
  }

  float m[kQPerWarp], l[kQPerWarp], racc[kQPerWarp], acc[kQPerWarp][kMaxDPerLane];
#pragma unroll
  for (int u = 0; u < kQPerWarp; ++u) {
    m[u] = -INFINITY;
    l[u] = 0.f;
    racc[u] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kMaxDPerLane; ++cc) acc[u][cc] = 0.f;
  }

  for (int kc0 = 0; kc0 < L; kc0 += kTK) {
    __syncthreads();  // previous chunk fully consumed (and rl visible on the first)
    for (int idx = tid; idx < kTK * d; idx += blockDim.x) {
      const int r = idx / d;
      const int c = idx - r * d;
      const int j = kc0 + r;
      const bool in = j < L;
      ks[r * dk + c] = in ? kh[(size_t)j * d + c] : 0.f;
      vs[r * d + c] = in ? vh[(size_t)j * d + c] : 0.f;
    }
    __syncthreads();
    const int j = kc0 + lane;
#pragma unroll
    for (int u = 0; u < kQPerWarp; ++u) {
      const int qi = warp * kQPerWarp + u;
      const int i = q0 + qi;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qs[qi * d + c], ks[lane * dk + c], s);
      const int delta = j - i;
      if (delta >= -w && delta <= w) s += rl[qi * nr + delta + w];
      if (j < L)
        s += j < len ? 0.f : kNeg;
      else
        s = -INFINITY;  // past the sequence: no weight at all
      const float m_new = fmaxf(m[u], warp_max(s));
      const float alpha = expf(m[u] - m_new);
      const float p = expf(s - m_new);
      l[u] = l[u] * alpha + warp_sum(p);
#pragma unroll
      for (int cc = 0; cc < kMaxDPerLane; ++cc) acc[u][cc] *= alpha;
      for (int jj = 0; jj < kTK; ++jj) {
        const float pj = __shfl_sync(kFull, p, jj);
#pragma unroll
        for (int cc = 0; cc < kMaxDPerLane; ++cc) {
          const int c = lane + 32 * cc;
          if (c < d) acc[u][cc] = fmaf(pj, vs[jj * d + c], acc[u][cc]);
        }
      }
      // lane r < nr collects the probability of key i + r - w for rel_v[r]
      const int src = i + lane - w - kc0;
      const float pr = __shfl_sync(kFull, p, src & 31);
      racc[u] = racc[u] * alpha + ((lane < nr && src >= 0 && src < kTK) ? pr : 0.f);
      m[u] = m_new;
    }
  }

#pragma unroll
  for (int u = 0; u < kQPerWarp; ++u) {
    const int i = q0 + warp * kQPerWarp + u;
    const float inv = 1.f / l[u];
    float o[kMaxDPerLane];
#pragma unroll
    for (int cc = 0; cc < kMaxDPerLane; ++cc) o[cc] = acc[u][cc] * inv;
    for (int r = 0; r < nr; ++r) {
      const float pr = __shfl_sync(kFull, racc[u], r) * inv;
#pragma unroll
      for (int cc = 0; cc < kMaxDPerLane; ++cc) {
        const int c = lane + 32 * cc;
        if (c < d) o[cc] = fmaf(pr, rvs[r * d + c], o[cc]);
      }
    }
    if (i < L) {
#pragma unroll
      for (int cc = 0; cc < kMaxDPerLane; ++cc) {
        const int c = lane + 32 * cc;
        if (c < d) oh[(size_t)i * d + c] = o[cc];
      }
      if (lseh && lane == 0) lseh[i] = m[u] + logf(l[u]);
    }
  }
}

}  // namespace

VK_EXPORT int vk_rel_attention(const float* q, const float* k, const float* v,
                               const float* rel_k, const float* rel_v, const int* lengths,
                               float* out, float* lse, int B, int H, int L, int d, int w,
                               void* stream) {
  const int nr = 2 * w + 1;
  if (d < 1 || d > 32 * kMaxDPerLane || w < 0 || nr > 32 || L < 1) return cudaErrorInvalidValue;
  const int smem =
      (kTQ * d + kTK * (d + 1) + kTK * d + 2 * nr * d + kTQ * nr) * static_cast<int>(sizeof(float));
  cudaError_t err = vk_set_smem(rel_attention_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTQ - 1) / kTQ, H, B);
  rel_attention_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rel_k, rel_v, lengths, out, lse, H, L, d, w);
  return cudaGetLastError();
}
