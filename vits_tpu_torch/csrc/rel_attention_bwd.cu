// Backward of the VITS windowed relative-position self-attention (kernel A,
// rel_attention.cu). Replaces vits_tpu/ops/pallas/attention_grad.py::_flash_bwd
// (_attn_bwd_kernel). From the forward's per-row logsumexp lse and the row dot
// D_i = dout_i . out_i (both computed outside), the probabilities are rebuilt
// blockwise, exactly as the Pallas kernel does:
//
//   s_ij  = q_i . k_j + (|j - i| <= w ? q_i . rel_k[j - i + w] : 0)
//   p_ij  = j < len ? exp(s_ij - lse_i) : 0        (0, not the forward's
//                                                    finfo.min weight, past len)
//   dp_ij = dout_i . v_j + (|j - i| <= w ? dout_i . rel_v[j - i + w] : 0)
//   ds_ij = p_ij (dp_ij - D_i)
//   dq_i  = sum_j ds_ij k_j + sum_r ds_{i,i+r-w} rel_k[r]
//   dk_j  = sum_i ds_ij q_i,     dv_j = sum_i p_ij dout_i
//   drel_k[r] = sum_i ds_{i,i+r-w} q_i,   drel_v[r] = sum_i p_{i,i+r-w} dout_i
//
// The Pallas grid walks the query tiles of one (batch, head) in order and
// carries dK/dV in VMEM scratch. CUDA blocks run in parallel, so the work is
// split into two passes with no float atomics (repeated runs give bit-identical
// gradients):
//   * a query-major pass (one block per 16 queries) writes dq and, per query
//     tile, partial rel-embedding gradients (nr, d), from delta-masked row sums
//     gathered with warp shuffles as in the forward;
//   * a key-major pass (one block per 16 keys) walks all queries and writes dk
//     and dv.
// The partial rel gradients are summed over (batch, head, tile) by the caller,
// as JAX sums its per-(batch, head) ones outside the kernel.
//
// What bounds it on an H100: like the forward, latency. At the encoder's
// shapes (H=2, d=96, L=512) each pass recomputes the (L, L) scores and dp
// (two d-long dots per pair) for under 0.5 GFLOP per row; the blocks number
// B*H*L/16, so a short batch leaves SMs idle. Nothing quadratic touches device
// memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;            // queries (dq pass) or keys (dkv pass) per warp
constexpr int kTile = kWarps * kRowsPerWarp;  // rows per block
constexpr int kChunk = 32;                 // keys (dq pass) or queries (dkv pass): one per lane
constexpr int kMaxDPerLane = 4;            // head_dim <= 128
constexpr unsigned kFull = 0xffffffffu;

// Rows [r0, r0 + n) of one (L, d) head into shared memory at row stride
// `stride`, zeros past L.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n, int L,
                                           int d, int stride) {
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[r * stride + c] = r0 + r < L ? src[(size_t)(r0 + r) * d + c] : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// a[i] . table[r] for the n rows of a and the nr rows of table.
__device__ __forceinline__ void rel_dots(float* out, const float* a, const float* table, int n,
                                         int a_stride, int nr, int d) {
  for (int idx = threadIdx.x; idx < n * nr; idx += blockDim.x) {
    const int i = idx / nr;
    const int r = idx - i * nr;
    out[idx] = dot(a + i * a_stride, table + r * d, d);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ rel_k,
              const float* __restrict__ rel_v, const int* __restrict__ lengths,
              const float* __restrict__ lse, const float* __restrict__ drow,
              const float* __restrict__ dout, float* __restrict__ dq,
              float* __restrict__ drk_part, float* __restrict__ drv_part, int H, int L, int d,
              int w) {
  extern __shared__ float smem[];
  const int nr = 2 * w + 1;
  const int dk = d + 1;  // padded key rows: lanes read one channel of 32 different keys
  float* qs = smem;                 // kTile x d
  float* dos = qs + kTile * d;      // kTile x d
  float* ks = dos + kTile * d;      // kChunk x dk
  float* vs = ks + kChunk * dk;     // kChunk x dk
  float* rks = vs + kChunk * dk;    // nr x d
  float* rvs = rks + nr * d;        // nr x d
  float* rl = rvs + nr * d;         // kTile x nr: q_i . rel_k[r]
  float* dr = rl + kTile * nr;      // kTile x nr: dout_i . rel_v[r]
  float* dsr_s = dr + kTile * nr;   // kTile x nr: sum of ds at delta r - w
  float* pr_s = dsr_s + kTile * nr; // kTile x nr: sum of p at delta r - w
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const size_t head = bh * L * d;
  const int len = lengths[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  stage_rows(qs, q + head, q0, kTile, L, d, d);
  stage_rows(dos, dout + head, q0, kTile, L, d, d);
  for (int idx = tid; idx < nr * d; idx += blockDim.x) {
    rks[idx] = rel_k[idx];
    rvs[idx] = rel_v[idx];
  }
  __syncthreads();
  rel_dots(rl, qs, rks, kTile, d, nr, d);
  rel_dots(dr, dos, rvs, kTile, d, nr, d);

  float lse_u[kRowsPerWarp], d_u[kRowsPerWarp], dsr[kRowsPerWarp], pr[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int i = q0 + warp * kRowsPerWarp + u;
    lse_u[u] = i < L ? lse[bh * L + i] : 0.f;
    d_u[u] = i < L ? drow[bh * L + i] : 0.f;
    dsr[u] = 0.f;
    pr[u] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kMaxDPerLane; ++cc) acc[u][cc] = 0.f;
  }

  for (int kc0 = 0; kc0 < L; kc0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and rl/dr visible on the first)
    stage_rows(ks, k + head, kc0, kChunk, L, d, dk);
    stage_rows(vs, v + head, kc0, kChunk, L, d, dk);
    __syncthreads();
    const int j = kc0 + lane;
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int qi = warp * kRowsPerWarp + u;
      const int i = q0 + qi;
      float s = dot(qs + qi * d, ks + lane * dk, d);
      float dp = dot(dos + qi * d, vs + lane * dk, d);
      const int delta = j - i;
      if (delta >= -w && delta <= w) {
        s += rl[qi * nr + delta + w];
        dp += dr[qi * nr + delta + w];
      }
      const float p = (i < L && j < L && j < len) ? expf(s - lse_u[u]) : 0.f;
      const float ds = p * (dp - d_u[u]);
      for (int jj = 0; jj < kChunk; ++jj) {
        const float dsj = __shfl_sync(kFull, ds, jj);
#pragma unroll
        for (int cc = 0; cc < kMaxDPerLane; ++cc) {
          const int c = lane + 32 * cc;
          if (c < d) acc[u][cc] = fmaf(dsj, ks[jj * dk + c], acc[u][cc]);
        }
      }
      // lane r < nr collects key i + r - w for the rel-embedding row sums
      const int src = i + lane - w - kc0;
      const float dsx = __shfl_sync(kFull, ds, src & 31);
      const float px = __shfl_sync(kFull, p, src & 31);
      if (lane < nr && src >= 0 && src < kChunk) {
        dsr[u] += dsx;
        pr[u] += px;
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int qi = warp * kRowsPerWarp + u;
    const int i = q0 + qi;
    for (int r = 0; r < nr; ++r) {
      const float x = __shfl_sync(kFull, dsr[u], r);
#pragma unroll
      for (int cc = 0; cc < kMaxDPerLane; ++cc) {
        const int c = lane + 32 * cc;
        if (c < d) acc[u][cc] = fmaf(x, rks[r * d + c], acc[u][cc]);
      }
    }
    if (i < L) {
#pragma unroll
      for (int cc = 0; cc < kMaxDPerLane; ++cc) {
        const int c = lane + 32 * cc;
        if (c < d) dq[head + (size_t)i * d + c] = acc[u][cc];
      }
    }
    if (lane < nr) {
      dsr_s[qi * nr + lane] = dsr[u];
      pr_s[qi * nr + lane] = pr[u];
    }
  }
  __syncthreads();
  // this tile's share of drel_k = sum_i dsr_i q_i and drel_v = sum_i pr_i dout_i
  const size_t part = (bh * gridDim.x + blockIdx.x) * nr * d;
  for (int idx = tid; idx < nr * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    float a = 0.f, bsum = 0.f;
    for (int qi = 0; qi < kTile; ++qi) {
      a = fmaf(dsr_s[qi * nr + r], qs[qi * d + c], a);
      bsum = fmaf(pr_s[qi * nr + r], dos[qi * d + c], bsum);
    }
    drk_part[part + idx] = a;
    drv_part[part + idx] = bsum;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ rel_k,
               const float* __restrict__ rel_v, const int* __restrict__ lengths,
               const float* __restrict__ lse, const float* __restrict__ drow,
               const float* __restrict__ dout, float* __restrict__ dk_out,
               float* __restrict__ dv_out, int H, int L, int d, int w) {
  extern __shared__ float smem[];
  const int nr = 2 * w + 1;
  const int dq = d + 1;  // padded query rows: lanes read one channel of 32 different queries
  float* ks = smem;                // kTile x d
  float* vs = ks + kTile * d;      // kTile x d
  float* qs = vs + kTile * d;      // kChunk x dq
  float* dos = qs + kChunk * dq;   // kChunk x dq
  float* rks = dos + kChunk * dq;  // nr x d
  float* rvs = rks + nr * d;       // nr x d
  float* rl = rvs + nr * d;        // kChunk x nr
  float* dr = rl + kChunk * nr;    // kChunk x nr
  float* lse_s = dr + kChunk * nr; // kChunk
  float* d_s = lse_s + kChunk;     // kChunk
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const size_t head = bh * L * d;
  const int len = lengths[b];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  stage_rows(ks, k + head, k0, kTile, L, d, d);
  stage_rows(vs, v + head, k0, kTile, L, d, d);
  for (int idx = tid; idx < nr * d; idx += blockDim.x) {
    rks[idx] = rel_k[idx];
    rvs[idx] = rel_v[idx];
  }

  float dka[kRowsPerWarp][kMaxDPerLane], dva[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t)
#pragma unroll
    for (int cc = 0; cc < kMaxDPerLane; ++cc) {
      dka[t][cc] = 0.f;
      dva[t][cc] = 0.f;
    }

  for (int qc0 = 0; qc0 < L; qc0 += kChunk) {
    __syncthreads();  // previous chunk consumed (and the key tile visible on the first)
    stage_rows(qs, q + head, qc0, kChunk, L, d, dq);
    stage_rows(dos, dout + head, qc0, kChunk, L, d, dq);
    if (tid < kChunk) {
      const int i = qc0 + tid;
      lse_s[tid] = i < L ? lse[bh * L + i] : 0.f;
      d_s[tid] = i < L ? drow[bh * L + i] : 0.f;
    }
    __syncthreads();
    rel_dots(rl, qs, rks, kChunk, dq, nr, d);
    rel_dots(dr, dos, rvs, kChunk, dq, nr, d);
    __syncthreads();
    const int i = qc0 + lane;
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int jl = warp * kRowsPerWarp + t;
      const int j = k0 + jl;
      float s = dot(qs + lane * dq, ks + jl * d, d);
      float dp = dot(dos + lane * dq, vs + jl * d, d);
      const int delta = j - i;
      if (delta >= -w && delta <= w) {
        s += rl[lane * nr + delta + w];
        dp += dr[lane * nr + delta + w];
      }
      const float p = (i < L && j < L && j < len) ? expf(s - lse_s[lane]) : 0.f;
      const float ds = p * (dp - d_s[lane]);
      for (int ii = 0; ii < kChunk; ++ii) {
        const float dsi = __shfl_sync(kFull, ds, ii);
        const float pi = __shfl_sync(kFull, p, ii);
#pragma unroll
        for (int cc = 0; cc < kMaxDPerLane; ++cc) {
          const int c = lane + 32 * cc;
          if (c < d) {
            dka[t][cc] = fmaf(dsi, qs[ii * dq + c], dka[t][cc]);
            dva[t][cc] = fmaf(pi, dos[ii * dq + c], dva[t][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int j = k0 + warp * kRowsPerWarp + t;
    if (j >= L) continue;
#pragma unroll
    for (int cc = 0; cc < kMaxDPerLane; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) {
        dk_out[head + (size_t)j * d + c] = dka[t][cc];
        dv_out[head + (size_t)j * d + c] = dva[t][cc];
      }
    }
  }
}

}  // namespace

// Gradients of rel_attention for (B, H, L, d) fp32 contiguous q (pre-scaled),
// k, v, dout and the forward's lse, with drow[b, h, i] = dout_i . out_i.
// Writes dq, dk, dv (B, H, L, d) and, per (b, h, 16-query tile), partial
// rel-embedding gradients drk_part, drv_part (B, H, ceil(L/16), 2w+1, d).
VK_EXPORT int vk_rel_attention_bwd(const float* q, const float* k, const float* v,
                                   const float* rel_k, const float* rel_v, const int* lengths,
                                   const float* lse, const float* drow, const float* dout,
                                   float* dq, float* dk, float* dv, float* drk_part,
                                   float* drv_part, int B, int H, int L, int d, int w,
                                   void* stream) {
  const int nr = 2 * w + 1;
  if (d < 1 || d > 32 * kMaxDPerLane || w < 0 || nr > 32 || L < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  const int smem_q = (2 * kTile * d + 2 * kChunk * (d + 1) + 2 * nr * d + 4 * kTile * nr) *
                     static_cast<int>(sizeof(float));
  cudaError_t err = vk_set_smem(dq_kernel, smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kWarps * 32, smem_q, s>>>(q, k, v, rel_k, rel_v, lengths, lse, drow, dout,
                                               dq, drk_part, drv_part, H, L, d, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_kv = (2 * kTile * d + 2 * kChunk * (d + 1) + 2 * nr * d + 2 * kChunk * nr +
                       2 * kChunk) *
                      static_cast<int>(sizeof(float));
  err = vk_set_smem(dkv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kWarps * 32, smem_kv, s>>>(q, k, v, rel_k, rel_v, lengths, lse, drow, dout,
                                                dk, dv, H, L, d, w);
  return cudaGetLastError();
}
