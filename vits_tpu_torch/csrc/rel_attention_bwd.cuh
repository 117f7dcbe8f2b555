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
// carries dK/dV in VMEM scratch. CUDA blocks run in parallel, so one launch
// holds two kinds of block with disjoint outputs and no float atomics
// (repeated runs give bit-identical gradients):
//   * a dkv block per 16 keys walks all L queries and writes dk and dv;
//   * a dq block per 16 queries walks the keys and writes dq and the tile's
//     partial rel-table gradients (nr, d), summed over (batch, head, tile) by
//     the caller as JAX sums its per-(batch, head) ones outside the kernel.
//
// What bounds it on an H100: latency. At the encoder's shapes (B=2, H=2,
// d=96, L=512) the five products are under 1 GFLOP, 0.003 ms at the
// fp32-accurate tensor-core rate, and nothing quadratic touches device
// memory, so the time is the chain of dependent steps each warp walks. The
// design is kernel A's:
// - Both passes in one grid (the dkv blocks first: they walk further), so a
//   batch of two rows puts 256 blocks in flight, not two serial waves of 128.
// - Up to 8 warps per block split the loop: warp w takes 16-row steps w,
//   w + 8, ... with its own dq (or dk, dv) partials in registers, merged once
//   through shared memory in warp order (a fixed order: deterministic). No
//   block barrier inside the loop.
// - Each warp streams its steps through its own two-stage cp.async buffer:
//   K and V (dq blocks) or Q, dout, lse and D (dkv blocks).
// - The window logits q.rel_k and dout.rel_v are computed once per block
//   before the loop, one dot a thread for the block's 16 queries, or four
//   (one query row against four table rows) for the 16 + 2w queries that fall
//   in the window of the block's 16 keys. The dq
//   block's rel_k term joins each warp's dq sum for the window keys the warp
//   walked (their ds are its own lanes' writes), so it costs no pass of its own.
// - The products are register-tiled FFMA: lane (group of 4 rows, one of 8
//   columns) holds 4 x 2 (row, column) pairs of s and dp over float4
//   channels (rows padded to 32 * ceil(d / 32) + 4 floats: conflict-free),
//   then 4 rows x 4 channels per 32 of dq (dk, dv), ds and p moving by
//   shuffles within 8-lane groups. FFMA and not 3xTF32 MMA, as in kernel A:
//   the whole work is a few us at the FFMA rate, so the tensor cores would
//   shorten no part of the chain that matters.
// - Exact skips: keys at or past len have p = 0, so a dq block stops its key
//   loop at ceil(len / 16) steps, a dkv block whose keys all lie at or past
//   len writes zeros and returns, and a len = 0 row writes only zeros. A dkv
//   block still walks every query: queries past len weigh valid keys, and
//   their dout need not be 0 (the JAX kernel walks them too).
// - Each (query, key) pair of the window belongs to one lane of one step, so
//   the rel-table row sums ds_{i,i+r-w} and p_{i,i+r-w} are single writes
//   into shared memory, not sums.
// - Precision tiers (M, common.cuh TierMode), as make_trainable_attention's
//   precision: every product of the JAX kernel's dots (the five above, the
//   window logits and the rel-table sums) is an fma_tier<M>; ds, p and every
//   sum stay fp32. Built for the training tiers: kExact on fp32, kFast on bf16.
// - bf16 storage (T, the bf16 training tier at kFast): q, k, v, the tables and
//   dout are read as bf16 and widened where they are staged (plain loads, 8
//   values a 16-byte load, in place of cp.async); dq, dk, dv are written as
//   bf16; the rel-table partials, lse and D stay fp32, and the caller sums the
//   partials in fp32 and casts once to the table's dtype (attention_grad.py:
//   253-257).
// - Any head width up to kMaxD and window up to kMaxW, as the JAX kernel takes
//   any d and w. A lane owns 4 x 4 * NC accumulators of dq (dk and dv), NC <= 4
//   column groups of 32 (at NC = 4 the dk/dv block already holds 255
//   registers); a wider head (d > 128) is cut into CH = 2 column chunks, one
//   block each. Every chunk block stages whole rows (the scores and dp are
//   dots over the whole d, the same bits in each chunk) and accumulates and
//   writes only its chunk's columns of dq (dk, dv) and of the rel-table
//   partials. The window logits and sums are per-block shared arrays of 2w + 1
//   per row (16 + 2w rows in a dk/dv block), so the window costs shared memory
//   and not lanes; the tables are read from device memory (L1/L2).
//
// The kernel's templates live here; fp32 storage (the exact tier) compiles in
// rel_attention_bwd.cu with the entry point, bf16 storage (fast) in
// rel_attention_bwd16.cu, so that the build's nvcc processes share them.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kT = 16;                // rows per block (queries or keys) and per warp step
constexpr int kMaxWarps = 8;
constexpr int kMaxD = 256;            // head_dim ceiling: CH * NC * 32 columns, CH <= 2, NC <= 4
constexpr int kMaxW = 32;             // window ceiling: 2w + 1 <= 65 relative offsets
constexpr unsigned kFull = 0xffffffffu;

// Row stride of every staged (rows, d) tile: the 32 * NC * CH channels the
// lanes of the CH chunks read in dq (dk, dv), plus 4, so that the 8 rows a
// quarter warp reads as float4 at one column fall on 32 distinct banks.
// Columns past d stay zero.
template <int NC, int CH>
__host__ __device__ constexpr int row_stride() {
  return 32 * NC * CH + 4;
}
// Shared memory (floats): the block's fixed tiles -- two (kT, d) tiles, then a
// dq block's four kT x nr window arrays or a dk/dv block's two (kT + 2w) x nr
// ones, rounded to 4 floats so that the warps' regions stay 16-byte aligned --
// and each warp's region.
template <int NC, int CH>
__host__ __device__ int fixed_floats(int w) {
  const int nr = 2 * w + 1, rows = 4 * kT > 2 * (kT + 2 * w) ? 4 * kT : 2 * (kT + 2 * w);
  return (2 * kT * row_stride<NC, CH>() + rows * nr + 3) / 4 * 4;
}
template <int NC, int CH>
__host__ __device__ constexpr int warp_floats() {  // two stages of two tiles and two row vectors
  return 2 * (2 * kT * row_stride<NC, CH>() + 2 * kT);
}

template <int M>
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fma_tier<M>(a.x, b.x, acc);
  acc = fma_tier<M>(a.y, b.y, acc);
  acc = fma_tier<M>(a.z, b.z, acc);
  return fma_tier<M>(a.w, b.w, acc);
}

template <int M>
__device__ __forceinline__ void fma4(float* acc, float s, float4 x) {
  acc[0] = fma_tier<M>(s, x.x, acc[0]);
  acc[1] = fma_tier<M>(s, x.y, acc[1]);
  acc[2] = fma_tier<M>(s, x.z, acc[2]);
  acc[3] = fma_tier<M>(s, x.w, acc[3]);
}

// One warp's copy of rows [r0, r0 + kT) of an (L, d) head into dst at row
// stride rs (zero rows past L; columns past d untouched): asynchronous for
// fp32, plain loads widened to fp32 for bf16 (vec: 8 values a 16-byte load).
__device__ __forceinline__ void issue_rows(float* dst, const __nv_bfloat16* src, int r0, int L,
                                           int d, int rs, int vec, int lane) {
  if (vec) {
    const int d8 = d >> 3;
    for (int idx = lane; idx < kT * d8; idx += 32) {
      const int r = idx / d8, c = (idx - r * d8) * 8;
      float* o = dst + r * rs + c;
      if (r0 + r < L) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
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
    for (int idx = lane; idx < kT * d; idx += 32) {
      const int r = idx / d, c = idx - r * d;
      dst[r * rs + c] = r0 + r < L ? ldf(src + (size_t)(r0 + r) * d + c) : 0.f;
    }
  }
}
__device__ __forceinline__ void issue_rows(float* dst, const float* src, int r0, int L, int d,
                                           int rs, int vec, int lane) {
  if (vec) {
    const int d4 = d >> 2;
    for (int idx = lane; idx < kT * d4; idx += 32) {
      const int r = idx / d4, c = (idx - r * d4) * 4;
      const bool in = r0 + r < L;
      cp_async16_zfill(dst + r * rs + c, src + (in ? (size_t)(r0 + r) * d + c : 0), in ? 16 : 0);
    }
  } else {
    for (int idx = lane; idx < kT * d; idx += 32) {
      const int r = idx / d, c = idx - r * d;
      const bool in = r0 + r < L;
      cp_async4_zfill(dst + r * rs + c, src + (in ? (size_t)(r0 + r) * d + c : 0), in ? 4 : 0);
    }
  }
}

// Rows [r0, r0 + kT) of an (L, d) head into dst at row stride rs, zero past L and d.
template <class T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int L, int d,
                                          int rs) {
  for (int idx = threadIdx.x; idx < kT * rs; idx += blockDim.x) {
    const int r = idx / rs, c = idx - r * rs;
    dst[idx] = c < d && r0 + r < L ? ldf(src + (size_t)(r0 + r) * d + c) : 0.f;
  }
}

// Zeros into columns [c0, c0 + n) of rows [r0, r0 + kT) of an (L, d) head.
template <class T>
__device__ __forceinline__ void zero_rows(T* dst, int r0, int L, int d, int c0, int n) {
  for (int idx = threadIdx.x; idx < kT * n; idx += blockDim.x) {
    const int r = idx / n;
    if (r0 + r >= L) break;  // idx only grows, and the row with it
    stf(dst + (size_t)(r0 + r) * d + c0 + idx - r * n, 0.f);
  }
}

// q . rel_k[r] and o . rel_v[r] for the four table rows r0..r0+3 (rows past nr
// read row nr - 1 and are not kept), over d, each product at the tier M.
template <int M, class T>
__device__ __forceinline__ void window_dots(const T* q, const T* o, const T* rel_k,
                                            const T* rel_v, int r0, int nr, int d, float* x,
                                            float* y) {
  const T *k[4], *v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + e < nr ? r0 + e : nr - 1;
    k[e] = rel_k + (size_t)r * d;
    v[e] = rel_v + (size_t)r * d;
  }
#pragma unroll 2
  for (int c = 0; c < d; ++c) {
    const float qc = ldf(q + c), oc = ldf(o + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = fma_tier<M>(qc, ldf(k[e] + c), x[e]);
      y[e] = fma_tier<M>(oc, ldf(v[e] + c), y[e]);
    }
  }
}

// T: the storage of q, k, v, the tables, dout, dq, dk, dv (fp32 or bf16).
template <class T>
struct Args {
  const T *q, *k, *v, *rel_k, *rel_v;
  const int* lengths;
  const float *lse, *drow;
  const T* dout;
  T *dq, *dk, *dv;
  float *drk_part, *drv_part;
  int H, L, d, w, vec;
};

// dq and the rel-table partials of queries [q0, q0 + kT), columns of ``chunk``.
template <int NC, int CH, int M, class T>
__device__ void dq_block(const Args<T>& a, float* smem, int tile, int chunk, int tiles,
                         size_t bh, int nk) {
  constexpr int RS = row_stride<NC, CH>();
  constexpr int DV = 32 * NC;
  const int L = a.L, d = a.d, w = a.w, nr = 2 * w + 1;
  const int c0 = chunk * DV, ncols = d - c0 < DV ? d - c0 : DV;  // the chunk's columns
  const int q0 = tile * kT;
  const size_t head = bh * L * d;
  const size_t part = (bh * tiles + tile) * nr * d;
  if (nk == 0) {  // every p of the row is 0
    zero_rows(a.dq + head, q0, L, d, c0, ncols);
    for (int idx = threadIdx.x; idx < nr * ncols; idx += blockDim.x) {
      const int r = idx / ncols, c = c0 + idx - r * ncols;
      a.drk_part[part + r * d + c] = 0.f;
      a.drv_part[part + r * d + c] = 0.f;
    }
    return;
  }
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 3, kg = lane & 7;  // queries qg*4 + u; keys kg, kg + 8 / columns 4*kg
  float* qs = smem;               // kT x RS
  float* dos = qs + kT * RS;      // kT x RS
  float* rl = dos + kT * RS;      // kT x nr: q_i . rel_k[r]
  float* dr = rl + kT * nr;       // kT x nr: dout_i . rel_v[r]
  float* dsr = dr + kT * nr;      // kT x nr: ds_{i, i+r-w}
  float* pr = dsr + kT * nr;      // kT x nr: p_{i, i+r-w}
  float* region = smem + fixed_floats<NC, CH>(w);
  float* kvw = region + warp * warp_floats<NC, CH>();
  constexpr int stage = 2 * kT * RS;  // K and V of one step

  load_tile(qs, a.q + head, q0, L, d, RS);
  load_tile(dos, a.dout + head, q0, L, d, RS);
  for (int idx = tid; idx < 2 * kT * nr; idx += blockDim.x) dsr[idx] = 0.f;  // dsr and pr
  for (int idx = tid; idx < nw * warp_floats<NC, CH>(); idx += blockDim.x) region[idx] = 0.f;
  __syncthreads();
  for (int task = tid; task < kT * nr; task += blockDim.x) {  // two dots a thread
    const int qi = task % kT, r = task / kT;
    rl[qi * nr + r] = dot_rel<M>(qs + qi * RS, a.rel_k + (size_t)r * d, d);
    dr[qi * nr + r] = dot_rel<M>(dos + qi * RS, a.rel_v + (size_t)r * d, d);
  }
  __syncthreads();  // the last block barrier before the merge

  float lse_u[4], d_u[4], acc[4][4 * NC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = q0 + qg * 4 + u;
    lse_u[u] = i < L ? a.lse[bh * L + i] : 0.f;
    d_u[u] = i < L ? a.drow[bh * L + i] : 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) acc[u][e] = 0.f;
  }
  const T* kh = a.k + head;
  const T* vh = a.v + head;
  auto issue = [&](int step, int slot) {
    float* ks = kvw + slot * stage;
    issue_rows(ks, kh, step * kT, L, d, RS, a.vec, lane);
    issue_rows(ks + kT * RS, vh, step * kT, L, d, RS, a.vec, lane);
    cp_async_commit();
  };
  const int steps = (nk + kT - 1) / kT;
  const int d4 = (d + 3) / 4;
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
    const float* vs = ks + kT * RS;
    const int j0 = step * kT;

    // s and dp: lane (qg, kg) holds queries qg*4 + u against keys kg and kg + 8
    float s[4][2], t[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u][0] = s[u][1] = t[u][0] = t[u][1] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < d4; ++c4) {
      const float4 k0 = *reinterpret_cast<const float4*>(ks + kg * RS + 4 * c4);
      const float4 k1 = *reinterpret_cast<const float4*>(ks + (kg + 8) * RS + 4 * c4);
      const float4 v0 = *reinterpret_cast<const float4*>(vs + kg * RS + 4 * c4);
      const float4 v1 = *reinterpret_cast<const float4*>(vs + (kg + 8) * RS + 4 * c4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (qg * 4 + u) * RS + 4 * c4);
        const float4 ov = *reinterpret_cast<const float4*>(dos + (qg * 4 + u) * RS + 4 * c4);
        s[u][0] = dot4<M>(qv, k0, s[u][0]);
        s[u][1] = dot4<M>(qv, k1, s[u][1]);
        t[u][0] = dot4<M>(ov, v0, t[u][0]);
        t[u][1] = dot4<M>(ov, v1, t[u][1]);
      }
    }
    // window logits, p (0 past len), ds; the window's ds and p into dsr and pr
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qi = qg * 4 + u, i = q0 + qi;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + kg + 8 * e;
        const int delta = j - i;
        const bool win = delta >= -w && delta <= w;
        float x = s[u][e], y = t[u][e];
        if (win) {
          x += rl[qi * nr + delta + w];
          y += dr[qi * nr + delta + w];
        }
        const float p = j < nk && i < L ? expf(x - lse_u[u]) : 0.f;
        const float ds = p * (y - d_u[u]);
        if (win) {
          dsr[qi * nr + delta + w] = ds;
          pr[qi * nr + delta + w] = p;
        }
        s[u][e] = ds;
      }
    }
    // dq += ds k: lane (qg, kg) holds queries qg*4 + u at columns c0 + 4*kg + 32*n + (0..3)
#pragma unroll
    for (int jj = 0; jj < kT; ++jj) {
      float g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) g[u] = __shfl_sync(kFull, s[u][jj >> 3], (lane & 24) | (jj & 7));
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + jj * RS + c0 + 4 * kg + 32 * n);
#pragma unroll
        for (int u = 0; u < 4; ++u) fma4<M>(&acc[u][4 * n], g[u], kk);
      }
    }
    __syncwarp();  // this stage is consumed before it is refilled
    slot ^= 1;
  }
  cp_async_wait<0>();
  __syncwarp();

  // the rel_k term of the window keys this warp walked: ds_{i, i+r-w} rel_k[r] for
  // key j = i + r - w of a step this warp took (its dsr entries are its own lanes')
  for (int r = 0; r < nr; ++r) {
    float g[4];
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = q0 + qg * 4 + u + r - w, step = j / kT;
      const bool mine = j >= 0 && j < L && step < steps && step % nw == warp;
      g[u] = mine ? dsr[(qg * 4 + u) * nr + r] : 0.f;
      any |= mine;
    }
    if (!__any_sync(kFull, any)) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * kg + 32 * n + e;
        const float rk = c < d ? ldf(a.rel_k + (size_t)r * d + c) : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u][4 * n + e] = fma_tier<M>(g[u], rk, acc[u][4 * n + e]);
      }
    }
  }

  // merge the warps' dq in warp order, write
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float4*>(kvw + (qg * 4 + u) * DV + 4 * kg + 32 * n) =
          make_float4(acc[u][4 * n], acc[u][4 * n + 1], acc[u][4 * n + 2], acc[u][4 * n + 3]);
  __syncthreads();
  for (int idx = tid; idx < kT * ncols; idx += blockDim.x) {
    const int qi = idx / ncols, cl = idx - qi * ncols, c = c0 + cl;
    const int i = q0 + qi;
    if (i >= L) break;  // idx only grows, and i with it
    float o = 0.f;
    for (int wi = 0; wi < nw; ++wi) o += region[wi * warp_floats<NC, CH>() + qi * DV + cl];
    stf(a.dq + head + (size_t)i * d + c, o);
  }
  // this tile's share of drel_k = sum_i dsr_i q_i and drel_v = sum_i pr_i dout_i
  for (int idx = tid; idx < nr * ncols; idx += blockDim.x) {
    const int r = idx / ncols, c = c0 + idx - r * ncols;
    float x = 0.f, y = 0.f;
    for (int qi = 0; qi < kT; ++qi) {
      x = fma_tier<M>(dsr[qi * nr + r], qs[qi * RS + c], x);
      y = fma_tier<M>(pr[qi * nr + r], dos[qi * RS + c], y);
    }
    a.drk_part[part + r * d + c] = x;
    a.drv_part[part + r * d + c] = y;
  }
}

// dk and dv of keys [k0, k0 + kT), columns of ``chunk``.
template <int NC, int CH, int M, class T>
__device__ void dkv_block(const Args<T>& a, float* smem, int tile, int chunk, size_t bh, int nk) {
  constexpr int RS = row_stride<NC, CH>();
  constexpr int DV = 32 * NC;
  const int L = a.L, d = a.d, w = a.w, nr = 2 * w + 1;
  const int c0 = chunk * DV, ncols = d - c0 < DV ? d - c0 : DV;  // the chunk's columns
  const int k0 = tile * kT;
  const size_t head = bh * L * d;
  if (k0 >= nk) {  // every key of the tile lies at or past len: p = 0 throughout
    zero_rows(a.dk + head, k0, L, d, c0, ncols);
    zero_rows(a.dv + head, k0, L, d, c0, ncols);
    return;
  }
  const int nw = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kq = lane >> 3, qc = lane & 7;  // keys kq*4 + u; queries qc, qc + 8 / columns 4*qc
  float* ks = smem;                // kT x RS
  float* vs = ks + kT * RS;        // kT x RS
  const int nwin = kT + 2 * w;     // queries within the window of the tile's keys
  float* qrl = vs + kT * RS;       // nwin x nr: q_i . rel_k[r] for i = k0 - w + row
  float* drl = qrl + nwin * nr;    // nwin x nr: dout_i . rel_v[r]
  float* region = smem + fixed_floats<NC, CH>(w);
  float* qw = region + warp * warp_floats<NC, CH>();
  constexpr int stage = 2 * kT * RS + 2 * kT;  // Q, dout, lse and D of one step

  load_tile(ks, a.k + head, k0, L, d, RS);
  load_tile(vs, a.v + head, k0, L, d, RS);
  for (int idx = tid; idx < nw * warp_floats<NC, CH>(); idx += blockDim.x) region[idx] = 0.f;
  const T* qh = a.q + head;
  const T* oh = a.dout + head;
  const int nq = (nr + 3) / 4;  // the table's rows in fours: one query row read per four
  for (int task = tid; task < nwin * nq; task += blockDim.x) {
    const int row = task / nq, r0 = (task - row * nq) * 4, i = k0 - w + row;
    float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
    if (i >= 0 && i < L)
      window_dots<M>(qh + (size_t)i * d, oh + (size_t)i * d, a.rel_k, a.rel_v, r0, nr, d, x, y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (r0 + e < nr) {
        qrl[row * nr + r0 + e] = x[e];
        drl[row * nr + r0 + e] = y[e];
      }
    }
  }
  __syncthreads();  // the last block barrier before the merge

  const float* lseh = a.lse + bh * L;
  const float* drh = a.drow + bh * L;
  auto issue = [&](int step, int slot) {
    float* qs = qw + slot * stage;
    const int i0 = step * kT;
    issue_rows(qs, qh, i0, L, d, RS, a.vec, lane);
    issue_rows(qs + kT * RS, oh, i0, L, d, RS, a.vec, lane);
    if (lane < 2 * kT) {
      const int i = i0 + (lane & (kT - 1));
      const float* src = lane < kT ? lseh : drh;
      cp_async4_zfill(qs + 2 * kT * RS + lane, src + (i < L ? i : 0), i < L ? 4 : 0);
    }
    cp_async_commit();
  };
  float dka[4][4 * NC], dva[4][4 * NC];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 4 * NC; ++e) dka[u][e] = dva[u][e] = 0.f;
  const int steps = (L + kT - 1) / kT;
  const int d4 = (d + 3) / 4;
  int slot = 0;
  if (warp < steps) issue(warp, 0);
  for (int step = warp; step < steps; step += nw) {
    if (step + nw < steps)
      issue(step + nw, slot ^ 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const float* qs = qw + slot * stage;
    const float* dos = qs + kT * RS;
    const float* lses = dos + kT * RS;
    const float* ds_row = lses + kT;
    const int i0 = step * kT;

    // s and dp: lane (kq, qc) holds keys kq*4 + u against queries qc and qc + 8
    float s[4][2], t[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u][0] = s[u][1] = t[u][0] = t[u][1] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < d4; ++c4) {
      const float4 q0v = *reinterpret_cast<const float4*>(qs + qc * RS + 4 * c4);
      const float4 q1v = *reinterpret_cast<const float4*>(qs + (qc + 8) * RS + 4 * c4);
      const float4 o0v = *reinterpret_cast<const float4*>(dos + qc * RS + 4 * c4);
      const float4 o1v = *reinterpret_cast<const float4*>(dos + (qc + 8) * RS + 4 * c4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (kq * 4 + u) * RS + 4 * c4);
        const float4 vv = *reinterpret_cast<const float4*>(vs + (kq * 4 + u) * RS + 4 * c4);
        s[u][0] = dot4<M>(kv, q0v, s[u][0]);
        s[u][1] = dot4<M>(kv, q1v, s[u][1]);
        t[u][0] = dot4<M>(vv, o0v, t[u][0]);
        t[u][1] = dot4<M>(vv, o1v, t[u][1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = k0 + kq * 4 + u;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = qc + 8 * e, i = i0 + il;
        const int delta = j - i;
        float x = s[u][e], y = t[u][e];
        if (delta >= -w && delta <= w) {
          const int row = i - k0 + w;
          x += qrl[row * nr + delta + w];
          y += drl[row * nr + delta + w];
        }
        const float p = j < nk && i < L ? expf(x - lses[il]) : 0.f;
        s[u][e] = p * (y - ds_row[il]);
        t[u][e] = p;
      }
    }
    // dk += ds q, dv += p dout: lane (kq, qc) holds keys kq*4 + u at columns c0 + 4*qc + 32*n
#pragma unroll
    for (int ii = 0; ii < kT; ++ii) {
      float g[4], h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        g[u] = __shfl_sync(kFull, s[u][ii >> 3], (lane & 24) | (ii & 7));
        h[u] = __shfl_sync(kFull, t[u][ii >> 3], (lane & 24) | (ii & 7));
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + ii * RS + c0 + 4 * qc + 32 * n);
        const float4 oo = *reinterpret_cast<const float4*>(dos + ii * RS + c0 + 4 * qc + 32 * n);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          fma4<M>(&dka[u][4 * n], g[u], qq);
          fma4<M>(&dva[u][4 * n], h[u], oo);
        }
      }
    }
    __syncwarp();  // this stage is consumed before it is refilled
    slot ^= 1;
  }
  cp_async_wait<0>();
  __syncwarp();

  // merge the warps' dk and dv in warp order, write
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float* at = qw + (kq * 4 + u) * DV + 4 * qc + 32 * n;
      *reinterpret_cast<float4*>(at) =
          make_float4(dka[u][4 * n], dka[u][4 * n + 1], dka[u][4 * n + 2], dka[u][4 * n + 3]);
      *reinterpret_cast<float4*>(at + kT * DV) =
          make_float4(dva[u][4 * n], dva[u][4 * n + 1], dva[u][4 * n + 2], dva[u][4 * n + 3]);
    }
  __syncthreads();
  for (int idx = tid; idx < kT * ncols; idx += blockDim.x) {
    const int kl = idx / ncols, cl = idx - kl * ncols, c = c0 + cl;
    const int j = k0 + kl;
    if (j >= L) break;  // idx only grows, and j with it
    float x = 0.f, y = 0.f;
    for (int wi = 0; wi < nw; ++wi) {
      const float* src = region + wi * warp_floats<NC, CH>() + kl * DV + cl;
      x += src[0];
      y += src[kT * DV];
    }
    stf(a.dk + head + (size_t)j * d + c, x);
    stf(a.dv + head + (size_t)j * d + c, y);
  }
}

// Block x < tiles * CH: the dkv block of key tile x / CH, chunk x % CH; else the
// dq block of query tile (x - tiles * CH) / CH, chunk (x - tiles * CH) % CH.
template <int NC, int CH, int M, class T>
__global__ void __launch_bounds__(kMaxWarps * 32) rel_attention_bwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = gridDim.x / (2 * CH);
  const size_t bh = (size_t)blockIdx.z * a.H + blockIdx.y;
  const int len = a.lengths[blockIdx.z];
  const int nk = len < 0 ? 0 : (len < a.L ? len : a.L);  // keys that can weigh anything
  const int x = blockIdx.x;
  if (x < tiles * CH)
    dkv_block<NC, CH, M, T>(a, smem, x / CH, x % CH, bh, nk);
  else
    dq_block<NC, CH, M, T>(a, smem, (x - tiles * CH) / CH, (x - tiles * CH) % CH, tiles, bh,
                           nk);
}

template <int NC, int CH, int M, class T>
cudaError_t launch(const Args<T>& a, int B, cudaStream_t stream) {
  const int fixed = fixed_floats<NC, CH>(a.w);
  int nw = (kMaxSmemBytes / static_cast<int>(sizeof(float)) - fixed) / warp_floats<NC, CH>();
  nw = nw < kMaxWarps ? nw : kMaxWarps;
  if (nw < 1) return cudaErrorInvalidValue;
  const int smem = (fixed + nw * warp_floats<NC, CH>()) * static_cast<int>(sizeof(float));
  cudaError_t err = vk_set_smem(rel_attention_bwd_kernel<NC, CH, M, T>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.L + kT - 1) / kT;
  rel_attention_bwd_kernel<NC, CH, M, T><<<dim3(2 * tiles * CH, a.H, B), nw * 32, smem,
                                           stream>>>(a);
  return cudaGetLastError();
}

template <int M, class T>
cudaError_t launch_nc(const Args<T>& a, int B, cudaStream_t s) {
  switch ((a.d + 31) / 32) {  // column groups of 32: up to 4 in one block, else two chunks
    case 1:
      return launch<1, 1, M, T>(a, B, s);
    case 2:
      return launch<2, 1, M, T>(a, B, s);
    case 3:
      return launch<3, 1, M, T>(a, B, s);
    case 4:
      return launch<4, 1, M, T>(a, B, s);
    case 5:
    case 6:
      return launch<3, 2, M, T>(a, B, s);
    default:
      return launch<4, 2, M, T>(a, B, s);
  }
}

template <class T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* rel_k,
                         const void* rel_v, const int* lengths, const float* lse,
                         const float* drow, const void* dout, void* dq, void* dk, void* dv,
                         float* drk_part, float* drv_part, int B, int H, int L, int d, int w,
                         int mode, cudaStream_t s) {
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec = d % (16 / static_cast<int>(sizeof(T))) == 0 && aligned(q) && aligned(k) &&
                  aligned(v) && aligned(dout);
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(rel_k), static_cast<const T*>(rel_v), lengths, lse, drow,
                  static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
                  static_cast<T*>(dv), drk_part, drv_part, H, L, d, w, vec};
  // the training tiers: exact on fp32 (fp32 training), fast on bf16 (bf16 training)
  if constexpr (sizeof(T) == 2)
    return mode == kFast ? launch_nc<kFast>(a, B, s) : cudaErrorInvalidValue;
  else
    return mode == kExact ? launch_nc<kExact>(a, B, s) : cudaErrorInvalidValue;
}

}  // namespace

namespace attn_bwd {
// launch_typed on fp32 and on bf16 storage, each in its own translation unit.
#define VK_ATTN_BWD_ARGS                                                                     \
  const void *q, const void *k, const void *v, const void *rel_k,                            \
      const void *rel_v, const int *lengths, const float *lse, const float *drow,            \
      const void *dout, void *dq, void *dk, void *dv, float *drk_part, float *drv_part,      \
      int B, int H, int L, int d, int w, int mode, cudaStream_t s
cudaError_t typed32(VK_ATTN_BWD_ARGS);
cudaError_t typed16(VK_ATTN_BWD_ARGS);
}  // namespace attn_bwd
