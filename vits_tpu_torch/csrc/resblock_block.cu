// Kernel 7 on the H100: one masked HiFiGAN resblock in one launch.
//
// Replaces vits_tpu/ops/pallas/resblock.py::fused_resblock (its _kernel): for
// each pair i (dilation d_i) of a resblock over (B, T, C) activations,
//   y1 = zero outside [0, len) of (dilated conv_k(leaky(x)) + b1)
//   x  = zero outside [0, len) of (x + conv_k(leaky(y1)) + b2)
// driven by vits_tpu_torch/ops/cuda/resblock.py::fused_resblock on the narrow
// vocoder stages (C = 8, 16, 32, 64: HiFi-GAN V2's stages 0-1 at 64 and 32).
//
// What bounds it on an H100: operations, and before this design latency.
// A resblock at C = 64, k = 11 over 2523 frames is 1.4 GFLOP of fp32 work
// (8 us at the 165 TFLOP/s 3xTF32 ceiling) against 1.3 MB of activations
// (0.4 us of HBM). It ran as six conv launches of B's conv (run_pairs), each
// a few us of products behind ~10 us of launch latency, with y1 and every
// pair's output making a round trip through HBM.
//
// Design (the TPU kernel's): a block owns bm output rows of one batch row. It
// loads the x window [t0 - H, t0 + bm + H) once (H = the sum of every pair's
// two reaches, 60 at k = 11), with cp.async, zero outside [0, T), and runs all
// convs in shared memory: conv1 over the window shrunk by d*(k-1)/2 on each
// side, masked to zero outside [0, len) in global coordinates, then conv2
// shrunk by (k-1)/2, the residual from the same rows of x, the mask again.
// Activations never go back to HBM between convs; only the last conv writes.
// - Grid fill. One busy row of 2523 frames is ~20 tiles of 128 for 132 SMs,
//   and a smaller tile multiplies the halo recompute (rows computed over the
//   six convs: ~1.5x the output at bm = 128, ~2.8x at 32). So the out-
//   channels of every conv are split over a thread-block cluster of C / N
//   blocks: each block computes N columns of a conv and stores them into
//   every block's copy of the next conv's input over distributed shared
//   memory, and a cluster barrier separates the convs. The cluster fills the
//   card without extra recompute; ops/cuda/resblock.py::block_plan picks the
//   tile and the cluster size by a cost model fitted on the card.
// - Shared memory: two windows, x and leaky(y1), of (bm + 2H + 16) rows of
//   C + 4 floats (the stride makes ldmatrix conflict-free), and two buffers
//   of one conv's (k, C, N) weight columns: the next conv's weights are in
//   flight (cp.async) while the current conv runs. The weight rows are
//   stored unpadded with the 8-column blocks XOR-swizzled by row (wcol), so
//   the B fragments load without bank conflicts.
// - Products: 3xTF32 mma.sync m16n8k8, as conv_gemm.cuh. A fragments come
//   raw from the window by one ldmatrix, then leaky (conv1; the y1 window
//   holds leaky(y1) already) and the hi/lo split in registers; weights are
//   split after their shared-memory load. Splits are the bulk of the issue
//   slots here, so they round on the bits (split_rna: two integer ops a
//   rounding, the same values as cvt.rna) and leaky is max(v, v * slope).
//   Each (tap, 32-channel chunk) step's products sum into a zeroed partial,
//   small products first, added to the accumulator in fp32 (the precision
//   rule of conv_gemm.cuh); the three products of a k8 step run as three
//   passes over the n8 tiles, so no MMA waits on the one before it. A unit
//   of work is one m16 tile x up to four n8 tiles; units go round 16 warps
//   (at most 128 registers a thread, one block an SM). Two m16 tiles a unit,
//   or 8 warps, left warps idle at the short convs and measured slower.
// - A tile that starts at or past its row's length skips its loads and
//   products and writes zeros (out * scale with accumulate).
// - With accumulate the last conv adds its result to out, then everything is
//   multiplied by scale: the caller's sum over a stage's resblocks and its
//   division folded into the epilogue.
// - Precision tiers (the template's M, common.cuh TierMode): kExact is the
//   3xTF32 above; kFast rounds both operands to bf16 and runs only the hi*hi
//   pass, kHigh splits both into bf16 hi and lo (split_tier) and runs all
//   three, on the same TF32 MMAs (exact products of bf16 values, fp32 sums).
//   With round (the bf16 value dtype) the x window is rounded to bf16 once it
//   lands and each pair's output before it is stored, where the JAX kernel
//   casts to its value dtype.
// - bf16 serving (io16, at kFast): the JAX package runs no kernel at
//   compute_dtype="bfloat16" but XLA's bf16 graph of the plain resblock, and
//   this launch computes that graph: x, out, the weights and biases are bf16
//   in memory (widened as they are staged, by plain loads), both leakys take
//   the bf16 slope, and each conv's sum, + bias, + residual, the running sum
//   over the stage's resblocks (accumulate) and the division by their number
//   (divisor) are rounded to bf16 where XLA rounds them; the mask zeroes rows
//   after each conv as before.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPairs = 4;
constexpr int kMargin = 16;  // window rows past bm + 2H that a partial m16 tile may read

struct Block {
  const void* x;        // (B, T, C), fp32 (bf16 with io16)
  void* out;            // (B, T, C), fp32 (bf16 with io16)
  const int* lengths;   // (B,) valid rows, or null: every row T long
  int T, bm, halo, k, pairs, accumulate, round;
  float slope, scale, divisor;
  float xslope;  // conv1's leaky of the x window: with round or io16 a bf16 constant, as in JAX
  int dil[kMaxPairs];
  const void* w[2 * kMaxPairs];     // conv c: w1 of pair c / 2 (c even), w2 (c odd); (k, C, C)
  const void* bias[2 * kMaxPairs];  // (C,)
};

// Two adjacent values of an fp32 or (kIO16) bf16 vector as floats.
template <bool kIO16>
__device__ __forceinline__ float2 load2(const void* base, size_t at) {
  if constexpr (kIO16)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(base) + at));
  else
    return *reinterpret_cast<const float2*>(static_cast<const float*>(base) + at);
}
template <bool kIO16>
__device__ __forceinline__ void store2(void* base, size_t at, float2 v) {
  if constexpr (kIO16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) + at) =
        __floats2bfloat162_rn(v.x, v.y);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(base) + at) = v;
}

// split_tf32 (common.cuh) on the bits: hi = x rounded to tf32 (to nearest, ties
// away from zero: cvt.rna's value for finite x), lo = the rest rounded the
// same way. Two integer ops a rounding.
__device__ __forceinline__ unsigned rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_rna(float x, unsigned& hi, unsigned& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}
// An operand's split at tier M: split_rna for kExact, else split_tier.
template <int M>
__device__ __forceinline__ void split_m(float x, unsigned& hi, unsigned& lo) {
  if constexpr (M == kExact)
    split_rna(x, hi, lo);
  else
    split_tier<M>(x, hi, lo);
}

// Column of element (row, col) in a weight row of N floats: the 8-column
// blocks are XOR-swizzled by the row, so that lanes (g, t) reading rows
// kk + t (kk % 4 == 0) at columns n0 + g hit 32 distinct banks.
template <int N>
__device__ __forceinline__ int wcol(int row, int col) {
  if constexpr (N >= 32) return col ^ ((row & 3) << 3);
  else if constexpr (N == 16) return col ^ (((row >> 1) & 1) << 3);
  else return col;
}

// One conv of the block: output rows [s, s + rows) of the window, from src rows
// [s - reach, s + M + reach) at dilation d, all k taps, into the epilogue.
// Its units, one m16 tile x NTW n8 tiles each, go round the warps.
template <int C, int N, bool kLeaky, int M, bool kIO16>
__device__ __forceinline__ void conv_pass(const Block& a, cg::cluster_group& cluster, float* X,
                                          float* Y, const float* src, const float* wt,
                                          const void* bias, int s, int rows, int reach, int d,
                                          int stage, bool last, int t0, int b, int len, int co0) {
  constexpr int XS = C + 4;
  constexpr int CS = C / N;
  constexpr int NT = N / 8;
  constexpr int NTW = NT > 4 ? 4 : NT;  // n8 tiles of a unit
  constexpr int NG = NT / NTW;          // column groups
  const int k = a.k, H = a.halo, T = a.T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  // this lane's ldmatrix row: row lane % 8 of block lane / 8 (rows 0-7 / 8-15, words 0-3 / 4-7)
  const int lrow = (lane >> 3 & 1) * 8 + (lane & 7), lcol = (lane >> 4) * 4;
  const int units = (rows + 15) / 16 * NG;
  for (int u = warp; u < units; u += kWarps) {
    const int n0 = u % NG * NTW * 8;  // first local column
    const int r0 = s + u / NG * 16;   // first row
    float acc[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int tap = 0; tap < k; ++tap) {
      const float* arow = src + (r0 - reach + tap * d + lrow) * XS + lcol;
      const float* wtap = wt + tap * C * N;
#pragma unroll
      for (int kc = 0; kc < C; kc += 32) {
        float part[NTW][4];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
        for (int kk = kc; kk < (kc + 32 < C ? kc + 32 : C); kk += 8) {
          unsigned raw[4], ah[4], al[4], bh[NTW][2], bl[NTW][2];
          ldmatrix_x4(raw, arow + kk);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const int col = n0 + nt * 8 + gr;
            split_m<M>(wtap[(kk + tq) * N + wcol<N>(kk + tq, col)], bh[nt][0], bl[nt][0]);
            split_m<M>(wtap[(kk + tq + 4) * N + wcol<N>(kk + tq + 4, col)], bh[nt][1],
                       bl[nt][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // leaky(v) = max(v, v * slope) for a slope in [0, 1] (vk_resblock_block checks)
            const float v = __uint_as_float(raw[e]);
            split_m<M>(kLeaky ? fmaxf(v, v * a.xslope) : v, ah[e], al[e]);
          }
          // each accumulator takes lo*hi, hi*lo, hi*hi in turn (kFast: hi*hi);
          // the passes run over the n8 tiles, so that no MMA waits on the one before it
          if constexpr (M != kFast) {
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) mma_tf32(part[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) mma_tf32(part[nt], ah, bl[nt][0], bl[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma_tf32(part[nt], ah, bh[nt][0], bh[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
      }
    }

    // Epilogue: rows r0 + gr (+8), local columns n0 + nt*8 + 2*tq (+1).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + gr + 8 * h;
      if (r >= s + rows) continue;
      const int p = t0 - H + r;  // global time step
      const bool valid = p >= 0 && p < len;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int col = co0 + n0 + nt * 8 + 2 * tq;
        const float2 bv = load2<kIO16>(bias, col);
        float2 y = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        if constexpr (kIO16)  // the conv's sum, then + bias, each rounded
          y = make_float2(bf16_round(bf16_round(y.x) + bv.x), bf16_round(bf16_round(y.y) + bv.y));
        else
          y = make_float2(y.x + bv.x, y.y + bv.y);
        float* at = (stage == 0 ? Y : X) + r * XS + col;
        if (stage == 0) {  // conv1: the next conv's input, leaky(y1), masked
          y = valid ? make_float2(fmaxf(y.x, y.x * a.slope), fmaxf(y.y, y.y * a.slope))
                    : make_float2(0.f, 0.f);
        } else {  // conv2: the residual from the same rows of x, masked
          const float2 xr = *reinterpret_cast<const float2*>(at);
          y = valid ? make_float2(xr.x + y.x, xr.y + y.y) : make_float2(0.f, 0.f);
          if (kIO16 || a.round) y = make_float2(bf16_round(y.x), bf16_round(y.y));
        }
        if (last) {  // r in [H, H + bm): output step p in [t0, t0 + bm)
          if (p < T) {
            const size_t o = ((size_t)b * T + p) * C + col;
            if constexpr (kIO16) {  // XLA's bf16 sum over the resblocks and division
              if (a.accumulate) {
                const float2 prev = load2<true>(a.out, o);
                y = make_float2(bf16_round(prev.x + y.x), bf16_round(prev.y + y.y));
              }
              if (a.divisor != 1.f)
                y = make_float2(bf16_round(y.x / a.divisor), bf16_round(y.y / a.divisor));
              store2<true>(a.out, o, y);
            } else {
              if (a.accumulate) {
                const float2 prev = load2<false>(a.out, o);
                y = make_float2(prev.x + y.x, prev.y + y.y);
              }
              store2<false>(a.out, o, make_float2(y.x * a.scale, y.y * a.scale));
            }
          }
        } else if constexpr (CS == 1) {
          *reinterpret_cast<float2*>(at) = y;
        } else {  // into every block of the cluster
#pragma unroll
          for (int q = 0; q < CS; ++q)
            *reinterpret_cast<float2*>(cluster.map_shared_rank(at, q)) = y;
        }
      }
    }
  }
}

template <int C, int N, int M, bool kIO16>
__global__ void __launch_bounds__(kThreads, 1) block_kernel(const Block a) {
  constexpr int XS = C + 4;
  constexpr int CS = C / N;  // cluster size: blocks sharing the out-channels
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = CS > 1 ? blockIdx.x % CS : 0;  // clusters are (CS, 1, 1)
  const int t0 = blockIdx.x / CS * a.bm;
  const int b = blockIdx.y;
  const int T = a.T, k = a.k, H = a.halo;
  const int W = a.bm + 2 * H;
  const int len = a.lengths ? min(a.lengths[b], T) : T;
  const int co0 = rank * N;
  const int tid = threadIdx.x;

  if (t0 >= len) {  // no valid row: zeros, or out * scale (io16: / divisor) with accumulate
    const int rows = min(a.bm, T - t0);
    const size_t o0 = ((size_t)b * T + t0) * C + co0;
    for (int idx = tid; idx < rows * (N / 2); idx += kThreads) {
      const size_t o = o0 + (size_t)(idx / (N / 2)) * C + idx % (N / 2) * 2;
      float2 v = a.accumulate ? load2<kIO16>(a.out, o) : make_float2(0.f, 0.f);
      if constexpr (kIO16)
        v = a.divisor != 1.f ? make_float2(bf16_round(v.x / a.divisor), bf16_round(v.y / a.divisor))
                             : v;
      else
        v = make_float2(v.x * a.scale, v.y * a.scale);
      store2<kIO16>(a.out, o, v);
    }
    return;  // every block of the cluster takes this branch (same tile)
  }

  float* X = smem;                          // x window: row r <-> step t0 - H + r
  float* Y = X + (W + kMargin) * XS;        // leaky(y1) window, same rows
  float* wbuf = Y + (W + kMargin) * XS;     // two buffers of one conv's (k, C, N) weights
  const int wfl = k * C * N;

  if constexpr (kIO16) {  // bf16 x: load, widen, store
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x) + (size_t)b * T * C;
    for (int idx = tid; idx < W * (C / 2); idx += kThreads) {
      const int r = idx / (C / 2), c2 = idx % (C / 2) * 2;
      const int p = t0 - H + r;
      const float2 v = p >= 0 && p < T ? load2<true>(xb, (size_t)p * C + c2) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(X + r * XS + c2) = v;
    }
  } else {
    const float* xb = static_cast<const float*>(a.x) + (size_t)b * T * C;
    for (int idx = tid; idx < W * (C / 4); idx += kThreads) {
      const int r = idx / (C / 4), c4 = idx % (C / 4);
      const int p = t0 - H + r;
      const bool in = p >= 0 && p < T;
      cp_async16_zfill(X + r * XS + c4 * 4, in ? xb + (size_t)p * C + c4 * 4 : a.x, in ? 16 : 0);
    }
  }
  // conv c's weight columns [co0, co0 + N) into buffer c % 2 (io16: widened by plain loads)
  auto issue_w = [&](int c) {
    float* dst = wbuf + (c & 1) * wfl;
    if constexpr (kIO16) {
      const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w[c]) + co0;
      for (int idx = tid; idx < k * C * (N / 2); idx += kThreads) {
        const int row = idx / (N / 2), col = idx % (N / 2) * 2;
        *reinterpret_cast<float2*>(dst + row * N + wcol<N>(row, col)) =
            load2<true>(w, (size_t)row * C + col);
      }
      return;
    }
    const float* w = static_cast<const float*>(a.w[c]) + co0;
    for (int idx = tid; idx < k * C * (N / 4); idx += kThreads) {
      const int row = idx / (N / 4), col = idx % (N / 4) * 4;  // row = tap * C + ci
      cp_async16(dst + row * N + wcol<N>(row, col), w + (size_t)row * C + col);
    }
  };
  issue_w(0);
  cp_async_commit();
  const int convs = 2 * a.pairs;
  if (convs > 1) issue_w(1);
  cp_async_commit();

  int o = 0;  // rows of the window consumed from each edge so far
  for (int c = 0; c < convs; ++c) {
    if (c == 0) {
      cp_async_wait<1>();
      if (a.round) {  // the bf16 value dtype: x as the JAX kernel casts it
        __syncthreads();
        for (int idx = tid; idx < W * C; idx += kThreads) {
          float* v = X + idx / C * XS + idx % C;
          *v = bf16_round(*v);
        }
      }
    } else {
      cp_async_wait<0>();
    }
    // conv c's weights and input landed for every thread of the cluster, and
    // conv c - 1 finished reading what conv c overwrites
    if constexpr (CS > 1)
      cluster.sync();
    else
      __syncthreads();
    if (c >= 1 && c + 1 < convs) issue_w(c + 1);  // into the buffer conv c - 1 read
    cp_async_commit();
    const int stage = c & 1;
    const int d = stage ? 1 : a.dil[c >> 1];
    const int reach = d * (k - 1) / 2;
    const int s = o + reach;
    const int rows = W - 2 * s;
    o = s;
    const float* wt = wbuf + (c & 1) * wfl;
    if (stage == 0)
      conv_pass<C, N, true, M, kIO16>(a, cluster, X, Y, X, wt, a.bias[c], s, rows, reach, d, 0,
                               c == convs - 1, t0, b, len, co0);
    else
      conv_pass<C, N, false, M, kIO16>(a, cluster, X, Y, Y, wt, a.bias[c], s, rows, reach, d, 1,
                                c == convs - 1, t0, b, len, co0);
  }
}

template <int C, int N, int M, bool kIO16 = false>
cudaError_t launch_mode(const Block& a, int B, cudaStream_t stream) {
  const size_t window = a.bm + 2 * a.halo + kMargin;
  const size_t smem = (2 * window * (C + 4) + 2 * (size_t)a.k * C * N) * sizeof(float);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem_once<block_kernel<C, N, M, kIO16>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.T + a.bm - 1) / a.bm * (C / N), B, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C / N;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, block_kernel<C, N, M, kIO16>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C, int N>
cudaError_t launch(const Block& a, int mode, int io16, int B, cudaStream_t stream) {
  if (io16) return launch_mode<C, N, kFast, true>(a, B, stream);  // bf16 serving: kFast
  switch (mode) {
    case kExact:
      return launch_mode<C, N, kExact>(a, B, stream);
    case kFast:
      return launch_mode<C, N, kFast>(a, B, stream);
    case kHigh:
      return launch_mode<C, N, kHigh>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One resblock: out = (accumulate ? out : 0) + resblock(x), times scale, for
// x and out (B, T, C) fp32 contiguous and 16-byte aligned, C in 8, 16, 32, 64.
// With io16 (bf16 serving, mode kFast) x, out, the weights and the biases are
// bf16 and the launch is XLA's bf16 graph of the resblock: out = (accumulate ?
// out + resblock(x) : resblock(x)) / divisor, every step rounded to bf16.
// weights: 4 * pairs pointers in ops/cuda/resblock.py::pair_weights' order
// (w1, b1, w2, b2 of each pair; w (k, C, C) as the JAX loader lays it out, b
// (C,)), 16-byte aligned; dilations: pairs ints; lengths (B,) int32 or null
// (every row T long). bm (a multiple of 16) and cluster (dividing C, C /
// cluster >= 8) come from ops/cuda/resblock.py::block_plan; mode is the tier
// (TierMode) and round the bf16 value carry. One launch.
VK_EXPORT int vk_resblock_block(const void* x, void* out, const int* lengths,
                                const void* const* weights, const int* dilations, int pairs,
                                int B, int T, int C, int k, float slope, int bm, int cluster,
                                int accumulate, float scale, int mode, int round,
                                float divisor, int io16, void* stream) {
  if (pairs < 1 || pairs > kMaxPairs || k < 1 || k % 2 == 0 || B < 1 || T < 1 || bm < 16 ||
      bm % 16 || cluster < 1 || C % cluster || C / cluster < 8 ||
      !(slope >= 0.f && slope <= 1.f) || divisor == 0.f ||
      (io16 && (mode != kFast || round || scale != 1.f)) || (!io16 && divisor != 1.f))
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(out)) return cudaErrorMisalignedAddress;
  Block a = {};
  a.x = x;
  a.out = out;
  a.lengths = lengths;
  a.T = T;
  a.bm = bm;
  a.k = k;
  a.pairs = pairs;
  a.accumulate = accumulate;
  a.round = round;
  const float slope16 = __bfloat162float(__float2bfloat16_rn(slope));
  a.slope = io16 ? slope16 : slope;
  a.xslope = round || io16 ? slope16 : slope;
  a.scale = scale;
  a.divisor = divisor;
  a.halo = 0;
  for (int i = 0; i < pairs; ++i) {
    if (dilations[i] < 1) return cudaErrorInvalidValue;
    a.dil[i] = dilations[i];
    a.halo += dilations[i] * (k - 1) / 2 + (k - 1) / 2;
    for (int j = 0; j < 4; ++j)
      if (misaligned(weights[4 * i + j])) return cudaErrorMisalignedAddress;
    a.w[2 * i] = weights[4 * i];
    a.bias[2 * i] = weights[4 * i + 1];
    a.w[2 * i + 1] = weights[4 * i + 2];
    a.bias[2 * i + 1] = weights[4 * i + 3];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = C / cluster;
  switch (C * 100 + N) {
    case 808:
      return launch<8, 8>(a, mode, io16, B, s);
    case 1616:
      return launch<16, 16>(a, mode, io16, B, s);
    case 1608:
      return launch<16, 8>(a, mode, io16, B, s);
    case 3232:
      return launch<32, 32>(a, mode, io16, B, s);
    case 3216:
      return launch<32, 16>(a, mode, io16, B, s);
    case 3208:
      return launch<32, 8>(a, mode, io16, B, s);
    case 6464:
      return launch<64, 64>(a, mode, io16, B, s);
    case 6432:
      return launch<64, 32>(a, mode, io16, B, s);
    case 6416:
      return launch<64, 16>(a, mode, io16, B, s);
    case 6408:
      return launch<64, 8>(a, mode, io16, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}
