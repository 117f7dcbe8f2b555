// One tile of a direct conv over narrow channels on the tensor cores (3xTF32
// mma.sync m16n8k8), shared by the resblock convs below 32 channels
// (resblock_trio.cu::narrow_conv_kernel) and the polyphase upsampler
// (stage.cu::upsample_kernel; at the `fast` tier on bf16 packs with bf16 values
// and C_out 16, 32 or 64 the upsampler is upsample_wgmma.cu's instead, which
// stages the bf16 weights and input by TMA as they are):
//
//   out[b, os*t + oo] = mask_t(bias + sum_i leaky(x[b, t - pad + i*dil]) @ w[wt0 + wts*i]
//                              [+ residual]) [+ out], times scale
//
// for the block's kBM rows t and up to 64 out-channels, with mask_t zeroing
// t >= lengths[b]. A Conv1d is os = 1, oo = 0, wt0 = 0, wts = 1; one phase phi
// of a stride-s ConvTranspose1d is os = s, oo = phi, dil = 1, taps at weight
// stride s (ops/cuda/stage.py::upsample_phases gives the table).
//
// What bounds it: at the vocoder's narrow stages (C = 8 .. 128 in, 8 .. 64
// out) the products are a few GFLOP at most, so bytes bound it: each input
// read once, each output written once (and read once with accumulate). Its
// bf16 and int8 weights are staged by scalar loads, every block again: the
// reason the `fast` upsampler moved to TMA. At
// these sizes a block is short, so its latency is what costs: the tile
// issues every 16-byte cp.async of the (taps, C_in, cols) weights and the raw
// x window at once (one round trip, not one per copy), zero-padded to
// K = taps x round8(C_in) and to whole n8 tiles, and loads its epilogue's
// bias, residual and running mean while they land. Then each warp runs one
// m16 tile against NT n8 tiles: A and B fragments come from conflict-free
// strides (window rows round8(C_in) + 4, weight rows NT*8 (+8) floats),
// leaky is applied to A, and both are split into hi/lo in registers.
// As in conv_kernel (conv_gemm.cuh), each (tap, 32-channel) step's
// products sum into a zeroed partial, small products first, added to the
// accumulator in fp32. A tile at or past its row's length skips its loads
// and products and only runs the epilogue.
//
// Precision tiers (the template's M, common.cuh TierMode): the operands are
// split by split_tier, so kFast multiplies bf16-rounded operands once and
// kHigh runs the bf16x3 split's three passes, on the same TF32 MMAs (a tf32
// MMA of bf16 values is exact products summed in fp32). bf16 and int8
// weights (wfmt) are read at 2 and 1 bytes an entry and converted to fp32 as
// they are staged (plain loads, not cp.async); int8 sums are scaled by
// wscale per out-channel before the bias. With round the output is rounded to
// bf16 (the bf16 value carry) before accumulate and scale.
//
// conv_tile16 below is the same tile for bf16 serving (kFast, bf16 weights):
// x, the residual and the output are bf16 storage, widened as they are staged
// (plain loads), and the epilogue is XLA's bf16 graph of the step as
// conv::Bf16Epi computes it: the conv's sum, + bias, + residual, + the running
// sum (accumulate), / divisor, each rounded to bf16; rows at and past the
// length are zero before the running sum. With per_tap (the polyphase
// upsampler, whose JAX form is one matmul a tap) each tap's products are summed
// and rounded on their own, and the taps are added last to first, each add
// rounded, as the JAX package's bf16 per-phase transposed conv adds them. It
// is a function of its own so that conv_tile's fp32 / tier code stays as it was.
#pragma once

#include "common.cuh"

namespace narrow {

constexpr int kWarps = 4;
constexpr int kBM = 16 * kWarps;  // rows per block: one m16 tile per warp
constexpr int kCols = 64;         // out-channels per block: up to eight n8 tiles

struct Conv {
  const float* x;         // (B, T_x, C_in)
  float* out;             // (B, os * T, C_out)
  const void* w;          // (taps, C_in, C_out) in the format wfmt (WeightFormat)
  const float* bias;      // (C_out,)
  const float* residual;  // like out, or null
  const int* lengths;     // (B,) valid rows t
  int T_x, T, C_in, C_out;
  int dil, wts, os;
  float slope;
  int accumulate;
  float scale;
  int vec_x, vec_w;  // 16-byte loads of x (C_in % 4 == 0) and w (C_out % 4 == 0)
  int wfmt = kW32;
  const float* wscale = nullptr;  // int8: (C_out,) per-out-channel scale
  int round = 0;
  __nv_bfloat16* out16 = nullptr;  // with it the result goes there as bf16 (out: accumulate's)
};

inline __host__ __device__ int k_pad(int C_in) { return (C_in + 7) / 8 * 8; }
inline __host__ __device__ int x_stride(int C_in) { return k_pad(C_in) + 4; }
inline __host__ __device__ int w_stride(int nt) { return nt * 8 + (nt % 2 == 0 ? 8 : 0); }
// Shared memory (floats) of a tile with n taps.
inline __host__ __device__ int smem_floats(int nt, int n, int dil, int C_in) {
  return n * k_pad(C_in) * w_stride(nt) + (kBM + (n - 1) * dil) * x_stride(C_in);
}

// Rows [t0, t0 + kBM) and columns [co0, co0 + 8*NT) of batch row b, with n
// taps at input offset -pad, weights from tap wt0, output rows os*t + oo.
template <int NT, int M>
__device__ __forceinline__ void conv_tile(const Conv& c, float* smem, int b, int t0, int co0,
                                          int n, int pad, int wt0, int oo) {
  constexpr int cols = 8 * NT;
  const int Kp = k_pad(c.C_in), XS = x_stride(c.C_in), WS = w_stride(NT);
  const int win = kBM + (n - 1) * c.dil;
  float* ws = smem;               // n x Kp x WS
  float* xs = smem + n * Kp * WS; // win x XS, row r <-> input row t0 - pad + r
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = c.lengths[b];
  const bool live = t0 < len;
  // Every copy of the tile in flight at once (cp.async, zero-fill past the
  // edges), then the epilogue's operands, so that the block waits for one
  // round trip to memory before its products, not one per loop iteration.
  if (live) {
    if (c.wfmt != kW32) {  // bf16 or int8: load, convert, store
      for (int idx = tid; idx < n * Kp * cols; idx += blockDim.x) {
        const int row = idx / cols, col = idx - row * cols;
        const int tap = row / Kp, ci = row - tap * Kp, co = co0 + col;
        float v = 0.f;
        if (ci < c.C_in && co < c.C_out) {
          const size_t at = ((size_t)(wt0 + c.wts * tap) * c.C_in + ci) * c.C_out + co;
          v = c.wfmt == kW16 ? wvalue(static_cast<const __nv_bfloat16*>(c.w)[at])
                             : wvalue(static_cast<const signed char*>(c.w)[at]);
        }
        ws[row * WS + col] = v;
      }
    } else if (c.vec_w) {
      const float* w = static_cast<const float*>(c.w);
      for (int idx = tid; idx < n * Kp * (cols / 4); idx += blockDim.x) {
        const int row = idx / (cols / 4), c4 = idx - row * (cols / 4);  // row = tap*Kp + ci
        const int tap = row / Kp, ci = row - tap * Kp, co = co0 + 4 * c4;
        const bool in = ci < c.C_in && co < c.C_out;
        cp_async16_zfill(ws + row * WS + 4 * c4,
                         in ? w + ((size_t)(wt0 + c.wts * tap) * c.C_in + ci) * c.C_out + co
                            : w,
                         in ? 16 : 0);
      }
    } else {
      const float* w = static_cast<const float*>(c.w);
      for (int idx = tid; idx < n * Kp * cols; idx += blockDim.x) {
        const int row = idx / cols, col = idx - row * cols;
        const int tap = row / Kp, ci = row - tap * Kp, co = co0 + col;
        const bool in = ci < c.C_in && co < c.C_out;
        cp_async4_zfill(ws + row * WS + col,
                        in ? w + ((size_t)(wt0 + c.wts * tap) * c.C_in + ci) * c.C_out + co
                           : w,
                        in ? 4 : 0);
      }
    }
    const float* xb = c.x + (size_t)b * c.T_x * c.C_in;
    if (c.vec_x) {
      for (int idx = tid; idx < win * (Kp / 4); idx += blockDim.x) {
        const int r = idx / (Kp / 4), c4 = idx - r * (Kp / 4);
        const int p = t0 - pad + r;
        const bool in = 4 * c4 < c.C_in && p >= 0 && p < c.T_x;
        cp_async16_zfill(xs + r * XS + 4 * c4, in ? xb + (size_t)p * c.C_in + 4 * c4 : c.x,
                         in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < win * Kp; idx += blockDim.x) {
        const int r = idx / Kp, ci = idx - r * Kp;
        const int p = t0 - pad + r;
        const bool in = ci < c.C_in && p >= 0 && p < c.T_x;
        cp_async4_zfill(xs + r * XS + ci, in ? xb + (size_t)p * c.C_in + ci : c.x, in ? 4 : 0);
      }
    }
    cp_async_commit();
  }

  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int m0 = warp * 16;
  const size_t rows_out = (size_t)c.os * c.T;
  float* ob = c.out + (size_t)b * rows_out * c.C_out;
  const float* rb = c.residual ? c.residual + (size_t)b * rows_out * c.C_out : nullptr;
  // this lane's outputs: rows t0 + m0 + g (+8), columns co0 + nt*8 + 2*tq (+1)
  float bias[NT][2], wsc[NT][2], res[2][NT][2], prev[2][NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + nt * 8 + 2 * tq + e;
      bias[nt][e] = co < c.C_out ? c.bias[co] : 0.f;
      wsc[nt][e] = c.wscale && co < c.C_out ? c.wscale[co] : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + m0 + g + 8 * h;
        const bool out_in = t < c.T && co < c.C_out;
        const size_t at = ((size_t)c.os * t + oo) * c.C_out + co;
        res[h][nt][e] = rb && out_in && t < len ? rb[at] : 0.f;
        prev[h][nt][e] = c.accumulate && out_in ? ob[at] : 0.f;
      }
    }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  if (live) {
    cp_async_wait<0>();
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* xa = xs + (m0 + i * c.dil + g) * XS + tq;
      const float* wb = ws + i * Kp * WS + tq * WS + g;
      for (int kc = 0; kc < Kp; kc += 32) {
        const int kend = kc + 32 < Kp ? kc + 32 : Kp;
        float part[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
        for (int k8 = kc; k8 < kend; k8 += 8) {
          unsigned ah[4], al[4];  // leaky here: the window holds raw x
          split_tier<M>(vk_leaky(xa[k8], c.slope), ah[0], al[0]);
          split_tier<M>(vk_leaky(xa[8 * XS + k8], c.slope), ah[1], al[1]);
          split_tier<M>(vk_leaky(xa[k8 + 4], c.slope), ah[2], al[2]);
          split_tier<M>(vk_leaky(xa[8 * XS + k8 + 4], c.slope), ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            unsigned bh0, bl0, bh1, bl1;
            split_tier<M>(wb[k8 * WS + nt * 8], bh0, bl0);
            split_tier<M>(wb[(k8 + 4) * WS + nt * 8], bh1, bl1);
            if constexpr (M != kFast) {
              mma_tf32(part[nt], al, bh0, bh1);
              mma_tf32(part[nt], ah, bl0, bl1);
            }
            mma_tf32(part[nt], ah, bh0, bh1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + m0 + g + 8 * h;
    if (t >= c.T) continue;
    const size_t row = ((size_t)c.os * t + oo) * c.C_out;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + nt * 8 + 2 * tq + e;
        if (co >= c.C_out) continue;
        float y = t < len ? acc[nt][2 * h + e] * wsc[nt][e] + bias[nt][e] + res[h][nt][e] : 0.f;
        if (c.round) y = bf16_round(y);
        y = (prev[h][nt][e] + y) * c.scale;
        if (c.out16)
          c.out16[(size_t)b * rows_out * c.C_out + row + co] = __float2bfloat16_rn(y);
        else
          ob[row + co] = y;
      }
  }
}

// The operands of conv_tile16 (bf16 serving).
struct Conv16 {
  const __nv_bfloat16* x;         // (B, T_x, C_in)
  __nv_bfloat16* out;             // (B, os * T, C_out); with accumulate also its running sum
  const __nv_bfloat16* w;         // (taps, C_in, C_out)
  const float* bias;              // (C_out,) fp32 holding bf16 values, or
  const __nv_bfloat16* bias16;    //   bf16
  const __nv_bfloat16* residual;  // like out, or null
  const int* lengths;             // (B,) valid rows t
  int T_x, T, C_in, C_out;
  int dil, wts, os;
  float slope;
  int accumulate;
  float divisor;
  int per_tap;
};

// conv_tile's rows, columns and taps for Conv16 (kFast arithmetic: both
// operands bf16, one tf32 MMA pass, fp32 sums).
template <int NT>
__device__ __forceinline__ void conv_tile16(const Conv16& c, float* smem, int b, int t0, int co0,
                                            int n, int pad, int wt0, int oo) {
  constexpr int cols = 8 * NT;
  const int Kp = k_pad(c.C_in), XS = x_stride(c.C_in), WS = w_stride(NT);
  const int win = kBM + (n - 1) * c.dil;
  float* ws = smem;                // n x Kp x WS
  float* xs = smem + n * Kp * WS;  // win x XS, row r <-> input row t0 - pad + r
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = c.lengths[b];
  const bool live = t0 < len;  // the same for every thread of the block
  if (live) {  // the weights and the x window, widened to fp32 by plain loads
    for (int idx = tid; idx < n * Kp * cols; idx += blockDim.x) {
      const int row = idx / cols, col = idx - row * cols;
      const int tap = row / Kp, ci = row - tap * Kp, co = co0 + col;
      ws[row * WS + col] =
          ci < c.C_in && co < c.C_out
              ? ldf(c.w + ((size_t)(wt0 + c.wts * tap) * c.C_in + ci) * c.C_out + co)
              : 0.f;
    }
    const __nv_bfloat16* xb = c.x + (size_t)b * c.T_x * c.C_in;
    for (int idx = tid; idx < win * Kp; idx += blockDim.x) {
      const int r = idx / Kp, ci = idx - r * Kp;
      const int p = t0 - pad + r;
      xs[r * XS + ci] =
          ci < c.C_in && p >= 0 && p < c.T_x ? ldf(xb + (size_t)p * c.C_in + ci) : 0.f;
    }
  }

  const int g = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int m0 = warp * 16;
  const size_t rows_out = (size_t)c.os * c.T;
  __nv_bfloat16* ob = c.out + (size_t)b * rows_out * c.C_out;
  const __nv_bfloat16* rb = c.residual ? c.residual + (size_t)b * rows_out * c.C_out : nullptr;
  // this lane's outputs: rows t0 + m0 + g (+8), columns co0 + nt*8 + 2*tq (+1)
  float bias[NT][2], res[2][NT][2], prev[2][NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + nt * 8 + 2 * tq + e;
      bias[nt][e] = co >= c.C_out ? 0.f : c.bias16 ? ldf(c.bias16 + co) : c.bias[co];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + m0 + g + 8 * h;
        const bool out_in = t < c.T && co < c.C_out;
        const size_t at = ((size_t)c.os * t + oo) * c.C_out + co;
        res[h][nt][e] = rb && out_in && t < len ? ldf(rb + at) : 0.f;
        prev[h][nt][e] = c.accumulate && out_in ? ldf(ob + at) : 0.f;
      }
    }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  if (live) {
    __syncthreads();  // the staged weights and window
    // per_tap: each tap's products alone, rounded, the taps added last to first
    // (acc = bf16(acc + bf16(tap))); else all taps into one fp32 sum
    for (int ii = 0; ii < n; ++ii) {
      const int i = c.per_tap ? n - 1 - ii : ii;
      const float* xa = xs + (m0 + i * c.dil + g) * XS + tq;
      const float* wb = ws + i * Kp * WS + tq * WS + g;
      float tap[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tap[nt][e] = 0.f;
      for (int kc = 0; kc < Kp; kc += 32) {
        const int kend = kc + 32 < Kp ? kc + 32 : Kp;
        float part[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
        for (int k8 = kc; k8 < kend; k8 += 8) {
          unsigned ah[4], al[4];  // leaky here: the window holds raw x
          split_tier<kFast>(vk_leaky(xa[k8], c.slope), ah[0], al[0]);
          split_tier<kFast>(vk_leaky(xa[8 * XS + k8], c.slope), ah[1], al[1]);
          split_tier<kFast>(vk_leaky(xa[k8 + 4], c.slope), ah[2], al[2]);
          split_tier<kFast>(vk_leaky(xa[8 * XS + k8 + 4], c.slope), ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            unsigned bh0, bl0, bh1, bl1;
            split_tier<kFast>(wb[k8 * WS + nt * 8], bh0, bl0);
            split_tier<kFast>(wb[(k8 + 4) * WS + nt * 8], bh1, bl1);
            mma_tf32(part[nt], ah, bh0, bh1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tap[nt][e] += part[nt][e];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!c.per_tap) {
            acc[nt][e] += tap[nt][e];
          } else {
            const float v = bf16_round(tap[nt][e]);
            acc[nt][e] = ii == 0 ? v : bf16_round(acc[nt][e] + v);
          }
        }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + m0 + g + 8 * h;
    if (t >= c.T) continue;
    const size_t row = ((size_t)c.os * t + oo) * c.C_out;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + nt * 8 + 2 * tq + e;
        if (co >= c.C_out) continue;
        float v = 0.f;  // XLA's bf16 graph of the step (conv::Bf16Epi)
        if (t < len) {
          v = bf16_round(bf16_round(acc[nt][2 * h + e]) + bias[nt][e]);
          if (rb) v = bf16_round(res[h][nt][e] + v);
        }
        if (c.accumulate) v = bf16_round(prev[h][nt][e] + v);
        if (c.divisor != 1.f) v = bf16_round(v / c.divisor);
        ob[row + co] = __float2bfloat16_rn(v);
      }
  }
}

// The n8 tiles a block needs for C_out (chunks of kCols).
inline int tiles_for(int C_out) {
  const int cols = C_out < kCols ? C_out : kCols;
  return cols <= 8 ? 1 : cols <= 16 ? 2 : cols <= 32 ? 4 : 8;
}

}  // namespace narrow
