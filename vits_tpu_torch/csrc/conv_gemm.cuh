// The tensor-core conv of the port: an implicit GEMM per batch row, 3xTF32 on
// mma.sync, with the output's elementwise work in a pluggable epilogue.
//
// out[b, p] = epilogue(sum_tap sum_ci leaky(x[b, p + tap*dil - pad, ci]) * W[tap][ci][co])
//
// M = output time steps, N = C_out, K = taps x C_in, walked as (C_in chunk of
// 32, tap) steps. Users: kernel B's resblock convs, kernel C's resblocks and
// kernel 5's forward (resblock_trio.cu, ResEpi), kernel 5's input gradients
// (trio_grad.cu: the weights read flipped in time and transposed, ResEpi with
// leaky's derivative), and kernel 6's products (flow.cu, its own epilogues).
//
// What bounds it on an H100: operations. A trio does 2*k*C*C multiply-adds per
// conv per time step over 126 taps of C x C (42 GFLOP at C=256, T=2560; 85
// GFLOP at C=128, T=20480); bytes are minor (a pass reads its input once plus a
// halo and writes its output once: 10.5 MB at C=128, T=20480, ~3 us of HBM).
// The products run on the tensor cores as 3xTF32, the fp32-accurate twin of
// the JAX package's bf16x3 split: each operand x becomes hi = tf32(x) and
// lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi accumulate in fp32 (relative
// error ~2^-21 per product, lo*lo dropped). So the card's ceiling is 495/3 =
// 165 TFLOP/s, not the 67 of fp32 FFMA; mma.sync itself reaches about 280
// TFLOP/s of TF32 on this card (a loop of independent MMAs), 93 of fp32.
// The tensor cores' own sums truncate: summed straight into one accumulator
// over K = 11 x 128, that bias reached 7e-6 of the output's scale on the card.
// So each step's products sum into a zeroed partial, small products first,
// and the partial is added to the accumulator in fp32 (round to nearest):
// 2e-7 - 6e-7 of the scale against an fp64 reference, below cuDNN's fp32
// convolution (5e-7 - 2e-6) at the same shapes (scripts/torch_conv_probe.py).
//
// Design:
// - mma.sync.m16n8k8 TF32 with a 16*MT x 32 warp tile (MT m16 tiles, four n8
//   tiles). wgmma would need both TF32 operands K-major in shared memory (a
//   second, transposed weight layout, and the split staged through shared
//   memory for both operands) and is later work: mma.sync tops out at about
//   57% of wgmma's TF32 rate here.
// - A 3-stage cp.async ring of (32 x BN) weight tiles over the steps, and a
//   small ring of the chunk's raw x window ((BM + (k-1)*dil) x 32; zero rows
//   outside [0, T) come from zero-fill), loaded with the chunk's first tap.
//   When a chunk's window lands, the block applies leaky and splits it once,
//   hi in place and lo beside it, for all k taps and all warps that read it;
//   A fragments then come in one ldmatrix each. The weights are split in
//   registers right after their shared-memory load. Row strides (32 + 4 and
//   BN + 8 floats) make every fragment load conflict-free.
// - kTransW reads W[tap][ci][co] = w[k-1-tap][co][ci] straight from the
//   forward conv's weights (the input gradient's conv): each out-channel's 32
//   input channels of a step are contiguous in w, so the stage holds BN rows
//   of 32 + 4 floats and a B fragment reads along the row (conflict-free).
// - The caller's plan (ops/cuda/resblock.py::conv_plan) picks the block tile
//   and a split of the K steps, by a small cost model fitted on the card.
//   A split of s runs as a thread-block cluster of s blocks: each sums its
//   share of the steps (ceil(steps / s); the last share may be shorter),
//   stages its partial tile in shared memory, and after a cluster barrier each
//   block reduces 1/s of the tile's rows over the cluster's distributed shared
//   memory and runs their epilogue (no workspace, no second launch). Every
//   block stages its tile, so the epilogue gets whole rows as float4.
// - A tile that starts at or past its row's length skips the products
//   (data-dependent work: a padding row costs only its epilogue).
// - Channel counts off the 32-channel grid (the flow's 16-wide halves of a
//   narrow model) zero-fill the tail of the last K step and of the last column
//   tile in the loaders; the epilogue skips columns past C_out.
//
// Precision tiers (common.cuh TierMode, the kernel's kMode): kExact is the
// 3xTF32 above. The resblock convs of B and C at kFast on bf16 weights and fp32
// x run on Hopper's route instead (conv_wgmma.cuh: TMA, an mbarrier ring,
// wgmma) wherever C_in and C_out are multiples of 64; here stay kHigh, kFast
// with int8 or fp32 weights, bf16 x (XT), kTransW, kernel 6's products and C's
// 32 channels. kFast and kHigh (the serving tiers "fast" and "high") run
// mma.sync.m16n8k16 bf16 with fp32 accumulators: when a chunk's window lands
// the block applies leaky and rounds it to bf16 once (kHigh: and the rest,
// bf16(x - hi)), into bf16 windows of 32 + 8 values a row (conflict-free
// ldmatrix), and the weights are rounded (split) in registers as they become
// B fragments. kFast is one pass a k16 slice; kHigh three, small first. The
// window and the weights are staged as they come (fp32 x; fp32, bf16 or int8
// weights, the WT of the launch: an int8 tile is 1 byte an entry in shared
// memory, and becomes bf16 exactly, |q| <= 127, in registers). Each step's
// products still sum into a zeroed partial.
//
// bf16 storage (XT, kernel 5 at bf16): x may be a bf16 tensor at the kFast
// tier; its raw window is then staged as bf16 (rows of 32 + 8 values) and
// widened when leaky runs. With kTransW the bf16 weights are read as the fp32
// ones are, 8 a copy.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace conv {

namespace cg = cooperative_groups;

constexpr int kKc = 32;       // input channels per step: two pairs of k8 MMA slices
constexpr int kAs = kKc + 4;  // window row stride (floats): rows 4 banks apart
constexpr int kStages = 3;    // weight tiles in flight
constexpr int kMaxSplit = 8;  // portable cluster size

constexpr int kAh = kKc + 8;  // bf16 window row stride (values): rows 20 words apart

// A WM x WN grid of warps, each owning a (16*MT time steps) x (32 out-channels) tile.
template <int WM, int WN, int MT, bool kTransW, class WT = float>
struct Tile {
  static constexpr int threads = 32 * WM * WN;
  static constexpr int wm = 16 * MT;  // warp tile rows
  static constexpr int bm = WM * wm;  // block tile rows (time steps)
  static constexpr int bn = WN * 32;  // block tile out-channels
  // weight stage: kKc rows of bn (+ pad) WT values, the rows 16-byte multiples
  // (pad 8 floats, 8 bf16, 16 int8), or with kTransW bn rows of kKc (+ 4 fp32, + 8 bf16)
  static constexpr int ws =
      kTransW ? kKc + (sizeof(WT) == 2 ? 8 : 4) : bn + (sizeof(WT) == 1 ? 16 : 8);
  static constexpr int w_floats = (kTransW ? bn * ws : kKc * ws) * (int)sizeof(WT) / 4;
  static constexpr int os = bn + 8;  // staged output row stride
};

// One conv: x (B, T, ldx) rows whose first C_in channels are the input; w
// (k, C_in, C_out), or with kTransW the forward weights (k, C_out, C_in) read
// flipped in time and transposed. slope 1 makes leaky the identity.
struct Gemm {
  const void* x;  // XT values
  int ldx;
  const void* w;  // WT values
  const int* lengths;
  int T, C_in, C_out, k, dil, pad;
  float slope;
  int split, nwin;
};

// The resblock epilogue: y (times the int8 weights' per-out-channel wscale)
// (+ bias), zero at p >= len; else times leaky'(aux) (1 at aux >= 0,
// aux_slope below) when aux is set, plus residual when set; rounded to bf16
// with round (the bf16 value carry of a pair's output); with accumulate added
// to out; then times scale, into out or, with out16, as bf16 into out16 (out
// then only gives accumulate's running sum). All (B, T, C), fp32 unless said.
struct ResEpi {
  float* out;
  const float* bias;
  const float* residual;
  const float* aux;
  float aux_slope;
  int T, C, accumulate;
  float scale;
  const float* wscale = nullptr;
  int round = 0;
  __nv_bfloat16* out16 = nullptr;

  // What the epilogue of one float4 reads from device memory besides y: the
  // residual and the running sum (fetch), so that a caller can have many in flight
  // before it computes (finish); operator() is the two in turn.
  struct In {
    float4 res, prev;
  };
  __device__ __forceinline__ In fetch(int b, int p, int co, bool valid) const {
    const size_t off = ((size_t)b * T + p) * C + co;
    In in{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    if (valid && residual) in.res = *reinterpret_cast<const float4*>(residual + off);
    if (accumulate) in.prev = *reinterpret_cast<const float4*>(out + off);
    return in;
  }
  __device__ __forceinline__ void operator()(int b, int p, int co, float4 y, bool valid) const {
    finish(b, p, co, y, valid, fetch(b, p, co, valid));
  }
  __device__ __forceinline__ void finish(int b, int p, int co, float4 y, bool valid,
                                         const In& in) const {
    const size_t off = ((size_t)b * T + p) * C + co;
    if (wscale) {
      const float4 sv = *reinterpret_cast<const float4*>(wscale + co);
      y = make_float4(y.x * sv.x, y.y * sv.y, y.z * sv.z, y.w * sv.w);
    }
    if (bias) {
      const float4 bv = *reinterpret_cast<const float4*>(bias + co);
      y = make_float4(y.x + bv.x, y.y + bv.y, y.z + bv.z, y.w + bv.w);
    }
    if (!valid) {
      y = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (aux) {
        const float4 a = *reinterpret_cast<const float4*>(aux + off);
        y = make_float4(a.x >= 0.f ? y.x : y.x * aux_slope, a.y >= 0.f ? y.y : y.y * aux_slope,
                        a.z >= 0.f ? y.z : y.z * aux_slope, a.w >= 0.f ? y.w : y.w * aux_slope);
      }
      if (residual) {
        const float4 r4 = in.res;
        y = make_float4(r4.x + y.x, r4.y + y.y, r4.z + y.z, r4.w + y.w);
      }
    }
    if (round) y = make_float4(bf16_round(y.x), bf16_round(y.y), bf16_round(y.z), bf16_round(y.w));
    float4* o = reinterpret_cast<float4*>(out + off);
    if (accumulate) {
      const float4 prev = in.prev;
      y = make_float4(prev.x + y.x, prev.y + y.y, prev.z + y.z, prev.w + y.w);
    }
    y = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
    if (out16) {
      __nv_bfloat162* o16 = reinterpret_cast<__nv_bfloat162*>(out16 + off);
      o16[0] = __floats2bfloat162_rn(y.x, y.y);
      o16[1] = __floats2bfloat162_rn(y.z, y.w);
    } else {
      *o = y;
    }
  }
};

// The bf16 epilogue of kernel 5 (trio_grad.py at bf16): the steps of XLA's bf16
// graph of the plain resblocks (vits_tpu/models/hifigan.py:29-57, 425-434), which
// JAX's bf16 training runs, each rounded to bf16 where XLA rounds it: the conv's
// sum; + bias; times leaky'(aux) (1 at aux >= 0, else a rounded product with
// aux_slope); + residual; + out's running sum (accumulate); / divisor. out,
// residual and aux are bf16 (B, T, C); bias fp32 holding bf16 values, or bf16
// (bias16: bf16 serving, whose parameters are bf16). The same epilogue serves
// bf16 serving's kernel B and kernel C's resblocks (the masked graph: rows at
// and past the length are zero after each conv, before the running sum).
struct Bf16Epi {
  __nv_bfloat16* out;
  const float* bias;
  const __nv_bfloat16* residual;
  const __nv_bfloat16* aux;
  float aux_slope;
  int T, C, accumulate;
  float divisor;
  const __nv_bfloat16* bias16 = nullptr;

  __device__ __forceinline__ void operator()(int b, int p, int co, float4 y, bool valid) const {
    const size_t off = ((size_t)b * T + p) * C + co;
    float v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = valid ? bf16_round(v[e]) : 0.f;
      if (valid && bias) x = bf16_round(x + bias[co + e]);
      if (valid && bias16) x = bf16_round(x + ldf(bias16 + co + e));
      if (valid && aux && ldf(aux + off + e) < 0.f) x = bf16_round(x * aux_slope);
      if (valid && residual) x = bf16_round(ldf(residual + off + e) + x);
      if (accumulate) x = bf16_round(ldf(out + off + e) + x);
      if (divisor != 1.f) x = bf16_round(x / divisor);
      v[e] = x;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + off);
    o[0] = __floats2bfloat162_rn(v[0], v[1]);
    o[1] = __floats2bfloat162_rn(v[2], v[3]);
  }
};

template <int WM, int WN, int MT, bool kTransW, int kMode, class WT, class Epi, class XT = float>
__global__ void __launch_bounds__(32 * WM * WN) conv_kernel(const Gemm g, const Epi epi) {
  using G = Tile<WM, WN, MT, kTransW, WT>;
  static_assert(!kTransW || sizeof(WT) != 1, "kTransW reads fp32 or bf16 weights");
  static_assert(!kTransW || kMode != kExact || sizeof(WT) == 4, "3xTF32 reads fp32 weights");
  constexpr bool kBf16 = kMode != kExact;
  constexpr bool kX16 = sizeof(XT) == 2;  // bf16 storage of x
  static_assert(!kX16 || kMode == kFast, "bf16 x is read at the kFast tier");
  constexpr int kXs = kX16 ? kAh : kAs;   // raw window row stride, XT values
  extern __shared__ __align__(16) float smem[];
  const int k = g.k, dil = g.dil, T = g.T, C_in = g.C_in, C_out = g.C_out, split = g.split;
  const int nwin = g.nwin;
  WT* ws = reinterpret_cast<WT*>(smem);        // kStages weight tiles
  XT* wins = reinterpret_cast<XT*>(smem + kStages * G::w_floats);  // nwin windows of win x kXs
  const int win = G::bm + (k - 1) * dil;
  float* wlo = reinterpret_cast<float*>(wins + nwin * win * kXs);  // kExact: lo halves
  // bf16 tiers: the current window's leaky values rounded to bf16 (kHigh: and the rest)
  __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(wlo);
  __nv_bfloat16* a16lo = a16 + win * kAh;
  const int rank = blockIdx.x % split;         // the cluster rank: clusters are (split, 1, 1)
  const int t0 = blockIdx.x / split * G::bm;
  const int co0 = blockIdx.y * G::bn;
  const int b = blockIdx.z;
  const int len = g.lengths[b];
  const XT* xb = static_cast<const XT*>(g.x) + (size_t)b * T * g.ldx;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wm0 = warp % WM * G::wm, wn0 = warp / WM * 32;

  const int steps = (C_in + kKc - 1) / kKc * k;
  const int per = (steps + split - 1) / split;  // steps of each block but the last
  const int s0 = rank * per;
  const int mine = steps - s0 < per ? steps - s0 : per;
  const int n = t0 < len && mine > 0 ? mine : 0;
  const int chunk0 = s0 / k;

  auto issue = [&](int i) {  // the copies of local step i
    const int s = s0 + i, chunk = s / k, tap = s - chunk * k;
    WT* dst = ws + i % kStages * (G::w_floats * 4 / (int)sizeof(WT));
    if constexpr (kTransW) {  // row c: out-channel co0 + c's 32 input channels of this chunk
      constexpr int V = 16 / sizeof(WT);
      const WT* src = static_cast<const WT*>(g.w) +
                      ((size_t)(k - 1 - tap) * C_out + co0) * C_in + chunk * kKc;
      for (int idx = tid; idx < G::bn * (kKc / V); idx += G::threads) {
        const int c = idx / (kKc / V), rv = idx - c * (kKc / V);
        cp_async16(dst + c * G::ws + rv * V, src + (size_t)c * C_in + rv * V);
      }
    } else {
      constexpr int V = 16 / sizeof(WT);  // values a 16-byte copy carries
      const WT* src = static_cast<const WT*>(g.w) + ((size_t)tap * C_in + chunk * kKc) * C_out + co0;
      for (int idx = tid; idx < kKc * G::bn / V; idx += G::threads) {
        const int r = idx / (G::bn / V), cv = idx - r * (G::bn / V);
        // zero rows past C_in and columns past C_out (a K or N tail)
        const bool in = chunk * kKc + r < C_in && co0 + cv * V < C_out;
        cp_async16_zfill(dst + r * G::ws + cv * V, in ? src + (size_t)r * C_out + cv * V : g.w,
                         in ? 16 : 0);
      }
    }
    if (tap == 0 || i == 0) {  // the chunk's raw window: row r <-> position t0 - pad + r
      constexpr int V = 16 / sizeof(XT);  // values a 16-byte copy carries
      XT* wdst = wins + (chunk - chunk0) % nwin * win * kXs;
      const XT* xs = xb + chunk * kKc;
      for (int idx = tid; idx < win * (kKc / V); idx += G::threads) {
        const int r = idx / (kKc / V), cv = idx - r * (kKc / V);
        const int p = t0 - g.pad + r;
        const bool in = p >= 0 && p < T && chunk * kKc + cv * V < C_in;
        cp_async16_zfill(wdst + r * kXs + cv * V, in ? xs + (size_t)p * g.ldx + cv * V : xs,
                         in ? 16 : 0);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step i landed for every thread; step i - 1's buffers are free
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    const int s = s0 + i, chunk = s / k, tap = s - chunk * k;
    XT* whi = wins + (chunk - chunk0) % nwin * win * kXs;
    if (tap == 0 || i == 0) {  // a new chunk: leaky, then the tier's split, once for k taps
      for (int idx = tid; idx < win * kKc; idx += G::threads) {
        const int r = idx / kKc, c = idx - r * kKc;
        const float v = vk_leaky(ldf(whi + r * kXs + c), g.slope);
        if constexpr (kBf16) {
          const __nv_bfloat16 h = __float2bfloat16_rn(v);
          a16[r * kAh + c] = h;
          if constexpr (kMode == kHigh) a16lo[r * kAh + c] = __float2bfloat16_rn(v - __bfloat162float(h));
        } else {  // hi in place, lo beside it
          unsigned hi, lo;
          split_tf32(v, hi, lo);
          whi[r * kAs + c] = __uint_as_float(hi);
          wlo[r * kAs + c] = __uint_as_float(lo);
        }
      }
      __syncthreads();
    }
    const WT* wst = ws + i % kStages * (G::w_floats * 4 / (int)sizeof(WT));
    // B[kk][n] of the warp's n8 tile nt, for this lane's n = gr, as a float
    auto bw = [&](int kk, int nt) {
      if constexpr (kTransW)
        return wvalue(wst[(wn0 + nt * 8 + gr) * G::ws + kk + t]);
      else
        return wvalue(wst[(kk + t) * G::ws + wn0 + nt * 8 + gr]);
    };
    // The tensor cores truncate each sum to the accumulator's precision, a bias
    // that grows with every MMA into one accumulator: the step's products sum
    // into a zeroed partial, small products first, and the partial is added to
    // acc in fp32 (round to nearest).
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    if constexpr (kBf16) {
      // this lane's ldmatrix row: row lane % 8 of block lane / 8 (rows 0-7 / 8-15, k 0-7 / 8-15)
      const int a_off = (wm0 + tap * dil + (lane >> 3 & 1) * 8 + (lane & 7)) * kAh + (lane >> 4) * 8;
#pragma unroll
      for (int kp = 0; kp < kKc; kp += 16) {  // one k16 slice
        unsigned bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // b0: rows kp + 2t, + 1; b1: rows kp + 8 + 2t, + 1
            float w0, w1;
            if constexpr (kTransW) {  // k runs along the stage's row
              const WT* wp = wst + (wn0 + nt * 8 + gr) * G::ws + kp + 8 * h + 2 * t;
              w0 = wvalue(wp[0]);
              w1 = wvalue(wp[1]);
            } else {
              const WT* wp = wst + (kp + 8 * h + 2 * t) * G::ws + wn0 + nt * 8 + gr;
              w0 = wvalue(wp[0]);
              w1 = wvalue(wp[G::ws]);
            }
            const float h0 = bf16_round(w0), h1 = bf16_round(w1);
            bh[nt][h] = pack_bf16(h0, h1);
            if constexpr (kMode == kHigh) bl[nt][h] = pack_bf16(w0 - h0, w1 - h1);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned ahi[4];
          ldmatrix_x4(ahi, a16 + a_off + mt * 16 * kAh + kp);
          if constexpr (kMode == kHigh) {
            unsigned alo[4];
            ldmatrix_x4(alo, a16lo + a_off + mt * 16 * kAh + kp);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], alo, bh[nt][0], bh[nt][1]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], ahi, bl[nt][0], bl[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], ahi, bh[nt][0], bh[nt][1]);
        }
      }
    } else {
      // this lane's ldmatrix row: row lane % 8 of block lane / 8 of the fragment
      const int a_off =
          (wm0 + tap * dil + (lane >> 3 & 1) * 8 + (lane & 7)) * kAs + (lane >> 4) * 4;
      const float* a_hi = whi + a_off;
      const float* a_lo = wlo + a_off;
#pragma unroll
      for (int kp = 0; kp < kKc; kp += 16) {  // a pair of k8 slices
        unsigned bh[2][4][2], bl[2][4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            split_tf32(bw(kp + 8 * h, nt), bh[h][nt][0], bl[h][nt][0]);
            split_tf32(bw(kp + 8 * h + 4, nt), bh[h][nt][1], bl[h][nt][1]);
          }
        // one pass: 4 * MT independent MMAs of slice h, A (hi or lo) from shared memory
        auto pass = [&](const float* a_s, int h, const unsigned (&bb)[2][4][2]) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned a[4];
            ldmatrix_x4(a, a_s + mt * 16 * kAs + kp + 8 * h);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], a, bb[h][nt][0], bb[h][nt][1]);
          }
        };
        pass(a_lo, 0, bh);
        pass(a_hi, 0, bl);
        pass(a_lo, 1, bh);
        pass(a_hi, 1, bl);
        pass(a_hi, 0, bh);
        pass(a_hi, 1, bh);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is consumed: its memory takes the staged tile

  float* tile = smem;  // bm x os partial sums of this block
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* o = tile + (wm0 + mt * 16 + gr) * G::os + wn0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * G::os) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();  // every block's partial tile is staged
  else
    __syncthreads();

  // Rows [r0, r0 + rows) of the tile: sum the cluster's partials, then the epilogue.
  const int rows = G::bm / split, r0 = rank * rows;
  for (int idx = tid; idx < rows * (G::bn / 4); idx += G::threads) {
    const int r = r0 + idx / (G::bn / 4), c = idx % (G::bn / 4) * 4;
    const int p = t0 + r;
    if (p >= T || co0 + c >= C_out) continue;
    float* at = tile + r * G::os + c;
    float4 y = *reinterpret_cast<const float4*>(at);
    for (int q = 1; q < split; ++q) {
      const float4 o =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(at, (rank + q) % split));
      y = make_float4(y.x + o.x, y.y + o.y, y.z + o.z, y.w + o.w);
    }
    epi(b, p, co0 + c, y, p < len);
  }
  if (split > 1) cluster.sync();  // the peers' shared memory outlives every remote read
}

template <int WM, int WN, int MT, bool kTransW, int kMode, class WT, class XT, class Epi>
cudaError_t launch(Gemm g, const Epi& epi, int B, cudaStream_t stream) {
  using G = Tile<WM, WN, MT, kTransW, WT>;
  const int steps = (g.C_in + kKc - 1) / kKc * g.k;
  const int per = g.split > 0 ? (steps + g.split - 1) / g.split : 0;
  if ((kTransW && g.C_out % G::bn) || g.split < 1 || g.split > kMaxSplit || G::bm % g.split ||
      (g.split - 1) * per >= steps)  // every block of a cluster has steps
    return cudaErrorInvalidValue;
  // window slots: a slot is refilled only after the kStages - 1 steps ahead of it are issued
  g.nwin = (kStages - 2) / g.k + 2;
  const int win = G::bm + (g.k - 1) * g.dil;
  // beside the raw windows: kExact the lo window (fp32), the bf16 tiers the
  // rounded window (kHigh: two), each win x kAh bf16
  const int split_floats = kMode == kExact ? win * kAs : (kMode == kHigh ? 2 : 1) * win * kAh / 2;
  const int raw_floats = sizeof(XT) == 2 ? win * kAh / 2 : win * kAs;  // one raw window
  const int pipe = kStages * G::w_floats + g.nwin * raw_floats + split_floats;
  const int smem = (pipe > G::bm * G::os ? pipe : G::bm * G::os) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem_once<conv_kernel<WM, WN, MT, kTransW, kMode, WT, Epi, XT>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.T + G::bm - 1) / G::bm * g.split, (g.C_out + G::bn - 1) / G::bn, B);
  cfg.blockDim = dim3(G::threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv_kernel<WM, WN, MT, kTransW, kMode, WT, Epi, XT>, g, epi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The block tile by the id of ops/cuda/resblock.py::CONV_TILES. Needs C_in and
// C_out multiples of 4 (a tail of a 32-channel step or of the tile's width is
// zero-filled; with kTransW, C_in % 32 == 0 and C_out a multiple of the
// tile's width), C_out a multiple of 8 for bf16 weights and of 16 for int8
// (whole 16-byte copies), and 16-byte aligned rows; bf16 x (XT) C_in and ldx
// multiples of 8.
template <bool kTransW, int kMode, class WT, class Epi, class XT = float>
cudaError_t launch_tile(int tile, const Gemm& g, const Epi& epi, int B, cudaStream_t stream) {
  const int xv = 16 / static_cast<int>(sizeof(XT));
  if (g.C_in % xv || g.C_out % 4 || g.ldx % xv || (kTransW && g.C_in % kKc) ||
      (!kTransW && g.C_out % (16 / static_cast<int>(sizeof(WT)))))
    return cudaErrorInvalidValue;
  switch (tile) {
    case 0:  // 128 x 64, warps 2 x 2 of 64 x 32
      return launch<2, 2, 4, kTransW, kMode, WT, XT>(g, epi, B, stream);
    case 1:  // 64 x 64, warps 2 x 2 of 32 x 32
      return launch<2, 2, 2, kTransW, kMode, WT, XT>(g, epi, B, stream);
    case 2:  // 128 x 32, warps 4 x 1 of 32 x 32
      return launch<4, 1, 2, kTransW, kMode, WT, XT>(g, epi, B, stream);
    case 3:  // 64 x 32, warps 4 x 1 of 16 x 32
      return launch<4, 1, 1, kTransW, kMode, WT, XT>(g, epi, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// launch_tile at a tier given at run time (TierMode), fp32 weights.
template <class Epi>
cudaError_t launch_tile_mode(int mode, int tile, const Gemm& g, const Epi& epi, int B,
                             cudaStream_t stream) {
  switch (mode) {
    case kExact:
      return launch_tile<false, kExact, float>(tile, g, epi, B, stream);
    case kFast:
      return launch_tile<false, kFast, float>(tile, g, epi, B, stream);
    case kHigh:
      return launch_tile<false, kHigh, float>(tile, g, epi, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace conv
