// HiFiGAN resblock convs: y = mask(conv(leaky(x)) + bias [+ residual]).
//
// Serves four TPU kernels, every pair of a resblock being two launches of
// conv_kernel below, driven by vits_tpu_torch/ops/cuda/resblock.py::run_pairs:
//   conv1: y1 = zero outside [0, len) of (dilated conv(leaky(x)) + b1)
//   conv2: y  = zero outside [0, len) of (x + conv(leaky(y1)) + b2)
// and the last pair of each resblock folds y into the running mean
// (accumulate/scale). Kernel B: vits_tpu/ops/pallas/resblock.py::
// fused_resblock_trio (_trio_kernel); kernel C's resblocks: ops/pallas/stage.py::
// fused_stage (with stage.cu); kernel 5's forward: ops/pallas/trio_grad.py::
// make_trainable_trio (lengths = T, y1 and x saved); kernel 7: resblock.py::
// fused_resblock.
//
// The conv is an implicit GEMM per batch row: M = output time steps, N =
// C_out, K = taps x C_in, walked as (C_in chunk of 32, tap) steps.
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
// - The caller's plan (ops/cuda/resblock.py::conv_plan) picks the block tile
//   and a split of the K steps, by a small cost model fitted on the card,
//   among the grids that hold at least two blocks per SM.
//   A split of s runs as a thread-block cluster of s blocks: each sums its
//   share of the steps, stages its partial tile in shared memory, and after a
//   cluster barrier each block reduces 1/s of the tile's rows over the
//   cluster's distributed shared memory and runs their epilogue (no
//   workspace, no second launch). Every block stages its tile, so the
//   epilogue reads and writes whole rows as float4.
// - A tile that starts at or past its row's length is all zeros after the
//   mask: it skips the products (data-dependent work: a padding row costs
//   only its epilogue).
//
// Narrow channels (C_in % 32 or C_out % 32, i.e. C = 1 .. 16 on the vocoder's
// narrow stages: kernel 7 and the C_out = 16, 8 tail of kernel C) take
// narrow_conv_kernel instead, narrow_gemm.cuh's tile: 64 time steps x up to 64
// out-channels per block, the (k, C_in, cols) weights and the raw x window
// staged once in shared memory by 16-byte cp.async, all in flight at once (K
// zero-padded to a multiple of 8), each warp one m16 tile against one to
// eight n8 tiles in 3xTF32. At C = 16 a conv is 2*k*256 FLOP per step, so
// bytes and the block's latency bound these launches: the input read once,
// the output (and residual, and with accumulate the running mean) once each.
// A tile at or past its row's length skips its loads and products and runs
// only the epilogue (zeros, or out * scale with accumulate).
#include <cooperative_groups.h>

#include "common.cuh"
#include "narrow_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kKc = 32;       // input channels per step: two pairs of k8 MMA slices
constexpr int kAs = kKc + 4;  // window row stride (floats): rows 4 banks apart
constexpr int kStages = 3;    // weight tiles in flight
constexpr int kMaxSplit = 8;  // portable cluster size

// A WM x WN grid of warps, each owning a (16*MT time steps) x (32 out-channels) tile.
template <int WM, int WN, int MT>
struct Tile {
  static constexpr int threads = 32 * WM * WN;
  static constexpr int wm = 16 * MT;          // warp tile rows
  static constexpr int bm = WM * wm;          // block tile rows (time steps)
  static constexpr int bn = WN * 32;          // block tile out-channels
  static constexpr int ws = bn + 8;           // weight row stride: B fragments conflict-free
  static constexpr int w_floats = kKc * ws;   // one weight stage
  static constexpr int os = bn + 8;           // staged output row stride
};

template <int WM, int WN, int MT>
__global__ void __launch_bounds__(32 * WM * WN)
    conv_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ residual, const int* __restrict__ lengths, int T,
                int C_in, int C_out, int k, int dil, int pad, float slope, int accumulate,
                float scale, int split, int nwin) {
  using G = Tile<WM, WN, MT>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                            // kStages weight tiles
  float* wins = smem + kStages * G::w_floats;  // nwin windows of win x kAs
  const int win = G::bm + (k - 1) * dil;
  float* wlo = wins + nwin * win * kAs;        // lo halves of the current window
  const int rank = blockIdx.x % split;         // the cluster rank: clusters are (split, 1, 1)
  const int t0 = blockIdx.x / split * G::bm;
  const int co0 = blockIdx.y * G::bn;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const float* xb = x + (size_t)b * T * C_in;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wm0 = warp % WM * G::wm, wn0 = warp / WM * 32;

  const int per = (C_in / kKc) * k / split;  // steps of this block
  const int s0 = rank * per;
  const int n = t0 < len ? per : 0;
  const int chunk0 = s0 / k;

  auto issue = [&](int i) {  // the copies of local step i
    const int s = s0 + i, chunk = s / k, tap = s - chunk * k;
    const float* src = w + ((size_t)tap * C_in + chunk * kKc) * C_out + co0;
    float* dst = ws + i % kStages * G::w_floats;
    for (int idx = tid; idx < kKc * G::bn / 4; idx += G::threads) {
      const int r = idx / (G::bn / 4), c4 = idx - r * (G::bn / 4);
      cp_async16(dst + r * G::ws + c4 * 4, src + (size_t)r * C_out + c4 * 4);
    }
    if (tap == 0 || i == 0) {  // the chunk's raw window: row r <-> position t0 - pad + r
      float* wdst = wins + (chunk - chunk0) % nwin * win * kAs;
      const float* xs = xb + chunk * kKc;
      for (int idx = tid; idx < win * (kKc / 4); idx += G::threads) {
        const int r = idx / (kKc / 4), c4 = idx - r * (kKc / 4);
        const int p = t0 - pad + r;
        const bool in = p >= 0 && p < T;
        cp_async16_zfill(wdst + r * kAs + c4 * 4, in ? xs + (size_t)p * C_in + c4 * 4 : xs,
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
    float* whi = wins + (chunk - chunk0) % nwin * win * kAs;
    if (tap == 0 || i == 0) {  // a new chunk: leaky, then hi (in place) and lo, once for k taps
      for (int idx = tid; idx < win * kKc; idx += G::threads) {
        const int r = idx / kKc, c = idx - r * kKc;
        unsigned hi, lo;
        split_tf32(vk_leaky(whi[r * kAs + c], slope), hi, lo);
        whi[r * kAs + c] = __uint_as_float(hi);
        wlo[r * kAs + c] = __uint_as_float(lo);
      }
      __syncthreads();
    }
    // this lane's ldmatrix row: row lane % 8 of block lane / 8 of the fragment
    const int a_off =
        (wm0 + tap * dil + (lane >> 3 & 1) * 8 + (lane & 7)) * kAs + (lane >> 4) * 4;
    const float* a_hi = whi + a_off;
    const float* a_lo = wlo + a_off;
    const float* b_s = ws + i % kStages * G::w_floats + t * G::ws + wn0 + g;
    // The tensor cores truncate each sum to the accumulator's precision, a bias
    // that grows with every MMA into one accumulator: the step's four k8
    // slices sum into a zeroed partial, each pair's four small products before
    // its two large ones, and the partial is added to acc in fp32 (round to
    // nearest).
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kKc; kp += 16) {  // a pair of k8 slices
      unsigned bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          split_tf32(b_s[(kp + 8 * h) * G::ws + nt * 8], bh[h][nt][0], bl[h][nt][0]);
          split_tf32(b_s[(kp + 8 * h + 4) * G::ws + nt * 8], bh[h][nt][1], bl[h][nt][1]);
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
      float* o = tile + (wm0 + mt * 16 + g) * G::os + wn0 + nt * 8 + 2 * t;
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
  float* ob = out + (size_t)b * T * C_out;
  const float* rb = residual ? residual + (size_t)b * T * C_out : nullptr;
  for (int idx = tid; idx < rows * (G::bn / 4); idx += G::threads) {
    const int r = r0 + idx / (G::bn / 4), c = idx % (G::bn / 4) * 4;
    const int p = t0 + r;
    if (p >= T) continue;
    float* at = tile + r * G::os + c;
    float4 y = *reinterpret_cast<const float4*>(at);
    for (int q = 1; q < split; ++q) {
      const float4 o =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(at, (rank + q) % split));
      y = make_float4(y.x + o.x, y.y + o.y, y.z + o.z, y.w + o.w);
    }
    const int co = co0 + c;
    const float4 bv = *reinterpret_cast<const float4*>(bias + co);
    y = make_float4(y.x + bv.x, y.y + bv.y, y.z + bv.z, y.w + bv.w);
    const size_t off = (size_t)p * C_out + co;
    if (p >= len) {
      y = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (rb) {
      const float4 r4 = *reinterpret_cast<const float4*>(rb + off);
      y = make_float4(r4.x + y.x, r4.y + y.y, r4.z + y.z, r4.w + y.w);
    }
    float4* o = reinterpret_cast<float4*>(ob + off);
    if (accumulate) {
      const float4 prev = *o;
      y = make_float4(prev.x + y.x, prev.y + y.y, prev.z + y.z, prev.w + y.w);
    }
    *o = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
  }
  if (split > 1) cluster.sync();  // the peers' shared memory outlives every remote read
}

template <int NT>
__global__ void __launch_bounds__(narrow::kWarps * 32) narrow_conv_kernel(const narrow::Conv c,
                                                                          int k, int pad) {
  extern __shared__ __align__(16) float smem[];
  narrow::conv_tile<NT>(c, smem, blockIdx.z, blockIdx.x * narrow::kBM,
                        blockIdx.y * narrow::kCols, k, pad, 0, 0);
}

template <int NT>
cudaError_t launch_narrow(const narrow::Conv& c, int B, int k, int pad, cudaStream_t stream) {
  const int smem = narrow::smem_floats(NT, k, c.dil, c.C_in) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(narrow_conv_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.T + narrow::kBM - 1) / narrow::kBM,
                  (c.C_out + narrow::kCols - 1) / narrow::kCols, B);
  narrow_conv_kernel<NT><<<grid, narrow::kWarps * 32, smem, stream>>>(c, k, pad);
  return cudaGetLastError();
}

cudaError_t launch_narrow_conv(const float* x, float* out, const float* w, const float* bias,
                               const float* residual, const int* lengths, int B, int T,
                               int C_in, int C_out, int k, int dil, int pad, float slope,
                               int accumulate, float scale, cudaStream_t stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const narrow::Conv c{x, out, w, bias, residual, lengths, T, T, C_in, C_out, dil, 1, 1,
                       slope, accumulate, scale, C_in % 4 == 0 && aligned(x),
                       C_out % 4 == 0 && aligned(w)};
  switch (narrow::tiles_for(C_out)) {
    case 1:
      return launch_narrow<1>(c, B, k, pad, stream);
    case 2:
      return launch_narrow<2>(c, B, k, pad, stream);
    case 4:
      return launch_narrow<4>(c, B, k, pad, stream);
    default:
      return launch_narrow<8>(c, B, k, pad, stream);
  }
}

template <int WM, int WN, int MT>
cudaError_t launch_conv(const float* x, float* out, const float* w, const float* bias,
                        const float* residual, const int* lengths, int B, int T, int C_in,
                        int C_out, int k, int dil, int pad, float slope, int accumulate,
                        float scale, int split, cudaStream_t stream) {
  using G = Tile<WM, WN, MT>;
  const int steps = (C_in / kKc) * k;
  if (C_out % G::bn || split < 1 || split > kMaxSplit || steps % split || G::bm % split)
    return cudaErrorInvalidValue;
  // window slots: a slot is refilled only after the kStages - 1 steps ahead of it are issued
  const int nwin = (kStages - 2) / k + 2;
  const int pipe = kStages * G::w_floats + (nwin + 1) * (G::bm + (k - 1) * dil) * kAs;
  const int smem = (pipe > G::bm * G::os ? pipe : G::bm * G::os) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(conv_kernel<WM, WN, MT>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + G::bm - 1) / G::bm * split, C_out / G::bn, B);
  cfg.blockDim = dim3(G::threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv_kernel<WM, WN, MT>, x, out, w, bias, residual, lengths, T,
                           C_in, C_out, k, dil, pad, slope, accumulate, scale, split, nwin);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

VK_EXPORT const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[b, p] = mask_p(conv(leaky(x))[p] + bias [+ residual[b, p]]) for p < T, where
// conv is torch's Conv1d with this dilation and left padding (right padding the
// same), mask_p zeroes p >= lengths[b], and with accumulate the result is added
// to out; the sum is then multiplied by scale. x (B, T, C_in), w (k, C_in,
// C_out) as the JAX loader lays it out, out/residual (B, T, C_out), all fp32
// and contiguous. tile and split come from ops/cuda/resblock.py::conv_plan:
// tile -1 is the direct path (any channel count); tiles 0-3 are the tensor-core
// path (C_in % 32 == 0, C_out a multiple of the tile's width, 16-byte aligned
// tensors), and split (1, 2, 4 or 8, dividing the k * C_in / 32 steps) is the
// cluster that shares the K steps of one output tile.
VK_EXPORT int vk_conv(const float* x, float* out, const float* w, const float* bias,
                      const float* residual, const int* lengths, int B, int T, int C_in,
                      int C_out, int k, int dil, int pad, float slope, int accumulate,
                      float scale, int tile, int split, void* stream) {
  if (C_in < 1 || C_out < 1 || k < 1 || dil < 1 || T < 1 || B < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 0) {
    return launch_narrow_conv(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k, dil,
                              pad, slope, accumulate, scale, s);
  }
  if (C_in % kKc || C_out % 32) return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 != 0; };
  if (misaligned(x) || misaligned(out) || misaligned(w) || misaligned(bias) ||
      misaligned(residual))
    return cudaErrorMisalignedAddress;
  switch (tile) {
    case 0:  // 128 x 64, warps 2 x 2 of 64 x 32
      return launch_conv<2, 2, 4>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k,
                                  dil, pad, slope, accumulate, scale, split, s);
    case 1:  // 64 x 64, warps 2 x 2 of 32 x 32
      return launch_conv<2, 2, 2>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k,
                                  dil, pad, slope, accumulate, scale, split, s);
    case 2:  // 128 x 32, warps 4 x 1 of 32 x 32
      return launch_conv<4, 1, 2>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k,
                                  dil, pad, slope, accumulate, scale, split, s);
    case 3:  // 64 x 32, warps 4 x 1 of 16 x 32
      return launch_conv<4, 1, 1>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k,
                                  dil, pad, slope, accumulate, scale, split, s);
    default:
      return cudaErrorInvalidValue;
  }
}
