// HiFiGAN resblock convs: y = mask(conv(leaky(x)) + bias [+ residual]).
//
// Serves four TPU kernels, every pair of a resblock being two launches of
// conv_gemm.cuh's conv_kernel, driven by vits_tpu_torch/ops/cuda/resblock.py::run_pairs:
//   conv1: y1 = zero outside [0, len) of (dilated conv(leaky(x)) + b1)
//   conv2: y  = zero outside [0, len) of (x + conv(leaky(y1)) + b2)
// and the last pair of each resblock folds y into the running mean
// (accumulate/scale). Kernel B: vits_tpu/ops/pallas/resblock.py::
// fused_resblock_trio (_trio_kernel); kernel C's resblocks: ops/pallas/stage.py::
// fused_stage (with stage.cu); kernel 5's forward: ops/pallas/trio_grad.py::
// make_trainable_trio (lengths = T, y1 and x saved); kernel 7: resblock.py::
// fused_resblock.
//
// The conv is conv_gemm.cuh's tensor-core implicit GEMM with the resblock
// epilogue (conv::ResEpi); its header says what bounds it and how it is built.
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
#include "common.cuh"
#include "conv_gemm.cuh"
#include "narrow_gemm.cuh"

namespace {

template <int NT, int M>
__global__ void __launch_bounds__(narrow::kWarps * 32) narrow_conv_kernel(const narrow::Conv c,
                                                                          int k, int pad) {
  extern __shared__ __align__(16) float smem[];
  narrow::conv_tile<NT, M>(c, smem, blockIdx.z, blockIdx.x * narrow::kBM,
                           blockIdx.y * narrow::kCols, k, pad, 0, 0);
}

template <int NT, int M>
cudaError_t launch_narrow(const narrow::Conv& c, int B, int k, int pad, cudaStream_t stream) {
  const int smem = narrow::smem_floats(NT, k, c.dil, c.C_in) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(narrow_conv_kernel<NT, M>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.T + narrow::kBM - 1) / narrow::kBM,
                  (c.C_out + narrow::kCols - 1) / narrow::kCols, B);
  narrow_conv_kernel<NT, M><<<grid, narrow::kWarps * 32, smem, stream>>>(c, k, pad);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_narrow_tiles(const narrow::Conv& c, int B, int k, int pad,
                                cudaStream_t stream) {
  switch (narrow::tiles_for(c.C_out)) {
    case 1:
      return launch_narrow<1, M>(c, B, k, pad, stream);
    case 2:
      return launch_narrow<2, M>(c, B, k, pad, stream);
    case 4:
      return launch_narrow<4, M>(c, B, k, pad, stream);
    default:
      return launch_narrow<8, M>(c, B, k, pad, stream);
  }
}

// The narrow conv of bf16 serving (narrow_gemm.cuh::conv_tile16).
template <int NT>
__global__ void __launch_bounds__(narrow::kWarps * 32)
    narrow_conv16_kernel(const narrow::Conv16 c, int k, int pad) {
  extern __shared__ __align__(16) float smem[];
  narrow::conv_tile16<NT>(c, smem, blockIdx.z, blockIdx.x * narrow::kBM,
                          blockIdx.y * narrow::kCols, k, pad, 0, 0);
}

template <int NT>
cudaError_t launch_narrow16(const narrow::Conv16& c, int B, int k, int pad, cudaStream_t stream) {
  const int smem = narrow::smem_floats(NT, k, c.dil, c.C_in) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(narrow_conv16_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c.T + narrow::kBM - 1) / narrow::kBM,
                  (c.C_out + narrow::kCols - 1) / narrow::kCols, B);
  narrow_conv16_kernel<NT><<<grid, narrow::kWarps * 32, smem, stream>>>(c, k, pad);
  return cudaGetLastError();
}

// The resblock conv at a tier (mode), its weights in one format (wfmt), for
// the tensor-core path: the (tier, format) pairs the engine runs. fp32
// weights at every tier, int8 at kExact (fp32 values over quantized weights)
// and kFast, bf16 at kFast.
cudaError_t launch_conv(int mode, int wfmt, int tile, const conv::Gemm& g,
                        const conv::ResEpi& epi, int B, cudaStream_t s) {
  using conv::launch_tile;
  if (wfmt == kW32) return conv::launch_tile_mode(mode, tile, g, epi, B, s);
  if (wfmt == kW8 && mode == kExact)
    return launch_tile<false, kExact, signed char>(tile, g, epi, B, s);
  if (wfmt == kW8 && mode == kFast) return launch_tile<false, kFast, signed char>(tile, g, epi, B, s);
  if (wfmt == kW16 && mode == kFast)
    return launch_tile<false, kFast, __nv_bfloat16>(tile, g, epi, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

VK_EXPORT const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[b, p] = mask_p(conv(leaky(x))[p] (* wscale) + bias [+ residual[b, p]]) for
// p < T, where conv is torch's Conv1d with this dilation and left padding (right
// padding the same), mask_p zeroes p >= lengths[b]; with round the value is
// rounded to bf16; with accumulate it is added to out; the sum is then
// multiplied by scale, into out, or with out16 (bf16, (B, T, C_out)) into out16.
// x (B, T, C_in), w (k, C_in, C_out) as the JAX loader lays it out in the
// format wfmt (WeightFormat: fp32, bf16, int8 with wscale (C_out,) fp32),
// out/residual (B, T, C_out) fp32 and contiguous; mode is the tier
// (TierMode). tile and split come from ops/cuda/resblock.py::conv_plan: tile
// -1 is the narrow path (any channel count); tiles 0-3 are the tensor-core
// path (C_in % 32 == 0, C_out a multiple of the tile's width, 16-byte aligned
// tensors), and split (1, 2, 4 or 8, dividing the k * C_in / 32 steps) is the
// cluster that shares the K steps of one output tile.
VK_EXPORT int vk_conv(const float* x, float* out, const void* w, const float* bias,
                      const float* residual, const int* lengths, int B, int T, int C_in,
                      int C_out, int k, int dil, int pad, float slope, int accumulate,
                      float scale, int tile, int split, int mode, int wfmt, const float* wscale,
                      int round, void* out16, void* stream) {
  if (C_in < 1 || C_out < 1 || k < 1 || dil < 1 || T < 1 || B < 1 || mode < kExact ||
      mode > kHigh || wfmt < kW32 || wfmt > kW8 || (wfmt == kW8) != (wscale != nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 0) {
    auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
    narrow::Conv c{x, out, w, bias, residual, lengths, T, T, C_in, C_out, dil, 1, 1,
                   slope, accumulate, scale, C_in % 4 == 0 && aligned(x),
                   C_out % 4 == 0 && aligned(w)};
    c.wfmt = wfmt;
    c.wscale = wscale;
    c.round = round;
    c.out16 = static_cast<__nv_bfloat16*>(out16);
    switch (mode) {
      case kExact:
        return launch_narrow_tiles<kExact>(c, B, k, pad, s);
      case kFast:
        return launch_narrow_tiles<kFast>(c, B, k, pad, s);
      default:
        return launch_narrow_tiles<kHigh>(c, B, k, pad, s);
    }
  }
  auto misaligned = [](const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 != 0; };
  if (misaligned(x) || misaligned(out) || misaligned(w) || misaligned(bias) ||
      misaligned(residual) || misaligned(wscale) || misaligned(out16))
    return cudaErrorMisalignedAddress;
  const conv::Gemm g{x, C_in, w, lengths, T, C_in, C_out, k, dil, pad, slope, split, 0};
  conv::ResEpi epi{out, bias, residual, nullptr, 1.f, T, C_out, accumulate, scale};
  epi.wscale = wscale;
  epi.round = round;
  epi.out16 = static_cast<__nv_bfloat16*>(out16);
  return launch_conv(mode, wfmt, tile, g, epi, B, s);
}

// XLA's bf16 graph of one resblock conv: kernel 5's forward at bf16
// (ops/cuda/trio_grad.py at the fast tier with bf16 values) and bf16 serving's
// kernels B and C (ops/tiers.py::BF16_COMPUTE_TIER). out = mask(conv(leaky(x))
// + bias (+ residual)) (+ out) / divisor, each step rounded to bf16 as XLA's
// bf16 graph rounds it (conv::Bf16Epi), mask zeroing t >= lengths[b], on B's
// conv at kFast (bf16 mma.sync, fp32 sums). x, w (k, C_in, C_out), residual and
// out bf16 (B, T, C) and contiguous; bias fp32 holding bf16 values, or bf16
// with bias16; tile and split from conv_plan: tile -1 is the narrow path
// (narrow_gemm.cuh::conv_tile16, any channel count), the others the
// tensor-core tiles.
VK_EXPORT int vk_conv_bf16(const void* x, void* out, const void* w, const void* bias,
                           const void* residual, const int* lengths, int B, int T, int C_in,
                           int C_out, int k, int dil, int pad, float slope, int accumulate,
                           float divisor, int tile, int split, int bias16, void* stream) {
  if (C_in < 1 || C_out < 1 || k < 1 || dil < 1 || T < 1 || B < 1 || divisor == 0.f)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b16 = bias16 ? static_cast<const __nv_bfloat16*>(bias) : nullptr;
  const auto* b32 = bias16 ? nullptr : static_cast<const float*>(bias);
  if (tile < 0) {
    const narrow::Conv16 c{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                           static_cast<const __nv_bfloat16*>(w), b32, b16,
                           static_cast<const __nv_bfloat16*>(residual), lengths, T, T, C_in,
                           C_out, dil, 1, 1, slope, accumulate, divisor, 0};
    switch (narrow::tiles_for(C_out)) {
      case 1:
        return launch_narrow16<1>(c, B, k, pad, s);
      case 2:
        return launch_narrow16<2>(c, B, k, pad, s);
      case 4:
        return launch_narrow16<4>(c, B, k, pad, s);
      default:
        return launch_narrow16<8>(c, B, k, pad, s);
    }
  }
  auto misaligned = [](const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 != 0; };
  if (misaligned(x) || misaligned(out) || misaligned(w) || misaligned(bias) ||
      misaligned(residual))
    return cudaErrorMisalignedAddress;
  const conv::Gemm g{x, C_in, w, lengths, T, C_in, C_out, k, dil, pad, slope, split, 0};
  conv::Bf16Epi epi{static_cast<__nv_bfloat16*>(out), b32,
                    static_cast<const __nv_bfloat16*>(residual), nullptr, 1.f, T, C_out,
                    accumulate, divisor};
  epi.bias16 = b16;
  return conv::launch_tile<false, kFast, __nv_bfloat16, conv::Bf16Epi, __nv_bfloat16>(
      tile, g, epi, B, s);
}
