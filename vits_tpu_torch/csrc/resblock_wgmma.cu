// The entry point of the resblock conv's Hopper route (conv_wgmma.cuh, whose note
// says what it computes and how), in a translation unit of its own beside
// resblock_trio.cu's mma.sync routes, so that the build's nvcc processes share
// the work.
#include "common.cuh"
#include "conv_wgmma.cuh"

// vk_conv at the kFast tier with bf16 weights on Hopper's route
// (conv_wgmma.cuh): x (B, T, C_in) fp32, w (k, C_in, C_out) bf16, out, residual,
// bias and out16 as vk_conv's, C_in and C_out multiples of 64, (k - 1) * dil <=
// 128; bn and nc (a built block shape: bn 64 or 128 out-channels with one
// consumer warpgroup of 64 rows, 128 or 256 with two), stages (2-8) and split (1,
// 2, 4 or 8, each block of a cluster with K steps) from
// ops/cuda/resblock.py::wgmma_plan.
VK_EXPORT int vk_conv_wgmma(const float* x, float* out, const void* w, const float* bias,
                            const float* residual, const int* lengths, int B, int T, int C_in,
                            int C_out, int k, int dil, int pad, float slope, int accumulate,
                            float scale, int bn, int nc, int stages, int split, int round,
                            void* out16, void* stream) {
  if (C_in < 1 || C_out < 1 || k < 1 || dil < 1 || T < 1 || B < 1) return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 != 0; };
  if (misaligned(x) || misaligned(out) || misaligned(w) || misaligned(bias) ||
      misaligned(residual) || misaligned(out16))
    return cudaErrorMisalignedAddress;
  const wg::Conv g{lengths, T, C_in, C_out, k, dil, pad, slope, split, stages};
  conv::ResEpi epi{out, bias, residual, nullptr, 1.f, T, C_out, accumulate, scale};
  epi.round = round;
  epi.out16 = static_cast<__nv_bfloat16*>(out16);
  return wg::launch_plan(bn, nc, x, static_cast<const __nv_bfloat16*>(w), g, epi, B,
                         static_cast<cudaStream_t>(stream));
}
