// Shared helpers for the hand-written Hopper kernels of vits_tpu_torch.
//
// Every exported function has a plain C interface (loaded with ctypes from
// vits_tpu_torch/ops/cuda/__init__.py), launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_runtime.h>

#define VK_EXPORT extern "C" __attribute__((visibility("default")))

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float vk_leaky(float x, float slope) {
  return x >= 0.f ? x : x * slope;
}

// floor(a / b) for b > 0 and any sign of a.
__host__ __device__ __forceinline__ int vk_floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// 16-byte asynchronous copy global -> shared (sm_80+), and its group fences.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Number of SMs of the current device (read once).
inline int vk_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Raise a kernel's dynamic shared-memory ceiling when it asks for more than
// the 48 KB default; returns the CUDA status.
template <typename Kernel>
inline cudaError_t vk_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
