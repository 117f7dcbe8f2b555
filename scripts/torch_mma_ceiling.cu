// The rate of mma.sync.m16n8k8 TF32 on this card: every warp runs CH
// independent accumulator chains of MMAs from registers (no memory traffic).
// The ceiling that kernel B's conv (vits_tpu_torch/csrc/resblock_trio.cu)
// works under; its fp32-accurate (3xTF32) rate is a third of the number.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_ceiling scripts/torch_mma_ceiling.cu
//   ./mma_ceiling          (or: python3 scripts/torch_conv_probe.py, which builds and runs it)
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CH>
__global__ void chains(float* out, int iters) {
  const unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float c[CH][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) mma_tf32(c[j], a, a[j & 3], a[(j + 1) & 3]);
  }
  float s = 0.f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH>
void run(int blocks, int threads) {
  float* out;
  cudaMalloc(&out, blocks * threads * sizeof(float));
  const int iters = 4096;
  chains<CH><<<blocks, threads>>>(out, 16);
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  cudaEventRecord(start);
  chains<CH><<<blocks, threads>>>(out, iters);
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, stop);
  const double flop = 2.0 * 16 * 8 * 8 * CH * static_cast<double>(iters) * blocks * (threads / 32);
  printf("mma.sync m16n8k8 TF32: %2d chains/warp, %3d blocks x %3d threads: %.1f TFLOP/s\n", CH,
         blocks, threads, flop / ms / 1e9);
  cudaFree(out);
}

int main() {
  run<8>(132, 128);
  run<8>(132, 256);
  run<8>(264, 256);
  run<16>(264, 256);
  run<16>(132, 512);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
