// Shared helpers for the hand-written Hopper kernels of vits_tpu_torch.
//
// Every exported function has a plain C interface (loaded with ctypes from
// vits_tpu_torch/ops/cuda/__init__.py), launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// The same copy, reading src_bytes (0 or 16) of gmem and zero-filling the rest.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
// 4-byte asynchronous copy (any alignment), reading src_bytes (0 or 4) of gmem.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The precision tiers of the products (vits_tpu_torch/ops/tiers.py, the JAX
// package's kernel precision: ops/pallas/__init__.py::resolve_precision and
// kernel_dot). kExact: fp32 products (3xTF32 on the tensor cores, fp32 FFMA
// elsewhere), the "highest" tier. kFast: both operands rounded to bf16, the
// products exact and summed in fp32, as one bf16 MXU pass ("fast", None).
// kHigh: bf16x3, each operand split hi = bf16(x), lo = bf16(x - hi), and
// hi*hi + hi*lo + lo*hi summed in fp32 ("high").
enum TierMode { kExact = 0, kFast = 1, kHigh = 2 };

// Weight formats of the vocoder packs: fp32, bf16, or int8 with one fp32 scale
// per out-channel applied to the sum (vits_tpu/models/hifigan.py:109-118).
enum WeightFormat { kW32 = 0, kW16 = 1, kW8 = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A stored value as a float, and a float stored, in fp32 or bf16 storage (the
// bf16 store rounds to nearest).
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A weight of any format as a float (bf16 and int8 values are exact in fp32).
__device__ __forceinline__ float wvalue(float w) { return w; }
__device__ __forceinline__ float wvalue(__nv_bfloat16 w) { return __bfloat162float(w); }
__device__ __forceinline__ float wvalue(signed char w) { return static_cast<float>(w); }

// c + a * b in a tier's arithmetic on the FFMA units (kernel A, conv_post).
template <int M>
__device__ __forceinline__ float fma_tier(float a, float b, float c) {
  if constexpr (M == kExact) {
    return fmaf(a, b, c);
  } else if constexpr (M == kFast) {
    return fmaf(bf16_round(a), bf16_round(b), c);
  } else {
    const float ah = bf16_round(a), bh = bf16_round(b);
    const float al = bf16_round(a - ah), bl = bf16_round(b - bh);
    return fmaf(al, bh, fmaf(ah, bl, fmaf(ah, bh, c)));
  }
}

// The dot of a row (staged fp32 or stored) with a stored table row over d, one
// thread, each product at the tier M (the attention kernels' window logits).
template <int M, class R, class T>
__device__ __forceinline__ float dot_rel(const R* row, const T* rel, int d) {
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) s = fma_tier<M>(ldf(row + c), ldf(rel + c), s);
  return s;
}

// Two floats as one register of two bf16 (x in the low half), rounded to nearest.
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&v);
}

// c += a * b on the tensor cores, one m16n8k16 bf16 product with fp32 sums.
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the lower k in
// the low half: a0..a3 = A[g][2t, 2t+1], A[g+8][2t, 2t+1], A[g][2t+8, 2t+9],
// A[g+8][2t+8, 2t+9]; b0, b1 = B[2t, 2t+1][g], B[2t+8, 2t+9][g]; c as mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32, the fp32 tier on the tensor cores: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in fp32); lo*hi + hi*lo + hi*hi summed in fp32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// One operand's split for a tier on the TF32 tensor cores (the narrow tile,
// kernel 7): kExact split_tf32's hi and lo; kFast hi = bf16(x), which tf32
// holds exactly, and lo = 0 (its passes are skipped); kHigh hi = bf16(x) and
// lo = bf16(x - hi). A tf32 MMA of bf16 values multiplies them exactly and
// sums in fp32: the bf16 MMA's arithmetic.
template <int M>
__device__ __forceinline__ void split_tier(float x, unsigned& hi, unsigned& lo) {
  if constexpr (M == kExact) {
    split_tf32(x, hi, lo);
  } else {
    const float h = bf16_round(x);
    hi = __float_as_uint(h);
    lo = M == kHigh ? __float_as_uint(bf16_round(x - h)) : 0u;
  }
}

// c += a * b on the tensor cores, one m16n8k8 TF32 product with fp32 sums.
// Fragments (g = lane / 4, t = lane % 4): a0..a3 = A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]; b0, b1 = B[t][g], B[t+4][g]; c0..c3 = C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of one m16n8k8 TF32 MMA in one instruction: ldmatrix's four
// 8x8 b16 matrices are four 8-row x 4-word blocks of tf32 (rows 0-7 / 8-15,
// words 0-3 / 4-7), and thread (g, t) of each gets word t of row g -- exactly
// a0..a3. Lane l passes the address of row l % 8 of block l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A wait on a hand-off (an mbarrier's phase, an exchange slot's tag) that has
// not ended after this many cycles (~2 s at the H100's clocks; a hand-off takes
// microseconds) never will: the thread traps, so a broken plan or layout fails
// its launch with a CUDA error instead of hanging the process.
constexpr long long kSpinCycles = 1ll << 32;

// mbarriers in shared memory (the kernels with TMA: align.cu, conv_wgmma.cuh).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kSpinCycles) __trap();
}
// An L2 prefetch of bytes (a multiple of 16) from a 16-byte aligned address.
__device__ __forceinline__ void prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// Raise a kernel's dynamic shared-memory ceiling when it asks for more than
// the 48 KB default; returns the CUDA status.
template <typename Kernel>
inline cudaError_t vk_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The same for a kernel launched many times a call: the ceiling is raised once
// per device and only when a launch needs more than it was raised to.
template <auto kKernel>
inline cudaError_t vk_set_smem_once(size_t bytes) {
  static int raised[64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && static_cast<int>(bytes) <= raised[dev]) return cudaSuccess;
  const cudaError_t err = vk_set_smem(kKernel, bytes);
  if (err == cudaSuccess && dev < 64) raised[dev] = static_cast<int>(bytes);
  return err;
}
