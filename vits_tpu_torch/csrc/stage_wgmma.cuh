// Kernel C's own launches at the `fast` tier on bf16 packs, designed for Hopper:
// the upsampler (upsample_wgmma.cu) and the 32-channel resblock pairs
// (pair_wgmma.cu). Both replace launches of vits_tpu/ops/pallas/stage.py:379
// fused_stage that PR 20's conv (conv_wgmma.cuh) left on the pre-Hopper routes:
// the tf32 mma.sync upsampler of stage.cu (narrow_gemm.cuh::conv_tile) and the
// two mma.sync launches a pair of conv_gemm.cuh at C = 32.
//
// What bounds them on an H100: bytes. The upsampler of MMS's 128->64 stage for
// 320 frames does 1.3 GFLOP (1.4 us at 989 TFLOP/s) against 16 MB of activations
// (4.7 us at 3.35 TB/s); a 32-channel pair 2 * k * 32 * 32 multiply-adds a step
// (at most 3.7 GFLOP a trio, 3.7 us) against its input, y1, residual and output,
// 10.5 MB apiece in fp32 at T = 81920. So the design moves fewer bytes: the
// upsampler reads the bf16 chained input as it is (no fp32 cast launch), the
// pair keeps y1 on chip and takes its residual from the window it already
// holds, and every activation between pairs is bf16 storage (the fast tier
// rounds each pair's output to bf16, so nothing is lost).
//
// The pieces both kernels share, here:
// - wgmma m64nNk16 (N = 16, 32, 64) with A from registers (mma.sync's m16n8k16
//   A fragment, one ldmatrix.x4 a warp) and B, the weights, from shared memory
//   as an MN-major operand: rows of K (input channels) of N bf16 (N * 2 bytes),
//   landed by TMA with the swizzle whose span is that row (32, 64 or 128
//   bytes). The descriptor's SBO is 8 rows of K (8 * N * 2 bytes); one swizzle
//   atom spans the whole N, so LBO is not read. N = 8 (16-byte rows, no
//   swizzle: the interleaved layout) is not built: HiFi-GAN V2's 16->8
//   upsampler keeps stage.cu's route.
// - A windows of bf16 activations landed by TMA with the swizzle of their
//   row (KC = min(C, 64) channels a row, 32 / 64 / 128 bytes), so that the
//   ldmatrix of 8 rows x 16 bytes hits 8 distinct bank groups; leaky and the
//   bf16 rounding of the A operand run in place (elementwise, blind to the
//   layout), and ldmatrix addresses go through swz().
#pragma once

#include "conv_wgmma.cuh"

namespace wgn {

__host__ __device__ constexpr int round1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// Byte offset `off` of a row-major region whose rows are `span` bytes (32, 64, 128),
// as TMA's swizzle of that span placed it (the region 1024-byte aligned): the
// 16-byte chunk index XORed with the row bits above it (Swizzle<log2(span/16), 4, 3>).
__device__ __forceinline__ int swz(int off, int span) {
  return off ^ ((off >> 3) & (span - 16));
}

// wgmma's descriptor of an MN-major B tile of N columns (N * 2 bytes a row of K,
// landed with the swizzle of that span): start address, LBO (unread: one swizzle
// atom spans N), SBO = 8 rows of K, layout 1 (128 B), 2 (64 B) or 3 (32 B).
template <int N>
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  static_assert(N == 16 || N == 32 || N == 64, "B tiles of 16, 32 or 64 columns");
  constexpr uint64_t layout = N == 64 ? 1 : N == 32 ? 2 : 3;
  constexpr uint64_t sbo = 8 * N * 2;
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

// d += A * B: one wgmma.m64nNk16 (bf16 in, fp32 sums), A (this warp's 16 rows x
// 16 of K) from registers, B (16 x N, MN-major) by descriptor. d[4q + e]: rows g,
// g, g + 8, g + 8 and columns 8q + 2t, + 1 of the warp's 16 rows (g = lane / 4,
// t = lane % 4).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const unsigned (&a)[4],
                                             uint64_t desc) {
    wg::wgmma_n64(d, a, desc);
  }
};

// One K step of a chain of wgmmas on one accumulator: the step's A fragment is
// already in `a`; the step's products stay in flight while the next step's
// fragment loads into the other register set (the caller alternates two), and
// wait_group 1 makes sure the step before this one is done with its registers.
template <int N>
__device__ __forceinline__ void wgmma_step(float (&acc)[N / 2], const unsigned (&a)[4],
                                           uint64_t desc) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) wg::fence_acc(acc[e]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  Wgmma<N>::run(acc, a, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_drain(float (&acc)[N / 2]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int e = 0; e < N / 2; ++e) wg::fence_acc(acc[e]);
}

// leaky at `slope`, then bf16, on `n` bf16 values in place (n a multiple of 8,
// 16-byte aligned), spread over `threads` threads from `tid`.
__device__ __forceinline__ void leaky_in_place(__nv_bfloat16* v, int n, float slope, int tid,
                                               int threads) {
  uint4* p = reinterpret_cast<uint4*>(v);
  for (int i = tid; i < n / 8; i += threads) {
    uint4 u = p[i];
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      w[h] = pack_bf16(vk_leaky(f.x, slope), vk_leaky(f.y, slope));
    }
    p[i] = u;
  }
}

// The swizzle mode of a row of `span` bytes.
inline CUtensorMapSwizzle swizzle_of(int span) {
  return span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A bf16 tensor map of `rank` dimensions (innermost first, strides in bytes of the
// outer ones) with boxes of `box` and the swizzle of a box row.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  const auto encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle_of(static_cast<int>(box[0]) * 2), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory of one upsampler block, bytes from a 1024-aligned base
// (ops/cuda/stage.py::upsample_smem computes the same): the mbarrier in the first
// 1 KB; the k taps' (C_in x N) weight slabs, each 1024-aligned; the x window of
// `rows` rows in C_in / KC chunks of KC = min(C_in, 64) channels, each
// 1024-aligned; plus 1 KB to align the base.
struct UpSmem {
  int w, tap, x, chunk, total;
  __host__ __device__ UpSmem(int n, int c_in, int k, int rows) {
    const int kc = c_in < 64 ? c_in : 64;
    w = 1024;
    tap = round1024(c_in * n * 2);
    x = w + k * tap;
    chunk = round1024(rows * kc * 2);
    total = x + (c_in / kc) * chunk + 1024;
  }
};

// Shared memory of one pair block (ops/cuda/resblock.py::pair_smem): the two
// mbarriers in the first 1 KB; conv1's and conv2's k (32 x 32) weight slabs of
// 2 KB; the src window of 64 * NW + (k - 1) * dil rows of 64 bytes; the bf16 y1
// window of 64 * NW + k - 1 rows of kYRow bytes; plus 1 KB to align the base.
constexpr int kPairC = 32;
constexpr int kYRow = (kPairC + 8) * 2;  // 80 bytes: conflict-free ldmatrix rows
struct PairSmem {
  int w1, w2, x, y, total;
  __host__ __device__ PairSmem(int k, int dil, int nw) {
    w1 = 1024;
    w2 = w1 + k * kPairC * kPairC * 2;
    x = w2 + k * kPairC * kPairC * 2;
    y = x + round1024((64 * nw + (k - 1) * dil) * kPairC * 2);
    total = y + (64 * nw + k - 1) * kYRow + 1024;
  }
};

}  // namespace wgn
