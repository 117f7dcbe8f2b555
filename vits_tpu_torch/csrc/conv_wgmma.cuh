// The resblock conv of kernels B and C at the `fast` tier, designed for Hopper:
// TMA loads into an mbarrier ring, a producer, and consumer warpgroups that run
// wgmma.
//
// out[b, p] = ResEpi(sum_tap sum_ci bf16(leaky(x[b, p + tap*dil - pad, ci])) * W[tap][ci][co])
//
// The same function as conv_gemm.cuh's conv_kernel<kFast> with bf16 weights
// and fp32 x (ResEpi: bias, residual, the mask past lengths[b], round,
// accumulate, scale, out16); it replaces that route for every resblock conv
// that B (vits_tpu/ops/pallas/resblock.py:238 fused_resblock_trio) and C's
// resblocks (ops/pallas/stage.py::fused_stage) launch at `fast` on bf16 packs
// with C_in % 64 == 0, C_out % 64 == 0 and (k - 1) * dil <= 128
// (ops/cuda/resblock.py::wgmma_plan). The JAX kernels compute it as one bf16
// MXU pass with fp32 sums (ops/pallas/__init__.py::kernel_dot).
//
// What bounds it on an H100. A trio's work, 2*k*C*C multiply-adds per conv per
// time step, takes 0.042 / 0.085 ms at 989 TFLOP/s (C=256, T=2560 / C=128,
// T=20480). But each of its 18 launches also moves its fp32 input, residual
// and output through device memory: 31 MB a launch at C=128, T=20480, ~10 us
// at 3.35 TB/s, more than its products. So a launch's time is its waves of
// blocks, each a window load, products and an epilogue; blocks that share an
// SM overlap one's memory phases with another's products.
//
// Design:
// - A block is NC consumer warpgroups of 64 output rows each (warpgroups
//   0 .. NC - 1) and a producer after them, all BN of the tile's
//   out-channels. NC = 2 (BN 128, 256): the producer is a warpgroup (384
//   threads) and setmaxnreg hands its registers to the consumers, one block an
//   SM (at two an SM setmaxnreg fails the launch). NC = 1 (BN 64, 128): the
//   producer is one warp (160 threads), three blocks an SM where their shared
//   memory fits. wgmma_plan picks the shape, the ring and the split by a cost
//   model fitted on the card (the other shapes measured no faster anywhere).
// - K is walked as (64-input-channel chunk, tap) steps. The weights
//   (k, C_in, C_out) bf16 are one 2-D tensor map of k*C_in rows; a step's
//   64 x BN tile comes as BN/64 TMA boxes of 64 x 64 with 128-byte swizzle into
//   a ring of `stages` slots, each with a full and an empty mbarrier. The
//   boxes are wgmma's MN-major B operand as they land (LBO 8 KB between the
//   64-column boxes, SBO 1 KB between 8-row groups of K).
// - A chunk's raw x window ((64 NC + (k-1)*dil) rows x 64 fp32 channels) is one
//   TMA box of a 3-D tensor map (C_in, T, B): its out-of-bounds zero fill gives
//   the positions outside [0, T). Each consumer warpgroup applies leaky to its
//   own rows (64 + (k-1)*dil) and rounds them into its bf16 window (rows of
//   64 + 8 values, conflict-free ldmatrix), then releases the raw window, which
//   the producer refills with the next chunk while the chunk's k taps run.
// - A tap is a row shift of the bf16 window: A fragments come from registers,
//   one ldmatrix.x4 per k16 slice at row offset tap*dil (a shared-memory A
//   descriptor could not start at every dilation's row). The products are
//   wgmma.m64n64k16 (BN/64 per k16 slice) summing into the accumulators
//   across all of K (no zeroed partial: at `fast` that guard of the exact
//   tier only lengthened the chain). A step's products stay in flight while
//   the next step's fragments load (two register sets in turn); a slot is
//   freed once its products are done.
// - The epilogue stages the tile in the ring's memory and reads each thread's
//   residual and running sum several float4s at a time, prefetched into L2 by
//   the producer while the products run.
// - Small grids (a short utterance at C=256): the K steps split over a
//   thread-block cluster (1, 2, 4 or 8 blocks) that reduces its partial tiles
//   in distributed shared memory before the epilogue, as conv_gemm.cuh does.
//   No persistent tile walk: later work.
// - A tile that starts at or past its row's length skips the products and
//   the copies (its epilogue writes zeros or the running mean).
//
// Left on conv_gemm.cuh's mma.sync: the `high` and `exact` tiers, int8
// weights at `fast`, bf16 activations (vk_conv_bf16: bf16 serving, kernel 5's
// bf16 forward), kTransW (kernel 5's input gradients), kernel 6's products,
// and channel counts off the 64 grid (the narrow path below 32; kernel B at 32,
// which no configuration runs). C's 32-wide resblocks at `fast` on bf16 packs
// run as one launch a pair on pair_wgmma.cu, and C's upsampler on
// upsample_wgmma.cu (stage_wgmma.cuh).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "conv_gemm.cuh"

namespace wg {

constexpr int kKc = 64;        // input channels per K step: one 128-byte swizzle row of bf16
constexpr int kAh = kKc + 8;   // bf16 window row stride (values): 144 bytes
// A block of NC consumer warpgroups (warpgroups 0 .. NC - 1), 64 output rows each,
// and a producer after them: a warpgroup at NC = 2 (setmaxnreg hands its registers
// to the consumers), one warp at NC = 1.
template <int NC>
constexpr int kRows = 64 * NC;
template <int NC>
constexpr int kThreads = NC == 2 ? 384 : 160;
constexpr int kMaxHalo = 128;  // (k - 1) * dil: the raw window is one TMA box of <= 256 rows
constexpr int kMaxStages = 8;
constexpr int kMaxSplit = 8;
constexpr int kBox = 64;       // a weight box: 64 columns (128 bytes) x 64 rows of K

// Shared memory of one block, bytes from a 1024-aligned base (ops/cuda/resblock.py::
// wgmma_smem computes the same): the mbarriers in the first 1 KB, then the ring, the
// raw window and a bf16 window a consumer warpgroup; the staged output tile reuses
// the space from the ring on after the products. Plus 1 KB to align the base.
struct Smem {
  int stage_bytes, ring, raw, a16, total;
  __host__ __device__ Smem(int bn, int stages, int halo, int nc) {
    stage_bytes = kKc * bn * 2;
    ring = 1024;
    raw = ring + stages * stage_bytes;
    a16 = raw + (64 * nc + halo) * kKc * 4;
    const int pipe = a16 + nc * (64 + halo) * kAh * 2;
    const int tile = ring + 64 * nc * (bn + 8) * 4;
    total = (pipe > tile ? pipe : tile) + 1024;
  }
};

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// Named barrier over `threads` threads (id 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// wgmma's descriptor of an MN-major B tile with 128-byte swizzle: start address,
// LBO = 8 KB (the next 64-column box), SBO = 1 KB (the next 8 rows of K), layout 1.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(8192 >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d += A * B: one wgmma.m64n64k16, A (this warp's 16 rows x 16 of K, mma.sync's
// m16n8k16 A fragment) from registers, B (16 x 64, MN-major) by descriptor.
// d[4j + e]: rows g, g, g + 8, g + 8 and columns 8j + 2t, + 1 of the warp's 16 rows.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

struct Conv {
  const int* lengths;
  int T, C_in, C_out, k, dil, pad;
  float slope;
  int split, stages;
};

// The blocks an SM that a block shape is built for, by registers (the plan's
// shared memory may allow fewer): at NC = 2 (BN 128, 256) one, setmaxnreg moving
// the producer's registers to the consumers (at two an SM it fails the launch);
// at NC = 1 (BN 64, 128) three, which overlap one's window loads and epilogue
// with another's products.
template <int NC>
constexpr int kBlocksPerSm = NC == 1 ? 3 : 1;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BN, int NC>
__global__ void __launch_bounds__(kThreads<NC>, kBlocksPerSm<NC>)
    wgmma_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const Conv g,
                      const conv::ResEpi epi) {
  constexpr int NB = BN / 64;  // 64-column boxes of a stage, m64n64 wgmmas of a k16 slice
  constexpr int kBM = kRows<NC>, kCons = 128 * NC;  // the block's rows, consumer threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int k = g.k, dil = g.dil, S = g.stages, split = g.split;
  const int halo = (k - 1) * dil;
  const Smem L(BN, S, halo, NC);
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(smem + L.a16);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  uint64_t* raw_full = empty + S;
  uint64_t* raw_empty = raw_full + 1;

  const int rank = blockIdx.x % split;  // clusters are (split, 1, 1)
  const int t0 = blockIdx.x / split * kBM;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int len = g.lengths[b];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wgi = warp >> 2;

  const int steps = g.C_in / kKc * k;
  const int per = (steps + split - 1) / split;
  const int s0 = rank * per;
  const int mine = steps - s0 < per ? steps - s0 : per;
  const int n = t0 < len && mine > 0 ? mine : 0;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NC);  // lane 0 of each consumer warp
    }
    mbar_init(raw_full, 1);
    mbar_init(raw_empty, 4 * NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {  // the producer
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pw = warp - 4 * NC;
    if (pw == 0) {  // the epilogue's residual and running-sum rows into L2 meanwhile
      const int rows = kBM / split, r0 = t0 + rank * rows;
      for (int r = lane; r < rows && r0 + r < g.T; r += 32) {
        const size_t off = ((size_t)b * g.T + r0 + r) * epi.C + co0;
        if (epi.residual && r0 + r < len) prefetch_l2(epi.residual + off, BN * 4);
        if (epi.accumulate) prefetch_l2(epi.out + off, BN * 4);
      }
    }
    if (pw == 0 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      int windows = 0;
      for (int i = 0; i < n; ++i) {
        const int s = s0 + i, chunk = s / k, tap = s - chunk * k;
        if (i == 0 || tap == 0) {  // the chunk's raw window: row r <-> position t0 - pad + r
          if (windows > 0) mbar_wait(raw_empty, (windows - 1) & 1);
          mbar_arrive_tx(raw_full, (kBM + halo) * kKc * 4);
          tma_3d(raw, &xmap, chunk * kKc, t0 - g.pad, b, raw_full);
          ++windows;
        }
        const int slot = i % S;
        if (i >= S) mbar_wait(&empty[slot], (i / S - 1) & 1);
        unsigned char* dst = smem + L.ring + slot * L.stage_bytes;
        mbar_arrive_tx(&full[slot], L.stage_bytes);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_2d(dst + j * kBox * kBox * 2, &wmap, co0 + j * kBox, tap * g.C_in + chunk * kKc,
                 &full[slot]);
      }
    }
    __syncwarp();
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // a consumer warpgroup: rows m0 .. m0 + 63 of the tile
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wgi, m0 = c * 64, w4 = warp & 3;
  const int wrows = 64 + halo;
  __nv_bfloat16* win = a16 + c * wrows * kAh;
  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;

  // this lane's ldmatrix row: row lane % 8 of block lane / 8 (rows 0-7 / 8-15, k 0-7 / 8-15)
  const int a_row = w4 * 16 + (lane >> 3 & 1) * 8 + (lane & 7), a_col = (lane >> 4) * 8;
  int windows = 0;
  // Step i into the A registers a: step i - 1's products stay in flight while step
  // i's fragments load and its slot lands (the two steps' registers alternate).
  auto step = [&](int i, unsigned (&a)[4][4]) {
    const int s = s0 + i, chunk = s / k, tap = s - chunk * k;
    if (i == 0 || tap == 0) {  // a new chunk: leaky and bf16 once for its k taps
      mbar_wait(raw_full, windows & 1);
      ++windows;
      named_sync(1 + c, 128);  // this warpgroup's reads of the last window are done
      const float* src = raw + m0 * kKc;
      for (int idx = tid & 127; idx < wrows * (kKc / 8); idx += 128) {
        const int r = idx >> 3, cv = (idx & 7) * 8;
        const float4 lo = *reinterpret_cast<const float4*>(src + r * kKc + cv);
        const float4 hi = *reinterpret_cast<const float4*>(src + r * kKc + cv + 4);
        uint4 o;
        o.x = pack_bf16(vk_leaky(lo.x, g.slope), vk_leaky(lo.y, g.slope));
        o.y = pack_bf16(vk_leaky(lo.z, g.slope), vk_leaky(lo.w, g.slope));
        o.z = pack_bf16(vk_leaky(hi.x, g.slope), vk_leaky(hi.y, g.slope));
        o.w = pack_bf16(vk_leaky(hi.z, g.slope), vk_leaky(hi.w, g.slope));
        *reinterpret_cast<uint4*>(win + r * kAh + cv) = o;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(raw_empty);
      named_sync(1 + c, 128);  // the window is written for every warp of the group
    }
    const int slot = i % S;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a[kk], win + (a_row + tap * dil) * kAh + a_col + kk * 16);
    mbar_wait(&full[slot], (i / S) & 1);
    const unsigned char* stage = smem + L.ring + slot * L.stage_bytes;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) fence_acc(acc[j][e]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // k16 slice kk: rows 16kk.. of the stage, 2 KB on
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_n64(acc[j], a[kk], b_desc(stage + j * kBox * kBox * 2 + kk * 16 * 128));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step i - 1's are done
    __syncwarp();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % S]);
  };
  unsigned a0[4][4], a1[4][4];
  for (int i = 0; i < n; i += 2) {
    step(i, a0);
    if (i + 1 < n) step(i + 1, a1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) fence_acc(acc[j][e]);

  named_sync(3, kCons);  // every consumer is done with the ring: it takes the staged tile
  constexpr int os = BN + 8;
  float* tile = reinterpret_cast<float*>(smem + L.ring);  // kBM x os partial sums of this block
  {
    const int gr = lane >> 2, t = lane & 3;
    const int r0 = m0 + w4 * 16 + gr;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float* o = tile + r0 * os + j * 64 + q * 8 + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][4 * q], acc[j][4 * q + 1]);
        *reinterpret_cast<float2*>(o + 8 * os) = make_float2(acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
  }
  if (split > 1)
    cluster_sync();  // every block's partial tile is staged
  else
    named_sync(3, kCons);

  // rows [r0, r0 + rows) of the tile: the cluster's partials summed, then the epilogue
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  // kU float4s a thread at a time, every read issued before any is used: a thread's
  // loads in flight are what hides device memory's latency here
  constexpr int kU = 8;
  const int rows = kBM / split, r0 = rank * rows, ct = tid;
  for (int base = ct; base < rows * (BN / 4); base += kCons * kU) {
    float4 y[kU];
    conv::ResEpi::In in[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = base + u * kCons;
      const int r = r0 + idx / (BN / 4), col = idx % (BN / 4) * 4, p = t0 + r;
      if (idx >= rows * (BN / 4) || p >= g.T) continue;
      const float* at = tile + r * os + col;
      y[u] = *reinterpret_cast<const float4*>(at);
      for (int q = 1; q < split; ++q) {
        const float4 o =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(at, (rank + q) % split));
        y[u] = make_float4(y[u].x + o.x, y[u].y + o.y, y[u].z + o.z, y[u].w + o.w);
      }
      in[u] = epi.fetch(b, p, co0 + col, p < len);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = base + u * kCons;
      const int r = r0 + idx / (BN / 4), col = idx % (BN / 4) * 4, p = t0 + r;
      if (idx >= rows * (BN / 4) || p >= g.T) continue;
      epi.finish(b, p, co0 + col, y[u], p < len, in[u]);
    }
  }
  if (split > 1) cluster_sync();  // the peers' shared memory outlives every remote read
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the library
// links no libcuda) once per device, as the other per-device state is kept.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 found[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && found[dev] != nullptr) return found[dev];
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  const auto fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  if (dev < 64) found[dev] = fn;
  return fn;
}

// One conv: x (B, T, C_in) fp32, w (k, C_in, C_out) bf16; the tile's width BN
// (64, 128, 256), its consumer warpgroups NC (1, 2), the ring's stages and the
// cluster split from wgmma_plan.
template <int BN, int NC>
cudaError_t launch(const float* x, const __nv_bfloat16* w, const Conv& g,
                   const conv::ResEpi& epi, int B, cudaStream_t stream) {
  constexpr int kBM = kRows<NC>;
  const int halo = (g.k - 1) * g.dil;
  const int steps = g.C_in / kKc * g.k;
  const int per = g.split > 0 ? (steps + g.split - 1) / g.split : 0;
  if (g.C_in % kKc || g.C_out % BN || halo > kMaxHalo || g.stages < 2 ||
      g.stages > kMaxStages || g.split < 1 || g.split > kMaxSplit || kBM % g.split ||
      (g.split - 1) * per >= steps)
    return cudaErrorInvalidValue;
  const Smem L(BN, g.stages, halo, NC);
  if (L.total > kMaxSmemBytes) return cudaErrorInvalidValue;
  const auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  {  // x as (C_in, T, B) fp32; a box of 64 channels x (kBM + halo) steps x 1 row
    const cuuint64_t dims[3] = {(cuuint64_t)g.C_in, (cuuint64_t)g.T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)g.C_in * 4, (cuuint64_t)g.T * g.C_in * 4};
    const cuuint32_t box[3] = {(cuuint32_t)kKc, (cuuint32_t)(kBM + halo), 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {  // w as (C_out, k * C_in) bf16; boxes of 64 x 64 with 128-byte swizzle
    const cuuint64_t dims[2] = {(cuuint64_t)g.C_out, (cuuint64_t)g.k * g.C_in};
    const cuuint64_t strides[1] = {(cuuint64_t)g.C_out * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)kBox};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(w), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  cudaError_t err = vk_set_smem_once<wgmma_conv_kernel<BN, NC>>(L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.T + kBM - 1) / kBM * g.split, g.C_out / BN, B);
  cfg.blockDim = dim3(kThreads<NC>);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wgmma_conv_kernel<BN, NC>, xmap, wmap, g, epi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The block shapes built (wgmma_plan's WGMMA_SHAPES): NC = 1 at BN 64 and 128,
// NC = 2 at 128 and 256.
inline cudaError_t launch_plan(int bn, int nc, const float* x, const __nv_bfloat16* w,
                               const Conv& g, const conv::ResEpi& epi, int B,
                               cudaStream_t stream) {
  if (nc == 1 && bn == 64) return launch<64, 1>(x, w, g, epi, B, stream);
  if (nc == 1 && bn == 128) return launch<128, 1>(x, w, g, epi, B, stream);
  if (nc == 2 && bn == 128) return launch<128, 2>(x, w, g, epi, B, stream);
  if (nc == 2 && bn == 256) return launch<256, 2>(x, w, g, epi, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg
