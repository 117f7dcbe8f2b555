// Kernel 5's backward: the gradients of the trainable resblock trio.
//
// Replaces the custom VJP of vits_tpu/ops/pallas/trio_grad.py::
// make_trainable_trio (:217-265), which the JAX package runs in XLA from the
// activations its Pallas forward saved. vits_tpu_torch/ops/cuda/trio_grad.py::
// trio_backward drives it, per pair i in reverse with dx the gradient at the
// pair's output (pair input x_in, saved pre-activation y1, slope s):
//   dW2, db2 = wgrad(leaky(y1), dx)                   wgrad_kernel, second stream
//   dy1      = conv(dx, flipT(w2)) * leaky'(y1)       conv_kernel
//   dW1, db1 = wgrad(leaky(x_in), dy1), dilation d    wgrad_kernel, second stream
//   dx      += conv(dy1, flipT(w1), d) * leaky'(x_in) conv_kernel (residual dx)
// where flipT(w)[tap][i][o] = w[k-1-tap][o][i] and leaky'(v) = 1 at v >= 0, s
// below. The conv is conv_gemm.cuh's kernel reading w flipped and transposed
// in its tile loader (kTransW: no transpose launch, no copy), with the
// resblock epilogue's aux factor. The last pair of a later block adds its
// dx into the sum over blocks (accumulate). The whole backward is one C call
// (vk_trio_backward); the weight gradients run on a second stream beside the
// input-gradient chain (each after the event of the input it reads), so the
// two kinds of launch fill the card together.
//
// wgrad: dW[tap] = sum over the B*T frames f of leaky(a)[f + tap*d - pad]^T dy[f]
// and db = sum_f dy[f]: per tap a (M = C_in) x (N = C_out) GEMM whose K is
// the frames. What bounds it: operations, 2*k*C*C per frame, as the forward
// conv (at B=4, C=256, T=256 the trio's 18 wgrads are 16.9 GFLOP, 0.10 ms at
// 165 TFLOP/s); its bytes are the two (B, T, C) operands per tap, read from L2
// by k tap blocks. Design: a block owns one tap and a 64 x 64 (C_in x C_out)
// tile; 4 warps of 32 x 32 (m16n8k8 TF32 MMAs, 3xTF32 with B's accumulation
// rule: each 32-frame step sums into a zeroed partial, small products first,
// added to the fp32 accumulator). Both operands stage frame-major in shared
// memory (rows of 64 + 8 floats: fragment loads conflict-free) through a
// 3-deep cp.async ring; each frame row is loaded on its own, so a 32-frame
// step may cross batch rows and the shifted a row is zero-filled outside
// [0, T) of its batch row. Fragments are loaded as scalars and split in
// registers (leaky applied to a first). The frames are split across a
// cluster of `split` blocks in contiguous ranges of whole steps; the partial
// tiles are summed over distributed shared memory in rank order 0, 1, ...
// (a fixed order: a repeated backward is bit-identical; no atomics, no
// workspace). The tap-0, first-C_in-tile blocks also sum dy's columns (per
// step, then into the running sum) for db, reduced the same way.
//
// At bf16 (mode kFast, the bf16 training tier): every tensor is bf16 storage
// and the steps are those of XLA's bf16 graph (the JAX package's bf16 training
// runs its plain resblocks): the input gradients are B's conv at kFast (bf16
// mma.sync, the weights read flipped and transposed as bf16) with the bf16
// epilogue (conv::Bf16Epi: the conv's sum, leaky's derivative and the residual
// each rounded to bf16); the weight gradients take bf16 operands (leaky(a)
// rounded to bf16, as XLA's forward saved it) on the same TF32 MMAs, one pass
// (a bf16 value is exact in tf32), fp32 sums in the fixed order above, each
// dW and db rounded to bf16 once at the end.
#include "common.cuh"
#include "conv_gemm.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kW = 64;         // tile: C_in rows and C_out columns
constexpr int kF = 32;         // frames per step
constexpr int kS = kW + 8;     // staged row stride (floats): 8 banks apart
constexpr int kWStages = 3;    // steps in flight
constexpr int kWThreads = 128; // 2 x 2 warps of 32 x 32
constexpr int kOs = kW + 4;    // staged output row stride

__device__ __forceinline__ void store4(float* p, float4 y) { *reinterpret_cast<float4*>(p) = y; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 y) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p);
  o[0] = __floats2bfloat162_rn(y.x, y.y);
  o[1] = __floats2bfloat162_rn(y.z, y.w);
}

// AT: the storage of a, dy, dw and db (fp32 at kExact, bf16 at kFast); M the tier.
template <class AT, int M>
__global__ void __launch_bounds__(kWThreads)
    wgrad_kernel(const AT* __restrict__ a, const AT* __restrict__ dy, AT* __restrict__ dw,
                 AT* __restrict__ db, int B, int T, int C_in, int C_out, int dil, int pad,
                 float slope, int split) {
  extern __shared__ __align__(16) float smem[];
  AT* as = reinterpret_cast<AT*>(smem);  // kWStages x kF x kS
  AT* bs = as + kWStages * kF * kS;      // kWStages x kF x kS
  const int rank = blockIdx.x;              // clusters are (split, 1, 1)
  const int ci_tiles = C_in / kW;
  const int ci0 = blockIdx.y % ci_tiles * kW, co0 = blockIdx.y / ci_tiles * kW;
  const int tap = blockIdx.z;
  const int shift = tap * dil - pad;
  const bool bias_block = tap == 0 && ci0 == 0;
  const int F = B * T;
  const int steps = (F + kF - 1) / kF;
  const int per = (steps + split - 1) / split;
  const int s0 = rank * per;
  const int n = steps - s0 < per ? (steps - s0 > 0 ? steps - s0 : 0) : per;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int wm0 = warp % 2 * 32, wn0 = warp / 2 * 32;

  auto issue = [&](int i) {  // frames f0 .. f0 + 31 of local step i
    const int f0 = (s0 + i) * kF;
    constexpr int V = 16 / sizeof(AT);  // values a 16-byte copy carries
    AT* ad = as + i % kWStages * kF * kS;
    AT* bd = bs + i % kWStages * kF * kS;
    for (int idx = tid; idx < kF * (kW / V); idx += kWThreads) {
      const int r = idx / (kW / V), cv = idx - r * (kW / V);
      const int f = f0 + r;
      const int b = f / T, p = f - b * T + shift;
      const bool fin = f < F, ain = fin && p >= 0 && p < T;
      cp_async16_zfill(ad + r * kS + cv * V,
                       ain ? a + ((size_t)b * T + p) * C_in + ci0 + cv * V : a, ain ? 16 : 0);
      cp_async16_zfill(bd + r * kS + cv * V, fin ? dy + (size_t)f * C_out + co0 + cv * V : dy,
                       fin ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float dbsum = 0.f;  // thread tid < kW: column co0 + tid

#pragma unroll
  for (int i = 0; i < kWStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();
    if (i + kWStages - 1 < n) issue(i + kWStages - 1);
    cp_async_commit();
    const AT* at = as + i % kWStages * kF * kS;
    const AT* bt = bs + i % kWStages * kF * kS;
    if (bias_block && tid < kW) {
      float s = 0.f;
      for (int r = 0; r < kF; ++r) s += ldf(bt + r * kS + tid);
      dbsum += s;
    }
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kF; kp += 16) {  // a pair of k8 slices of frames
      unsigned ah[2][2][4], al[2][2][4], bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const AT* r0 = at + (kp + 8 * h + t) * kS;  // frame kk = t; kk = t + 4 is 4 rows on
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m = wm0 + mt * 16 + gr;
          const float v[4] = {ldf(r0 + m), ldf(r0 + m + 8), ldf(r0 + 4 * kS + m),
                              ldf(r0 + 4 * kS + m + 8)};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tier<M>(vk_leaky(v[e], slope), ah[h][mt][e], al[h][mt][e]);
        }
        const AT* q0 = bt + (kp + 8 * h + t) * kS + wn0 + gr;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          split_tier<M>(ldf(q0 + nt * 8), bh[h][nt][0], bl[h][nt][0]);
          split_tier<M>(ldf(q0 + 4 * kS + nt * 8), bh[h][nt][1], bl[h][nt][1]);
        }
      }
      auto pass = [&](const unsigned (&aa)[2][2][4], int h, const unsigned (&bb)[2][4][2]) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(part[mt][nt], aa[h][mt], bb[h][nt][0], bb[h][nt][1]);
      };
      if constexpr (M != kFast) {  // kFast: lo = 0
        pass(al, 0, bh);
        pass(ah, 0, bl);
        pass(al, 1, bh);
        pass(ah, 1, bl);
      }
      pass(ah, 0, bh);
      pass(ah, 1, bh);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();
  __syncthreads();

  float* tile = smem;  // kW x kOs partial dW, then kW partial db
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* o = tile + (wm0 + mt * 16 + gr) * kOs + wn0 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * kOs) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  float* dbs = tile + kW * kOs;
  if (bias_block && tid < kW) dbs[tid] = dbsum;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();

  // rows [r0, r0 + rows) of the tile: the cluster's partials summed in rank order
  const int rows = kW / split, r0 = rank * rows;
  AT* out = dw + ((size_t)tap * C_in + ci0) * C_out + co0;
  for (int idx = tid; idx < rows * (kW / 4); idx += kWThreads) {
    const int r = r0 + idx / (kW / 4), c = idx % (kW / 4) * 4;
    const float* src = tile + r * kOs + c;
    float4 y = *reinterpret_cast<const float4*>(split > 1 ? cluster.map_shared_rank(src, 0) : src);
    for (int q = 1; q < split; ++q) {
      const float4 o = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, q));
      y = make_float4(y.x + o.x, y.y + o.y, y.z + o.z, y.w + o.w);
    }
    store4(out + (size_t)r * C_out + c, y);
  }
  if (bias_block && rank == 0 && tid < kW) {
    float s = split > 1 ? *cluster.map_shared_rank(dbs + tid, 0) : dbs[tid];
    for (int q = 1; q < split; ++q) s += *cluster.map_shared_rank(dbs + tid, q);
    stf(db + co0 + tid, s);
  }
  if (split > 1) cluster.sync();  // the peers' shared memory outlives every remote read
}

template <class AT, int M>
cudaError_t launch_wgrad(const void* a_, const void* dy_, void* dw_, void* db_, int B, int T,
                         int C_in, int C_out, int k, int dil, int pad, float slope, int split,
                         cudaStream_t stream) {
  const AT* a = static_cast<const AT*>(a_);
  const AT* dy = static_cast<const AT*>(dy_);
  AT* dw = static_cast<AT*>(dw_);
  AT* db = static_cast<AT*>(db_);
  if (B < 1 || T < 1 || k < 1 || dil < 1 || C_in % kW || C_out % kW || C_in < kW ||
      C_out < kW || split < 1 || split > conv::kMaxSplit || kW % split)
    return cudaErrorInvalidValue;
  const int steps = (B * T + kF - 1) / kF;
  if ((split - 1) * ((steps + split - 1) / split) >= steps) return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 != 0; };
  if (misaligned(a) || misaligned(dy) || misaligned(dw)) return cudaErrorMisalignedAddress;
  const int pipe = 2 * kWStages * kF * kS * static_cast<int>(sizeof(AT)) / 4;
  const int staged = kW * kOs + kW;
  const int smem = (pipe > staged ? pipe : staged) * static_cast<int>(sizeof(float));
  cudaError_t err = vk_set_smem_once<wgrad_kernel<AT, M>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (C_in / kW) * (C_out / kW), k);
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wgrad_kernel<AT, M>, a, dy, dw, db, B, T, C_in, C_out, dil,
                           pad, slope, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The second stream and the two events of vk_trio_backward, one set per device.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t to_side = nullptr, to_main = nullptr;
};

cudaError_t side_of_device(Side** out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Side& side = sides[dev];
  if (!side.stream) {
    err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.to_side, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.to_main, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

}  // namespace

// One pair of the backward, in the order vk_trio_backward runs them. dx_in is
// the gradient at the pair's output; dy1 and dx_out are buffers of the pair's
// own (the weight gradients read dx_in and dy1 on the second stream while the
// next pair runs); need_in 0 skips dx_out (pair 0 when x needs no gradient).
// Every tensor fp32 at kExact, bf16 at kFast.
struct TrioPair {
  const void *w1, *w2, *y1, *x_in, *dx_in;
  void *dy1, *dx_out, *dw1, *db1, *dw2, *db2;
  int k, dil, tile, split, wsplit, need_in, accumulate;
};

// Kernel 5's backward over n pairs, (B, T, C) activations, on stream: per
// pair the input gradients on it (dy1, then dx_out = dx_in + conv(dy1,
// flipT(w1)) * leaky'(x_in), added to dx_out with accumulate), and the two
// weight gradients (dW2, db2 from y1 and dx_in; dW1, db1 from x_in and dy1) on
// a second stream of this library's, each after the input it reads; the
// stream waits for the second before returning. lengths: (B,) = T. mode: the
// tier, kExact (fp32 tensors) or kFast (bf16 tensors, slope the bf16 one).
VK_EXPORT int vk_trio_backward(const TrioPair* pairs, int n, const int* lengths, int B, int T,
                               int C, float slope, int mode, void* stream) {
  if (mode != kExact && mode != kFast) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Side* side = nullptr;
  cudaError_t err = side_of_device(&side);
  auto dgrad = [&](const void* dy, void* out, const void* w, const void* aux,
                   const void* residual, int k, int dil, int accumulate, int tile, int split) {
    const conv::Gemm g{dy, C, w, lengths, T, C, C, k, dil, dil * (k - 1) / 2, 1.f, split, 0};
    if (mode == kFast) {
      using bf = __nv_bfloat16;
      const conv::Bf16Epi epi{static_cast<bf*>(out), nullptr, static_cast<const bf*>(residual),
                              static_cast<const bf*>(aux), slope, T, C, accumulate, 1.f};
      return conv::launch_tile<true, kFast, bf, conv::Bf16Epi, bf>(tile, g, epi, B, s);
    }
    const conv::ResEpi epi{static_cast<float*>(out), nullptr, static_cast<const float*>(residual),
                           static_cast<const float*>(aux), slope, T, C, accumulate, 1.f};
    return conv::launch_tile<true, kExact, float>(tile, g, epi, B, s);
  };
  auto wgrad = [&](const void* a, const void* dy, void* dw, void* db, int k, int dil, int pad,
                   int wsplit) {
    return mode == kFast ? launch_wgrad<__nv_bfloat16, kFast>(a, dy, dw, db, B, T, C, C, k, dil,
                                                              pad, slope, wsplit, side->stream)
                         : launch_wgrad<float, kExact>(a, dy, dw, db, B, T, C, C, k, dil, pad,
                                                       slope, wsplit, side->stream);
  };
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    const TrioPair& p = pairs[i];
    const int pad2 = (p.k - 1) / 2, pad1 = p.dil * (p.k - 1) / 2;
    // dW2, db2 on the side stream once dx_in is ready; dy1 on the main stream
    err = cudaEventRecord(side->to_side, s);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->to_side, 0);
    if (err == cudaSuccess)
      err = wgrad(p.y1, p.dx_in, p.dw2, p.db2, p.k, 1, pad2, p.wsplit);
    if (err == cudaSuccess)
      err = dgrad(p.dx_in, p.dy1, p.w2, p.y1, nullptr, p.k, 1, 0, p.tile, p.split);
    // dW1, db1 on the side stream once dy1 is ready; dx_out on the main stream
    if (err == cudaSuccess) err = cudaEventRecord(side->to_side, s);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->to_side, 0);
    if (err == cudaSuccess)
      err = wgrad(p.x_in, p.dy1, p.dw1, p.db1, p.k, p.dil, pad1, p.wsplit);
    if (err == cudaSuccess && p.need_in)
      err = dgrad(p.dy1, p.dx_out, p.w1, p.x_in, p.dx_in, p.k, p.dil, p.accumulate, p.tile,
                  p.split);
  }
  if (side) {  // the stream waits for the side stream's work, even after an error
    const cudaError_t rec = cudaEventRecord(side->to_main, side->stream);
    const cudaError_t wait = rec == cudaSuccess ? cudaStreamWaitEvent(s, side->to_main, 0) : rec;
    if (err == cudaSuccess) err = wait;
  }
  return err;
}
