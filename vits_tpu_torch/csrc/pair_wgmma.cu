// Kernel C's 32-channel resblock pairs at the `fast` tier on bf16 packs, on
// Hopper: one launch a pair, y1 kept on chip (stage_wgmma.cuh says what bounds
// it and what the pieces are).
//
// y1  = mask(conv1(bf16(leaky(src, x_slope))) + b1)         dilated by dil
// out = (prev + round(mask(src + conv2(bf16(leaky(y1, slope))) + b2))) * scale
//
// the two launches of one pair that ops/cuda/resblock.py::run_pairs makes
// through conv_gemm.cuh's conv_kernel<kFast> at C = 32 (its conv_reference
// chained twice), with mask zero at rows at and past lengths[b] (and outside
// [0, T): conv2's zero padding of y1), round the bf16 value carry, prev the
// running sum over the stage's resblocks (accumulate) and scale the mean's
// 1 / blocks on the last pair. It replaces those launches in kernel C's stages at
// C = 32 (MMS's and VCTK's 64->32, small_config's) wherever the src window fits
// one TMA box (ops/cuda/resblock.py::pair_plan); B's launches stay as they are.
//
// Design:
// - A tile is NW warpgroups' rows: y1 over R = 64 * NW rows and the output over
//   the R - (k - 1) rows in their middle (conv2's reach of (k - 1) / 2 rows on
//   each side), so tiles advance by R - (k - 1) rows and each recomputes the
//   (k - 1) rows of y1 it shares with a neighbour.
// - Blocks are persistent: a grid of at most the blocks the card holds at once
//   walks the (batch row, tile) items. A block loads both convs' k (32 x 32)
//   weight slabs once (at C = 32 and k <= 11, 44 KB: whole in shared memory):
//   per tile they would be most of its bytes. Thread 0 asks TMA for a tile's
//   src window (R + (k - 1) * dil rows x 32 bf16 channels, zero fill outside
//   [0, T), 64-byte swizzle) on an mbarrier whose phase turns once a tile, and
//   for the next tile's window as soon as conv1 is done with this one, so the
//   load runs under conv2 and the epilogue.
// - Each thread takes its residual values (the src rows its outputs sit on) from
//   the raw window into registers; then leaky at the carry's slope and the bf16
//   rounding run on the window in place.
// - conv1 is k x 2 steps of wgmma.m64n32k16 per warpgroup (A by ldmatrix at the
//   tap's row shift tap * dil). Its epilogue adds b1, zeroes rows outside
//   [0, len), applies leaky at `slope` (fp32, as conv2's launch does) and writes
//   the bf16 A operand of conv2 into the y1 window (rows of 40 values:
//   conflict-free ldmatrix), never to device memory.
// - conv2 is the same chain over the y1 window (dilation 1); its epilogue adds
//   b2 and the residual, zeroes rows past the length, rounds to bf16, adds the
//   running sum and scales, and writes bf16 (the pairs' outputs between
//   resblocks, the chained mean) or fp32 (the running sum) from registers.
// - A tile that starts at or past its row's length loads nothing: its outputs
//   are the running sum times the scale, or zeros.
#include "stage_wgmma.cuh"

namespace {

using wgn::kPairC;
using wgn::kYRow;

struct Pair {
  const int* lengths;
  const float* b1;  // (32,)
  const float* b2;
  float* out32;           // (B, T, 32) fp32: the output, or the running sum read with accumulate
  __nv_bfloat16* out16;   // (B, T, 32) bf16: the output where given
  int T, k, dil, accumulate;
  float x_slope, slope, scale;
  int tiles, work;  // tiles a batch row, and (batch row, tile) items
};

// Outputs (row pos, columns co, co + 1) of batch row b: y = the pair's rounded
// output (0 past the length), then the running sum prev (with accumulate) and
// the scale.
__device__ __forceinline__ size_t out_at(const Pair& p, int b, int pos, int co) {
  return ((size_t)b * p.T + pos) * kPairC + co;
}
__device__ __forceinline__ void finish(const Pair& p, size_t at, float y0, float y1,
                                       float2 prev) {
  if (p.accumulate) {
    y0 += prev.x;
    y1 += prev.y;
  }
  y0 *= p.scale;
  y1 *= p.scale;
  if (p.out16)
    *reinterpret_cast<__nv_bfloat162*>(p.out16 + at) = __floats2bfloat162_rn(y0, y1);
  else
    *reinterpret_cast<float2*>(p.out32 + at) = make_float2(y0, y1);
}
__device__ __forceinline__ float2 prev_at(const Pair& p, size_t at) {
  return p.accumulate ? *reinterpret_cast<const float2*>(p.out32 + at) : make_float2(0.f, 0.f);
}

template <int NW>
__global__ void __launch_bounds__(128 * NW, NW == 1 ? 6 : 3)
    pair_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map, const Pair p) {
  constexpr int R = 64 * NW, kThreads = 128 * NW, kSpan = kPairC * 2;
  constexpr int kSlab = kPairC * kPairC * 2;  // one tap's weights
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int k = p.k, dil = p.dil, h2 = (k - 1) / 2, h1 = dil * h2;
  const int mout = R - 2 * h2;  // output rows of a tile
  const int xrows = R + 2 * h1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const wgn::PairSmem L(k, dil, NW);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // [0]: the weights, [1]: a tile's window
  unsigned char* xw = smem + L.x;
  unsigned char* yw = smem + L.y;
  // item w: batch row w / tiles, tile w % tiles; live while it starts before the length
  auto live = [&](int w) { return (w % p.tiles) * mout < p.lengths[w / p.tiles]; };
  auto next_live = [&](int w) {
    while (w < p.work && !live(w)) w += gridDim.x;
    return w;
  };
  auto load_window = [&](int w) {  // thread 0; window row 0 <-> t0 - h2 - h1
    mbar_arrive_tx(&bar[1], xrows * kSpan);
    wg::tma_3d(xw, &xmap, 0, (w % p.tiles) * mout - h2 - h1, w / p.tiles, &bar[1]);
  };

  if (next_live(blockIdx.x) < p.work) {  // this block computes: weights and a first window
    if (tid == 0) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_arrive_tx(&bar[0], 2 * k * kSlab);
      for (int tap = 0; tap < k; ++tap) {
        wg::tma_2d(smem + L.w1 + tap * kSlab, &w1map, 0, tap * kPairC, &bar[0]);
        wg::tma_2d(smem + L.w2 + tap * kSlab, &w2map, 0, tap * kPairC, &bar[0]);
      }
      load_window(next_live(blockIdx.x));
    }
  }

  // this warp's 16 rows of its warpgroup's 64; this lane's ldmatrix row and column;
  // this lane's accumulator rows m0 + g (+ 8) and columns 8q + 2tq (+ 1)
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16;
  const int a_row = m0 + (lane >> 3 & 1) * 8 + (lane & 7), a_col = (lane >> 4) * 8;
  int windows = 0;
  for (int w = blockIdx.x; w < p.work; w += gridDim.x) {
    const int b = w / p.tiles, t0 = (w % p.tiles) * mout, len = p.lengths[b];
    if (t0 >= len) {  // the whole tile is padding
      const int rows = p.T - t0 < mout ? p.T - t0 : mout;
      for (int idx = tid; idx < rows * (kPairC / 2); idx += kThreads) {
        const int r = idx / (kPairC / 2), co = 2 * (idx - r * (kPairC / 2));
        const size_t at = out_at(p, b, t0 + r, co);
        finish(p, at, 0.f, 0.f, prev_at(p, at));
      }
      continue;
    }
    float bias[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 bv = *reinterpret_cast<const float2*>(p.b1 + 8 * q + 2 * tq);
      bias[q][0] = bv.x;
      bias[q][1] = bv.y;
    }
    mbar_wait(&bar[1], windows & 1);
    if (windows++ == 0) mbar_wait(&bar[0], 0);
    unsigned res[2][4];  // output row m0 + g + 8h <-> window row + h1 + h2: the raw src
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        res[h][q] = *reinterpret_cast<const unsigned*>(
            xw + wgn::swz((m0 + g + 8 * h + h1 + h2) * kSpan + (8 * q + 2 * tq) * 2, kSpan));
    __syncthreads();  // every residual is read, and the last tile's conv2 is done with yw
    wgn::leaky_in_place(reinterpret_cast<__nv_bfloat16*>(xw), xrows * kPairC, p.x_slope, tid,
                        kThreads);
    __syncthreads();

    float acc[16];
    unsigned a0[4], a1[4];
    // conv1 over y1 rows m0.. (y1 row j <-> position t0 - h2 + j, reading window rows
    // j + tap * dil): step si = tap * 2 + (16-channel half)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    auto step1 = [&](int si, unsigned (&a)[4]) {
      const int tap = si >> 1, c0 = 16 * (si & 1);
      ldmatrix_x4(a, xw + wgn::swz((a_row + tap * dil) * kSpan + (c0 + a_col) * 2, kSpan));
      wgn::wgmma_step<32>(acc, a, wgn::b_desc<32>(smem + L.w1 + tap * kSlab + c0 * kSpan));
    };
    for (int si = 0; si < 2 * k; si += 2) {
      step1(si, a0);
      step1(si + 1, a1);
    }
    wgn::wgmma_drain<32>(acc);
    // y1's epilogue: + b1, zero outside [0, len), leaky at slope, bf16 into the y1 window
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = m0 + g + 8 * h, pos = t0 - h2 + j;
      const bool valid = pos >= 0 && pos < len;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v0 = valid ? acc[4 * q + 2 * h] + bias[q][0] : 0.f;
        const float v1 = valid ? acc[4 * q + 2 * h + 1] + bias[q][1] : 0.f;
        *reinterpret_cast<unsigned*>(yw + j * kYRow + (8 * q + 2 * tq) * 2) =
            pack_bf16(vk_leaky(v0, p.slope), vk_leaky(v1, p.slope));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 bv = *reinterpret_cast<const float2*>(p.b2 + 8 * q + 2 * tq);
      bias[q][0] = bv.x;
      bias[q][1] = bv.y;
    }
    // the window's generic writes (leaky in place) before TMA's next write into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // conv1 is done with the window; conv2 reads the next warpgroup's y1
    if (tid == 0) {
      const int n = next_live(w + gridDim.x);
      if (n < p.work) load_window(n);  // under conv2 and the epilogue
    }

    // conv2: output row r <-> position t0 + r reads y1 rows r + tap. Rows r >= mout
    // read y1 rows past R that no one wrote; they are never stored.
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    auto step2 = [&](int si, unsigned (&a)[4]) {
      const int tap = si >> 1, c0 = 16 * (si & 1);
      ldmatrix_x4(a, yw + (a_row + tap) * kYRow + (c0 + a_col) * 2);
      wgn::wgmma_step<32>(acc, a, wgn::b_desc<32>(smem + L.w2 + tap * kSlab + c0 * kSpan));
    };
    for (int si = 0; si < 2 * k; si += 2) {
      step2(si, a0);
      step2(si + 1, a1);
    }
    wgn::wgmma_drain<32>(acc);
    // the running sum's eight float2s a thread, every read issued before any is
    // used: a thread's loads in flight hide device memory's latency
    float2 prev[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h, pos = t0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        prev[h][q] = r < mout && pos < p.T ? prev_at(p, out_at(p, b, pos, 8 * q + 2 * tq))
                                           : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h, pos = t0 + r;
      if (r >= mout || pos >= p.T) continue;
      const bool valid = pos < len;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float y0 = 0.f, y1 = 0.f;
        if (valid) {
          const float2 rv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[h][q]));
          y0 = bf16_round(acc[4 * q + 2 * h] + bias[q][0] + rv.x);
          y1 = bf16_round(acc[4 * q + 2 * h + 1] + bias[q][1] + rv.y);
        }
        finish(p, out_at(p, b, pos, 8 * q + 2 * tq), y0, y1, prev[h][q]);
      }
    }
  }
}

template <int NW>
cudaError_t launch(const void* src, const void* w1, const void* w2, const Pair& p, int B,
                   int grid, cudaStream_t stream) {
  const wgn::PairSmem L(p.k, p.dil, NW);
  const int xrows = 64 * NW + (p.k - 1) * p.dil;
  if (L.total > kMaxSmemBytes || xrows > 256 || 64 * NW <= p.k - 1) return cudaErrorInvalidValue;
  CUtensorMap xmap, w1map, w2map;
  {  // src as (32, T, B) bf16; a box of 32 channels x the window's rows x 1 row
    const cuuint64_t dims[3] = {(cuuint64_t)kPairC, (cuuint64_t)p.T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)kPairC * 2, (cuuint64_t)p.T * kPairC * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kPairC, (cuuint32_t)xrows, 1};
    if (!wgn::encode_bf16(&xmap, src, 3, dims, strides, box)) return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kPairC, (cuuint64_t)p.k * kPairC};
  const cuuint64_t strides[1] = {(cuuint64_t)kPairC * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kPairC, (cuuint32_t)kPairC};  // a tap's slab
  if (!wgn::encode_bf16(&w1map, w1, 2, dims, strides, box) ||
      !wgn::encode_bf16(&w2map, w2, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem_once<pair_conv_kernel<NW>>(L.total);
  if (err != cudaSuccess) return err;
  pair_conv_kernel<NW><<<grid < p.work ? grid : p.work, 128 * NW, L.total, stream>>>(
      xmap, w1map, w2map, p);
  return cudaGetLastError();
}

}  // namespace

// One resblock pair of kernel C at the kFast tier on bf16 packs, in one launch:
// src (B, T, 32) bf16; w1, w2 (k, 32, 32) bf16; b1, b2 (32,) fp32; the output bf16
// into out16 where given, else fp32 into out32; with accumulate the running sum
// is read from out32 (fp32). k odd; nw (warpgroups of 64 y1 rows a block: 1 or 2)
// and grid (persistent blocks, at most one a (batch row, tile) item) from
// ops/cuda/resblock.py::pair_plan, whose window 64 * nw + (k - 1) * dil is at most
// 256 rows.
VK_EXPORT int vk_pair_wgmma(const void* src, float* out32, void* out16, const void* w1,
                            const float* b1, const void* w2, const float* b2, const int* lengths,
                            int B, int T, int C, int k, int dil, float x_slope, float slope,
                            int accumulate, float scale, int nw, int grid, void* stream) {
  if (B < 1 || T < 1 || C != kPairC || k < 1 || k % 2 == 0 || dil < 1 || (nw != 1 && nw != 2) ||
      grid < 1 || 64 * nw <= k - 1 || (out16 == nullptr && out32 == nullptr) ||
      (accumulate && out32 == nullptr))
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 != 0; };
  if (misaligned(src) || misaligned(out32) || misaligned(out16) || misaligned(w1) ||
      misaligned(w2) || misaligned(b1) || misaligned(b2))
    return cudaErrorMisalignedAddress;
  const int mout = 64 * nw - (k - 1), tiles = (T + mout - 1) / mout;
  const Pair p{lengths, b1, b2, out32, static_cast<__nv_bfloat16*>(out16), T, k, dil,
               accumulate, x_slope, slope, scale, tiles, tiles * B};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nw == 1 ? launch<1>(src, w1, w2, p, B, grid, s) : launch<2>(src, w1, w2, p, B, grid, s);
}
