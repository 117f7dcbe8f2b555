// Kernel C's upsampler at the `fast` tier on bf16 packs, on Hopper: TMA windows
// and wgmma (stage_wgmma.cuh says what bounds it and what the pieces are).
//
// y[b, s*t + phi] = round(mask_t(sum_i bf16(leaky(x[b, t + i - o_phi])) @ w[j_phi + s*i]
//                                + bias))
//
// the polyphase ConvTranspose1d of stage.cu's upsample_kernel<NT, kFast> on bf16
// weights (ops/cuda/stage.py::upsample_phases gives the table), with mask_t zero
// at t >= lengths[b] and round the bf16 value carry. It replaces that launch
// (and the fp32 cast of its input before it) wherever C_in % 16 == 0 and C_out is
// 16, 32 or 64 (a B row of 32, 64 or 128 bytes: a TMA swizzle's span), and the x
// window fits one TMA box (ops/cuda/stage.py::upsample_plan). bf16 x bf16
// products are exact in fp32, so the result is the tf32 route's up to the order
// of the fp32 sums.
//
// Design:
// - A block is NW warpgroups of 64 input rows each, every phase and all C_out
//   columns: each input row is read once, for every phase. No producer: a
//   block loads once. Thread 0 asks for the window (C_in / KC boxes of a 3-D
//   tensor map (C_in, T_in, B), zero fill outside [0, T_in)) and the k taps'
//   (C_in x C_out) weight slabs (one 2-D box each, swizzled as wgmma's B
//   reads them) on one mbarrier.
// - The block applies leaky (at the carry's slope) and the bf16 rounding to the
//   window in place; each phase is then a chain of wgmma.m64nNk16 over (tap,
//   16 input channels) steps, A by ldmatrix at the tap's row shift, B the tap's
//   slab by descriptor, fp32 sums in registers.
// - The epilogue adds the bias, zeroes rows at and past the length, rounds to
//   bf16 and writes the phase's rows s*t + phi from the registers: fp32 where
//   the next launch stages fp32 (the 64-channel resblock convs of
//   conv_wgmma.cuh, the narrow path at 16), bf16 where it is the pair kernel.
// - A block that starts at or past its row's length loads nothing and writes
//   zeros.
#include "stage_wgmma.cuh"

namespace {

using wgn::Wgmma;

struct Up {
  const int* lengths;
  const float* bias;  // (C_out,)
  float* out32;       // (B, s * T_in, C_out), or
  __nv_bfloat16* out16;
  int T_in, C_in, k, stride, pad;
  int lo, rows;  // the window: rows t0 + lo .. t0 + lo + rows - 1
  float slope;
  int round;
};

// Phase phi of a stride-s ConvTranspose1d of k taps and padding pad (stage.cu's
// phase_of): first weight tap j, taps n, input offset o.
struct Phase {
  int j, n, o;
};
__host__ __device__ inline Phase phase(int phi, int k, int s, int pad) {
  const int pe = k - 1 - pad;
  int j = (pe - phi) % s;
  if (j < 0) j += s;
  return {j, (k - j + s - 1) / s, vk_floordiv(pe - phi - j, s)};
}

template <int N>
__device__ __forceinline__ void store_pair(const Up& u, size_t at, float y0, float y1) {
  if (u.out16)
    *reinterpret_cast<__nv_bfloat162*>(u.out16 + at) = __floats2bfloat162_rn(y0, y1);
  else
    *reinterpret_cast<float2*>(u.out32 + at) = make_float2(y0, y1);
}

template <int N, int NW>
__global__ void __launch_bounds__(128 * NW, NW == 1 ? 4 : 2)
    wgmma_upsample_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, const Up u) {
  constexpr int kRows = 64 * NW, kThreads = 128 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int t0 = blockIdx.x * kRows, b = blockIdx.y;
  const int len = u.lengths[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int s = u.stride;
  const size_t rows_out = (size_t)s * u.T_in;

  if (t0 >= len) {  // the whole tile is padding: zeros, nothing loaded
    const int n = (u.T_in - t0 < kRows ? u.T_in - t0 : kRows) * s * (N / 2);
    for (int idx = tid; idx < n; idx += kThreads) {
      const size_t at = ((size_t)b * rows_out + (size_t)s * t0) * N + 2 * idx;
      store_pair<N>(u, at, 0.f, 0.f);
    }
    return;
  }

  const int kc = u.C_in < 64 ? u.C_in : 64, span = 2 * kc;
  const wgn::UpSmem L(N, u.C_in, u.k, u.rows);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const int chunks = u.C_in / kc;
    mbar_arrive_tx(bar, u.k * u.C_in * N * 2 + chunks * u.rows * kc * 2);
    for (int tap = 0; tap < u.k; ++tap)
      wg::tma_2d(smem + L.w + tap * L.tap, &wmap, 0, tap * u.C_in, bar);
    for (int ch = 0; ch < chunks; ++ch)
      wg::tma_3d(smem + L.x + ch * L.chunk, &xmap, ch * kc, t0 + u.lo, b, bar);
  }
  mbar_wait(bar, 0);
  for (int ch = 0; ch < u.C_in / kc; ++ch)
    wgn::leaky_in_place(reinterpret_cast<__nv_bfloat16*>(smem + L.x + ch * L.chunk),
                        u.rows * kc, u.slope, tid, kThreads);
  __syncthreads();

  // this warp's 16 rows of its warpgroup's 64; this lane's ldmatrix row and column
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16;
  const int a_row = m0 + (lane >> 3 & 1) * 8 + (lane & 7), a_col = (lane >> 4) * 8;
  const int kk_n = u.C_in / 16;
  float bias[N / 8][2];
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const float2 bv = *reinterpret_cast<const float2*>(u.bias + 8 * q + 2 * tq);
    bias[q][0] = bv.x;
    bias[q][1] = bv.y;
  }
  for (int phi = 0; phi < s; ++phi) {
    const Phase ph = phase(phi, u.k, s, u.pad);
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
    const int steps = ph.n * kk_n;
    // step si: tap i = si / kk_n, input channels 16 * (si % kk_n) ..
    auto step = [&](int si, unsigned (&a)[4]) {
      const int i = si / kk_n, c0 = 16 * (si - i * kk_n);
      const int row = a_row + i - ph.o - u.lo, col = c0 % kc + a_col;
      ldmatrix_x4(a, reinterpret_cast<const unsigned char*>(xw) + (c0 / kc) * L.chunk +
                         wgn::swz(row * span + col * 2, span));
      wgn::wgmma_step<N>(acc, a, wgn::b_desc<N>(smem + L.w + (ph.j + s * i) * L.tap +
                                                c0 * N * 2));
    };
    unsigned a0[4], a1[4];
    for (int si = 0; si < steps; si += 2) {
      step(si, a0);
      if (si + 1 < steps) step(si + 1, a1);
    }
    wgn::wgmma_drain<N>(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + m0 + g + 8 * h;
      if (t >= u.T_in) continue;
      const size_t row = (size_t)b * rows_out + (size_t)s * t + phi;
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        float y0 = 0.f, y1 = 0.f;
        if (t < len) {
          y0 = acc[4 * q + 2 * h] + bias[q][0];
          y1 = acc[4 * q + 2 * h + 1] + bias[q][1];
        }
        if (u.round) {
          y0 = bf16_round(y0);
          y1 = bf16_round(y1);
        }
        store_pair<N>(u, row * N + 8 * q + 2 * tq, y0, y1);
      }
    }
  }
}

template <int N, int NW>
cudaError_t launch(const void* x, const void* w, const Up& u, int B, cudaStream_t stream) {
  const wgn::UpSmem L(N, u.C_in, u.k, u.rows);
  if (L.total > kMaxSmemBytes) return cudaErrorInvalidValue;
  const int kc = u.C_in < 64 ? u.C_in : 64;
  CUtensorMap xmap, wmap;
  {  // x as (C_in, T_in, B) bf16; a box of KC channels x the window's rows x 1 row
    const cuuint64_t dims[3] = {(cuuint64_t)u.C_in, (cuuint64_t)u.T_in, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)u.C_in * 2, (cuuint64_t)u.T_in * u.C_in * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kc, (cuuint32_t)u.rows, 1};
    if (!wgn::encode_bf16(&xmap, x, 3, dims, strides, box)) return cudaErrorInvalidValue;
  }
  {  // w as (C_out, k * C_in) bf16; one box a tap: N columns x C_in rows
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)u.k * u.C_in};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
    const cuuint32_t box[2] = {(cuuint32_t)N, (cuuint32_t)u.C_in};
    if (!wgn::encode_bf16(&wmap, w, 2, dims, strides, box)) return cudaErrorInvalidValue;
  }
  cudaError_t err = vk_set_smem_once<wgmma_upsample_kernel<N, NW>>(L.total);
  if (err != cudaSuccess) return err;
  const dim3 grid((u.T_in + 64 * NW - 1) / (64 * NW), B);
  wgmma_upsample_kernel<N, NW><<<grid, 128 * NW, L.total, stream>>>(xmap, wmap, u);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_nw(int nw, const void* x, const void* w, const Up& u, int B,
                      cudaStream_t stream) {
  return nw == 1 ? launch<N, 1>(x, w, u, B, stream) : launch<N, 2>(x, w, u, B, stream);
}

}  // namespace

// y (B, T_in * stride, C_out) = round(mask(ConvTranspose1d(leaky(x), w) + bias)) at
// the kFast tier, for bf16 x (B, T_in, C_in) and the loader's spatially reversed
// bf16 w (k, C_in, C_out): y bf16 with out16, else fp32; rows at and past
// lengths[b] * stride zero; round the bf16 value carry. C_in a multiple of 16 (at
// most 256), C_out 16, 32 or 64, nw (warpgroups of 64 input rows a block: 1 or 2)
// from ops/cuda/stage.py::upsample_plan, whose window (64 * nw + the phases'
// reach) is at most 256 rows.
VK_EXPORT int vk_upsample_wgmma(const void* x, void* y, int out16, const void* w,
                                const float* bias, const int* lengths, int B, int T_in, int C_in,
                                int C_out, int k, int stride, int pad, float slope, int round,
                                int nw, void* stream) {
  if (B < 1 || T_in < 1 || C_in < 16 || C_in > 256 || C_in % 16 || stride < 1 || k < 1 ||
      pad < 0 || (nw != 1 && nw != 2) || (C_out != 16 && C_out != 32 && C_out != 64))
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(y) || misaligned(w) || misaligned(bias))
    return cudaErrorMisalignedAddress;
  int lo = 0, hi = 0;  // the phases' reach: input rows t + lo .. t + hi
  for (int phi = 0; phi < stride; ++phi) {
    const Phase ph = phase(phi, k, stride, pad);
    lo = -ph.o < lo ? -ph.o : lo;
    hi = ph.n - 1 - ph.o > hi ? ph.n - 1 - ph.o : hi;
  }
  Up u{lengths, bias, out16 ? nullptr : static_cast<float*>(y),
       out16 ? static_cast<__nv_bfloat16*>(y) : nullptr, T_in, C_in, k, stride, pad, lo,
       64 * nw + hi - lo, slope, round};
  if (u.rows > 256) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C_out) {
    case 16:
      return launch_nw<16>(nw, x, w, u, B, s);
    case 32:
      return launch_nw<32>(nw, x, w, u, B, s);
    default:
      return launch_nw<64>(nw, x, w, u, B, s);
  }
}
