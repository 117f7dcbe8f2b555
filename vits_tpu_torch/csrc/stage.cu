// HiFiGAN narrow stage: leaky -> ConvTranspose1d + bias -> zero outside
// [0, len*stride) -> mean of the resblocks -> (terminal stage) leaky(0.01) ->
// conv_post -> tanh -> zero outside [0, len*stride) -> waveform.
//
// Replaces vits_tpu/ops/pallas/stage.py::fused_stage (_stage_kernel), which
// runs the whole stage on one VMEM window with 128-lane time packing. Here a
// stage is three kinds of launch, driven by vits_tpu_torch/ops/cuda/stage.py:
// upsample_kernel below, the resblock convs of resblock_trio.cu (conv_gemm.cuh's conv_kernel
// on the tensor cores at C_out = 64, 32 on MMS stages 2-3; narrow_conv_kernel
// at C_out = 16, 8 on HiFi-GAN V2's), and wave_kernel below for the terminal
// conv_post. No packing: the channels map onto MMA tiles and threads directly.
// At the `fast` tier on bf16 packs (bf16 values) the routes are Hopper's
// (ops/cuda/stage.py::stage_routes): the upsampler on upsample_wgmma.cu wherever
// C_out is 16, 32 or 64, the resblocks at 64 channels on conv_wgmma.cuh and at
// 32 on pair_wgmma.cu (one launch a pair); upsample_kernel keeps the `high` and
// `exact` tiers, int8 packs, fp32 values and C_out 8, and wave_kernel every tier.
//
// What bounds a stage on an H100: bytes, below ~295 operations a byte. At `fast`
// MMS's 64->32 stage for 320 frames does 21 GFLOP of resblock products (0.022 ms
// at 989 TFLOP/s, 0.13 ms at the fp32-accurate 165) against its activations: on
// the two-launch route every conv moved its fp32 input, residual and output
// (10.5 MB apiece, ~470 MB a stage, ~0.14 ms of HBM); on the pair route a pair
// reads and writes bf16 once and keeps y1 on chip. The upsampler and conv_post
// read their input once and write their output once (16 MB and 11 MB at MMS
// stage 2 and 3, 3-5 us at 3.35 TB/s), against 1.3 GFLOP of upsampler products.
//
// upsample_kernel: the ConvTranspose1d as a polyphase implicit GEMM. With
// pe = k - 1 - pad, output row v = s*t + phi takes only the taps
// j = j_phi + s*i (j_phi = (pe - phi) mod s, i < n_phi = ceil((k - j_phi)/s))
// of input row t + i - o_phi (o_phi = (pe - phi - j_phi)/s), so each phase is
// a plain Conv1d over the input steps and no tap off the stride grid is ever
// multiplied; the mask v < len*s is t < len. One block is one phase (in the
// grid) x 64 input steps x up to 64 out-channels: narrow_gemm.cuh's 3xTF32
// tile (shape (a): a kernel of its own, not conv_kernel with strides, so that
// kernel B's launches stay as they are). C_out = 8, 16 fill one and two n8
// tiles; any C_in is zero-padded to a multiple of 8.
//
// wave_kernel: one thread per 4 consecutive samples, the leaky(h) window
// staged channel-major in shared memory by 16-byte loads, so that a thread
// reads its 4 + k - 1 rows of a channel as float4 (conflict-free) and reuses
// each for all k taps. A block whose samples all lie past the length writes
// zeros without loading anything; a thread past the length writes zeros.
//
// Precision tiers: the upsampler takes the narrow tile's (M, weight format,
// int8 scale on the sum, and with round the bf16 value carry of its output);
// wave_kernel multiplies in fma_tier<M>'s arithmetic, its bf16 or int8
// weights converted as they are staged, an int8 sum times its one scale.
//
// bf16 serving (compute16; the JAX package runs no stage kernel at
// compute_dtype="bfloat16", so this is XLA's bf16 graph of the plain stage):
// the upsampler reads bf16 x and writes bf16, rounding as the bf16 per-phase
// transposed conv does (per tap when k % stride == 0, narrow_gemm.cuh's
// per_tap; else once), then + bias and the mask; the resblocks are the bf16
// conv of resblock_trio.cu (vk_conv_bf16); wave_kernel reads bf16 h and
// writes a bf16 waveform: leaky at the bf16 slope, the conv's sum rounded,
// tanh rounded, the mask.
#include <math.h>

#include "narrow_gemm.cuh"

namespace {

constexpr int kWaveThreads = 128;
constexpr int kWaveSamples = 4;                           // per thread
constexpr int kWaveTile = kWaveThreads * kWaveSamples;    // samples per block
constexpr int kMaxPostTaps = 13;
constexpr int kWaveRows = kWaveTile + 4 * ((kMaxPostTaps + 6) / 4);  // window row stride

// Phase phi of a stride-s ConvTranspose1d of k taps and padding pad.
struct Phase {
  int j, n, o;  // first weight tap, taps, input offset
};
__host__ __device__ inline Phase phase_of(int phi, int k, int s, int pad) {
  const int pe = k - 1 - pad;
  int j = (pe - phi) % s;
  if (j < 0) j += s;
  return {j, (k - j + s - 1) / s, (pe - phi - j) / s};
}

template <int NT, int M>
__global__ void __launch_bounds__(narrow::kWarps * 32)
    upsample_kernel(const narrow::Conv c, int k, int stride, int pad) {
  extern __shared__ __align__(16) float smem[];
  const int chunks = (c.C_out + narrow::kCols - 1) / narrow::kCols;
  const int phi = blockIdx.y / chunks;
  const int co0 = (blockIdx.y - phi * chunks) * narrow::kCols;
  const Phase ph = phase_of(phi, k, stride, pad);
  narrow::conv_tile<NT, M>(c, smem, blockIdx.z, blockIdx.x * narrow::kBM, co0, ph.n, ph.o,
                           ph.j, phi);
}

// The upsampler of bf16 serving (narrow_gemm.cuh::conv_tile16, per_tap).
template <int NT>
__global__ void __launch_bounds__(narrow::kWarps * 32)
    upsample16_kernel(const narrow::Conv16 c, int k, int stride, int pad) {
  extern __shared__ __align__(16) float smem[];
  const int chunks = (c.C_out + narrow::kCols - 1) / narrow::kCols;
  const int phi = blockIdx.y / chunks;
  const int co0 = (blockIdx.y - phi * chunks) * narrow::kCols;
  const Phase ph = phase_of(phi, k, stride, pad);
  narrow::conv_tile16<NT>(c, smem, blockIdx.z, blockIdx.x * narrow::kBM, co0, ph.n, ph.o, ph.j,
                          phi);
}

// wave[t] = tanh(sum_j sum_c leaky(h[t + j - pad][c], slope) * w[j][c] (* wscale))
// for t < lengths[b] * len_scale, else 0. w is conv_post's (k, C, 1) kernel in
// the format wfmt, no bias; wscale its one int8 scale (null otherwise).
// With kIO16 (bf16 serving) h and wave are bf16 (h16, wave16) and the sum and
// tanh are rounded to bf16.
template <int M, bool kIO16>
__global__ void __launch_bounds__(kWaveThreads)
    wave_kernel(const float* __restrict__ h, float* __restrict__ wave,
                const void* __restrict__ w, const int* __restrict__ lengths, int T, int C,
                int k, int pad, int len_scale, float slope, int vec, int wfmt,
                const float* __restrict__ wscale, const __nv_bfloat16* __restrict__ h16,
                __nv_bfloat16* __restrict__ wave16) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                   // C x kWaveRows: row r <-> position t0 - pad + r
  float* ws = smem + C * kWaveRows;   // k x C
  const int t0 = blockIdx.x * kWaveTile;
  const int b = blockIdx.y;
  const int valid = lengths[b] * len_scale;
  float* wb = wave + (size_t)b * T;
  __nv_bfloat16* wb16 = wave16 + (size_t)b * T;
  const int tid = threadIdx.x;
  const int ts = t0 + kWaveSamples * tid;
  if (t0 >= valid) {  // the whole tile is padding
    for (int u = 0; u < kWaveSamples; ++u)
      if (ts + u < T) {
        if constexpr (kIO16)
          wb16[ts + u] = __float2bfloat16_rn(0.f);
        else
          wb[ts + u] = 0.f;
      }
    return;
  }
  const int rows = kWaveTile + k - 1;
  const float* hb = h + (size_t)b * T * C;
  if constexpr (kIO16) {  // bf16 h: load, widen, leaky
    const __nv_bfloat16* hb16 = h16 + (size_t)b * T * C;
    for (int idx = tid; idx < rows * C; idx += kWaveThreads) {
      const int c = idx / rows, r = idx - c * rows;
      const int p = t0 - pad + r;
      hs[c * kWaveRows + r] = p >= 0 && p < T ? vk_leaky(ldf(hb16 + (size_t)p * C + c), slope) : 0.f;
    }
  } else if (vec) {  // row fastest: a warp writes 32 consecutive rows of one channel
    for (int idx = tid; idx < rows * (C / 4); idx += kWaveThreads) {
      const int c4 = idx / rows, r = idx - c4 * rows;
      const int p = t0 - pad + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p >= 0 && p < T) v = __ldg(reinterpret_cast<const float4*>(hb + (size_t)p * C + 4 * c4));
      hs[(4 * c4 + 0) * kWaveRows + r] = vk_leaky(v.x, slope);
      hs[(4 * c4 + 1) * kWaveRows + r] = vk_leaky(v.y, slope);
      hs[(4 * c4 + 2) * kWaveRows + r] = vk_leaky(v.z, slope);
      hs[(4 * c4 + 3) * kWaveRows + r] = vk_leaky(v.w, slope);
    }
  } else {
    for (int idx = tid; idx < rows * C; idx += kWaveThreads) {
      const int c = idx / rows, r = idx - c * rows;
      const int p = t0 - pad + r;
      hs[c * kWaveRows + r] = p >= 0 && p < T ? vk_leaky(__ldg(hb + (size_t)p * C + c), slope) : 0.f;
    }
  }
  for (int idx = tid; idx < k * C; idx += kWaveThreads)
    ws[idx] = wfmt == kW16 ? wvalue(static_cast<const __nv_bfloat16*>(w)[idx])
              : wfmt == kW8 ? wvalue(static_cast<const signed char*>(w)[idx])
                            : static_cast<const float*>(w)[idx];
  __syncthreads();

  float acc[kWaveSamples] = {0.f, 0.f, 0.f, 0.f};
  if (ts < valid) {
    const int nq = (kWaveSamples + k - 1 + 3) / 4;  // float4 rows a thread reads
    for (int c = 0; c < C; ++c) {
      float x[4 * ((kMaxPostTaps + 6) / 4)];
      const float* row = hs + c * kWaveRows + kWaveSamples * tid;
#pragma unroll
      for (int q = 0; q < (kMaxPostTaps + 6) / 4; ++q) {
        if (q < nq) {
          const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
          x[4 * q] = v.x;
          x[4 * q + 1] = v.y;
          x[4 * q + 2] = v.z;
          x[4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxPostTaps; ++j) {
        if (j < k) {
          const float wj = ws[j * C + c];
#pragma unroll
          for (int u = 0; u < kWaveSamples; ++u) acc[u] = fma_tier<M>(x[u + j], wj, acc[u]);
        }
      }
    }
  }
  const float sq = wscale ? *wscale : 1.f;
  for (int u = 0; u < kWaveSamples; ++u) {
    if (ts + u >= T) continue;
    if constexpr (kIO16)
      wb16[ts + u] = __float2bfloat16_rn(ts + u < valid ? tanhf(bf16_round(acc[u])) : 0.f);
    else
      wb[ts + u] = ts + u < valid ? tanhf(acc[u] * sq) : 0.f;
  }
}

template <int NT, int M>
cudaError_t launch_upsample(const narrow::Conv& c, int B, int k, int stride, int pad,
                            cudaStream_t stream) {
  int taps = 0;
  for (int phi = 0; phi < stride; ++phi) {
    const int n = phase_of(phi, k, stride, pad).n;
    taps = n > taps ? n : taps;
  }
  const int smem = narrow::smem_floats(NT, taps, 1, c.C_in) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(upsample_kernel<NT, M>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (c.C_out + narrow::kCols - 1) / narrow::kCols;
  const dim3 grid((c.T + narrow::kBM - 1) / narrow::kBM, stride * chunks, B);
  upsample_kernel<NT, M><<<grid, narrow::kWarps * 32, smem, stream>>>(c, k, stride, pad);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_upsample_tiles(const narrow::Conv& c, int B, int k, int stride, int pad,
                                  cudaStream_t s) {
  switch (narrow::tiles_for(c.C_out)) {
    case 1:
      return launch_upsample<1, M>(c, B, k, stride, pad, s);
    case 2:
      return launch_upsample<2, M>(c, B, k, stride, pad, s);
    case 4:
      return launch_upsample<4, M>(c, B, k, stride, pad, s);
    default:
      return launch_upsample<8, M>(c, B, k, stride, pad, s);
  }
}

template <int NT>
cudaError_t launch_upsample16(const narrow::Conv16& c, int B, int k, int stride, int pad,
                              cudaStream_t stream) {
  int taps = 0;
  for (int phi = 0; phi < stride; ++phi) {
    const int n = phase_of(phi, k, stride, pad).n;
    taps = n > taps ? n : taps;
  }
  const int smem = narrow::smem_floats(NT, taps, 1, c.C_in) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(upsample16_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (c.C_out + narrow::kCols - 1) / narrow::kCols;
  const dim3 grid((c.T + narrow::kBM - 1) / narrow::kBM, stride * chunks, B);
  upsample16_kernel<NT><<<grid, narrow::kWarps * 32, smem, stream>>>(c, k, stride, pad);
  return cudaGetLastError();
}

template <int M, bool kIO16 = false>
cudaError_t launch_wave(const void* h, void* wave, const void* w, const int* lengths, int B,
                        int T, int C, int k, int pad, int len_scale, float slope, int wfmt,
                        const float* wscale, cudaStream_t stream) {
  const int smem = (C * kWaveRows + k * C) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(wave_kernel<M, kIO16>, smem);
  if (err != cudaSuccess) return err;
  const int vec = !kIO16 && C % 4 == 0 && reinterpret_cast<size_t>(h) % 16 == 0;
  const dim3 grid((T + kWaveTile - 1) / kWaveTile, B);
  const float* h32 = kIO16 ? nullptr : static_cast<const float*>(h);
  const __nv_bfloat16* h16 = kIO16 ? static_cast<const __nv_bfloat16*>(h) : nullptr;
  float* w32 = kIO16 ? nullptr : static_cast<float*>(wave);
  __nv_bfloat16* w16 = kIO16 ? static_cast<__nv_bfloat16*>(wave) : nullptr;
  wave_kernel<M, kIO16><<<grid, kWaveThreads, smem, stream>>>(
      h32, w32, w, lengths, T, C, k, pad, len_scale, slope, vec, wfmt, wscale, h16, w16);
  return cudaGetLastError();
}

}  // namespace

// y (B, T_in*stride, C_out) = ConvTranspose1d(leaky(x), w) (* wscale) + bias,
// zero at output rows >= lengths[b]*stride, with round rounded to bf16, for x
// (B, T_in, C_in) and the loader's spatially reversed w (k, C_in, C_out) in
// the format wfmt (wscale: int8's (C_out,) scales), all contiguous, at the
// tier mode. With compute16 (bf16 serving: mode kFast, bf16 weights) x, y and
// bias are bf16 and y is XLA's bf16 graph of the upsampler, each tap's sum
// rounded with per_tap (k % stride == 0: the per-phase form).
VK_EXPORT int vk_upsample(const void* x, void* y, const void* w, const void* bias,
                          const int* lengths, int B, int T_in, int C_in, int C_out, int k,
                          int stride, int pad, float slope, int mode, int wfmt,
                          const float* wscale, int round, int compute16, int per_tap,
                          void* stream) {
  if (C_in < 1 || C_out < 1 || stride < 1 || k < 1 || pad < 0 || T_in < 1 || B < 1 ||
      mode < kExact || mode > kHigh || wfmt < kW32 || wfmt > kW8 ||
      (wfmt == kW8) != (wscale != nullptr) ||
      (compute16 && (mode != kFast || wfmt != kW16 || round)) || (per_tap && !compute16))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute16) {
    const narrow::Conv16 c{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
                           static_cast<const __nv_bfloat16*>(w), nullptr,
                           static_cast<const __nv_bfloat16*>(bias), nullptr, lengths, T_in, T_in,
                           C_in, C_out, 1, stride, stride, slope, 0, 1.f, per_tap};
    switch (narrow::tiles_for(C_out)) {
      case 1:
        return launch_upsample16<1>(c, B, k, stride, pad, s);
      case 2:
        return launch_upsample16<2>(c, B, k, stride, pad, s);
      case 4:
        return launch_upsample16<4>(c, B, k, stride, pad, s);
      default:
        return launch_upsample16<8>(c, B, k, stride, pad, s);
    }
  }
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  narrow::Conv c{static_cast<const float*>(x), static_cast<float*>(y), w,
                 static_cast<const float*>(bias), nullptr, lengths, T_in, T_in, C_in, C_out,
                 1, stride, stride, slope, 0, 1.f,
                 C_in % 4 == 0 && aligned(x), C_out % 4 == 0 && aligned(w)};
  c.wfmt = wfmt;
  c.wscale = wscale;
  c.round = round;
  switch (mode) {
    case kExact:
      return launch_upsample_tiles<kExact>(c, B, k, stride, pad, s);
    case kFast:
      return launch_upsample_tiles<kFast>(c, B, k, stride, pad, s);
    default:
      return launch_upsample_tiles<kHigh>(c, B, k, stride, pad, s);
  }
}

// wave (B, T) = tanh(conv_post(leaky(h))) (* wscale), zero at t >= lengths[b] *
// len_scale, for h (B, T, C) and conv_post's (k, C, 1) weight in the format
// wfmt, at the tier mode. With compute16 (bf16 serving: kFast, bf16 weights)
// h and wave are bf16 and the sum and tanh are rounded to bf16.
VK_EXPORT int vk_wave(const void* h, void* wave, const void* w, const int* lengths, int B,
                      int T, int C, int k, int pad, int len_scale, float slope, int mode,
                      int wfmt, const float* wscale, int compute16, void* stream) {
  if (C < 1 || k < 1 || k > kMaxPostTaps || T < 1 || B < 1 || wfmt < kW32 || wfmt > kW8 ||
      (wfmt == kW8) != (wscale != nullptr) || (compute16 && (mode != kFast || wfmt != kW16)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute16)
    return launch_wave<kFast, true>(h, wave, w, lengths, B, T, C, k, pad, len_scale, slope,
                                    wfmt, wscale, s);
  switch (mode) {
    case kExact:
      return launch_wave<kExact>(h, wave, w, lengths, B, T, C, k, pad, len_scale, slope, wfmt,
                                 wscale, s);
    case kFast:
      return launch_wave<kFast>(h, wave, w, lengths, B, T, C, k, pad, len_scale, slope, wfmt,
                                wscale, s);
    case kHigh:
      return launch_wave<kHigh>(h, wave, w, lengths, B, T, C, k, pad, len_scale, slope, wfmt,
                                wscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
