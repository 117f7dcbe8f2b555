// HiFiGAN narrow stage: leaky -> ConvTranspose1d + bias -> zero outside
// [0, len*stride) -> mean of the resblocks -> (terminal stage) leaky(0.01) ->
// conv_post -> tanh -> zero outside [0, len*stride) -> waveform.
//
// Replaces vits_tpu/ops/pallas/stage.py::fused_stage (_stage_kernel), which
// runs the whole stage on one VMEM window with 128-lane time packing. Here a
// stage is three kinds of launch, driven by vits_tpu_torch/ops/cuda/stage.py:
// upsample_kernel below, the resblock conv kernel of resblock_trio.cu for the
// resblocks, and wave_kernel below for the terminal conv_post. No packing: the
// narrow channels map onto threads directly -- C_out = 64, 32 on MMS stages
// 2-3 and C_out = 16, 8 on HiFi-GAN V2's (the resblock convs then take the
// direct narrow path of resblock_trio.cu); the upsampler takes any C_out that
// divides 128 (4 out-channels a thread, or 1 below 4).
//
// What bounds it on an H100: the resblock convs (fp32 FFMA, as in
// resblock_trio.cu). The upsampler does k/stride taps of C_in x C_out per
// output step (2 x 128 x 64 at MMS stage 2) and conv_post 7 x 32 per sample;
// both are small next to the 126 resblock taps of C_out x C_out and read their
// input once through a shared-memory window.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // output steps per thread
constexpr int kWaveTile = 256;

// y[v] = bias + sum_j x_d[v + j - pe] @ w[j], with x_d the stride-dilated
// leaky(x) and pe = k - 1 - pad (w is the loader's spatially reversed kernel,
// so this is torch's ConvTranspose1d). Output steps v >= len*stride are zero.
// Each thread owns CO (4 or 1) output channels.
template <int CO>
__global__ void __launch_bounds__(kThreads)
    upsample_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    const int* __restrict__ lengths, int T_in, int C_in, int C_out, int k,
                    int stride, int pad, float slope) {
  extern __shared__ float smem[];
  const int cg = C_out / CO;
  const int tile = (kThreads / cg) * kRows;
  const int T_out = T_in * stride;
  const int pe = k - 1 - pad;
  const int v0 = blockIdx.x * tile;
  const int b = blockIdx.y;
  const int t_lo = vk_floordiv(v0 - pe, stride);
  const int t_hi = vk_floordiv(v0 + tile - 1 + k - 1 - pe, stride);
  const int rows = t_hi - t_lo + 1;
  const int S = C_in + 1;
  const float* xb = x + (size_t)b * T_in * C_in;
  for (int idx = threadIdx.x; idx < rows * C_in; idx += kThreads) {
    const int r = idx / C_in;
    const int c = idx - r * C_in;
    const int t = t_lo + r;
    smem[r * S + c] = (t >= 0 && t < T_in) ? vk_leaky(xb[(size_t)t * C_in + c], slope) : 0.f;
  }
  __syncthreads();

  const int co = (threadIdx.x % cg) * CO;
  const int vbase = v0 + (threadIdx.x / cg) * kRows;
  float acc[kRows][CO];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  for (int j = 0; j < k; ++j) {
    int off[kRows];
    bool use[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = vbase + i + j - pe;
      const int t = vk_floordiv(m, stride);
      use[i] = m == t * stride;
      off[i] = (t - t_lo) * S;
    }
    const float* wt = w + (size_t)j * C_in * C_out + co;
    for (int ci = 0; ci < C_in; ++ci) {
      float wv[CO];
      if constexpr (CO == 4) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * C_out));
        wv[0] = w4.x;
        wv[1] = w4.y;
        wv[2] = w4.z;
        wv[3] = w4.w;
      } else {
        wv[0] = __ldg(wt + (size_t)ci * C_out);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (!use[i]) continue;
        const float v = smem[off[i] + ci];
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
      }
    }
  }
  const int len_out = lengths[b] * stride;
  float* yb = y + (size_t)b * T_out * C_out;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int v = vbase + i;
    if (v >= T_out) break;
#pragma unroll
    for (int c = 0; c < CO; ++c)
      yb[(size_t)v * C_out + co + c] = v < len_out ? acc[i][c] + bias[co + c] : 0.f;
  }
}

// wave[t] = tanh(sum_j sum_c leaky(h[t + j - pad][c], slope) * w[j][c]) for
// t < lengths[b] * len_scale, else 0. w is conv_post's (k, C, 1) kernel, no bias.
__global__ void __launch_bounds__(kWaveTile)
    wave_kernel(const float* __restrict__ h, float* __restrict__ wave,
                const float* __restrict__ w, const int* __restrict__ lengths, int T, int C,
                int k, int pad, int len_scale, float slope) {
  extern __shared__ float smem[];
  const int S = C + 1;  // consecutive threads read consecutive rows: no bank conflicts
  const int rows = kWaveTile + k - 1;
  float* hs = smem;
  float* ws = smem + rows * S;
  const int t0 = blockIdx.x * kWaveTile;
  const int b = blockIdx.y;
  const float* hb = h + (size_t)b * T * C;
  for (int idx = threadIdx.x; idx < rows * C; idx += kWaveTile) {
    const int r = idx / C;
    const int c = idx - r * C;
    const int p = t0 - pad + r;
    hs[r * S + c] = (p >= 0 && p < T) ? vk_leaky(hb[(size_t)p * C + c], slope) : 0.f;
  }
  for (int idx = threadIdx.x; idx < k * C; idx += kWaveTile) ws[idx] = w[idx];
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const float* row = hs + (threadIdx.x + j) * S;
    const float* wj = ws + j * C;
    for (int c = 0; c < C; ++c) acc = fmaf(row[c], wj[c], acc);
  }
  wave[(size_t)b * T + t] = t < lengths[b] * len_scale ? tanhf(acc) : 0.f;
}

int upsample_smem(int C_in, int C_out, int co, int k, int stride) {
  const int tile = (kThreads / (C_out / co)) * kRows;
  const int rows = (tile - 1 + k - 1) / stride + 2;  // bound on t_hi - t_lo + 1
  return rows * (C_in + 1) * static_cast<int>(sizeof(float));
}

template <int CO>
cudaError_t launch_upsample(const float* x, float* y, const float* w, const float* bias,
                            const int* lengths, int B, int T_in, int C_in, int C_out, int k,
                            int stride, int pad, float slope, cudaStream_t stream) {
  if (kThreads % (C_out / CO)) return cudaErrorInvalidValue;
  const int smem = upsample_smem(C_in, C_out, CO, k, stride);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(upsample_kernel<CO>, smem);
  if (err != cudaSuccess) return err;
  const int tile = (kThreads / (C_out / CO)) * kRows;
  const dim3 grid((T_in * stride + tile - 1) / tile, B);
  upsample_kernel<CO><<<grid, kThreads, smem, stream>>>(x, y, w, bias, lengths, T_in, C_in,
                                                        C_out, k, stride, pad, slope);
  return cudaGetLastError();
}

}  // namespace

VK_EXPORT int vk_upsample(const float* x, float* y, const float* w, const float* bias,
                          const int* lengths, int B, int T_in, int C_in, int C_out, int k,
                          int stride, int pad, float slope, void* stream) {
  if (C_in < 1 || C_out < 1 || stride < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C_out % 4 == 0) {
    return launch_upsample<4>(x, y, w, bias, lengths, B, T_in, C_in, C_out, k, stride, pad,
                              slope, s);
  }
  return launch_upsample<1>(x, y, w, bias, lengths, B, T_in, C_in, C_out, k, stride, pad, slope,
                            s);
}

VK_EXPORT int vk_wave(const float* h, float* wave, const float* w, const int* lengths, int B,
                      int T, int C, int k, int pad, int len_scale, float slope, void* stream) {
  const int smem = ((kWaveTile + k - 1) * (C + 1) + k * C) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(wave_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kWaveTile - 1) / kWaveTile, B);
  wave_kernel<<<grid, kWaveTile, smem, static_cast<cudaStream_t>(stream)>>>(
      h, wave, w, lengths, T, C, k, pad, len_scale, slope);
  return cudaGetLastError();
}
