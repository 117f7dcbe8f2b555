// HiFiGAN resblock convs: y = mask(conv(leaky(x)) + bias [+ residual]).
//
// Replaces vits_tpu/ops/pallas/resblock.py::fused_resblock_trio (_trio_kernel),
// which runs the mean of three resblocks (3 pairs each) on one VMEM window.
// Here every pair of the trio is two launches of conv_kernel below, driven by
// vits_tpu_torch/ops/cuda/resblock.py:
//   conv1: y1 = zero outside [0, len) of (dilated conv(leaky(x)) + b1)
//   conv2: y  = zero outside [0, len) of (x + conv(leaky(y1)) + b2)
// and the last pair of each resblock folds y into the running mean
// (accumulate/scale). The stage kernel (stage.cu) reuses the same launches.
//
// What bounds it on an H100: fp32 FFMA. A stage does 2*k*C*C multiply-adds per
// conv per time step, 126 taps of C x C for k = 3/7/11 -- 42 GFLOP per row at
// C=256, T=2560 and 85 GFLOP at C=128, T=20480 -- against 67 TFLOP/s of fp32
// outside the tensor cores. Bytes are minor: a trio makes 18 conv passes, each
// reading its input once (plus a (k-1)*dilation halo per tile) and writing its
// output once; at C=128, T=20480 a pass is 10.5 MB, about 3 us of HBM time.
//
// Design: one block of 128 threads per (time tile, 64 or 32 out-channels,
// row). The input channels go in chunks of 16: the block stages the chunk's
// leaky(x) window (tile + (k-1)*dilation rows) in shared memory, and streams
// the chunk's weights tap by tap through a double-buffered shared tile filled
// with cp.async while the previous tap computes. Each thread keeps an
// R-row x 8-channel fp32 accumulator: per input channel it reads R window
// values (broadcast) and two float4 of weights for 8*R FMAs. The rows of a
// thread are strided by the number of time groups, so the groups of one warp
// read neighbouring rows, on different banks. wgmma/TMA, bf16 and a one-launch
// pair are later work.
//
// Narrow channels (C_in % 16 or C_out % 32, i.e. C = 1 .. 16 on the vocoder's
// narrow stages: kernel 7, vits_tpu/ops/pallas/resblock.py::fused_resblock,
// and the C_out = 16, 8 tail of kernel C) take narrow_conv_kernel instead: a
// direct convolution, one thread per (time step, out-channel) output at a
// time, the whole (k, C_in, C_out) weight and the block's leaky(x) window in
// shared memory. At C = 16 a conv is 2*k*256 FLOP per step, so these stages
// are small; a tiled narrow path is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKc = 16;         // input channels per chunk
constexpr int kAs = kKc + 1;    // window row stride (floats): odd, so rows hit distinct banks
constexpr int kCoThread = 8;    // out-channels per thread: two float4 halves

// Geometry of one CO_T x (groups * R) output tile.
template <int CO_T, int R>
struct Tile {
  static constexpr int co_threads = CO_T / kCoThread;     // threads across out-channels
  static constexpr int groups = kThreads / co_threads;    // time groups
  static constexpr int rows = groups * R;                 // output steps per block
  static constexpr int w_floats = kKc * CO_T;             // one weight tile
};

template <int CO_T, int R>
__global__ void __launch_bounds__(kThreads)
    conv_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ residual, const int* __restrict__ lengths, int T,
                int C_in, int C_out, int k, int dil, int pad, float slope, int accumulate,
                float scale) {
  using G = Tile<CO_T, R>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                    // 2 x (kKc x CO_T) weight tiles
  float* as = smem + 2 * G::w_floats;  // (rows + (k-1)*dil) x kAs window chunk
  const int t0 = blockIdx.x * G::rows;
  const int co0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int win = G::rows + (k - 1) * dil;
  const float* xb = x + (size_t)b * T * C_in;
  const int ct = threadIdx.x % G::co_threads;
  const int tg = threadIdx.x / G::co_threads;

  auto load_w = [&](int step, int buf) {
    const int chunk = step / k, tap = step - chunk * k;
    const float* src = w + ((size_t)tap * C_in + chunk * kKc) * C_out + co0;
    float* dst = ws + buf * G::w_floats;
    for (int idx = threadIdx.x; idx < G::w_floats / 4; idx += kThreads) {
      const int kc = idx / (CO_T / 4), c4 = idx - kc * (CO_T / 4);
      cp_async16(dst + kc * CO_T + c4 * 4, src + (size_t)kc * C_out + c4 * 4);
    }
    cp_async_commit();
  };

  float acc[R][kCoThread];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < kCoThread; ++c) acc[i][c] = 0.f;

  const int steps = (C_in / kKc) * k;
  load_w(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int chunk = step / k, tap = step - chunk * k;
    if (tap == 0) {  // next input-channel chunk: window row r <-> position t0 - pad + r
      const int ci0 = chunk * kKc;
      for (int idx = threadIdx.x; idx < win * kKc; idx += kThreads) {
        const int r = idx / kKc, kc = idx - r * kKc;
        const int p = t0 - pad + r;
        as[r * kAs + kc] =
            (p >= 0 && p < T) ? vk_leaky(xb[(size_t)p * C_in + ci0 + kc], slope) : 0.f;
      }
    }
    if (step + 1 < steps) {
      load_w(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a = as + tap * dil * kAs;
    const float* wt = ws + (step & 1) * G::w_floats + ct * 4;
#pragma unroll 4
    for (int kc = 0; kc < kKc; ++kc) {
      const float4 w0 = *reinterpret_cast<const float4*>(wt + kc * CO_T);
      const float4 w1 = *reinterpret_cast<const float4*>(wt + kc * CO_T + CO_T / 2);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float v = a[(tg + i * G::groups) * kAs + kc];
        acc[i][0] = fmaf(v, w0.x, acc[i][0]);
        acc[i][1] = fmaf(v, w0.y, acc[i][1]);
        acc[i][2] = fmaf(v, w0.z, acc[i][2]);
        acc[i][3] = fmaf(v, w0.w, acc[i][3]);
        acc[i][4] = fmaf(v, w1.x, acc[i][4]);
        acc[i][5] = fmaf(v, w1.y, acc[i][5]);
        acc[i][6] = fmaf(v, w1.z, acc[i][6]);
        acc[i][7] = fmaf(v, w1.w, acc[i][7]);
      }
    }
    __syncthreads();  // tile (and window) consumed before they are refilled
  }

  float* ob = out + (size_t)b * T * C_out;
  const float* rb = residual ? residual + (size_t)b * T * C_out : nullptr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int co = co0 + half * (CO_T / 2) + ct * 4;
    const float4 bv = *reinterpret_cast<const float4*>(bias + co);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int p = t0 + tg + i * G::groups;
      if (p >= T) continue;
      float4 y = make_float4(acc[i][4 * half + 0] + bv.x, acc[i][4 * half + 1] + bv.y,
                             acc[i][4 * half + 2] + bv.z, acc[i][4 * half + 3] + bv.w);
      const size_t at = (size_t)p * C_out + co;
      if (p >= len) {
        y = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (rb) {
        const float4 r = *reinterpret_cast<const float4*>(rb + at);
        y = make_float4(r.x + y.x, r.y + y.y, r.z + y.z, r.w + y.w);
      }
      float4* o = reinterpret_cast<float4*>(ob + at);
      if (accumulate) {
        const float4 prev = *o;
        y = make_float4(prev.x + y.x, prev.y + y.y, prev.z + y.z, prev.w + y.w);
      }
      *o = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
    }
  }
}

constexpr int kNarrowThreads = 256;
constexpr int kNarrowTile = 256;  // output steps per block

__global__ void __launch_bounds__(kNarrowThreads)
    narrow_conv_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       const float* __restrict__ residual, const int* __restrict__ lengths,
                       int T, int C_in, int C_out, int k, int dil, int pad, float slope,
                       int accumulate, float scale) {
  extern __shared__ float smem[];
  float* ws = smem;                        // (k, C_in, C_out) weights
  float* xs = smem + k * C_in * C_out;     // window row r <-> position t0 - pad + r
  const int win = kNarrowTile + (k - 1) * dil;
  const int t0 = blockIdx.x * kNarrowTile;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const float* xb = x + (size_t)b * T * C_in;
  for (int idx = threadIdx.x; idx < k * C_in * C_out; idx += kNarrowThreads) ws[idx] = w[idx];
  for (int idx = threadIdx.x; idx < win * C_in; idx += kNarrowThreads) {
    const int r = idx / C_in, c = idx - r * C_in;
    const int p = t0 - pad + r;
    xs[idx] = (p >= 0 && p < T) ? vk_leaky(xb[(size_t)p * C_in + c], slope) : 0.f;
  }
  __syncthreads();
  float* ob = out + (size_t)b * T * C_out;
  const float* rb = residual ? residual + (size_t)b * T * C_out : nullptr;
  for (int idx = threadIdx.x; idx < kNarrowTile * C_out; idx += kNarrowThreads) {
    const int t = idx / C_out, co = idx - t * C_out;
    const int p = t0 + t;
    if (p >= T) break;  // idx only grows, and p with it
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float* row = xs + (t + j * dil) * C_in;
      const float* wj = ws + j * C_in * C_out + co;
      for (int ci = 0; ci < C_in; ++ci) acc = fmaf(row[ci], wj[ci * C_out], acc);
    }
    float y = acc + bias[co];
    const size_t at = (size_t)p * C_out + co;
    if (p >= len) {
      y = 0.f;
    } else if (rb) {
      y += rb[at];
    }
    if (accumulate) y += ob[at];
    ob[at] = y * scale;
  }
}

cudaError_t launch_narrow_conv(const float* x, float* out, const float* w, const float* bias,
                               const float* residual, const int* lengths, int B, int T,
                               int C_in, int C_out, int k, int dil, int pad, float slope,
                               int accumulate, float scale, cudaStream_t stream) {
  const int smem =
      (k * C_in * C_out + (kNarrowTile + (k - 1) * dil) * C_in) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(narrow_conv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kNarrowTile - 1) / kNarrowTile, B);
  narrow_conv_kernel<<<grid, kNarrowThreads, smem, stream>>>(
      x, out, w, bias, residual, lengths, T, C_in, C_out, k, dil, pad, slope, accumulate, scale);
  return cudaGetLastError();
}

template <int CO_T, int R>
int conv_smem(int k, int dil) {
  using G = Tile<CO_T, R>;
  return (2 * G::w_floats + (G::rows + (k - 1) * dil) * kAs) * static_cast<int>(sizeof(float));
}

template <int CO_T, int R>
cudaError_t launch_conv(const float* x, float* out, const float* w, const float* bias,
                        const float* residual, const int* lengths, int B, int T, int C_in,
                        int C_out, int k, int dil, int pad, float slope, int accumulate,
                        float scale, cudaStream_t stream) {
  using G = Tile<CO_T, R>;
  const int smem = conv_smem<CO_T, R>(k, dil);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(conv_kernel<CO_T, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + G::rows - 1) / G::rows, C_out / CO_T, B);
  conv_kernel<CO_T, R><<<grid, kThreads, smem, stream>>>(
      x, out, w, bias, residual, lengths, T, C_in, C_out, k, dil, pad, slope, accumulate,
      scale);
  return cudaGetLastError();
}

}  // namespace

VK_EXPORT const char* vk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[b, p] = mask_p(conv(leaky(x))[p] + bias [+ residual[b, p]]) for p < T, where
// conv is torch's Conv1d with this dilation and left padding (right padding the
// same), mask_p zeroes p >= lengths[b], and with accumulate the result is added
// to out; the sum is then multiplied by scale. x (B, T, C_in), w (k, C_in,
// C_out) as the JAX loader lays it out, out/residual (B, T, C_out), all fp32
// and contiguous; the tiled path (C_in % 16 == 0, C_out % 32 == 0) needs
// 16-byte aligned weights and biases, other channel counts take the direct path.
VK_EXPORT int vk_conv(const float* x, float* out, const float* w, const float* bias,
                      const float* residual, const int* lengths, int B, int T, int C_in,
                      int C_out, int k, int dil, int pad, float slope, int accumulate,
                      float scale, void* stream) {
  if (C_in < 1 || C_out < 1 || k < 1 || dil < 1 || T < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C_in % kKc || C_out % 32) {
    return launch_narrow_conv(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k, dil,
                              pad, slope, accumulate, scale, s);
  }
  if (C_out % 64) {
    return launch_conv<32, 8>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k, dil,
                              pad, slope, accumulate, scale, s);
  }
  // Fewer rows per thread when the full tiles would leave SMs idle (C=256 at B=1).
  const int blocks = (T + Tile<64, 8>::rows - 1) / Tile<64, 8>::rows * (C_out / 64) * B;
  if (blocks < 2 * vk_sm_count()) {
    return launch_conv<64, 4>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k, dil,
                              pad, slope, accumulate, scale, s);
  }
  return launch_conv<64, 8>(x, out, w, bias, residual, lengths, B, T, C_in, C_out, k, dil,
                            pad, slope, accumulate, scale, s);
}
