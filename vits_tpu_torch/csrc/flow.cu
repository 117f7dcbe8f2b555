// Reverse residual-coupling flow: one mean-only coupling per call.
//
// Replaces vits_tpu/ops/pallas/flow.py::fused_flow (_flow_kernel), which runs
// all couplings of one batch row on a VMEM-resident sequence, grid (B, n).
// Here vits_tpu_torch/ops/cuda/flow.py calls vk_flow_coupling once per
// coupling (the next one reads the half this one wrote). It launches
// flow_gemm_kernel 2 + 2*nl times, each one product over every frame of the
// batch with its step of the coupling in the epilogue:
//   pre   h    = mask(read @ w_pre + b_pre)                       1x1, half -> hidden
//   per WaveNet layer l (k taps, dilation 1):
//   gate  a    = mask(tanh(g[:hidden]) * sigmoid(g[hidden:])),
//         g    = conv_k(h) @ w_in[l] + b_in[l] + cond[l]           hidden -> 2*hidden
//   res   h    = mask(h + rs[:hidden]);  skip += rs[hidden:],
//         rs   = a @ w_rs[l] + b_rs[l]                             (last layer: skip += rs)
//   post  upd  = mask(upd - (skip @ w_post + b_post))              1x1, hidden -> half
// where mask zeroes frames at and past the row's length. On the flipped steps
// the read half is the second one read backwards and the mean goes backwards
// into the first half (the channel flips of the module, which the JAX package
// folds into packed weights). h, a and skip are (B, T, hidden) buffers of the
// caller; the updated half is written in place.
//
// What bounds it on an H100: fp32 FFMA. At MMS/VCTK width (half 96, hidden
// 192, 4 layers of k=5) a coupling does 2*(96*192 + 4*5*192*384 + 3*192*384
// + 192*192 + 192*96) = 3.6 MFLOP per frame, 14.4 MFLOP per frame over the
// four couplings: 4.6 GFLOP for a 320-frame row, 0.07 ms at 67 TFLOP/s. Its
// bytes are the weights (7.1 MB a coupling, 28 MB in all) and the (T, 192)
// state: about 10 us of HBM time at B=3, T=320. So it is compute-bound.
//
// Design: the inner loop of the resblock conv (resblock_trio.cu). A block of
// 128 threads owns (frame tile, column tile, row); the input channels go in
// chunks of 16, each chunk's window (tile + k-1 frames) and weights staged in
// shared memory through a 3-deep cp.async ring, so a step's loads land while
// the two before it compute. Each thread keeps R frames x 8 columns in
// registers; in the gate and res products its two float4 halves are a column
// and its partner hidden columns on (tanh and sigmoid, res and skip), so the
// epilogue has both. R (8, 4, 2 or 1) is the largest that still gives every
// SM a block: a 320-frame request is latency-bound, and thinner tiles spread
// it. A tile wholly past its row's length skips the products and writes
// zeros. Why not the TPU kernel's shape, one block per time tile running the
// whole WaveNet in shared memory with a 2-frame halo per layer: each block
// then streams all of a coupling's weights from L2 for 8-32 frames of work,
// and measured so it lost to the plain flow (PERF.md §6). Tensor cores and
// one launch for the whole flow are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kKc = 16;       // input channels per chunk
constexpr int kAs = kKc + 1;  // window row stride (floats): odd, so rows hit distinct banks
constexpr int kCoThread = 8;  // columns per thread: two float4 halves
constexpr int kStages = 3;    // chunks in flight

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

enum Mode { kPre, kGate, kRes, kSkip, kPost };

// One product out = epilogue(conv_taps(a) @ w + bias) over (B, T) frames.
struct Gemm {
  const float* a;  // (B, T, lda): channels a_off .. a_off + K of each frame (backwards: a_flip)
  int lda, a_off, a_flip, K, taps;  // taps with padding taps / 2 (taps = 1: a 1x1 conv)
  const float* w;                   // (taps, K, ldw)
  int ldw;
  const float* bias;
  const float* cond;  // kGate (nullable): row 0's 2*hidden vector, rows cond_stride apart
  int cond_stride;
  float* out;  // (B, T, ldo): columns o_off + c (backwards over n_cols with o_flip)
  int ldo, o_off, o_flip;
  float* skip;  // (B, T, hidden) skip sum: the first layer writes it, later ones add
  int first;
  int n_cols;  // output columns; kGate/kRes: column c pairs with c + hidden
  int hidden;
};

template <int M>
constexpr bool kPaired = M == kGate || M == kRes;

// Columns of output per block: kPaired modes take CO_T / 2 pairs.
template <int M, int CO_T>
constexpr int kColsPerTile = kPaired<M> ? CO_T / 2 : CO_T;

template <int M, int CO_T, int R>
__global__ void __launch_bounds__(kThreads)
    flow_gemm_kernel(const Gemm g, const int* __restrict__ lengths, int T) {
  constexpr int co_threads = CO_T / kCoThread;
  constexpr int groups = kThreads / co_threads;  // frame groups
  constexpr int rows = groups * R;               // frames per block
  constexpr int w_floats = kKc * CO_T;           // one weight tile
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                       // kStages weight tiles
  float* as = smem + kStages * w_floats;  // kStages windows of (rows + taps - 1) x kAs
  const int t0 = blockIdx.x * rows;
  const int base = blockIdx.y * kColsPerTile<M, CO_T>;  // first column of half 0
  const int hoff = kPaired<M> ? g.hidden : CO_T / 2;    // half 1 = half 0 + hoff
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int ct = threadIdx.x % co_threads;
  const int tg = threadIdx.x / co_threads;

  float acc[R][kCoThread];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < kCoThread; ++c) acc[i][c] = 0.f;

  if (t0 < len) {  // block-uniform: a tile past the length only writes its zeros
    const int pad = g.taps / 2;
    const int win = rows + g.taps - 1;
    const float* ab = g.a + (size_t)b * T * g.lda + g.a_off;
    const int steps = (g.K / kKc) * g.taps;
    // Step s reads weight tile s % kStages and the window of its chunk, slot
    // chunk % kStages; load(s) fills both (the window at the chunk's first
    // tap) as one cp.async group, window row r <-> frame t0 - pad + r.
    auto load = [&](int step) {
      if (step < steps) {
        const int chunk = step / g.taps, tap = step - chunk * g.taps;
        const float* src = g.w + ((size_t)tap * g.K + chunk * kKc) * g.ldw + base;
        float* dst = ws + (step % kStages) * w_floats;
        for (int idx = threadIdx.x; idx < w_floats / 4; idx += kThreads) {
          const int kc = idx / (CO_T / 4), c4 = idx - kc * (CO_T / 4);
          const int h = c4 / (CO_T / 8), q = c4 - h * (CO_T / 8);
          cp_async16(dst + kc * CO_T + c4 * 4, src + (size_t)kc * g.ldw + h * hoff + q * 4);
        }
        if (tap == 0) {
          float* window = as + (chunk % kStages) * win * kAs;
          const int c0 = chunk * kKc;
          for (int idx = threadIdx.x; idx < win * kKc; idx += kThreads) {
            const int r = idx / kKc, kc = idx - r * kKc;
            const int p = t0 - pad + r;
            const int c = g.a_flip ? g.K - 1 - (c0 + kc) : c0 + kc;
            if (p >= 0 && p < T) {
              cp_async4(window + r * kAs + kc, ab + (size_t)p * g.lda + c);
            } else {
              window[r * kAs + kc] = 0.f;
            }
          }
        }
      }
      cp_async_commit();  // an empty group past the end keeps the count
    };

    for (int s = 0; s < kStages - 1; ++s) load(s);
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // this step's loads landed for all; step - 1 is consumed
      load(step + kStages - 1);
      const int chunk = step / g.taps, tap = step - chunk * g.taps;
      const float* a = as + ((chunk % kStages) * win + tap) * kAs;
      const float* wt = ws + (step % kStages) * w_floats + ct * 4;
#pragma unroll 4
      for (int kc = 0; kc < kKc; ++kc) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + kc * CO_T);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + kc * CO_T + CO_T / 2);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float v = a[(tg + i * groups) * kAs + kc];
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
    }
  }

  const int c0 = base + ct * 4;  // the thread's first column of half 0
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int p = t0 + tg + i * groups;
    if (p >= T) continue;
    const bool valid = p < len;
    const size_t frame = (size_t)b * T + p;
    if constexpr (M == kGate) {
      const float* cd = g.cond ? g.cond + (size_t)b * g.cond_stride + c0 : nullptr;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = acc[i][j] + g.bias[c0 + j] + (cd ? cd[j] : 0.f);
        const float s = acc[i][4 + j] + g.bias[g.hidden + c0 + j] + (cd ? cd[g.hidden + j] : 0.f);
        v[j] = valid ? tanhf(t) * (1.f / (1.f + expf(-s))) : 0.f;
      }
      *reinterpret_cast<float4*>(g.out + frame * g.ldo + c0) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (M == kRes) {
      float* h = g.out + frame * g.ldo + c0;
      float* sk = g.skip + frame * g.hidden + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = valid ? h[j] + acc[i][j] + g.bias[c0 + j] : 0.f;
        sk[j] = (g.first ? 0.f : sk[j]) + acc[i][4 + j] + g.bias[g.hidden + c0 + j];
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + half * hoff + j;
          const float y = acc[i][4 * half + j] + g.bias[c];
          if constexpr (M == kPre) {
            g.out[frame * g.ldo + c] = valid ? y : 0.f;
          } else if constexpr (M == kSkip) {
            float* sk = g.skip + frame * g.hidden + c;
            *sk = (g.first ? 0.f : *sk) + y;
          } else {  // kPost
            float* dst = g.out + frame * g.ldo + g.o_off + (g.o_flip ? g.n_cols - 1 - c : c);
            *dst = valid ? *dst - y : 0.f;
          }
        }
      }
    }
  }
}

template <int M, int CO_T, int R>
cudaError_t launch_gemm(const Gemm& g, const int* lengths, int B, int T, cudaStream_t stream) {
  constexpr int rows = kThreads / (CO_T / kCoThread) * R;
  const int smem =
      kStages * (kKc * CO_T + (rows + g.taps - 1) * kAs) * static_cast<int>(sizeof(float));
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = vk_set_smem(flow_gemm_kernel<M, CO_T, R>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + rows - 1) / rows, g.n_cols / kColsPerTile<M, CO_T>, B);
  flow_gemm_kernel<M, CO_T, R><<<grid, kThreads, smem, stream>>>(g, lengths, T);
  return cudaGetLastError();
}

// The largest R (frames per thread) whose grid still gives every SM a block.
template <int M, int CO_T>
cudaError_t launch_rows(const Gemm& g, const int* lengths, int B, int T, cudaStream_t stream) {
  const long long col_tiles = g.n_cols / kColsPerTile<M, CO_T>;
  int best = 8;
  for (; best > 1; best /= 2) {
    const int rows = kThreads / (CO_T / kCoThread) * best;
    if ((long long)((T + rows - 1) / rows) * col_tiles * B >= vk_sm_count()) break;
  }
  switch (best) {
    case 8: return launch_gemm<M, CO_T, 8>(g, lengths, B, T, stream);
    case 4: return launch_gemm<M, CO_T, 4>(g, lengths, B, T, stream);
    case 2: return launch_gemm<M, CO_T, 2>(g, lengths, B, T, stream);
    default: return launch_gemm<M, CO_T, 1>(g, lengths, B, T, stream);
  }
}

}  // namespace

// One coupling of the reverse flow, in place on x (B, T, C = 2*half) fp32:
// reads channels [read_off, read_off + half) (backwards with flip), writes
// channels [upd_off, upd_off + half) (backwards with flip) at every t < T,
// zero at t >= lengths[b]. cond (nullable) points at this coupling's (nl,
// 2*hidden) vectors of row 0, rows cond_stride floats apart. weights is a host
// array of the n_weights = 4 + 4*nl device pointers, in the canonical layouts:
// w_pre, b_pre, w_post, b_post, then per layer w_in, b_in, w_rs, b_rs. h,
// acts and skip are (B, T, hidden) scratch buffers. Weights, biases and x
// are 16-byte aligned; half % 16 == 0, hidden % 32 == 0.
VK_EXPORT int vk_flow_coupling(float* x, const int* lengths, const float* cond, int cond_stride,
                               const void* const* weights, int n_weights, float* h, float* acts,
                               float* skip, int B, int T, int C, int half, int hidden, int nl,
                               int k, int read_off, int upd_off, int flip, void* stream) {
  if (nl < 1 || n_weights != 4 + 4 * nl || k < 1 || k % 2 == 0 || T < 1 || B < 1 ||
      C != 2 * half || half % kKc || hidden % 32)
    return cudaErrorInvalidValue;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto product = [&](const float* a, int lda, int K, int taps, const float* wt, int ldw,
                     const float* bias, float* out, int ldo, int n_cols) {
    Gemm g{};
    g.a = a, g.lda = lda, g.K = K, g.taps = taps, g.w = wt, g.ldw = ldw, g.bias = bias;
    g.out = out, g.ldo = ldo, g.n_cols = n_cols, g.skip = skip, g.hidden = hidden;
    return g;
  };

  Gemm pre = product(x, C, half, 1, w[0], hidden, w[1], h, hidden, hidden);
  pre.a_off = read_off, pre.a_flip = flip;
  cudaError_t err = launch_rows<kPre, 32>(pre, lengths, B, T, s);
  for (int l = 0; l < nl && err == cudaSuccess; ++l) {
    const float* const* wl = w + 4 + 4 * l;  // w_in, b_in, w_rs, b_rs
    Gemm gate = product(h, hidden, hidden, k, wl[0], 2 * hidden, wl[1], acts, hidden, hidden);
    gate.cond = cond ? cond + l * 2 * hidden : nullptr, gate.cond_stride = cond_stride;
    err = launch_rows<kGate, 64>(gate, lengths, B, T, s);
    const bool last = l == nl - 1;  // its res_skip conv is all skip
    Gemm res = product(acts, hidden, hidden, 1, wl[2], last ? hidden : 2 * hidden, wl[3], h,
                       hidden, hidden);
    res.first = l == 0;
    if (err == cudaSuccess) {
      err = last ? launch_rows<kSkip, 32>(res, lengths, B, T, s)
                 : launch_rows<kRes, 64>(res, lengths, B, T, s);
    }
  }
  if (err != cudaSuccess) return err;
  Gemm post = product(skip, hidden, hidden, 1, w[2], half, w[3], x, C, half);
  post.o_off = upd_off, post.o_flip = flip;
  return launch_rows<kPost, 16>(post, lengths, B, T, s);
}
