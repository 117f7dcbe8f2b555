// Monotonic Alignment Search (MAS) on the H100: the Viterbi forward over the
// frames and the backtrace into a one-hot alignment, one launch per call.
//
// Replaces no Pallas kernel. It is the port of the JAX package's hot-path
// lax.scan: the forward at vits_tpu/ops/align.py:51 and the backtrace at :70,
// which run over every frame of every training step. Driven by
// vits_tpu_torch/ops/cuda/align.py::monotonic_align (its plain twin,
// monotonic_align_reference, is that module's Python loop over frames). The
// arithmetic is JAX's, cell for cell:
//   ll[s, t]  = tmask[t] != 0 ? log_likelihood[s, t] : -1e9
//   val_0[t]  = t == 0 ? ll[0, 0] : -1e9
//   shifted   = val_{s-1}[t - 1] (-1e9 at t = 0)
//   choice    = shifted >= val_{s-1}[t]            (ties go to the diagonal move)
//   val_s[t]  = ll[s, t] + max(val_{s-1}[t], shifted)   (one fp32 add; NaN propagates)
// then the backtrace from frame S-1 down to 1 with s_len, t_len the mask counts
// and end = max(t_len - 1, 0):
//   t_here = s == s_len - 1 ? end : t_cur;  path[s] = t_here
//   t_cur  = s <= s_len - 1 ? t_here - choice[s-1][t_here] : t_here
// and path[0] = t_cur. The output is one_hot(path[s])[t] * fmask[s] *
// tmask[t], a negative path a zero row (as jax.nn.one_hot). A row with no
// valid token walks below token 0 and never climbs back, so once t_here < 0
// every earlier row is zero whatever choice it reads: there the walk reads
// token 0's (JAX wraps or fills the index). So the alignments are equal to
// JAX's, not close.
//
// What bounds it on an H100: latency. The forward is a chain of S - 1
// dependent steps per batch row; each needs the whole previous row of values.
// Its bytes (the likelihoods read once, the alignment written once: 10.5 MB at
// B = 2, S = 1280, T = 512, 3.1 us at 3.35 TB/s) are nothing beside that chain.
// Measured (scripts/torch_mas_probe.py, B = 2): a frame costs 373 ns at
// T = 512 with the values in registers (mas_kernel), 499 at 768, 690 at 1024,
// and 587, 676, 850 with them in device scratch (mas_generic); the exchange and
// its barrier are the chain. A barrier-free wavefront (warp w a frame behind
// warp w - 1, flags in shared memory) is the next design to try.
//
// Design: one block per batch row, so the chain never leaves the SM;
// ops/cuda/align.py::mas_plan picks the kernel, the block and where the
// choices live.
// - mas_kernel, up to kMaxThreads tokens: thread t keeps token t's value in a
//   register. A frame's shift t - 1 -> t is __shfl_up_sync inside a warp; the
//   first lane takes the last lane of the warp before from shared memory (lane
//   31 of every warp publishes its value, then one __syncthreads). The
//   exchange slots alternate by frame parity, so one barrier a frame suffices.
//   The likelihood rows arrive kRing frames ahead with cp.async into a ring in
//   shared memory. Each thread copies and reads only its own token, so the
//   ring needs no barrier, only the thread's own wait_group. Its choices stay
//   in shared memory; where they do not fit, the shape goes to mas_generic.
// - mas_generic, any shape: the values in a device scratch buffer of two rows,
//   read and written once a frame between the same barriers, several tokens a
//   thread past the block size, so no shape is refused.
// - Each frame's choices are packed by __ballot_sync, one 32-bit word per warp
//   and token block of 32, into shared memory when (S - 1) * ceil(T / 32) * 4
//   bytes fit beside the rest (81.9 KB at S = 1280, T = 512), else (mas_generic)
//   into a device scratch buffer that the wrapper allocates.
// - Backtrace: thread 0 walks the bits into a chunk of the path in shared
//   memory (kPathChunk frames); then the whole block writes those rows of the
//   masked one-hot, coalesced along T, and the walk goes on. Shared memory
//   stays bounded at any S.
// - Lengths: s_len and t_len are the sums of the 1/0 masks (as JAX sums them),
//   reduced by the block.

#include "common.cuh"

namespace {

constexpr float kNeg = -1e9f;
constexpr int kRing = 8;  // frames of likelihoods in flight (cp.async ring)
constexpr int kPathChunk = 1024;  // frames of the path walked between writes
constexpr int kMaxThreads = 1024;

struct Mas {
  const float* ll;     // (B, S, T)
  const float* fmask;  // (B, S)
  const float* tmask;  // (B, T)
  float* out;          // (B, S, T)
  unsigned* choices;   // (B, S - 1, W) device scratch of mas_generic; null: shared memory
  float* values;       // (B, 2, T) device scratch of mas_generic; null otherwise
  int S, T, W;
};

// cp_async4_zfill with a memory clobber: the ring slot it refills was read by
// this thread a frame earlier, and no load of it may move past the copy.
__device__ __forceinline__ void ring_copy(float* smem, const float* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

// torch.maximum / jnp.maximum: NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// The row's s_len and t_len (sums of its masks) into lens[0], lens[1]; red holds
// 2 * 32 floats. Ends with a barrier.
__device__ void row_lengths(const Mas& a, int b, float* red, int* lens) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  float fs = 0.f, ts = 0.f;
  for (int s = tid; s < a.S; s += blockDim.x) fs += a.fmask[static_cast<size_t>(b) * a.S + s];
  for (int t = tid; t < a.T; t += blockDim.x) ts += a.tmask[static_cast<size_t>(b) * a.T + t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    fs += __shfl_xor_sync(0xffffffffu, fs, o);
    ts += __shfl_xor_sync(0xffffffffu, ts, o);
  }
  if (lane == 0) {
    red[warp] = fs;
    red[32 + warp] = ts;
  }
  __syncthreads();
  if (tid == 0) {
    float f = 0.f, t = 0.f;
    for (int w = 0; w < nw; ++w) {
      f += red[w];
      t += red[32 + w];
    }
    lens[0] = static_cast<int>(f);
    lens[1] = static_cast<int>(t);
  }
  __syncthreads();
}

// The backtrace and the output rows of batch row b (every thread of the block
// calls it; thread 0 walks). choices: this row's (S - 1, W) words.
__device__ void backtrace_and_write(const Mas& a, int b, const unsigned* choices, int* path,
                                    const int* lens) {
  const int S = a.S, T = a.T, W = a.W, tid = threadIdx.x;
  const int s_len = lens[0], t_len = lens[1];
  const int end = max(t_len - 1, 0);
  int t_cur = end;  // thread 0's walk
  const float* tmask = a.tmask + static_cast<size_t>(b) * T;
  for (int hi = S - 1; hi >= 0; hi -= kPathChunk) {
    const int lo = max(hi - kPathChunk + 1, 0);
    if (tid == 0) {
      for (int s = hi; s >= lo; --s) {
        if (s == 0) {
          path[0] = t_cur;
          break;
        }
        const int t_here = s == s_len - 1 ? end : t_cur;
        path[s - lo] = t_here;
        const int idx = max(t_here, 0);
        const int diag = (choices[static_cast<size_t>(s - 1) * W + (idx >> 5)] >> (idx & 31)) & 1u;
        t_cur = s <= s_len - 1 ? t_here - diag : t_here;
      }
    }
    __syncthreads();
    for (int s = lo; s <= hi; ++s) {
      const int p = path[s - lo];
      const float f = a.fmask[static_cast<size_t>(b) * S + s];
      float* row = a.out + (static_cast<size_t>(b) * S + s) * T;
      for (int t = tid; t < T; t += blockDim.x) row[t] = ((t == p ? 1.f : 0.f) * f) * tmask[t];
    }
    __syncthreads();
  }
}

// Values in registers: one token a thread, t = threadIdx.x (T <= blockDim.x).
// Shared memory: the ring (kRing x threads floats), the exchange (2 x warps
// floats), the path chunk, the reduction (64 floats, 2 ints), then the choices.
__global__ void __launch_bounds__(kMaxThreads) mas_kernel(Mas a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, nw = NT >> 5, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, S = a.S, T = a.T, W = a.W;
  float* ring = reinterpret_cast<float*>(smem);
  float* xchg = ring + kRing * NT;
  int* path = reinterpret_cast<int*>(xchg + 2 * nw);
  float* red = reinterpret_cast<float*>(path + kPathChunk);
  int* lens = reinterpret_cast<int*>(red + 64);
  unsigned* choices = reinterpret_cast<unsigned*>(lens + 2);
  const float* ll = a.ll + static_cast<size_t>(b) * S * T;

  const bool keep = tid < T && a.tmask[static_cast<size_t>(b) * T + tid] != 0.f;
  // frames 1 .. kRing-1 in flight before the first is needed
  auto prefetch = [&](int f) {
    if (f < S) {
      ring_copy(ring + (f % kRing) * NT + tid, ll + static_cast<size_t>(f) * T + min(tid, T - 1),
                tid < T ? 4 : 0);
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int f = 1; f < kRing; ++f) prefetch(f);

  float v = tid == 0 && keep ? ll[0] : kNeg;
  row_lengths(a, b, red, lens);

#pragma unroll 1
  for (int s = 1; s < S; ++s) {
    prefetch(s + kRing - 1);
    cp_async_wait<kRing - 1>();
    float* x = xchg + (s & 1) * nw;
    if (lane == 31) x[warp] = v;
    __syncthreads();
    // the frame's shared-memory loads before its store of the choice word
    float up = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) up = warp > 0 ? x[warp - 1] : kNeg;
    const float l = keep ? ring[(s % kRing) * NT + tid] : kNeg;
    const unsigned bits = __ballot_sync(0xffffffffu, up >= v);
    v = l + max_nan(v, up);
    if (lane == 0 && warp < W) choices[static_cast<size_t>(s - 1) * W + warp] = bits;
  }
  cp_async_wait<0>();
  __syncthreads();
  backtrace_and_write(a, b, choices, path, lens);
}

// Values in a device scratch buffer of two rows (any T): each frame reads the
// previous row and writes the next, then one barrier (global writes are
// visible to the block after __syncthreads). Shared memory: the path chunk, the
// reduction, then the choices when they are kept here.
__global__ void __launch_bounds__(kMaxThreads) mas_generic(Mas a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x, S = a.S, T = a.T, W = a.W;
  const int TP = (T + NT - 1) / NT * NT;
  int* path = reinterpret_cast<int*>(smem);
  float* red = reinterpret_cast<float*>(path + kPathChunk);
  int* lens = reinterpret_cast<int*>(red + 64);
  unsigned* choices = a.choices != nullptr
                          ? a.choices + static_cast<size_t>(b) * (S > 1 ? S - 1 : 0) * W
                          : reinterpret_cast<unsigned*>(lens + 2);
  const float* ll = a.ll + static_cast<size_t>(b) * S * T;
  const float* tmask = a.tmask + static_cast<size_t>(b) * T;
  float* vals = a.values + static_cast<size_t>(b) * 2 * T;

  for (int t = tid; t < T; t += NT) vals[t] = t == 0 && tmask[0] != 0.f ? ll[0] : kNeg;
  row_lengths(a, b, red, lens);  // its barriers publish the first row

#pragma unroll 1
  for (int s = 1; s < S; ++s) {
    const float* prev = vals + ((s - 1) & 1) * T;
    float* next = vals + (s & 1) * T;
    unsigned* word = choices + static_cast<size_t>(s - 1) * W;
    for (int base = 0; base < TP; base += NT) {
      const int t = base + tid;
      const float here = t < T ? prev[t] : kNeg;
      const float up = t > 0 && t <= T ? prev[t - 1] : kNeg;
      const bool diag = up >= here;
      const unsigned bits = __ballot_sync(0xffffffffu, diag);
      if (t < T) {
        const float l = tmask[t] != 0.f ? ll[static_cast<size_t>(s) * T + t] : kNeg;
        next[t] = l + max_nan(here, up);
      }
      if (lane == 0 && (t >> 5) < W) word[t >> 5] = bits;
    }
    __syncthreads();
  }
  backtrace_and_write(a, b, choices, path, lens);
}

// Shared memory besides the choices (ops/cuda/align.py::mas_plan's base_bytes).
size_t base_bytes(int threads, bool registers) {
  const size_t tail = sizeof(int) * kPathChunk + sizeof(float) * 64 + sizeof(int) * 2;
  if (!registers) return tail;
  return sizeof(float) * (static_cast<size_t>(kRing) * threads + 2 * (threads / 32)) + tail;
}

}  // namespace

// The alignment of ll (B, S, T) under the 1/0 masks fmask (B, S) and tmask
// (B, T), all fp32, into out (B, S, T). values null: mas_kernel, the values in
// registers (T <= threads) and the choices in shared memory (choices null).
// values (B, 2, T) of device scratch: mas_generic, any T, with choices (B, S - 1,
// ceil(T / 32)) words of device scratch, or null to keep them in shared memory.
// Refused where the shared memory (that of mas_plan) passes the block's.
VK_EXPORT int vk_monotonic_align(const float* ll, const float* fmask, const float* tmask,
                                 float* out, unsigned* choices, float* values, int B, int S,
                                 int T, int threads, void* stream) {
  const bool registers = values == nullptr;
  if (B < 1 || S < 1 || T < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (registers && (threads < T || choices != nullptr)))
    return cudaErrorInvalidValue;
  Mas a = {ll, fmask, tmask, out, choices, values, S, T, (T + 31) / 32};
  size_t smem = base_bytes(threads, registers);
  if (choices == nullptr) smem += sizeof(unsigned) * static_cast<size_t>(S - 1) * a.W;
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = registers ? vk_set_smem_once<mas_kernel>(smem)
                                     : vk_set_smem_once<mas_generic>(smem);
  if (err != cudaSuccess) return err;
  if (registers) {
    mas_kernel<<<B, threads, smem, st>>>(a);
  } else {
    mas_generic<<<B, threads, smem, st>>>(a);
  }
  return cudaGetLastError();
}
