// Kernel 6: the reverse residual-coupling flow, on the tensor cores.
//
// Replaces vits_tpu/ops/pallas/flow.py::fused_flow (_flow_kernel), which runs
// all couplings of one batch row on a VMEM-resident sequence, grid (B, n).
// Here the whole flow is one captured CUDA graph per (B, T) shape: the cond
// kernel (the speaker vectors), then for each of the n couplings in execution
// order 2 + 2*nl launches of conv_gemm.cuh's tensor-core conv over every frame
// of the batch, each product with its step of the coupling in a flow epilogue
// (FlowEpi below):
//   pre   h    = mask(read @ w_pre + b_pre)                     1x1, half -> hidden
//   per WaveNet layer l (k taps, dilation 1):
//   gate  acts = mask(tanh(g_t + cond_t) * sigmoid(g_s + cond_s)),
//         g    = conv_k(h) @ w_gate[l] + b_gate[l]               hidden -> 2*hidden
//   res   h    = mask(h + rs_res) (not on the last layer); skip (+)= rs_skip,
//         rs   = acts @ w_rs[l] + b_rs[l]                        hidden -> 2*hidden
//   post  upd  = mask(upd - (skip @ w_post + b_post))           1x1, hidden -> half
// where mask zeroes frames at and past the row's length. The weights come
// packed once per parameter set (ops/cuda/flow.py::pack_flow_weights, the
// port's twin of the JAX function): in execution order, the channel flips
// folded into conv_pre's rows and conv_post's columns and bias, so a step
// reads the half [read_off, read_off + half) and updates the other in place
// with plain 16-byte loads and stores; the gate's columns interleaved (tanh
// column j at 2j, its sigmoid partner at 2j + 1) and res/skip likewise (the
// last layer's res columns zero, as in the JAX pack), so an epilogue's float4
// of a staged row holds two whole pairs. x, h, acts and skip are buffers of
// the caller's workspace (ops/cuda/flow.py::FlowWorkspace).
//
// What bounds it on an H100: operations. At MMS/VCTK width (half 96, hidden
// 192, 4 layers of k=5) a coupling does 2*(96*192 + 4*5*192*384 + 4*192*384
// + 192*96) = 3.6 MFLOP per frame, 14.5 MFLOP per frame over four couplings:
// 297 GFLOP at B=16, T=1280 (1.8 ms at 165 TFLOP/s, 3xTF32). Bytes are the
// packed weights (7.2 MB a coupling, L2-resident) and the (T, 192) state.
// The first port ran the products as fp32 FFMA with a 16-channel serial chain
// per step (about 25 TFLOP/s on an H100 80GB HBM3 at 700 W, level with the
// plain flow at B=16); at B=1 each of its 40 launches took ~27 us for 0.24
// GFLOP, and its host enqueue was 0.58 ms (PERF.md). Here each product is the resblock conv's 3xTF32 tile (32-channel
// steps, ldmatrix A fragments, a cp.async ring); the caller's plan
// (ops/cuda/flow.py::flow_plan, fitted on the card) splits the gate's 30 K
// steps (5 taps x 6 chunks) over an 8-block cluster at small batch, so no
// block walks more than 4, and takes whole 128 x 64 tiles at large batch. A
// tile that starts at or past its row's length skips the products; a
// length-0 row is exact zeros. Replaying the graph makes a call five stream
// operations from one C call (vk_flow_run), whatever the launch count. What
// is left at B=1 is each launch's own latency (~12 us on the same card for a
// few K steps, a cluster reduction and an epilogue); programmatic dependent
// launch between the products, and a launch fusing the gate with res/skip,
// were measured no faster (PERF.md) and are not used. At the serving tiers
// the products take the conv's bf16 paths (kFast, kHigh; conv_gemm.cuh), the
// elementwise work of the epilogues staying fp32 as in the JAX kernel.
// bf16 serving (io16): x, the speaker embedding and the output are bf16, as
// the JAX kernel's are at compute_dtype="bfloat16". The graph then opens with
// widen_kernel (bf16 -> the fp32 workspace, exact), the cond vectors are
// rounded where the JAX package's bf16 cond_layer conv rounds them (the sum,
// then the bias add), the couplings stage fp32 as before, and narrow_kernel
// rounds the result to bf16 last.
#include <math.h>

#include "common.cuh"
#include "conv_gemm.cuh"

namespace {

enum Mode { kPre, kGate, kRes, kPost };

template <int M>
struct FlowEpi {
  float* out;  // kPre, kRes: h; kGate: acts; kPost: x at the updated half
  int ldo;     // out's row stride
  const float* bias;
  const float* cond;  // kGate (nullable): this layer's 2*hidden vector of row 0 (tanh | sigmoid)
  int cond_stride;    // floats between rows' cond vectors
  float* skip;        // kRes
  int first, write_h; // kRes: the first layer writes skip; all but the last update h
  int T, hidden;

  __device__ __forceinline__ void operator()(int b, int p, int co, float4 y, bool valid) const {
    const size_t frame = (size_t)b * T + p;
    const float4 bv = *reinterpret_cast<const float4*>(bias + co);
    y = make_float4(y.x + bv.x, y.y + bv.y, y.z + bv.z, y.w + bv.w);
    if constexpr (M == kPre) {
      *reinterpret_cast<float4*>(out + frame * ldo + co) =
          valid ? y : make_float4(0.f, 0.f, 0.f, 0.f);
    } else if constexpr (M == kGate) {  // y = (tanh j, sigmoid j, tanh j+1, sigmoid j+1)
      const int j = co / 2;
      if (cond) {
        const float* c = cond + (size_t)b * cond_stride + j;
        y.x += c[0], y.z += c[1], y.y += c[hidden], y.w += c[hidden + 1];
      }
      float2 v = make_float2(0.f, 0.f);
      if (valid)
        v = make_float2(tanhf(y.x) * (1.f / (1.f + expf(-y.y))),
                        tanhf(y.z) * (1.f / (1.f + expf(-y.w))));
      *reinterpret_cast<float2*>(out + frame * ldo + j) = v;
    } else if constexpr (M == kRes) {  // y = (res j, skip j, res j+1, skip j+1)
      const int j = co / 2;
      float2* sk = reinterpret_cast<float2*>(skip + frame * hidden + j);
      const float2 s = first ? make_float2(0.f, 0.f) : *sk;
      *sk = make_float2(s.x + y.y, s.y + y.w);
      if (write_h) {
        float2* h = reinterpret_cast<float2*>(out + frame * ldo + j);
        const float2 hv = *h;
        *h = valid ? make_float2(hv.x + y.x, hv.y + y.z) : make_float2(0.f, 0.f);
      }
    } else {  // kPost
      float4* o = reinterpret_cast<float4*>(out + frame * ldo + co);
      const float4 xv = *o;
      *o = valid ? make_float4(xv.x - y.x, xv.y - y.y, xv.z - y.z, xv.w - y.w)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
};

// cond[b, j] = bias[j] + sum_e emb[b, e] * w[e, j]: the speaker vectors of every
// (coupling, layer) from the embedding, (B, E) x (E, N). A block of 8 warps
// owns 32 outputs of one row: warp q sums every 8th e from q (lane j, loads
// coalesced along j), and the 8 partials are added in order in shared memory.
__global__ void __launch_bounds__(256)
    cond_kernel(const float* __restrict__ emb, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ cond, int E, int N,
                int round) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5, b = blockIdx.y;
  const int j = blockIdx.x * 32 + lane;
  const float* e = emb + (size_t)b * E;
  float acc = 0.f;
  if (j < N)
#pragma unroll 4
    for (int i = q; i < E; i += 8) acc = fmaf(e[i], w[(size_t)i * N + j], acc);
  part[q][lane] = acc;
  __syncthreads();
  if (q == 0 && j < N) {
    float s = part[0][lane];
    for (int r = 1; r < 8; ++r) s += part[r][lane];
    cond[(size_t)b * N + j] = round ? bf16_round(bf16_round(s) + bias[j]) : s + bias[j];
  }
}

// out[i] = in[i] for n values, bf16 -> fp32 (widen_kernel) or fp32 -> bf16
// rounded to nearest (narrow_kernel).
__global__ void widen_kernel(const __nv_bfloat16* __restrict__ in, float* __restrict__ out,
                             size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __bfloat162float(in[i]);
}
__global__ void narrow_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                              size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

inline unsigned elementwise_blocks(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
}

// The n couplings in place on x (B, T, C = 2*half), in execution order (see
// vk_flow_capture), on stream s.
cudaError_t run_flow(float* x, const int* lengths, const float* cond,
                     const float* const* packed, const int* plan, float* h, float* acts,
                     float* skip, int B, int T, int half, int hidden, int nl, int k, int n,
                     int mode, cudaStream_t s) {
  const int C = 2 * half, h2 = 2 * hidden;
  const float *w_pre = packed[0], *b_pre = packed[1], *w_gate = packed[2], *b_gate = packed[3];
  const float *w_rs = packed[4], *b_rs = packed[5], *w_post = packed[6], *b_post = packed[7];
  auto gemm = [&](const float* a, int lda, const float* w, int C_in, int C_out, int taps,
                  int which) {
    return conv::Gemm{a, lda, w, lengths, T, C_in, C_out, taps, 1, taps / 2, 1.f,
                      plan[2 * which + 1], 0};
  };
  cudaError_t err = cudaSuccess;
  for (int step = 0; step < n && err == cudaSuccess; ++step) {
    const int read_off = step % 2 == 0 ? half : 0, upd_off = half - read_off;
    FlowEpi<kPre> pre{h, hidden, b_pre + (size_t)step * hidden};
    pre.T = T, pre.hidden = hidden;
    err = conv::launch_tile_mode(
        mode, plan[0], gemm(x + read_off, C, w_pre + (size_t)step * half * hidden, half, hidden, 1, 0),
        pre, B, s);
    for (int l = 0; l < nl && err == cudaSuccess; ++l) {
      const size_t sl = (size_t)step * nl + l;
      FlowEpi<kGate> gate{acts, hidden, b_gate + sl * h2, cond ? cond + sl * h2 : nullptr,
                          n * nl * h2};
      gate.T = T, gate.hidden = hidden;
      err = conv::launch_tile_mode(
          mode, plan[2], gemm(h, hidden, w_gate + sl * k * hidden * h2, hidden, h2, k, 1), gate, B, s);
      if (err != cudaSuccess) break;
      FlowEpi<kRes> res{h, hidden, b_rs + sl * h2, nullptr, 0, skip, l == 0, l < nl - 1};
      res.T = T, res.hidden = hidden;
      err = conv::launch_tile_mode(
          mode, plan[4], gemm(acts, hidden, w_rs + sl * hidden * h2, hidden, h2, 1, 2), res, B, s);
    }
    if (err != cudaSuccess) break;
    FlowEpi<kPost> post{x + upd_off, C, b_post + (size_t)step * half};
    post.T = T, post.hidden = hidden;
    err = conv::launch_tile_mode(
        mode, plan[6], gemm(skip, hidden, w_post + (size_t)step * hidden * half, hidden, half, 1, 3),
        post, B, s);
  }
  return err;
}

}  // namespace

// Captures the whole reverse flow over one workspace into a CUDA graph (*exec):
// with emb, cond_kernel first (cond = emb @ w_cond + b_cond), then the n
// couplings in place on x (B, T, C = 2*half) fp32 in execution order, step s
// reading channels [read_off, read_off + half) with read_off = half on even
// steps (their flips folded into the packed weights) and 0 on odd ones, and
// updating the other half; zero at t >= lengths[b]. packed: host array of the
// 10 device pointers of pack_flow_weights, in the order w_pre (n, half,
// hidden), b_pre (n, hidden), w_gate (n, nl, k, hidden, 2*hidden), b_gate (n,
// nl, 2*hidden), w_rs (n, nl, hidden, 2*hidden), b_rs (n, nl, 2*hidden),
// w_post (n, hidden, half), b_post (n, half), w_cond (E, n*nl*2*hidden) and
// b_cond (n*nl*2*hidden) (null without speakers). emb (nullable): (B, E);
// cond: (B, n, nl, 2*hidden). plan: host array of (tile, split) for the pre,
// gate, res/skip and post products (ops/cuda/flow.py::flow_plan). h, acts,
// skip: (B, T, hidden) scratch. mode: the products' tier (TierMode; the JAX
// kernel's reduce_precision(pallas_precision)), baked into the graph. With
// x16 (bf16 serving) the graph reads x16 (B, T, C) and emb16 (B, E) bf16 into
// x and emb first, rounds cond as a bf16 conv, and writes the result back to
// x16 as bf16 last.
// half % 16 == 0, hidden % 32 == 0, k odd,
// 16-byte aligned tensors. The graph keeps every pointer: the caller keeps
// the buffers for its life and frees it with vk_graph_destroy.
VK_EXPORT int vk_flow_capture(float* x, const int* lengths, float* emb, float* cond, int E,
                              const float* const* packed, const int* plan, float* h,
                              float* acts, float* skip, int B, int T, int half, int hidden,
                              int nl, int k, int n, int mode, void* x16, const void* emb16,
                              void** exec) {
  if (nl < 1 || n < 1 || k < 1 || k % 2 == 0 || T < 1 || B < 1 || half % 16 || hidden % 32 ||
      mode < kExact || mode > kHigh ||
      (emb && (!cond || E < 1 || !packed[8] || !packed[9])) || (x16 && emb && !emb16))
    return cudaErrorInvalidValue;
  const size_t values = (size_t)B * T * 2 * half;
  cudaStream_t cs;
  cudaError_t err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    if (x16) {
      widen_kernel<<<elementwise_blocks(values), 256, 0, cs>>>(
          static_cast<const __nv_bfloat16*>(x16), x, values);
      if (emb)
        widen_kernel<<<elementwise_blocks((size_t)B * E), 256, 0, cs>>>(
            static_cast<const __nv_bfloat16*>(emb16), emb, (size_t)B * E);
      err = cudaGetLastError();
    }
    if (emb && err == cudaSuccess) {
      const int N = n * nl * 2 * hidden;
      cond_kernel<<<dim3((N + 31) / 32, B), 256, 0, cs>>>(emb, packed[8], packed[9], cond, E, N,
                                                          x16 != nullptr);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess)
      err = run_flow(x, lengths, emb ? cond : nullptr, packed, plan, h, acts, skip, B, T, half,
                     hidden, nl, k, n, mode, cs);
    if (x16 && err == cudaSuccess) {
      narrow_kernel<<<elementwise_blocks(values), 256, 0, cs>>>(
          x, static_cast<__nv_bfloat16*>(x16), values);
      err = cudaGetLastError();
    }
    cudaGraph_t graph = nullptr;
    const cudaError_t end = cudaStreamEndCapture(cs, &graph);
    if (err == cudaSuccess) err = end;
    if (err == cudaSuccess)
      err = cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec), graph, 0);
    if (graph) cudaGraphDestroy(graph);
  }
  cudaStreamDestroy(cs);
  return err;
}

// One flow call on stream: x (B, T, C) -> the workspace's ws_x, lengths (B,)
// -> ws_lens, emb (nullable, (B, E)) -> ws_emb; the captured graph; ws_x ->
// out. Five calls on the stream, whatever the flow's size. elem is the bytes
// of one value of x, emb and out: 4 (fp32), or 2 for bf16 serving, with
// ws_x and ws_emb the graph's x16 and emb16.
VK_EXPORT int vk_flow_run(void* exec, void* ws_x, const void* x, int* ws_lens,
                          const int* lengths, void* ws_emb, const void* emb, int B, int T,
                          int C, int E, void* out, int elem, void* stream) {
  if (elem != 4 && elem != 2) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)B * T * C * elem;
  cudaError_t err = cudaMemcpyAsync(ws_x, x, bytes, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(ws_lens, lengths, B * sizeof(int), cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess && emb)
    err = cudaMemcpyAsync(ws_emb, emb, (size_t)B * E * elem, cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), s);
  if (err == cudaSuccess) err = cudaMemcpyAsync(out, ws_x, bytes, cudaMemcpyDeviceToDevice, s);
  return err;
}

VK_EXPORT int vk_graph_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
