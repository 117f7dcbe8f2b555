// Monotonic Alignment Search (MAS) on the H100: the Viterbi forward over the
// frames, the backtrace and the masked one-hot alignment, one launch a call.
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
//   t_cur  = s <= s_len - 1 ? t_here - choice[s-1][max(t_here, 0)] : t_here
// and path[0] = t_cur. The output is one_hot(path[s])[t] * fmask[s] *
// tmask[t], a negative path a zero row (as jax.nn.one_hot). A row with no
// valid token walks below token 0 and never climbs back, so once t_here < 0
// every earlier row is zero whatever choice it reads: there the walk reads
// token 0's (JAX wraps or fills the index). So the alignments are equal to
// JAX's, not close.
//
// What bounds it on an H100. The forward is a chain of S - 1 dependent frames
// per batch row, each needing all of the frame before; its bytes (the
// likelihoods read once and the alignment written once: 10.5 MB at B = 2,
// S = 1280, T = 512, 3.1 us at 3.35 TB/s) are small beside that chain at the
// training batch. So the design shortens a frame's step on one SM, keeps that
// SM's warps on the chain alone, and moves the bytes beside it. Measured
// (scripts/torch_mas_probe.py): a frame still costs ~110-210 ns at 512-1,024
// tokens, the latency of one warp a scheduler stepping through ~25 dependent
// instructions a frame; PERF.md has the numbers and what was tried.
//
// - The forward without a block barrier (chain warps 0 .. NW-1 of block 0).
//   Lane l of warp w holds K consecutive tokens in registers (K a template
//   parameter: 4 up to 1,024 tokens, a warp each 128, else 16, a warp each
//   512; 32 K NW tokens a strip). A frame costs one __shfl_up_sync of
//   each lane's last token and K independent max-adds; the value a cell needs
//   from the frame before sits in the same lane except at a lane's first token.
//   The warps run as a skewed wavefront: warp w computes frame s once warp
//   w - 1 has published its last token's value of frame s - 1 into a ring of
//   R 64-bit (value, tag) slots in shared memory (one predicated store, polled
//   loads, no fence: value and tag land together), checked once every
//   H = min(32 / K, 4) frames. No __syncthreads or other block barrier runs
//   inside the frame loop. A warp runs at most the likelihood ring's NC F
//   frames ahead of the next (the producer refills a slot only once every chain
//   warp has handed it back), and R > NC F, so no slot is overwritten before
//   it is read. Every such wait is bounded (kSpinCycles, ~2 s): past it the
//   thread traps, and the launch fails with a CUDA error rather than hanging.
// - Choices: each cell's `>=` is one bit; a lane packs its K bits of G = 32 / K
//   frames itself (no ballot) into 4 words (no chain through one
//   register), and during the next group's first frames a log2(G)-round
//   shuffle transpose gives lane i of each G lanes frame i's 32-bit word in the
//   plain layout (bit t & 31 of word t >> 5 of the frame's row of W =
//   ceil(T / 32) words): one store a lane every G frames, no shuffle latency
//   between groups.
// - Likelihoods by TMA: warp NW is the producer. A chunk of F frames is one
//   span in memory, so it comes into a ring slot in shared memory by one 1-D
//   bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes) of its 16-byte
//   aligned interior; its ragged ends (an odd T or pointer, under 16 bytes each)
//   come by 4-byte cp.async on the same mbarrier (cp.async.mbarrier.arrive).
//   The chain warps wait on the chunk's mbarrier phase and hand the slot back
//   on an `empty` mbarrier; each lane reads its group's 32 likelihoods into
//   registers at once (float4 where T % 4 == 0 and the pointer is aligned:
//   kVec). The chunks two rings ahead are prefetched into L2
//   (cp.async.bulk.prefetch.L2).
// - The backtrace 32 frames at a time (warp 0 of block 0): lane j loads frame
//   hi - j's choice words around the current token (the token falls by at most
//   one a frame, so the 32 bits from t - 31 to t cover the batch; tokens below
//   0 read token 0's bit) into a window, every lane reads the 32 windows back
//   from shared memory as broadcasts, and walks them two frames a step from
//   registers; lane j then writes frame hi - j's one. The token mask is staged
//   in the ring, the frame mask read a batch ahead.
// - The alignment written by a cluster. Each batch row runs as a thread-block
//   cluster of C blocks (2 <= C <= 8, cudaLaunchKernelEx with
//   cudaLaunchAttributeClusterDimension). Block 0 runs the chain and the
//   backtrace; blocks 1 .. C-1 write the row's masked zeros ((0 * fmask[s]) *
//   tmask[t]), coalesced along T, while the chain runs, so the output's bytes
//   leave from C - 1 other SMs during the forward. A cluster barrier (release /
//   acquire) then orders those zeros before block 0's ones ((1 * fmask[s]) *
//   tmask[path[s]]), one store a frame.
// - Where the choices live: block 0's shared memory when (S - 1) rows of W
//   words fit beside its ring; else the cluster's distributed shared memory
//   (block 0 holds rows0 rows, each other block rows1, the chain storing and
//   the backtrace loading them through map_shared_rank, the last barrier
//   keeping every block resident until the backtrace is done); past what 8
//   blocks hold (about 1.6 MB of bits at 12,288 tokens) a device scratch
//   buffer (B, S - 1, W) that the wrapper allocates. MAS_CASES' "cluster_past"
//   (1074 x 12288) takes that path, and so does any shape past it.
// - Past kMaxWarps warps of K = 16 (12,288 tokens) the tokens run in strips of
//   that width one after another; the values stay in registers, and the
//   boundary column between strips (one value a frame) goes through a device
//   scratch buffer (B, 2, S), read by the next strip's warp 0 after a barrier
//   of the chain warps between strips (not inside a frame loop); a strip's ring
//   slot then holds a row a frame. MAS_CASES' "strips" (T = 13000) takes that
//   path.
// - Lengths: s_len and t_len are the sums of the 1/0 masks (as JAX sums them),
//   reduced by block 0 before the forward.
// ops/cuda/align.py::mas_plan picks K, the warps, F, NC, the cluster size and
// block 0's shared-memory layout; vk_monotonic_align takes them as given and
// refuses a plan that would reach past a block's shared memory.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxWarps = 24;   // chain warps of a block (plus the producer), K = 16
constexpr int kMaxWarpsNarrow = 8;  // and for K = 4, whose lanes keep more registers
// A block's threads: the chain warps and the producer.
template <int K>
constexpr int kBlockThreads = 32 * ((K == 16 ? kMaxWarps : kMaxWarpsNarrow) + 1);
constexpr int kMaxCluster = 8;  // the portable cluster size
struct Mas {
  const float* ll;     // (B, S, T)
  const float* fmask;  // (B, S)
  const float* tmask;  // (B, T)
  float* out;          // (B, S, T)
  unsigned* scratch;   // (B, S - 1, W) choice words in device scratch, or null
  float* column;       // (B, 2, S) the strips' boundary values, or null
  int S, T, W;
  int warps, strips, frames, chunks, row_floats, slot_floats, slots;
  int rows0, rows1;          // choice rows in block 0 / in each other block
  int xs_off, ring_off, base_off;  // block 0's exchange, ring, choices (bytes)
};

// Block 0's shared memory, as ops/cuda/align.py::mas_plan lays it out: full[NC]
// and empty[NC] mbarriers and the length reduction (64 floats, 2 ints) from
// byte 0, the exchange slots (NW x R of 8 bytes) from xs_off, the likelihood
// ring (NC slots of slot_floats, 128-byte aligned) from ring_off, then its
// choice rows from base_off. The other blocks keep their choice rows from byte
// 0. A slot holds its chunk's frames as they lie in memory (rows of T floats,
// from a ragged start) when the row is one strip, else one row of RW = 32 K NW
// + 4 floats a frame; slot_floats >= F x row + 4 (a ragged start).

// The mbarrier's phase waits also for this thread's earlier cp.async copies.
__device__ __forceinline__ void mbar_track_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// A barrier of the chain warps only (the producer runs on).
__device__ __forceinline__ void chain_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// torch.maximum / jnp.maximum: NaN if either is NaN. (Where both are zeros of
// either sign it may pick the other zero; the values then add and compare
// equal, so no choice moves.)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The exchange: one 64-bit slot holds a value and its tag (the strip's frame).
__device__ __forceinline__ float await(const unsigned long long* slot, unsigned tag) {
  const long long t0 = clock64();
  unsigned long long x;
  while (static_cast<unsigned>((x = *reinterpret_cast<const volatile unsigned long long*>(slot)) >>
                               32) != tag)
    if (clock64() - t0 > kSpinCycles) __trap();
  return __uint_as_float(static_cast<unsigned>(x));
}

// The row's s_len and t_len (sums of its masks) into lens[0], lens[1]; red holds
// 2 * 32 floats. Ends with a barrier (before any frame loop).
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

// Choice row q (frame q + 1) of batch row b: device scratch, block 0's shared
// memory, or block r's through the cluster (block 0's threads only).
__device__ __forceinline__ unsigned* choice_row(const Mas& a, int b, int q, unsigned char* smem,
                                                cg::cluster_group& cluster) {
  if (q < a.rows0)
    return reinterpret_cast<unsigned*>(smem + a.base_off) + static_cast<size_t>(q) * a.W;
  if (a.scratch != nullptr)
    return a.scratch + (static_cast<size_t>(b) * (a.S - 1) + q) * a.W;
  const int r = (q - a.rows0) / a.rows1;
  return cluster.map_shared_rank(reinterpret_cast<unsigned*>(smem), 1 + r) +
         static_cast<size_t>(q - a.rows0 - r * a.rows1) * a.W;
}

// The span [g0, g0 + bytes) of the likelihoods into shared memory from `dst` on
// (both at the same offset modulo 16) on the mbarrier `bar`: its 16-byte aligned
// interior [a0, a1) is returned for one bulk copy; its ragged ends (under 16
// bytes each; none with kVec) go now by 4-byte cp.async that `bar` tracks.
template <bool kVec>
__device__ __forceinline__ void span_edges(unsigned char* dst, uintptr_t g0, unsigned bytes,
                                           uint64_t* bar, uintptr_t& a0, uintptr_t& a1) {
  const uintptr_t g1 = g0 + bytes;
  a0 = (g0 + 15) & ~uintptr_t(15);
  a1 = g1 & ~uintptr_t(15);
  if (a1 < a0) a1 = a0;
  if (!kVec) {
    for (uintptr_t p = g0; p < g1; p += 4) {
      if (p == a0 && a1 > a0) p = a1;
      if (p >= g1) break;
      cp_async4_zfill(dst + (p - g0), reinterpret_cast<const void*>(p), 4);
    }
    mbar_track_cp_async(bar);
  }
}

// Word m of choice row q, from a chain lane: block 0's rows by a plain
// shared-memory store, the cluster's and device scratch's out of line.
__device__ __noinline__ void store_choice_far(const Mas& a, int b, int q, int m, unsigned word,
                                              unsigned char* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  choice_row(a, b, q, smem, cluster)[m] = word;
}
__device__ __forceinline__ void store_choice(const Mas& a, int b, int q, int m, unsigned word,
                                             unsigned char* smem) {
  if (q < a.rows0)
    reinterpret_cast<unsigned*>(smem + a.base_off)[static_cast<size_t>(q) * a.W + m] = word;
  else
    store_choice_far(a, b, q, m, word, smem);
}

// Producer warp: chunk c of strip st is frames 1 + c F .. 1 + c F + F - 1 (those
// below S) of tokens [st Ts, st Ts + tend). One strip: lane 0 copies the
// chunk's frames in one span; strips: lane f copies frame 1 + c F + f's row.
template <int K, bool kVec>
__device__ void produce(const Mas& a, int b, uint64_t* full, uint64_t* empty, float* ring,
                        int lane) {
  const int S = a.S, T = a.T, F = a.frames, NC = a.chunks;
  const int Ts = 32 * K * a.warps, nch = (S - 1 + F - 1) / F;
  const float* llb = a.ll + static_cast<size_t>(b) * S * T;
  auto start = [&](int s, int tok0) {
    return reinterpret_cast<uintptr_t>(llb + static_cast<size_t>(s) * T + tok0);
  };
  // the 16-byte aligned interior of chunk c into L2 ahead of its copy
  auto prefetch = [&](int c, int tok0, int tend) {
    const int s = 1 + c * F, n = min(F, S - s);
    if (c >= nch) return;
    if (a.strips == 1 && lane == 0) {
      const uintptr_t g0 = start(s, 0), a0 = (g0 + 15) & ~uintptr_t(15);
      const uintptr_t a1 = (g0 + 4ull * n * T) & ~uintptr_t(15);
      if (a1 > a0) prefetch_l2(reinterpret_cast<const void*>(a0), static_cast<unsigned>(a1 - a0));
    } else if (a.strips > 1 && lane < n) {
      const uintptr_t g0 = start(s + lane, tok0), a0 = (g0 + 15) & ~uintptr_t(15);
      const uintptr_t a1 = (g0 + 4ull * tend) & ~uintptr_t(15);
      if (a1 > a0) prefetch_l2(reinterpret_cast<const void*>(a0), static_cast<unsigned>(a1 - a0));
    }
  };
  for (int st = 0; st < a.strips; ++st) {
    const int tok0 = st * Ts, tend = min(T - tok0, Ts);
    for (int c = NC; c < 2 * NC; ++c) prefetch(c, tok0, tend);
    for (int c = 0; c < nch; ++c) {
      const int gc = st * nch + c, slot = gc % NC, s = 1 + c * F, n = min(F, S - s);
      if (gc >= NC) mbar_wait(&empty[slot], ((gc / NC) - 1) & 1);
      unsigned char* dst = reinterpret_cast<unsigned char*>(ring + slot * a.slot_floats);
      if (a.strips == 1) {
        if (lane == 0) {
          const uintptr_t g0 = start(s, 0);
          uintptr_t a0, a1;
          span_edges<kVec>(dst + (g0 & 15), g0, 4u * n * T, &full[slot], a0, a1);
          mbar_arrive_tx(&full[slot], static_cast<unsigned>(a1 - a0));
          if (a1 > a0)
            bulk_copy(dst + (g0 & 15) + (a0 - g0), reinterpret_cast<const void*>(a0),
                      static_cast<unsigned>(a1 - a0), &full[slot]);
        }
      } else {  // the frames' rows of this strip, one a lane, one arrival for the chunk
        if (lane < n) {
          const uintptr_t g0 = start(s + lane, tok0);
          unsigned char* row = dst + 4 * lane * a.row_floats + (g0 & 15);
          uintptr_t a0, a1;
          span_edges<kVec>(row, g0, 4u * tend, &full[slot], a0, a1);
          const unsigned bytes = static_cast<unsigned>(a1 - a0);
          const unsigned total = __reduce_add_sync(__activemask(), bytes);
          if (lane == 0) mbar_arrive_tx(&full[slot], total);
          __syncwarp(__activemask());
          if (bytes > 0)
            bulk_copy(row + (a0 - g0), reinterpret_cast<const void*>(a0), bytes, &full[slot]);
        }
      }
      prefetch(c + 2 * NC, tok0, tend);
    }
  }
}

// G = 32 / K lanes each hold G frames' K-bit fields (field j = frame j); after
// rounds 0 .. log2(G) - 1 lane i of the G holds frame i's fields of the G lanes
// (field f = lane f's bits): the frame's plain 32-bit choice word of those
// tokens. Round r exchanges fields with the lane (G / 2) >> r away.
template <int K>
__device__ __forceinline__ unsigned transpose_round(unsigned x, int lane, int r) {
  constexpr int G = 32 / K;
  const int j = (G / 2) >> r;
  unsigned m = 0;
#pragma unroll
  for (int f = 0; f < G; ++f)
    if ((f & j) == 0) m |= ((1u << K) - 1u) << (f * K);
  const bool hi = lane & j;
  const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
  const unsigned rot = __funnelshift_l(y, y, hi ? 32 - j * K : j * K);  // rotate left
  const unsigned keep = hi ? ~m : m;
  return (x & keep) | (rot & ~keep);
}

// The exchange slot store of lane 31 as one predicated store (no branch).
__device__ __forceinline__ void publish_if(bool p, unsigned long long* slot, unsigned tag,
                                           float v) {
  const unsigned long long x = (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.shared.u64 [%0], %1;\n}\n" ::"r"(
          smem_addr(slot)),
      "l"(x), "r"(static_cast<unsigned>(p)));
}

// One strip's forward for chain warp `warp`, as a stream of groups of G = 32 / K
// frames (K bits of each of G frames make a lane's word), each group one run of
// straight code in blocks of H frames:
// - the group's 32 likelihoods of the lane come into registers at its start;
// - a block's H left values (the warp before's last token at the frames before)
//   are loaded at its start and checked once;
// - the choice bits go to up to four words by token (no chain through one register);
// - the group before's word is transposed, a round after each of the first frames,
//   and stored at the group's end, so no shuffle latency sits between groups.
// kMasked: some token of the warp is masked or past the strip (it reads -1e9).
template <int K, bool kVec, bool kMasked>
__device__ __forceinline__ void strip_forward(const Mas& a, int b, int st, float (&v)[K],
                                              unsigned keep, unsigned char* smem,
                                              uint64_t* full, uint64_t* empty,
                                              unsigned long long* xs, const float* ring, int warp,
                                              int lane) {
  constexpr int G = 32 / K;
  constexpr int H = G < 4 ? G : 4;  // frames a hand-off check covers
  constexpr int kRounds = G == 8 ? 3 : 1;  // log2(G)
  constexpr int kWords = 4;  // bit accumulators: no chain through one register
  const int S = a.S, T = a.T, NW = a.warps, F = a.frames, NC = a.chunks, RW = a.row_floats;
  const int R = a.slots, Ts = 32 * K * NW, nch = (S - 1 + F - 1) / F, tok0 = st * Ts;
  const int tend = min(T - tok0, Ts), gpc = F / G, ngroups = nch * gpc;
  const unsigned tag0 = st * (1u + static_cast<unsigned>(nch) * F);  // a strip's frames, padded
  const float* llb = a.ll + static_cast<size_t>(b) * S * T;
  const int tl = warp * 32 * K + lane * K;  // the lane's first token in its strip
  // the value of frame s sits in slot (s - 1) & (R - 1): a group's G slots are contiguous
  unsigned long long* mine = xs + warp * R;
  const unsigned long long* before = xs + (warp > 0 ? warp - 1 : 0) * R;
  const float* cin = a.column + (static_cast<size_t>(b) * 2 + ((st + 1) & 1)) * S;
  float* cout = a.column + (static_cast<size_t>(b) * 2 + (st & 1)) * S;
  const bool to_column = K == 16 && warp == NW - 1 && st + 1 < a.strips;
  const int m = (tok0 + warp * 32 * K) / 32 + lane / G;  // this lane's word of a choice row
  publish_if(lane == 31, mine + (R - 1), tag0, v[K - 1]);
  if (to_column && lane == 31) cout[0] = v[K - 1];

  auto wait_chunk = [&](int c) {
    const int gc = st * nch + c;
    mbar_wait(&full[gc % NC], (gc / NC) & 1);
  };
  auto load_group = [&](int g, float (&dst)[G][K]) {
    const int c = g / gpc, grp = g - c * gpc, gc = st * nch + c;
    const float* chunk = ring + (gc % NC) * a.slot_floats + tl;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float* row = chunk + (grp * G + j) * RW;
      if (!kVec) {  // the ragged start of the chunk's span (one strip) or of the row
        const int f = a.strips == 1 ? c * F + 1 : 1 + g * G + j;
        row += static_cast<int>(
            (reinterpret_cast<uintptr_t>(llb + static_cast<size_t>(f) * T + tok0) >> 2) & 3);
      }
      if constexpr (kVec && K % 4 == 0) {
#pragma unroll
        for (int k = 0; k < K; k += 4) {
          float4 x = make_float4(kNeg, kNeg, kNeg, kNeg);
          if (tl + k < tend) x = *reinterpret_cast<const float4*>(row + k);
          dst[j][k] = x.x;
          dst[j][k + 1] = x.y;
          dst[j][k + 2] = x.z;
          dst[j][k + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) dst[j][k] = tl + k < tend ? row[k] : kNeg;
      }
    }
  };

  unsigned pending = 0;  // the group before's word, transposed over this group
  int pending_q = -1;    // and its lane's choice row (-1: none)
#pragma unroll 1
  for (int g = 0; g < ngroups; ++g) {
    const int s0 = 1 + g * G;
    if (g % gpc == 0) wait_chunk(g / gpc);
    float lg[G][K];
    load_group(g, lg);
    unsigned long long* pub = mine + ((s0 - 1) & (R - 1));
    unsigned wk[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) wk[k] = 0;
#pragma unroll
    for (int h = 0; h < G; h += H) {
      const int n = g * (G / H) + h / H;  // this block
      float edge[H];
      if (warp > 0) {
        unsigned long long x[H];
        bool ready = true;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          x[i] = *reinterpret_cast<const volatile unsigned long long*>(
              before + ((n * H - 1 + i) & (R - 1)));
          ready &= static_cast<unsigned>(x[i] >> 32) == tag0 + n * H + i;
        }
        if (!ready) {
#pragma unroll
          for (int i = 0; i < H; ++i)
            x[i] = __float_as_uint(
                await(before + ((n * H - 1 + i) & (R - 1)), tag0 + n * H + i));
        }
#pragma unroll
        for (int i = 0; i < H; ++i) edge[i] = __uint_as_float(static_cast<unsigned>(x[i]));
      } else if (K == 16 && st > 0) {
#pragma unroll
        for (int i = 0; i < H; ++i) edge[i] = cin[min(n * H + i, S - 1)];
      } else {
#pragma unroll
        for (int i = 0; i < H; ++i) edge[i] = kNeg;
      }
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int j = h + i, s = s0 + j;
        float left = __shfl_up_sync(0xffffffffu, v[K - 1], 1);
        if (lane == 0) left = edge[i];
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
          const float up = k > 0 ? v[k - 1] : left;
          if (up >= v[k]) wk[k % kWords] |= 1u << (j * K + k);
          float lk = lg[j][k];
          if constexpr (kMasked) lk = (keep >> k) & 1u ? lk : kNeg;
          v[k] = lk + max_nan(v[k], up);
        }
        publish_if(lane == 31, pub + j, tag0 + s, v[K - 1]);
        if (to_column && lane == 31 && s < S) cout[s] = v[K - 1];
        // the group before's word: a transpose round after each of the first frames
        if (j < kRounds) pending = transpose_round<K>(pending, lane, j);
      }
    }
    if (pending_q >= 0 && pending_q < S - 1 && m < a.W) store_choice(a, b, pending_q, m, pending, smem);
    if ((g + 1) % gpc == 0) {  // the chunk is read: its slot goes back to the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(st * nch + g / gpc) % NC]);
    }
    pending = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) pending |= wk[k];
    pending_q = s0 - 1 + (lane & (G - 1));
  }
  if (pending_q >= 0) {  // the last group's word
#pragma unroll
    for (int r = 0; r < kRounds; ++r) pending = transpose_round<K>(pending, lane, r);
    if (pending_q < S - 1 && m < a.W) store_choice(a, b, pending_q, m, pending, smem);
  }
}

// Chain warp `warp` of NW: the forward of every strip, storing the choices.
template <int K, bool kVec>
__device__ void chain(const Mas& a, int b, unsigned char* smem, uint64_t* full, uint64_t* empty,
                      unsigned long long* xs, const float* ring, int warp, int lane) {
  const int T = a.T, Ts = 32 * K * a.warps;
  const float* tmb = a.tmask + static_cast<size_t>(b) * T;
  const int tl = warp * 32 * K + lane * K;
  for (int st = 0; st < a.strips; ++st) {
    const int tok0 = st * Ts, tend = min(T - tok0, Ts);
    unsigned keep = 0;  // bit k: token k of the lane reads its likelihood, else -1e9
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (tl + k < tend && tmb[tok0 + tl + k] != 0.f) keep |= 1u << k;
      v[k] = kNeg;
    }
    const bool masked = keep != (1u << K) - 1u;
    if (st == 0 && tl == 0 && (keep & 1u)) v[0] = a.ll[static_cast<size_t>(b) * a.S * T];
    if (__any_sync(0xffffffffu, masked))
      strip_forward<K, kVec, true>(a, b, st, v, keep, smem, full, empty, xs, ring, warp, lane);
    else
      strip_forward<K, kVec, false>(a, b, st, v, keep, smem, full, empty, xs, ring, warp, lane);
    if (a.strips > 1) chain_barrier(32 * a.warps);  // this strip's column is written
  }
}

// Bit e: the choice at token t - 31 + e of the row (a token below 0 reads token 0's).
__device__ __forceinline__ unsigned window(const unsigned* row, int t) {
  const int lo = t - 31;
  if (lo >= 0) return __funnelshift_r(row[lo >> 5], row[t >> 5], lo & 31);
  const unsigned w0 = row[0];
  const unsigned fill = (w0 & 1u) ? ~0u : 0u;
  if (t < 0) return fill;
  const int n = -lo;  // 1 .. 31 tokens below 0
  return (w0 << n) | (fill >> (32 - n));
}

// Warp 0 of block 0, once the forward is done: the walk from the row's last
// frame, 32 frames a batch, and the ones of the alignment ((1 * fmask[s]) *
// tmask[path[s]]; a negative path: a zero row, already written). The ring,
// which the forward no longer needs, holds the batch's 32 windows (every lane
// reads all of them back as broadcasts) and the row's token mask.
__device__ void backtrace(const Mas& a, int b, const int* lens, unsigned char* smem, float* ring,
                          cg::cluster_group& cluster, int lane) {
  const int S = a.S, T = a.T;
  const float* fmb = a.fmask + static_cast<size_t>(b) * S;
  const float* tmb = a.tmask + static_cast<size_t>(b) * T;
  float* outb = a.out + static_cast<size_t>(b) * S * T;
  unsigned* windows = reinterpret_cast<unsigned*>(ring);
  const bool staged = T + 32 <= a.chunks * a.slot_floats;
  if (staged)
    for (int t = lane; t < T; t += 32) ring[32 + t] = tmb[t];
  __syncwarp();
  const float* tm = staged ? ring + 32 : tmb;
  const int s_len = lens[0], t_len = lens[1];
  const int end = max(t_len - 1, 0);
  const int start = min(S - 1, s_len - 1);  // frames above it hold the end token
  for (int s = max(start, 0) + 1 + lane; s < S; s += 32)
    outb[static_cast<size_t>(s) * T + end] = (1.f * __ldg(fmb + s)) * tm[end];
  int t = end;
  // lane j's frame mask, one batch ahead
  float f = lane < min(32, start) ? __ldg(fmb + start - lane) : 0.f;
#pragma unroll 1
  for (int hi = start; hi >= 1; hi -= 32) {
    const int n = min(32, hi);
    const float f_next = lane < min(32, hi - 32) ? __ldg(fmb + hi - 32 - lane) : 0.f;
    windows[lane] = lane < n ? window(choice_row(a, b, hi - lane - 1, smem, cluster), t) : 0u;
    __syncwarp();
    unsigned ws[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(windows)[q];
      ws[4 * q] = x.x;
      ws[4 * q + 1] = x.y;
      ws[4 * q + 2] = x.z;
      ws[4 * q + 3] = x.w;
    }
    __syncwarp();  // every lane holds the windows before the next batch writes them
    // two frames a step: from e, frame j moves by ws[j][e] and frame j + 1 by
    // ws[j+1][e - ws[j][e]], so the pair moves by A[e] + B[e] with A = ws[j] | ws[j+1]
    // and B = ws[j] & (ws[j+1] << 1) (e >= 1 at every pair: it starts at 31 and
    // falls by at most one a frame)
    int e = 31, here = 0;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const unsigned A = ws[j] | ws[j + 1], B = ws[j] & (ws[j + 1] << 1);
      if (lane == j) here = e;
      if (lane == j + 1) here = e - static_cast<int>((ws[j] >> e) & 1u);
      e -= static_cast<int>((A >> e) & 1u) + static_cast<int>((B >> e) & 1u);
    }
    const int p = t - 31 + here;
    if (lane < n && p >= 0) outb[static_cast<size_t>(hi - lane) * T + p] = (1.f * f) * tm[p];
    t += e - 31;
    f = f_next;
  }
  if (lane == 0 && t >= 0) outb[t] = (1.f * __ldg(fmb)) * tm[t];
}

// Blocks 1 .. C-1: the row's masked zeros ((0 * fmask[s]) * tmask[t]), S / (C - 1)
// frames a block; a thread keeps its columns' mask and walks down the frames.
__device__ void write_zeros(const Mas& a, int b, int rank, int C) {
  const int S = a.S, T = a.T, writers = C - 1;
  const int lo = static_cast<int>(static_cast<long long>(S) * (rank - 1) / writers);
  const int hi = static_cast<int>(static_cast<long long>(S) * rank / writers);
  const float* fmb = a.fmask + static_cast<size_t>(b) * S;
  const float* tmb = a.tmask + static_cast<size_t>(b) * T;
  float* outb = a.out + static_cast<size_t>(b) * S * T;
  if (T % 4 == 0 && (reinterpret_cast<uintptr_t>(outb) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(tmb) & 15) == 0) {
    for (int c = threadIdx.x; c < T / 4; c += blockDim.x) {
      const float4 tm = __ldg(reinterpret_cast<const float4*>(tmb) + c);
      float4* o = reinterpret_cast<float4*>(outb + static_cast<size_t>(lo) * T) + c;
#pragma unroll 4
      for (int s = lo; s < hi; ++s, o += T / 4) {
        const float z = 0.f * __ldg(fmb + s);
        *o = make_float4(z * tm.x, z * tm.y, z * tm.z, z * tm.w);
      }
    }
  } else {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const float tm = __ldg(tmb + t);
#pragma unroll 4
      for (int s = lo; s < hi; ++s) outb[static_cast<size_t>(s) * T + t] = (0.f * __ldg(fmb + s)) * tm;
    }
  }
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kBlockThreads<K>) mas_wavefront(Mas a) {
  static_assert(K == 4 || K == 16, "mas_plan picks K = 4 or 16");
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NC = a.chunks;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NC;
  float* red = reinterpret_cast<float*>(smem + 16 * NC);
  int* lens = reinterpret_cast<int*>(red + 64);
  unsigned long long* xs = reinterpret_cast<unsigned long long*>(smem + a.xs_off);
  float* ring = reinterpret_cast<float*>(smem + a.ring_off);

  if (rank == 0) {
    if (tid == 0) {
      for (int i = 0; i < NC; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], a.warps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int i = tid; i < a.warps * a.slots; i += blockDim.x) xs[i] = ~0ull;  // no tag
    row_lengths(a, b, red, lens);  // its barriers publish the above
  }
  cluster.sync();  // every block runs before any reaches into another's shared memory

  if (rank != 0) {
    write_zeros(a, b, rank, C);
  } else if (a.S > 1) {
    if (warp < a.warps)
      chain<K, kVec>(a, b, smem, full, empty, xs, ring, warp, lane);
    else
      produce<K, kVec>(a, b, full, empty, ring, lane);
  }
  cluster_arrive();  // the zeros and the choices, before the ones and the walk
  cluster_wait();
  if (rank == 0 && warp == 0) backtrace(a, b, lens, smem, ring, cluster, lane);
  cluster_arrive();  // every block's choices stay until the walk is done
  cluster_wait();
}

template <int K, bool kVec>
cudaError_t launch(const Mas& a, int B, int cluster, int smem, cudaStream_t stream) {
  cudaError_t err = vk_set_smem_once<mas_wavefront<K, kVec>>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(32 * (a.warps + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mas_wavefront<K, kVec>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const Mas& a, bool vec, int B, int cluster, int smem, cudaStream_t stream) {
  return vec ? launch<K, true>(a, B, cluster, smem, stream)
             : launch<K, false>(a, B, cluster, smem, stream);
}

}  // namespace

// The alignment of ll (B, S, T) under the 1/0 masks fmask (B, S) and tmask
// (B, T), all fp32, into out (B, S, T), by ops/cuda/align.py::mas_plan's plan:
// K tokens a lane, `warps` chain warps, chunks of `frames` frames, a ring of
// `chunks` slots of `slot_floats` floats, `slots` exchange slots a warp, choice
// rows0 rows in block 0 and rows1 in each other block, block 0's layout
// (xs_off, ring_off, base_off bytes), clusters of `cluster` blocks of `smem`
// bytes of shared memory. scratch: (B, S - 1, ceil(T / 32)) words of device
// scratch for the choices where the cluster cannot hold them (null otherwise);
// column: (B, 2, S) floats where the tokens run in more than one strip (null
// otherwise). The plan is taken as given; refused where it would reach past a
// block's shared memory or break what the kernel relies on.
VK_EXPORT int vk_monotonic_align(const float* ll, const float* fmask, const float* tmask,
                                 float* out, unsigned* scratch, float* column, int B, int S, int T,
                                 int K, int warps, int frames, int chunks, int slot_floats,
                                 int slots, int rows0, int rows1, int xs_off, int ring_off,
                                 int base_off, int cluster, int smem, void* stream) {
  if (B < 1 || S < 1 || T < 1 || (K != 4 && K != 16) || warps < 1 ||
      warps > (K == 16 ? kMaxWarps : kMaxWarpsNarrow) || frames < 1 || frames % (32 / K) ||
      frames > 32 || chunks < 2 || chunks > 8 || cluster < 2 || cluster > kMaxCluster ||
      smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  const int Ts = 32 * K * warps, strips = (T + Ts - 1) / Ts;
  if ((strips > 1) != (column != nullptr) || (strips > 1 && K != 16)) return cudaErrorInvalidValue;
  const int row_floats = strips == 1 ? T : Ts + 4;
  const long long W = (T + 31) / 32, rows = S - 1, G = 32 / K;
  // the exchange: a power of two past the frames the ring holds (no slot is
  // overwritten before it is read); the ring's slots hold their chunk's frames
  if (slots & (slots - 1) || slots <= chunks * frames ||
      slot_floats % 4 || slot_floats < static_cast<long long>(frames) * row_floats + 4 ||
      xs_off % 16 || xs_off < 16 * chunks + 4 * 64 + 4 * 2 || ring_off % 128 ||
      ring_off < xs_off + 8LL * warps * slots ||
      base_off < ring_off + 4LL * chunks * slot_floats || base_off > smem)
    return cudaErrorInvalidValue;
  if (scratch != nullptr ? rows0 != 0 || rows1 != 0
                         : rows0 < 0 || rows1 < 0 || base_off + 4 * W * rows0 > smem ||
                               4 * W * rows1 > smem ||
                               (rows0 < rows && (rows0 % G || rows1 < G || rows1 % G ||
                                                 rows0 + (cluster - 1) * rows1 < rows)))
    return cudaErrorInvalidValue;
  Mas a = {ll, fmask, tmask, out, scratch, column, S, T, static_cast<int>(W), warps, strips,
           frames, chunks, row_floats, slot_floats, slots, rows0, rows1, xs_off, ring_off,
           base_off};
  const bool vec = T % 4 == 0 && (reinterpret_cast<uintptr_t>(ll) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K == 4 ? launch_k<4>(a, vec, B, cluster, smem, st)
                : launch_k<16>(a, vec, B, cluster, smem, st);
}
