// Kernel 4, the attention backward: fp32 storage's instantiations and the entry
// point (rel_attention_bwd.cuh has the kernel and its note; bf16 storage compiles
// in rel_attention_bwd16.cu).
#include "rel_attention_bwd.cuh"

cudaError_t attn_bwd::typed32(VK_ATTN_BWD_ARGS) {
  return launch_typed<float>(q, k, v, rel_k, rel_v, lengths, lse, drow, dout, dq, dk, dv,
                             drk_part, drv_part, B, H, L, d, w, mode, s);
}

// Gradients of rel_attention for (B, H, L, d) contiguous q (pre-scaled), k, v,
// dout and the forward's lse, with drow[b, h, i] = dout_i . out_i (fp32). Writes
// dq, dk, dv (B, H, L, d) and, per (b, h, 16-query tile), fp32 partial
// rel-embedding gradients drk_part, drv_part (B, H, ceil(L/16), 2w+1, d).
// mode: the tier of the products (TierMode); bf16: q, k, v, the tables, dout,
// dq, dk and dv are bf16 storage (the kFast tier only), else fp32 (kExact only).
VK_EXPORT int vk_rel_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* rel_k, const void* rel_v, const int* lengths,
                                   const float* lse, const float* drow, const void* dout,
                                   void* dq, void* dk, void* dv, float* drk_part,
                                   float* drv_part, int B, int H, int L, int d, int w, int mode,
                                   int bf16, void* stream) {
  if (d < 1 || d > kMaxD || w < 0 || w > kMaxW || L < 1 || B < 1 || H < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? attn_bwd::typed16(q, k, v, rel_k, rel_v, lengths, lse, drow, dout, dq, dk, dv,
                                  drk_part, drv_part, B, H, L, d, w, mode, s)
              : attn_bwd::typed32(q, k, v, rel_k, rel_v, lengths, lse, drow, dout, dq, dk, dv,
                                  drk_part, drv_part, B, H, L, d, w, mode, s);
}
