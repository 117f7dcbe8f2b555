// Kernel A at the fast tier, fp32 and bf16 storage (rel_attention.cuh).
#include "rel_attention.cuh"

cudaError_t attn_fwd::fast(VK_ATTN_FWD_ARGS) {
  return launch_mode<kFast, float>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
}

cudaError_t attn_fwd::fast16(VK_ATTN_FWD_ARGS) {
  return launch_mode<kFast, __nv_bfloat16>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d,
                                           w, s);
}
