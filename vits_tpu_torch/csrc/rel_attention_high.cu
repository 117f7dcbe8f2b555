// Kernel A at the high tier (rel_attention.cuh).
#include "rel_attention.cuh"

cudaError_t attn_fwd::high(VK_ATTN_FWD_ARGS) {
  return launch_mode<kHigh, float>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
}
