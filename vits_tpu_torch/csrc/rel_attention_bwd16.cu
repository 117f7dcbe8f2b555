// Kernel 4 on bf16 storage (rel_attention_bwd.cuh).
#include "rel_attention_bwd.cuh"

cudaError_t attn_bwd::typed16(VK_ATTN_BWD_ARGS) {
  return launch_typed<__nv_bfloat16>(q, k, v, rel_k, rel_v, lengths, lse, drow, dout, dq, dk,
                                     dv, drk_part, drv_part, B, H, L, d, w, mode, s);
}
