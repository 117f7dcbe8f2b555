// Kernel A, the relative-position flash attention: the exact tier's
// instantiations and the entry point (rel_attention.cuh has the kernel and its
// note; the other tiers compile in rel_attention_fast.cu and rel_attention_high.cu).
#include "rel_attention.cuh"

cudaError_t attn_fwd::exact(VK_ATTN_FWD_ARGS) {
  return launch_mode<kExact, float>(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
}

// mode: the tier of the products (TierMode); bf16: q, k, v, the tables and out
// are bf16 storage (the kFast tier only), else fp32.
VK_EXPORT int vk_rel_attention(const void* q, const void* k, const void* v, const void* rel_k,
                               const void* rel_v, const int* lengths, void* out, float* lse,
                               int B, int H, int L, int d, int w, int mode, int bf16,
                               void* stream) {
  if (d < 1 || d > kMaxD || w < 0 || w > kMaxW || L < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return mode == kFast
               ? attn_fwd::fast16(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s)
               : cudaErrorInvalidValue;
  switch (mode) {
    case kExact:
      return attn_fwd::exact(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case kFast:
      return attn_fwd::fast(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    case kHigh:
      return attn_fwd::high(q, k, v, rel_k, rel_v, lengths, out, lse, B, H, L, d, w, s);
    default:
      return cudaErrorInvalidValue;
  }
}
