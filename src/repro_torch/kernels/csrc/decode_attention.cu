// Decode attention for the H100 (sm_90a): a few query positions per row
// against a KV cache whose slots carry absolute positions (-1 = empty).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel), the split-K flash-decode of the speculative verify and
// of the drafter. On the serving path it runs both phases of every
// two-phase attention: phase 1 against the cache (positions >= the block's
// first position masked by the caller), phase 2 against the current block
// with k_positions = positions. Unlike the TPU kernel it also returns the
// online-softmax stats (m, l) in (B, KV, G, T), which the phase merge needs,
// and it takes any T (the drafter's prefill extend sends the whole prompt).
//
// What bounds it on this card: bytes. A target verify launch (B 8, T 6,
// 12 heads over 2 KV heads, hd 128, 1024 cache slots) reads 8.4 MB of K/V
// for about 9 MFLOP, far below the 295 FLOP/byte where the tensor cores
// would be the limit. What the design does about it: the G query heads of
// a KV head share one block, so each K/V tile is read once per block rather
// than once per head; tiles holding no key any row can see (empty slots
// past the prompt, keys past the causal edge) are skipped before their K/V
// is loaded, so a launch reads only the live part of the cache. Rows are
// tiled 16 at a time to put more blocks on the 132 SMs. Split-K across
// blocks, tensor-core MMAs and TMA pipelining are left to later work.
#include "attention_common.cuh"

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_positions,
    const void* q_positions, void* out, void* m_out, void* l_out, int B,
    int T, int H, int KV, int S, int hd, float scale, int window,
    int is_bf16, void* stream) {
  constexpr int kRows = 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    repro_attn::Params<__nv_bfloat16> p{
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(k_positions),
        static_cast<const int*>(q_positions), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out),
        B, T, H, KV, S, S, /*causal=*/1, window, scale, /*softcap=*/0.f};
    return repro_attn::launch<kRows>(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(k_positions),
      static_cast<const int*>(q_positions), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      B, T, H, KV, S, S, /*causal=*/1, window, scale, /*softcap=*/0.f};
  return repro_attn::launch<kRows>(p, hd, st);
}
