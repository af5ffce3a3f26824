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
// 12 heads over 2 KV heads, hd 128, 1024 cache slots, 576 live) moves
// 5.05 MB for about 9 MFLOP, far below the 295 FLOP/byte where the tensor
// cores would be the limit.
//
// Two bodies, chosen by dtype:
//   - bfloat16: decode_splitk.cuh, split-K over the cache slots on the
//     tensor cores (mma.sync, hi/lo P) with cp.async K/V tiles and a
//     combine pass; split-K is what fills the 132 SMs. `nsplit` and `chunk`
//     come from ops.decode_split, and the wrapper allocates the partials'
//     scratch (po, pm, pl) when nsplit > 1. `key_tile` and `row_tile` are
//     the tiles ops.decode_split assumed; they must equal kBK and kRows.
//   - float32: attention_common.cuh's f32-FMA body (16 rows a block); its
//     1e-4 absolute limit admits neither bf16 MMAs nor TF32.
// In both, the G query heads of a KV head share one block, so each K/V tile
// is read once per block rather than once per head, and tiles holding no
// key any row can see are skipped before their K/V is loaded.
#include "attention_common.cuh"
#include "decode_splitk.cuh"

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_positions,
    const void* q_positions, void* out, void* m_out, void* l_out, void* po,
    void* pm, void* pl, int B, int T, int H, int KV, int S, int hd,
    float scale, int window, int nsplit, int chunk, int key_tile,
    int row_tile, int is_bf16, void* stream) {
  constexpr int kRows = 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (key_tile != repro_decode_tc::kBK || row_tile != repro_decode_tc::kRows)
      return (int)cudaErrorInvalidValue;
    repro_decode_tc::Params p{
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(k_positions),
        static_cast<const int*>(q_positions), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out),
        static_cast<float*>(po), static_cast<float*>(pm), static_cast<float*>(pl),
        B, T, H, KV, S, window, nsplit, chunk, scale,
        /*block_table=*/nullptr, /*page=*/0, /*n_pages=*/0};
    return repro_decode_tc::launch</*PAGED=*/false>(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(k_positions),
      static_cast<const int*>(q_positions), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      B, T, H, KV, S, S, /*causal=*/1, window, scale, /*softcap=*/0.f};
  return repro_attn::launch<kRows>(p, hd, st);
}
