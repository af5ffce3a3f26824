// Paged decode attention for the H100 (sm_90a): a few query positions per
// row against a KV cache held in a shared pool of fixed-size pages, which
// each row reaches through its block table.
//
// Replaces the TPU kernel
// repro/kernels/decode_attention.py::paged_decode_attention (_paged_kernel),
// which the JAX engine never calls (it gathers a contiguous view instead).
// On the port's paged serving path it runs phase 1 of every two-phase
// decode attention (target verify, drafter draft, drafter extend): the
// queries against the pool, positions >= the block's first position having
// been invalidated in the row's pages by the caller; phase 2 (the current
// block) stays with decode_attention. Like the port's decode kernel, and
// unlike the TPU kernel, it also returns the online-softmax stats (m, l) in
// (B, KV, G, T) for the phase merge.
//
// What bounds it on this card: bytes, as for decode_attention (a target
// verify launch at batch 8 reads ~5 MB of live K/V for ~9 MFLOP). Key j of
// row b lives at offset j % page of pool page block_table[b, j / page];
// unallocated table entries (-1) and ids outside the pool read as position
// -1: they never count as visible, their K/V is never loaded, and unlike
// the TPU kernel's clamp to page 0 they cannot alias another request's
// page. Two bodies, chosen by dtype, each shared with decode_attention.cu:
//   - bfloat16: decode_splitk.cuh with its paged key_slot(), split-K over
//     the nb * page slots a row addresses on mma.sync (hi/lo P), cp.async
//     K/V tiles of 64 keys (each key resolving its own page) and a combine
//     pass; `nsplit` and `chunk` come from ops.decode_split, and the
//     wrapper allocates the partials' scratch (po, pm, pl) when nsplit > 1.
//     `key_tile` and `row_tile` are the tiles ops.decode_split assumed.
//   - float32: attention_common.cuh's f32-FMA body (16 rows a block, one
//     key per lane through the table); its 1e-4 absolute limit admits
//     neither bf16 MMAs nor TF32.
// In both, tiles with no visible key are skipped before any K/V load, so a
// launch reads the row's live pages only.
#include "attention_common.cuh"
#include "decode_splitk.cuh"

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* pos_pool, const void* block_table, const void* q_positions,
    void* out, void* m_out, void* l_out, void* po, void* pm, void* pl, int B,
    int T, int H, int KV, int n_pages, int page, int nb, int hd, float scale,
    int window, int nsplit, int chunk, int key_tile, int row_tile,
    int is_bf16, void* stream) {
  constexpr int kRows = 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = nb * page;   // keys a row addresses through its table
  if (is_bf16) {
    if (key_tile != repro_decode_tc::kBK || row_tile != repro_decode_tc::kRows)
      return (int)cudaErrorInvalidValue;
    repro_decode_tc::Params p{
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(pos_pool), static_cast<const int*>(q_positions),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(po),
        static_cast<float*>(pm), static_cast<float*>(pl), B, T, H, KV, S,
        window, nsplit, chunk, scale, static_cast<const int*>(block_table),
        page, n_pages};
    return repro_decode_tc::launch</*PAGED=*/true>(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(pos_pool),
      static_cast<const int*>(q_positions), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, T, H, KV, S,
      S, /*causal=*/1, window, scale, /*softcap=*/0.f,
      static_cast<const int*>(block_table), page, n_pages};
  return repro_attn::launch<kRows>(p, hd, st);
}
