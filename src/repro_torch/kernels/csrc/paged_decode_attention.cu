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
// verify launch at batch 8 reads ~5 MB of live K/V for ~9 MFLOP). What the
// design does about it: it is the decode kernel's body with a third way of
// addressing keys (attention_common.cuh). Key j of row b resolves, one key
// per lane, to pool page block_table[b, j / page] at offset j % page, so a
// 32-key tile may span several pages (the serving page is 16 positions).
// Unallocated table entries (-1) and ids outside the pool read as position
// -1: they never count as visible, their K/V is never loaded, and unlike the
// TPU kernel's clamp to page 0 they cannot alias another request's page.
// Tiles with no visible key are skipped before any K/V load, as in the
// contiguous kernel, so a launch reads the row's live pages only. Page
// loads through cp.async or TMA and split-K are left to later work.
#include "attention_common.cuh"

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* pos_pool, const void* block_table, const void* q_positions,
    void* out, void* m_out, void* l_out, int B, int T, int H, int KV,
    int n_pages, int page, int nb, int hd, float scale, int window,
    int is_bf16, void* stream) {
  constexpr int kRows = 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = nb * page;   // keys a row addresses through its table
  if (is_bf16) {
    repro_attn::Params<__nv_bfloat16> p{
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(pos_pool), static_cast<const int*>(q_positions),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), B, T, H, KV, S, S, /*causal=*/1, window,
        scale, /*softcap=*/0.f, nullptr, nullptr,
        static_cast<const int*>(block_table), page, n_pages};
    return repro_attn::launch<kRows>(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(pos_pool),
      static_cast<const int*>(q_positions), static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, T, H, KV, S,
      S, /*causal=*/1, window, scale, /*softcap=*/0.f, nullptr, nullptr,
      static_cast<const int*>(block_table), page, n_pages};
  return repro_attn::launch<kRows>(p, hd, st);
}
