// MTP attention for the H100 (sm_90a): the forward of the drafter's
// training attention over COD-expanded positions, under the closed-form MTP
// predicate
//
//     attend((qd, qp) -> (kd, kp))  <=>  (kd = 0 and kp <= qp - qd)
//                                    or (kp - kd = qp - qd and kd <= qd)
//
// evaluated from per-row int32 (pos, depth) arrays of shape (B, M); pad rows
// (depth -1) attend nothing and are written as zeros. No M x M mask exists
// anywhere: O(M) metadata instead of O(M^2) mask bytes.
//
// Replaces the TPU kernel repro/kernels/mtp_attention.py::mtp_attention
// (_mtp_kernel). The Pallas kernel took shared (M,) metadata and returned
// only the output; this one takes the per-row (B, M) metadata the trainer's
// batches carry and also returns the online-softmax stats (m, l) in
// (B, KV, G, M), which the recompute-by-block backward of
// core/flash_train.py reads (rows that see no key: m = -1e30, l = 0).
//
// What bounds it on this card: at the training shape (B 1, n 2048, K 8,
// r 0.8: M 8522, 12 heads over 12 KV heads, hd 128) a launch moves about
// 210 MB in float32 (q, k, v, out) and the visible (head, key) pairs need
// about 54 GFLOP: operations bound, on the CUDA cores in f32 as written. What the
// design does about it: it shares the decode/flash body (64 query rows per
// block, 32-key tiles, warp-per-row online softmax) with the MTP predicate
// as its visibility policy; since every visible key has kp <= qp and the
// COD layout is sorted by (p, g), the key tiles past the block's last
// position are skipped, which halves the work, as a causal mask would. The
// depth > 0 keys inside live tiles that belong to other chains are still
// scored and masked (about 3 of every 4 keys at r 0.8): a depth-0-first key
// order, tensor-core MMAs and TMA are left to later work.
#include "attention_common.cuh"

extern "C" int mtp_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* depth, void* out, void* m_out, void* l_out, int B, int M,
    int H, int KV, int hd, float scale, int is_bf16, void* stream) {
  constexpr int kRows = 64;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos_i = static_cast<const int*>(pos);
  const int* depth_i = static_cast<const int*>(depth);
  if (is_bf16) {
    repro_attn::Params<__nv_bfloat16> p{
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), pos_i, pos_i,
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), B, M, H, KV, M, M, /*causal=*/0,
        /*window=*/0, scale, /*softcap=*/0.f, depth_i, depth_i};
    return repro_attn::launch<kRows, /*MTP=*/true>(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos_i, pos_i, static_cast<float*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), B, M, H, KV, M,
      M, /*causal=*/0, /*window=*/0, scale, /*softcap=*/0.f, depth_i, depth_i};
  return repro_attn::launch<kRows, /*MTP=*/true>(p, hd, st);
}
