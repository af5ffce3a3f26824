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
// What bounds it on this card: operations (53.9 GFLOP of visible pairs at
// the training shape, M 8522, 12/12 heads, hd 128, against about 210 MB).
// The body is mtp_tc.cuh, for float32 (the training dtype) and bfloat16
// alike: a depth-split walk of index lists of the keys that skips the
// depth > 0 keys of other chains, on mma.sync in 3xTF32 (float32 accuracy
// from three TF32 products), with a cp.async ring of gathered K/V rows.
// The index lists (order, okey, counts) come from ops.mtp_key_lists.
#include "mtp_tc.cuh"

extern "C" int mtp_attention_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* depth, const void* order, const void* okey,
    const void* counts, void* out, void* m_out, void* l_out, int B, int M,
    int H, int KV, int hd, float scale, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos_i = static_cast<const int*>(pos);
  const int* depth_i = static_cast<const int*>(depth);
  const long long* order_i = static_cast<const long long*>(order);
  const int* okey_i = static_cast<const int*>(okey);
  const int* counts_i = static_cast<const int*>(counts);
  if (is_bf16) {
    using T = __nv_bfloat16;
    repro_mtp_tc::Params<T> p{
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos_i, depth_i, order_i, okey_i, counts_i,
        static_cast<T*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), B, M, H, KV, scale};
    return repro_mtp_tc::launch(p, hd, st);
  }
  repro_mtp_tc::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos_i, depth_i, order_i, okey_i, counts_i,
      static_cast<float*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), B, M, H, KV, scale};
  return repro_mtp_tc::launch(p, hd, st);
}
