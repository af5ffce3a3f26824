// Flash attention for the H100 (sm_90a): the target prefill forward,
// causal or sliding-window, optional tanh logit softcap, GQA, and keys at
// index >= kv_len masked.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel). The TPU grid walked KV blocks in order for each query
// tile, carrying the online-softmax state in VMEM scratch; here that walk is
// a loop inside one thread block, and the blocks of all query tiles run in
// parallel across the SMs.
//
// What bounds it on this card: at the serving prefill shape (B 8, 512
// tokens, 12 heads over 2 KV heads, hd 128) a launch moves 29.4 MB and
// needs 6.46 GFLOP causal: bytes by a small margin on the tensor-core
// roofline (8.76 µs).
//
// Two bodies, chosen by dtype:
//   - bfloat16: flash_tc.cuh, FlashAttention-2 style on the tensor cores
//     (wgmma, P·V as a hi/lo pair of bf16 products) with a two-stage
//     cp.async ring of 64-key K/V tiles, one warpgroup per (b, head, 64
//     queries);
//   - float32: attention_common.cuh's f32-FMA body, a block of 64 rows
//     ordered (token, head) so the heads sharing a KV head read each K/V
//     tile once; its 1e-4 absolute limit admits neither bf16 MMAs nor TF32.
// Both skip the key tiles past the causal edge of the block's last query.
#include "attention_common.cuh"
#include "flash_tc.cuh"

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Skv, int H, int KV, int hd, float scale, int causal, int window,
    float softcap, int kv_len, int is_bf16, void* stream) {
  constexpr int kRows = 64;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    repro_flash_tc::Params p{
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        B, Sq, Skv, H, KV, kv_len, causal, window, scale, softcap};
    return repro_flash_tc::launch(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), nullptr, nullptr, static_cast<float*>(out),
      nullptr, nullptr, B, Sq, H, KV, Skv, kv_len, causal, window, scale,
      softcap};
  return repro_attn::launch<kRows>(p, hd, st);
}
