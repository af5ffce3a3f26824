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
// tokens, 12 heads over 2 KV heads, hd 128) a launch moves about 29 MB and
// does about 6.4 GFLOP causal: bytes bound by a small margin on the
// tensor-core roofline, but this kernel does its products with f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), where the FLOPs are the limit. What the
// design does about it: a block holds 64 query rows, ordered (token, head)
// so the 6 heads sharing a KV head read each K/V tile once, and tiles past
// the causal edge of the block's last token are skipped, which halves the
// work of a causal prefill. Tensor-core MMAs (mma.sync / wgmma), TMA and
// warp specialisation are left to later work.
#include "attention_common.cuh"

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Skv, int H, int KV, int hd, float scale, int causal, int window,
    float softcap, int kv_len, int is_bf16, void* stream) {
  constexpr int kRows = 64;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    repro_attn::Params<__nv_bfloat16> p{
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), nullptr, nullptr,
        static_cast<__nv_bfloat16*>(out), nullptr, nullptr,
        B, Sq, H, KV, Skv, kv_len, causal, window, scale, softcap};
    return repro_attn::launch<kRows>(p, hd, st);
  }
  repro_attn::Params<float> p{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), nullptr, nullptr, static_cast<float*>(out),
      nullptr, nullptr, B, Sq, H, KV, Skv, kv_len, causal, window, scale,
      softcap};
  return repro_attn::launch<kRows>(p, hd, st);
}
