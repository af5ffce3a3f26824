// Building blocks shared by the tensor-core bodies of the flash
// (flash_tc.cuh, wgmma), decode and paged decode (decode_splitk.cuh,
// mma.sync) and MTP (mtp_tc.cuh, mma.sync in TF32) kernels: 16-byte
// asynchronous copies into shared memory (cp.async), the hi/lo split of f32
// probabilities into two bf16 MMA operands, the online softmax over a tile
// of scores held in accumulator registers, the shared-memory opt-in, and
// the error string every kernel library exports.
//
// Accumulator layout (mma.sync m16n8k16 and m16n8k8, and per warp of a
// wgmma m64nNk16):
// lane = 4 * g + t holds, for each 8-column tile j, rows g (c0, c1) and
// g + 8 (c2, c3) at columns 8j + 2t, 8j + 2t + 1. The A operand (16 x 16
// per warp) holds rows g and g + 8 at columns 2t, 2t + 1 (regs 0, 1) and
// 2t + 8, 2t + 9 (regs 2, 3), so two neighbouring 8-column tiles of S are
// exactly the A fragment of the next product P·V, with no trip through
// shared memory.
//
// Why P is split: the kernels keep P in f32, as the TPU kernels do. One
// bf16 MMA of P·V would round p to 8 bits of mantissa first, which on
// peaked attention (scores of std 2) moves the output by several times the
// two-rounding-step limit the kernels are held to; p = hi + lo with
// hi = bf16(p), lo = bf16(p - hi) keeps 16 bits, and the two products sum
// into the same f32 accumulator.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_tc {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;    // the JAX package's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// the score of a masked (query, key) pair: exp2 of it is exactly 0
__device__ __forceinline__ float masked_score() { return __int_as_float(0xff800000); }

// 2^x in one MUFU.EX2 (2^-inf = +0); exp2f adds a denormal fix-up around it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; valid == false zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) -> hi = bf16(x, y), lo = bf16((x, y) - hi); x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The hi and lo A fragments of P for keys 16 kk .. 16 kk + 15 of a tile of
// probabilities held as accumulators.
template <int BK>
__device__ __forceinline__ void p_fragments(const float (&s)[BK / 8][4],
                                            int kk, uint32_t (&ph)[4],
                                            uint32_t (&pl)[4]) {
  split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
  split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
  split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
  split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
}

// Online softmax of one tile of masked scores s (masked entries -inf),
// in units where p = 2^(mult * (s - m)): mult = log2(e) for scores already
// scaled, scale * log2(e) for raw ones. The rows' running max m and
// partial sum l (this thread's columns only; the quad's four partial sums
// are added at the end) are updated, s is replaced by p, and the
// accumulator o is rescaled.
template <int HD, int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 8][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[HD / 8][4],
                                               float mult) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * mult);
    mb[i] = mx[i] * mult;
    m[i] = mx[i];
  }
  // m starts at -1e30, never -inf, so a masked score gives exp2(-inf) = 0
  // even in a row that has seen no key yet
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ex2(fmaf(s[nt][e], mult, -mb[e >> 1]));
      rs[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    o[dt][0] *= alpha[0];
    o[dt][1] *= alpha[0];
    o[dt][2] *= alpha[1];
    o[dt][3] *= alpha[1];
  }
}

// Opt in to `smem` bytes of dynamic shared memory for `kernel` once per
// device (setting it twice from two threads is harmless).
template <typename K>
int opt_in_smem(K kernel, size_t smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) done[dev] = true;
  }
  return (int)cudaSuccess;
}

}  // namespace repro_tc

// the message of a launch's error code, for the ctypes wrappers
extern "C" const char* repro_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
