// The bfloat16 body of the flash kernel (flash_attention.cu), in the style
// of FlashAttention-2 on Hopper's warpgroup MMAs: S = Q·Kᵀ and O += P·V by
// wgmma with f32 accumulators, K/V tiles streamed through a two-stage
// cp.async ring in shared memory, online softmax in registers.
//
// Replaces, for bfloat16, the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel); the
// float32 path stays on attention_common.cuh's FMA body, whose 1e-4
// absolute limit admits neither bf16 MMAs nor TF32.
//
// What bounds it on this card: at the target prefill (B 8, 512 tokens, 12
// heads over 2 KV heads, hd 128, causal) a launch moves 29.4 MB and needs
// 6.46 GFLOP: bytes by a small margin (8.76 µs at 3.35 TB/s against 6.5 µs
// at 989 TFLOP/s). The hi/lo split of P (tc_common.cuh: the kernel keeps P
// in f32 as the TPU kernel does, and one bf16 rounding of P fails the
// card's limit) makes the tensor cores do about 9.7 GFLOP of MMA work.
//
// Design: one block is one warpgroup (4 warps, 128 threads) owning 64
// queries of one (batch row b, query head h): one wgmma M. Each warp holds
// the A fragments of its 16 query rows in registers, read once from global
// memory, so shared memory holds only K/V and three blocks fit an SM. Key
// tiles of 64 arrive by 16-byte cp.async into wgmma's 128-byte-swizzled
// layout; the next tile is in flight while tile i is multiplied. S is one
// m64n64 product per 16 columns of the head (K read K-major), O += P·V two
// m64n{hd}k16 products per 16 keys (P's hi and lo halves from registers,
// V read MN-major). Tiles past the causal edge of the block's last query,
// below the window of its first, or past kv_len are never loaded; masks
// are evaluated element by element only in edge tiles. The scale
// multiplies the f32 scores, inside the exponent of the softmax, or before
// the softcap where there is one; it is not folded into bf16 Q, which would
// round the scores. The causal query tiles launch longest first, so the
// heavy blocks do not land in the tail. GQA maps head h to KV head h / G;
// rows with no visible key end with l == 0 and are written as zeros. Head
// dim 32 is padded to 64 in shared memory and registers (zeros).
//
// Head dim 256 (gemma-7b's target). One warpgroup's 64 x 256 f32 O is 128
// registers a thread, and its Q fragments another 64: spilled. So at HD 256
// two blocks share each (b, h, 64 queries) and split O's columns (kNC 2):
// each computes S over all 256 columns (the second block's S is repeated
// work, about a third more tensor-core operations than the launch needs)
// and accumulates P·V into its 128 columns, from the 128 columns of V it
// loads. A thread then holds 64 accumulators and 64 Q registers, and a
// block's shared memory is a 32 KB K tile and a 16 KB V tile a stage,
// 97 KB in all, so two blocks fit an SM. gemma-7b's prefill (B 8 x 512,
// 16/16 heads) moves 134 MB for 17.2 GFLOP: bytes, a 40 µs bound.
#pragma once

#include "tc_common.cuh"

namespace repro_flash_tc {

using namespace repro_tc;

constexpr int kBQ = 64;        // queries per block: the M of one wgmma
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;

template <int HD> constexpr int kHP = HD < 64 ? 64 : HD;   // padded head dim
template <int HD> constexpr int kNC = HD == 256 ? 2 : 1;    // blocks a head
template <int HD> constexpr int kVW = kHP<HD> / kNC<HD>;    // O, V columns
template <int HD> constexpr int kKTile = kBK * kHP<HD> * 2;  // bytes a tile
template <int HD> constexpr int kVTile = kBK * kVW<HD> * 2;

template <int HD>
constexpr size_t smem_bytes() {   // K and V rings, and room to align them
  return 1024 + (size_t)(kKTile<HD> + kVTile<HD>) * kStages;
}

struct Params {
  const bf16* q;   // (B, Sq, H, hd)
  const bf16* k;   // (B, Skv, KV, hd)
  const bf16* v;   // (B, Skv, KV, hd)
  bf16* out;       // (B, Sq, H, hd)
  int B, Sq, Skv, H, KV, kv_len, causal, window;
  float scale, softcap;
};

// Byte offset of (row r, 16-byte chunk J) in a 64-row tile held as blocks
// of 64 columns (8 KB each, 1024-byte aligned), rows of 128 bytes, chunks
// XOR-swizzled by r % 8: wgmma's canonical 128-byte-swizzle layout, K-major
// for K (row = key) and MN-major for V (row = key, hd contiguous).
__device__ __forceinline__ uint32_t sw128(int r, int J) {
  return (J >> 3) * 8192 + r * 128 + (((J & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory matrix descriptor of that layout: start address,
// leading and stride byte offsets (in 16-byte units), 128-byte swizzle.
// K-major: stride 1024 B between 8-row groups, leading offset unused (1).
// MN-major: leading 8192 B between 64-column blocks, stride 1024 B between
// 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulators in place around asynchronous wgmma (the compiler must
// not move them while the tensor cores write them).
template <int N>
__device__ __forceinline__ void keep(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// D (64 x 64) (+)= A·B, A (64 x 16) in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[8][4],
                                               const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A·B, A (64 x 16) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A·B, A (64 x 16) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int VW>
__device__ __forceinline__ void wgmma_pv(float (&d)[VW / 8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(VW == 64 || VW == 128, "P·V is m64n64 or m64n128");
  if constexpr (VW == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// cp.async a 64-row tile (global row r at src + r * row_stride) into the
// swizzled layout; rows at or past `limit` and columns past HD are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          size_t row_stride, int row0,
                                          int limit, int tid) {
  constexpr int CPR = kHP<HD> / 8;   // 16-byte chunks per row
  for (int i = tid; i < kBK * CPR; i += kThreads) {
    const int r = i / CPR, J = i % CPR;
    const bool valid = row0 + r < limit && J * 8 < HD;
    const bf16* from = valid ? src + (size_t)(row0 + r) * row_stride + J * 8 : src;
    cp_async16(dst + sw128(r, J), from, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_tc_attention_kernel(Params p) {
  constexpr int HP = kHP<HD>, NC = kNC<HD>, VW = kVW<HD>;
  constexpr int KT = kKTile<HD>, VT = kVTile<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t base_s = (raw_s + 1023u) & ~1023u;   // swizzle atoms
  unsigned char* base = smem_raw + (base_s - raw_s);
  auto k_at = [](int stage) { return KT * stage; };                  // K ring
  auto v_at = [](int stage) { return KT * kStages + VT * stage; };   // V ring

  const int nqt = (p.Sq + kBQ - 1) / kBQ;
  const int q0 = (nqt - 1 - blockIdx.x) * kBQ;     // longest tiles first
  const int h = blockIdx.y / NC, b = blockIdx.z;
  const int c0 = (blockIdx.y % NC) * VW;           // this block's O columns
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_last = min(q0 + kBQ, p.Sq) - 1;

  // the keys some query of the block can see: [k_begin, k_end)
  const int kv_lim = min(p.kv_len, p.Skv);
  const int k_end = p.causal ? min(kv_lim, q_last + 1) : kv_lim;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end + kBK - 1) / kBK - t_begin : 0;

  const size_t q_row = (size_t)p.H * HD, kv_row = (size_t)p.KV * HD;
  const bf16* qb = p.q + ((size_t)b * p.Sq * p.H + h) * HD;
  const bf16* kb = p.k + ((size_t)b * p.Skv * p.KV + kvh) * HD;
  const bf16* vb = p.v + ((size_t)b * p.Skv * p.KV + kvh) * HD + c0;
  auto load_kv = [&](int tile, int stage) {
    load_tile<HD>(base + k_at(stage), kb, kv_row, tile * kBK, kv_lim, tid);
    load_tile<HD / NC>(base + v_at(stage), vb, kv_row, tile * kBK, kv_lim,
                       tid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {   // one commit group per tile
    if (i < n_tiles) load_kv(t_begin + i, i);
    cp_async_commit();
  }

  const int g = lane >> 2, tq = lane & 3;
  const int qi0 = q0 + warp * 16 + g;              // query of c0/c1; +8: c2/c3
  // this warp's 16 query rows as wgmma A fragments, one per 16 columns
  uint32_t qf[HP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HP / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = qi0 + (r & 1) * 8;
      const int c = kk * 16 + (r >> 1) * 8 + 2 * tq;
      qf[kk][r] = qi < p.Sq && c < HD
                      ? *reinterpret_cast<const uint32_t*>(qb + (size_t)qi * q_row + c)
                      : 0u;
    }
  float o[VW / 8][4];
#pragma unroll
  for (int dt = 0; dt < VW / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float softcap = p.softcap;
  // the scale rides in the exponent (f32) unless the softcap needs the
  // scaled score first; m is then in raw units, which nothing reads
  const float mult = softcap > 0.f ? kLog2e : p.scale * kLog2e;
  const float cap_mult = softcap > 0.f ? p.scale / softcap : 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int tile = t_begin + it;
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles) load_kv(t_begin + ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile `it` has landed
    // make the cp.async writes visible to wgmma's reads (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t ks = base_s + k_at(it % kStages);
    const uint32_t vs = base_s + v_at(it % kStages);

    float s[kBK / 8][4];
    keep(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk)
      wgmma_rs_n64_k(s, qf[kk],
                     sw128_desc(ks + (kk >> 2) * 8192 + (kk & 3) * 32, 1, 64),
                     kk > 0);
    wg_commit_wait();
    keep(s);

    const int k0 = tile * kBK;
    const bool edge = k0 + kBK > kv_lim || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window > 0 && q_last - k0 >= p.window);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        if (softcap > 0.f) x = cap_tanh(x * cap_mult, softcap);
        if (edge) {
          const int kj = k0 + nt * 8 + 2 * tq + (e & 1);
          const int qi = qi0 + (e >> 1) * 8;
          const bool ok = kj < kv_lim && (!p.causal || kj <= qi) &&
                          (p.window <= 0 || qi - kj < p.window);
          if (!ok) x = masked_score();
        }
        s[nt][e] = x;
      }
    online_softmax<VW, kBK>(s, m, l, o, mult);

    uint32_t ph[kBK / 16][4], pl[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) p_fragments<kBK>(s, kk, ph[kk], pl[kk]);
    keep(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {   // 16 keys = two 8-key groups
      const uint64_t dv = sw128_desc(vs + kk * 2048, 512, 64);
      wgmma_pv<VW>(o, ph[kk], dv);
      wgmma_pv<VW>(o, pl[kk], dv);
    }
    wg_commit_wait();
    keep(o);
    __syncthreads();        // stage `it % kStages` is refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = qi0 + i * 8;
    if (qi >= p.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* dst = p.out + (((size_t)b * p.Sq + qi) * p.H + h) * HD + c0 + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < HD / NC / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
  }
}

// whether the kernel of head dim HD has its shared memory opt-in, per
// device; internal linkage, so every library that holds the kernel keeps
// its own (a static inside the template would be one object across them)
namespace {
template <int HD> bool opted_in[64];
}

template <int HD>
int launch_hd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const int e = opt_in_smem(flash_tc_attention_kernel<HD>, smem, opted_in<HD>);
  if (e) return e;
  if (p.B == 0 || p.Sq == 0) return (int)cudaSuccess;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H * kNC<HD>, p.B);
  flash_tc_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

inline int launch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32>(p, stream);
    case 64: return launch_hd<64>(p, stream);
    case 128: return launch_hd<128>(p, stream);
    case 256: return launch_hd<256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_flash_tc
