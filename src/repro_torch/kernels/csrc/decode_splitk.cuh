// The bfloat16 body of the decode and paged decode kernels
// (decode_attention.cu, paged_decode_attention.cu): split-K flash-decode on
// the tensor cores. A few query positions per row against a KV cache whose
// slots carry absolute positions (-1 = empty), held per row or in a shared
// pool of pages reached through a block table.
//
// Replaces, for bfloat16, the TPU kernels
// repro/kernels/decode_attention.py::decode_attention (_decode_kernel) and
// ::paged_decode_attention (_paged_kernel); the float32 paths stay on
// attention_common.cuh's FMA body, whose 1e-4 absolute limit admits neither
// bf16 MMAs nor TF32 at these byte-bound shapes.
//
// What bounds it on this card: bytes. Target verify phase 1 (B 8, T 6, 12
// heads over 2 KV heads, hd 128, 1024 slots, 576 live) moves 5.05 MB, a
// 1.51 µs bound; the drafter's phase 1 (12 KV heads) about 28 MB, 8.5 µs.
// Both are far below the 295 FLOP/byte where the tensor cores would bind.
// A block per (batch row, KV head) walking its keys alone puts 16 blocks on
// the 132 SMs at target verify and is bound by the latency of its serial
// tiles; split-K is what fills the SMs.
//
// Design. Pass 1, grid (row tiles, B x KV, splits): a block owns one
// (b, KV head), up to 64 rows packed r = t * G + g (the G query heads of a
// KV head share each K/V tile), and one contiguous chunk of the cache
// slots. It first reads the chunk's key positions and lists the 64-key
// tiles some row can see; a chunk with none exits before any K/V load
// (empty slots past the prompt are never read). Live tiles arrive through
// a two-stage cp.async ring in bf16; each of the 4 warps holds 16 rows'
// Q fragments in registers, S = Q·Kᵀ and the hi/lo P·V (tc_common.cuh) run
// on mma.sync m16n8k16, and the positional mask (kp >= 0, kp <= qp, the
// window) is evaluated per key. With one split the block normalises and
// writes out and (m, l) itself; otherwise it writes its unnormalised f32
// partial o and (m, l) per (split, row) to scratch the wrapper allocated.
// Pass 2, the combine: each split's partial is rescaled by exp(m_i - m),
// summed and divided by l; splits with l == 0 drop out and rows with
// l == 0 are written as zeros. (m, l) leave in the (B, KV, G, T) layout
// the two-phase merge reads.
//
// Keys are addressed through key_slot() alone, a compile-time policy: slot
// b * S + j of (B, S) per row, or, paged, offset j % page of pool page
// block_table[b, j / page]. A 64-key tile spans several pages (the serving
// page is 16 slots) and each key resolves its own; a page id outside
// [0, n_pages) (-1 = unallocated) has no slot, reads as an empty key and is
// never loaded (cp.async zero-fills it), so it cannot alias another
// request's page. Both layouts instantiate this one body.
#pragma once

#include <climits>

#include "tc_common.cuh"

namespace repro_decode_tc {

using namespace repro_tc;

// mma.sync m16n8k16 building blocks: ldmatrix fragment loads from shared
// rows padded by 16 bytes, so that the eight rows an ldmatrix phase reads
// fall on distinct banks.

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a · b on the tensor cores, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// O += P·V for one 16-key step: the hi/lo halves of P (A fragments) against
// the V tile's 16 rows starting at v_rows (row stride `stride` elements),
// all HD columns. ldmatrix.trans turns the key-major V rows into the
// column-major B operand.
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4],
                                        const uint32_t (&ph)[4],
                                        const uint32_t (&pl)[4],
                                        const bf16* v_rows, int stride,
                                        int lane) {
  const bf16* base =
      v_rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + ((lane >> 4) & 1) * 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; dt += 2) {
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, base + dt * 8);
    mma_bf16(o[dt], ph, vf[0], vf[1]);
    mma_bf16(o[dt], pl, vf[0], vf[1]);
    mma_bf16(o[dt + 1], ph, vf[2], vf[3]);
    mma_bf16(o[dt + 1], pl, vf[2], vf[3]);
  }
}

// S = Q·Kᵀ for a 16-row Q (A fragments qf, one per 16 columns of HD) and a
// tile of BK keys whose rows start at k_rows (row stride `stride`).
template <int HD, int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 8][4],
                                        const uint32_t (&qf)[HD / 16][4],
                                        const bf16* k_rows, int stride,
                                        int lane) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const bf16* base =
      k_rows + ((lane & 7) + ((lane >> 4) & 1) * 8) * stride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < BK / 8; nt += 2) {
      uint32_t kf[4];
      ldmatrix_x4(kf, base + nt * 8 * stride + kk * 16);
      mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
      mma_bf16(s[nt + 1], qf[kk], kf[2], kf[3]);
    }
}

// The A fragments of 16 rows of Q held in shared memory (row stride
// `stride`), one per 16 columns of HD.
template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HD / 16][4],
                                             const bf16* q_rows, int stride,
                                             int lane) {
  const bf16* base =
      q_rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + ((lane >> 4) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], base + kk * 16);
}

// O += P·V over a whole tile of BK keys, P split into hi/lo bf16 halves.
template <int HD, int BK>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 8][4],
                                        const float (&s)[BK / 8][4],
                                        const bf16* v_rows, int stride,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t ph[4], pl[4];
    p_fragments<BK>(s, kk, ph, pl);
    pv_step<HD>(o, ph, pl, v_rows + kk * 16 * stride, stride, lane);
  }
}

constexpr int kRows = 64;        // packed (query, head) rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;
constexpr int kMaxTiles = 256;   // key tiles per chunk (ops.decode_split)
constexpr int kCombineThreads = 128;

template <int HD> constexpr int kStride = HD + 8;   // smem row, elements

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * kStride<HD> * (kRows + 2 * kStages * kBK) +
         sizeof(int) * (kStages * kBK + kRows + kMaxTiles) + kMaxTiles;
}

struct Params {
  const bf16* q;      // (B, T, H, hd)
  const bf16* k;      // (B, S, KV, hd), paged (n_pages, page, KV, hd)
  const bf16* v;      // as k
  const int* kpos;    // (B, S) key positions, -1 = empty; paged (n_pages, page)
  const int* qpos;    // (B, T) query positions
  bf16* out;          // (B, T, H, hd)
  float* m_out;       // (B, KV, G, T)
  float* l_out;       // (B, KV, G, T)
  float* po;          // (B * KV, nsplit, G * T, hd) partial o (nsplit > 1)
  float* pm;          // (B * KV, nsplit, G * T) partial m
  float* pl;          // (B * KV, nsplit, G * T) partial l
  int B, T, H, KV, S, window, nsplit, chunk;
  float scale;
  const int* block_table;  // (B, S / page) pool page ids (paged only)
  int page, n_pages;       // slots a page, pages in the pool (paged only)
};

// The cache slot of key j of batch row b, or -1 for none.
template <bool PAGED>
__device__ __forceinline__ long long key_slot(const Params& p, int b, int j) {
  if constexpr (!PAGED) {
    return (long long)b * p.S + j;
  } else {
    const int pg = p.block_table[(size_t)b * (p.S / p.page) + j / p.page];
    return pg >= 0 && pg < p.n_pages ? (long long)pg * p.page + j % p.page
                                     : -1;
  }
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
}

template <int HD, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decode_tc_attention_kernel(Params p) {
  constexpr int ST = kStride<HD>;
  constexpr int CPR = HD / 8;          // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // kRows x ST
  bf16* k_s = q_s + kRows * ST;                    // kStages x kBK x ST
  bf16* v_s = k_s + kStages * kBK * ST;            // kStages x kBK x ST
  int* kp_s = reinterpret_cast<int*>(v_s + kStages * kBK * ST);  // kStages x kBK
  int* qp_s = kp_s + kStages * kBK;                // kRows
  int* list_s = qp_s + kRows;                      // kMaxTiles: live tiles
  unsigned char* live_s = reinterpret_cast<unsigned char*>(list_s + kMaxTiles);
  __shared__ int qlo_s, qhi_s, nlive_s;

  const int G = p.H / p.KV, nrows = G * p.T;
  const int row0 = blockIdx.x * kRows;
  const int bk = blockIdx.y, b = bk / p.KV, kvh = bk % p.KV;
  const int split = blockIdx.z;
  const int c0 = split * p.chunk, c1 = min(p.S, c0 + p.chunk);
  const int ntiles = c1 > c0 ? (c1 - c0 + kBK - 1) / kBK : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    qlo_s = INT_MAX;
    qhi_s = INT_MIN;
  }
  for (int i = tid; i < ntiles; i += kThreads) live_s[i] = 0;
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int rr = i / CPR, c = (i % CPR) * 8, r = row0 + rr;
    const bool valid = r < nrows;
    const bf16* from =
        valid ? p.q + ((size_t)(b * p.T + r / G) * p.H + kvh * G + r % G) * HD + c
              : p.q;
    cp_async16(q_s + rr * ST + c, from, valid);
  }
  cp_async_commit();
  __syncthreads();
  if (tid < kRows) {
    const int r = row0 + tid;
    int qp = -1;                         // rows past the end see no key
    if (r < nrows) {
      qp = p.qpos[(size_t)b * p.T + r / G];
      atomicMin(&qlo_s, qp);
      atomicMax(&qhi_s, qp);
    }
    qp_s[tid] = qp;
  }
  __syncthreads();

  // the chunk's tiles that hold a key some row of the block can see
  {
    const int qlo = qlo_s, qhi = qhi_s;
    for (int j = c0 + tid; j < c1; j += kThreads) {
      const long long slot = key_slot<PAGED>(p, b, j);
      const int kp = slot >= 0 ? p.kpos[slot] : -1;
      if (kp >= 0 && kp <= qhi && (p.window <= 0 || qlo - kp < p.window))
        live_s[(j - c0) / kBK] = 1;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool f = i < ntiles && live_s[i];
      const unsigned mask = __ballot_sync(0xffffffffu, f);
      if (f) list_s[n + __popc(mask & ((1u << lane) - 1u))] = i;
      n += __popc(mask);
    }
    if (lane == 0) nlive_s = n;
  }
  __syncthreads();
  const int nlive = nlive_s;

  auto load_tile = [&](int idx, int stage) {
    const int j0 = c0 + list_s[idx] * kBK;
    bf16* ks = k_s + stage * kBK * ST;
    bf16* vs = v_s + stage * kBK * ST;
    for (int i = tid; i < kBK * CPR; i += kThreads) {
      const int jj = i / CPR, c = (i % CPR) * 8, j = j0 + jj;
      const long long slot = j < c1 ? key_slot<PAGED>(p, b, j) : -1;
      const bool valid = slot >= 0;
      const size_t off = valid ? ((size_t)slot * p.KV + kvh) * HD + c : 0;
      cp_async16(ks + jj * ST + c, p.k + off, valid);
      cp_async16(vs + jj * ST + c, p.v + off, valid);
    }
    if (tid < kBK) {
      const int j = j0 + tid;
      const long long slot = j < c1 ? key_slot<PAGED>(p, b, j) : -1;
      kp_s[stage * kBK + tid] = slot >= 0 ? p.kpos[slot] : -1;
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {   // one commit group per tile
    if (i < nlive) load_tile(i, i);
    cp_async_commit();
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[HD / 16][4];
  const int g = lane >> 2, tq = lane & 3;
  const bool active = row0 + warp * 16 < nrows;   // warp has a real row
  const int qp_a = qp_s[warp * 16 + g], qp_b = qp_s[warp * 16 + g + 8];

  for (int it = 0; it < nlive; ++it) {
    const int ahead = it + kStages - 1;
    if (ahead < nlive) load_tile(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile `it` (and Q) has landed
    __syncthreads();
    if (active) {
      if (it == 0) load_q_frags<HD>(qf, q_s + warp * 16 * ST, ST, lane);
      const int stage = it % kStages;
      float s[kBK / 8][4];
      qk_tile<HD, kBK>(s, qf, k_s + stage * kBK * ST, ST, lane);
      const int* kps = kp_s + stage * kBK;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kps[nt * 8 + 2 * tq + (e & 1)];
          const bool ok = visible(kp, (e >> 1) ? qp_b : qp_a, p.window);
          s[nt][e] = ok ? s[nt][e] * p.scale : masked_score();
        }
      online_softmax<HD, kBK>(s, m, l, o, kLog2e);
      pv_tile<HD, kBK>(o, s, v_s + stage * kBK * ST, ST, lane);
    }
    __syncthreads();        // stage `it % kStages` is refilled next
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = row0 + warp * 16 + g + i * 8;
    if (r >= nrows) continue;
    const int t = r / G, gg = r % G;
    if (p.nsplit == 1) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      bf16* dst = p.out + ((size_t)(b * p.T + t) * p.H + kvh * G + gg) * HD + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
      if (tq == 0) {
        const size_t so = ((size_t)bk * G + gg) * p.T + t;
        p.m_out[so] = m[i];
        p.l_out[so] = l[i];
      }
    } else {
      const size_t pr = ((size_t)bk * p.nsplit + split) * nrows + r;
      if (l[i] > 0.f) {   // an empty partial is never read
        float* dst = p.po + pr * HD + 2 * tq;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
          *reinterpret_cast<float2*>(dst + dt * 8) =
              make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
      }
      if (tq == 0) {
        p.pm[pr] = m[i];
        p.pl[pr] = l[i];
      }
    }
  }
}

// Pass 2: HD / 4 threads per row, four columns each.
template <int HD>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_attention_kernel(Params p) {
  constexpr int TPR = HD / 4;
  constexpr int RPB = kCombineThreads / TPR;
  const int G = p.H / p.KV, nrows = G * p.T;
  const int r = blockIdx.x * RPB + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 4;
  const int bk = blockIdx.y, b = bk / p.KV, kvh = bk % p.KV;
  if (r >= nrows) return;
  const size_t pr0 = (size_t)bk * p.nsplit * nrows + r;
  float mx = kNegInf;
  for (int s = 0; s < p.nsplit; ++s) {
    const size_t pr = pr0 + (size_t)s * nrows;
    if (p.pl[pr] > 0.f) mx = fmaxf(mx, p.pm[pr]);
  }
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.nsplit; ++s) {
    const size_t pr = pr0 + (size_t)s * nrows;
    const float ls = p.pl[pr];
    if (!(ls > 0.f)) continue;          // a split with no visible key
    const float w = ex2((p.pm[pr] - mx) * kLog2e);
    const float4 x = *reinterpret_cast<const float4*>(p.po + pr * HD + c);
    l += ls * w;
    acc.x += x.x * w;
    acc.y += x.y * w;
    acc.z += x.z * w;
    acc.w += x.w * w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  const int t = r / G, gg = r % G;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
      p.out + ((size_t)(b * p.T + t) * p.H + kvh * G + gg) * HD + c);
  dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  if (c == 0) {
    const size_t so = ((size_t)bk * G + gg) * p.T + t;
    p.m_out[so] = mx;
    p.l_out[so] = l;
  }
}

// whether the kernel has its shared memory opt-in, per device; internal
// linkage, so every library that holds the kernel keeps its own (a static
// inside the template would be one object across them)
namespace {
template <int HD, bool PAGED> bool opted_in[64];
}

template <int HD, bool PAGED>
int launch_hd(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const int e = opt_in_smem(decode_tc_attention_kernel<HD, PAGED>, smem,
                            opted_in<HD, PAGED>);
  if (e) return e;
  const int nrows = (p.H / p.KV) * p.T;
  if (nrows == 0 || p.B == 0) return (int)cudaSuccess;
  if (p.nsplit < 1 || p.chunk % kBK || p.chunk > kMaxTiles * kBK ||
      (long long)p.nsplit * p.chunk < p.S ||
      (p.nsplit > 1 && (p.po == nullptr || p.pm == nullptr || p.pl == nullptr)) ||
      (PAGED && (p.block_table == nullptr || p.page < 1 || p.S % p.page)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nrows + kRows - 1) / kRows, p.B * p.KV, p.nsplit);
  decode_tc_attention_kernel<HD, PAGED><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return (int)err;
  constexpr int RPB = kCombineThreads / (HD / 4);
  const dim3 cgrid((nrows + RPB - 1) / RPB, p.B * p.KV);
  decode_combine_attention_kernel<HD><<<cgrid, kCombineThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// PAGED: keys through p.block_table (paged_decode_attention), else per row
template <bool PAGED>
int launch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32, PAGED>(p, stream);
    case 64: return launch_hd<64, PAGED>(p, stream);
    case 128: return launch_hd<128, PAGED>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_decode_tc
