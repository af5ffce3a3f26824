// The body of the MTP kernel (mtp_attention.cu): a depth-split key walk on
// the tensor cores, with float32 accuracy from three TF32 products.
//
// Replaces the TPU kernel repro/kernels/mtp_attention.py::mtp_attention
// (_mtp_kernel), which walked every key block for every query block and
// masked the closed-form predicate
//
//     attend((qd, qp) -> (kd, kp))  <=>  qd >= 0 and kd >= 0 and
//         ((kd = 0 and kp <= qp - qd) or (kp - kd = qp - qd and kd <= qd)).
//
// What bounds it on this card: operations. At the training shape (B 1,
// n 2048, K 8, r 0.8: M 8522, 12 heads over 12 KV heads, hd 128) the
// visible pairs need 53.9 GFLOP against about 210 MB of q, k, v and out.
// What the design does about it:
//
// 1. Depth-split key walk. The predicate splits into two disjoint key sets
//    of a query with anchor a = qp - qd: the context (depth-0 keys with
//    kp <= a) and the chain (depth >= 1 keys with kp - kd = a, kd <= qd).
//    The wrapper sorts each row's keys once per call into two index lists
//    (ops.mtp_key_lists, one int32 sort): the depth-0 keys by position and
//    the depth >= 1 keys by anchor, with the sort keys and the two counts
//    beside them. A block of query rows finds, by a warp-wide 32-way search
//    of the sort keys, the context prefix up to its largest anchor and the
//    chain range between its smallest and largest anchor, and walks only
//    those list entries, in 32-key tiles, one online softmax across both.
//    Within a tile the predicate is evaluated per (row, key), so any layout
//    of (pos, depth) gives the same function; a COD layout, whose rows sit
//    in (position, depth) order, gives blocks of nearby anchors and so
//    short walks. At the training shape the walked tiles cover 1.12 pairs
//    per visible pair, where every tile up to the block's last position
//    covered 4.25 (test_mtp_walk_scores_little_beyond_the_visible_pairs).
// 2. Tensor cores at float32 accuracy: S = Q·Kᵀ and O += P·V run on
//    mma.sync m16n8k8 in TF32, each f32 operand split as hi = tf32(x),
//    lo = tf32(x - hi), and each product taken as hi·hi + hi·lo + lo·hi
//    accumulated in f32 (lo·lo, about 2^-22 of the product, is dropped);
//    the tensor-core sums are kept short (one tile's P·V, then an f32 add
//    into O; the small products of S apart from hi·hi).
//    One TF32 product keeps 11 bits and fails the card's 1e-4 limit on
//    scores of std 2 (pinned on the CPU by
//    test_card_f32_limit_rejects_one_tf32_product). bfloat16 inputs are
//    exact in TF32 (lo = 0), so their S is one product and P·V two (P's hi
//    and lo). The softmax stays in f32 (tc_common.cuh).
// 3. K/V rows are gathered by index through a two-stage cp.async ring, the
//    next tile in flight while one is multiplied. Q stays in shared memory
//    in f32 and is split per k-step, so no warp holds 128 registers of Q
//    fragments; V needs no transpose: the k index of P·V maps k-slot i to
//    key 2i and k-slot i + 4 to key 2i + 1, which is exactly where S's
//    accumulators hold P, and the V operand is read at those key rows.
//
// Rows are (query, grouped head) pairs r = t * G + g of one (b, KV head),
// 64 a block (16 a warp); the blocks of the largest row tiles (the longest
// context walks under a COD layout) launch first. A warp skips a tile in
// which none of its rows sees a key. Rows that see no key (pad rows, depth
// -1) end with l == 0, m = -1e30 and are written as zeros. (m, l) leave in
// the (B, KV, G, M) layout the recompute-by-block backward of
// core/flash_train.py reads.
#pragma once

#include <climits>
#include <type_traits>

#include "tc_common.cuh"

namespace repro_mtp_tc {

using namespace repro_tc;

constexpr int kRows = 64;      // query rows per block: 4 warps of 16
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;
constexpr int kStages = 2;

template <int HD> constexpr int kQStride = HD + 4;   // f32 Q rows
// K/V rows in shared memory, elements: the 16-byte aligned padding that
// puts the eight rows a fragment load reads on distinct banks
template <typename T, int HD>
constexpr int kKStride = std::is_same<T, float>::value ? HD + 4 : HD + 8;

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * kRows * kQStride<HD> +
         sizeof(T) * 2 * kStages * kBK * kKStride<T, HD> +
         sizeof(int) * (2 * kStages * kBK + 2 * kRows);
}

template <typename T>
struct Params {
  const T* q;          // (B, M, H, hd)
  const T* k;          // (B, M, KV, hd)
  const T* v;          // (B, M, KV, hd)
  const int* pos;      // (B, M)
  const int* depth;    // (B, M), -1 = pad
  const long long* order;  // (B, 2, M) key indices: list 0 the depth-0
                           // keys by position, list 1 the depth >= 1 keys
                           // by anchor, each first (ops.mtp_key_lists)
  const int* okey;     // (B, 2, M) their sort keys: position, anchor
  const int* counts;   // (B, 2) the entries of each list
  T* out;              // (B, M, H, hd)
  float* m_out;        // (B, KV, G, M)
  float* l_out;        // (B, KV, G, M)
  int B, M, H, KV;
  float scale;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a · b on the tensor cores, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// hi/lo of n f32 values; with LO false the values are exact in TF32
template <bool LO, int N>
__device__ __forceinline__ void split_n(const float (&x)[N], uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (LO) {
      split_tf32(x[i], hi[i], lo[i]);
    } else {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    }
  }
}

// S = Q·Kᵀ for the warp's 16 rows of Q (f32 in shared memory, row stride
// kQStride) against a tile of kBK keys (row stride kKStride). A: rows g,
// g + 8 at columns t, t + 4 of each 8-column step; B: key g at columns t,
// t + 4. The tensor cores do not round their f32 sums to nearest, so the
// hi·lo and lo·hi products sum apart from hi·hi, whose chain is the long
// one. The products of one k-step go to the four n-tiles in turn, so no
// MMA waits on the one before it.
template <typename T, int HD>
__device__ __forceinline__ void qk_tile(float (&s)[kBK / 8][4],
                                        const float* q_rows, const T* k_rows,
                                        int lane) {
  constexpr bool LO = std::is_same<T, float>::value;
  constexpr int QS = kQStride<HD>, KS = kKStride<T, HD>;
  const int g = lane >> 2, t = lane & 3;
  float sx[kBK / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = sx[nt][e] = 0.f;
  const float* qa = q_rows + g * QS + t;
  const T* kb = k_rows + g * KS + t;
#pragma unroll 4
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float a[4] = {qa[kk * 8], qa[8 * QS + kk * 8], qa[kk * 8 + 4],
                        qa[8 * QS + kk * 8 + 4]};
    uint32_t ah[4], al[4];
    split_n<LO>(a, ah, al);
    uint32_t bh[kBK / 8][2], bl[kBK / 8][2];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      const T* kr = kb + nt * 8 * KS + kk * 8;
      const float b[2] = {to_f32(kr[0]), to_f32(kr[4])};
      split_n<LO>(b, bh[nt], bl[nt]);
    }
    if (LO) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) mma_tf32(sx[nt], ah, bl[nt]);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) mma_tf32(sx[nt], al, bh[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) mma_tf32(s[nt], ah, bh[nt]);
  }
  if (LO) {
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += sx[nt][e];
  }
}

// O += P·V over a tile of kBK keys, P the probabilities left in S's
// accumulators. k-slot t of each 8-key step is key 2t and k-slot t + 4 key
// 2t + 1, so the A fragment is the thread's own accumulators and the B
// fragment is V at rows 2t, 2t + 1, column g of each 8-column step. Each
// tile's product sums on the tensor cores from zero and is added to O in
// f32 (rounded to nearest): the cores' sums are not, and a chain through
// every tile of a long context would carry their error into O. Eight
// 8-column steps sum side by side, so no MMA waits on the one before it.
template <typename T, int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 8][4],
                                        const float (&s)[kBK / 8][4],
                                        const T* v_rows, int lane) {
  constexpr bool LO = std::is_same<T, float>::value;
  constexpr int KS = kKStride<T, HD>;
  const int g = lane >> 2, t = lane & 3;
  uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
    split_n<true>(a, ph[kk], pl[kk]);
  }
  constexpr int DG = HD / 8 < 8 ? HD / 8 : 8;   // steps summed side by side
  const T* vb = v_rows + 2 * t * KS + g;
#pragma unroll
  for (int d0 = 0; d0 < HD / 8; d0 += DG) {
    float acc[DG][4] = {};
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      uint32_t bh[DG][2], bl[DG][2];
#pragma unroll
      for (int d = 0; d < DG; ++d) {
        const T* vr = vb + kk * 8 * KS + (d0 + d) * 8;
        const float b[2] = {to_f32(vr[0]), to_f32(vr[KS])};
        split_n<LO>(b, bh[d], bl[d]);
      }
      if (LO) {   // V's lo half: zero for bfloat16 inputs
#pragma unroll
        for (int d = 0; d < DG; ++d) mma_tf32(acc[d], ph[kk], bl[d]);
      }
#pragma unroll
      for (int d = 0; d < DG; ++d) mma_tf32(acc[d], pl[kk], bh[d]);
#pragma unroll
      for (int d = 0; d < DG; ++d) mma_tf32(acc[d], ph[kk], bh[d]);
    }
#pragma unroll
    for (int d = 0; d < DG; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d0 + d][e] += acc[d][e];
  }
}

// The number of leading entries of the sorted a[0, n) that are <= x
// (inclusive) or < x: a warp-wide search, 32 probes a step.
__device__ __forceinline__ int warp_count_below(const int* a, int n, int x,
                                                bool inclusive, int lane) {
  int lo = 0, hi = n;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    bool below = false;
    if (i < hi) {
      const int y = a[i];
      below = inclusive ? y <= x : y < x;
    }
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    if (cnt == 0) {
      hi = lo;
    } else {   // probe cnt - 1 is below x, probe cnt (if any) is not
      hi = min(hi, lo + cnt * step);
      lo += (cnt - 1) * step + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ bool visible(int kp, int kd, int anchor, int qd) {
  return qd >= 0 && kd >= 0 &&
         ((kd == 0 && kp <= anchor) || (kp - kd == anchor && kd <= qd));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// one 16-byte chunk of a row of Q into shared memory, as f32
__device__ __forceinline__ void load_q_chunk(float* dst, const float* src,
                                             bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void load_q_chunk(float* dst, const bf16* src,
                                             bool valid) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (valid) raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    mtp_tc_attention_kernel(Params<T> p) {
  constexpr int QS = kQStride<HD>, KS = kKStride<T, HD>;
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;         // chunks per row of Q, K or V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);          // kRows x QS
  T* k_s = reinterpret_cast<T*>(q_s + kRows * QS);           // kStages x kBK x KS
  T* v_s = k_s + kStages * kBK * KS;                         // kStages x kBK x KS
  int* kp_s = reinterpret_cast<int*>(v_s + kStages * kBK * KS);  // kStages x kBK
  int* kd_s = kp_s + kStages * kBK;                          // kStages x kBK
  int* ra_s = kd_s + kStages * kBK;                          // kRows: anchors
  int* rd_s = ra_s + kRows;                                  // kRows: depths
  __shared__ int alo_s, ahi_s, range_s[3];

  const int G = p.H / p.KV, nrows = G * p.M;
  const int nrt = (nrows + kRows - 1) / kRows;
  const int row0 = (nrt - 1 - blockIdx.y) * kRows;   // longest walks first
  const int bk = blockIdx.x, b = bk / p.KV, kvh = bk % p.KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t meta0 = (size_t)b * p.M;

  if (tid == 0) {
    alo_s = INT_MAX;
    ahi_s = INT_MIN;
  }
  __syncthreads();
  if (tid < kRows) {
    const int r = row0 + tid;
    int anchor = 0, qd = -1;             // rows past the end see no key
    if (r < nrows) {
      const int t = r / G;
      qd = p.depth[meta0 + t];
      if (qd >= 0) {
        anchor = p.pos[meta0 + t] - qd;
        atomicMin(&alo_s, anchor);
        atomicMax(&ahi_s, anchor);
      }
    }
    ra_s[tid] = anchor;
    rd_s[tid] = qd;
  }
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int rr = i / CPR, c = (i % CPR) * EPC, r = row0 + rr;
    const bool valid = r < nrows;
    const T* from = valid ? p.q + ((meta0 + r / G) * p.H + kvh * G + r % G) * HD + c
                          : p.q;
    load_q_chunk(q_s + rr * QS + c, from, valid);
  }
  cp_async_commit();
  __syncthreads();

  // the list ranges the block walks: the context prefix up to its largest
  // anchor, the chain entries whose anchors lie within its anchors
  if (warp < 3) {
    const int alo = alo_s, ahi = ahi_s;
    const int list = warp == 0 ? 0 : 1;
    const int* keys = p.okey + (2 * (size_t)b + list) * p.M;
    const int n = p.counts[2 * b + list];
    int v = 0;
    if (alo <= ahi)        // the block has a real row
      v = warp_count_below(keys, n, warp == 1 ? alo : ahi, warp != 1, lane);
    if (lane == 0) range_s[warp] = v;
  }
  __syncthreads();
  const int n1 = range_s[0], c2 = range_s[1], e2 = range_s[2];
  const int t1 = (n1 + kBK - 1) / kBK;
  const int ntiles = t1 + (e2 - c2 + kBK - 1) / kBK;

  auto load_tile = [&](int idx, int stage) {
    const int j0 = idx < t1 ? idx * kBK : c2 + (idx - t1) * kBK;
    const int jend = idx < t1 ? n1 : e2;
    const long long* ord = p.order + (2 * (size_t)b + (idx < t1 ? 0 : 1)) * p.M;
    T* ks = k_s + stage * kBK * KS;
    T* vs = v_s + stage * kBK * KS;
#pragma unroll
    for (int i = tid; i < kBK * CPR; i += kThreads) {
      const int jj = i / CPR, c = (i % CPR) * EPC;
      const bool valid = j0 + jj < jend;
      const size_t off =
          valid ? ((meta0 + ord[j0 + jj]) * p.KV + kvh) * HD + c : 0;
      cp_async16(ks + jj * KS + c, p.k + off, valid);
      cp_async16(vs + jj * KS + c, p.v + off, valid);
    }
    if (tid < kBK) {
      int kp = -1, kd = -1;              // past the range: never visible
      if (j0 + tid < jend) {
        const long long key = ord[j0 + tid];
        kp = p.pos[meta0 + key];
        kd = p.depth[meta0 + key];
      }
      kp_s[stage * kBK + tid] = kp;
      kd_s[stage * kBK + tid] = kd;
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {   // one commit group per tile
    if (i < ntiles) load_tile(i, i);
    cp_async_commit();
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, tq = lane & 3;
  const bool active = row0 + warp * 16 < nrows;   // warp has a real row
  const int ra[2] = {ra_s[warp * 16 + g], ra_s[warp * 16 + g + 8]};
  const int rd[2] = {rd_s[warp * 16 + g], rd_s[warp * 16 + g + 8]};

  for (int it = 0; it < ntiles; ++it) {
    const int ahead = it + kStages - 1;
    if (ahead < ntiles) load_tile(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile `it` (and Q) has landed
    __syncthreads();
    const int stage = it % kStages;
    const int* kps = kp_s + stage * kBK;
    const int* kds = kd_s + stage * kBK;
    uint32_t vis = 0;                // bit 4 nt + e: this thread's pairs
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tq + (e & 1);
        if (visible(kps[j], kds[j], ra[e >> 1], rd[e >> 1]))
          vis |= 1u << (4 * nt + e);
      }
    if (active && __any_sync(0xffffffffu, vis != 0)) {
      float s[kBK / 8][4];
      qk_tile<T, HD>(s, q_s + warp * 16 * QS, k_s + stage * kBK * KS, lane);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = (vis >> (4 * nt + e)) & 1u ? s[nt][e] * p.scale
                                                : masked_score();
      online_softmax<HD, kBK>(s, m, l, o, kLog2e);
      pv_tile<T, HD>(o, s, v_s + stage * kBK * KS, lane);
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
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = p.out + ((meta0 + t) * p.H + kvh * G + gg) * HD + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      store2(dst + dt * 8, o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    if (tq == 0) {
      const size_t so = ((size_t)bk * G + gg) * p.M + t;
      p.m_out[so] = m[i];
      p.l_out[so] = l[i];
    }
  }
}

// whether the kernel has its shared memory opt-in, per device; internal
// linkage, so every library that holds the kernel keeps its own
namespace {
template <typename T, int HD> bool opted_in[64];
}

template <typename T, int HD>
int launch_hd(const Params<T>& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  const int e = opt_in_smem(mtp_tc_attention_kernel<T, HD>, smem,
                            opted_in<T, HD>);
  if (e) return e;
  const int nrows = (p.H / p.KV) * p.M;
  if (nrows == 0 || p.B == 0) return (int)cudaSuccess;
  const int nrt = (nrows + kRows - 1) / kRows;
  if (nrt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.B * p.KV, nrt);
  mtp_tc_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params<T>& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(p, stream);
    case 64: return launch_hd<T, 64>(p, stream);
    case 128: return launch_hd<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_mtp_tc
