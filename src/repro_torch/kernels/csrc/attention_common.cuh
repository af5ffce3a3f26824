// The float32 body of the decode, paged decode and flash kernels
// (decode_attention.cu, paged_decode_attention.cu, flash_attention.cu):
// masked online-softmax attention of a tile of query rows against a
// key/value sequence, computed with f32 FMAs. Their bfloat16 paths, and the
// MTP kernel in both dtypes, run tensor-core bodies of their own.
//
// One thread block owns ROWS query rows of one (batch row b, KV head). A
// row is one (query t, grouped head g) pair, ordered r = t * G + g, so the
// G query heads that share a KV head read each K/V tile once. Inside the
// block a loop walks the keys in tiles of kBK = 32 (one key per lane):
//
//   1. the key positions of the tile are read; a tile that no row of the
//      block can see (empty slots, keys past the causal edge or outside the
//      window) is skipped without touching K/V;
//   2. K and V are converted to f32 into shared memory;
//   3. warp w scores rows w, w + 8, ... against the 32 keys (lane = key),
//      keeps the row's running max m and sum l in registers across lanes,
//      and writes p = exp(s - m) into shared memory;
//   4. every thread rescales and accumulates its (row, column) outputs
//      with p @ V.
//
// Keys are addressed in one of two ways. Per row (block_table == nullptr):
// key j of row b is slot b * S + j of k/v/kpos, each (B, S, ...). Paged
// (paged_decode_attention): k/v/kpos are a shared pool of pages (NP, page,
// ...) and key j of row b lives in pool page block_table[b, j / page] at
// offset j % page; a page id outside [0, NP) (-1 = unallocated) reads as
// position -1 and its K/V are never loaded, so it cannot alias a live page.
// A tile may span two or more pages (page < kBK); each key resolves its own.
//
// Masking takes positions, not indices: key j is visible to a query at
// position qp when kp >= 0, kp <= qp (causal) and qp - kp < window
// (window > 0). A caller without a position array gets kp = j (-1 at
// j >= kv_len) and qp = t. p is masked explicitly, so rows with no visible
// key end with l == 0 and are written as zeros (exp(NEG_INF - NEG_INF) = 1
// never reaches the sum). The optional (m, l) outputs use the
// (B, KV, G, T) layout the two-phase decode merge reads.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace repro_attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;              // keys per tile = lanes per warp
constexpr float kNegInf = -1e30f;    // the JAX package's NEG_INF

template <typename T>
struct Params {
  const T* q;        // (B, Tq, H, hd)
  const T* k;        // (B, S, KV, hd)
  const T* v;        // (B, S, KV, hd)
  const int* kpos;   // (B, S) key positions, -1 = empty; nullptr = index
  const int* qpos;   // (B, Tq) query positions; nullptr = index
  T* out;            // (B, Tq, H, hd)
  float* m_out;      // (B, KV, G, Tq) running max, or nullptr
  float* l_out;      // (B, KV, G, Tq) softmax denominator, or nullptr
  int B, Tq, H, KV, S, kv_len;
  int causal, window;
  float scale, softcap;
  const int* block_table;  // (B, S / page) pool page ids; nullptr = per row
  int page, n_pages;       // keys per pool page, pages in the pool (paged)
};

// 16-byte global loads converted to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ inline void store_out(float* p, float x) { *p = x; }
__device__ inline void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Padded row strides (floats): +4 keeps float4 reads of neighbouring rows
// on distinct banks.
template <int HD> constexpr int kRowStride = HD + 4;
constexpr int kPStride = kBK + 4;

template <int HD, int ROWS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * kRowStride<HD> + kBK * kRowStride<HD> +
                          kBK * HD + ROWS * kPStride + 3 * ROWS) +
         sizeof(int) * (ROWS + 2 * kBK);
}

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads) attention_kernel(Params<T> p) {
  constexpr int QS = kRowStride<HD>;
  constexpr int VN = Vec<T>::N;
  constexpr int RQK = ROWS / kWarps;   // rows each warp scores
  constexpr int RS = kThreads / HD;    // row step of the p @ V mapping
  constexpr int RPV = ROWS / RS;       // rows each thread accumulates
  static_assert(ROWS % kWarps == 0, "ROWS must be a multiple of 8");
  static_assert(kThreads % HD == 0 && ROWS % RS == 0, "bad HD/ROWS");
  static_assert(HD % VN == 0 && HD % 4 == 0, "bad HD");

  extern __shared__ float smem[];
  float* q_s = smem;                         // ROWS x QS
  float* k_s = q_s + ROWS * QS;              // kBK x QS
  float* v_s = k_s + kBK * QS;               // kBK x HD
  float* p_s = v_s + kBK * HD;               // ROWS x kPStride
  float* alpha_s = p_s + ROWS * kPStride;    // ROWS
  float* m_s = alpha_s + ROWS;               // ROWS
  float* l_s = m_s + ROWS;                   // ROWS
  int* qp_s = reinterpret_cast<int*>(l_s + ROWS);  // ROWS
  int* kp_s = qp_s + ROWS;                   // kBK
  int* ks_s = kp_s + kBK;                    // kBK: K/V slot, -1 = none
  __shared__ int qlo_s, qhi_s;

  const int G = p.H / p.KV;
  const int nrows = G * p.Tq;
  const int row0 = blockIdx.x * ROWS;
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    qlo_s = INT_MAX;
    qhi_s = INT_MIN;
  }
  __syncthreads();
  if (tid < ROWS) {
    const int r = row0 + tid;
    int qp = -1;                   // rows past the end see no causal key
    if (r < nrows) {
      const int t = r / G;
      qp = p.qpos ? p.qpos[(size_t)b * p.Tq + t] : t;
      atomicMin(&qlo_s, qp);
      atomicMax(&qhi_s, qp);
    }
    qp_s[tid] = qp;
  }
  for (int i = tid; i < ROWS * (HD / VN); i += kThreads) {
    const int rr = i / (HD / VN);
    const int c = (i % (HD / VN)) * VN;
    const int r = row0 + rr;
    float x[VN];
    if (r < nrows) {
      const int t = r / G, g = r % G;
      Vec<T>::load(p.q + ((size_t)(b * p.Tq + t) * p.H + kvh * G + g) * HD + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) q_s[rr * QS + c + e] = x[e];
  }
  __syncthreads();
  const int qlo = qlo_s, qhi = qhi_s;

  float m_r[RQK], l_r[RQK], acc[RPV];
#pragma unroll
  for (int i = 0; i < RQK; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPV; ++i) acc[i] = 0.f;
  const int d = tid % HD;
  const int rpv0 = tid / HD;

  for (int j0 = 0; j0 < p.S; j0 += kBK) {
    int live = 0;
    if (tid < kBK) {
      const int j = j0 + tid;
      int kp = -1, slot = -1;
      if (j < p.S) {
        if (p.block_table != nullptr) {
          const int pg = p.block_table[(size_t)b * (p.S / p.page) + j / p.page];
          if (pg >= 0 && pg < p.n_pages) {
            slot = pg * p.page + j % p.page;
            kp = p.kpos[slot];
          }
        } else {
          slot = b * p.S + j;
          kp = p.kpos ? p.kpos[slot] : (j < p.kv_len ? j : -1);
        }
      }
      kp_s[tid] = kp;
      ks_s[tid] = slot;
      live = kp >= 0 && (!p.causal || kp <= qhi) &&
             (p.window <= 0 || qlo - kp < p.window);
    }
    if (!__syncthreads_or(live)) continue;   // no row sees this tile

    for (int i = tid; i < kBK * (HD / VN); i += kThreads) {
      const int jj = i / (HD / VN);
      const int c = (i % (HD / VN)) * VN;
      const int slot = ks_s[jj];
      float kx[VN], vx[VN];
      if (slot >= 0) {
        const size_t off = ((size_t)slot * p.KV + kvh) * HD + c;
        Vec<T>::load(p.k + off, kx);
        Vec<T>::load(p.v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[jj * QS + c + e] = kx[e];
        v_s[jj * HD + c + e] = vx[e];
      }
    }
    __syncthreads();

    const int kp = kp_s[lane];
    const float* kr = k_s + lane * QS;
#pragma unroll
    for (int i = 0; i < RQK; ++i) {
      const int rr = warp + i * kWarps;
      const float* qr = q_s + rr * QS;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + c);
        const float4 w = *reinterpret_cast<const float4*>(kr + c);
        s = fmaf(a.x, w.x, s);
        s = fmaf(a.y, w.y, s);
        s = fmaf(a.z, w.z, s);
        s = fmaf(a.w, w.w, s);
      }
      s *= p.scale;
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      const int qp = qp_s[rr];
      const bool ok = kp >= 0 && (!p.causal || kp <= qp) &&
                      (p.window <= 0 || qp - kp < p.window);
      const float m_new = fmaxf(m_r[i], warp_max(ok ? s : kNegInf));
      const float pr = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + warp_sum(pr);
      m_r[i] = m_new;
      p_s[rr * kPStride + lane] = pr;
      if (lane == 0) alpha_s[rr] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPV; ++i) acc[i] *= alpha_s[rpv0 + i * RS];
#pragma unroll 4
    for (int jj = 0; jj < kBK; jj += 4) {
      const float v0 = v_s[(jj + 0) * HD + d];
      const float v1 = v_s[(jj + 1) * HD + d];
      const float v2 = v_s[(jj + 2) * HD + d];
      const float v3 = v_s[(jj + 3) * HD + d];
#pragma unroll
      for (int i = 0; i < RPV; ++i) {
        const float4 pp =
            *reinterpret_cast<const float4*>(p_s + (rpv0 + i * RS) * kPStride + jj);
        float a = acc[i];
        a = fmaf(pp.x, v0, a);
        a = fmaf(pp.y, v1, a);
        a = fmaf(pp.z, v2, a);
        a = fmaf(pp.w, v3, a);
        acc[i] = a;
      }
    }
    __syncthreads();   // the next tile overwrites kp_s, ks_s, k_s, v_s, p_s
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RQK; ++i) {
      m_s[warp + i * kWarps] = m_r[i];
      l_s[warp + i * kWarps] = l_r[i];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPV; ++i) {
    const int rr = rpv0 + i * RS;
    const int r = row0 + rr;
    if (r >= nrows) continue;
    const int t = r / G, g = r % G;
    const float l = l_s[rr];
    const float o = l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f;
    store_out(p.out + ((size_t)(b * p.Tq + t) * p.H + kvh * G + g) * HD + d, o);
  }
  if (p.m_out != nullptr && tid < ROWS && row0 + tid < nrows) {
    const int r = row0 + tid;
    const int t = r / G, g = r % G;
    const size_t o = ((size_t)(b * p.KV + kvh) * G + g) * p.Tq + t;
    p.m_out[o] = m_s[tid];
    p.l_out[o] = l_s[tid];
  }
}

// whether the kernel has its shared memory opt-in (above 48 KB), per
// device; internal linkage, so every library that holds the kernel keeps
// its own (a static inside the template would be one object across them,
// and the second library's kernel would skip its opt-in)
namespace {
template <typename T, int HD, int ROWS> bool opted_in[64];
}

template <typename T, int HD, int ROWS>
int launch_hd(const Params<T>& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, ROWS>();
  const int e = repro_tc::opt_in_smem(attention_kernel<T, HD, ROWS>, smem,
                                      opted_in<T, HD, ROWS>);
  if (e) return e;
  const int nrows = (p.H / p.KV) * p.Tq;
  if (nrows == 0 || p.B == 0) return (int)cudaSuccess;
  const dim3 grid((nrows + ROWS - 1) / ROWS, p.B * p.KV);
  attention_kernel<T, HD, ROWS><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int ROWS, typename T>
int launch(const Params<T>& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32, ROWS>(p, stream);
    case 64: return launch_hd<T, 64, ROWS>(p, stream);
    case 128: return launch_hd<T, 128, ROWS>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_attn
