// The tile code of the attention backward for Hopper (sm_90a), shared by
// packed_attention_bwd.cu (TPU kernels 2 and 3, packed (B, N, 3*dim) qkv) and
// mha_attention_bwd.cu (TPU kernel 5, head-major (B, H, N, hd) q, k, v); its
// helpers also serve the head-major forward, mha_attention.cu (kernel 4).
//
// For one (batch, head), with q, k, v and dO addressed by a pointer to row 0
// and a row pitch each (packed: base + b*N*3dim + h*hd, pitch 3dim;
// head-major: base + (b*H + h)*N*hd, pitch hd):
//   s  = (q k^T) * scale                 f32 (the scale is NOT folded into q)
//   P  = softmax(s)                      f32
//   dV = bf16(P)^T dO
//   dP = dO V^T                          f32
//   dS = P * (dP - rowsum(dP * P))       f32
//   dQ = bf16(dS * scale) K,  dK = bf16(dS * scale)^T Q
// and dQ, dK, dV are written, rounded to bf16, into their rows. Only the
// addressing differs between the two layouts, so they give the same bits.
//
// * dq_tile, one 64-row query tile per CTA (each warp owns 16 rows). Pass 1
//   over the key tiles: online f32 row max m and row sum l of exp(s - m),
//   and the online sum of exp(s - m) * dP, which divided by l is
//   D = rowsum(dP * P). Pass 2 rebuilds P = exp(s - m) / l exactly, forms dS
//   and accumulates dQ in f32 wmma fragments. Writes dQ and the per-row
//   (m, l, D) to the head's (3, N) f32 statistics.
// * dkv_tile, one 64-row key tile per CTA (each warp owns 16 key rows).
//   Loops over the query tiles, rebuilds P^T and dS^T from (m, l, D), and
//   accumulates dV and dK in f32 wmma fragments. Writes dK and dV.
// Tensor-core products via nvcuda::wmma (bf16 x bf16 -> f32, 16x16x16).
// Rows past N are zero-loaded and masked out of every softmax; head dims 32,
// 64 and 88 are supported, 88 zero-padded to 96 in shared memory. Both run
// on 128 threads with Layout<HD>::SMEM bytes of dynamic shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

namespace dinox_attn_bwd {

using namespace nvcuda;

constexpr int BLOCK = 64;  // rows per query tile and per key tile
constexpr int WARPS = 4;   // each warp owns 16 rows of the CTA's tile
constexpr int THREADS = WARPS * 32;
constexpr int BF_PAD = 8;  // bf16 row padding (elements); keeps wmma ldm a multiple of 8
constexpr int F_PAD = 4;   // f32 row padding (elements); keeps wmma ldm a multiple of 4

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

template <int HD>
struct Layout {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // head dim padded to the wmma depth
  static constexpr int LDB = HDP + BF_PAD;          // pitch of the Q, K, V, dO tiles (bf16)
  static constexpr int LDS = BLOCK + F_PAD;         // pitch of the S and dP tiles (f32)
  static constexpr int LDP = BLOCK + BF_PAD;        // pitch of the P and dS tiles (bf16)
  static constexpr int LDO = HDP + F_PAD;           // pitch of the output staging tile (f32)
  static constexpr size_t TILE = round128(sizeof(__nv_bfloat16) * BLOCK * LDB);
  static constexpr size_t S_TILE = round128(sizeof(float) * BLOCK * LDS);
  static constexpr size_t P_TILE = round128(sizeof(__nv_bfloat16) * BLOCK * LDP);
  static constexpr size_t T0 = 0;  // dq: Q    dkv: K
  static constexpr size_t T1 = T0 + TILE;  // dq: dO   dkv: V
  static constexpr size_t T2 = T1 + TILE;  // dq: K    dkv: Q
  static constexpr size_t T3 = T2 + TILE;  // dq: V    dkv: dO
  static constexpr size_t S_OFF = T3 + TILE;
  static constexpr size_t DP_OFF = S_OFF + S_TILE;
  static constexpr size_t P0_OFF = DP_OFF + S_TILE;  // dq: dS  dkv: P^T
  static constexpr size_t P1_OFF = P0_OFF + P_TILE;  // dkv: dS^T
  static constexpr size_t STAT_OFF = P1_OFF + P_TILE;
  static constexpr size_t SMEM = STAT_OFF + round128(sizeof(float) * 3 * BLOCK);
  // The output staging tile aliases S and dP once the main loop is over.
  static_assert(sizeof(float) * BLOCK * LDO <= P0_OFF - S_OFF, "staging tile does not fit");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copy rows [r0, r0 + BLOCK) of an hd-wide column slice (row pitch *stride*
// elements) into a padded shared tile; rows past N and columns past hd are 0.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int n) {
  using L = Layout<HD>;
  constexpr int CHUNKS = L::HDP / 8;  // 16-byte chunks in a padded row
  constexpr int HD_CHUNKS = HD / 8;   // chunks that hold data
  for (int i = threadIdx.x; i < BLOCK * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n && c < HD_CHUNKS)
      v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * L::LDB + c * 8) = v;
  }
}

// C (16 x BLOCK, f32, pitch LDS) = A (16 x HDP rows of sA) . B^T, where B is
// BLOCK rows of sB: the product of a warp's 16 rows with a whole tile.
template <int HD>
__device__ __forceinline__ void rows_times_tile_t(float* c, const __nv_bfloat16* a,
                                                  const __nv_bfloat16* b) {
  using L = Layout<HD>;
#pragma unroll
  for (int j = 0; j < BLOCK / 16; ++j) {
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < L::HDP / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::LDB);
      wmma::load_matrix_sync(fb, b + j * 16 * L::LDB + kk * 16, L::LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + j * 16, acc, L::LDS, wmma::mem_row_major);
  }
}

// acc[j] += P (16 x BLOCK rows of a bf16 tile, pitch LDP) . B (BLOCK x HDP tile).
template <int HD>
__device__ __forceinline__ void accumulate_p_times_tile(FragAcc* acc, const __nv_bfloat16* p,
                                                        const __nv_bfloat16* b) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < BLOCK / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk * 16, L::LDP);
#pragma unroll
    for (int j = 0; j < L::HDP / 16; ++j) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * L::LDB + j * 16, L::LDB);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Write an f32 staging tile (BLOCK x HDP, pitch LDO), rounded to bf16, into
// rows [r0, r0 + BLOCK) of an hd-wide column slice with row pitch *stride*.
template <int HD>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const float* stage,
                                           long long stride, int r0, int n) {
  using L = Layout<HD>;
  constexpr int HD_CHUNKS = HD / 8;
  for (int i = threadIdx.x; i < BLOCK * HD_CHUNKS; i += THREADS) {
    const int r = i / HD_CHUNKS, c = i % HD_CHUNKS;
    if (r0 + r >= n) continue;
    uint4 v;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
    const float* src = stage + r * L::LDO + c * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(src[j]);
    *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * stride + c * 8) = v;
  }
}

template <int HD>
__device__ __forceinline__ void stage_fragments(float* stage, FragAcc* acc) {
  using L = Layout<HD>;
  float* w = stage + (threadIdx.x >> 5) * 16 * L::LDO;
#pragma unroll
  for (int j = 0; j < L::HDP / 16; ++j)
    wmma::store_matrix_sync(w + j * 16, acc[j], L::LDO, wmma::mem_row_major);
}

// Query rows [q0, q0 + BLOCK) of one (batch, head): writes their dQ rows
// (pitch dq_pitch) and their (m, l, D) to st[row], st[n + row], st[2n + row].
template <int HD>
__device__ __forceinline__ void dq_tile(const __nv_bfloat16* __restrict__ q,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v, long long qkv_pitch,
                                        const __nv_bfloat16* __restrict__ dout, long long do_pitch,
                                        __nv_bfloat16* __restrict__ dq, long long dq_pitch,
                                        float* __restrict__ st, int n, int q0, float scale,
                                        unsigned char* smem) {
  using L = Layout<HD>;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::T1);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::T2);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::T3);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sdP = reinterpret_cast<float*>(smem + L::DP_OFF);
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + L::P0_OFF);
  float* sStage = reinterpret_cast<float*>(smem + L::S_OFF);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<HD>(sQ, q, qkv_pitch, q0, n);
  load_tile<HD>(sdO, dout, do_pitch, q0, n);

  // Two lanes share a row, each holding half of its 64 key columns.
  const int lr = lane >> 1;
  const int half = lane & 1;
  const __nv_bfloat16* sQw = sQ + warp * 16 * L::LDB;
  const __nv_bfloat16* sdOw = sdO + warp * 16 * L::LDB;
  float* sSw = sS + warp * 16 * L::LDS;
  float* sdPw = sdP + warp * 16 * L::LDS;
  __nv_bfloat16* sdSw = sdS + warp * 16 * L::LDP;
  const float* srow = sSw + lr * L::LDS + half * 32;
  const float* dprow = sdPw + lr * L::LDS + half * 32;

  // Pass 1: row max m, row sum l of exp(s - m), and sum of exp(s - m) * dP.
  float m_run = -INFINITY, l_run = 0.f, d_run = 0.f;
  for (int k0 = 0; k0 < n; k0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD>(sK, k, qkv_pitch, k0, n);
    load_tile<HD>(sV, v, qkv_pitch, k0, n);
    __syncthreads();
    rows_times_tile_t<HD>(sSw, sQw, sK);
    rows_times_tile_t<HD>(sdPw, sdOw, sV);
    __syncwarp();
    const int cbase = k0 + half * 32;
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (cbase + c < n) tmax = fmaxf(tmax, srow[c] * scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile holds a key < N
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f, dsum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      if (cbase + c < n) {
        const float e = expf(srow[c] * scale - m_new);
        psum += e;
        dsum += e * dprow[c];
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    l_run = l_run * alpha + psum;
    d_run = d_run * alpha + dsum;
    m_run = m_new;
    __syncwarp();  // the lanes are done reading S and dP before the next tile overwrites them
  }
  const float d_row = d_run / l_run;  // rowsum(dP * P)

  // Pass 2: P = exp(s - m) / l, dS = P (dP - D), dQ += bf16(dS * scale) K.
  FragAcc acc[L::HDP / 16];
#pragma unroll
  for (int j = 0; j < L::HDP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < n; k0 += BLOCK) {
    __syncthreads();
    load_tile<HD>(sK, k, qkv_pitch, k0, n);
    load_tile<HD>(sV, v, qkv_pitch, k0, n);
    __syncthreads();
    rows_times_tile_t<HD>(sSw, sQw, sK);
    rows_times_tile_t<HD>(sdPw, sdOw, sV);
    __syncwarp();
    const int cbase = k0 + half * 32;
    __nv_bfloat16* dsrow = sdSw + lr * L::LDP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float ds = 0.f;
      if (cbase + c < n) {
        const float p = expf(srow[c] * scale - m_run) / l_run;
        ds = p * (dprow[c] - d_row);
      }
      dsrow[c] = __float2bfloat16(ds * scale);
    }
    __syncwarp();
    accumulate_p_times_tile<HD>(acc, sdSw, sK);
  }

  __syncthreads();  // S and dP are dead in every warp: the staging tile may alias them
  stage_fragments<HD>(sStage, acc);
  __syncthreads();
  store_tile<HD>(dq, sStage, dq_pitch, q0, n);
  const int row = q0 + warp * 16 + lr;
  if (half == 0 && row < n) {
    st[row] = m_run;
    st[n + row] = l_run;
    st[2 * n + row] = d_row;
  }
}

// Key rows [k0, k0 + BLOCK) of one (batch, head): reads the (m, l, D) that
// dq_tile wrote to st and writes their dK and dV rows (pitch dkv_pitch).
template <int HD>
__device__ __forceinline__ void dkv_tile(const __nv_bfloat16* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ k,
                                         const __nv_bfloat16* __restrict__ v, long long qkv_pitch,
                                         const __nv_bfloat16* __restrict__ dout, long long do_pitch,
                                         const float* __restrict__ st,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv, long long dkv_pitch, int n,
                                         int k0, float scale, unsigned char* smem) {
  using L = Layout<HD>;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::T1);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::T2);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::T3);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);    // S^T: key rows x query columns
  float* sdP = reinterpret_cast<float*>(smem + L::DP_OFF);  // dP^T
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P0_OFF);   // bf16(P^T)
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + L::P1_OFF);  // bf16(dS^T * scale)
  float* sStat = reinterpret_cast<float*>(smem + L::STAT_OFF);  // m, l, D of the query tile
  float* sStage = reinterpret_cast<float*>(smem + L::S_OFF);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<HD>(sK, k, qkv_pitch, k0, n);
  load_tile<HD>(sV, v, qkv_pitch, k0, n);

  const int lr = lane >> 1;
  const int half = lane & 1;
  const __nv_bfloat16* sKw = sK + warp * 16 * L::LDB;
  const __nv_bfloat16* sVw = sV + warp * 16 * L::LDB;
  float* sSw = sS + warp * 16 * L::LDS;
  float* sdPw = sdP + warp * 16 * L::LDS;
  __nv_bfloat16* sPw = sP + warp * 16 * L::LDP;
  __nv_bfloat16* sdSw = sdS + warp * 16 * L::LDP;
  const float* srow = sSw + lr * L::LDS + half * 32;
  const float* dprow = sdPw + lr * L::LDS + half * 32;
  __nv_bfloat16* prow = sPw + lr * L::LDP + half * 32;
  __nv_bfloat16* dsrow = sdSw + lr * L::LDP + half * 32;

  FragAcc dv_acc[L::HDP / 16], dk_acc[L::HDP / 16];
#pragma unroll
  for (int j = 0; j < L::HDP / 16; ++j) {
    wmma::fill_fragment(dv_acc[j], 0.f);
    wmma::fill_fragment(dk_acc[j], 0.f);
  }
  for (int q0 = 0; q0 < n; q0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<HD>(sQ, q, qkv_pitch, q0, n);
    load_tile<HD>(sdO, dout, do_pitch, q0, n);
    for (int i = threadIdx.x; i < 3 * BLOCK; i += THREADS) {
      const int s = i / BLOCK, r = i % BLOCK;
      sStat[i] = q0 + r < n ? st[s * n + q0 + r] : 0.f;
    }
    __syncthreads();
    rows_times_tile_t<HD>(sSw, sKw, sQ);   // S^T = K Q^T
    rows_times_tile_t<HD>(sdPw, sVw, sdO);  // dP^T = V dO^T
    __syncwarp();
    const int cl = half * 32;  // first query column of this lane, local to the tile
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float p = 0.f, ds = 0.f;
      if (q0 + cl + c < n) {
        p = expf(srow[c] * scale - sStat[cl + c]) / sStat[BLOCK + cl + c];
        ds = p * (dprow[c] - sStat[2 * BLOCK + cl + c]);
      }
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(ds * scale);
    }
    __syncwarp();
    accumulate_p_times_tile<HD>(dv_acc, sPw, sdO);  // dV += P^T dO
    accumulate_p_times_tile<HD>(dk_acc, sdSw, sQ);  // dK += dS^T Q
  }

  __syncthreads();  // S and dP are dead in every warp: the staging tile may alias them
  stage_fragments<HD>(sStage, dv_acc);
  __syncthreads();
  store_tile<HD>(dv, sStage, dkv_pitch, k0, n);
  __syncthreads();
  stage_fragments<HD>(sStage, dk_acc);
  __syncthreads();
  store_tile<HD>(dk, sStage, dkv_pitch, k0, n);
}

}  // namespace dinox_attn_bwd
