// Packed-QKV multi-head attention backward for Hopper (sm_90a): two kernels,
// dq and dkv.
//
// Replaces the TPU kernels `_packed_bwd_kernel` (kernel 2, reached through
// `_packed_bwd`) and its split form `_packed_bwd_dq_kernel` +
// `_packed_bwd_dkv_kernel` (kernel 3, `_packed_bwd_split`, taken at ViT-G
// width), all in dinox_tpu/ops/flash_attention.py. Same function: for every
// (batch, head), with q, k, v the hd-wide column slices of the packed
// (B, N, 3*dim) [q|k|v] row and dO the head's slice of the (B, N, dim)
// output gradient,
//   s  = (q k^T) * scale                 f32 (the scale is NOT folded into q)
//   P  = softmax(s)                      f32
//   dV = bf16(P)^T dO
//   dP = dO V^T                          f32
//   dS = P * (dP - rowsum(dP * P))       f32
//   dQ = bf16(dS * scale) K,  dK = bf16(dS * scale)^T Q
// and dQ, dK, dV are written, rounded to bf16, into their hd-wide slots of
// the packed (B, N, 3*dim) dqkv. No transposes, no concatenate.
//
// Bound on an H100 SXM: at the ViT-S training shape (192 views, N=261,
// dim 384, 6 heads) the pair must read qkv (115.5 MB) and dO (38.5 MB) and
// write dqkv (115.5 MB): 269 MB, 80 us at 3.35 TB/s, against 50.2 GFLOP
// (10 b h n^2 hd), 51 us at 989 TFLOP/s, so memory bounds it. The design
// does not reach that bound: it recomputes S and dP (three times over for a
// query/key tile pair) to keep every block independent, and re-reads K/V
// and Q/dO tiles from L2 once per tile pair. What it does do: the (N, N)
// matrices never leave shared memory, each output slot is written once, and
// no block adds into another's output, so the result is deterministic
// (no atomics). wgmma, TMA and a single fused pass are later work.
//
// Design: both kernels use the grid (ceil(N/64), heads, B) and 4 warps.
// * dq kernel, one 64-row query tile per CTA (each warp owns 16 rows). Pass 1
//   over the key tiles: online f32 row max m and row sum l of exp(s - m),
//   and the online sum of exp(s - m) * dP, which divided by l is
//   D = rowsum(dP * P). Pass 2 rebuilds P = exp(s - m) / l exactly, forms dS
//   and accumulates dQ in f32 wmma fragments. Writes the dQ slot and the
//   per-row (m, l, D) to a (B*heads, 3, N) f32 scratch.
// * dkv kernel, one 64-row key tile per CTA (each warp owns 16 key rows).
//   Loops over the query tiles, rebuilds P^T and dS^T from (m, l, D), and
//   accumulates dV and dK in f32 wmma fragments. Writes the dK and dV slots.
// Tensor-core products via nvcuda::wmma (bf16 x bf16 -> f32, 16x16x16).
// Rows past N are zero-loaded and masked out of every softmax; head dims 32,
// 64 and 88 are supported, 88 zero-padded to 96 in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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
  static constexpr size_t T0 = 0;  // dq: Q    dkv: K
  static constexpr size_t T1 = T0 + TILE;  // dq: dO   dkv: V
  static constexpr size_t T2 = T1 + TILE;  // dq: K    dkv: Q
  static constexpr size_t T3 = T2 + TILE;  // dq: V    dkv: dO
  static constexpr size_t S_OFF = T3 + TILE;
  static constexpr size_t DP_OFF = S_OFF + round128(sizeof(float) * BLOCK * LDS);
  static constexpr size_t P0_OFF = DP_OFF + round128(sizeof(float) * BLOCK * LDS);  // dq: dS  dkv: P^T
  static constexpr size_t P1_OFF = P0_OFF + round128(sizeof(__nv_bfloat16) * BLOCK * LDP);  // dkv: dS^T
  static constexpr size_t STAT_OFF = P1_OFF + round128(sizeof(__nv_bfloat16) * BLOCK * LDP);
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
packed_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const __nv_bfloat16* __restrict__ dout,
                               __nv_bfloat16* __restrict__ dqkv, float* __restrict__ stats,
                               int n, int heads, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::T0);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::T1);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::T2);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::T3);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  float* sdP = reinterpret_cast<float*>(smem + L::DP_OFF);
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + L::P0_OFF);
  float* sStage = reinterpret_cast<float*>(smem + L::S_OFF);

  const int q0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = heads * HD;
  const long long row_stride = 3LL * dim;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride + (long long)h * HD;
  const __nv_bfloat16* dbase = dout + (long long)b * n * dim + (long long)h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<HD>(sQ, base, row_stride, q0, n);
  load_tile<HD>(sdO, dbase, dim, q0, n);

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
    load_tile<HD>(sK, base + dim, row_stride, k0, n);
    load_tile<HD>(sV, base + 2 * dim, row_stride, k0, n);
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
    load_tile<HD>(sK, base + dim, row_stride, k0, n);
    load_tile<HD>(sV, base + 2 * dim, row_stride, k0, n);
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
  store_tile<HD>(dqkv + (long long)b * n * row_stride + (long long)h * HD, sStage, row_stride,
                 q0, n);
  const int row = q0 + warp * 16 + lr;
  if (half == 0 && row < n) {
    float* st = stats + ((long long)b * heads + h) * 3 * n;
    st[row] = m_run;
    st[n + row] = l_run;
    st[2 * n + row] = d_row;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
packed_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ stats,
                                __nv_bfloat16* __restrict__ dqkv, int n, int heads,
                                float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
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

  const int k0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = heads * HD;
  const long long row_stride = 3LL * dim;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride + (long long)h * HD;
  const __nv_bfloat16* dbase = dout + (long long)b * n * dim + (long long)h * HD;
  const float* st = stats + ((long long)b * heads + h) * 3 * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<HD>(sK, base + dim, row_stride, k0, n);
  load_tile<HD>(sV, base + 2 * dim, row_stride, k0, n);

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

  FragAcc dv[L::HDP / 16], dk[L::HDP / 16];
#pragma unroll
  for (int j = 0; j < L::HDP / 16; ++j) {
    wmma::fill_fragment(dv[j], 0.f);
    wmma::fill_fragment(dk[j], 0.f);
  }
  for (int q0 = 0; q0 < n; q0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<HD>(sQ, base, row_stride, q0, n);
    load_tile<HD>(sdO, dbase, dim, q0, n);
    for (int i = threadIdx.x; i < 3 * BLOCK; i += THREADS) {
      const int k = i / BLOCK, r = i % BLOCK;
      sStat[i] = q0 + r < n ? st[k * n + q0 + r] : 0.f;
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
    accumulate_p_times_tile<HD>(dv, sPw, sdO);  // dV += P^T dO
    accumulate_p_times_tile<HD>(dk, sdSw, sQ);  // dK += dS^T Q
  }

  __nv_bfloat16* out = dqkv + (long long)b * n * row_stride + (long long)h * HD;
  __syncthreads();  // S and dP are dead in every warp: the staging tile may alias them
  stage_fragments<HD>(sStage, dv);
  __syncthreads();
  store_tile<HD>(out + 2 * dim, sStage, row_stride, k0, n);
  __syncthreads();
  stage_fragments<HD>(sStage, dk);
  __syncthreads();
  store_tile<HD>(out + dim, sStage, row_stride, k0, n);
}

template <int HD>
cudaError_t launch_dq(const void* qkv, const void* dout, void* dqkv, void* stats, int b, int n,
                      int heads, float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  packed_attention_bwd_dq_kernel<HD><<<grid, THREADS, L::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(stats), n, heads, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* qkv, const void* dout, const void* stats, void* dqkv, int b,
                       int n, int heads, float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_bwd_dkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  packed_attention_bwd_dkv_kernel<HD><<<grid, THREADS, L::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(dqkv), n, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: (b, n, 3*heads*hd) bf16; dout: (b, n, heads*hd) bf16; dqkv: like qkv;
// stats: (b*heads, 3, n) f32 scratch. All contiguous and 16-byte aligned.
// The dq kernel writes the dq slots of dqkv and the per-row (m, l, D) to
// stats; the dkv kernel, launched after it on the same stream, reads stats
// and writes the dk and dv slots. Each returns the cudaError_t of its launch.
extern "C" int dinox_packed_attention_bwd_dq_bf16(const void* qkv, const void* dout, void* dqkv,
                                                  void* stats, int b, int n, int heads, int hd,
                                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch_dq<32>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
    case 64:
      return static_cast<int>(launch_dq<64>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
    case 88:
      return static_cast<int>(launch_dq<88>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dinox_packed_attention_bwd_dkv_bf16(const void* qkv, const void* dout,
                                                   const void* stats, void* dqkv, int b, int n,
                                                   int heads, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch_dkv<32>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    case 64:
      return static_cast<int>(launch_dkv<64>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    case 88:
      return static_cast<int>(launch_dkv<88>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
