// Head-major multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mha_kernel` (kernel 4, reached through
// `_flash_fwd` and `flash_attention`, dinox_tpu/ops/flash_attention.py).
// Same function, with its rounding points: for every (batch, head) of
// head-major (B, H, N, hd) q, k, v,
//   s = (q k^T) * scale                  f32 (the scale multiplies the logits;
//                                        it is not folded into a rounded q)
//   P = bf16(exp(s - max s) / sum)       normalised in f32, THEN rounded
//   o = bf16(P v)                        f32 accumulation
// which is also the JAX package's plain `_xla_sdpa` / `sdpa_xla`. This is not
// kernel 1's rounding (there the unnormalised exp is rounded and the division
// comes after PV).
//
// Bound on an H100 SXM: at (192, 6, 261, 64) the call moves 153.9 MB (q, k, v
// read once, out written once) against 20.1 GFLOP, so memory bounds it
// (46.0 us at 3.35 TB/s against 20.3 us at 989 TFLOP/s). At the bring-up
// shape (8, 8, 1024, 64) it moves 33.6 MB against 17.2 GFLOP, so the tensor
// cores bound it (17.4 us at 989 TFLOP/s against 10.0 us of bytes).
//
// Design: an online softmax cannot round the normalised P, because the row
// sum is not known until the last key tile. So each CTA makes two passes
// over the key tiles: pass 1 computes S and the f32 row max m and row sum l
// (online, as the backward's dq pass 1 does); pass 2 computes S again, forms
// P = bf16(exp(s - m) / l) and accumulates O += P V in f32 wmma fragments,
// then writes O rounded to bf16. The second Q K^T costs 50% more FLOPs than
// one pass (three (N, N, hd) products instead of two); that is accepted for
// now. Grid (ceil(N/64), H, B), 4 warps (each owning 16 query rows), Q, K
// and V tiles of 64 rows in shared memory, tensor-core products via
// nvcuda::wmma (bf16 x bf16 -> f32), any N with the ragged edge masked, hd
// 32, 64 and 88 (88 zero-padded to 96 in shared memory). Row addresses are
// 16-byte aligned for every N, since hd * 2 bytes is a multiple of 16. The
// tile helpers (loads, products, staging) are the backward's, from
// attention_bwd_tile.cuh. wgmma, TMA and a pipelined K/V ring are later work.

#include "attention_bwd_tile.cuh"

namespace {

using dinox_attn_bwd::BLOCK;
using dinox_attn_bwd::Layout;
using dinox_attn_bwd::THREADS;

// Shared memory of the forward: Q, K and V tiles, the f32 logits of a K tile
// and the bf16 probabilities; the f32 output staging tile aliases S and P
// once the second pass is over.
template <int HD>
struct FwdLayout {
  using L = Layout<HD>;
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + L::TILE;
  static constexpr size_t V_OFF = K_OFF + L::TILE;
  static constexpr size_t S_OFF = V_OFF + L::TILE;
  static constexpr size_t P_OFF = S_OFF + L::S_TILE;
  static constexpr size_t SMEM = P_OFF + L::P_TILE;
  static_assert(sizeof(float) * BLOCK * L::LDO <= SMEM - S_OFF, "staging tile does not fit");
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
mha_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int n, float scale) {
  using namespace dinox_attn_bwd;
  using L = Layout<HD>;
  using F = FwdLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + F::Q_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + F::K_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + F::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + F::S_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + F::P_OFF);
  float* sStage = reinterpret_cast<float*>(smem + F::S_OFF);

  const int q0 = blockIdx.x * BLOCK;
  const long long off = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * n * HD;
  const __nv_bfloat16* kh = k + off;
  const __nv_bfloat16* vh = v + off;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  load_tile<HD>(sQ, q + off, HD, q0, n);

  // Two lanes share a row, each holding half of its 64 key columns.
  const int lr = lane >> 1;
  const int half = lane & 1;
  const __nv_bfloat16* sQw = sQ + warp * 16 * L::LDB;
  float* sSw = sS + warp * 16 * L::LDS;
  __nv_bfloat16* sPw = sP + warp * 16 * L::LDP;
  const float* srow = sSw + lr * L::LDS + half * 32;
  __nv_bfloat16* prow = sPw + lr * L::LDP + half * 32;

  // Pass 1: row max m and row sum l of exp(s - m).
  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < n; k0 += BLOCK) {
    __syncthreads();  // every warp is done with the previous K tile (and Q is in place)
    load_tile<HD>(sK, kh, HD, k0, n);
    __syncthreads();
    rows_times_tile_t<HD>(sSw, sQw, sK);
    __syncwarp();
    const int cbase = k0 + half * 32;
    float tmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (cbase + c < n) tmax = fmaxf(tmax, srow[c] * scale);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile holds a key < N
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (cbase + c < n) psum += expf(srow[c] * scale - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the lanes are done reading S before the next tile overwrites it
  }

  // Pass 2: P = bf16(exp(s - m) / l), O += P V.
  FragAcc acc[L::HDP / 16];
#pragma unroll
  for (int j = 0; j < L::HDP / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < n; k0 += BLOCK) {
    __syncthreads();
    load_tile<HD>(sK, kh, HD, k0, n);
    load_tile<HD>(sV, vh, HD, k0, n);
    __syncthreads();
    rows_times_tile_t<HD>(sSw, sQw, sK);
    __syncwarp();
    const int cbase = k0 + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = cbase + c < n ? expf(srow[c] * scale - m_run) / l_run : 0.f;
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
    accumulate_p_times_tile<HD>(acc, sPw, sV);
  }

  __syncthreads();  // S and P are dead in every warp: the staging tile may alias them
  stage_fragments<HD>(sStage, acc);
  __syncthreads();
  store_tile<HD>(out + off, sStage, HD, q0, n);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int heads, int n,
                   float scale, cudaStream_t stream) {
  using F = FwdLayout<HD>;
  cudaError_t err = cudaFuncSetAttribute(mha_attention_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  using B = const __nv_bfloat16*;
  mha_attention_fwd_kernel<HD><<<grid, THREADS, F::SMEM, stream>>>(
      static_cast<B>(q), static_cast<B>(k), static_cast<B>(v), static_cast<__nv_bfloat16*>(out),
      n, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (b, heads, n, hd) bf16, contiguous, 16-byte aligned. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int dinox_mha_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                            int b, int heads, int n, int hd, float scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch<32>(q, k, v, out, b, heads, n, scale, s));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, out, b, heads, n, scale, s));
    case 88:
      return static_cast<int>(launch<88>(q, k, v, out, b, heads, n, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
