// Head-major multi-head attention backward for Hopper (sm_90a): two kernels,
// dq and dkv.
//
// Replaces the TPU kernel `_mha_bwd_kernel` (kernel 5, reached through
// `_flash_bwd` and the VJP rule of `flash_attention`, all in
// dinox_tpu/ops/flash_attention.py). Same function as the packed backward
// (kernel 2), on head-major (B, H, N, hd) q, k, v and output gradient dO:
//   s  = (q k^T) * scale, P = softmax(s)  f32
//   dV = bf16(P)^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P))
//   dQ = bf16(dS * scale) K,  dK = bf16(dS * scale)^T Q
// written, rounded to bf16, as three (B, H, N, hd) tensors.
//
// Bound on an H100 SXM: at (192, 6, 261, 64) the pair must read q, k, v and
// dO (154 MB) and write dq, dk, dv (115.5 MB): 269.4 MB, 80.4 us at
// 3.35 TB/s, against 50.2 GFLOP, 51 us at 989 TFLOP/s, so memory bounds it.
//
// Design: the tile code of attention_bwd_tile.cuh, the same code the packed
// backward runs (packed_attention_bwd.cu), addressed here by the head's base
// (b*H + h)*N*hd and a row pitch of hd; on the same data laid out packed and
// head-major the two give the same bits. Grid (ceil(N/64), H, B), 4 warps.
// The dq kernel writes dQ and each row's (m, l, D) to a (B*H, 3, N) f32
// scratch; the dkv kernel, launched after it, reads them and writes dK and
// dV. Deterministic, no atomics; any N; hd 32, 64 and 88 (88 zero-padded to
// 96 in shared memory). Row addresses are 16-byte aligned for every N, since
// hd * 2 bytes is a multiple of 16. It inherits the packed pair's distance
// from the bound (S and dP recomputed in both kernels, K/V and Q/dO tiles
// re-read from L2 per tile pair); wgmma and TMA are later work.

#include "attention_bwd_tile.cuh"

namespace {

using dinox_attn_bwd::BLOCK;
using dinox_attn_bwd::Layout;
using dinox_attn_bwd::THREADS;

template <int HD>
__global__ void __launch_bounds__(THREADS)
mha_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int n,
                            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long off = bh * n * HD;
  dinox_attn_bwd::dq_tile<HD>(q + off, k + off, v + off, HD, dout + off, HD, dq + off, HD,
                              stats + bh * 3 * n, n, blockIdx.x * BLOCK, scale, smem);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
mha_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int n, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long bh = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const long long off = bh * n * HD;
  dinox_attn_bwd::dkv_tile<HD>(q + off, k + off, v + off, HD, dout + off, HD, stats + bh * 3 * n,
                               dk + off, dv + off, HD, n, blockIdx.x * BLOCK, scale, smem);
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      void* stats, int b, int heads, int n, float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(mha_attention_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  using B = const __nv_bfloat16*;
  mha_attention_bwd_dq_kernel<HD><<<grid, THREADS, L::SMEM, stream>>>(
      static_cast<B>(q), static_cast<B>(k), static_cast<B>(v), static_cast<B>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<float*>(stats), n, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* stats, void* dk, void* dv, int b, int heads, int n, float scale,
                       cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(mha_attention_bwd_dkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  using B = const __nv_bfloat16*;
  mha_attention_bwd_dkv_kernel<HD><<<grid, THREADS, L::SMEM, stream>>>(
      static_cast<B>(q), static_cast<B>(k), static_cast<B>(v), static_cast<B>(dout),
      static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (b, heads, n, hd) bf16; stats: (b*heads, 3, n)
// f32 scratch. All contiguous and 16-byte aligned. The dq kernel writes dq
// and the per-row (m, l, D) to stats; the dkv kernel, launched after it on
// the same stream, reads stats and writes dk and dv. Each returns the
// cudaError_t of its launch.
extern "C" int dinox_mha_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, void* dq, void* stats, int b,
                                               int heads, int n, int hd, float scale,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch_dq<32>(q, k, v, dout, dq, stats, b, heads, n, scale, s));
    case 64:
      return static_cast<int>(launch_dq<64>(q, k, v, dout, dq, stats, b, heads, n, scale, s));
    case 88:
      return static_cast<int>(launch_dq<88>(q, k, v, dout, dq, stats, b, heads, n, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dinox_mha_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                const void* dout, const void* stats, void* dk,
                                                void* dv, int b, int heads, int n, int hd,
                                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(
          launch_dkv<32>(q, k, v, dout, stats, dk, dv, b, heads, n, scale, s));
    case 64:
      return static_cast<int>(
          launch_dkv<64>(q, k, v, dout, stats, dk, dv, b, heads, n, scale, s));
    case 88:
      return static_cast<int>(
          launch_dkv<88>(q, k, v, dout, stats, dk, dv, b, heads, n, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
