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
// Design: both kernels use the grid (ceil(N/64), heads, B) and 4 warps and
// run the tile code of attention_bwd_tile.cuh (shared with the head-major
// backward, mha_attention_bwd.cu, which gives the same bits on the same
// data): the dq kernel one 64-row query tile per CTA, writing the dQ slot
// and each row's (m, l, D) to a (B*heads, 3, N) f32 scratch; then the dkv
// kernel one 64-row key tile per CTA, writing the dK and dV slots.

#include "attention_bwd_tile.cuh"

namespace {

using dinox_attn_bwd::BLOCK;
using dinox_attn_bwd::Layout;
using dinox_attn_bwd::THREADS;

template <int HD>
__global__ void __launch_bounds__(THREADS)
packed_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const __nv_bfloat16* __restrict__ dout,
                               __nv_bfloat16* __restrict__ dqkv, float* __restrict__ stats,
                               int n, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = heads * HD;
  const long long pitch = 3LL * dim;
  const long long off = (long long)b * n * pitch + (long long)h * HD;
  const __nv_bfloat16* q = qkv + off;
  dinox_attn_bwd::dq_tile<HD>(q, q + dim, q + 2 * dim, pitch,
                              dout + (long long)b * n * dim + (long long)h * HD, dim, dqkv + off,
                              pitch, stats + ((long long)b * heads + h) * 3 * n, n,
                              blockIdx.x * BLOCK, scale, smem);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
packed_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ stats,
                                __nv_bfloat16* __restrict__ dqkv, int n, int heads,
                                float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = heads * HD;
  const long long pitch = 3LL * dim;
  const long long off = (long long)b * n * pitch + (long long)h * HD;
  const __nv_bfloat16* q = qkv + off;
  dinox_attn_bwd::dkv_tile<HD>(q, q + dim, q + 2 * dim, pitch,
                               dout + (long long)b * n * dim + (long long)h * HD, dim,
                               stats + ((long long)b * heads + h) * 3 * n, dqkv + off + dim,
                               dqkv + off + 2 * dim, pitch, n, blockIdx.x * BLOCK, scale, smem);
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
