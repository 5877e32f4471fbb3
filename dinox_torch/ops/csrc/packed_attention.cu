// Packed-QKV multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_kernel` (dinox_tpu/ops/flash_attention.py,
// reached through `_packed_fwd` / `flash_attention_packed`). Same function:
// for every (batch, head), softmax(q k^T / sqrt(hd)) v, where q, k and v are
// hd-wide column slices of the packed (B, N, 3*dim) [q|k|v] row, written into
// the head's slice of the token-major (B, N, dim) output. No transposes on
// either side. Rounding points follow the TPU kernel: the scale is folded into
// q and rounded to bf16, logits and softmax statistics are f32, the
// unnormalised exp is rounded to bf16 before the PV product, and the division
// by the row sum comes after PV.
//
// Bound on an H100 SXM: at the ViT-S serving shape (B=32, N=261, dim 384,
// 6 heads, hd 64) the call moves 25.7 MB (qkv read once, out written once)
// and does 3.35 GFLOP, so memory bounds it (7.7 us at 3.35 TB/s against
// 3.4 us at 989 TFLOP/s). The design reads every qkv byte from device memory
// once per query tile: K/V tiles are re-read by the ceil(N/64) query-tile CTAs
// of a (batch, head), which L2 absorbs at these sizes, and the logits never
// leave shared memory. What the design does not do yet (later work): wgmma,
// TMA and a pipelined K/V ring; this version is simple and right first.
//
// Design: grid (ceil(N/64) query tiles, heads, B); 4 warps. Each CTA runs
// the online-softmax tile core of attention_tile.cuh (shared with the fused
// attention half-block, fused_attn_block.cu) on its (batch, head, query tile):
// Q, then 64-row K/V tiles staged in shared memory, tensor-core products via
// nvcuda::wmma (bf16 x bf16 -> f32), f32 O in shared memory, any N (the
// ragged edge masked), head dims 32, 64 and 88 (88 zero-padded to 96).

#include "attention_tile.cuh"

namespace {

using dinox_attn::BLOCK_M;
using dinox_attn::Layout;
using dinox_attn::THREADS;

template <int HD>
__global__ void __launch_bounds__(THREADS)
packed_attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            __nv_bfloat16* __restrict__ out, int n, int heads,
                            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = heads * HD;
  dinox_attn::attention_tile<HD>(qkv + (long long)b * n * 3 * dim + (long long)h * HD,
                                 out + (long long)b * n * dim + (long long)h * HD, n, dim,
                                 blockIdx.x * BLOCK_M, scale, smem);
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, float scale,
                   cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK_M - 1) / BLOCK_M, heads, b);
  packed_attention_fwd_kernel<HD><<<grid, THREADS, L::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), n, heads,
      scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: (b, n, 3*heads*hd) bf16, contiguous; out: (b, n, heads*hd) bf16,
// contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int dinox_packed_attention_fwd_bf16(const void* qkv, void* out, int b, int n,
                                               int heads, int hd, float scale,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch<32>(qkv, out, b, n, heads, scale, s));
    case 64:
      return static_cast<int>(launch<64>(qkv, out, b, n, heads, scale, s));
    case 88:
      return static_cast<int>(launch<88>(qkv, out, b, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
