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
// Design: the tile core of attention_fwd_sm90.cuh with Rounding::Normalised.
// An online softmax cannot round the normalised P, because the row sum is not
// known until the last key tile, so each CTA makes two passes over the key
// tiles in one launch: pass 1 streams K alone and keeps only the f32 row max
// and row sum, pass 2 streams K and V, forms P = bf16(exp(s - m) / l) and
// accumulates O += P V. The second Q K^T issues 50% more tensor-core work
// than one pass (25.8 GFLOP at the bring-up shape), which wgmma (the card's
// full-rate path) absorbs; q, k and v come by TMA through three 3-D maps
// (hd, N, H * B as (hd, N, H, B)) that zero-fill rows past N and the columns
// 88-95 of hd 88, and S, P and O stay in registers.

#include "attention_fwd_sm90.cuh"

namespace {

using namespace dinox_fwd;

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int heads, int n,
                   float scale, cudaStream_t stream) {
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * n, 2ull * HD * n * heads};
  const cuuint32_t box[4] = {BOX_COLS, BLOCK_N, 1, 1};
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = encode_map(&maps[i], bases[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return launch_fwd<HD, Rounding::Normalised, false>(maps[0], maps[1], maps[2], out, b, heads, n,
                                                     scale, stream);
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

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of the kernel at head dim hd. Returns a cudaError_t.
extern "C" int dinox_mha_attention_fwd_occupancy(int hd, int* regs, int* smem, int* ctas) {
  switch (hd) {
    case 32:
      return static_cast<int>(occupancy<32, Rounding::Normalised, false>(regs, smem, ctas));
    case 64:
      return static_cast<int>(occupancy<64, Rounding::Normalised, false>(regs, smem, ctas));
    case 88:
      return static_cast<int>(occupancy<88, Rounding::Normalised, false>(regs, smem, ctas));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
