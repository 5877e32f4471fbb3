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
// write dqkv (115.5 MB): 269.4 MB, 80.4 us at 3.35 TB/s, against 50.2 GFLOP
// (10 b h n^2 hd), 51 us at 989 TFLOP/s, so memory bounds it.
//
// Issued work, and what the design does about it: the backward tile core of
// attention_bwd_sm90.cuh, one wgmma consumer warpgroup and one TMA producer
// warp per CTA, the same code the head-major backward (mha_attention_bwd.cu)
// runs, so the two give the same bits on the same data. The dq kernel (one
// 64-row query tile per CTA) computes S and dP twice (once for the softmax
// statistics and D, once to form dS) and dQ; the dkv kernel (one 64-row key
// tile per CTA) S^T, dP^T, dV and dK: 9 tile products per (query, key) tile
// pair where one fused kernel would issue 5, 115.5 GFLOP at the training
// shape (the CTA's rows padded to 320, the looped rows to 272), bought for
// determinism without atomics and the reference's exact D = rowsum(dP * P).
// Every product runs
// on wgmma with its accumulator in registers, and each streamed tile's TMA
// load overlaps the previous tile's products; the (N, N) matrices never
// leave registers. What is left above the byte bound: each CTA rereads its
// head's K/V (dq, twice) or Q/dO (dkv) from L2, ~1.2 GB a call by count.
// q, k and v come by TMA through one 4-D map (hd, 3*heads, N, B) of qkv, dO
// through one (hd, heads, N, B), both with an innermost extent of exactly
// hd, so hd 88 is zero-padded to 96 without touching the next head.

#include "attention_bwd_sm90.cuh"

namespace {

using namespace dinox_bwd;

// The maps of qkv (q, k, v in head slots h, heads + h, 2 * heads + h) and dO.
template <int HD>
cudaError_t packed_maps(const void* qkv, const void* dout, int b, int n, int heads,
                        CUtensorMap* map_qkv, CUtensorMap* map_do) {
  const cuuint32_t box[4] = {BOX_COLS, 1, BLOCK, 1};
  const cuuint64_t row = 6ull * heads * HD;  // bytes of one packed qkv row
  const cuuint64_t dims[4] = {HD, 3ull * heads, static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * HD, row, row * n};
  const cudaError_t err = encode_map(map_qkv, qkv, dims, strides, box);
  if (err != cudaSuccess) return err;
  const cuuint64_t drow = 2ull * heads * HD;  // bytes of one dO row
  const cuuint64_t ddims[4] = {HD, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(n),
                               static_cast<cuuint64_t>(b)};
  const cuuint64_t dstrides[3] = {2ull * HD, drow, drow * n};
  return encode_map(map_do, dout, ddims, dstrides, box);
}

template <int HD>
cudaError_t dq(const void* qkv, const void* dout, void* dqkv, void* stats, int b, int n,
               int heads, float scale, cudaStream_t stream) {
  CUtensorMap map, map_do;
  const cudaError_t err = packed_maps<HD>(qkv, dout, b, n, heads, &map, &map_do);
  if (err != cudaSuccess) return err;
  return launch_dq<HD, true>(map, map, map, map_do, dqkv, stats, b, heads, n, scale, stream);
}

template <int HD>
cudaError_t dkv(const void* qkv, const void* dout, const void* stats, void* dqkv, int b, int n,
                int heads, float scale, cudaStream_t stream) {
  CUtensorMap map, map_do;
  const cudaError_t err = packed_maps<HD>(qkv, dout, b, n, heads, &map, &map_do);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dqkv);
  const int dim = heads * HD;
  return launch_dkv<HD, true>(map, map, map, map_do, stats, out + dim, out + 2 * dim, b, heads,
                              n, scale, stream);
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
      return static_cast<int>(dq<32>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
    case 64:
      return static_cast<int>(dq<64>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
    case 88:
      return static_cast<int>(dq<88>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
    case 128:
      return static_cast<int>(dq<128>(qkv, dout, dqkv, stats, b, n, heads, scale, s));
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
      return static_cast<int>(dkv<32>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    case 64:
      return static_cast<int>(dkv<64>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    case 88:
      return static_cast<int>(dkv<88>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    case 128:
      return static_cast<int>(dkv<128>(qkv, dout, stats, dqkv, b, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of the dq (part 0) or dkv (part 1) kernel at head dim hd.
// Returns a cudaError_t.
extern "C" int dinox_packed_attention_bwd_occupancy(int hd, int part, int* regs, int* smem,
                                                    int* ctas) {
  switch (hd) {
    case 32:
      return static_cast<int>(occupancy_bwd<32, true>(part, regs, smem, ctas));
    case 64:
      return static_cast<int>(occupancy_bwd<64, true>(part, regs, smem, ctas));
    case 88:
      return static_cast<int>(occupancy_bwd<88, true>(part, regs, smem, ctas));
    case 128:
      return static_cast<int>(occupancy_bwd<128, true>(part, regs, smem, ctas));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
