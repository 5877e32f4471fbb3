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
// Design: the backward tile core of attention_bwd_sm90.cuh, the code the
// packed backward runs (packed_attention_bwd.cu, whose note gives the issued
// work), with q, k, v and dO brought by TMA through four 4-D maps
// (hd, N, H, B) that zero-fill rows past N and hd 88's columns 88-95; on the
// same data laid out packed and head-major the two give the same bits. The
// dq kernel writes dQ and each row's (m, l, D) to a (B*H, 3, N) f32 scratch;
// the dkv kernel, launched after it, reads them and writes dK and dV.
// Deterministic, no atomics; any N; hd 32, 64 and 88.

#include "attention_bwd_sm90.cuh"

namespace {

using namespace dinox_bwd;

template <int HD>
cudaError_t head_major_maps(const void* const (&bases)[4], int b, int heads, int n,
                            CUtensorMap (&maps)[4]) {
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * n, 2ull * HD * n * heads};
  const cuuint32_t box[4] = {BOX_COLS, BLOCK, 1, 1};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_map(&maps[i], bases[i], dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int HD>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, void* dqo,
               void* stats, int b, int heads, int n, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const cudaError_t err = head_major_maps<HD>({q, k, v, dout}, b, heads, n, maps);
  if (err != cudaSuccess) return err;
  return launch_dq<HD, false>(maps[0], maps[1], maps[2], maps[3], dqo, stats, b, heads, n, scale,
                              stream);
}

template <int HD>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* stats,
                void* dk, void* dv, int b, int heads, int n, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const cudaError_t err = head_major_maps<HD>({q, k, v, dout}, b, heads, n, maps);
  if (err != cudaSuccess) return err;
  return launch_dkv<HD, false>(maps[0], maps[1], maps[2], maps[3], stats, dk, dv, b, heads, n,
                               scale, stream);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (b, heads, n, hd) bf16; stats: (b*heads, 3, n)
// f32 scratch. All contiguous and 16-byte aligned. The dq kernel writes dq
// and the per-row (m, l, D) to stats; the dkv kernel, launched after it on
// the same stream, reads stats and writes dk and dv. Each returns the
// cudaError_t of its launch.
extern "C" int dinox_mha_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, void* dq_out, void* stats, int b,
                                               int heads, int n, int hd, float scale,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(dq<32>(q, k, v, dout, dq_out, stats, b, heads, n, scale, s));
    case 64:
      return static_cast<int>(dq<64>(q, k, v, dout, dq_out, stats, b, heads, n, scale, s));
    case 88:
      return static_cast<int>(dq<88>(q, k, v, dout, dq_out, stats, b, heads, n, scale, s));
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
      return static_cast<int>(dkv<32>(q, k, v, dout, stats, dk, dv, b, heads, n, scale, s));
    case 64:
      return static_cast<int>(dkv<64>(q, k, v, dout, stats, dk, dv, b, heads, n, scale, s));
    case 88:
      return static_cast<int>(dkv<88>(q, k, v, dout, stats, dk, dv, b, heads, n, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of the dq (part 0) or dkv (part 1) kernel at head dim hd.
// Returns a cudaError_t.
extern "C" int dinox_mha_attention_bwd_occupancy(int hd, int part, int* regs, int* smem,
                                                 int* ctas) {
  switch (hd) {
    case 32:
      return static_cast<int>(occupancy_bwd<32, false>(part, regs, smem, ctas));
    case 64:
      return static_cast<int>(occupancy_bwd<64, false>(part, regs, smem, ctas));
    case 88:
      return static_cast<int>(occupancy_bwd<88, false>(part, regs, smem, ctas));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
