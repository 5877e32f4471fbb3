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
// Bound on an H100 SXM: at the ViT-S training shape (B=192, N=261, dim 384,
// 6 heads, hd 64) the call moves 153.9 MB (qkv read once, out written once)
// against 20.1 GFLOP, so memory bounds it (46.0 us at 3.35 TB/s against
// 20.3 us at 989 TFLOP/s); at the serving shape (B=32) 25.7 MB, 7.7 us. What
// the design does about it: the tile core of attention_fwd_sm90.cuh (Rounding
// ::Packed) reads q, k and v straight from the packed rows by TMA, through one
// 4-D tensor map (hd, 3*heads, N, B) whose innermost extent is exactly hd, so
// hd 88 is zero-padded to 96 without touching the next head; K/V tiles
// stream through a two-stage ring while wgmma runs on the previous one; S, P
// and the f32 O accumulator stay in registers, and the output leaves from
// registers straight into the head's columns. Every K/V byte is read from
// L2 by the ceil(N/64) query-tile CTAs of its (batch, head), four CTAs to an
// SM, so L2 traffic is ~3.3x the bound's bytes at N = 261.

#include "attention_fwd_sm90.cuh"

namespace {

using namespace dinox_fwd;

template <int HD>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, float scale,
                   cudaStream_t stream) {
  CUtensorMap map;
  const cudaError_t err = encode_packed_map<HD>(&map, qkv, b, n, heads);
  if (err != cudaSuccess) return err;
  return launch_fwd<HD, Rounding::Packed, true>(map, map, map, out, b, heads, n, scale, stream);
}

}  // namespace

// qkv: (b, n, 3*heads*hd) bf16, contiguous, 16-byte aligned; out: (b, n,
// heads*hd) bf16, contiguous. Returns the cudaError_t of the launch (0 on
// success).
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
    case 128:
      return static_cast<int>(launch<128>(qkv, out, b, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of the kernel at head dim hd. Returns a cudaError_t.
extern "C" int dinox_packed_attention_fwd_occupancy(int hd, int* regs, int* smem, int* ctas) {
  switch (hd) {
    case 32:
      return static_cast<int>(occupancy<32, Rounding::Packed, true>(regs, smem, ctas));
    case 64:
      return static_cast<int>(occupancy<64, Rounding::Packed, true>(regs, smem, ctas));
    case 88:
      return static_cast<int>(occupancy<88, Rounding::Packed, true>(regs, smem, ctas));
    case 128:
      return static_cast<int>(occupancy<128, Rounding::Packed, true>(regs, smem, ctas));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
