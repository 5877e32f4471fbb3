// Fused attention half-block for Hopper (sm_90a):
//   y = x + proj(attention(qkv(LN(x)))), also emitting qkv and the attention
//   output for the backward.
//
// Replaces the TPU kernel `_fused_kernel` (dinox_tpu/ops/fused_attn_block.py,
// reached through `_call_fused` / `fused_attn_block`). Same function and
// rounding points: LayerNorm statistics in f32 with the fast variance
// E[x^2] - E[x]^2 clipped at 0, ln rounded to bf16; qkv = bf16(ln Wqkv^T +
// bqkv) with the f32 bias added to the f32 accumulator; attention as the
// packed forward (kernel 1: scale folded into q, f32 logits, bf16 exp before
// PV, division after PV); y = bf16(x32 + (attn Wproj^T + bproj)), bias and
// residual in f32. Weights are bf16 in the (out, in) layout: Wqkv (3*dim,
// dim), Wproj (dim, dim).
//
// Bound on an H100 SXM: at the ViT-S training shape (192 views, N=261,
// dim 384, 6 heads) the call does 79.2 GFLOP (the two projections and the two
// attention products) and must move 232 MB (x in; y, qkv and attn out; the
// weights), so the tensor cores bound it: 0.080 ms at 989 TFLOP/s against
// 0.069 ms at 3.35 TB/s. At the serving shape (32 views) 13.2 GFLOP, 0.013 ms.
//
// The dependency: a query row's attention needs the keys and values of every
// row of its view, so the TPU kernel's single pass per batch group becomes
// three launches in order on the caller's stream, stream order in place of a
// barrier:
//   1. fused_attn_block_qkv: LN + QKV over the flattened B*N rows on the GEMM
//      core (gemm_sm90.cuh) with the LayerNorm prologue and the BiasRound
//      epilogue: qkv = bf16(ln Wqkv^T + bqkv), LN once per row block and
//      column group;
//   2. kernel 1's tile core (attention_fwd_sm90.cuh, Rounding::Packed) on qkv
//      through the same 4-D map as packed_attention.cu, so attn has kernel
//      1's bits on this qkv;
//   3. fused_attn_block_proj: the GEMM core with no prologue and the
//      BiasResidual epilogue: y = bf16(x32 + (attn Wproj^T + bproj)).
// qkv and attn go to device memory and are read back (they are outputs the
// backward needs anyway), so the three parts' bounds sum to more than the
// fused bound: 0.127 ms at the training shape against 0.080.
// Head dims 32, 64 and 88; dim a multiple of 8 and at most MAX_K (1408); any
// B and N.

#include "gemm_sm90.cuh"

namespace {

using dinox_fwd::Rounding;
using dinox_gemm::BiasResidual;
using dinox_gemm::BiasRound;
using dinox_gemm::Layout;
using dinox_gemm::LayerNorm;
using dinox_gemm::NoPrologue;

template <int WGS>
__global__ void __launch_bounds__(Layout<WGS>::THREADS, 1)
fused_attn_block_qkv(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_qkv, const LayerNorm pro,
                     const BiasRound epi, int m, int k, int nout, int stages, int tiles_per_cta) {
  dinox_gemm::gemm_rows<WGS>(&map_x, &map_w, &map_qkv, pro, epi, m, k, nout, stages,
                             tiles_per_cta);
}

template <int WGS>
__global__ void __launch_bounds__(Layout<WGS>::THREADS, 1)
fused_attn_block_proj(const __grid_constant__ CUtensorMap map_attn,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_y, const NoPrologue pro,
                      const BiasResidual epi, int m, int k, int nout, int stages,
                      int tiles_per_cta) {
  dinox_gemm::gemm_rows<WGS>(&map_attn, &map_w, &map_y, pro, epi, m, k, nout, stages,
                             tiles_per_cta);
}

// Two consumer warpgroups (128-row blocks) where their A block fits beside
// two W stages, else one.
bool wide(int dim) { return Layout<2>::stages(dim) >= 2; }

template <int WGS>
cudaError_t projection(int part, const void* x, const void* gamma, const void* beta,
                       const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
                       void* y, void* qkv, const void* attn, int m, int dim, cudaStream_t s) {
  if (part == 0)
    return dinox_gemm::launch_gemm<WGS>(
        fused_attn_block_qkv<WGS>, x, wqkv, m, dim, 3 * dim,
        LayerNorm{static_cast<const float*>(gamma), static_cast<const float*>(beta)},
        BiasRound{static_cast<const float*>(bqkv), static_cast<__nv_bfloat16*>(qkv)}, s);
  return dinox_gemm::launch_gemm<WGS>(
      fused_attn_block_proj<WGS>, attn, wproj, m, dim, dim, NoPrologue{},
      BiasResidual{static_cast<const float*>(bproj), static_cast<const __nv_bfloat16*>(x),
                   static_cast<__nv_bfloat16*>(y)},
      s);
}

template <int HD>
cudaError_t attention(const void* qkv, void* attn, int b, int n, int heads, float scale,
                      cudaStream_t s) {
  CUtensorMap map;
  const cudaError_t err = dinox_fwd::encode_packed_map<HD>(&map, qkv, b, n, heads);
  if (err != cudaSuccess) return err;
  return dinox_fwd::launch_fwd<HD, Rounding::Packed, true>(map, map, map, attn, b, heads, n, scale,
                                                           s);
}

cudaError_t attention_any(int hd, const void* qkv, void* attn, int b, int n, int heads,
                          float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return attention<32>(qkv, attn, b, n, heads, scale, s);
    case 64:
      return attention<64>(qkv, attn, b, n, heads, scale, s);
    case 88:
      return attention<88>(qkv, attn, b, n, heads, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (b, n, dim) bf16; gamma, beta: (dim,) f32; wqkv: (3*dim, dim) bf16;
// bqkv: (3*dim,) f32; wproj: (dim, dim) bf16; bproj: (dim,) f32; outputs y:
// (b, n, dim), qkv: (b, n, 3*dim), attn: (b, n, dim), bf16. All contiguous and
// 16-byte aligned; dim = heads * hd. Three launches on `stream`; returns the
// first cudaError_t that is not 0, or 0.
extern "C" int dinox_fused_attn_block_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                               const void* wqkv, const void* bqkv,
                                               const void* wproj, const void* bproj, void* y,
                                               void* qkv, void* attn, int b, int n, int heads,
                                               int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dim = heads * hd;
  const int m = b * n;
  if (hd != 32 && hd != 64 && hd != 88) return static_cast<int>(cudaErrorInvalidValue);
  auto project = wide(dim) ? &projection<2> : &projection<1>;
  cudaError_t err = project(0, x, gamma, beta, wqkv, bqkv, wproj, bproj, y, qkv, attn, m, dim, s);
  if (err == cudaSuccess) err = attention_any(hd, qkv, attn, b, n, heads, scale, s);
  if (err == cudaSuccess)
    err = project(1, x, gamma, beta, wqkv, bqkv, wproj, bproj, y, qkv, attn, m, dim, s);
  return static_cast<int>(err);
}

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of the GEMM launch `part` (0: LN + QKV, 1: proj + residual) at
// width dim. Returns a cudaError_t.
extern "C" int dinox_fused_attn_block_occupancy(int part, int dim, int* regs, int* smem,
                                                int* ctas) {
  cudaError_t err;
  if (wide(dim))
    err = part == 0 ? dinox_gemm::gemm_occupancy<2>(fused_attn_block_qkv<2>, dim, regs, smem, ctas)
                    : dinox_gemm::gemm_occupancy<2>(fused_attn_block_proj<2>, dim, regs, smem, ctas);
  else
    err = part == 0 ? dinox_gemm::gemm_occupancy<1>(fused_attn_block_qkv<1>, dim, regs, smem, ctas)
                    : dinox_gemm::gemm_occupancy<1>(fused_attn_block_proj<1>, dim, regs, smem, ctas);
  return static_cast<int>(err);
}

// The grid of the GEMM launch `part` over m rows at width dim: row blocks,
// column groups and column tiles per CTA. Returns a cudaError_t.
extern "C" int dinox_fused_attn_block_grid(int part, int m, int dim, int* rows, int* groups,
                                           int* per_cta) {
  const int nout = part == 0 ? 3 * dim : dim;
  dinox_gemm::Grid g = {};
  cudaError_t err;
  if (wide(dim))
    err = part == 0 ? dinox_gemm::gemm_grid<2>(fused_attn_block_qkv<2>, m, dim, nout, &g)
                    : dinox_gemm::gemm_grid<2>(fused_attn_block_proj<2>, m, dim, nout, &g);
  else
    err = part == 0 ? dinox_gemm::gemm_grid<1>(fused_attn_block_qkv<1>, m, dim, nout, &g)
                    : dinox_gemm::gemm_grid<1>(fused_attn_block_proj<1>, m, dim, nout, &g);
  *rows = g.rows;
  *groups = g.groups;
  *per_cta = g.per_cta;
  return static_cast<int>(err);
}
