// Fused transformer-MLP half-block forward for Hopper (sm_90a):
//   y = x + fc2(GELU_erf(fc1(LayerNorm(x)))) over rows of width C.
//
// Replaces the TPU kernel `_fwd_kernel` (dinox_tpu/ops/fused_mlp.py, reached
// through `_fwd` / `fused_mlp_block`). Same function and rounding points:
// LayerNorm in f32 with the two-pass variance mean((x - mu)^2), its output
// rounded to bf16; h = ln W1^T with f32 accumulation plus the f32 b1; exact
// GELU in f32 with the TPU kernel's polynomial erf (within 1.5e-7 of erf);
// a rounded to bf16; y = bf16(x32 + (a W2^T + b2)). Weights are bf16 in the
// (out, in) layout: W1 (hidden, C), W2 (C, hidden).
//
// Bound on an H100 SXM: at the ViT-S training shape (50,112 rows, 384 ->
// 1536 -> 384) the call does 118.2 GFLOP against 77 MB of x, y and weights,
// so the tensor cores bound it (0.120 ms at 989 TFLOP/s).
//
// Two launches in order on the caller's stream, both on the wgmma + TMA GEMM
// core (gemm_sm90.cuh):
//   1. fused_mlp_fwd_fc1: the row-block core gemm_rows with the two-pass
//      LayerNorm prologue (once per row block and column group, the x block
//      held whole in shared memory) and the BiasGelu epilogue:
//      a = bf16(gelu(ln W1^T + b1)), (M, hidden), leaving by TMA stores;
//   2. fused_mlp_fwd_fc2: the streaming core (A tiles of a ride in the ring
//      beside the W2 tiles, so K = hidden is unbounded; three column tiles
//      of y per pass, so each tile of a is read once at C = 384) with the
//      ResidualOut epilogue: y = bf16(x + (a W2^T + b2)).
// a goes to device memory and is read back (154 MB at the training shape), so
// the two launches' own bounds sum to more than the fused bound: 0.0598 +
// 0.0693 ms there (utils.roofline.fused_mlp_fwd_parts_work). A single launch
// that keeps a on chip would hold the 64 x C f32 fc2 accumulator of a row
// block across every hidden tile: 192 registers a thread at C = 384 for one
// warpgroup, impossible at 1408 (PERF.md, open questions).
// C a multiple of 8 and at most MAX_K (1408, the x block fc1 holds whole);
// hidden a multiple of 8; any M. No atomics: the same inputs give the same
// bits on every run.

#include "gemm_sm90.cuh"

namespace {

using dinox_gemm::BiasGelu;
using dinox_gemm::Layout;
using dinox_gemm::LayerNormTwoPass;
using dinox_gemm::ResidualOut;
using dinox_gemm::WForm;

template <int WGS>
__global__ void __launch_bounds__(Layout<WGS>::THREADS, 1)
fused_mlp_fwd_fc1(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
                  const __grid_constant__ CUtensorMap map_a, const LayerNormTwoPass pro,
                  const BiasGelu epi, int m, int k, int nout, int stages, int tiles_per_cta) {
  dinox_gemm::gemm_rows<WGS>(&map_x, &map_w1, &map_a, pro, epi, m, k, nout, stages, tiles_per_cta);
}

// fc2 covers 3 column tiles of y (C = 384) per pass over a's tiles: 3 x 64
// accumulator floats a consumer thread.
constexpr int FC2_TILES = 3;
using Fc2 = dinox_gemm::StreamLayout<2, 1, ResidualOut::C_TILES, ResidualOut::SCRATCH, FC2_TILES>;

__global__ void __launch_bounds__(Fc2::THREADS, 1)
fused_mlp_fwd_fc2(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w2,
                  const ResidualOut epi, int m, int k, int nout, int stages, int tiles_per_cta) {
  dinox_gemm::gemm_stream<2, WForm::KMajor, WForm::KMajor, FC2_TILES>(
      &map_a, &map_w2, &map_a, &map_w2, nullptr, nullptr, epi, m, k, nout, stages, tiles_per_cta);
}

// Two consumer warpgroups (128-row blocks) where fc1's x block fits beside
// two W stages, else one.
bool wide(int c) { return Layout<2>::stages(c) >= 2; }

bool takes(int c, int hidden) {
  return c > 0 && c % 8 == 0 && c <= dinox_gemm::MAX_K && hidden > 0 && hidden % 8 == 0;
}

template <int WGS>
cudaError_t fc1(const void* x, const void* gamma, const void* beta, const void* w1, const void* b1,
                void* a, int m, int c, int hidden, cudaStream_t s) {
  return dinox_gemm::launch_gemm<WGS>(
      fused_mlp_fwd_fc1<WGS>, x, w1, m, c, hidden,
      LayerNormTwoPass{static_cast<const float*>(gamma), static_cast<const float*>(beta)},
      BiasGelu{static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(a)}, s);
}

}  // namespace

// Launch 1. x: (m, c) bf16; gamma, beta: (c,) f32; w1: (hidden, c) bf16; b1:
// (hidden,) f32; a: (m, hidden) bf16 out. All contiguous and 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int dinox_fused_mlp_fwd_fc1_bf16(const void* x, const void* gamma, const void* beta,
                                            const void* w1, const void* b1, void* a, int m, int c,
                                            int hidden, void* stream) {
  if (!takes(c, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wide(c) ? fc1<2>(x, gamma, beta, w1, b1, a, m, c, hidden, s)
                                  : fc1<1>(x, gamma, beta, w1, b1, a, m, c, hidden, s));
}

// Launch 2. a: (m, hidden) bf16; x: (m, c) bf16, the residual; w2: (c,
// hidden) bf16; b2: (c,) f32; y: (m, c) bf16 out. Returns the launch's
// cudaError_t.
extern "C" int dinox_fused_mlp_fwd_fc2_bf16(const void* a, const void* x, const void* w2,
                                            const void* b2, void* y, int m, int c, int hidden,
                                            void* stream) {
  if (!takes(c, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  dinox_gemm::Grid g;
  cudaError_t err = dinox_gemm::stream_grid<Fc2>(fused_mlp_fwd_fc2, m, c, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_w;
  if ((err = dinox_gemm::encode_rows_map(&map_a, a, m, hidden, Fc2::BM)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_w, w2, c, hidden, dinox_gemm::BN)) != cudaSuccess)
    return static_cast<int>(err);
  fused_mlp_fwd_fc2<<<dim3(g.rows, g.groups), Fc2::THREADS, g.smem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_w,
      ResidualOut{static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(x),
                  static_cast<__nv_bfloat16*>(y)},
      m, hidden, c, g.stages, g.per_cta);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of launch `part` (0: fc1, 1: fc2) at width c. Returns a
// cudaError_t.
extern "C" int dinox_fused_mlp_fwd_occupancy(int part, int c, int* regs, int* smem, int* ctas) {
  if (!takes(c, 8)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (part == 0)
    err = wide(c) ? dinox_gemm::gemm_occupancy<2>(fused_mlp_fwd_fc1<2>, c, regs, smem, ctas)
                  : dinox_gemm::gemm_occupancy<1>(fused_mlp_fwd_fc1<1>, c, regs, smem, ctas);
  else
    err = dinox_gemm::occupancy(fused_mlp_fwd_fc2, Fc2::THREADS, Fc2::dynamic(Fc2::stages()), regs,
                                smem, ctas);
  return static_cast<int>(err);
}
