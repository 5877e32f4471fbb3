// Fused attention half-block for Hopper (sm_90a):
//   y = x + proj(attention(qkv(LN(x)))), also emitting qkv and the attention
//   output for the backward.
//
// Replaces the TPU kernel `_fused_kernel` (dinox_tpu/ops/fused_attn_block.py,
// reached through `_call_fused` / `fused_attn_block`). Same function and
// rounding points: LayerNorm statistics in f32 with the fast variance
// E[x^2] - E[x]^2 clipped at 0, ln rounded to bf16; qkv = bf16(ln Wqkv^T +
// bqkv) with the f32 bias added to the f32 accumulator; attention as the
// packed forward (attention_tile.cuh: scale folded into q, f32 logits, bf16
// exp before PV, division after PV); y = bf16(x32 + (attn Wproj^T + bproj)),
// bias and residual in f32. Weights are bf16 in the (out, in) layout: Wqkv
// (3*dim, dim), Wproj (dim, dim).
//
// Bound on an H100 SXM: at the ViT-S training shape (192 views, N=261,
// dim 384, 6 heads) the call does 79.2 GFLOP (the two projections and the two
// attention products) and must move 232 MB (x in; y, qkv and attn out; the
// weights), so the tensor cores bound it: 0.080 ms at 989 TFLOP/s against
// 0.069 ms at 3.35 TB/s. At the serving shape (32 views) 13.2 GFLOP, 0.013 ms.
//
// The dependency: a query row's attention needs the keys and values of every
// row of its view, so the TPU kernel's single pass per batch group becomes
// three phases per view, in one launch:
//   1. LN -> qkv = bf16(ln Wqkv^T + bqkv), tile by (64 rows, 128 columns);
//   2. attention for each (head, 64-query tile), reading qkv back;
//   3. y = bf16(x32 + attn Wproj^T + bproj), tile by (64 rows, 128 columns).
// A thread block cluster of 8 CTAs owns one view: its CTAs share the tiles of
// each phase round-robin, and a cluster barrier (release/acquire at cluster
// scope) separates the phases, so qkv and attn written by one CTA are seen by
// the others. A view's qkv (601 KB at ViT-S) is written and read back while it
// sits in the 50 MB L2. The weights stream from global memory in 128 x 64
// tiles, so any width works (ViT-G's bf16 Wqkv is 11.9 MB). What the design
// does not do yet (later work): wgmma, TMA, a pipelined tile ring, and keeping
// x/ln tiles on chip between phases 1 and 3.
//
// 4 warps per CTA. Projection tiles: the 64 x 128 f32 accumulator is split
// 2 x 2 over the warps (32 x 64, eight 16x16 wmma fragments each), depth
// steps of 64 staged in shared memory; LN is applied while the x tile is
// staged. Head dims 32, 64 and 88; dim a multiple of 8; any N.

#include <cooperative_groups.h>

#include "attention_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nvcuda;
using dinox_attn::round128;

constexpr int CLUSTER = 8;  // CTAs per view
constexpr int THREADS = dinox_attn::THREADS;
constexpr int TM = 64;       // rows of a projection tile
constexpr int TN = 128;      // columns of a projection tile
constexpr int TK = 64;       // depth step
constexpr int LDA = TK + 8;  // bf16 pitch of the staged A (x or attn) tile
constexpr int LDW = TK + 8;  // bf16 pitch of the staged weight tile
constexpr int LDC = TN + 4;  // f32 pitch of the accumulator staging tile
constexpr float LN_EPS = 1e-5f;

constexpr size_t A_OFF = 0;
constexpr size_t W_OFF = A_OFF + round128(sizeof(__nv_bfloat16) * TM * LDA);
constexpr size_t C_OFF = W_OFF + round128(sizeof(__nv_bfloat16) * TN * LDW);
constexpr size_t STAT_OFF = C_OFF + round128(sizeof(float) * TM * LDC);
constexpr size_t GEMM_SMEM = STAT_OFF + round128(sizeof(float) * 2 * TM);

template <int HD>
constexpr size_t smem_bytes() {
  return dinox_attn::Layout<HD>::SMEM > GEMM_SMEM ? dinox_attn::Layout<HD>::SMEM : GEMM_SMEM;
}

// Row mean and 1/std (fast variance) of rows [r0, r0 + TM) of x (pitch dim)
// into s_stat[0..TM) and s_stat[TM..2*TM); rows past `rows` get 0.
__device__ __forceinline__ void ln_stats(const __nv_bfloat16* __restrict__ x, int rows,
                                         int dim, float* s_stat) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TM; r += THREADS / 32) {
    float s = 0.f, ss = 0.f;
    if (r < rows) {
      const __nv_bfloat16* row = x + (long long)r * dim;
      for (int k = lane; k < dim; k += 32) {
        const float v = __bfloat162float(row[k]);
        s += v;
        ss += v * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (lane == 0) {
      const float mu = s / dim;
      const float var = fmaxf(ss / dim - mu * mu, 0.f);
      s_stat[r] = r < rows ? mu : 0.f;
      s_stat[TM + r] = r < rows ? rsqrtf(var + LN_EPS) : 0.f;
    }
  }
}

// acc (TM x TN, f32, left in sC) = A[r, :] . W[c, :] for rows r < `rows` of A
// (pitch dim) and rows c < `cols` of W (pitch dim). With LN, A is x and each
// element is normalised on the way in: bf16(((x - mu) * rstd) * gamma + beta).
template <bool LN>
__device__ __forceinline__ void project_tile(const __nv_bfloat16* __restrict__ a, int rows,
                                             const __nv_bfloat16* __restrict__ w, int cols,
                                             int dim, const float* __restrict__ gamma,
                                             const float* __restrict__ beta,
                                             unsigned char* smem) {
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + A_OFF);
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem + W_OFF);
  float* sC = reinterpret_cast<float*>(smem + C_OFF);
  const float* s_stat = reinterpret_cast<const float*>(smem + STAT_OFF);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 32-row, 64-column quarter of the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < dim; k0 += TK) {
    __syncthreads();  // every warp is done with the previous tiles (and the statistics are in)
    for (int i = tid; i < TM * (TK / 8); i += THREADS) {
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && k0 + c < dim) {
        v = *reinterpret_cast<const uint4*>(a + (long long)r * dim + k0 + c);
        if (LN) {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
          const float mu = s_stat[r], rstd = s_stat[TM + r];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = __float2bfloat16((__bfloat162float(e[j]) - mu) * rstd * gamma[k0 + c + j] +
                                    beta[k0 + c + j]);
        }
      }
      *reinterpret_cast<uint4*>(sA + r * LDA + c) = v;
    }
    for (int i = tid; i < TN * (TK / 8); i += THREADS) {
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < cols && k0 + c < dim)
        v = *reinterpret_cast<const uint4*>(w + (long long)r * dim + k0 + c);
      *reinterpret_cast<uint4*>(sW + r * LDW + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 32 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, sW + (wn * 64 + j * 16) * LDW + kk * 16, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fused_attn_block_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const __nv_bfloat16* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const __nv_bfloat16* __restrict__ wproj,
                        const float* __restrict__ bproj, __nv_bfloat16* __restrict__ y,
                        __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ attn, int n,
                        int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int view = blockIdx.x / CLUSTER;
  const int dim = heads * HD;
  const int td = 3 * dim;
  const int tid = threadIdx.x;
  const int row_tiles = (n + TM - 1) / TM;
  const __nv_bfloat16* xv = x + (long long)view * n * dim;
  __nv_bfloat16* qkv_v = qkv + (long long)view * n * td;
  __nv_bfloat16* attn_v = attn + (long long)view * n * dim;
  __nv_bfloat16* y_v = y + (long long)view * n * dim;
  const float* sC = reinterpret_cast<const float*>(smem + C_OFF);
  float* s_stat = reinterpret_cast<float*>(smem + STAT_OFF);

  // Phase 1: LN -> qkv.
  const int qkv_tiles = (td + TN - 1) / TN;
  for (int t = rank; t < row_tiles * qkv_tiles; t += CLUSTER) {
    const int r0 = (t / qkv_tiles) * TM, c0 = (t % qkv_tiles) * TN;
    const int rows = min(TM, n - r0), cols = min(TN, td - c0);
    ln_stats(xv + (long long)r0 * dim, rows, dim, s_stat);
    project_tile<true>(xv + (long long)r0 * dim, rows, wqkv + (long long)c0 * dim, cols, dim,
                       gamma, beta, smem);
    for (int i = tid; i < rows * (TN / 8); i += THREADS) {
      const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
      if (c >= cols) continue;
      uint4 v;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(sC[r * LDC + c + j] + bqkv[c0 + c + j]);
      *reinterpret_cast<uint4*>(qkv_v + (long long)(r0 + r) * td + c0 + c) = v;
    }
  }
  cluster.sync();  // every CTA of the view has written its qkv tiles

  // Phase 2: attention for each (head, query tile).
  for (int t = rank; t < heads * row_tiles; t += CLUSTER) {
    const int h = t / row_tiles, q0 = (t % row_tiles) * TM;
    dinox_attn::attention_tile<HD>(qkv_v + h * HD, attn_v + h * HD, n, dim, q0, scale, smem);
  }
  cluster.sync();  // every CTA of the view has written its attention tiles

  // Phase 3: y = x + attn Wproj^T + bproj.
  const int proj_tiles = (dim + TN - 1) / TN;
  for (int t = rank; t < row_tiles * proj_tiles; t += CLUSTER) {
    const int r0 = (t / proj_tiles) * TM, c0 = (t % proj_tiles) * TN;
    const int rows = min(TM, n - r0), cols = min(TN, dim - c0);
    project_tile<false>(attn_v + (long long)r0 * dim, rows, wproj + (long long)c0 * dim, cols,
                        dim, nullptr, nullptr, smem);
    for (int i = tid; i < rows * (TN / 8); i += THREADS) {
      const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
      if (c >= cols) continue;
      const long long off = (long long)(r0 + r) * dim + c0 + c;
      uint4 xin = *reinterpret_cast<const uint4*>(xv + off);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xin);
      uint4 v;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(xe[j]) + (sC[r * LDC + c + j] + bproj[c0 + c + j]));
      *reinterpret_cast<uint4*>(y_v + off) = v;
    }
  }
}

template <int HD>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* wqkv,
                   const void* bqkv, const void* wproj, const void* bproj, void* y, void* qkv,
                   void* attn, int b, int n, int heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(fused_attn_block_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(b * CLUSTER);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, fused_attn_block_kernel<HD>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const __nv_bfloat16*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const __nv_bfloat16*>(wproj), static_cast<const float*>(bproj),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), n, heads, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x: (b, n, dim) bf16; gamma, beta: (dim,) f32; wqkv: (3*dim, dim) bf16;
// bqkv: (3*dim,) f32; wproj: (dim, dim) bf16; bproj: (dim,) f32; outputs y:
// (b, n, dim), qkv: (b, n, 3*dim), attn: (b, n, dim), bf16. All contiguous and
// 16-byte aligned; dim = heads * hd. Returns the cudaError_t of the launch.
extern "C" int dinox_fused_attn_block_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                               const void* wqkv, const void* bqkv,
                                               const void* wproj, const void* bproj, void* y,
                                               void* qkv, void* attn, int b, int n, int heads,
                                               int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch<32>(x, gamma, beta, wqkv, bqkv, wproj, bproj, y, qkv, attn,
                                         b, n, heads, scale, s));
    case 64:
      return static_cast<int>(launch<64>(x, gamma, beta, wqkv, bqkv, wproj, bproj, y, qkv, attn,
                                         b, n, heads, scale, s));
    case 88:
      return static_cast<int>(launch<88>(x, gamma, beta, wqkv, bqkv, wproj, bproj, y, qkv, attn,
                                         b, n, heads, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
