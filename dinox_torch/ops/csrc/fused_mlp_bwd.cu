// Fused transformer-MLP half-block backward for Hopper (sm_90a): three
// kernels, rows, weights and reduce.
//
// Replaces the TPU kernel `_bwd_kernel` (dinox_tpu/ops/fused_mlp.py, reached
// through `_bwd` / the VJP of `fused_mlp_block`). Same function and rounding
// points, for rows x (m, C) and the output gradient dy (m, C), bf16:
//   ln, xhat, rstd = two-pass f32 LayerNorm(x); lnb = bf16(ln)
//   h  = lnb W1^T + b1 (f32);  ab = bf16(GELU(h))
//   da = dyb W2 (f32);  dh = da * GELU'(h);  dhb = bf16(dh)
//   dln = dhb W1 (f32);  dx = bf16(dy + rstd (dxh - mean(dxh) - xhat mean(dxh xhat))),
//     dxh = dln * gamma
//   dW2 = dyb^T ab, dW1 = dhb^T lnb, db2 = sum dy, db1 = sum dh,
//   dgamma = sum dln xhat, dbeta = sum dln   (f32, over all rows)
// with W1 (hidden, C) and W2 (C, hidden) bf16 in the (out, in) layout and the
// weight gradients in the same layout.
//
// The trap: the TPU kernel adds the parameter gradients into constant-index
// output blocks across its grid, which is safe only because a TPU grid runs
// in order. Here CTAs run at once, and a partial of dW1 + dW2 per CTA would be
// 4.7 MB. So the work is split into three launches, with no float atomics and
// a fixed order of every sum (the same bits run to run):
//   rows:    one CTA of 8 warps per block of R rows (R = 32 up to C = 768,
//            16 above) recomputes LN, fc1 and GELU chunk by chunk (128 hidden
//            columns), forms da, dh and dhb, keeps dln in registers across the
//            chunks, writes dx, the bf16 lnb, ab and dhb (the values the TPU
//            kernel feeds its matrix unit), and the block's partial sums of
//            dgamma, dbeta, db2 and db1;
//   weights: dW2 = dyb^T ab and dW1 = dhb^T lnb as tiled products (64 x 128
//            output tiles, 4 warps) over `chunks` row ranges, one f32 partial
//            per range;
//   reduce:  adds the ranges' partials and the row blocks' partials in order.
//
// Bound on an H100 SXM at the ViT-S training shape (50,112 rows, 384 ->
// 1536 -> 384): 295.6 GFLOP (recomputed fc1, da, dW2, dW1, dln), so the
// tensor cores bound it (0.299 ms at 989 TFLOP/s). Writing and reading lnb,
// ab and dhb costs ~0.66 GB of device traffic (0.2 ms at 3.35 TB/s), under
// that bound; the workspace is ~0.4 GB at that shape. What the design does not
// do yet (later work): wgmma, TMA-staged weight tiles, larger row blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HC = 128;       // hidden chunk: 16 columns per warp
constexpr int LDH = HC + 4;   // f32 pitch of the h and da staging tiles
constexpr int LDD = HC + 8;   // bf16 pitch of the dhb tile
constexpr float LN_EPS = 1e-5f;
constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

template <int C>
struct Shape {
  static constexpr int R = C <= 768 ? 32 : 16;  // rows per CTA
  static constexpr int FR = R / 16;              // row fragments
  static constexpr int FC = C / (WARPS * 16);    // dln column fragments per warp
  static constexpr int LDL = C + 8;              // bf16 pitch of the lnb and dyb tiles
  static constexpr int LDO = C + 4;              // f32 pitch of the dln staging tile
  static constexpr size_t LN_OFF = 0;
  static constexpr size_t DY_OFF = LN_OFF + round128(sizeof(__nv_bfloat16) * R * LDL);
  static constexpr size_t H_OFF = DY_OFF + round128(sizeof(__nv_bfloat16) * R * LDL);
  static constexpr size_t DA_OFF = H_OFF + round128(sizeof(float) * R * LDH);
  static constexpr size_t DH_OFF = DA_OFF + round128(sizeof(float) * R * LDH);
  static constexpr size_t STAT_OFF = DH_OFF + round128(sizeof(__nv_bfloat16) * R * LDD);
  static constexpr size_t SMEM = STAT_OFF + round128(sizeof(float) * 2 * R);
  // The dln staging tile aliases the lnb and dyb tiles once the chunks are done.
  static constexpr size_t O_OFF = LN_OFF;
  static_assert(sizeof(float) * R * LDO <= H_OFF - LN_OFF, "dln staging does not fit");
  static_assert(C % (WARPS * 16) == 0, "C must be a multiple of 128");
};

template <int C>
__global__ void __launch_bounds__(THREADS)
fused_mlp_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
                          const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                          const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* __restrict__ dx,
                          __nv_bfloat16* __restrict__ lnb, __nv_bfloat16* __restrict__ ab,
                          __nv_bfloat16* __restrict__ dhb, float* __restrict__ part, int m,
                          int hidden) {
  using S = Shape<C>;
  constexpr int R = S::R;
  constexpr int PER_LANE = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sLn = reinterpret_cast<__nv_bfloat16*>(smem + S::LN_OFF);
  __nv_bfloat16* sDy = reinterpret_cast<__nv_bfloat16*>(smem + S::DY_OFF);
  float* sH = reinterpret_cast<float*>(smem + S::H_OFF);
  float* sDa = reinterpret_cast<float*>(smem + S::DA_OFF);
  __nv_bfloat16* sDh = reinterpret_cast<__nv_bfloat16*>(smem + S::DH_OFF);
  float* sMu = reinterpret_cast<float*>(smem + S::STAT_OFF);
  float* sRstd = sMu + R;
  float* sO = reinterpret_cast<float*>(smem + S::O_OFF);

  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long part_pitch = 3LL * C + hidden;
  float* my_part = part + blockIdx.x * part_pitch;

  // LayerNorm (two-pass f32) of the block's rows: lnb into shared memory and
  // to global memory for the weight gradients, dyb into shared memory; rows
  // past m are zero.
  for (int r = warp; r < R; r += WARPS) {
    __nv_bfloat16* dst = sLn + r * S::LDL;
    __nv_bfloat16* dyd = sDy + r * S::LDL;
    if (r0 + r >= m) {
      for (int k = lane; k < C; k += 32) {
        dst[k] = __float2bfloat16(0.f);
        dyd[k] = __float2bfloat16(0.f);
      }
      if (lane == 0) sMu[r] = sRstd[r] = 0.f;
      continue;
    }
    const long long row = (long long)(r0 + r) * C;
    float v[PER_LANE];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      v[i] = __bfloat162float(x[row + lane + 32 * i]);
      s += v[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / C;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) ss += (v[i] - mu) * (v[i] - mu);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rstd = rsqrtf(ss / C + LN_EPS);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int k = lane + 32 * i;
      const __nv_bfloat16 l = __float2bfloat16((v[i] - mu) * rstd * gamma[k] + beta[k]);
      dst[k] = l;
      lnb[row + k] = l;
      dyd[k] = dy[row + k];
    }
    if (lane == 0) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dln[S::FR][S::FC];
#pragma unroll
  for (int i = 0; i < S::FR; ++i)
#pragma unroll
    for (int f = 0; f < S::FC; ++f) wmma::fill_fragment(dln[i][f], 0.f);
  const int c_warp = warp * (C / WARPS);  // this warp's dln columns

  for (int j0 = 0; j0 < hidden; j0 += HC) {
    const int jw = j0 + warp * 16;  // this warp's 16 hidden columns
    // h = lnb W1^T and da = dyb W2 for those columns, f32 accumulation.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hf[S::FR], daf[S::FR];
#pragma unroll
    for (int i = 0; i < S::FR; ++i) {
      wmma::fill_fragment(hf[i], 0.f);
      wmma::fill_fragment(daf[i], 0.f);
    }
#pragma unroll 2
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fw1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fw2;
      wmma::load_matrix_sync(fw1, w1 + (long long)jw * C + k, C);
      wmma::load_matrix_sync(fw2, w2 + (long long)k * hidden + jw, hidden);
#pragma unroll
      for (int i = 0; i < S::FR; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sLn + i * 16 * S::LDL + k, S::LDL);
        wmma::mma_sync(hf[i], fa, fw1, hf[i]);
        wmma::load_matrix_sync(fa, sDy + i * 16 * S::LDL + k, S::LDL);
        wmma::mma_sync(daf[i], fa, fw2, daf[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < S::FR; ++i) {
      wmma::store_matrix_sync(sH + i * 16 * LDH + warp * 16, hf[i], LDH, wmma::mem_row_major);
      wmma::store_matrix_sync(sDa + i * 16 * LDH + warp * 16, daf[i], LDH, wmma::mem_row_major);
    }
    __syncthreads();  // h and da complete; every warp is done reading the previous dhb

    // One thread per hidden column walks the rows in order: ab, dh, dhb and
    // the block's db1 partial.
    if (tid < HC) {
      const int j = tid;
      const float bj = b1[j0 + j];
      float db1 = 0.f;
      for (int r = 0; r < R; ++r) {
        float dh = 0.f;
        if (r0 + r < m) {
          const float hv = sH[r * LDH + j] + bj;
          const float cdf = 0.5f * (1.f + erff(hv * SQRT_HALF));
          const long long off = (long long)(r0 + r) * hidden + j0 + j;
          ab[off] = __float2bfloat16(hv * cdf);
          dh = sDa[r * LDH + j] * (cdf + hv * expf(-0.5f * hv * hv) * INV_SQRT_2PI);
          dhb[off] = __float2bfloat16(dh);
          db1 += dh;
        }
        sDh[r * LDD + j] = __float2bfloat16(dh);
      }
      my_part[3 * C + j0 + j] = db1;
    }
    __syncthreads();

    // dln[:, this warp's columns] += dhb W1[chunk, :].
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[S::FR];
#pragma unroll
      for (int i = 0; i < S::FR; ++i)
        wmma::load_matrix_sync(fa[i], sDh + i * 16 * LDD + kk * 16, LDD);
#pragma unroll
      for (int f = 0; f < S::FC; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, w1 + (long long)(j0 + kk * 16) * C + c_warp + f * 16, C);
#pragma unroll
        for (int i = 0; i < S::FR; ++i) wmma::mma_sync(dln[i][f], fa[i], fb, dln[i][f]);
      }
    }
  }

  __syncthreads();  // the lnb and dyb tiles are dead: the dln staging tile may alias them
#pragma unroll
  for (int i = 0; i < S::FR; ++i)
#pragma unroll
    for (int f = 0; f < S::FC; ++f)
      wmma::store_matrix_sync(sO + i * 16 * S::LDO + c_warp + f * 16, dln[i][f], S::LDO,
                              wmma::mem_row_major);
  __syncthreads();

  // LayerNorm backward, one warp per row: dx = bf16(dy + rstd (dxh -
  // mean(dxh) - xhat mean(dxh xhat))).
  for (int r = warp; r < R; r += WARPS) {
    if (r0 + r >= m) continue;
    const long long row = (long long)(r0 + r) * C;
    const float mu = sMu[r], rstd = sRstd[r];
    float xh[PER_LANE], dxh[PER_LANE];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int k = lane + 32 * i;
      xh[i] = (__bfloat162float(x[row + k]) - mu) * rstd;
      dxh[i] = sO[r * S::LDO + k] * gamma[k];
      s1 += dxh[i];
      s2 += dxh[i] * xh[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean1 = s1 / C, mean2 = s2 / C;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int k = lane + 32 * i;
      dx[row + k] = __float2bfloat16(__bfloat162float(dy[row + k]) +
                                     rstd * (dxh[i] - mean1 - xh[i] * mean2));
    }
  }

  // The block's partial sums of dgamma, dbeta and db2, one thread per column
  // walking the rows in order.
  for (int c = tid; c < C; c += THREADS) {
    float dg = 0.f, db = 0.f, d2 = 0.f;
    for (int r = 0; r < R && r0 + r < m; ++r) {
      const long long off = (long long)(r0 + r) * C + c;
      const float d = sO[r * S::LDO + c];
      dg += d * ((__bfloat162float(x[off]) - sMu[r]) * sRstd[r]);
      db += d;
      d2 += __bfloat162float(dy[off]);
    }
    my_part[c] = dg;
    my_part[C + c] = db;
    my_part[2 * C + c] = d2;
  }
}

// Weight gradients: out[s] (mo x no, f32, row-major) = sum over the rows of
// range s of P[r, :]^T Q[r, :], for P (m x mo) and Q (m x no) bf16. blockIdx.x
// picks a 64 x 128 tile of dW2 = dyb^T ab (mo = C, no = hidden) or, past
// those, of dW1 = dhb^T lnb (mo = hidden, no = C); blockIdx.y the row range.
constexpr int WM = 64, WN = 128, WK = 32;
constexpr int LDP = WM + 8, LDQ = WN + 8;
constexpr int WTHREADS = 128;

__global__ void __launch_bounds__(WTHREADS)
fused_mlp_bwd_weights_kernel(const __nv_bfloat16* __restrict__ dy,
                             const __nv_bfloat16* __restrict__ ab,
                             const __nv_bfloat16* __restrict__ dhb,
                             const __nv_bfloat16* __restrict__ lnb, float* __restrict__ wpart,
                             int m, int c, int hidden, int rows_per_range) {
  __shared__ __align__(128) __nv_bfloat16 sP[WK * LDP];
  __shared__ __align__(128) __nv_bfloat16 sQ[WK * LDQ];
  const int tiles = (c / WM) * (hidden / WN);  // tiles of each product (c*hidden / 8192)
  const bool first = blockIdx.x < tiles;
  const int t = first ? blockIdx.x : blockIdx.x - tiles;
  const int mo = first ? c : hidden, no = first ? hidden : c;
  const __nv_bfloat16* p = first ? dy : dhb;
  const __nv_bfloat16* q = first ? ab : lnb;
  const int m0 = (t / (no / WN)) * WM, n0 = (t % (no / WN)) * WN;
  const int k_begin = blockIdx.y * rows_per_range;
  const int k_end = min(m, k_begin + rows_per_range);
  float* out = wpart + (long long)blockIdx.y * 2 * c * hidden + (first ? 0 : (long long)c * hidden);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 32 x 64 quarter of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += WK) {
    __syncthreads();
    for (int i = tid; i < WK * (WM / 8); i += WTHREADS) {
      const int r = i / (WM / 8), col = (i % (WM / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k_end) v = *reinterpret_cast<const uint4*>(p + (long long)(k0 + r) * mo + m0 + col);
      *reinterpret_cast<uint4*>(sP + r * LDP + col) = v;
    }
    for (int i = tid; i < WK * (WN / 8); i += WTHREADS) {
      const int r = i / (WN / 8), col = (i % (WN / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k_end) v = *reinterpret_cast<const uint4*>(q + (long long)(k0 + r) * no + n0 + col);
      *reinterpret_cast<uint4*>(sQ + r * LDQ + col) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sP + kk * 16 * LDP + wm * 32 + i * 16, LDP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sQ + kk * 16 * LDQ + wn * 64 + j * 16, LDQ);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + (long long)(m0 + wm * 32 + i * 16) * no + n0 + wn * 64 + j * 16,
                              acc[i][j], no, wmma::mem_row_major);
}

// out[i] = sum over ranges of wpart[s][i] for the 2*c*hidden weight
// gradients, then sum over row blocks of part[b][j] for the 3*c + hidden
// vector gradients, each in index order.
__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ wpart,
                                            const float* __restrict__ part,
                                            float* __restrict__ out, int ranges, int blocks,
                                            long long weights, int vectors) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < weights) {
    float s = 0.f;
    for (int r = 0; r < ranges; ++r) s += wpart[r * weights + i];
    out[i] = s;
  } else if (i < weights + vectors) {
    const long long j = i - weights;
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) s += part[b * (long long)vectors + j];
    out[i] = s;
  }
}

template <int C>
cudaError_t launch_rows(const void* x, const void* gamma, const void* beta, const void* w1,
                        const void* b1, const void* w2, const void* dy, void* dx, void* lnb,
                        void* ab, void* dhb, void* part, int m, int hidden, cudaStream_t stream) {
  using S = Shape<C>;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_rows_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + S::R - 1) / S::R);
  fused_mlp_bwd_rows_kernel<C><<<grid, THREADS, S::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(lnb), static_cast<__nv_bfloat16*>(ab),
      static_cast<__nv_bfloat16*>(dhb), static_cast<float*>(part), m, hidden);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx, lnb: (m, c) bf16; ab, dhb: (m, hidden) bf16; gamma, beta: (c,)
// f32; w1: (hidden, c) bf16; b1: (hidden,) f32; w2: (c, hidden) bf16; part:
// (ceil(m / R), 3*c + hidden) f32 with R = 32 for c <= 768, else 16. All
// contiguous and 32-byte aligned; c one of 384, 768, 1024, 1408; hidden a
// multiple of 128. Returns the cudaError_t of the launch.
extern "C" int dinox_fused_mlp_bwd_rows_bf16(const void* x, const void* gamma, const void* beta,
                                             const void* w1, const void* b1, const void* w2,
                                             const void* dy, void* dx, void* lnb, void* ab,
                                             void* dhb, void* part, int m, int c, int hidden,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden % 128) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 384:
      return static_cast<int>(launch_rows<384>(x, gamma, beta, w1, b1, w2, dy, dx, lnb, ab, dhb,
                                               part, m, hidden, s));
    case 768:
      return static_cast<int>(launch_rows<768>(x, gamma, beta, w1, b1, w2, dy, dx, lnb, ab, dhb,
                                               part, m, hidden, s));
    case 1024:
      return static_cast<int>(launch_rows<1024>(x, gamma, beta, w1, b1, w2, dy, dx, lnb, ab, dhb,
                                                part, m, hidden, s));
    case 1408:
      return static_cast<int>(launch_rows<1408>(x, gamma, beta, w1, b1, w2, dy, dx, lnb, ab, dhb,
                                                part, m, hidden, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// wpart: (chunks, 2*c*hidden) f32, each range's dW2 (c, hidden) then dW1
// (hidden, c). c a multiple of 64 and of 128 for dW1's columns; hidden a
// multiple of 128. Rows split into `chunks` ranges of a multiple of 32 rows.
extern "C" int dinox_fused_mlp_bwd_weights_bf16(const void* dy, const void* ab, const void* dhb,
                                                const void* lnb, void* wpart, int m, int c,
                                                int hidden, int chunks, void* stream) {
  if (c % 128 || hidden % 128 || chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_range = ((m + chunks - 1) / chunks + WK - 1) / WK * WK;
  const dim3 grid(2 * (c / WM) * (hidden / WN), chunks);
  fused_mlp_bwd_weights_kernel<<<grid, WTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(ab),
      static_cast<const __nv_bfloat16*>(dhb), static_cast<const __nv_bfloat16*>(lnb),
      static_cast<float*>(wpart), m, c, hidden, rows_per_range);
  return static_cast<int>(cudaGetLastError());
}

// out: (2*c*hidden + 3*c + hidden) f32 = [dW2 | dW1 | dgamma | dbeta | db2 | db1]
// from wpart (chunks, 2*c*hidden) and part (blocks, 3*c + hidden).
extern "C" int dinox_fused_mlp_bwd_reduce(const void* wpart, const void* part, void* out,
                                          int chunks, int blocks, int c, int hidden,
                                          void* stream) {
  const long long weights = 2LL * c * hidden;
  const int vectors = 3 * c + hidden;
  const long long total = weights + vectors;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((total + threads - 1) / threads));
  fused_mlp_bwd_reduce_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wpart), static_cast<const float*>(part),
      static_cast<float*>(out), chunks, blocks, weights, vectors);
  return static_cast<int>(cudaGetLastError());
}
