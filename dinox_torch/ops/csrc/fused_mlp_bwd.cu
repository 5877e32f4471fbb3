// Fused transformer-MLP half-block backward for Hopper (sm_90a): six
// launches, norm, hidden, dln, dx, weights and reduce.
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
// in order. Here CTAs run at once, so the sums over rows become per-block
// and per-chunk partials that a last launch adds in a fixed order: no float
// atomics, the same bits run to run. The launches, in order on the caller's
// stream (the matrix products on the wgmma + TMA cores of gemm_sm90.cuh):
//   norm:    one warp per row: the two-pass LayerNorm, lnb = bf16(ln);
//   hidden:  the streaming core with two products over the same K = C and
//            hidden tile, h = lnb W1^T (W1 K-major) and da = dyb W2 (W2 read
//            MN-major, as stored), into two accumulators in each of two
//            consumer warpgroups (128-row blocks, so every W tile read from
//            L2 serves 128 rows); the producer is a whole warpgroup that
//            hands its registers to them (setmaxnreg). Its GeluPair epilogue
//            writes ab and dhb by TMA stores and each 64-row block's column
//            sums of dh (db1), rows past m masked to 0;
//   dln:     the streaming core, dln = dhb W1 (W1 MN-major, K = hidden), f32,
//            three column tiles per pass over dhb's tiles (C = 384 in one);
//   dx:      one warp per row: the two-pass statistics recomputed from x, dx,
//            and each 64-row block's column sums of dln xhat, dln and dy
//            (dgamma, dbeta, db2), each warp's kept in registers over its
//            rows and the eight warps' added in order;
//   weights: the weight-gradient core, dW2 = dyb^T ab and dW1 = dhb^T lnb
//            (both operands MN-major) in 128 x 256 and 256 x 128 tiles,
//            split over row chunks chosen to fill the SMs, one f32 partial
//            per chunk;
//   reduce:  the chunks' partials added in chunk order, and the 64-row
//            blocks' partials in eight interleaved runs added in a fixed order.
//
// Bound on an H100 SXM at the ViT-S training shape (50,112 rows, 384 ->
// 1536 -> 384): 295.6 GFLOP (recomputed fc1, da, dW2, dW1, dln), so the
// tensor cores bound the function (0.299 ms at 989 TFLOP/s). Each launch's
// own bound (utils.roofline.fused_mlp_bwd_parts_work) counts what it moves:
// lnb, ab, dhb, dln and the partials are written and read back, so the
// launches' bounds sum to more: 0.409 ms there (7 weight chunks). C a
// multiple of 8 and at most 1408; hidden a multiple of 8; any m.

#include "gemm_sm90.cuh"

namespace {

using dinox_gemm::BN;
using dinox_gemm::F32Out;
using dinox_gemm::GeluPair;
using dinox_gemm::StreamLayout;
using dinox_gemm::WForm;

constexpr int BLOCK = 64;         // rows of a partial-sum block (the hidden launch's row blocks)
constexpr int ROW_THREADS = 256;  // norm and dx: 8 warps, a row at a time each
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int MAX_C = 1408;
constexpr int MAX_CHUNKS = 16;    // row chunks of the weights launch, at most
constexpr int RED_RUNS = 8;       // interleaved runs of the block partials in the reduce
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bf16x8(const uint4& u, float (&o)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) o[t] = __bfloat162float(e[t]);
}

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// A row's x as f32 in a lane's LC chunks (chunk lane + 32 i: 8 columns) and
// its two-pass statistics, summed in the lane's order and then over the warp
// by a fixed tree.
template <int LC>
__device__ __forceinline__ void row_stats(const __nv_bfloat16* x, long long row, int c, int lane,
                                          float (&v)[LC][8], float& mu, float& rstd) {
  const int chunks = c / 8;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LC; ++i) {
    if (lane + 32 * i < chunks) {
      bf16x8(*reinterpret_cast<const uint4*>(x + row * c + 8 * (lane + 32 * i)), v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[i][t];
    }
  }
  mu = warp_sum(s) / c;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < LC; ++i)
    if (lane + 32 * i < chunks)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float d = v[i][t] - mu;
        ss += d * d;
      }
  rstd = rsqrtf(warp_sum(ss) / c + LN_EPS);
}

// lnb = bf16((x - mu) rstd gamma + beta), one warp per row; a lane holds LC
// 8-column chunks (C <= 256 LC).
template <int LC>
__global__ void __launch_bounds__(ROW_THREADS)
fused_mlp_bwd_norm(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, __nv_bfloat16* __restrict__ lnb, int m, int c) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  float v[LC][8], mu, rstd;
  row_stats<LC>(x, row, c, lane, v, mu, rstd);
#pragma unroll
  for (int i = 0; i < LC; ++i) {
    const int q = lane + 32 * i;
    if (q < c / 8) {
      float g[8], b[8];
      load8(gamma + 8 * q, g);
      load8(beta + 8 * q, b);
      uint4 u;
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t) e[t] = __float2bfloat16((v[i][t] - mu) * rstd * g[t] + b[t]);
      *reinterpret_cast<uint4*>(lnb + static_cast<long long>(row) * c + 8 * q) = u;
    }
  }
}

using Hidden = StreamLayout<2, 2, GeluPair::C_TILES, GeluPair::SCRATCH>;
constexpr int DLN_TILES = 3;  // column tiles of dln per pass over dhb (C = 384 in one)
using Dln = StreamLayout<2, 1, F32Out::C_TILES, F32Out::SCRATCH, DLN_TILES>;

__global__ void __launch_bounds__(Hidden::THREADS, 1)
fused_mlp_bwd_hidden(const __grid_constant__ CUtensorMap map_lnb,
                     const __grid_constant__ CUtensorMap map_w1,
                     const __grid_constant__ CUtensorMap map_dy,
                     const __grid_constant__ CUtensorMap map_w2,
                     const __grid_constant__ CUtensorMap map_ab,
                     const __grid_constant__ CUtensorMap map_dhb, const GeluPair epi, int m, int k,
                     int nout, int stages, int tiles_per_cta) {
  dinox_gemm::gemm_stream<2, WForm::KMajor, WForm::MNMajor, 1>(
      &map_lnb, &map_w1, &map_dy, &map_w2, &map_ab, &map_dhb, epi, m, k, nout, stages,
      tiles_per_cta);
}

__global__ void __launch_bounds__(Dln::THREADS, 1)
fused_mlp_bwd_dln(const __grid_constant__ CUtensorMap map_dhb, const __grid_constant__ CUtensorMap map_w1,
                  const F32Out epi, int m, int k, int nout, int stages, int tiles_per_cta) {
  dinox_gemm::gemm_stream<2, WForm::MNMajor, WForm::MNMajor, DLN_TILES>(
      &map_dhb, &map_w1, &map_dhb, &map_w1, nullptr, nullptr, epi, m, k, nout, stages, tiles_per_cta);
}

// dx and the 64-row block's partial sums of dgamma, dbeta and db2 (columns
// 0, c and 2c of its row of `part`). A warp takes rows warp, warp + 8, ...
// of the block and keeps its lanes' column sums over them in registers; the
// eight warps' sums meet in shared memory ((3 c) floats each) and are added
// in warp order.
template <int LC>
__global__ void __launch_bounds__(ROW_THREADS)
fused_mlp_bwd_dx(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ dln, const __nv_bfloat16* __restrict__ dy,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ part, int m, int c, int pitch) {
  extern __shared__ float sums[];  // [ROW_WARPS][3 c]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BLOCK;
  const int rows = min(BLOCK, m - r0);
  const int chunks = c / 8;
  float sg[LC][8], sb[LC][8], sy[LC][8];  // this lane's sums of dln xhat, dln, dy
#pragma unroll
  for (int i = 0; i < LC; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) sg[i][t] = sb[i][t] = sy[i][t] = 0.f;
  for (int r = warp; r < rows; r += ROW_WARPS) {
    const long long row = r0 + r;
    float v[LC][8], mu, rstd;
    row_stats<LC>(x, row, c, lane, v, mu, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < LC; ++i) {
      const int q = lane + 32 * i;
      if (q < chunks) {
        float d[8], g[8];
        load8(dln + row * c + 8 * q, d);
        load8(gamma + 8 * q, g);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          v[i][t] = (v[i][t] - mu) * rstd;  // xhat from here on
          sg[i][t] += d[t] * v[i][t];
          sb[i][t] += d[t];
          const float dxh = d[t] * g[t];
          s1 += dxh;
          s2 += dxh * v[i][t];
        }
      }
    }
    const float mean1 = warp_sum(s1) / c, mean2 = warp_sum(s2) / c;
#pragma unroll
    for (int i = 0; i < LC; ++i) {
      const int q = lane + 32 * i;
      if (q < chunks) {
        float d[8], g[8], y[8];
        load8(dln + row * c + 8 * q, d);  // a second read, from L1
        load8(gamma + 8 * q, g);
        uint4 u = *reinterpret_cast<const uint4*>(dy + row * c + 8 * q);
        bf16x8(u, y);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          sy[i][t] += y[t];
          e[t] = __float2bfloat16(y[t] + rstd * (d[t] * g[t] - mean1 - v[i][t] * mean2));
        }
        *reinterpret_cast<uint4*>(dx + row * c + 8 * q) = u;
      }
    }
  }
  float* mine = sums + warp * 3 * c;
#pragma unroll
  for (int i = 0; i < LC; ++i) {
    const int q = lane + 32 * i;
    if (q < chunks)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        mine[8 * q + t] = sg[i][t];
        mine[c + 8 * q + t] = sb[i][t];
        mine[2 * c + 8 * q + t] = sy[i][t];
      }
  }
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * pitch;
  for (int j = threadIdx.x; j < 3 * c; j += ROW_THREADS) {
    float t = sums[j];
#pragma unroll
    for (int w = 1; w < ROW_WARPS; ++w) t += sums[w * 3 * c + j];
    out[j] = t;
  }
}

// Tiles of each weight gradient: dW2 (c, hidden) in wide 128 x 256 tiles,
// dW1 (hidden, c) in tall 256 x 128 ones, the same count.
__host__ __device__ int wgrad_tiles(int c, int hidden) {
  return ((c + dinox_gemm::WG_SHORT - 1) / dinox_gemm::WG_SHORT) *
         ((hidden + dinox_gemm::WG_LONG - 1) / dinox_gemm::WG_LONG);
}

__global__ void __launch_bounds__(dinox_gemm::WG_THREADS, 1)
fused_mlp_bwd_weights(const __grid_constant__ CUtensorMap map_dy,
                      const __grid_constant__ CUtensorMap map_ab,
                      const __grid_constant__ CUtensorMap map_dhb,
                      const __grid_constant__ CUtensorMap map_lnb, float* __restrict__ wpart, int m,
                      int c, int hidden, int rows_per_chunk, int stages) {
  // blockIdx.x: a tile of dW2 = dyb^T ab or, past those, of dW1 = dhb^T
  // lnb; blockIdx.y: the row chunk.
  constexpr int S = dinox_gemm::WG_SHORT, L = dinox_gemm::WG_LONG;
  const int per = wgrad_tiles(c, hidden);
  const bool first = static_cast<int>(blockIdx.x) < per;
  const int t = first ? blockIdx.x : blockIdx.x - per;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int steps = (min(m, r0 + rows_per_chunk) - r0 + 63) / 64;
  float* out = wpart + static_cast<long long>(blockIdx.y) * 2 * c * hidden +
               (first ? 0 : static_cast<long long>(c) * hidden);
  if (first) {  // wide tiles of dW2: (c / 128) x (hidden / 256)
    const int cols = (hidden + L - 1) / L;
    dinox_gemm::gemm_wgrad(&map_dy, &map_ab, out, c, hidden, (t / cols) * S, (t % cols) * L, true,
                           r0, steps, stages);
  } else {  // tall tiles of dW1: (hidden / 256) x (c / 128)
    const int cols = (c + S - 1) / S;
    dinox_gemm::gemm_wgrad(&map_dhb, &map_lnb, out, hidden, c, (t / cols) * L, (t % cols) * S, false,
                           r0, steps, stages);
  }
}

// out[i] = sum over chunks of wpart[s][i] for the 2 c hidden weight
// gradients (blocks below `wgrid`, one thread per element), then, for the
// 3 c + hidden vector gradients (32 columns a block), the sum over the row
// blocks' partials: run g of 8 adds blocks g, g + 8, ... in order, and the
// runs are added 0 to 7.
__global__ void __launch_bounds__(256)
fused_mlp_bwd_reduce(const float* __restrict__ wpart, const float* __restrict__ part,
                     float* __restrict__ out, int chunks, int blocks, long long weights,
                     int vectors, int wgrid) {
  if (static_cast<int>(blockIdx.x) < wgrid) {
    const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    if (i < weights) {
      float s = 0.f;
      for (int k = 0; k < chunks; ++k) s += wpart[k * weights + i];
      out[i] = s;
    }
    return;
  }
  __shared__ float runs[RED_RUNS][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int j = (blockIdx.x - wgrid) * 32 + lane;
  float s = 0.f;
  if (j < vectors)
    for (int b = g; b < blocks; b += RED_RUNS) s += part[static_cast<long long>(b) * vectors + j];
  runs[g][lane] = s;
  __syncthreads();
  if (g == 0 && j < vectors) {
    float t = runs[0][lane];
#pragma unroll
    for (int r = 1; r < RED_RUNS; ++r) t += runs[r][lane];
    out[weights + j] = t;
  }
}

bool takes(int c, int hidden) {
  return c > 0 && c % 8 == 0 && c <= MAX_C && hidden > 0 && hidden % 8 == 0;
}

// The row kernels' instantiation: a lane holds 2 chunks of 8 columns up to
// C = 512, else 6 (up to 1536).
bool narrow(int c) { return c <= 2 * 256; }
int dx_smem(int c) { return ROW_WARPS * 3 * c * static_cast<int>(sizeof(float)); }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// x, dy: (m, c) bf16; gamma, beta: (c,) f32; w1: (hidden, c) bf16; b1:
// (hidden,) f32; w2: (c, hidden) bf16. Workspace: lnb (m, c) bf16; ab, dhb
// (m, hidden) bf16; dln (m, c) f32; part (ceil(m / 64), 3 c + hidden) f32;
// wpart (chunks, 2 c hidden) f32. Outputs: dx (m, c) bf16; out (2 c hidden +
// 3 c + hidden) f32 = [dW2 | dW1 | dgamma | dbeta | db2 | db1]. All contiguous
// and 16-byte aligned. Each entry point makes one launch on `stream` and
// returns its cudaError_t.

extern "C" int dinox_fused_mlp_bwd_norm_bf16(const void* x, const void* gamma, const void* beta,
                                             void* lnb, int m, int c, void* stream) {
  if (!takes(c, 8)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = narrow(c) ? fused_mlp_bwd_norm<2> : fused_mlp_bwd_norm<6>;
  kernel<<<(m + ROW_WARPS - 1) / ROW_WARPS, ROW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(lnb), m, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dinox_fused_mlp_bwd_hidden_bf16(const void* lnb, const void* dy, const void* w1,
                                               const void* b1, const void* w2, void* ab, void* dhb,
                                               void* part, int m, int c, int hidden, void* stream) {
  if (!takes(c, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  dinox_gemm::Grid g;
  cudaError_t err = dinox_gemm::stream_grid<Hidden>(fused_mlp_bwd_hidden, m, hidden, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_lnb, map_w1, map_dy, map_w2, map_ab, map_dhb;
  if ((err = dinox_gemm::encode_rows_map(&map_lnb, lnb, m, c, Hidden::BM)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_w1, w1, hidden, c, BN)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_dy, dy, m, c, Hidden::BM)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_w2, w2, c, hidden, 64)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_ab, ab, m, hidden, 64)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_dhb, dhb, m, hidden, 64)) != cudaSuccess)
    return static_cast<int>(err);
  fused_mlp_bwd_hidden<<<dim3(g.rows, g.groups), Hidden::THREADS, g.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      map_lnb, map_w1, map_dy, map_w2, map_ab, map_dhb,
      GeluPair{static_cast<const float*>(b1), static_cast<float*>(part), 3 * c + hidden, 3 * c}, m,
      c, hidden, g.stages, g.per_cta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dinox_fused_mlp_bwd_dln_bf16(const void* dhb, const void* w1, void* dln, int m, int c,
                                            int hidden, void* stream) {
  if (!takes(c, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  dinox_gemm::Grid g;
  cudaError_t err = dinox_gemm::stream_grid<Dln>(fused_mlp_bwd_dln, m, c, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_dhb, map_w1;
  if ((err = dinox_gemm::encode_rows_map(&map_dhb, dhb, m, hidden, Dln::BM)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_w1, w1, hidden, c, 64)) != cudaSuccess)
    return static_cast<int>(err);
  fused_mlp_bwd_dln<<<dim3(g.rows, g.groups), Dln::THREADS, g.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      map_dhb, map_w1, F32Out{static_cast<float*>(dln)}, m, hidden, c, g.stages, g.per_cta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dinox_fused_mlp_bwd_dx_bf16(const void* x, const void* gamma, const void* dln,
                                           const void* dy, void* dx, void* part, int m, int c,
                                           int hidden, void* stream) {
  if (!takes(c, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = narrow(c) ? fused_mlp_bwd_dx<2> : fused_mlp_bwd_dx<6>;
  const int smem = dx_smem(c);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(m + BLOCK - 1) / BLOCK, ROW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(dln), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), m, c, 3 * c + hidden);
  return static_cast<int>(cudaGetLastError());
}

// The weights launch's split: `chunks` row chunks of `rows_per_chunk` rows
// (a multiple of 64, each chunk starting below m), the fewest that keep at
// least 90% of the SMs' resident CTA slots busy in the last wave (else the
// count with the best such share), and the resident CTAs per SM. Returns a
// cudaError_t.
extern "C" int dinox_fused_mlp_bwd_chunks(int m, int c, int hidden, int* chunks, int* rows_per_chunk,
                                          int* ctas) {
  if (!takes(c, hidden) || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = dinox_gemm::wgrad_stages();
  int regs = 0, smem = 0;
  cudaError_t err = dinox_gemm::occupancy(fused_mlp_bwd_weights, dinox_gemm::WG_THREADS,
                                          dinox_gemm::wgrad_dynamic(stages), &regs, &smem, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(sm_count()) * *ctas;
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = 2LL * wgrad_tiles(c, hidden);
  const int blocks = (m + 63) / 64;
  int best = 1;
  double best_share = 0.0;
  for (int n = 1; n <= MAX_CHUNKS && n <= blocks; ++n) {
    const long long ctas_n = n * tiles;
    const double share = static_cast<double>(ctas_n) / (((ctas_n + slots - 1) / slots) * slots);
    if (ctas_n >= slots && share >= 0.9) {
      best = n;
      break;
    }
    if (share > best_share + 1e-9) {
      best_share = share;
      best = n;
    }
  }
  const int per = (blocks + best - 1) / best;
  *rows_per_chunk = 64 * per;
  *chunks = (blocks + per - 1) / per;
  return 0;
}

extern "C" int dinox_fused_mlp_bwd_weights_bf16(const void* dy, const void* ab, const void* dhb,
                                                const void* lnb, void* wpart, int m, int c,
                                                int hidden, int chunks, int rows_per_chunk,
                                                void* stream) {
  if (!takes(c, hidden) || chunks < 1 || rows_per_chunk % 64 ||
      static_cast<long long>(chunks - 1) * rows_per_chunk >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stages = dinox_gemm::wgrad_stages();
  const int smem = dinox_gemm::wgrad_dynamic(stages);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_weights,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_dy, map_ab, map_dhb, map_lnb;
  if ((err = dinox_gemm::encode_rows_map(&map_dy, dy, m, c, 64)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_ab, ab, m, hidden, 64)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_dhb, dhb, m, hidden, 64)) != cudaSuccess ||
      (err = dinox_gemm::encode_rows_map(&map_lnb, lnb, m, c, 64)) != cudaSuccess)
    return static_cast<int>(err);
  fused_mlp_bwd_weights<<<dim3(2 * wgrad_tiles(c, hidden), chunks), dinox_gemm::WG_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      map_dy, map_ab, map_dhb, map_lnb, static_cast<float*>(wpart), m, c, hidden, rows_per_chunk,
      stages);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dinox_fused_mlp_bwd_reduce(const void* wpart, const void* part, void* out, int chunks,
                                          int blocks, int c, int hidden, void* stream) {
  const long long weights = 2LL * c * hidden;
  const int vectors = 3 * c + hidden;
  const int wgrid = static_cast<int>((weights + 255) / 256);
  fused_mlp_bwd_reduce<<<wgrid + (vectors + 31) / 32, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wpart), static_cast<const float*>(part), static_cast<float*>(out),
      chunks, blocks, weights, vectors, wgrid);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, dynamic shared memory per CTA (bytes) and resident
// CTAs per SM of launch `part` (0 norm, 1 hidden, 2 dln, 3 dx, 4 weights, 5
// reduce) at width c. Returns a cudaError_t.
extern "C" int dinox_fused_mlp_bwd_occupancy(int part, int c, int* regs, int* smem, int* ctas) {
  if (!takes(c, 8)) return static_cast<int>(cudaErrorInvalidValue);
  switch (part) {
    case 0:
      return static_cast<int>(dinox_gemm::occupancy(narrow(c) ? fused_mlp_bwd_norm<2> : fused_mlp_bwd_norm<6>,
                                                    ROW_THREADS, 0, regs, smem, ctas));
    case 1:
      return static_cast<int>(dinox_gemm::occupancy(fused_mlp_bwd_hidden, Hidden::THREADS,
                                                    Hidden::dynamic(Hidden::stages()), regs, smem, ctas));
    case 2:
      return static_cast<int>(dinox_gemm::occupancy(fused_mlp_bwd_dln, Dln::THREADS,
                                                    Dln::dynamic(Dln::stages()), regs, smem, ctas));
    case 3:
      return static_cast<int>(dinox_gemm::occupancy(narrow(c) ? fused_mlp_bwd_dx<2> : fused_mlp_bwd_dx<6>,
                                                    ROW_THREADS, dx_smem(c), regs, smem, ctas));
    case 4:
      return static_cast<int>(dinox_gemm::occupancy(fused_mlp_bwd_weights, dinox_gemm::WG_THREADS,
                                                    dinox_gemm::wgrad_dynamic(dinox_gemm::wgrad_stages()),
                                                    regs, smem, ctas));
    case 5:
      return static_cast<int>(dinox_gemm::occupancy(fused_mlp_bwd_reduce, 256, 0, regs, smem, ctas));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
