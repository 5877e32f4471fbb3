// Fused transformer-MLP half-block forward for Hopper (sm_90a):
//   y = x + fc2(GELU_erf(fc1(LayerNorm(x)))) over rows of width C.
//
// Replaces the TPU kernel `_fwd_kernel` (dinox_tpu/ops/fused_mlp.py, reached
// through `_fwd` / `fused_mlp_block`). Same function and rounding points:
// LayerNorm in f32 with the two-pass variance, its output rounded to bf16;
// h = ln W1^T with f32 accumulation plus the f32 b1; exact GELU in f32 (erff;
// the TPU kernel's polynomial erf is within 1.5e-7 of it); a rounded to bf16;
// y = bf16(x32 + (a W2^T + b2)). Weights are bf16 in the (out, in) layout:
// W1 (hidden, C), W2 (C, hidden).
//
// Bound on an H100 SXM: at the ViT-S training shape (50,112 rows, 384 ->
// 1536 -> 384) the call does 118.2 GFLOP against 77 MB of x, y and weights,
// so the tensor cores bound it (0.120 ms at 989 TFLOP/s).
//
// Design: one CTA of 8 warps per block of R rows (R = 32 up to C = 768, 16
// above, so the f32 fc2 accumulator fits in registers). The CTA normalises its
// rows into a bf16 tile in shared memory, then walks the hidden width in
// chunks of 128: each warp forms 16 hidden columns of h for all R rows
// (wmma, W1 fragments read straight from global memory, where L1/L2 hold the
// weights every CTA shares), the CTA adds b1 and applies GELU through shared
// memory, and each warp adds a W2^T into its C/8 columns of the accumulator.
// Neither h nor a leaves the chip; device memory sees x in, y out and the
// weights. The ragged last row block is masked, not padded. What the design
// does not do yet (later work): wgmma, TMA-staged weight tiles, larger row
// blocks to cut the weight traffic from L2 (each CTA reads all of W1 and W2).

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
constexpr int LDH = HC + 4;   // f32 pitch of the h staging tile
constexpr int LDAC = HC + 8;  // bf16 pitch of the activation tile
constexpr float LN_EPS = 1e-5f;
constexpr float SQRT_HALF = 0.7071067811865476f;

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

template <int C>
struct Shape {
  static constexpr int R = C <= 768 ? 32 : 16;  // rows per CTA
  static constexpr int FR = R / 16;              // row fragments
  static constexpr int FC = C / (WARPS * 16);    // accumulator column fragments per warp
  static constexpr int LDL = C + 8;              // bf16 pitch of the LN tile
  static constexpr int LDO = C + 4;              // f32 pitch of the output staging tile
  static constexpr size_t LN_OFF = 0;
  static constexpr size_t H_OFF = LN_OFF + round128(sizeof(__nv_bfloat16) * R * LDL);
  static constexpr size_t A_OFF = H_OFF + round128(sizeof(float) * R * LDH);
  static constexpr size_t O_OFF = A_OFF + round128(sizeof(__nv_bfloat16) * R * LDAC);
  static constexpr size_t SMEM = O_OFF + round128(sizeof(float) * R * LDO);
  static_assert(C % (WARPS * 16) == 0, "C must be a multiple of 128");
};

template <int C>
__global__ void __launch_bounds__(THREADS)
fused_mlp_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2, __nv_bfloat16* __restrict__ y, int m,
                     int hidden) {
  using S = Shape<C>;
  constexpr int R = S::R;
  constexpr int PER_LANE = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sLn = reinterpret_cast<__nv_bfloat16*>(smem + S::LN_OFF);
  float* sH = reinterpret_cast<float*>(smem + S::H_OFF);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + S::A_OFF);
  float* sO = reinterpret_cast<float*>(smem + S::O_OFF);

  const int r0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Two-pass f32 LayerNorm of the block's rows into the bf16 tile; rows past
  // m are zero.
  for (int r = warp; r < R; r += WARPS) {
    __nv_bfloat16* dst = sLn + r * S::LDL;
    if (r0 + r >= m) {
      for (int k = lane; k < C; k += 32) dst[k] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat16* row = x + (long long)(r0 + r) * C;
    float v[PER_LANE];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      v[i] = __bfloat162float(row[lane + 32 * i]);
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
      dst[k] = __float2bfloat16((v[i] - mu) * rstd * gamma[k] + beta[k]);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[S::FR][S::FC];
#pragma unroll
  for (int i = 0; i < S::FR; ++i)
#pragma unroll
    for (int f = 0; f < S::FC; ++f) wmma::fill_fragment(acc[i][f], 0.f);
  const int c_warp = warp * (C / WARPS);  // this warp's accumulator columns

  for (int j0 = 0; j0 < hidden; j0 += HC) {
    // h[:, j0 + 16*warp .. +16] = ln W1^T, f32 accumulation.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hf[S::FR];
#pragma unroll
    for (int i = 0; i < S::FR; ++i) wmma::fill_fragment(hf[i], 0.f);
    const __nv_bfloat16* w1c = w1 + (long long)(j0 + warp * 16) * C;
#pragma unroll 4
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, w1c + k, C);
#pragma unroll
      for (int i = 0; i < S::FR; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sLn + i * 16 * S::LDL + k, S::LDL);
        wmma::mma_sync(hf[i], fa, fb, hf[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < S::FR; ++i)
      wmma::store_matrix_sync(sH + i * 16 * LDH + warp * 16, hf[i], LDH, wmma::mem_row_major);
    __syncthreads();  // h is complete; every warp is done reading the previous activations

    // a = bf16(GELU(h + b1)).
    for (int i = tid; i < R * HC; i += THREADS) {
      const int r = i / HC, j = i % HC;
      const float hv = sH[r * LDH + j] + b1[j0 + j];
      sA[r * LDAC + j] = __float2bfloat16(0.5f * hv * (1.f + erff(hv * SQRT_HALF)));
    }
    __syncthreads();

    // acc[:, this warp's columns] += a W2^T[chunk, :].
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[S::FR];
#pragma unroll
      for (int i = 0; i < S::FR; ++i)
        wmma::load_matrix_sync(fa[i], sA + i * 16 * LDAC + kk * 16, LDAC);
#pragma unroll
      for (int f = 0; f < S::FC; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, w2 + (long long)(c_warp + f * 16) * hidden + j0 + kk * 16,
                               hidden);
#pragma unroll
        for (int i = 0; i < S::FR; ++i) wmma::mma_sync(acc[i][f], fa[i], fb, acc[i][f]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < S::FR; ++i)
#pragma unroll
    for (int f = 0; f < S::FC; ++f)
      wmma::store_matrix_sync(sO + i * 16 * S::LDO + c_warp + f * 16, acc[i][f], S::LDO,
                              wmma::mem_row_major);
  __syncthreads();

  // y = bf16(x32 + (acc + b2)), 8 columns per thread and step.
  for (int i = tid; i < R * (C / 8); i += THREADS) {
    const int r = i / (C / 8), c = (i % (C / 8)) * 8;
    if (r0 + r >= m) continue;
    const long long off = (long long)(r0 + r) * C + c;
    uint4 xin = *reinterpret_cast<const uint4*>(x + off);
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xin);
    uint4 v;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(xe[j]) + (sO[r * S::LDO + c + j] + b2[c + j]));
    *reinterpret_cast<uint4*>(y + off) = v;
  }
}

template <int C>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* w1,
                   const void* b1, const void* w2, const void* b2, void* y, int m, int hidden,
                   cudaStream_t stream) {
  using S = Shape<C>;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + S::R - 1) / S::R);
  fused_mlp_fwd_kernel<C><<<grid, THREADS, S::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(y), m, hidden);
  return cudaGetLastError();
}

}  // namespace

// x, y: (m, c) bf16; gamma, beta, b2: (c,) f32; w1: (hidden, c) bf16; b1:
// (hidden,) f32; w2: (c, hidden) bf16. All contiguous and 32-byte aligned;
// c one of 384, 768, 1024, 1408; hidden a multiple of 128. Returns the
// cudaError_t of the launch.
extern "C" int dinox_fused_mlp_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, void* y, int m, int c, int hidden,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden % 128) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 384:
      return static_cast<int>(launch<384>(x, gamma, beta, w1, b1, w2, b2, y, m, hidden, s));
    case 768:
      return static_cast<int>(launch<768>(x, gamma, beta, w1, b1, w2, b2, y, m, hidden, s));
    case 1024:
      return static_cast<int>(launch<1024>(x, gamma, beta, w1, b1, w2, b2, y, m, hidden, s));
    case 1408:
      return static_cast<int>(launch<1408>(x, gamma, beta, w1, b1, w2, b2, y, m, hidden, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
