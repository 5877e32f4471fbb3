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
// Bound on an H100 SXM: at the ViT-S serving shape (B=32, N=261, dim 384,
// 6 heads, hd 64) the call moves 25.7 MB (qkv read once, out written once)
// and does 3.35 GFLOP, so memory bounds it (7.7 us at 3.35 TB/s against
// 3.4 us at 989 TFLOP/s). The design reads every qkv byte from device memory
// once per query tile: K/V tiles are re-read by the ceil(N/64) query-tile CTAs
// of a (batch, head), which L2 absorbs at these sizes, and the logits never
// leave shared memory. What the design does not do yet (later work): wgmma,
// TMA and a pipelined K/V ring; this version is simple and right first.
//
// Design: grid (ceil(N/64) query tiles, heads, B); 4 warps, each owning 16
// query rows. The CTA stages its Q tile, then 64-row K/V tiles, in shared
// memory. Tensor-core products via nvcuda::wmma (bf16 x bf16 -> f32, 16x16x16).
// Online softmax over the key tiles (f32 running max and sum, f32 O kept in
// shared memory) lets any N work; the ragged edge of N is masked. Head dims
// 32, 64 and 88 are supported; 88 is zero-padded to 96 in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BLOCK_M = 64;  // query rows per CTA
constexpr int BLOCK_N = 64;  // key rows per K/V tile
constexpr int WARPS = 4;     // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int BF_PAD = 8;  // bf16 row padding (elements); keeps wmma ldm a multiple of 8
constexpr int F_PAD = 4;   // f32 row padding (elements); keeps wmma ldm a multiple of 4

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

template <int HD>
struct Layout {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // head dim padded to the wmma depth
  static constexpr int LDB = HDP + BF_PAD;          // pitch of the Q, K and V tiles (bf16)
  static constexpr int LDS = BLOCK_N + F_PAD;       // pitch of the logits tile (f32)
  static constexpr int LDP = BLOCK_N + BF_PAD;      // pitch of the probabilities tile (bf16)
  static constexpr int LDO = HDP + F_PAD;           // pitch of the output accumulator (f32)
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + round128(sizeof(__nv_bfloat16) * BLOCK_M * LDB);
  static constexpr size_t V_OFF = K_OFF + round128(sizeof(__nv_bfloat16) * BLOCK_N * LDB);
  static constexpr size_t S_OFF = V_OFF + round128(sizeof(__nv_bfloat16) * BLOCK_N * LDB);
  static constexpr size_t P_OFF = S_OFF + round128(sizeof(float) * BLOCK_M * LDS);
  static constexpr size_t O_OFF = P_OFF + round128(sizeof(__nv_bfloat16) * BLOCK_M * LDP);
  static constexpr size_t SMEM = O_OFF + round128(sizeof(float) * BLOCK_M * LDO);
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
packed_attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                            __nv_bfloat16* __restrict__ out, int n, int heads,
                            float scale) {
  using L = Layout<HD>;
  constexpr int HDP = L::HDP;
  constexpr int CHUNKS = HDP / 8;    // 16-byte chunks in a padded row
  constexpr int HD_CHUNKS = HD / 8;  // chunks that hold data
  constexpr int O_HALF = HDP / 2;    // output columns handled by one lane of a row pair

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  float* sO = reinterpret_cast<float*>(smem + L::O_OFF);

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int dim = heads * HD;
  const long long row_stride = 3LL * dim;
  const __nv_bfloat16* base = qkv + (long long)b * n * row_stride + (long long)h * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Q tile, with the scale folded in and rounded to bf16; rows past N and
  // columns past hd are zero.
  for (int i = tid; i < BLOCK_M * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n && c < HD_CHUNKS) {
      val = *reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride + c * 8);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::LDB + c * 8) = val;
  }
  for (int i = tid; i < BLOCK_M * L::LDO; i += THREADS) sO[i] = 0.f;

  // Per-row softmax state: two lanes share a row, each holding half of its
  // logits tile columns and half of its output columns.
  const int lr = lane >> 1;
  const int half = lane & 1;
  const __nv_bfloat16* sQw = sQ + warp * 16 * L::LDB;
  float* sSw = sS + warp * 16 * L::LDS;
  __nv_bfloat16* sPw = sP + warp * 16 * L::LDP;
  float* sOw = sO + warp * 16 * L::LDO;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < n; k0 += BLOCK_N) {
    // Every warp is done with the previous K/V tile (and Q/O are in place).
    __syncthreads();
    for (int i = tid; i < BLOCK_N * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n && c < HD_CHUNKS) {
        const __nv_bfloat16* src = base + (k0 + r) * row_stride + c * 8;
        kv = *reinterpret_cast<const uint4*>(src + dim);
        vv = *reinterpret_cast<const uint4*>(src + 2 * dim);
      }
      *reinterpret_cast<uint4*>(sK + r * L::LDB + c * 8) = kv;
      *reinterpret_cast<uint4*>(sV + r * L::LDB + c * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows, f32 accumulation.
#pragma unroll
    for (int j = 0; j < BLOCK_N / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, sQw + kk * 16, L::LDB);
        wmma::load_matrix_sync(bk, sK + j * 16 * L::LDB + kk * 16, L::LDB);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(sSw + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax update; keys past N get probability 0.
    {
      const float* srow = sSw + lr * L::LDS + half * 32;
      const int cbase = k0 + half * 32;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (cbase + c < n) tmax = fmaxf(tmax, srow[c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_run, tmax);  // finite: every tile holds a key < N
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      __nv_bfloat16* prow = sPw + lr * L::LDP + half * 32;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = (cbase + c < n) ? expf(srow[c] - m_new) : 0.f;
        psum += p;
        prow[c] = __float2bfloat16(p);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      float* orow = sOw + lr * L::LDO + half * O_HALF;
#pragma unroll
      for (int c = 0; c < O_HALF; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O += P V, accumulated in f32 through shared memory.
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sOw + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sPw + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, sV + kk * 16 * L::LDB + j * 16, L::LDB);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sOw + j * 16, acc, L::LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // Normalise after PV and write the head's slice of the token-major output.
  const int row = q0 + warp * 16 + lr;
  if (row < n) {
    const float* orow = sOw + lr * L::LDO;
    __nv_bfloat16* dst = out + ((long long)b * n + row) * dim + (long long)h * HD;
    const int c_end = (half + 1) * O_HALF < HD ? (half + 1) * O_HALF : HD;
    for (int c = half * O_HALF; c < c_end; ++c) dst[c] = __float2bfloat16(orow[c] / l_run);
  }
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, float scale,
                   cudaStream_t stream) {
  using L = Layout<HD>;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK_M - 1) / BLOCK_M, heads, b);
  packed_attention_fwd_kernel<HD><<<grid, THREADS, L::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), n, heads,
      scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: (b, n, 3*heads*hd) bf16, contiguous; out: (b, n, heads*hd) bf16,
// contiguous. Returns the cudaError_t of the launch (0 on success).
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
