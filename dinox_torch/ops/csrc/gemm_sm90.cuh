// A row-block GEMM core for Hopper (sm_90a): C = A W^T, with a templated
// prologue on the A block and a templated epilogue on the f32 accumulator.
// fused_attn_block.cu (TPU kernel 6) runs it twice: LayerNorm + QKV and
// out-projection + residual; fused_mlp.cu (kernel 7) runs it for LayerNorm
// (two-pass) + fc1 + GELU. Further down, two more cores for kernels 7 and 8
// on the same pieces: a streaming core (A tiles in the ring, unbounded K,
// MN-major weights, two products or three column tiles at once) and a
// weight-gradient core (C = P^T Q, split over row chunks). It is built from
// the forward attention core's
// pieces (attention_fwd_sm90.cuh: the mbarrier, TMA and wgmma wrappers, the
// 64-byte-swizzled tensor maps and the K-major `qk` operand form), which this
// header includes rather than copies.
//
// A is (M, K) bf16 row-major; W is (Nout, K) bf16 row-major, the (out, in)
// layout of a Linear weight, which is K-major: wgmma reads it as the B
// operand exactly as the forward core reads K in S = Q K^T.
//
// One CTA owns BM = 64 x WGS rows of A and a run of BN-column tiles of C.
// Its threads are WGS consumer warpgroups, one per 64 rows, and one producer
// warp:
//   - the producer warp's first lane loads the CTA's whole A block along K by
//     TMA, once (32-column boxes of BM rows), then streams BN x 64 tiles of W
//     into a ring of up to MAX_STAGES shared-memory stages, each completion
//     reported to a "full" mbarrier, each stage reused after its "empty"
//     mbarrier has seen every consumer warp;
//   - each consumer warpgroup runs wgmma.m64n128k16 (bf16 x bf16 -> f32, both
//     operands from shared memory) over its 64 rows with the accumulator in
//     registers; the product of one stage is in flight while the previous
//     stage is released (wgmma.wait_group 1); the tile's residual (else its
//     bias) is loaded into registers when the tile starts, so the loads
//     arrive under the products; the epilogue writes the bf16 tile into a
//     shared-memory staging tile and leaves it by TMA stores, which drain
//     while the next tile's products run.
// The A block stays in shared memory for every column tile of the CTA, so a
// prologue runs once per row block and column group, not once per tile.
// Prologues:
//   NoPrologue: A is used as loaded.
//   LayerNorm: each row's f32 statistics (sum and sum of squares over K,
//     the fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-5) and then
//     ln = bf16(((x - mu) * rstd) * gamma + beta) written in place, then a
//     proxy fence so wgmma (the async proxy) reads the normalised block, as
//     the forward core folds the scale into q.
//   LayerNormTwoPass: the same with the two-pass variance mean((x - mu)^2),
//     a second read of the block from shared memory (kernel 7).
// Epilogues:
//   BiasRound:    C = bf16(acc + bias)
//   BiasResidual: C = bf16(x + (acc + bias)), x (M x Nout) read once.
//   BiasGelu:     C = bf16(gelu(acc + bias)), the exact GELU (kernel 7).
//
// Shared memory holds the A block whole: 64 x WGS rows x K x 2 bytes (48 KB
// at WGS 1 and K 384, 176 KB at K 1408), a 16 KB C staging tile per
// warpgroup and the W ring (16 KB a stage). WGS 2 halves the L2 reads of W
// (each CTA reads W once per BM rows) where a 128-row block and two stages
// fit (K <= 640); wider K takes WGS 1. K is at most MAX_K (1408, ViT-G's
// width): a wider A block does not fit beside two stages.
//
// Ragged edges. K need not be a multiple of 32: TMA zero-fills the columns
// past K of A and W (the maps' innermost extent is exactly K). The A block
// is padded to whole 64-deep stages with zero boxes, whose W partner is a
// loaded box again (finite values), so no TMA box lies wholly past K and
// every stage issues the same four products (a branch between them makes
// ptxas serialise the wgmmas). Rows past M and W rows past Nout are
// zero-filled; LayerNorm turns a zero row into beta, which is never stored:
// the TMA store clips rows >= M and columns >= Nout, and the epilogue's
// loads read clamped addresses. LayerNorm writes 0 to the columns past K,
// reads gamma and beta only below K and divides the sums by K.
//
// The swizzle: TMA writes each 64-byte row of a box with its four 16-byte
// chunks permuted (chunk c of row r lands at chunk c ^ ((r >> 1) & 3), the
// 64-byte pattern on address bits 7-8, every box on a 1024-byte boundary).
// LayerNorm reads a row's chunks in any order for its sums, and un-swizzles a
// chunk's column to pick its gamma and beta.
//
// The grid is (row blocks, column groups): a CTA takes ceil(tiles / groups)
// consecutive column tiles, and the groups are as few as fill every SM with
// the resident CTAs the occupancy API allows (1 group at M = 50112, K = 384;
// 2 at M = 8352), accepting the prologue once per group. A CTA starts its
// tiles at blockIdx.x % tiles, so the CTAs of a wave do not all stream the
// same W tile from L2 at once. No atomics: the same inputs give the same
// bits on every run.

#pragma once

#include "attention_fwd_sm90.cuh"

namespace dinox_fwd {

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

}  // namespace dinox_fwd

namespace dinox_gemm {

using dinox_fwd::BOX_COLS;
using dinox_fwd::desc64;
using dinox_fwd::encode_map;
using dinox_fwd::fence_operands;
using dinox_fwd::mbar_arrive;
using dinox_fwd::mbar_expect_tx;
using dinox_fwd::mbar_init;
using dinox_fwd::mbar_wait;
using dinox_fwd::named_barrier;
using dinox_fwd::pack_bf16;
using dinox_fwd::smem_u32;
using dinox_fwd::tma_load_4d;
using dinox_fwd::wgmma_commit;
using dinox_fwd::wgmma_fence;
using dinox_fwd::wgmma_ss;

constexpr int BN = 128;                       // columns of a C tile (the wgmma N)
constexpr int MAX_STAGES = 4;                 // W ring depth, at most
constexpr int STAGE_BOXES = 2;                // 32-column boxes of W per ring stage (64 deep)
constexpr int W_BOX = BN * BOX_COLS * 2;      // one 32-column box of a W tile
constexpr int W_STAGE = STAGE_BOXES * W_BOX;  // a BN x 64 W tile
constexpr int SMEM_LIMIT = 232448;            // a CTA's most dynamic shared memory on sm_90
constexpr int BAR_BYTES = 8 * (1 + 2 * MAX_STAGES);
constexpr int C_BOX = 64 * BOX_COLS * 2;      // one 32-column box of a warpgroup's C tile
constexpr int C_WG = (BN / BOX_COLS) * C_BOX;  // a warpgroup's 64 x BN staging tile
constexpr int MAX_K = 1408;
constexpr float LN_EPS = 1e-5f;

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// TMA stores from shared memory, in bulk groups.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {  // the sources of all but N groups are read
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {  // all but N groups are complete
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

template <int WGS>
struct Layout {
  static constexpr int BM = 64 * WGS;                  // rows of A per CTA
  static constexpr int THREADS = 32 * (4 * WGS + 1);   // WGS consumer warpgroups, one producer warp
  static constexpr int A_BOX = BM * BOX_COLS * 2;      // one 32-column box of the A block
  // The boxes of A that TMA loads (the last may be partly past K), and those
  // the products run over: a whole number of stages, the padding boxes zero.
  __host__ __device__ static int a_loaded(int k) { return (k + BOX_COLS - 1) / BOX_COLS; }
  __host__ __device__ static int a_boxes(int k) {
    return (a_loaded(k) + STAGE_BOXES - 1) / STAGE_BOXES * STAGE_BOXES;
  }
  __host__ __device__ static int c_off(int k) { return a_boxes(k) * A_BOX; }
  __host__ __device__ static int w_off(int k) { return c_off(k) + WGS * C_WG; }
  __host__ __device__ static int bar_off(int k, int stages) { return w_off(k) + stages * W_STAGE; }
  static int dynamic(int k, int stages) { return bar_off(k, stages) + BAR_BYTES + 1024; }
  // The W ring stages that fit beside the A block and the C staging tiles
  // (at most MAX_STAGES), or 0 when fewer than two do.
  static int stages(int k) {
    const int s = (SMEM_LIMIT - 1024 - BAR_BYTES - w_off(k)) / W_STAGE;
    return k > MAX_K || s < 2 ? 0 : (s < MAX_STAGES ? s : MAX_STAGES);
  }
};

// -- prologues ----------------------------------------------------------------

struct NoPrologue {
  static constexpr bool IN_PLACE = false;
};

// LayerNorm of the warpgroup's 64 rows of the A block, in place. Lane l of
// warp cw holds 16-byte chunk l & 3 of rows 16 cw + (l >> 2) and that row + 8
// in each box, so a warp reads 512 contiguous bytes at a time; both rows
// share a swizzle phase, so the lane's gamma and beta serve both. A row's
// four lanes sum their parts with two shuffles.
template <bool TWO_PASS>
struct LayerNormT {
  static constexpr bool IN_PLACE = true;
  const float* gamma;
  const float* beta;

  template <int WGS>
  __device__ __forceinline__ void run(unsigned char* a, int k, int wg, int cw, int lane) const {
    constexpr int A_BOX = Layout<WGS>::A_BOX;
    const int boxes = Layout<WGS>::a_loaded(k);
    const int q = lane & 3;
    const int r0 = wg * 64 + cw * 16 + (lane >> 2);  // and r0 + 8
    unsigned char* chunk = a + r0 * 64 + q * 16;
    const int col0 = 8 * (q ^ ((r0 >> 1) & 3));  // the chunk's column within its box
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, ss[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int j = 0; j < boxes; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(chunk + r * 512 + j * A_BOX);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = __bfloat162float(e[i]);
          s[r][i & 1] += x;
          if constexpr (!TWO_PASS) ss[r][i & 1] += x * x;
        }
      }
    }
    float mu[2], rstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = s[r][0] + s[r][1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      mu[r] = sum / k;
    }
    if constexpr (TWO_PASS) {
      // The variance as mean((x - mu)^2) over the columns below K, a second
      // read of the block from shared memory.
#pragma unroll 4
      for (int j = 0; j < boxes; ++j) {
        if (j * BOX_COLS + col0 >= k) continue;  // a chunk wholly past K (K is a multiple of 8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint4 v = *reinterpret_cast<const uint4*>(chunk + r * 512 + j * A_BOX);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d = __bfloat162float(e[i]) - mu[r];
            ss[r][i & 1] += d * d;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sq = ss[r][0] + ss[r][1];
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      if constexpr (TWO_PASS)
        rstd[r] = rsqrtf(sq / k + LN_EPS);
      else
        rstd[r] = rsqrtf(fmaxf(sq / k - mu[r] * mu[r], 0.f) + LN_EPS);
    }
#pragma unroll 4
    for (int j = 0; j < boxes; ++j) {
      const int col = j * BOX_COLS + col0;
      if (col < k) {  // K is a multiple of 8: a chunk lies wholly below K or wholly past it
        const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
        const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(beta + col);
        const float4 b1 = *reinterpret_cast<const float4*>(beta + col + 4);
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint4 v = *reinterpret_cast<const uint4*>(chunk + r * 512 + j * A_BOX);
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            e[i] = __float2bfloat16((__bfloat162float(e[i]) - mu[r]) * rstd[r] * g[i] + bt[i]);
          *reinterpret_cast<uint4*>(chunk + r * 512 + j * A_BOX) = v;
        }
      } else {  // columns past K end as 0
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint4*>(chunk + r * 512 + j * A_BOX) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
};

using LayerNorm = LayerNormT<false>;        // kernel 6: the fast variance
using LayerNormTwoPass = LayerNormT<true>;  // kernels 7 and 8: mean((x - mu)^2)

// -- epilogues: C = bf16(acc + bias) or bf16(x + (acc + bias)) --------------
// The core loads a tile's residual (else its bias) into registers when the
// tile starts, so those loads are in flight during its products.

struct BiasRound {
  static constexpr bool RESIDUAL = false;
  static constexpr bool GELU = false;
  const float* bias;
  __nv_bfloat16* out;
};

struct BiasResidual {
  static constexpr bool RESIDUAL = true;
  static constexpr bool GELU = false;
  const float* bias;
  const __nv_bfloat16* x;  // (M, Nout), the residual
  __nv_bfloat16* out;
};

// C = bf16(gelu_erf(acc + bias)), the exact GELU in f32.
struct BiasGelu {
  static constexpr bool RESIDUAL = false;
  static constexpr bool GELU = true;
  const float* bias;
  __nv_bfloat16* out;
};

constexpr float SQRT_HALF = 0.7071067811865476f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;

// The exact GELU in f32 with the TPU kernel's erf (Abramowitz & Stegun
// 7.1.26, within 1.5e-7 of erf; dinox_tpu/ops/fused_mlp.py `_erf_f32`):
// p = (1 + erf(h / sqrt 2)) / 2 and e = exp(-h^2 / 2), which is also the
// Gaussian factor of GELU', so one exponential serves both.
__device__ __forceinline__ float gelu_p(float h, float& e) {
  const float ax = fabsf(h) * SQRT_HALF;
  float t;  // 1 / (1 + p ax) by the MUFU reciprocal (1 ulp), not the correctly rounded divide
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(1.f + 0.3275911f * ax));
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t + 0.254829592f) * t;
  e = __expf(-ax * ax);
  return 0.5f * (1.f + copysignf(1.f - poly * e, h));
}

__device__ __forceinline__ float gelu_erf(float h) {
  float e;
  return h * gelu_p(h, e);
}

// -- the core -------------------------------------------------------------------

// The products of one ring stage: STAGE_BOXES A boxes from `a` and the
// stage's W boxes from `w`, two k16 products a box; the first product of a
// tile (ks 0) overwrites the accumulator.
template <int A_BOX>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t a, uint32_t w, int ks) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2 * STAGE_BOXES; ++kk) {
    const uint32_t off = (kk & 1) * 32;
    wgmma_ss<BN>(acc, desc64(a + (kk >> 1) * A_BOX + off, 16, 512),
                 desc64(w + (kk >> 1) * W_BOX + off, 16, 512), ks + kk);
  }
}

// The bias pairs of the fragment's columns in the tile at n0, clamped below
// nout.
__device__ __forceinline__ void load_bias(float2 (&bias)[BN / 8], const float* b, int n0, int tq,
                                          int nout) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    bias[j] = *reinterpret_cast<const float2*>(b + min(n0 + 8 * j + 2 * tq, nout - 2));
}

// The body of a GEMM kernel: grid (row blocks, column groups),
// Layout<WGS>::THREADS threads, Layout<WGS>::dynamic(k, stages) bytes. A
// kernel that calls it passes its __grid_constant__ maps of A (box 32 x BM),
// W (box 32 x BN) and C (box 32 x 64).
template <int WGS, class Pro, class Epi>
__device__ __forceinline__ void gemm_rows(const CUtensorMap* map_a, const CUtensorMap* map_w,
                                          const CUtensorMap* map_c, const Pro& pro, const Epi& epi,
                                          int m, int k, int nout, int stages, int tiles_per_cta) {
  using L = Layout<WGS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled boxes start on 1024-byte boundaries
  unsigned char* smem = smem_raw + (base - raw);
  const int loaded = L::a_loaded(k);
  const int boxes = L::a_boxes(k);
  const int steps = boxes / STAGE_BOXES;  // W stages per column tile
  const uint32_t sw = base + L::w_off(k);
  const uint32_t bar_a = base + L::bar_off(k, stages);
  const uint32_t bar_full = bar_a + 8;  // one per stage
  const uint32_t bar_empty = bar_full + 8 * MAX_STAGES;
  const int m0 = blockIdx.x * L::BM;
  const int tile0 = blockIdx.y * tiles_per_cta;
  const int tiles = min(tiles_per_cta, (nout + BN - 1) / BN - tile0);
  // Each CTA starts its column tiles at blockIdx.x % tiles, so the CTAs of a
  // wave do not all stream the same W tile from L2 at once.
  const int turn = blockIdx.x % tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_a, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * WGS);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_a, loaded * L::A_BOX);
      for (int j = 0; j < loaded; ++j)
        tma_load_4d(base + j * L::A_BOX, map_a, bar_a, j * BOX_COLS, m0, 0, 0);
      int it = 0;
      for (int t = 0; t < tiles; ++t) {
        const int n0 = (tile0 + (t + turn) % tiles) * BN;
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int s = it % stages;
          mbar_wait(bar_empty + 8 * s, ((it / stages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, W_STAGE);
          // A padding box (past the loaded ones) is zero: its W partner is the
          // last loaded box again, any finite values.
          for (int j = 0; j < STAGE_BOXES; ++j)
            tma_load_4d(sw + s * W_STAGE + j * W_BOX, map_w, bar_full + 8 * s,
                        min(STAGE_BOXES * ks + j, loaded - 1) * BOX_COLS, n0, 0, 0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int cw = warp & 3;
  const int wtid = threadIdx.x & 127;  // the thread within its warpgroup
  mbar_wait(bar_a, 0);
  for (int i = wtid; i < (boxes - loaded) * 256; i += 128)  // the padding boxes' rows of this warpgroup
    reinterpret_cast<uint4*>(smem + (loaded + i / 256) * L::A_BOX + wg * 4096)[i % 256] =
        make_uint4(0u, 0u, 0u, 0u);
  if constexpr (Pro::IN_PLACE) pro.template run<WGS>(smem, k, wg, cw, lane);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
  named_barrier(1 + wg, 128);  // the warpgroup's 64 rows are all written
  const uint32_t sa = base + wg * 64 * 64;  // the warpgroup's rows within each A box
  const int sc = L::c_off(k) + wg * C_WG;    // the warpgroup's C staging tile
  const int rr0 = cw * 16 + (lane >> 2);    // the fragment's rows in the warpgroup's 64: rr0, rr0 + 8
  const int tq = lane & 3;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    // The tile's residual pairs, or else its bias pairs, at clamped
    // addresses (a pair past M or Nout is computed but never stored), loaded
    // now so they arrive during the products. With a residual the bias waits
    // for the epilogue: both at once would not fit the registers of two
    // consumer warpgroups.
    const int n0 = (tile0 + (t + turn) % tiles) * BN;
    float2 bias[BN / 8];
    __nv_bfloat162 res[BN / 8][2];
    if constexpr (Epi::RESIDUAL) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = min(m0 + wg * 64 + rr0 + 8 * r, m - 1);
          res[j][r] = *reinterpret_cast<const __nv_bfloat162*>(
              epi.x + row * nout + min(n0 + 8 * j + 2 * tq, nout - 2));
        }
      }
    } else if constexpr (!Epi::GELU) {
      load_bias(bias, epi.bias, n0, tq, nout);
    }

    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % stages;
      mbar_wait(bar_full + 8 * s, (it / stages) & 1);
      mma_stage<L::A_BOX>(acc, sa + STAGE_BOXES * ks * L::A_BOX, sw + s * W_STAGE, ks);
      wgmma_commit();
      if (ks > 0) {  // the previous stage's product is done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % stages));
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % stages));

    // The bf16 tile into the warpgroup's staging boxes through the 64-byte
    // swizzle (chunk j & 3 of row rr lands at (j & 3) ^ ((rr >> 1) & 3): the
    // fragment's stores are free of bank conflicts), then one TMA store per
    // 32-column box, which writes no row >= M and no column >= Nout and
    // drains while the next tile's products run.
    if constexpr (Epi::RESIDUAL) load_bias(bias, epi.bias, n0, tq, nout);
    const bool leader = wtid == 0;
    if (leader) bulk_wait_read<0>();  // the previous tile's stores have read the staging tile
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if constexpr (Epi::GELU)  // one pair at a time: the GELU's registers beside the accumulator
        bias[j] = *reinterpret_cast<const float2*>(epi.bias + min(n0 + 8 * j + 2 * tq, nout - 2));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = rr0 + 8 * r;
        float v0 = acc[4 * j + 2 * r] + bias[j].x;
        float v1 = acc[4 * j + 2 * r + 1] + bias[j].y;
        if constexpr (Epi::RESIDUAL) {
          const float2 x = __bfloat1622float2(res[j][r]);
          v0 = x.x + v0;
          v1 = x.y + v1;
        }
        if constexpr (Epi::GELU) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        *reinterpret_cast<uint32_t*>(smem + sc + (j >> 2) * C_BOX + rr * 64 +
                                     (((j & 3) ^ ((rr >> 1) & 3)) << 4) + 4 * tq) =
            pack_bf16(v0, v1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA store
    named_barrier(1 + wg, 128);
    if (leader && m0 + wg * 64 < m) {
      for (int box = 0; box < BN / BOX_COLS && n0 + box * BOX_COLS < nout; ++box)
        tma_store_4d(map_c, base + sc + box * C_BOX, n0 + box * BOX_COLS, m0 + wg * 64, 0, 0);
      bulk_commit();
    }
  }
  if (wtid == 0) bulk_wait<0>();  // every store is complete
}

// -- host side ------------------------------------------------------------------

// A row-major bf16 (rows, cols) matrix as a 4-D map (cols, rows, 1, 1) with
// boxes of 32 columns x box_rows rows; cols must be a multiple of 8.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int rows, int cols,
                                   int box_rows) {
  const cuuint64_t pitch = 2ull * cols;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows), 1, 1};
  const cuuint64_t strides[3] = {pitch, pitch * rows, pitch * rows};
  const cuuint32_t box[4] = {BOX_COLS, static_cast<cuuint32_t>(box_rows), 1, 1};
  return encode_map(map, base, dims, strides, box);
}

// The grid of one launch: ceil(M / BM) row blocks x `groups` column groups of
// `per_cta` tiles each, the fewest groups that give every SM its resident
// CTAs. Also returns the ring stages and the dynamic shared memory.
struct Grid {
  int rows, groups, per_cta, stages, smem;
};

template <int WGS, class Kernel>
cudaError_t gemm_grid(Kernel kernel, int m, int k, int nout, Grid* g) {
  using L = Layout<WGS>;
  g->stages = L::stages(k);
  if (g->stages < 2) return cudaErrorInvalidValue;
  g->smem = L::dynamic(k, g->stages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::THREADS, g->smem);
  if (err != cudaSuccess) return err;
  const int tiles = (nout + BN - 1) / BN;
  g->rows = (m + L::BM - 1) / L::BM;
  const int want = (sms * per_sm + g->rows - 1) / g->rows;
  const int groups = want < 1 ? 1 : (want > tiles ? tiles : want);
  g->per_cta = (tiles + groups - 1) / groups;
  g->groups = (tiles + g->per_cta - 1) / g->per_cta;
  return cudaSuccess;
}

// Launches `kernel` (a __global__ wrapper of gemm_rows<WGS, Pro, Epi>) for
// C = A W^T: A (m, k), W (nout, k), C = epi.out (m, nout), all bf16
// row-major.
template <int WGS, class Kernel, class Pro, class Epi>
cudaError_t launch_gemm(Kernel kernel, const void* a, const void* w, int m, int k, int nout,
                        const Pro& pro, const Epi& epi, cudaStream_t stream) {
  Grid g;
  cudaError_t err = gemm_grid<WGS>(kernel, m, k, nout, &g);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_w, map_c;
  if ((err = encode_rows_map(&map_a, a, m, k, Layout<WGS>::BM)) != cudaSuccess) return err;
  if ((err = encode_rows_map(&map_w, w, nout, k, BN)) != cudaSuccess) return err;
  if ((err = encode_rows_map(&map_c, epi.out, m, nout, 64)) != cudaSuccess) return err;
  kernel<<<dim3(g.rows, g.groups), Layout<WGS>::THREADS, g.smem, stream>>>(
      map_a, map_w, map_c, pro, epi, m, k, nout, g.stages, g.per_cta);
  return cudaGetLastError();
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs per
// SM of one instantiation at depth k, from the CUDA occupancy API.
template <int WGS, class Kernel>
cudaError_t gemm_occupancy(Kernel kernel, int k, int* regs, int* smem, int* ctas) {
  using L = Layout<WGS>;
  const int stages = L::stages(k);
  if (stages < 2) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = L::dynamic(k, stages);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, L::THREADS, *smem);
}

// =============================================================================
// The streaming core (kernels 7 and 8): C = A W^T or C = A W with A streamed.
//
// gemm_rows holds the CTA's A block whole, so its K is at most MAX_K. Here the
// A tiles ride in the ring beside the W tiles, so K (a multiple of 8) is
// unbounded, and a CTA may run two products over the same K, each with its own
// A and W, into two accumulators (kernel 8's hidden launch: h = lnb W1^T and
// da = dyb W2 over one hidden tile), or one product over NT column tiles at
// once (kernel 7's fc2 and kernel 8's dln: NT = 3 covers C = 384 in one
// pass). Each ring stage holds, per product, NT BN x 64 tiles of W and a
// BM x 64 tile of A (64 deep); the A row block is reread from L2 once per
// pass of NT column tiles.
//
// W comes in two forms:
//   KMajor:  the (out, in) layout, C = A W^T, a stage is two 32-column boxes
//            of BN rows (the `qk` operand form, as in gemm_rows);
//   MNMajor: a (K, N) row-major matrix, C = A W, a stage is four 32-column
//            boxes of 64 rows read transposed (the forward core's V form in
//            P V): kernel 8's da = dyb W2 and dln = dhb W1 read the weights
//            as they are stored, with no transposed copy.
//
// The K tail: TMA zero-fills the columns past K of a partly loaded box. A box
// wholly past K (the second of the last stage when K mod 64 is in (0, 32]) is
// not loaded at all: its products read a zero box in shared memory instead
// (the descriptor is selected, not branched, so every stage issues the same
// products), and a K-major W partner is the last loaded box again (finite).
// An MN-major W box starts below K (its 64 rows are one stage), and one
// whose columns lie wholly past N is the last box below N again: it feeds
// only columns that are never stored.
//
// Epilogues (each loads what it needs at the tile's start, then finishes the
// tile from the accumulators):
//   ResidualOut: y = bf16(x + (acc + bias)), direct stores (kernel 7's fc2);
//   F32Out:      the f32 accumulator stored as it is (kernel 8's dln);
//   GeluPair:    h = acc0 + b1, ab = bf16(gelu(h)), dh = acc1 gelu'(h) (gelu_p),
//                dhb = bf16(dh) through two staging tiles, and the row
//                block's f32 column sums of dh (kernel 8's db1 partials),
//                rows past M masked to 0.
// =============================================================================

enum class WForm { KMajor, MNMajor };

constexpr int MN_BOX = 64 * BOX_COLS * 2;  // a 32-column box of 64 rows

// D (m64n128k16, f32) = A B (+ D when acc != 0), both from shared memory;
// TA / TB read A / B transposed (MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_t(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

// The four k16 products of one 64-deep stage: A from the boxes at a0 and a1
// (K-major, the warpgroup's 64 rows), W from the stage at w in form F.
template <WForm F>
__device__ __forceinline__ void mma_stream(float (&acc)[BN / 2], uint32_t a0, uint32_t a1, uint32_t w,
                                           int ks) {
#pragma unroll
  for (int kk = 0; kk < 2 * STAGE_BOXES; ++kk) {
    const uint64_t da = desc64((kk >> 1 ? a1 : a0) + (kk & 1) * 32, 16, 512);
    if constexpr (F == WForm::KMajor)
      wgmma_t<0, 0>(acc, da, desc64(w + (kk >> 1) * W_BOX + (kk & 1) * 32, 16, 512), ks + kk);
    else
      wgmma_t<0, 1>(acc, da, desc64(w + kk * 1024, MN_BOX, 512), ks + kk);
  }
}

// Shared memory of the streaming core: [zero box][C staging tiles][ring]
// [barriers][epilogue scratch], each box on a 1024-byte boundary. The
// producer is a whole warpgroup that gives up its registers (setmaxnreg) so
// that each consumer thread may hold CONSUMER_REGS: two or three
// accumulators a thread (two products, or three column tiles) would not fit
// the 168 registers a thread of 9 warps gets.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int WGS, int NPROD, int C_TILES, int SCRATCH, int NT = 1>
struct StreamLayout {
  static_assert(NPROD == 1 || NT == 1, "two products run one column tile at a time");
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);  // WGS consumer warpgroups, one producer
  static constexpr int A_BOX = BM * BOX_COLS * 2;
  static constexpr int W_TILES = NT * W_STAGE;                  // a product's NT W tiles of a stage
  static constexpr int PAIR = W_TILES + STAGE_BOXES * A_BOX;  // then its A tile
  static constexpr int NT_COLS = NT * BN;                     // columns of C a pass covers
  static constexpr int STAGE = NPROD * PAIR;
  static constexpr int C_OFF = A_BOX;
  static constexpr int RING_OFF = C_OFF + C_TILES * WGS * C_WG;
  __host__ __device__ static int bar_off(int stages) { return RING_OFF + stages * STAGE; }
  static int dynamic(int stages) { return bar_off(stages) + BAR_BYTES + WGS * SCRATCH + 1024; }
  static int stages() {
    const int s = (SMEM_LIMIT - 1024 - BAR_BYTES - WGS * SCRATCH - RING_OFF) / STAGE;
    return s < MAX_STAGES ? s : MAX_STAGES;
  }
};

// What an epilogue sees of its tile.
struct TileCtx {
  int m, nout, n0;
  int row0;        // the warpgroup's first row
  int block;       // the warpgroup's 64-row block
  int rr0, tq;     // the fragment's rows rr0 and rr0 + 8 of the 64, its column pairs 2 tq + 8 j
  int cw, lane, wtid;
  unsigned char* smem;
  uint32_t base;
  int c_off;       // the warpgroup's first staging tile (bytes from base)
  int c_stride;    // to its next staging tile
  float* scratch;  // the warpgroup's epilogue scratch
};

// Staging (GeluPair's two output tiles): the previous tile's stores have
// read the warpgroup's staging tiles; then the bf16 pair of fragment column
// pair j, row rr, through the 64-byte swizzle; then one TMA store per
// 32-column box of each tile.
__device__ __forceinline__ void stage_begin(const TileCtx& t, int wg) {
  if (t.wtid == 0) bulk_wait_read<0>();
  named_barrier(1 + wg, 128);
}
__device__ __forceinline__ void stage_pair(const TileCtx& t, int tile, int j, int rr, float v0,
                                           float v1) {
  *reinterpret_cast<uint32_t*>(t.smem + t.c_off + tile * t.c_stride + (j >> 2) * C_BOX + rr * 64 +
                               (((j & 3) ^ ((rr >> 1) & 3)) << 4) + 4 * t.tq) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void store_staged(const TileCtx& t, int tile, const CUtensorMap* map) {
  for (int box = 0; box < BN / BOX_COLS && t.n0 + box * BOX_COLS < t.nout; ++box)
    tma_store_4d(map, t.base + t.c_off + tile * t.c_stride + box * C_BOX, t.n0 + box * BOX_COLS,
                 t.row0, 0, 0);
}
__device__ __forceinline__ void stage_end(const TileCtx& t, int wg, const CUtensorMap* map0,
                                          const CUtensorMap* map1) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the TMA store
  named_barrier(1 + wg, 128);
  if (t.wtid == 0 && t.row0 < t.m) {
    store_staged(t, 0, map0);
    store_staged(t, 1, map1);
    bulk_commit();
  }
}

struct ResidualOut {
  static constexpr int NPROD = 1, C_TILES = 0, SCRATCH = 0;
  const float* bias;
  const __nv_bfloat16* x;  // (M, Nout), the residual
  __nv_bfloat16* out;      // (M, Nout)
  struct Regs {};
  __device__ __forceinline__ void load(Regs&, const TileCtx&) const {}
  // The residual and bias pairs are loaded by the epilogue (the accumulators
  // of the pass's other column tiles hold the registers meanwhile), and the
  // bf16 pairs leave as direct stores: no staging tile, so the ring has a
  // third stage (y is C columns, a quarter of the bytes fc2 reads).
  // Loads go out a quarter tile at a time, all of a quarter before any use,
  // from clamped addresses; a pair past M or Nout is never stored.
  __device__ __forceinline__ void finish(float (&acc)[BN / 2], const Regs&, const TileCtx& t, int,
                                         const CUtensorMap*, const CUtensorMap*) const {
    constexpr int Q = BN / 32;  // column pairs a quarter
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 b[Q];
      __nv_bfloat162 xr[Q][2];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int col = min(t.n0 + 8 * (Q * q + i) + 2 * t.tq, t.nout - 2);
        b[i] = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          xr[i][r] = *reinterpret_cast<const __nv_bfloat162*>(
              x + static_cast<long long>(min(t.row0 + t.rr0 + 8 * r, t.m - 1)) * t.nout + col);
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int j = Q * q + i, col = t.n0 + 8 * j + 2 * t.tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = t.row0 + t.rr0 + 8 * r;
          const float2 v = __bfloat1622float2(xr[i][r]);
          if (row < t.m && col < t.nout)
            *reinterpret_cast<uint32_t*>(out + row * t.nout + col) =
                pack_bf16(v.x + (acc[4 * j + 2 * r] + b[i].x), v.y + (acc[4 * j + 2 * r + 1] + b[i].y));
        }
      }
    }
  }
};

struct F32Out {
  static constexpr int NPROD = 1, C_TILES = 0, SCRATCH = 0;
  float* out;  // (M, Nout) f32
  struct Regs {};
  __device__ __forceinline__ void load(Regs&, const TileCtx&) const {}
  __device__ __forceinline__ void finish(float (&acc)[BN / 2], const Regs&, const TileCtx& t, int,
                                         const CUtensorMap*, const CUtensorMap*) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t.row0 + t.rr0 + 8 * r, col = t.n0 + 8 * j + 2 * t.tq;
        if (row < t.m && col < t.nout)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * t.nout + col) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
  }
};

struct GeluPair {
  static constexpr int NPROD = 2, C_TILES = 2, SCRATCH = 4 * BN * 4;  // a warp's column sums each
  const float* b1;
  float* part;  // (64-row blocks, pitch) f32: the block's sums of dh go to columns off + n
  int pitch, off;
  struct Regs {
    float2 bias[BN / 8];
  };
  __device__ __forceinline__ void load(Regs& g, const TileCtx& t) const {
    load_bias(g.bias, b1, t.n0, t.tq, t.nout);
  }
  __device__ __forceinline__ void finish(float (&acc)[2][BN / 2], const Regs& g, const TileCtx& t,
                                         int wg, const CUtensorMap* map_ab,
                                         const CUtensorMap* map_dhb) const {
    stage_begin(t, wg);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float cs[2] = {0.f, 0.f};  // this lane's sum of dh over its two rows, per column
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool live = t.row0 + t.rr0 + 8 * r < t.m;
        float a[2], d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h = acc[0][4 * j + 2 * r + e] + (e ? g.bias[j].y : g.bias[j].x);
          float gauss;
          const float p = gelu_p(h, gauss);
          a[e] = h * p;
          const float dh = acc[1][4 * j + 2 * r + e] * (p + h * gauss * INV_SQRT_2PI);
          d[e] = live ? dh : 0.f;
          cs[e] += d[e];
        }
        stage_pair(t, 0, j, t.rr0 + 8 * r, a[0], a[1]);
        stage_pair(t, 1, j, t.rr0 + 8 * r, d[0], d[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // over the warp's 8 row pairs, a fixed tree
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 4);
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 8);
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
      }
      if (t.lane < 4) *reinterpret_cast<float2*>(t.scratch + t.cw * BN + 8 * j + 2 * t.tq) =
          make_float2(cs[0], cs[1]);
    }
    stage_end(t, wg, map_ab, map_dhb);  // its barrier also publishes the scratch
    const int col = t.n0 + t.wtid;
    if (t.row0 < t.m && col < t.nout) {
      const float* sc = t.scratch + t.wtid;
      part[static_cast<long long>(t.block) * pitch + off + col] =
          ((sc[0] + sc[BN]) + sc[2 * BN]) + sc[3 * BN];
    }
  }
};

// The body of a streaming GEMM kernel: grid (row blocks, column groups),
// StreamLayout::THREADS threads. Product p multiplies A_p (M, K), K-major,
// by W_p in form F_p; the maps of A (box 32 x BM), of a K-major W (box 32 x
// BN) or an MN-major W (box 32 x 64) and of the epilogue's outputs (box 32 x
// 64) are the kernel's __grid_constant__ parameters.
template <int WGS, WForm F0, WForm F1, int NT, class Epi>
__device__ __forceinline__ void gemm_stream(const CUtensorMap* map_a0, const CUtensorMap* map_w0,
                                            const CUtensorMap* map_a1, const CUtensorMap* map_w1,
                                            const CUtensorMap* map_c0, const CUtensorMap* map_c1,
                                            const Epi& epi, int m, int k, int nout, int stages,
                                            int tiles_per_cta) {
  constexpr int NPROD = Epi::NPROD;
  using L = StreamLayout<WGS, NPROD, Epi::C_TILES, Epi::SCRATCH, NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int loaded = (k + BOX_COLS - 1) / BOX_COLS;  // A boxes along K
  const int steps = (k + 63) / 64;
  const uint32_t ring = base + L::RING_OFF;
  const uint32_t bar_full = base + L::bar_off(stages);  // one per stage
  const uint32_t bar_empty = bar_full + 8 * MAX_STAGES;
  const int m0 = blockIdx.x * L::BM;
  const int tile0 = blockIdx.y * tiles_per_cta;  // in passes of NT column tiles
  const int tiles = min(tiles_per_cta, (nout + L::NT_COLS - 1) / L::NT_COLS - tile0);
  const int turn = blockIdx.x % tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * WGS);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WGS) {  // the producer warpgroup; its first lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == 4 * WGS && lane == 0) {
      const CUtensorMap* map_a[2] = {map_a0, map_a1};
      const CUtensorMap* map_w[2] = {map_w0, map_w1};
      const int n_last = (nout - 1) / BOX_COLS * BOX_COLS;  // the last 32-column box below N
      int it = 0;
      for (int t = 0; t < tiles; ++t) {
        const int n0 = (tile0 + (t + turn) % tiles) * L::NT_COLS;
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int s = it % stages;
          const uint32_t full = bar_full + 8 * s;
          const int nb = min(STAGE_BOXES, loaded - STAGE_BOXES * ks);  // A boxes below K
          mbar_wait(bar_empty + 8 * s, ((it / stages) & 1) ^ 1);
          mbar_expect_tx(full, NPROD * (L::W_TILES + nb * L::A_BOX));
#pragma unroll
          for (int p = 0; p < NPROD; ++p) {
            const uint32_t pair = ring + s * L::STAGE + p * L::PAIR;
            for (int j = 0; j < nb; ++j)
              tma_load_4d(pair + L::W_TILES + j * L::A_BOX, map_a[p], full,
                          (STAGE_BOXES * ks + j) * BOX_COLS, m0, 0, 0);
            // A column tile wholly past N (in the last pass) loads the last
            // box below N again: finite values for columns never stored.
            for (int nt = 0; nt < NT; ++nt) {
              const uint32_t w = pair + nt * W_STAGE;
              const int n = n0 + nt * BN;
              if ((p == 0 ? F0 : F1) == WForm::KMajor) {
                for (int j = 0; j < STAGE_BOXES; ++j)
                  tma_load_4d(w + j * W_BOX, map_w[p], full,
                              min(STAGE_BOXES * ks + j, loaded - 1) * BOX_COLS, min(n, n_last), 0, 0);
              } else {
                for (int b = 0; b < BN / BOX_COLS; ++b)
                  tma_load_4d(w + b * MN_BOX, map_w[p], full, min(n + b * BOX_COLS, n_last), 64 * ks,
                              0, 0);
              }
            }
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2;
  const int wtid = threadIdx.x & 127;
  const uint32_t zero = base + wg * 64 * 64;  // the warpgroup's rows of the zero box
  for (int i = wtid; i < 64 * 64 / 16; i += 128)
    reinterpret_cast<uint4*>(smem + wg * 64 * 64)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
  named_barrier(1 + wg, 128);

  TileCtx ctx;
  ctx.m = m;
  ctx.nout = nout;
  ctx.row0 = m0 + wg * 64;
  ctx.block = blockIdx.x * WGS + wg;
  ctx.cw = warp & 3;
  ctx.lane = lane;
  ctx.wtid = wtid;
  ctx.rr0 = ctx.cw * 16 + (lane >> 2);
  ctx.tq = lane & 3;
  ctx.smem = smem;
  ctx.base = base;
  ctx.c_off = L::C_OFF + wg * C_WG;
  ctx.c_stride = WGS * C_WG;
  ctx.scratch = reinterpret_cast<float*>(smem + L::bar_off(stages) + BAR_BYTES) + wg * (Epi::SCRATCH / 4);

  constexpr int NACC = NPROD * NT;  // accumulators: one per product, or one per column tile
  float acc[NACC][BN / 2];
#pragma unroll
  for (int p = 0; p < NACC; ++p)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[p][i] = 0.f;
  int it = 0;
  for (int t = 0; t < tiles; ++t) {
    const int n0 = (tile0 + (t + turn) % tiles) * L::NT_COLS;
    ctx.n0 = n0;
    typename Epi::Regs regs;
    epi.load(regs, ctx);
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int s = it % stages;
      mbar_wait(bar_full + 8 * s, (it / stages) & 1);
      const bool both = STAGE_BOXES * ks + 1 < loaded;  // else the second A box is the zero box
#pragma unroll
      for (int p = 0; p < NACC; ++p) fence_operands(acc[p]);
      wgmma_fence();
      const uint32_t pair = ring + s * L::STAGE;  // product 0's tiles, then product 1's
      const uint32_t a0 = pair + L::W_TILES + wg * 64 * 64;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_stream<F0>(acc[nt], a0, both ? a0 + L::A_BOX : zero, pair + nt * W_STAGE, ks);
      if constexpr (NPROD == 2)
        mma_stream<F1>(acc[NACC - 1], a0 + L::PAIR, both ? a0 + L::PAIR + L::A_BOX : zero,
                       pair + L::PAIR, ks);
      wgmma_commit();
      if (ks > 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % stages));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NACC; ++p) fence_operands(acc[p]);
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % stages));
    if constexpr (NPROD == 2) {
      epi.finish(acc, regs, ctx, wg, map_c0, map_c1);
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        ctx.n0 = n0 + nt * BN;
        if (ctx.n0 < nout) epi.finish(acc[nt], regs, ctx, wg, map_c0, map_c1);
      }
    }
  }
  if (wtid == 0) bulk_wait<0>();  // every store is complete
}

// =============================================================================
// The weight-gradient core (kernel 8): C = P^T Q over a chunk of rows, with
// P (M, mo) and Q (M, no) bf16 row-major, so both operands are MN-major:
// wgmma reads the P tile as a transposed A from shared memory (its tnspA
// field) and the Q tile as a transposed B, both in the MN-major box form
// above. The rows are the K of the product, streamed 64 at a time.
//
// A CTA owns one tile of C and one chunk of rows. Its two consumer
// warpgroups hold two 64 x 128 accumulators each (the producer warpgroup
// hands them its registers, as in the streaming core), so a tile is 128 x
// 256 when C is wide (dW2 = dyb^T ab, C x hidden: each warpgroup 64 rows by
// two column halves) or 256 x 128 when it is tall (dW1 = dhb^T lnb, hidden x
// C: each warpgroup two 64-row halves by 128 columns). Either way a stage
// is 12 boxes (48 KB), the same eight products a stage run from selected
// descriptors, and every output element costs (rows of P + columns of Q)
// of the tile's reads: 1.39 GB of L2 reads at the ViT-S training shape
// against 1.85 GB at 128 x 128.
//
// Split-K: every chunk writes its own f32 partial of the whole C, and a
// later launch adds the chunks in order (no atomics). Rows past M are
// zero-filled by TMA, so they add nothing; chunks hold a multiple of 64 rows
// and start below M.
// =============================================================================

constexpr int WG_THREADS = 3 * 128;                  // a producer warpgroup, two consumer warpgroups
constexpr int WG_STAGE = 12 * MN_BOX;                // P and Q boxes of a 64-row step
constexpr int WG_LONG = 256, WG_SHORT = 128;         // the tile's long and short sides

inline int wgrad_stages() {
  const int s = (SMEM_LIMIT - 1024 - BAR_BYTES) / WG_STAGE;
  return s < MAX_STAGES ? s : MAX_STAGES;
}
inline int wgrad_dynamic(int stages) { return stages * WG_STAGE + BAR_BYTES + 1024; }

// The tile at rows pc, columns qc of C = P^T Q (f32 out (mo, no)), wide
// (128 x 256) or tall (256 x 128), over rows r0 .. r0 + 64 steps - 1.
__device__ __forceinline__ void gemm_wgrad(const CUtensorMap* map_p, const CUtensorMap* map_q,
                                           float* out, int mo, int no, int pc, int qc, bool wide,
                                           int r0, int steps, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_full = base + stages * WG_STAGE;
  const uint32_t bar_empty = bar_full + 8 * MAX_STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p_boxes = (wide ? WG_SHORT : WG_LONG) / BOX_COLS;  // then 12 - p_boxes of Q
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      const int p_last = (mo - 1) / BOX_COLS * BOX_COLS, q_last = (no - 1) / BOX_COLS * BOX_COLS;
      for (int ks = 0; ks < steps; ++ks) {
        const int s = ks % stages;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((ks / stages) & 1) ^ 1);
        mbar_expect_tx(full, WG_STAGE);
        const uint32_t sp = base + s * WG_STAGE;
        // Boxes wholly past mo or no load the last box below it again:
        // finite values for rows or columns of C never stored.
        for (int b = 0; b < 12; ++b) {
          const bool is_p = b < p_boxes;
          tma_load_4d(sp + b * MN_BOX, is_p ? map_p : map_q, full,
                      is_p ? min(pc + b * BOX_COLS, p_last) : min(qc + (b - p_boxes) * BOX_COLS, q_last),
                      r0 + 64 * ks, 0, 0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2;
  // The boxes each accumulator reads: wide, the warpgroup's 64 rows of P by
  // Q's two 128-column halves; tall, its two 64-row halves by Q's 128.
  const uint32_t a_off[2] = {static_cast<uint32_t>((wide ? 2 * wg : 4 * wg) * MN_BOX),
                             static_cast<uint32_t>((wide ? 2 * wg : 4 * wg + 2) * MN_BOX)};
  const uint32_t b_off[2] = {static_cast<uint32_t>(p_boxes * MN_BOX),
                             static_cast<uint32_t>((p_boxes + (wide ? 4 : 0)) * MN_BOX)};
  float acc[2][BN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
  for (int ks = 0; ks < steps; ++ks) {
    const int s = ks % stages;
    mbar_wait(bar_full + 8 * s, (ks / stages) & 1);
    const uint32_t sp = base + s * WG_STAGE;
    fence_operands(acc[0]);
    fence_operands(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_t<1, 1>(acc[h], desc64(sp + a_off[h] + kk * 1024, MN_BOX, 512),
                      desc64(sp + b_off[h] + kk * 1024, MN_BOX, 512), ks + kk);
    wgmma_commit();
    if (ks > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(bar_empty + 8 * ((ks - 1) % stages));
    }
  }
  wgmma_wait<0>();
  fence_operands(acc[0]);
  fence_operands(acc[1]);
  const int rr0 = (warp & 3) * 16 + (lane >> 2), tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row0 = pc + (wide ? 64 * wg : 128 * wg + 64 * h), col0 = qc + (wide ? 128 * h : 0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + rr0 + 8 * r, col = col0 + 8 * j + 2 * tq;
        if (row < mo && col < no)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * no + col) =
              make_float2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
      }
  }
}

// -- host side of the new cores ---------------------------------------------------

// The grid of a streaming launch (as gemm_grid): ceil(M / BM) row blocks x
// the fewest column groups that give every SM its resident CTAs.
template <class L, class Kernel>
cudaError_t stream_grid(Kernel kernel, int m, int nout, Grid* g) {
  g->stages = L::stages();
  if (g->stages < 2) return cudaErrorInvalidValue;
  g->smem = L::dynamic(g->stages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, L::THREADS, g->smem);
  if (err != cudaSuccess) return err;
  const int tiles = (nout + L::NT_COLS - 1) / L::NT_COLS;  // passes of NT column tiles
  g->rows = (m + L::BM - 1) / L::BM;
  const int want = (sms * per_sm + g->rows - 1) / g->rows;
  const int groups = want < 1 ? 1 : (want > tiles ? tiles : want);
  g->per_cta = (tiles + groups - 1) / groups;
  g->groups = (tiles + g->per_cta - 1) / g->per_cta;
  return cudaSuccess;
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs per
// SM of a kernel with `threads` threads and `smem` bytes.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int* regs, int* smem_out, int* ctas) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem_out = smem;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads, smem);
}

}  // namespace dinox_gemm
