// A row-block GEMM core for Hopper (sm_90a): C = A W^T, with a templated
// prologue on the A block and a templated epilogue on the f32 accumulator.
// fused_attn_block.cu (TPU kernel 6) runs it twice: LayerNorm + QKV and
// out-projection + residual. It is built from the forward attention core's
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
// Epilogues:
//   BiasRound:    C = bf16(acc + bias)
//   BiasResidual: C = bf16(x + (acc + bias)), x (M x Nout) read once.
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
struct LayerNorm {
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
          ss[r][i & 1] += x * x;
        }
      }
    }
    float mu[2], rstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = s[r][0] + s[r][1], sq = ss[r][0] + ss[r][1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      mu[r] = sum / k;
      rstd[r] = rsqrtf(fmaxf(sq / k - mu[r] * mu[r], 0.f) + LN_EPS);
    }
    const int col0 = 8 * (q ^ ((r0 >> 1) & 3));  // the chunk's column within its box
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

// -- epilogues: C = bf16(acc + bias) or bf16(x + (acc + bias)) --------------
// The core loads a tile's residual (else its bias) into registers when the
// tile starts, so those loads are in flight during its products.

struct BiasRound {
  static constexpr bool RESIDUAL = false;
  const float* bias;
  __nv_bfloat16* out;
};

struct BiasResidual {
  static constexpr bool RESIDUAL = true;
  const float* bias;
  const __nv_bfloat16* x;  // (M, Nout), the residual
  __nv_bfloat16* out;
};

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
    } else {
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

}  // namespace dinox_gemm
