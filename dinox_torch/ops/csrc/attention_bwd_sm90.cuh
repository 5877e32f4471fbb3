// The backward attention tile core for Hopper (sm_90a), shared by
// packed_attention_bwd.cu (TPU kernels 2 and 3, packed (B, N, 3*dim) qkv) and
// mha_attention_bwd.cu (TPU kernel 5, head-major (B, H, N, hd) q, k, v). It is
// built from the forward core's pieces (attention_fwd_sm90.cuh: the mbarrier,
// TMA and wgmma wrappers, the 64-byte-swizzled 4-D tensor maps, the qk and pv
// operand forms), which this header includes rather than copies.
//
// It replaces the TPU kernels `_packed_bwd_kernel` (kernel 2), its split
// form `_packed_bwd_dq_kernel` + `_packed_bwd_dkv_kernel` (kernel 3) and
// `_mha_bwd_kernel` (kernel 5), all in dinox_tpu/ops/flash_attention.py.
// Bound on an H100 SXM at the ViT-S training shape (192 views, N = 261, 6
// heads of 64): q, k, v and dO in, dq, dk and dv out, 269.4 MB, 80.4 us at
// 3.35 TB/s, against 50.2 GFLOP (51 us at 989 TFLOP/s): bytes bound it.
// Issued work: 9 tile products per (query, key) tile pair (dq: S and dP
// twice, dQ; dkv: S^T, dP^T, dV, dK) where one kernel with atomics would
// issue 5, on the CTA's rows padded to 320 and the looped rows to 272:
// 115.5 GFLOP. What the design does about each: every product on wgmma
// with its accumulator in registers, so the (N, N) matrices never reach
// memory; each streamed tile's TMA load overlaps the previous tile's
// products; the narrowed last tile; 3 CTAs per SM at hd 64. What it leaves:
// each CTA rereads its head's K/V (dq, twice) or Q/dO (dkv) from L2, ~1.2
// GB a call by count, and the serial product -> exps -> product chain
// inside each CTA.
//
// For one (batch, head):
//   s  = (q k^T) * scale                 f32 (the scale is NOT folded into q)
//   P  = softmax(s)                      f32, normalised before any rounding
//   dV = bf16(P)^T dO
//   dP = dO V^T                          f32
//   dS = P * (dP - D),  D = rowsum(dP * P)
//   dQ = bf16(dS * scale) K,  dK = bf16(dS * scale)^T Q
// written, rounded to bf16, into their rows. Only the addressing (the tensor
// maps' coordinates and the output pitch) differs between the two layouts, so
// they give the same bits on the same data.
//
// Two kernels, each on the forward's thread shape: one consumer warpgroup
// that owns a 64-row tile and runs every product with wgmma, its accumulators
// in registers, and one producer warp that streams the other operand's 64-row
// tiles by TMA into a two-stage ring of mbarriers.
// * attention_bwd_sm90_dq, one 64-row query tile per CTA (Q and dO loaded
//   once; K and V streamed twice).
//   Pass 1: S = Q K^T and dP = dO V^T (both K-major, the forward's qk form,
//   one commit group); the online row max m of the scaled logits, the sum l
//   of exp(s - m) and d = sum exp(s - m) * dP, l and d rescaled by
//   exp(m_old - m_new) when m moves; then D = d / l.
//   Pass 2: S and dP again; P = exp(s - m) * (1 / l) and dS = P (dP - D) in
//   registers; bf16(dS * scale) becomes the register A fragment of
//   dQ += dS K, with K the MN-major B operand (the forward's pv form, K in
//   V's place). Writes dQ and each row's (m, l, D) to the head's (3, N) f32
//   statistics.
// * attention_bwd_sm90_dkv, one 64-row key tile per CTA (K and V loaded once;
//   Q, dO and the query tile's statistics streamed). S^T = K Q^T and
//   dP^T = V dO^T (qk form); P^T and dS^T in registers from the per-column
//   (m, 1/l, D); dV += bf16(P^T) dO and dK += bf16(dS^T * scale) Q, each a
//   register A operand with dO or Q the MN-major B operand. Every streamed
//   tile is read K-major by one product and MN-major by another, as the
//   forward reads K and V. The statistics' row pitch is N * 4 bytes (1044 at
//   N = 261), not a multiple of 16, so no tensor map covers them: the
//   producer warp's 32 lanes load the tile's 3 x 64 floats with ordinary
//   loads one tile ahead (1 / l taken there), store them beside the stage
//   and arrive on its full barrier with the TMA bytes.
// S, dP, P and dS never leave registers.
//
// The ragged edge. TMA zero-fills rows past N and hd 88's columns 88-95 (the
// maps' innermost extent is exactly hd). Key columns >= N of the dq kernel
// are set to -inf before the row max, so their P and dS are 0. Query columns
// >= N of the dkv kernel get P = 0 and dS = 0 explicitly: their zero-filled
// statistics would give exp(s) * inf. The last tile of the looped axis is
// multiplied at the narrowest width that covers it: 16, 32 or 64 keys in dq,
// 16 or 32 queries in dkv's last 32-column step (272 rather than 320 rows at
// N = 261 on both axes). Rows >= N and columns >= hd
// are never written: the outputs leave the accumulator fragments as direct
// bf16x2 stores (the forward's epilogue), which need no staging tile, skip
// the padded columns and rows by a compare, and whose 16-byte row pieces L2
// merges; a TMA store would need the fragments staged in shared memory first.
//
// Registers and occupancy: the dkv consumer holds dK and dV (2 x HDP/2
// floats) beside S^T and dP^T, so it steps over each query tile in two
// 32-column halves (S^T and dP^T 16 floats each). That fits 128 registers
// at hd <= 64, the most that lets 3 CTAs of 5 warps share an SM (one
// scheduler holds 4 of their 15 warps); a 64-column step needs more and
// runs 2 CTAs per SM. The dq kernel (S, dP and dQ in registers) runs 3 CTAs
// per SM at hd <= 64; at hd 88 both run 2, with 0 spills everywhere. At hd
// 128 (the ring and the fixed tiles 97 KB of shared memory a CTA) the
// launch bound asks for one CTA an SM: two CTAs of 5 warps put 3 warps on
// one scheduler, which caps a thread at 168 registers, under what dQ (64
// accumulators beside S and dP) or dK + dV (128) need without spilling; a
// kernel that fits in 168 still runs two. No
// atomics: every output element is written once, by one thread, and the
// same inputs give the same bits on every run.
//
// Rounding points are kernel 2's (dinox_tpu/ops/flash_attention.py,
// `_packed_bwd_kernel`): the scale multiplies the f32 logits, P is
// normalised in f32, dV takes bf16(P), dQ and dK take bf16(dS * scale).
// exp is ex2((s * scale - m) * log2 e) and the normalisation p * (1 / l), as
// in the forward; D is d / l. D is the reference's rowsum(dP * P), not
// FlashAttention-2's rowsum(dO * O): O is kernel 1's bf16 output, whose
// rounding is not the reference's P.

#pragma once

#include "attention_fwd_sm90.cuh"

namespace dinox_bwd {

using namespace dinox_fwd;

constexpr int BLOCK = 64;  // rows of the CTA's own tile and of each streamed tile
constexpr int STAT_BYTES = 3 * BLOCK * 4;  // (m, 1/l, D) of one query tile
constexpr int QSTEP = 32;  // query columns per step of the dkv kernel: two steps a tile
static_assert(BLOCK == BLOCK_M && BLOCK == BLOCK_N, "the forward's box shape serves every tile");

template <int HD>
struct Layout {
  static constexpr int HDP = Smem<HD>::HDP;  // 32, 64, 96, 128
  static constexpr int TILE = Smem<HD>::TILE;
  static constexpr int FIXED_OFF = 0;         // dq: Q, dO; dkv: K, V (loaded once)
  static constexpr int RING_OFF = 2 * TILE;   // per stage: dq: K, V; dkv: Q, dO
  static constexpr int STAT_OFF = RING_OFF + 2 * STAGES * TILE;  // dkv: per stage
  static constexpr int BAR_OFF = STAT_OFF + STAGES * STAT_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int DYNAMIC = BYTES + 1024;  // slack to align the base to 1024 bytes
};

// The fragment coordinates of value i of an m64nN accumulator (see dinox_fwd::RowState).
__device__ __forceinline__ int frag_col(int i, int tq) { return 8 * (i >> 2) + 2 * tq + (i & 1); }
__device__ __forceinline__ int frag_row(int i) { return (i >> 1) & 1; }

// S = A B^T and T = C D^T over the first KW rows of B and D (all K-major),
// issued as one commit group and waited for together.
template <int KW, int HDP>
__device__ __forceinline__ void qk_pair(float (&s)[KW / 2], uint32_t sa, uint32_t sb,
                                        float (&t)[KW / 2], uint32_t sc, uint32_t sd) {
  fence_operands(s);
  fence_operands(t);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk >> 1) * BOX_BYTES + (kk & 1) * 32;
    wgmma_ss<KW>(s, desc64(sa + off, 16, 512), desc64(sb + off, 16, 512), kk);
  }
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk >> 1) * BOX_BYTES + (kk & 1) * 32;
    wgmma_ss<KW>(t, desc64(sc + off, 16, 512), desc64(sd + off, 16, 512), kk);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_operands(s);
  fence_operands(t);
}

// O += P X and U += R Y over the first KW rows of the tiles X and Y (MN-major
// B operands), P and R register A fragments; one commit group.
template <int KW, int HDP>
__device__ __forceinline__ void pv_pair(float (&o)[HDP / 2], const uint32_t (&p)[KW / 16][4],
                                        uint32_t sx, float (&u)[HDP / 2],
                                        const uint32_t (&r)[KW / 16][4], uint32_t sy) {
  fence_operands(o);
  fence_operands(u);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) wgmma_rs<HDP>(o, p[kk], desc64(sx + kk * 1024, BOX_BYTES, 512));
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) wgmma_rs<HDP>(u, r[kk], desc64(sy + kk * 1024, BOX_BYTES, 512));
  wgmma_commit();
  wgmma_wait0();
  fence_operands(o);
  fence_operands(u);
}

// An f32 accumulator fragment of KW columns as the m64k16 bf16 A fragments
// of the next product.
template <int KW>
__device__ __forceinline__ void to_a_fragments(uint32_t (&f)[KW / 16][4], const float (&x)[KW / 2]) {
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
  }
}

// The dq consumer's row state; a thread holds rows r = 0 (g) and r = 1 (g + 8)
// of its warp's 16.
struct DqRows {
  float m[2];     // running max of the scaled logits
  float l[2];     // this thread's part of the row sum of exp(s - m)
  float d[2];     // this thread's part of the row sum of exp(s - m) * dP
  float rinv[2];  // pass 2: 1 / l
  float dd[2];    // pass 2: D = d / l
};

// One key tile at width KW of the dq kernel: pass 1 (m, l, d) when STATS,
// else the tile's contribution to dQ.
template <int KW, int HD, bool STATS>
__device__ __forceinline__ void dq_step(float (&dq)[Layout<HD>::HDP / 2], DqRows& st, uint32_t sq,
                                        uint32_t sdo, uint32_t sk, uint32_t sv, uint32_t empty,
                                        int k0, int n, float scale, int tq, int lane) {
  constexpr int HDP = Layout<HD>::HDP;
  float s[KW / 2], dp[KW / 2];
  qk_pair<KW, HDP>(s, sq, sk, dp, sdo, sv);
  const bool ragged = k0 + KW > n;
#pragma unroll
  for (int i = 0; i < KW / 2; ++i) {
    float x = s[i] * scale;
    if (ragged && k0 + frag_col(i, tq) >= n) x = -INFINITY;
    s[i] = x;
  }
  if constexpr (STATS) {
    if (lane == 0) mbar_arrive(empty);  // the K and V tiles are no longer read
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KW / 2; ++i)
        if (frag_row(i) == r) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(st.m[r], mx);  // finite: every tile holds a key < N
      const float alpha = ex2((st.m[r] - m_new) * LOG2E);  // 0 on the first tile
      st.m[r] = m_new;
      st.l[r] *= alpha;
      st.d[r] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) {
      const int r = frag_row(i);
      const float e = ex2((s[i] - st.m[r]) * LOG2E);
      st.l[r] += e;
      st.d[r] += e * dp[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) {
      const int r = frag_row(i);
      const float p = ex2((s[i] - st.m[r]) * LOG2E) * st.rinv[r];
      s[i] = p * (dp[i] - st.dd[r]) * scale;
    }
    uint32_t f[KW / 16][4];
    to_a_fragments<KW>(f, s);
    pv<KW, HDP>(dq, f, sk);  // dQ += bf16(dS * scale) K
    if (lane == 0) mbar_arrive(empty);  // the K and V tiles are no longer read
  }
}

// The last key tile at the narrowest width that covers its rem keys.
template <int HD, bool STATS>
__device__ __forceinline__ void dq_any(float (&dq)[Layout<HD>::HDP / 2], DqRows& st, uint32_t sq,
                                       uint32_t sdo, uint32_t sk, uint32_t sv, uint32_t empty,
                                       int k0, int n, float scale, int tq, int lane) {
  const int rem = n - k0;
  if (rem > 32)
    dq_step<64, HD, STATS>(dq, st, sq, sdo, sk, sv, empty, k0, n, scale, tq, lane);
  else if (rem > 16)
    dq_step<32, HD, STATS>(dq, st, sq, sdo, sk, sv, empty, k0, n, scale, tq, lane);
  else
    dq_step<16, HD, STATS>(dq, st, sq, sdo, sk, sv, empty, k0, n, scale, tq, lane);
}

// Query columns [c0, c0 + QW) of the streamed tile in the dkv kernel: S^T
// and dP^T against the CTA's K and V, then dV and dK. `stat` is the tile's
// (m, 1/l, D) in shared memory, q0 the tile's first query.
template <int QW, int HD>
__device__ __forceinline__ void dkv_step(float (&dk)[Layout<HD>::HDP / 2],
                                         float (&dv)[Layout<HD>::HDP / 2], uint32_t sk, uint32_t sv,
                                         uint32_t sq, uint32_t sdo, const float* stat, int q0,
                                         int c0, int n, float scale, int tq) {
  constexpr int HDP = Layout<HD>::HDP;
  const uint32_t rows = c0 * BOX_COLS * 2;  // byte offset of row c0 in every box
  float s[QW / 2], dp[QW / 2];
  qk_pair<QW, HDP>(s, sk, sq + rows, dp, sv, sdo + rows);  // S^T = K Q^T, dP^T = V dO^T
  const bool ragged = q0 + c0 + QW > n;
#pragma unroll
  for (int i = 0; i < QW / 2; i += 2) {
    const int c = c0 + frag_col(i, tq);  // even: columns c and c + 1
    const float2 m = *reinterpret_cast<const float2*>(stat + c);
    const float2 rinv = *reinterpret_cast<const float2*>(stat + BLOCK + c);
    const float2 dd = *reinterpret_cast<const float2*>(stat + 2 * BLOCK + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = 0.f, ds = 0.f;  // query columns past N: P = dS = 0
      if (!ragged || q0 + c + e < n) {
        p = ex2((s[i + e] * scale - (e ? m.y : m.x)) * LOG2E) * (e ? rinv.y : rinv.x);
        ds = p * (dp[i + e] - (e ? dd.y : dd.x)) * scale;
      }
      s[i + e] = p;
      dp[i + e] = ds;
    }
  }
  uint32_t pf[QW / 16][4], df[QW / 16][4];
  to_a_fragments<QW>(pf, s);
  to_a_fragments<QW>(df, dp);
  pv_pair<QW, HDP>(dv, pf, sdo + rows, dk, df, sq + rows);  // dV += P^T dO, dK += dS^T Q
}

// One streamed query tile of the dkv kernel: its valid columns in steps of
// QSTEP, the last at the narrowest of 16 or 32 that covers it. The steps
// are not unrolled, which keeps the consumer at 128 registers at hd <= 64.
template <int HD>
__device__ __forceinline__ void dkv_tile(float (&dk)[Layout<HD>::HDP / 2],
                                         float (&dv)[Layout<HD>::HDP / 2], uint32_t sk, uint32_t sv,
                                         uint32_t sq, uint32_t sdo, const float* stat, int q0, int n,
                                         float scale, int tq) {
#pragma unroll 1
  for (int c0 = 0; c0 < BLOCK; c0 += QSTEP) {
    const int rem = n - q0 - c0;
    if (rem <= 0) break;
    if (rem > 16)
      dkv_step<QSTEP, HD>(dk, dv, sk, sv, sq, sdo, stat, q0, c0, n, scale, tq);
    else
      dkv_step<16, HD>(dk, dv, sk, sv, sq, sdo, stat, q0, c0, n, scale, tq);
  }
}

// Row 0 of the head's slice of an output, and the output's row pitch:
// packed outputs are hd-wide slots of (B, N, 3 * heads * hd) rows, head-major
// ones (B, heads, N, hd).
template <int HD, bool PACKED>
__device__ __forceinline__ __nv_bfloat16* head_rows(__nv_bfloat16* base, int b, int h, int n,
                                                    int heads) {
  return PACKED ? base + static_cast<long long>(b) * n * 3 * heads * HD + h * HD
                : base + (static_cast<long long>(b) * heads + h) * n * HD;
}

// Writes a thread's rows row0 and row0 + 8 of an m64nHDP accumulator,
// rounded to bf16; rows >= N and columns >= hd are skipped.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[Layout<HD>::HDP / 2],
                                           __nv_bfloat16* dst, long long pitch, int row0, int n,
                                           int tq) {
#pragma unroll
  for (int j = 0; j < Layout<HD>::HDP / 8; ++j) {
    if (8 * j >= HD) break;  // hd 88: the zero columns 88-95
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < n)
        *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(row) * pitch + 8 * j + 2 * tq) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// grid (ceil(N / 64), heads, B), THREADS threads, Layout<HD>::DYNAMIC bytes.
// Packed: map_qkv is (hd, 3 * heads, N, B) (q, k, v in head slots h,
// heads + h, 2 * heads + h), map_do (hd, heads, N, B); head-major: map_q,
// map_k, map_v, map_do are (hd, N, H, B). Writes dq's rows of the CTA's query
// tile and their (m, l, D) to stats (B * heads, 3, N).
template <int HD, bool PACKED>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 3 : HD <= 96 ? 2 : 1)
attention_bwd_sm90_dq(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, __nv_bfloat16* __restrict__ dq,
                      float* __restrict__ stats, int n, int heads, float scale) {
  using L = Layout<HD>;
  constexpr int HDP = L::HDP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles start on 1024-byte boundaries
  const uint32_t bar_fixed = base + L::BAR_OFF;
  const uint32_t bar_full = bar_fixed + 8;  // one per stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BLOCK;
  const int tiles = (n + BLOCK - 1) / BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t sq = base + L::FIXED_OFF;
  const uint32_t sdo = sq + L::TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_fixed, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);  // each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer: Q and dO once, then K and V for each pass
    if (lane == 0) {
      mbar_expect_tx(bar_fixed, 2 * L::TILE);
      load_tile<HD, PACKED>(sq, &map_q, bar_fixed, h, m0, h, b);
      load_tile<HD, PACKED>(sdo, &map_do, bar_fixed, h, m0, h, b);
      int it = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int t = 0; t < tiles; ++t, ++it) {
          const int s = it % STAGES;
          const uint32_t sk = base + L::RING_OFF + 2 * s * L::TILE;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * L::TILE);
          load_tile<HD, PACKED>(sk, &map_k, bar_full + 8 * s, heads + h, t * BLOCK, h, b);
          load_tile<HD, PACKED>(sk + L::TILE, &map_v, bar_full + 8 * s, 2 * heads + h, t * BLOCK,
                                h, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = m0 + warp * 16 + g;  // row r = 0; r = 1 is row0 + 8


  mbar_wait(bar_fixed, 0);
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  DqRows st = {{-INFINITY, -INFINITY}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  int it = 0;
  for (int t = 0; t < tiles; ++t, ++it) {  // pass 1: m, l, d
    const int s = it % STAGES;
    mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
    const uint32_t sk = base + L::RING_OFF + 2 * s * L::TILE;
    if (t * BLOCK + BLOCK <= n)
      dq_step<64, HD, true>(acc, st, sq, sdo, sk, sk + L::TILE, bar_empty + 8 * s, t * BLOCK, n,
                            scale, tq, lane);
    else
      dq_any<HD, true>(acc, st, sq, sdo, sk, sk + L::TILE, bar_empty + 8 * s, t * BLOCK, n, scale,
                       tq, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the full row sums
    float l = st.l[r], d = st.d[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    st.l[r] = l;
    st.rinv[r] = 1.f / l;
    st.dd[r] = d / l;
  }
  for (int t = 0; t < tiles; ++t, ++it) {  // pass 2: dQ
    const int s = it % STAGES;
    mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
    const uint32_t sk = base + L::RING_OFF + 2 * s * L::TILE;
    if (t * BLOCK + BLOCK <= n)
      dq_step<64, HD, false>(acc, st, sq, sdo, sk, sk + L::TILE, bar_empty + 8 * s, t * BLOCK, n,
                             scale, tq, lane);
    else
      dq_any<HD, false>(acc, st, sq, sdo, sk, sk + L::TILE, bar_empty + 8 * s, t * BLOCK, n,
                        scale, tq, lane);
  }

  store_rows<HD>(acc, head_rows<HD, PACKED>(dq, b, h, n, heads), PACKED ? 3LL * heads * HD : HD,
                 row0, n, tq);
  if (tq == 0) {
    float* row_stats = stats + (static_cast<long long>(b) * heads + h) * 3 * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < n) {
        row_stats[row] = st.m[r];
        row_stats[n + row] = st.l[r];
        row_stats[2 * n + row] = st.dd[r];
      }
    }
  }
}

// grid (ceil(N / 64), heads, B), THREADS threads, Layout<HD>::DYNAMIC bytes;
// maps as for the dq kernel. Reads the (m, l, D) that the dq kernel wrote to
// stats and writes dk's and dv's rows of the CTA's key tile.
template <int HD, bool PACKED>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 3 : HD <= 96 ? 2 : 1)
attention_bwd_sm90_dkv(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int n, int heads, float scale) {
  using L = Layout<HD>;
  constexpr int HDP = L::HDP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_fixed = base + L::BAR_OFF;
  const uint32_t bar_full = bar_fixed + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BLOCK;
  const int tiles = (n + BLOCK - 1) / BLOCK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t sk = base + L::FIXED_OFF;
  const uint32_t sv = sk + L::TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_fixed, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // every lane of the producer (the statistics)
      mbar_init(bar_empty + 8 * s, 4);  // each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer: K and V once, then Q, dO and the statistics of each query tile
    if (lane == 0) {
      mbar_expect_tx(bar_fixed, 2 * L::TILE);
      load_tile<HD, PACKED>(sk, &map_k, bar_fixed, heads + h, k0, h, b);
      load_tile<HD, PACKED>(sv, &map_v, bar_fixed, 2 * heads + h, k0, h, b);
    }
    const float* row_stats = stats + (static_cast<long long>(b) * heads + h) * 3 * n;
    // This lane's columns (lane, lane + 32) of a query tile's (m, 1/l, D),
    // read one tile ahead so the loads' latency passes while the producer
    // waits for a free stage; zeros past N, whose columns are masked anyway.
    float next[2][3];
    auto fetch = [&](int t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = t * BLOCK + lane + 32 * j;
        const bool ok = q < n;
        next[j][0] = ok ? row_stats[q] : 0.f;
        next[j][1] = ok ? 1.f / row_stats[n + q] : 0.f;
        next[j][2] = ok ? row_stats[2 * n + q] : 0.f;
      }
    };
    fetch(0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t sq = base + L::RING_OFF + 2 * s * L::TILE;
      float* stat = reinterpret_cast<float*>(smem + L::STAT_OFF + s * STAT_BYTES);
      mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int x = 0; x < 3; ++x) stat[x * BLOCK + lane + 32 * j] = next[j][x];
      }
      if (lane == 0) {  // arrives after its own stores, like the other lanes
        mbar_expect_tx(bar_full + 8 * s, 2 * L::TILE);
        load_tile<HD, PACKED>(sq, &map_q, bar_full + 8 * s, h, t * BLOCK, h, b);
        load_tile<HD, PACKED>(sq + L::TILE, &map_do, bar_full + 8 * s, h, t * BLOCK, h, b);
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
      if (t + 1 < tiles) fetch(t + 1);
    }
    return;
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = k0 + warp * 16 + g;

  mbar_wait(bar_fixed, 0);
  float acc_k[HDP / 2], acc_v[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t sq = base + L::RING_OFF + 2 * s * L::TILE;
    const float* stat = reinterpret_cast<const float*>(smem + L::STAT_OFF + s * STAT_BYTES);
    dkv_tile<HD>(acc_k, acc_v, sk, sv, sq, sq + L::TILE, stat, t * BLOCK, n, scale, tq);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // Q, dO and the statistics are no longer read
  }

  const long long pitch = PACKED ? 3LL * heads * HD : HD;
  store_rows<HD>(acc_k, head_rows<HD, PACKED>(dk, b, h, n, heads), pitch, row0, n, tq);
  store_rows<HD>(acc_v, head_rows<HD, PACKED>(dv, b, h, n, heads), pitch, row0, n, tq);
}

// -- host side ----------------------------------------------------------------

// The dq kernel writes dq (the dq slots of dqkv when PACKED) and stats; the
// dkv kernel, launched after it on the same stream, reads stats and writes dk
// and dv. Packed: dq, dk, dv point at the dq, dk and dv slots of row 0.
template <int HD, bool PACKED>
cudaError_t launch_dq(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                      const CUtensorMap& dout, void* dq, void* stats, int b, int heads, int n,
                      float scale, cudaStream_t stream) {
  auto kernel = attention_bwd_sm90_dq<HD, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<HD>::DYNAMIC);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  kernel<<<grid, THREADS, Layout<HD>::DYNAMIC, stream>>>(
      q, k, v, dout, static_cast<__nv_bfloat16*>(dq), static_cast<float*>(stats), n, heads, scale);
  return cudaGetLastError();
}

template <int HD, bool PACKED>
cudaError_t launch_dkv(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                       const CUtensorMap& dout, const void* stats, void* dk, void* dv, int b,
                       int heads, int n, float scale, cudaStream_t stream) {
  auto kernel = attention_bwd_sm90_dkv<HD, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<HD>::DYNAMIC);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, heads, b);
  kernel<<<grid, THREADS, Layout<HD>::DYNAMIC, stream>>>(
      q, k, v, dout, static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, heads, scale);
  return cudaGetLastError();
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs per
// SM of the dq (part 0) or dkv (part 1) kernel, from the CUDA occupancy API.
template <int HD, bool PACKED>
cudaError_t occupancy_bwd(int part, int* regs, int* smem, int* ctas) {
  const void* kernel = part == 0 ? reinterpret_cast<const void*>(attention_bwd_sm90_dq<HD, PACKED>)
                                 : reinterpret_cast<const void*>(attention_bwd_sm90_dkv<HD, PACKED>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<HD>::DYNAMIC);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = Layout<HD>::DYNAMIC;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, THREADS, Layout<HD>::DYNAMIC);
}

}  // namespace dinox_bwd
