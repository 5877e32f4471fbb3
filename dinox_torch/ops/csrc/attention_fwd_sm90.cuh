// The forward attention tile core for Hopper (sm_90a), shared by
// packed_attention.cu (TPU kernel 1) and mha_attention.cu (TPU kernel 4).
//
// One CTA computes softmax(q k^T * scale) v for 64 query rows of one
// (batch, head). Its threads are one consumer warpgroup, which owns the 64
// query rows, and one producer warp:
//   - the producer warp's first lane loads the Q tile once, then streams
//     64-row K/V tiles into a ring of STAGES shared-memory buffers by TMA
//     (cp.async.bulk.tensor), each completion reported to a "full" mbarrier;
//     it waits on the stage's "empty" mbarrier before reusing it, so the next
//     tile is in flight while the consumer computes;
//   - the consumer warpgroup runs S = Q K^T with wgmma (m64nKWk16, bf16 x
//     bf16 -> f32, both operands from shared memory), the softmax on the
//     accumulator fragment in registers (row max and row sum with quad
//     shuffles), converts P to bf16 in registers and feeds it as the register
//     A operand of O += P V (m64nHDPk16, V the shared-memory B operand read
//     transposed). S, P and O never go through shared memory.
// Shared memory is written by TMA with the 64-byte swizzle (boxes of 32
// columns x 64 rows) and read by wgmma through descriptors of the same
// swizzle, so operand reads have no bank conflicts. Head dims 32, 64, 88
// and 128 (88 is zero-padded to 96 by TMA's out-of-bounds fill: the maps'
// innermost extent is exactly hd, so no column of a neighbouring head is
// read).
//
// The ragged edge: TMA zero-fills K/V rows past N, and a zero K row would give
// a logit of 0, so key columns >= N are set to -inf before the row max. The
// last key tile is multiplied at the narrowest width that covers it (16, 32
// or 64 keys): at N = 261 the keys are padded to 272, not 320. The grid holds
// ceil(N / 64) query blocks, so no CTA's rows all lie past N; rows past N are
// never stored. No atomics: the same inputs give the same bits on every run.
//
// One consumer warpgroup per CTA, four CTAs per SM at hd <= 64, three at hd
// 88 and two at hd 128 (the O accumulator alone is 64 registers a thread
// there, and the Q tile and the K/V ring 80 KB of shared memory). Each product
// is waited for before the softmax that reads it (PERF.md records the
// variants that were measured slower on an H100).
//
// Two rounding modes, those of the two TPU kernels
// (dinox_tpu/ops/flash_attention.py):
//   Rounding::Packed (kernel 1, `_packed_kernel`): the scale is folded into q
//     and q rounded to bf16 (the consumer rescales the Q tile in shared
//     memory, then fences the async proxy before wgmma reads it); logits and
//     statistics f32; one pass with an online softmax; the unnormalised exp
//     is rounded to bf16 before PV and the division by the row sum comes
//     after PV.
//   Rounding::Normalised (kernel 4, `_mha_kernel`): the scale multiplies the
//     f32 logits and P = bf16(exp(s - m) / l) is normalised in f32 before it
//     is rounded, so the final m and l must exist before any P: two passes in
//     one launch, pass 1 streaming K only for m and l, pass 2 streaming K and
//     V. Pass 2 recomputes Q K^T rather than keeping the f32 S row block in
//     shared memory: that block would hold N x 64 x 4 bytes per CTA
//     (80 KB at N = 320, unbounded for the N = 1500 the kernel also takes),
//     which would cut the CTAs per SM and cap N.
// exp is computed as ex2((s - m) * log2(e)) and the normalisation as
// p * (1 / l): each may move the last f32 bit against the plain versions,
// which can flip a bf16 rounding of P (within the 0.02 gate).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace dinox_fwd {

enum class Rounding { Packed, Normalised };

constexpr int BLOCK_M = 64;              // query rows per CTA (the wgmma M)
constexpr int BLOCK_N = 64;              // key rows per K/V tile
constexpr int STAGES = 2;                // K/V ring depth
constexpr int THREADS = 5 * 32;          // one consumer warpgroup and one producer warp
constexpr int BOX_COLS = 32;             // 64 bytes of bf16: the 64B swizzle span
constexpr int BOX_BYTES = 64 * BOX_COLS * 2;  // one box of 64 rows
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BLOCK_M == 64 && BLOCK_N == 64, "one box shape serves the Q and K/V tiles");

template <int HD>
struct Smem {
  static constexpr int HDP = (HD + BOX_COLS - 1) / BOX_COLS * BOX_COLS;  // 32, 64, 96, 128
  static constexpr int BOXES = HDP / BOX_COLS;
  static constexpr int TILE = BOXES * BOX_BYTES;  // one Q, K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
  static constexpr int DYNAMIC = BYTES + 1024;  // slack to align the base to 1024 bytes
};

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A wgmma shared-memory descriptor for the 64-byte swizzle. K-major operands
// (Q, K): 8-row groups `sbo` = 512 bytes apart, `lbo` unused. MN-major (V):
// `lbo` = the distance between 32-column boxes, `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accesses of a wgmma accumulator across the
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64nN, f32) = A * B (+ D when acc != 0); A and B from shared memory,
// both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

// D (m64nN, f32) += A * B; A (m64k16 bf16) from registers, B from shared
// memory, MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- the tile core ------------------------------------------------------------

// S = Q K^T over the first KW rows of the K tile at `sk`.
template <int KW, int HDP>
__device__ __forceinline__ void qk(float (&s)[KW / 2], uint32_t sq, uint32_t sk) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t off = (kk >> 1) * BOX_BYTES + (kk & 1) * 32;
    wgmma_ss<KW>(s, desc64(sq + off, 16, 512), desc64(sk + off, 16, 512), kk);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_operands(s);
}

// O += P V over the first KW rows of the V tile at `sv`.
template <int KW, int HDP>
__device__ __forceinline__ void pv(float (&o)[HDP / 2], const uint32_t (&p)[KW / 16][4],
                                   uint32_t sv) {
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) wgmma_rs<HDP>(o, p[kk], desc64(sv + kk * 1024, BOX_BYTES, 512));
  wgmma_commit();
  wgmma_wait0();
  fence_operands(o);
}

// The consumer's softmax state. A thread holds two rows of the accumulator
// fragment (r = 0: row g, r = 1: row g + 8 of its warp's 16), and value i of
// an m64nN fragment sits at row r(i) = (i >> 1) & 1, column 8 * (i >> 2) +
// 2 * tq + (i & 1), tq = lane % 4.
struct RowState {
  float m[2];     // running max of the (scaled) logits
  float l[2];     // this thread's part of the row sum of exp(s - m)
  float rinv[2];  // 1 / the row sum (Normalised, pass 2)
};

// One key tile at width KW: pass 1 of Normalised when STATS (m and l only),
// else the tile's contribution to O.
template <int KW, int HD, Rounding R, bool STATS>
__device__ __forceinline__ void step(float (&o)[Smem<HD>::HDP / 2], RowState& st, uint32_t sq,
                                     uint32_t sk, uint32_t sv, uint32_t empty, int k0, int n,
                                     float scale, int tq, int lane) {
  constexpr int HDP = Smem<HD>::HDP;
  float s[KW / 2];
  qk<KW, HDP>(s, sq, sk);
  if constexpr (STATS) {
    if (lane == 0) mbar_arrive(empty);  // the K tile is no longer read
  }

  const bool ragged = k0 + KW > n;
#pragma unroll
  for (int i = 0; i < KW / 2; ++i) {
    float x = R == Rounding::Normalised ? s[i] * scale : s[i];
    if (ragged && k0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= n) x = -INFINITY;
    s[i] = x;
  }

  if constexpr (STATS || R == Rounding::Packed) {  // online max and sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KW / 2; ++i)
        if (((i >> 1) & 1) == r) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(st.m[r], mx);  // finite: every tile holds a key < N
      const float alpha = ex2((st.m[r] - m_new) * LOG2E);  // 0 on the first tile
      st.m[r] = m_new;
      st.l[r] *= alpha;
      if constexpr (!STATS) {
#pragma unroll
        for (int i = 0; i < HDP / 2; ++i)
          if (((i >> 1) & 1) == r) o[i] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ex2((s[i] - st.m[r]) * LOG2E);
      st.l[r] += p;
      s[i] = p;
    }
  } else {  // Normalised, pass 2: P normalised in f32
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2((s[i] - st.m[r]) * LOG2E) * st.rinv[r];
    }
  }
  if constexpr (!STATS) {
    // P to bf16 in registers, laid out as the m64k16 A fragments of PV.
    uint32_t p[KW / 16][4];
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    }
    pv<KW, HDP>(o, p, sv);
    if (lane == 0) mbar_arrive(empty);  // the K and V tiles are no longer read
  }
}

// The last key tile at the narrowest width that covers its rem keys.
template <int HD, Rounding R, bool STATS>
__device__ __forceinline__ void any_step(float (&o)[Smem<HD>::HDP / 2], RowState& st, uint32_t sq,
                                         uint32_t sk, uint32_t sv, uint32_t empty, int k0, int n,
                                         float scale, int tq, int lane) {
  const int rem = n - k0;
  if (rem > 32)
    step<64, HD, R, STATS>(o, st, sq, sk, sv, empty, k0, n, scale, tq, lane);
  else if (rem > 16)
    step<32, HD, R, STATS>(o, st, sq, sk, sv, empty, k0, n, scale, tq, lane);
  else
    step<16, HD, R, STATS>(o, st, sq, sk, sv, empty, k0, n, scale, tq, lane);
}

// Loads the Q, K or V tile of `row` into `dst`: BOXES boxes of 32 columns.
// Packed maps are (hd, 3 * heads, N, B) with `slot` the q, k or v head slot;
// head-major maps are (hd, N, H, B).
template <int HD, bool PACKED>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int slot, int row, int h, int b) {
#pragma unroll
  for (int j = 0; j < Smem<HD>::BOXES; ++j) {
    if constexpr (PACKED)
      tma_load_4d(dst + j * BOX_BYTES, map, bar, j * BOX_COLS, slot, row, b);
    else
      tma_load_4d(dst + j * BOX_BYTES, map, bar, j * BOX_COLS, row, h, b);
  }
}

// grid (ceil(N / 64), heads, B), THREADS threads,
// Smem<HD>::DYNAMIC bytes.
// `out` is the packed (B, N, heads * hd) output when PACKED, else the
// head-major (B, heads, N, hd) one.
template <int HD, Rounding R, bool PACKED>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 4 : HD <= 96 ? 3 : 2)
attention_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                   int n, int heads, float scale) {
  using S = Smem<HD>;
  constexpr int HDP = S::HDP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + S::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;  // one per stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BLOCK_M;
  const int tiles = (n + BLOCK_N - 1) / BLOCK_N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4);  // each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, S::TILE);
      load_tile<HD, PACKED>(base + S::Q_OFF, &map_q, bar_q, h, m0, h, b);
      constexpr int PASSES = R == Rounding::Normalised ? 2 : 1;
      int it = 0;
      for (int pass = 0; pass < PASSES; ++pass) {
        const bool with_v = pass == PASSES - 1;
        for (int t = 0; t < tiles; ++t, ++it) {
          const int s = it % STAGES;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, with_v ? 2 * S::TILE : S::TILE);
          load_tile<HD, PACKED>(base + S::K_OFF + s * S::TILE, &map_k, bar_full + 8 * s,
                                heads + h, t * BLOCK_N, h, b);
          if (with_v)
            load_tile<HD, PACKED>(base + S::V_OFF + s * S::TILE, &map_v, bar_full + 8 * s,
                                  2 * heads + h, t * BLOCK_N, h, b);
        }
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = m0 + warp * 16 + g;  // row r = 0; r = 1 is row0 + 8
  const uint32_t sq = base + S::Q_OFF;

  mbar_wait(bar_q, 0);
  if constexpr (R == Rounding::Packed) {  // fold the scale into q, rounded to bf16
    uint4* q4 = reinterpret_cast<uint4*>(smem + S::Q_OFF);
    for (int i = threadIdx.x; i < S::TILE / 16; i += 128) {
      uint4 v = q4[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      q4[i] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
    named_barrier(1, 128);  // the consumer's four warps
  }

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  RowState st = {{-INFINITY, -INFINITY}, {0.f, 0.f}, {0.f, 0.f}};
  int it = 0;
  if constexpr (R == Rounding::Normalised) {  // pass 1: m and l
    for (int t = 0; t < tiles; ++t, ++it) {
      const int s = it % STAGES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      const uint32_t sk = base + S::K_OFF + s * S::TILE;
      if (t * BLOCK_N + BLOCK_N <= n)
        step<64, HD, R, true>(o, st, sq, sk, 0, bar_empty + 8 * s, t * BLOCK_N, n, scale, tq, lane);
      else
        any_step<HD, R, true>(o, st, sq, sk, 0, bar_empty + 8 * s, t * BLOCK_N, n, scale, tq, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the full row sum, for the normalised P of pass 2
      float l = st.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      st.rinv[r] = 1.f / l;
    }
  }
  for (int t = 0; t < tiles; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
    const uint32_t sk = base + S::K_OFF + s * S::TILE;
    const uint32_t sv = base + S::V_OFF + s * S::TILE;
    if (t * BLOCK_N + BLOCK_N <= n)
      step<64, HD, R, false>(o, st, sq, sk, sv, bar_empty + 8 * s, t * BLOCK_N, n, scale, tq, lane);
    else
      any_step<HD, R, false>(o, st, sq, sk, sv, bar_empty + 8 * s, t * BLOCK_N, n, scale, tq, lane);
  }

  // Packed: the division by the row sum after PV.
  float post[2] = {1.f, 1.f};
  if constexpr (R == Rounding::Packed) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      post[r] = 1.f / l;
    }
  }
  const int pitch = PACKED ? heads * HD : HD;
  __nv_bfloat16* dst = PACKED ? out + (static_cast<long long>(b) * n) * pitch + h * HD
                              : out + (static_cast<long long>(b) * heads + h) * n * HD;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    if (8 * j >= HD) break;  // hd 88: the zero columns 88-95
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < n)
        *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(row) * pitch + 8 * j + 2 * tq) =
            pack_bf16(o[4 * j + 2 * r] * post[r], o[4 * j + 2 * r + 1] * post[r]);
    }
  }
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 4-D bf16 tensor map with the 64-byte swizzle: `dims` innermost first,
// `strides` the byte strides of dims 1-3, `box` the tile. Out-of-bounds
// elements load as zeros. cuTensorMapEncodeTiled belongs to libcuda's API:
// it is reached through the runtime's entry-point query, so the library is
// not linked against libcuda.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                              const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a packed (B, N, 3 * heads * hd) qkv: (hd, 3 * heads, N, B), q, k
// and v of head h in slots h, heads + h and 2 * heads + h. Its innermost
// extent is exactly hd, so hd 88 is zero-padded to 96 without touching the
// next head.
template <int HD>
cudaError_t encode_packed_map(CUtensorMap* map, const void* qkv, int b, int n, int heads) {
  const cuuint64_t row = 6ull * heads * HD;  // bytes of one packed row
  const cuuint64_t dims[4] = {HD, 3ull * heads, static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {2ull * HD, row, row * n};
  const cuuint32_t box[4] = {BOX_COLS, 1, BLOCK_N, 1};
  return encode_map(map, qkv, dims, strides, box);
}

template <int HD, Rounding R, bool PACKED>
cudaError_t launch_fwd(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, void* out,
                       int b, int heads, int n, float scale, cudaStream_t stream) {
  auto kernel = attention_fwd_sm90<HD, R, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<HD>::DYNAMIC);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK_M - 1) / BLOCK_M, heads, b);
  kernel<<<grid, THREADS, Smem<HD>::DYNAMIC, stream>>>(q, k, v, static_cast<__nv_bfloat16*>(out),
                                                      n, heads, scale);
  return cudaGetLastError();
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs per
// SM of one instantiation, from the CUDA occupancy API.
template <int HD, Rounding R, bool PACKED>
cudaError_t occupancy(int* regs, int* smem, int* ctas) {
  auto kernel = attention_fwd_sm90<HD, R, PACKED>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<HD>::DYNAMIC);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = Smem<HD>::DYNAMIC;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, THREADS, Smem<HD>::DYNAMIC);
}

}  // namespace dinox_fwd
