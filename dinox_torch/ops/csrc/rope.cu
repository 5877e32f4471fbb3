// Axial 2D rotary positions (DINOv3's RoPE) on the q and k of the patch
// tokens of a packed (B, N, 3*dim) [q|k|v] row block, forward and backward,
// for Hopper (sm_90a). Two launches: dinox_rope_fwd and dinox_rope_bwd.
//
// Replaces no TPU kernel: the JAX package has no rotary positions. The
// function, for each head's hd columns of q and of k, in pairs (j, j + hd/2)
// with the patch's angle theta_j (the angles are tiled twice over hd):
//   q'_j        = q_j cos theta_j        - q_{j+hd/2} sin theta_j
//   q'_{j+hd/2} = q_{j+hd/2} cos theta_j + q_j sin theta_j
// i.e. q cos + rot(q) sin with rot(q) = [-q_hi, q_lo], each product and the
// sum rounded to f32 on their own (no fused multiply-add, as the plain
// version computes them), then rounded once to bf16. The rows of tokens
// outside [first, first + patches) of each image (CLS and the registers)
// and the v columns are not rotated. The backward is the transpose, the
// rotation by -theta, of the incoming gradient.
//
// Bound: device memory. At DINOv3 ViT-7B's training shape (64 views, 261
// tokens, 256 patches, dim 4096) the forward reads and writes the q and k
// columns of the patch rows, 2 x 268 MB (160 us at 3.35 TB/s), in place; the
// backward reads the whole incoming gradient and writes the whole outgoing
// one, 2 x 411 MB (245 us), out of place, so that the gradient autograd hands
// over is left as it was. The design: one CTA per row, each thread a pair of
// 16-byte vectors (8 columns of the low and of the high half of one head's
// q or k) and the pair's 8 angles' cos and sin (f32, two 16-byte loads each,
// from an L2-resident (patches, hd/2) table). hd/2 a multiple of 8; operands
// 16-byte aligned. No atomics: the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Bf8 {
  uint4 u;
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      o[2 * t] = f.x;
      o[2 * t + 1] = f.y;
    }
  }
  __device__ __forceinline__ void set(const float (&o)[8]) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(o[2 * t], o[2 * t + 1]);
  }
};

// Rotates the 8-column pieces lo (at p) and hi (at p + half) by the angles
// whose cos and sin start at c and s; sign -1 rotates by -theta.
__device__ __forceinline__ void rotate(const __nv_bfloat16* src, __nv_bfloat16* dst, int half,
                                       const float* c, const float* s, float sign) {
  Bf8 lo, hi;
  lo.u = *reinterpret_cast<const uint4*>(src);
  hi.u = *reinterpret_cast<const uint4*>(src + half);
  float l[8], h[8], cv[8], sv[8];
  lo.get(l);
  hi.get(h);
  *reinterpret_cast<float4*>(cv) = *reinterpret_cast<const float4*>(c);
  *reinterpret_cast<float4*>(cv + 4) = *reinterpret_cast<const float4*>(c + 4);
  *reinterpret_cast<float4*>(sv) = *reinterpret_cast<const float4*>(s);
  *reinterpret_cast<float4*>(sv + 4) = *reinterpret_cast<const float4*>(s + 4);
  float nl[8], nh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float si = sign * sv[i];  // exact: a sign flip
    nl[i] = __fsub_rn(__fmul_rn(l[i], cv[i]), __fmul_rn(h[i], si));
    nh[i] = __fadd_rn(__fmul_rn(h[i], cv[i]), __fmul_rn(l[i], si));
  }
  lo.set(nl);
  hi.set(nh);
  *reinterpret_cast<uint4*>(dst) = lo.u;
  *reinterpret_cast<uint4*>(dst + half) = hi.u;
}

// grid (patches, B): the q and k of one patch row, in place.
__global__ void __launch_bounds__(THREADS)
dinox_rope_fwd(__nv_bfloat16* __restrict__ qkv, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, int n, int first, int heads, int hd) {
  const int p = blockIdx.x;
  const int half = hd / 2;
  const int per_head = half / 8;
  const int items = 2 * heads * per_head;  // q and k
  __nv_bfloat16* row = qkv + (static_cast<long long>(blockIdx.y) * n + first + p) * 3 * heads * hd;
  const float* c = cos_t + static_cast<long long>(p) * half;
  const float* s = sin_t + static_cast<long long>(p) * half;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int head = it / per_head;  // 0 .. 2 * heads - 1: q's heads, then k's
    const int j = 8 * (it - head * per_head);
    __nv_bfloat16* at = row + head * hd + j;
    rotate(at, at, half, c + j, s + j, 1.f);
  }
}

// grid (N, B): one row of the outgoing gradient from the incoming one, the
// q and k of a patch row rotated by -theta, everything else copied.
__global__ void __launch_bounds__(THREADS)
dinox_rope_bwd(const __nv_bfloat16* __restrict__ din, __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t, int n, int first,
               int patches, int heads, int hd) {
  const int t = blockIdx.x;
  const int half = hd / 2;
  const int per_head = half / 8;
  const long long off = (static_cast<long long>(blockIdx.y) * n + t) * 3 * heads * hd;
  const __nv_bfloat16* src = din + off;
  __nv_bfloat16* dst = dout + off;
  const int p = t - first;
  const int rotated = (p >= 0 && p < patches) ? 2 * heads * per_head : 0;
  const float* c = cos_t + static_cast<long long>(p < 0 ? 0 : p) * half;
  const float* s = sin_t + static_cast<long long>(p < 0 ? 0 : p) * half;
  for (int it = threadIdx.x; it < rotated; it += THREADS) {
    const int head = it / per_head;
    const int j = 8 * (it - head * per_head);
    rotate(src + head * hd + j, dst + head * hd + j, half, c + j, s + j, -1.f);
  }
  const int from = rotated ? 2 * heads * hd / 8 : 0;  // 8-column vectors already written
  const int vectors = 3 * heads * hd / 8;
  for (int v = from + threadIdx.x; v < vectors; v += THREADS)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
}

}  // namespace

// qkv: (b, n, 3 * heads * hd) bf16, rotated in place at the rows [first,
// first + patches) of each image; cos, sin: (patches, hd / 2) f32. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int dinox_rope_fwd_bf16(void* qkv, const void* cos_t, const void* sin_t, int b, int n,
                                   int first, int patches, int heads, int hd, void* stream) {
  if (hd % 16 || patches <= 0 || first < 0 || first + patches > n) return cudaErrorInvalidValue;
  const dim3 grid(patches, b);
  dinox_rope_fwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), n, first, heads, hd);
  return static_cast<int>(cudaGetLastError());
}

// din, dout: (b, n, 3 * heads * hd) bf16, distinct; the rest as the forward.
extern "C" int dinox_rope_bwd_bf16(const void* din, void* dout, const void* cos_t, const void* sin_t,
                                   int b, int n, int first, int patches, int heads, int hd,
                                   void* stream) {
  if (hd % 16 || patches <= 0 || first < 0 || first + patches > n) return cudaErrorInvalidValue;
  const dim3 grid(n, b);
  dinox_rope_bwd<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(din), static_cast<__nv_bfloat16*>(dout),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), n, first, patches, heads,
      hd);
  return static_cast<int>(cudaGetLastError());
}
