// The SwiGLU gate of DINOv3's feed-forward, forward and backward, for Hopper
// (sm_90a). Two launches: dinox_swiglu_fwd and dinox_swiglu_bwd.
//
// Replaces no TPU kernel: the JAX package's MLP is a GELU one. The function,
// on the fused W1/W2 product's output h = [u | g] (rows of 2H, bf16):
//   z  = silu(u) * g,                       silu(u) = u / (1 + exp(-u))
//   du = dz * g * silu'(u),   dg = dz * silu(u),
//   silu'(u) = sigma (1 + u (1 - sigma)),   sigma = 1 / (1 + exp(-u))
// each computed in f32 from the bf16 inputs and rounded once to bf16. Run
// eagerly in PyTorch the forward is ~5 launches with f32 temporaries of the
// full width and the backward ~10; these move what the function needs.
//
// Bound: device memory. At DINOv3 ViT-7B's training shape (16,704 rows, H
// 8192) the forward reads h and writes z, 822 MB (245 us at 3.35 TB/s); the
// backward reads h and dz and writes dh, 1.37 GB (409 us). The design: a
// grid-stride loop over 8-column vectors of a row's H, each thread loading
// the 16-byte pieces of u and g (and dz) and storing z (or du and dg) with
// 16-byte stores; the exponentials with expf, no fast-math. H a multiple of
// 8; operands 16-byte aligned. No atomics: the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void unpack(uint4 u, float (&o)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    o[2 * t] = f.x;
    o[2 * t + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&o)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(o[2 * t], o[2 * t + 1]);
  return u;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(THREADS)
dinox_swiglu_fwd(const __nv_bfloat16* __restrict__ h, __nv_bfloat16* __restrict__ z, long long rows,
                 int hidden) {
  const int per_row = hidden / 8;
  const long long total = rows * per_row;
  for (long long v = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = v / per_row;
    const int c = 8 * static_cast<int>(v - r * per_row);
    const __nv_bfloat16* row = h + r * 2 * hidden;
    float u[8], g[8], o[8];
    unpack(*reinterpret_cast<const uint4*>(row + c), u);
    unpack(*reinterpret_cast<const uint4*>(row + hidden + c), g);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __fmul_rn(u[i] / (1.f + expf(-u[i])), g[i]);
    *reinterpret_cast<uint4*>(z + r * hidden + c) = pack(o);
  }
}

__global__ void __launch_bounds__(THREADS)
dinox_swiglu_bwd(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ dz,
                 __nv_bfloat16* __restrict__ dh, long long rows, int hidden) {
  const int per_row = hidden / 8;
  const long long total = rows * per_row;
  for (long long v = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = v / per_row;
    const int c = 8 * static_cast<int>(v - r * per_row);
    const __nv_bfloat16* row = h + r * 2 * hidden;
    float u[8], g[8], d[8], du[8], dg[8];
    unpack(*reinterpret_cast<const uint4*>(row + c), u);
    unpack(*reinterpret_cast<const uint4*>(row + hidden + c), g);
    unpack(*reinterpret_cast<const uint4*>(dz + r * hidden + c), d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = sigmoid(u[i]);
      const float silu = __fmul_rn(u[i], s);
      const float dsilu = __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(u[i], __fsub_rn(1.f, s))));
      du[i] = __fmul_rn(__fmul_rn(d[i], g[i]), dsilu);
      dg[i] = __fmul_rn(d[i], silu);
    }
    __nv_bfloat16* out = dh + r * 2 * hidden;
    *reinterpret_cast<uint4*>(out + c) = pack(du);
    *reinterpret_cast<uint4*>(out + hidden + c) = pack(dg);
  }
}

int grid_for(long long vectors) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (vectors + THREADS - 1) / THREADS;
  const long long cap = 8LL * sms;  // eight CTAs of 256 an SM
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// h: (rows, 2 * hidden) bf16 [u | g]; z: (rows, hidden) bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dinox_swiglu_fwd_bf16(const void* h, void* z, long long rows, int hidden,
                                     void* stream) {
  if (hidden % 8 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  dinox_swiglu_fwd<<<grid_for(rows * (hidden / 8)), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(z), rows, hidden);
  return static_cast<int>(cudaGetLastError());
}

// h: (rows, 2 * hidden) bf16; dz: (rows, hidden) bf16; dh: (rows, 2 * hidden)
// bf16 [du | dg].
extern "C" int dinox_swiglu_bwd_bf16(const void* h, const void* dz, void* dh, long long rows,
                                     int hidden, void* stream) {
  if (hidden % 8 || rows < 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  dinox_swiglu_bwd<<<grid_for(rows * (hidden / 8)), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(dz),
      static_cast<__nv_bfloat16*>(dh), rows, hidden);
  return static_cast<int>(cudaGetLastError());
}
