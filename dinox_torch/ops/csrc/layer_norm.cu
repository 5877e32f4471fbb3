// LayerNorm of the port's blocks, forward and backward, for Hopper (sm_90a):
// flax's fast-variance LayerNorm over rows of width C, three launches.
//
// Replaces no TPU kernel: the JAX package leaves flax's LayerNorm to XLA,
// which fuses it into the neighbouring work. Run eagerly in PyTorch the same
// function is ~14 float32 launches forward and ~35 in autograd's backward,
// ~60 and ~150 bytes of device memory per element; these kernels move what
// the function needs, about 4 bytes forward and 6 backward for bf16 rows. The
// function, with gamma and beta f32 and x -> y bf16 -> bf16 (the block and
// ScaleEmbedding norms), bf16 -> f32 (the final and the MAE decoder norm) or
// f32 -> f32 (a float32 model's norms):
//   mean = sum(x) / C,  var = max(sum(x^2) / C - mean^2, 0),
//   rstd = rsqrt(var + eps),  y = round((x - mean) * (rstd * gamma) + beta)
// at the rounding points of the eager module (models/vit.LayerNorm: each
// product and sum rounded to f32 on its own, no fused multiply-add), and
//   dx = round(rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))),
//   dxh = dy * gamma, xhat = (x - mean) * rstd,
//   dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy,
// where the variance term is dropped for a row whose fast variance was
// clamped (clamp_min's gradient is 0 below its bound).
//
// Bound: device memory. At the ViT-S training shape (66,816 rows of 384,
// bf16) the forward reads x and writes y, 103 MB (31 us at 3.35 TB/s); the
// backward reads x and dy and writes dx, 154 MB (46 us). The design:
//   fwd:    a row belongs to a group of `tpr` threads (a power of two, the
//           fewest that hold the row in at most FWD_NV = 4 8-column vectors
//           a thread: 16 at C 384, 32 at 1024, 256 at 8192), read once with
//           16-byte loads and held in registers while both sums are taken in
//           the same pass (the fast variance allows it), then written once.
//           Groups of up to 32 threads sum by xor shuffles, wider ones add
//           their warps' sums in shared memory in warp order. One CTA per
//           256 / tpr rows (4,176 CTAs at both cells' shapes), registers
//           capped so that four CTAs of bf16 rows fit an SM. mean and rstd
//           (f32, rstd negated where the variance was clamped) are written
//           only when a backward follows.
//   bwd:    row groups of at most BWD_NV = 2 vectors a thread (32 threads at
//           C 384, 64 at 1024: fewer registers, so more CTAs an SM) over a
//           persistent grid (the SMs' resident CTAs); each row's x, dy and
//           statistics are loaded while the row before is worked; dx row by
//           row, and each thread's sums of dy * xhat and dy over its rows
//           and columns in registers, which the CTA's row groups add in a
//           fixed order into one partial row of dgamma and dbeta per CTA.
//   params: the partial rows added in a fixed order (eight interleaved runs
//           per column, then the runs in order): no atomics, so the same
//           inputs on the same card give the same bits.
// C a multiple of 8 from 8 to 8192; any number of rows; operands 16-byte
// aligned. Kernel names start with dinox_layer_norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FWD_NV = 4;        // 8-column vectors a thread holds of a row: forward
constexpr int BWD_NV = 2;        // backward, up to C = 4096 (FWD_NV above)
constexpr int MAX_C = 8 * FWD_NV * THREADS;
constexpr int PARAM_RUNS = 8;    // interleaved runs of the partial rows per column

template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      o[2 * t] = f.x;
      o[2 * t + 1] = f.y;
    }
  }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float (&o)[8]) const {
    o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w, o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
  }
};

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  Vec8<float> v;
  v.load(p);
  v.get(o);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// a and b summed over the tpr threads of a row group, the same bits in every
// thread of it. Groups of up to 32 threads are aligned runs of a warp: an xor
// butterfly. Wider groups are whole warps: each warp's sums meet in `red`
// and are added in warp order. Every thread of the CTA calls it alike.
__device__ __forceinline__ void group_sum2(float& a, float& b, int tpr, float2* red) {
  for (int o = (tpr < 32 ? tpr : 32) >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the last call's reads of red are done
    if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
    __syncthreads();
    const int first = warp & ~((tpr >> 5) - 1);
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < (tpr >> 5); ++w) {
      a += red[first + w].x;
      b += red[first + w].y;
    }
  }
}

// Resident CTAs a kernel is compiled for: the forward's registers cap at 64
// (bf16 rows) so four CTAs fit an SM; the backward's at 128.
template <typename TX>
constexpr int fwd_ctas() { return sizeof(TX) == 2 ? 4 : 3; }

template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS, fwd_ctas<TX>())
dinox_layer_norm_fwd_rows(const TX* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, TY* __restrict__ y,
                          float* __restrict__ mean, float* __restrict__ rstd, int m, int c, int tpr,
                          float eps) {
  __shared__ float2 red[THREADS / 32];
  const int sub = threadIdx.x & (tpr - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / tpr) + threadIdx.x / tpr;
  const bool live = row < m;
  const int vecs = c >> 3;
  Vec8<TX> v[FWD_NV];
#pragma unroll
  for (int i = 0; i < FWD_NV; ++i) {
    const int q = sub + tpr * i;
    if (live && q < vecs) v[i].load(x + row * c + 8 * q);
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < FWD_NV; ++i) {
    const int q = sub + tpr * i;
    if (live && q < vecs) {
      float f[8];
      v[i].get(f);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        s += f[t];
        ss += __fmul_rn(f[t], f[t]);
      }
    }
  }
  group_sum2(s, ss, tpr, red);
  if (live) {
    const float inv_c = 1.f / static_cast<float>(c);
    const float mu = s * inv_c;
    const float var = __fsub_rn(ss * inv_c, __fmul_rn(mu, mu));
    const float r = rsqrtf(__fadd_rn(fmaxf(var, 0.f), eps));
    if (rstd != nullptr && sub == 0) {
      mean[row] = mu;
      rstd[row] = var < 0.f ? -r : r;
    }
#pragma unroll
    for (int i = 0; i < FWD_NV; ++i) {
      const int q = sub + tpr * i;
      if (q < vecs) {
        float f[8], g[8], b[8], o[8];
        v[i].get(f);
        load8(gamma + 8 * q, g);
        load8(beta + 8 * q, b);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          o[t] = __fadd_rn(__fmul_rn(__fsub_rn(f[t], mu), __fmul_rn(r, g[t])), b[t]);
        store8(y + row * c + 8 * q, o);
      }
    }
  }
}

// dx of the rows blockIdx.x * groups + grp, stepping by gridDim.x * groups,
// each row's x, dy and statistics loaded while the row before is worked; and,
// where `part` is given, the CTA's partial row [dgamma | dbeta] (2 c floats)
// at part + blockIdx.x * 2 c. The row groups' sums meet in a fixed order:
// the groups inside a warp by xor shuffles, then the warps (or the row
// groups, where a row spans warps) one after another in shared memory, each
// 8-column vector at a pitch of 9 floats so that a warp's lanes hit 32 banks.
template <int NV, typename TX, typename TD>
__global__ void __launch_bounds__(THREADS, NV == BWD_NV ? 2 : 1)
dinox_layer_norm_bwd_rows(const TX* __restrict__ x, const float* __restrict__ gamma,
                          const TD* __restrict__ dy, const float* __restrict__ mean,
                          const float* __restrict__ rstd, TX* __restrict__ dx,
                          float* __restrict__ part, int m, int c, int tpr) {
  extern __shared__ float sums[];  // [2 c / 8][9], where the CTA has more than one unit
  __shared__ float2 red[THREADS / 32];
  const int groups = THREADS / tpr;
  const int sub = threadIdx.x & (tpr - 1), grp = threadIdx.x / tpr;
  const int vecs = c >> 3;
  const float inv_c = 1.f / static_cast<float>(c);
  const long long stride = static_cast<long long>(gridDim.x) * groups;
  float sg[NV][8], sb[NV][8];  // this thread's sums of dy * xhat and dy
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) sg[i][t] = sb[i][t] = 0.f;
  Vec8<TX> nx[NV];
  Vec8<TD> nd[NV];
  float nmu = 0.f, nrs = 0.f;
  long long base = static_cast<long long>(blockIdx.x) * groups;
  {
    const long long row = base + grp;
    if (row < m) {
      nmu = mean[row];
      nrs = rstd[row];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int q = sub + tpr * i;
      if (row < m && q < vecs) {
        nx[i].load(x + row * c + 8 * q);
        nd[i].load(dy + row * c + 8 * q);
      }
    }
  }
  for (; base < m; base += stride) {
    const long long row = base + grp, next = row + stride;
    const bool live = row < m;
    const float mu = nmu, rs = nrs;
    Vec8<TX> xv[NV];
    Vec8<TD> dv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[i] = nx[i];
      dv[i] = nd[i];
    }
    if (next < m) {
      nmu = mean[next];
      nrs = rstd[next];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int q = sub + tpr * i;
      if (next < m && q < vecs) {
        nx[i].load(x + next * c + 8 * q);
        nd[i].load(dy + next * c + 8 * q);
      }
    }
    const float r = fabsf(rs);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int q = sub + tpr * i;
      if (live && q < vecs) {
        float f[8], d[8], g[8];
        xv[i].get(f);
        dv[i].get(d);
        load8(gamma + 8 * q, g);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float xh = __fmul_rn(__fsub_rn(f[t], mu), r);
          const float dh = __fmul_rn(d[t], g[t]);
          s1 += dh;
          s2 += dh * xh;
          sg[i][t] += d[t] * xh;
          sb[i][t] += d[t];
        }
      }
    }
    group_sum2(s1, s2, tpr, red);
    if (live) {
      const float a1 = s1 * inv_c;
      const float a2 = rs < 0.f ? 0.f : s2 * inv_c;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int q = sub + tpr * i;
        if (q < vecs) {
          float f[8], d[8], g[8], o[8];
          xv[i].get(f);
          dv[i].get(d);
          load8(gamma + 8 * q, g);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float xh = __fmul_rn(__fsub_rn(f[t], mu), r);
            o[t] = r * (__fmul_rn(d[t], g[t]) - a1 - xh * a2);
          }
          store8(dx + row * c + 8 * q, o);
        }
      }
    }
  }
  if (part == nullptr) return;
  for (int o = tpr; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        sg[i][t] += __shfl_xor_sync(0xffffffffu, sg[i][t], o);
        sb[i][t] += __shfl_xor_sync(0xffffffffu, sb[i][t], o);
      }
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * c;
  const int units = tpr < 32 ? THREADS / 32 : groups;
  if (units == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int q = sub + tpr * i;
      if (q < vecs) {
        store8(out + 8 * q, sg[i]);
        store8(out + c + 8 * q, sb[i]);
      }
    }
    return;
  }
  const int unit = tpr < 32 ? threadIdx.x >> 5 : grp;
  const bool writes = tpr >= 32 || (threadIdx.x & 31) < tpr;
  for (int k = 0; k < units; ++k) {
    if (unit == k && writes) {
      float ag[NV][8], ab[NV][8];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int q = sub + tpr * i;
        if (q < vecs)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            ag[i][t] = k ? sums[9 * q + t] : 0.f;
            ab[i][t] = k ? sums[9 * (vecs + q) + t] : 0.f;
          }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int q = sub + tpr * i;
        if (q < vecs)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            sums[9 * q + t] = ag[i][t] + sg[i][t];
            sums[9 * (vecs + q) + t] = ab[i][t] + sb[i][t];
          }
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < 2 * c; j += THREADS) out[j] = sums[9 * (j >> 3) + (j & 7)];
}

// dgamma and dbeta from `parts` partial rows of 2 c floats: 32 columns a
// CTA, each column's rows in PARAM_RUNS interleaved runs, the runs added in
// order.
__global__ void __launch_bounds__(THREADS)
dinox_layer_norm_bwd_params_sum(const float* __restrict__ part, float* __restrict__ dgamma,
                                float* __restrict__ dbeta, int parts, int c) {
  __shared__ float runs[PARAM_RUNS][32];
  const int lane = threadIdx.x & 31, run = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < 2 * c)
    for (int p = run; p < parts; p += PARAM_RUNS) s += part[static_cast<long long>(p) * 2 * c + col];
  runs[run][lane] = s;
  __syncthreads();
  if (run == 0 && col < 2 * c) {
    float t = runs[0][lane];
#pragma unroll
    for (int k = 1; k < PARAM_RUNS; ++k) t += runs[k][lane];
    if (col < c)
      dgamma[col] = t;
    else
      dbeta[col - c] = t;
  }
}

bool takes(int c) { return c % 8 == 0 && c >= 8 && c <= MAX_C; }

// The dtype pairs the kernels are built for: f32 rows only to f32.
bool pair(int x_f32, int y_f32) { return !x_f32 || y_f32; }

// Threads per row: the fewest (a power of two) that hold the row's c / 8
// vectors at nv a thread. A thread's vector slots past the row stay idle,
// so one kernel per dtype pair serves every width (a build of seconds).
int threads_per_row(int c, int nv) {
  int t = 1;
  while (t * nv < c / 8) t <<= 1;
  return t;
}

// The backward holds BWD_NV vectors a thread (fewer registers, more CTAs an
// SM) up to the widths 256 threads cover so, FWD_NV past them.
int bwd_nv(int c) { return c / 8 <= BWD_NV * THREADS ? BWD_NV : FWD_NV; }

template <typename TX, typename TY>
void launch_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
                int m, int c, float eps, cudaStream_t stream) {
  const int tpr = threads_per_row(c, FWD_NV);
  const int groups = THREADS / tpr;
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(m) + groups - 1) / groups);
  dinox_layer_norm_fwd_rows<TX, TY><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<TY*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), m, c, tpr, eps);
}

template <typename TX, typename TD>
using BwdKernel = void (*)(const TX*, const float*, const TD*, const float*, const float*, TX*,
                           float*, int, int, int);

template <typename TX, typename TD>
BwdKernel<TX, TD> bwd_kernel(int c) {
  return bwd_nv(c) == BWD_NV ? dinox_layer_norm_bwd_rows<BWD_NV, TX, TD>
                             : dinox_layer_norm_bwd_rows<FWD_NV, TX, TD>;
}

// Shared memory of a backward CTA: the padded [dgamma | dbeta] sums where
// more than one warp or row group meets in it.
int bwd_smem(int c, bool partials) {
  const int tpr = threads_per_row(c, bwd_nv(c));
  return partials && tpr < THREADS ? 9 * c : 0;
}

// The backward's grid: the SMs' resident CTAs of the kernel for c, or fewer
// where the rows need fewer.
template <typename TX, typename TD>
cudaError_t bwd_grid_of(int m, int c, int* grid) {
  const int groups = THREADS / threads_per_row(c, bwd_nv(c));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel<TX, TD>(c), THREADS,
                                                        bwd_smem(c, true));
  if (err != cudaSuccess) return err;
  const long long need = (static_cast<long long>(m) + groups - 1) / groups;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(need < slots ? (need > 0 ? need : 1) : slots);
  return cudaSuccess;
}

template <typename TX, typename TD>
void launch_bwd(const void* x, const void* gamma, const void* dy, const void* mean, const void* rstd,
                void* dx, void* part, int m, int c, int grid, cudaStream_t stream) {
  const BwdKernel<TX, TD> kernel = bwd_kernel<TX, TD>(c);
  kernel<<<grid, THREADS, bwd_smem(c, part != nullptr), stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(gamma), static_cast<const TD*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<TX*>(dx),
      static_cast<float*>(part), m, c, threads_per_row(c, bwd_nv(c)));
}

}  // namespace

// y = LayerNorm(x) over m rows of c; x and y bf16, or f32 where x_f32 /
// y_f32 (not f32 rows to bf16); mean and rstd (m floats each) written
// unless null. Returns a cudaError_t.
extern "C" int dinox_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                    void* mean, void* rstd, int m, int c, int x_f32, int y_f32,
                                    float eps, void* stream) {
  if (!takes(c) || !pair(x_f32, y_f32) || m < 0 || (mean == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    launch_fwd<float, float>(x, gamma, beta, y, mean, rstd, m, c, eps, s);
  else if (y_f32)
    launch_fwd<__nv_bfloat16, float>(x, gamma, beta, y, mean, rstd, m, c, eps, s);
  else
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, mean, rstd, m, c, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// The backward's grid (CTAs, and so partial rows) for m rows of c on the
// current device.
extern "C" int dinox_layer_norm_bwd_grid(int m, int c, int x_f32, int dy_f32, int* grid) {
  if (!takes(c) || !pair(x_f32, dy_f32) || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_f32)
    err = bwd_grid_of<float, float>(m, c, grid);
  else if (dy_f32)
    err = bwd_grid_of<__nv_bfloat16, float>(m, c, grid);
  else
    err = bwd_grid_of<__nv_bfloat16, __nv_bfloat16>(m, c, grid);
  return static_cast<int>(err);
}

// dx (x's dtype) of m rows of c from x, dy (bf16, or f32 where dy_f32;
// f32 where x is) and the forward's mean and rstd, over `grid` CTAs
// (dinox_layer_norm_bwd_grid); with `part`, each CTA's partial row of
// [dgamma | dbeta] (grid x 2c floats).
extern "C" int dinox_layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                                    const void* mean, const void* rstd, void* dx, void* part, int m,
                                    int c, int x_f32, int dy_f32, int grid, void* stream) {
  if (!takes(c) || !pair(x_f32, dy_f32) || m < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    launch_bwd<float, float>(x, gamma, dy, mean, rstd, dx, part, m, c, grid, s);
  else if (dy_f32)
    launch_bwd<__nv_bfloat16, float>(x, gamma, dy, mean, rstd, dx, part, m, c, grid, s);
  else
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, dy, mean, rstd, dx, part, m, c, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// dgamma and dbeta (c floats each) from `parts` partial rows.
extern "C" int dinox_layer_norm_bwd_params(const void* part, void* dgamma, void* dbeta, int parts,
                                           int c, void* stream) {
  if (!takes(c) || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  dinox_layer_norm_bwd_params_sum<<<(2 * c + 31) / 32, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dgamma), static_cast<float*>(dbeta), parts,
      c);
  return static_cast<int>(cudaGetLastError());
}
