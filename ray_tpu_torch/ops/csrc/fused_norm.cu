// Fused LayerNorm forward/backward and tanh-GELU forward/backward for Hopper
// (sm_90a), the counterparts of the Pallas kernels in ray_tpu/ops/fused_norm.py.
//
// Built by ray_tpu_torch/ops/_build.py into a shared library with a plain C
// interface and bound with ctypes from ray_tpu_torch/ops/fused_norm.py. Every
// launcher takes raw device pointers and a cudaStream_t, launches on that
// stream, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// I/O is float or __nv_bfloat16 (dtype code 0 or 1); all arithmetic is fp32.
//
// All four kernels are bound by device-memory bytes, not by operations: a
// LayerNorm does ~8-14 fp32 operations per element it reads, GELU ~20, far
// below the ~20 operations per byte at which the H100's fp32 units, let alone
// its tensor cores, become the limit. So the designs aim at moving each byte
// once: 16-byte vector loads where the row width allows, rows held in registers
// between the reduction and the write, and statistics kept in fp32 registers
// instead of an fp32 copy of the activations in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Widest LayerNorm row the kernels take: a thread holds kElems elements of a
// row in registers and a row is spread over at most kMaxRowThreads threads.
// The launch bound leaves a thread 128 registers, room for the backward's
// four kElems arrays without spilling.
constexpr int kElems = 16;
constexpr int kMaxRowThreads = 512;
constexpr int kMaxD = kElems * kMaxRowThreads;
// Threads a row kernel's CTA aims for: narrow rows share a CTA.
constexpr int kCtaThreads = 256;
// Rows whose dscale/dbias partials one ln_bwd CTA sums into its partial row.
// A multiple of every rows-per-CTA the launcher picks (1, 2, 4 or 8).
constexpr int kBwdRows = 16;

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* out) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f(pk.v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* in) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int j = 0; j < VEC; ++j) pk.v[j] = from_f<T>(in[j]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the blockDim.x threads that share a row (threadIdx.y picks the
// row). Every thread of the CTA calls it the same number of times: when a row
// spans several warps it synchronises the CTA. red holds 32 floats per row.
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if (blockDim.x == 32) return v;
  float* r = red + threadIdx.y * 32;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? r[lane] : 0.f);
}

// ---------------------------------------------------------------------------
// ln_fwd: replaces _ln_fwd_kernel (ray_tpu/ops/fused_norm.py:121).
//
// A row of D elements is spread over blockDim.x threads (a multiple of 32),
// each holding up to kElems elements in registers; blockDim.y rows share a
// CTA. The row is read once: the mean and the centered variance mean((x-mu)^2)
// are two passes over registers, each a warp-shuffle (plus shared-memory when
// the row spans warps) reduction. Writes y, and mu and rstd as [R] fp32 -- the
// only statistics the backward needs (8 bytes per row).
// Bound: bytes, 2*R*D*sizeof(T) + 8*R (+ scale and bias, 8*D).
// ---------------------------------------------------------------------------
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads) ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias, T* __restrict__ y,
                              float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int rows, int d,
                              float eps) {
  constexpr int NV = kElems / VEC;
  __shared__ float red[8 * 32];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const size_t off = (size_t)(live ? row : 0) * d;

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * VEC;
    if (live && c < d) {
      load<T, VEC>(x + off + c, v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum += v[k][j];
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
    }
  }
  const float mu = row_sum(sum, red) / d;

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * VEC;
    if (live && c < d) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = v[k][j] - mu;
        sq += t * t;
      }
    }
  }
  const float rstd = rsqrtf(row_sum(sq, red) / d + eps);
  if (!live) return;  // no barrier follows

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * VEC;
    if (c < d) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = (v[k][j] - mu) * rstd * scale[c + j] + bias[c + j];
      store<T, VEC>(y + off + c, o);
    }
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// ---------------------------------------------------------------------------
// ln_bwd: replaces the LayerNorm variant of _norm_bwd_kernel
// (ray_tpu/ops/fused_norm.py:184), in two phases inside one kernel.
//
// (a) Per row, x-hat is rebuilt from the saved fp32 mu and rstd; the two row
//     reductions c1 = mean(dy*scale) and c2 = mean(dy*scale*x-hat) give
//     dx = rstd*(dy*scale - c1 - x-hat*c2), plus the residual cotangent dres
//     when its pointer is not null.
// (b) Each CTA owns kBwdRows consecutive rows. A thread owns the same columns
//     in every row it visits, so it sums dy*x-hat and dy for them in registers;
//     the CTA's row groups are then added in a fixed order through shared
//     memory and written as one [D] fp32 partial row for dscale and one for
//     dbias. The caller sums the [n_blocks, D] partials. No atomics: the result
//     is the same on every run.
// Bound: bytes, 4*R*D*sizeof(T) with dres (3 reads, 1 write) + 8*R + partials.
// ---------------------------------------------------------------------------
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads) ln_bwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const float* __restrict__ scale,
                              const T* __restrict__ dy,
                              const T* __restrict__ dres, T* __restrict__ dx,
                              float* __restrict__ dscale_part,
                              float* __restrict__ dbias_part, int rows,
                              int d) {
  constexpr int NV = kElems / VEC;
  __shared__ float red[8 * 32];
  __shared__ float comb[2][kElems * kCtaThreads];

  float acc_s[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_s[k][j] = acc_b[k][j] = 0.f;

  const int row0 = blockIdx.x * kBwdRows;
  // The same trip count for every thread keeps row_sum's barriers aligned.
  for (int r = threadIdx.y; r < kBwdRows; r += blockDim.y) {
    const int row = row0 + r;
    const bool live = row < rows;
    const size_t off = (size_t)(live ? row : 0) * d;
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;

    float xh[NV][VEC], g[NV][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * blockDim.x + threadIdx.x) * VEC;
      if (live && c < d) {
        load<T, VEC>(x + off + c, xh[k]);
        load<T, VEC>(dy + off + c, g[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          xh[k][j] = (xh[k][j] - mu) * rs;
          const float dxh = g[k][j] * scale[c + j];
          s1 += dxh;
          s2 += dxh * xh[k][j];
          acc_s[k][j] += g[k][j] * xh[k][j];
          acc_b[k][j] += g[k][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xh[k][j] = g[k][j] = 0.f;
      }
    }
    const float c1 = row_sum(s1, red) / d;
    const float c2 = row_sum(s2, red) / d;
    if (!live) continue;

#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * blockDim.x + threadIdx.x) * VEC;
      if (c < d) {
        float o[VEC];
        if (dres != nullptr) {
          load<T, VEC>(dres + off + c, o);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) o[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] += rs * (g[k][j] * scale[c + j] - c1 - xh[k][j] * c2);
        store<T, VEC>(dx + off + c, o);
      }
    }
  }

  // Phase (b): row group 0 adds the others' column sums, in order 1..Y-1.
  const int slot = threadIdx.x * kElems;
  for (int y = 1; y < (int)blockDim.y; ++y) {
    __syncthreads();
    if ((int)threadIdx.y == y) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          comb[0][slot + k * VEC + j] = acc_s[k][j];
          comb[1][slot + k * VEC + j] = acc_b[k][j];
        }
    }
    __syncthreads();
    if (threadIdx.y == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc_s[k][j] += comb[0][slot + k * VEC + j];
          acc_b[k][j] += comb[1][slot + k * VEC + j];
        }
    }
  }
  if (threadIdx.y != 0) return;
  const size_t prow = (size_t)blockIdx.x * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * blockDim.x + threadIdx.x) * VEC;
    if (c < d) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        dscale_part[prow + c + j] = acc_s[k][j];
        dbias_part[prow + c + j] = acc_b[k][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// gelu_fwd / gelu_bwd: replace _gelu_fwd_kernel and _gelu_bwd_kernel
// (ray_tpu/ops/fused_norm.py:278, :284). Grid-stride elementwise passes over
// VEC-element packs (16 bytes when the length and the pointers allow it). The
// backward recomputes tanh from the saved pre-activation instead of reading a
// saved fp32 tanh.
// Bound: bytes, 2*n*sizeof(T) forward, 3*n*sizeof(T) backward.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float gelu_f(float x) {
  const float t = tanhf(kGeluC * (x + kGeluA * x * x * x));
  return 0.5f * x * (1.f + t);
}

__device__ __forceinline__ float gelu_grad_f(float x) {
  const float t = tanhf(kGeluC * (x + kGeluA * x * x * x));
  const float du = kGeluC * (1.f + 3.f * kGeluA * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

template <typename T, int VEC>
__global__ void gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int64_t n_vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    float v[VEC];
    load<T, VEC>(x + i * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = gelu_f(v[j]);
    store<T, VEC>(y + i * VEC, v);
  }
}

template <typename T, int VEC>
__global__ void gelu_bwd_kernel(const T* __restrict__ x,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int64_t n_vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    float v[VEC], gv[VEC];
    load<T, VEC>(x + i * VEC, v);
    load<T, VEC>(g + i * VEC, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = gv[j] * gelu_grad_f(v[j]);
    store<T, VEC>(dx + i * VEC, v);
  }
}

// ---------------------------------------------------------------------------
// Launch geometry
// ---------------------------------------------------------------------------
bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Threads per row: enough that no thread holds more than kElems elements,
// rounded up to whole warps.
int row_threads(int d, int vec) {
  const int nvec = (d + vec - 1) / vec;
  const int per_thread = kElems / vec;
  const int t = (nvec + per_thread - 1) / per_thread;
  return t <= 32 ? 32 : (t + 31) / 32 * 32;
}

dim3 row_block(int d, int vec) {
  const int tpr = row_threads(d, vec);
  const int per_cta = tpr >= kCtaThreads ? 1 : kCtaThreads / tpr;
  // Keep rows-per-CTA a power of two so it divides kBwdRows.
  int y = 1;
  while (y * 2 <= per_cta) y *= 2;
  return dim3(tpr, y);
}

template <typename T>
cudaError_t ln_fwd_launch(const void* x, const void* scale, const void* bias,
                          void* y, void* mean, void* rstd, int rows, int d,
                          float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(y);
  const dim3 block = row_block(d, vec ? V : 1);
  const dim3 grid((rows + block.y - 1) / block.y);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps);
  };
  if (vec)
    args(ln_fwd_kernel<T, V>);
  else
    args(ln_fwd_kernel<T, 1>);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_bwd_launch(const void* x, const void* mean, const void* rstd,
                          const void* scale, const void* dy, const void* dres,
                          void* dx, void* dscale_part, void* dbias_part,
                          int rows, int d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dres) && aligned16(dx);
  const dim3 block = row_block(d, vec ? V : 1);
  const dim3 grid((rows + kBwdRows - 1) / kBwdRows);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(scale),
        static_cast<const T*>(dy), static_cast<const T*>(dres),
        static_cast<T*>(dx), static_cast<float*>(dscale_part),
        static_cast<float*>(dbias_part), rows, d);
  };
  if (vec)
    args(ln_bwd_kernel<T, V>);
  else
    args(ln_bwd_kernel<T, 1>);
  return cudaGetLastError();
}

int elementwise_grid(int64_t n_vec, int threads) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n_vec + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 16;
  return (int)(want < cap ? want : cap);
}

template <typename T>
cudaError_t gelu_launch(const void* x, const void* g, void* out, int64_t n,
                        cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const bool vec = n % V == 0 && aligned16(x) && aligned16(g) && aligned16(out);
  const int64_t n_vec = vec ? n / V : n;
  const int grid = elementwise_grid(n_vec, kThreads);
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(g);
  T* os = static_cast<T*>(out);
  if (g == nullptr) {
    if (vec)
      gelu_fwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(xs, os, n_vec);
    else
      gelu_fwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xs, os, n_vec);
  } else {
    if (vec)
      gelu_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(xs, gs, os, n_vec);
    else
      gelu_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xs, gs, os, n_vec);
  }
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. dtype: 0 = float32, 1 = bfloat16. Scale, bias, mean, rstd and
// the partials are always float32. A zero-size call launches nothing.
// ---------------------------------------------------------------------------
extern "C" {

int rt_ln_max_d() { return kMaxD; }

int rt_ln_bwd_rows_per_block() { return kBwdRows; }

cudaError_t rt_ln_fwd(const void* x, const void* scale, const void* bias,
                      void* y, void* mean, void* rstd, int rows, int d,
                      float eps, int dtype, void* stream) {
  if (rows < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ln_fwd_launch<float>(x, scale, bias, y, mean, rstd, rows, d, eps, s);
  if (dtype == 1)
    return ln_fwd_launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, rows, d,
                                        eps, s);
  return cudaErrorInvalidValue;
}

cudaError_t rt_ln_bwd(const void* x, const void* mean, const void* rstd,
                      const void* scale, const void* dy, const void* dres,
                      void* dx, void* dscale_part, void* dbias_part, int rows,
                      int d, int dtype, void* stream) {
  if (rows < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ln_bwd_launch<float>(x, mean, rstd, scale, dy, dres, dx,
                                dscale_part, dbias_part, rows, d, s);
  if (dtype == 1)
    return ln_bwd_launch<__nv_bfloat16>(x, mean, rstd, scale, dy, dres, dx,
                                        dscale_part, dbias_part, rows, d, s);
  return cudaErrorInvalidValue;
}

cudaError_t rt_gelu_fwd(const void* x, void* y, long long n, int dtype,
                        void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gelu_launch<float>(x, nullptr, y, n, s);
  if (dtype == 1) return gelu_launch<__nv_bfloat16>(x, nullptr, y, n, s);
  return cudaErrorInvalidValue;
}

cudaError_t rt_gelu_bwd(const void* x, const void* g, void* dx, long long n,
                        int dtype, void* stream) {
  if (n < 0 || g == nullptr) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gelu_launch<float>(x, g, dx, n, s);
  if (dtype == 1) return gelu_launch<__nv_bfloat16>(x, g, dx, n, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
