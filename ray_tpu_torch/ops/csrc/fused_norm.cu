// Fused LayerNorm and RMSNorm forward/backward and tanh-GELU forward/backward
// for Hopper (sm_90a), the counterparts of the Pallas kernels in
// ray_tpu/ops/fused_norm.py.
//
// Built by ray_tpu_torch/ops/_build.py into a shared library with a plain C
// interface and bound with ctypes from ray_tpu_torch/ops/fused_norm.py. Every
// launcher takes raw device pointers and a cudaStream_t, launches on that
// stream, allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
//
// I/O is float or __nv_bfloat16 (dtype code 0 or 1); all arithmetic is fp32.
//
// All six kernels are bound by device-memory bytes, not by operations: a
// LayerNorm does ~8-14 fp32 operations per element it reads, GELU ~20, far
// below the ~20 operations per byte at which the H100's fp32 units, let alone
// its tensor cores, become the limit. So the designs aim at moving each byte
// once: 16-byte vector loads where the row width allows, rows held in registers
// between the reduction and the write, and statistics kept in fp32 registers
// instead of an fp32 copy of the activations in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// One-warp rows (rms_fwd, ln_fwd, ln_bwd, rms_bwd): a lane holds up to
// kLaneElems elements, so a warp takes rows up to kWarpMaxD wide; the
// forward kernels put kWarpRows rows (warps) in a CTA.
constexpr int kLaneElems = 32;
constexpr int kWarpMaxD = 32 * kLaneElems;
constexpr int kWarpRows = 8;
// Rows whose column partials one backward CTA sums into its partial row
// (one [D] fp32 row of dscale, and for LayerNorm one of dbias): ln_bwd's
// kLnBwdWarps warps walk a block of kLnBwdRows rows, rms_bwd's kRmsBwdWarps
// warps a block of kRmsBwdRows. Both blocks are multiples of every
// rows-per-CTA that the multi-warp body's launcher picks (1, 2, 4 or 8).
// Each is the fastest of 16, 32 or 64 rows with 4 or 8 warps at its main
// path's width on an H100 (PERF.md): for rms_bwd at D = 1024, 128 CTAs of
// 8 warps, one an SM at its 164 registers a lane.
constexpr int kLnBwdRows = 32;
constexpr int kLnBwdWarps = 4;
constexpr int kRmsBwdRows = 64;
constexpr int kRmsBwdWarps = 8;
// norm_bwd_sum's row groups: a CTA sums 32 columns of the partial rows with
// kSumGroups warps, each over every kSumGroups-th row.
constexpr int kSumGroups = 16;
// gelu_bwd: threads a CTA, each owning one 16-byte pack.
constexpr int kGeluThreads = 128;

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

// VEC fp32 values of scale at p, as float4 loads where VEC allows (p then
// 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      out[j] = f.x;
      out[j + 1] = f.y;
      out[j + 2] = f.z;
      out[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = p[j];
  }
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
// The multi-warp row body of the forward: ln_fwd (ln_fwd_wide_kernel) and
// rms_fwd (rms_fwd_wide_kernel, RMS = true) for rows wider than kWarpMaxD;
// narrower rows take the one-warp kernels below.
//
// A row of D elements is spread over blockDim.x threads (a multiple of 32),
// each holding up to kElems elements in registers; blockDim.y rows share a
// CTA. The row is read once: the mean and the centered variance mean((x-mu)^2)
// are two passes over registers, each a warp-shuffle (plus shared-memory when
// the row spans warps) reduction. Writes y, and mu and rstd as [R] fp32 -- the
// only statistics the backward needs (8 bytes per row).
// The RMS variant skips the mean: one reduction, rstd = rsqrt(mean(x^2) + eps),
// y = x * rstd * scale; bias and mean_out are unused (null) and only rstd is
// written (4 bytes per row).
// Bound: bytes, 2*R*D*sizeof(T) + 8*R (+ scale and bias, 8*D); RMS 4*R + 4*D.
// ---------------------------------------------------------------------------
template <typename T, int VEC, bool RMS>
__device__ __forceinline__ void norm_fwd(const T* __restrict__ x,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias,
                                         T* __restrict__ y,
                                         float* __restrict__ mean_out,
                                         float* __restrict__ rstd_out,
                                         int rows, int d, float eps) {
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
  float mu = 0.f;
  if constexpr (!RMS) mu = row_sum(sum, red) / d;

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
      for (int j = 0; j < VEC; ++j) {
        if constexpr (RMS)
          o[j] = v[k][j] * rstd * scale[c + j];
        else
          o[j] = (v[k][j] - mu) * rstd * scale[c + j] + bias[c + j];
      }
      store<T, VEC>(y + off + c, o);
    }
  }
  if (threadIdx.x == 0) {
    if constexpr (!RMS) mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// Two entry points over one body, so that a profile names them apart.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads)
    ln_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int rows, int d,
                       float eps) {
  norm_fwd<T, VEC, false>(x, scale, bias, y, mean_out, rstd_out, rows, d, eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads)
    rms_fwd_wide_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ y,
                        float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, int rows, int d,
                        float eps) {
  norm_fwd<T, VEC, true>(x, scale, bias, y, mean_out, rstd_out, rows, d, eps);
}

// ---------------------------------------------------------------------------
// ln_fwd: replaces _ln_fwd_kernel (ray_tpu/ops/fused_norm.py:121), and
// rms_fwd: replaces _rms_fwd_kernel (:137), for rows up to kWarpMaxD wide
// (GPT-2 small's 768 and Llama small's 1024 included).
//
// One warp a row: a lane holds NV chunks of VEC elements in registers, all
// loaded before the first reduction (at D = 768 bf16, three 16-byte loads:
// the launcher picks NV from the width, so no lane carries a dead chunk).
// Every reduction is a warp shuffle alone -- no shared memory and no
// barrier, so the kWarpRows rows of a CTA run independently.
// LayerNorm: mu = mean(x), then the centered variance mean((x-mu)^2) from
// registers (as the reference computes it, not E[x^2] - mu^2),
// rstd = rsqrt(var + eps), y = (x - mu) * rstd * scale + bias; lane 0 writes
// mu and rstd. RMS: rstd = rsqrt(mean(x^2) + eps), y = x * rstd * scale, and
// rstd alone (rms_fwd keeps NV = kLaneElems / VEC, as it was built).
// scale and bias are read as float4 where VEC allows; LayerNorm issues
// those loads with the row's, before the reductions, where VEC > 1
// (rms_fwd reads scale after its reduction, as it was built).
// Bound: bytes, as the multi-warp body above.
// ---------------------------------------------------------------------------
template <typename T, int VEC, int NV, bool RMS>
__device__ __forceinline__ void warp_norm_fwd(const T* __restrict__ x,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              T* __restrict__ y,
                                              float* __restrict__ mean_out,
                                              float* __restrict__ rstd_out,
                                              int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // no barrier follows
  const size_t off = (size_t)row * d;

  float v[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * 32 + lane) * VEC;
    if (c < d) {
      load<T, VEC>(x + off + c, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = 0.f;
    }
  }
  // LayerNorm's scale and bias, in flight during the reductions where the
  // rows are vectorised (registers are short for the element-wise rows).
  constexpr bool kEarly = !RMS && VEC > 1;
  float ws[kEarly ? NV : 1][VEC], bs[kEarly ? NV : 1][VEC];
  if constexpr (kEarly) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * 32 + lane) * VEC;
      if (c < d) {
        load_scale<VEC>(scale + c, ws[k]);
        load_scale<VEC>(bias + c, bs[k]);
      }
    }
  }
  float mu = 0.f;
  if constexpr (!RMS) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) sum += v[k][j];
    mu = warp_sum(sum) / d;
  }
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    // The zeros past the row's end add nothing to x^2, but would add mu^2.
    if (RMS || (k * 32 + lane) * VEC < d) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = RMS ? v[k][j] : v[k][j] - mu;
        sq += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * 32 + lane) * VEC;
    if (c < d) {
      float o[VEC];
      if constexpr (RMS) {
        float w[VEC];
        load_scale<VEC>(scale + c, w);
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = v[k][j] * rstd * w[j];
      } else {
        float w[VEC], b[VEC];
        if constexpr (kEarly) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            w[j] = ws[k][j];
            b[j] = bs[k][j];
          }
        } else {
          load_scale<VEC>(scale + c, w);
          load_scale<VEC>(bias + c, b);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = (v[k][j] - mu) * rstd * w[j] + b[j];
      }
      store<T, VEC>(y + off + c, o);
    }
  }
  if (lane == 0) {
    if constexpr (!RMS) mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kWarpRows * 32)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int d, float eps) {
  warp_norm_fwd<T, VEC, NV, false>(x, scale, bias, y, mean_out, rstd_out,
                                   rows, d, eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpRows * 32)
    rms_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd_out, int rows,
                   int d, float eps) {
  warp_norm_fwd<T, VEC, kLaneElems / VEC, true>(x, scale, nullptr, y, nullptr,
                                                rstd_out, rows, d, eps);
}

// ---------------------------------------------------------------------------
// The multi-warp row body of the backward: ln_bwd (ln_bwd_wide_kernel) and
// rms_bwd (rms_bwd_wide_kernel, RMS = true) for rows wider than kWarpMaxD
// or not readable 16 bytes at a time; their other rows take the one-warp
// body below. Two phases inside one kernel:
//
// (a) Per row, x-hat is rebuilt from the saved fp32 mu and rstd; the two row
//     reductions c1 = mean(dy*scale) and c2 = mean(dy*scale*x-hat) give
//     dx = rstd*(dy*scale - c1 - x-hat*c2), plus the residual cotangent dres
//     when its pointer is not null. RMS: mu = 0 and no c1, x-hat = x*rstd,
//     dx = rstd*(dy*scale - x-hat*c2) (+ dres), and only the dscale partials
//     (mean and dbias_part are unused, null).
// (b) Each CTA owns ROWS consecutive rows. A thread owns the same columns
//     in every row it visits, so it sums dy*x-hat and dy for them in registers;
//     the CTA's row groups are then added in a fixed order through shared
//     memory and written as one [D] fp32 partial row for dscale and one for
//     dbias. norm_bwd_sum adds the [n_blocks, D] partials. No atomics: the
//     result is the same on every run.
// Bound: bytes, 4*R*D*sizeof(T) with dres (3 reads, 1 write) + 8*R + partials
// (RMS: 4*R and one partial row per CTA).
// ---------------------------------------------------------------------------
template <typename T, int VEC, bool RMS, int ROWS>
__device__ __forceinline__ void norm_bwd(const T* __restrict__ x,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ rstd,
                                         const float* __restrict__ scale,
                                         const T* __restrict__ dy,
                                         const T* __restrict__ dres,
                                         T* __restrict__ dx,
                                         float* __restrict__ dscale_part,
                                         float* __restrict__ dbias_part,
                                         int rows, int d) {
  constexpr int NV = kElems / VEC;
  __shared__ float red[8 * 32];
  __shared__ float comb[RMS ? 1 : 2][kElems * kCtaThreads];  // dscale(, dbias)

  float acc_s[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_s[k][j] = acc_b[k][j] = 0.f;

  const int row0 = blockIdx.x * ROWS;
  // The same trip count for every thread keeps row_sum's barriers aligned.
  for (int r = threadIdx.y; r < ROWS; r += blockDim.y) {
    const int row = row0 + r;
    const bool live = row < rows;
    const size_t off = (size_t)(live ? row : 0) * d;
    const float mu = (live && !RMS) ? mean[row] : 0.f;
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
          s2 += dxh * xh[k][j];
          acc_s[k][j] += g[k][j] * xh[k][j];
          if constexpr (!RMS) {
            s1 += dxh;
            acc_b[k][j] += g[k][j];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xh[k][j] = g[k][j] = 0.f;
      }
    }
    float c1 = 0.f;
    if constexpr (!RMS) c1 = row_sum(s1, red) / d;
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
          if constexpr (!RMS) comb[1][slot + k * VEC + j] = acc_b[k][j];
        }
    }
    __syncthreads();
    if (threadIdx.y == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc_s[k][j] += comb[0][slot + k * VEC + j];
          if constexpr (!RMS) acc_b[k][j] += comb[1][slot + k * VEC + j];
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
        if constexpr (!RMS) dbias_part[prow + c + j] = acc_b[k][j];
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads)
    ln_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const float* __restrict__ scale,
                       const T* __restrict__ dy, const T* __restrict__ dres,
                       T* __restrict__ dx, float* __restrict__ dscale_part,
                       float* __restrict__ dbias_part, int rows, int d) {
  norm_bwd<T, VEC, false, kLnBwdRows>(x, mean, rstd, scale, dy, dres, dx,
                                      dscale_part, dbias_part, rows, d);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxRowThreads)
    rms_bwd_wide_kernel(const T* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ scale,
                        const T* __restrict__ dy, const T* __restrict__ dres,
                        T* __restrict__ dx, float* __restrict__ dscale_part,
                        float* __restrict__ dbias_part, int rows, int d) {
  norm_bwd<T, VEC, true, kRmsBwdRows>(x, mean, rstd, scale, dy, dres, dx,
                                      dscale_part, dbias_part, rows, d);
}

// ---------------------------------------------------------------------------
// ln_bwd and rms_bwd: replace the LayerNorm and the RMSNorm variants of
// _norm_bwd_kernel (ray_tpu/ops/fused_norm.py:184) for rows up to kWarpMaxD
// wide whose pointers allow 16-byte loads (GPT-2 small's 768 and Llama
// small's 1024 included). One body, warp_norm_bwd, with two entry points
// (ln_bwd_kernel, rms_bwd_kernel) so that a profile names them apart.
//
// One warp a row, WARPS warps a CTA, and each warp walks every WARPS-th row
// of its CTA's block of ROWS rows. A lane owns the same NV chunks of VEC
// columns in every row (NV picked from the width, as in ln_fwd), so it
// holds its scale values and its dscale (sum of dy*x-hat) column sums -- and
// for LayerNorm its dbias (sum of dy) ones -- in fp32 registers across the
// rows. Per row, every load (x, dy, dres, mu, rstd) is issued before the
// row's reductions, into packed 16-byte vectors that are widened to fp32
// where they are used. c2 = mean(dy*scale*x-hat), and for LayerNorm
// c1 = mean(dy*scale), are warp-shuffle sums -- no shared memory and no
// barrier -- and dx = rstd*(dy*scale - c1 - x-hat*c2) (+ dres); RMS reads
// no mu, x-hat = x*rstd and c1 = 0.
// At the end the CTA's warps add their column sums in warp order through
// shared memory and write one [D] fp32 partial row each of dscale (and
// dbias); norm_bwd_sum then adds the [n_blocks, D] partials. No atomics:
// the same result on every run.
// Bound: bytes, 4*R*D*sizeof(T) with dres (3 reads, 1 write) + 8*R + 4*D +
// 8*D per partial row (RMS: 4*R, and 4*D per partial row).
// ---------------------------------------------------------------------------

// An empty asm that claims to rewrite every 32-bit word of p: what the
// compiler derived from p before it is derived again after it.
template <typename P>
__device__ __forceinline__ void opaque(P& p) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(P) / 4); ++i) asm volatile("" : "+r"(w[i]));
}

template <typename T, int VEC, int NV, bool RMS, int ROWS, int WARPS>
__device__ __forceinline__ void warp_norm_bwd(
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ rstd, const float* __restrict__ scale,
    const T* __restrict__ dy, const T* __restrict__ dres, T* __restrict__ dx,
    float* __restrict__ dscale_part, float* __restrict__ dbias_part, int rows,
    int d) {
  using P = Pack<T, VEC>;
  __shared__ float comb[WARPS * kWarpMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float sc[NV][VEC], acc_s[NV][VEC], acc_b[RMS ? 1 : NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (k * 32 + lane) * VEC;
    if (c < d) {
      load_scale<VEC>(scale + c, sc[k]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sc[k][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc_s[k][j] = 0.f;
      if constexpr (!RMS) acc_b[k][j] = 0.f;
    }
  }

  const int end = min(rows, (int)(blockIdx.x + 1) * ROWS);
  for (int row = blockIdx.x * ROWS + warp; row < end; row += WARPS) {
    const size_t off = (size_t)row * d;
    const float mu = RMS ? 0.f : mean[row];
    const float rs = rstd[row];
    P xp[NV], gp[NV], rp[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * 32 + lane) * VEC;
      if (c < d) {
        xp[k] = *reinterpret_cast<const P*>(x + off + c);
        gp[k] = *reinterpret_cast<const P*>(dy + off + c);
        if (dres != nullptr) rp[k] = *reinterpret_cast<const P*>(dres + off + c);
      }
    }
    // x-hat of one element of the packed row.
    auto xhat = [&](const P& p, int j) {
      if constexpr (RMS)
        return to_f(p.v[j]) * rs;
      else
        return (to_f(p.v[j]) - mu) * rs;
    };

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if ((k * 32 + lane) * VEC < d) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = xhat(xp[k], j);
          const float g = to_f(gp[k].v[j]);
          const float dxh = g * sc[k][j];
          if constexpr (!RMS) s1 += dxh;
          s2 += dxh * xh;
          acc_s[k][j] += g * xh;
          if constexpr (!RMS) acc_b[k][j] += g;
        }
      }
    }
    const float c1 = RMS ? 0.f : warp_sum(s1) / d;
    const float c2 = warp_sum(s2) / d;
    // Widen x and dy again below instead of holding x-hat and dy*scale in
    // fp32 registers across the reductions: fewer live registers (160
    // against 188 for ln_bwd at D = 768 bf16) and a faster kernel (PERF.md).
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      opaque(xp[k]);
      opaque(gp[k]);
    }

#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * 32 + lane) * VEC;
      if (c < d) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = xhat(xp[k], j);
          const float g = to_f(gp[k].v[j]);
          o[j] = dres != nullptr ? to_f(rp[k].v[j]) : 0.f;
          if constexpr (RMS)
            o[j] += rs * (g * sc[k][j] - xh * c2);
          else
            o[j] += rs * (g * sc[k][j] - c1 - xh * c2);
        }
        store<T, VEC>(dx + off + c, o);
      }
    }
  }

  // The warps' column sums, added in warp order: dscale, then dbias.
  auto fold = [&](const float (&acc)[NV][VEC], float* __restrict__ part) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (k * 32 + lane) * VEC;
      if (c < d) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) comb[warp * d + c + j] = acc[k][j];
      }
    }
    __syncthreads();
    part += (size_t)blockIdx.x * d;
    for (int c = threadIdx.x; c < d; c += WARPS * 32) {
      float s = comb[c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += comb[w * d + c];
      part[c] = s;
    }
    __syncthreads();  // the readers are done before comb is written again
  };
  fold(acc_s, dscale_part);
  if constexpr (!RMS) fold(acc_b, dbias_part);
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kLnBwdWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ rstd,
                  const float* __restrict__ scale, const T* __restrict__ dy,
                  const T* __restrict__ dres, T* __restrict__ dx,
                  float* __restrict__ dscale_part,
                  float* __restrict__ dbias_part, int rows, int d) {
  warp_norm_bwd<T, VEC, NV, false, kLnBwdRows, kLnBwdWarps>(
      x, mean, rstd, scale, dy, dres, dx, dscale_part, dbias_part, rows, d);
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kRmsBwdWarps * 32)
    rms_bwd_kernel(const T* __restrict__ x, const float* __restrict__ rstd,
                   const float* __restrict__ scale, const T* __restrict__ dy,
                   const T* __restrict__ dres, T* __restrict__ dx,
                   float* __restrict__ dscale_part, int rows, int d) {
  warp_norm_bwd<T, VEC, NV, true, kRmsBwdRows, kRmsBwdWarps>(
      x, nullptr, rstd, scale, dy, dres, dx, dscale_part, nullptr, rows, d);
}

// ---------------------------------------------------------------------------
// norm_bwd_sum: the column sums of a backward's k partial arrays,
// out[a][c] = sum over the n rows r of parts[a][r][c] -- ln_bwd's dscale
// and dbias (k = 2), rms_bwd's dscale (k = 1) -- taken outside the row
// kernel as the reference takes its partials' sum outside its Pallas
// kernel. A CTA owns 32 columns of one array (blockIdx.y): warp g adds
// rows g, g + kSumGroups, ... in order, and warp 0 adds the kSumGroups
// sums in order, so the result is the same on every run. The partials were
// just written and come from L2; torch.sum over the middle axis of the
// same [k, n, D] tensor took 2-3x as long.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSumGroups * 32)
    norm_bwd_sum_kernel(const float* __restrict__ parts, int n, int d,
                        float* __restrict__ out) {
  __shared__ float red[kSumGroups][32];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* p = parts + (size_t)blockIdx.y * n * d;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int r = grp; r < n; r += kSumGroups) s += p[(size_t)r * d + c];
  }
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && c < d) {
#pragma unroll
    for (int g = 1; g < kSumGroups; ++g) s += red[g][lane];
    out[(size_t)blockIdx.y * d + c] = s;
  }
}

// ---------------------------------------------------------------------------
// gelu_fwd / gelu_bwd: replace _gelu_fwd_kernel and _gelu_bwd_kernel
// (ray_tpu/ops/fused_norm.py:278, :284). The backward recomputes tanh from
// the saved pre-activation instead of reading a saved fp32 tanh.
// Bound: bytes, 2*n*sizeof(T) forward, 3*n*sizeof(T) backward.
// ---------------------------------------------------------------------------
// tanh(u) as 1 - 2 / (1 + e^(2u)) with the fast exp and division, in both
// GELU kernels: an absolute error of the order of fp32's 6e-8 near 1 (an
// overflowing e^(2u) gives 1 exactly), which the fp32 checks (1e-5 forward,
// 1e-4 backward) and the bf16 one (one ulp) hold. At [8192, 3072] bf16 on
// an H100 it took 1 us off gelu_bwd and 1.8 us off gelu_fwd against tanhf;
// in fp32 gelu_fwd it was level with tanhf, within 1% (PERF.md, PRs 7-8).
__device__ __forceinline__ float exp_tanh(float u) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * u));
}

__device__ __forceinline__ float gelu_f(float x) {
  const float t = exp_tanh(kGeluC * (x + kGeluA * x * x * x));
  return 0.5f * x * (1.f + t);
}

__device__ __forceinline__ float gelu_grad_f(float x) {
  const float t = exp_tanh(kGeluC * (x + kGeluA * x * x * x));
  const float du = kGeluC * (1.f + 3.f * kGeluA * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

// gelu_fwd: gelu_bwd's geometry (below) with one input: a grid that covers
// the n_vec = n / VEC packs once, one pack a thread, 128 threads a CTA; the
// threads past the last pack take the n % VEC elements after it, one each.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGeluThreads)
    gelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  using P = Pack<T, VEC>;
  const int64_t n_vec = n / VEC;
  const int64_t i = (int64_t)blockIdx.x * kGeluThreads + threadIdx.x;
  if (i < n_vec) {
    const P xv = reinterpret_cast<const P*>(x)[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f<T>(gelu_f(to_f(xv.v[j])));
    reinterpret_cast<P*>(y)[i] = o;
    return;
  }
  const int64_t e = n_vec * VEC + (i - n_vec);
  if (e < n) y[e] = from_f<T>(gelu_f(to_f(x[e])));
}

// gelu_bwd: one pass, with a grid that covers the n_vec = n / VEC packs
// once, one pack a thread, x and g loaded before any arithmetic. The
// threads past the last pack take the n % VEC elements after it, one
// each. The geometry is the fastest of those timed (PERF.md): one pack a
// thread and 128 threads a CTA beat 2 or 4 packs a thread, 64 to 512
// threads, the grid-stride loop it replaces, and evict-first
// (ld/st.global.cs) or read-only (ld.global.nc) loads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGeluThreads)
    gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int64_t n) {
  using P = Pack<T, VEC>;
  const int64_t n_vec = n / VEC;
  const int64_t i = (int64_t)blockIdx.x * kGeluThreads + threadIdx.x;
  if (i < n_vec) {
    const P xv = reinterpret_cast<const P*>(x)[i];
    const P gv = reinterpret_cast<const P*>(g)[i];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f<T>(to_f(gv.v[j]) * gelu_grad_f(to_f(xv.v[j])));
    reinterpret_cast<P*>(dx)[i] = o;
    return;
  }
  const int64_t e = n_vec * VEC + (i - n_vec);
  if (e < n) dx[e] = from_f<T>(to_f(g[e]) * gelu_grad_f(to_f(x[e])));
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
  // Keep rows-per-CTA a power of two so it divides kLnBwdRows and
  // kRmsBwdRows.
  int y = 1;
  while (y * 2 <= per_cta) y *= 2;
  return dim3(tpr, y);
}

// f(std::integral_constant<int, NV>{}) for the least NV in [1, MAX] that is
// at least nv: the one-warp kernels' chunks a lane, fixed at compile time.
template <int MAX, int NV = 1, typename F>
void with_nv(int nv, F&& f) {
  if constexpr (NV < MAX) {
    if (nv > NV) return with_nv<MAX, NV + 1>(nv, f);
  }
  f(std::integral_constant<int, NV>{});
}

// The multi-warp forward rows (rows wider than kWarpMaxD).
template <typename T, bool RMS>
cudaError_t norm_fwd_wide_launch(const void* x, const void* scale,
                                 const void* bias, void* y, void* mean,
                                 void* rstd, int rows, int d, float eps,
                                 cudaStream_t stream) {
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
  if constexpr (RMS) {
    if (vec)
      args(rms_fwd_wide_kernel<T, V>);
    else
      args(rms_fwd_wide_kernel<T, 1>);
  } else {
    if (vec)
      args(ln_fwd_wide_kernel<T, V>);
    else
      args(ln_fwd_wide_kernel<T, 1>);
  }
  return cudaGetLastError();
}

// ln_fwd: one warp a row up to kWarpMaxD, the multi-warp rows past it.
template <typename T>
cudaError_t ln_fwd_launch(const void* x, const void* scale, const void* bias,
                          void* y, void* mean, void* rstd, int rows, int d,
                          float eps, cudaStream_t stream) {
  if (d > kWarpMaxD)
    return norm_fwd_wide_launch<T, false>(x, scale, bias, y, mean, rstd, rows,
                                          d, eps, stream);
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(scale) && aligned16(bias);
  const int grid = (rows + kWarpRows - 1) / kWarpRows;
  auto args = [&](auto kernel) {
    kernel<<<grid, kWarpRows * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, eps);
  };
  if (vec)
    with_nv<kLaneElems / V>((d / V + 31) / 32, [&](auto nv) {
      args(ln_fwd_kernel<T, V, decltype(nv)::value>);
    });
  else
    args(ln_fwd_kernel<T, 1, kLaneElems>);
  return cudaGetLastError();
}

// rms_fwd: one warp a row up to kWarpMaxD, the multi-warp rows past it.
template <typename T>
cudaError_t rms_fwd_launch(const void* x, const void* scale, void* y,
                           void* rstd, int rows, int d, float eps,
                           cudaStream_t stream) {
  if (d > kWarpMaxD)
    return norm_fwd_wide_launch<T, true>(x, scale, nullptr, y, nullptr, rstd,
                                         rows, d, eps, stream);
  constexpr int V = 16 / sizeof(T);
  const bool vec =
      d % V == 0 && aligned16(x) && aligned16(y) && aligned16(scale);
  const int grid = (rows + kWarpRows - 1) / kWarpRows;
  auto args = [&](auto kernel) {
    kernel<<<grid, kWarpRows * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(y), static_cast<float*>(rstd), rows, d, eps);
  };
  if (vec)
    args(rms_fwd_kernel<T, V>);
  else
    args(rms_fwd_kernel<T, 1>);
  return cudaGetLastError();
}

// The multi-warp backward rows: rows wider than kWarpMaxD or not readable
// 16 bytes at a time.
template <typename T, bool RMS>
cudaError_t norm_bwd_wide_launch(const void* x, const void* mean,
                                 const void* rstd, const void* scale,
                                 const void* dy, const void* dres, void* dx,
                                 void* dscale_part, void* dbias_part, int rows,
                                 int d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kRows = RMS ? kRmsBwdRows : kLnBwdRows;
  const bool vec = d % V == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dres) && aligned16(dx);
  const dim3 block = row_block(d, vec ? V : 1);
  const dim3 grid((rows + kRows - 1) / kRows);
  auto args = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(scale),
        static_cast<const T*>(dy), static_cast<const T*>(dres),
        static_cast<T*>(dx), static_cast<float*>(dscale_part),
        static_cast<float*>(dbias_part), rows, d);
  };
  if constexpr (RMS) {
    if (vec)
      args(rms_bwd_wide_kernel<T, V>);
    else
      args(rms_bwd_wide_kernel<T, 1>);
  } else {
    if (vec)
      args(ln_bwd_wide_kernel<T, V>);
    else
      args(ln_bwd_wide_kernel<T, 1>);
  }
  return cudaGetLastError();
}

// True where the one-warp backward takes the rows: up to kWarpMaxD wide,
// with every row pointer and scale readable 16 bytes at a time.
template <typename T>
bool warp_bwd_rows(int d, const void* x, const void* scale, const void* dy,
                   const void* dres, const void* dx) {
  constexpr int V = 16 / sizeof(T);
  return d <= kWarpMaxD && d % V == 0 && aligned16(x) && aligned16(dy) &&
         aligned16(dres) && aligned16(dx) && aligned16(scale);
}

// ln_bwd: one warp a row where warp_bwd_rows allows, the multi-warp rows
// otherwise.
template <typename T>
cudaError_t ln_bwd_launch(const void* x, const void* mean, const void* rstd,
                          const void* scale, const void* dy, const void* dres,
                          void* dx, void* dscale_part, void* dbias_part,
                          int rows, int d, cudaStream_t stream) {
  if (!warp_bwd_rows<T>(d, x, scale, dy, dres, dx))
    return norm_bwd_wide_launch<T, false>(x, mean, rstd, scale, dy, dres, dx,
                                          dscale_part, dbias_part, rows, d,
                                          stream);
  constexpr int V = 16 / sizeof(T);
  const int grid = (rows + kLnBwdRows - 1) / kLnBwdRows;
  with_nv<kLaneElems / V>((d / V + 31) / 32, [&](auto nv) {
    ln_bwd_kernel<T, V, decltype(nv)::value>
        <<<grid, kLnBwdWarps * 32, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(mean),
            static_cast<const float*>(rstd), static_cast<const float*>(scale),
            static_cast<const T*>(dy), static_cast<const T*>(dres),
            static_cast<T*>(dx), static_cast<float*>(dscale_part),
            static_cast<float*>(dbias_part), rows, d);
  });
  return cudaGetLastError();
}

// rms_bwd: one warp a row where warp_bwd_rows allows, the multi-warp rows
// otherwise; both write one partial row per kRmsBwdRows rows.
template <typename T>
cudaError_t rms_bwd_launch(const void* x, const void* rstd, const void* scale,
                           const void* dy, const void* dres, void* dx,
                           void* dscale_part, int rows, int d,
                           cudaStream_t stream) {
  if (!warp_bwd_rows<T>(d, x, scale, dy, dres, dx))
    return norm_bwd_wide_launch<T, true>(x, nullptr, rstd, scale, dy, dres,
                                         dx, dscale_part, nullptr, rows, d,
                                         stream);
  constexpr int V = 16 / sizeof(T);
  const int grid = (rows + kRmsBwdRows - 1) / kRmsBwdRows;
  with_nv<kLaneElems / V>((d / V + 31) / 32, [&](auto nv) {
    rms_bwd_kernel<T, V, decltype(nv)::value>
        <<<grid, kRmsBwdWarps * 32, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const float*>(rstd),
            static_cast<const float*>(scale), static_cast<const T*>(dy),
            static_cast<const T*>(dres), static_cast<T*>(dx),
            static_cast<float*>(dscale_part), rows, d);
  });
  return cudaGetLastError();
}

// Threads of a one-pack-a-thread GELU launch: one a 16-byte pack where
// the pointers allow it, whatever the length (the threads past the last
// whole pack take the elements after it); one an element otherwise.
int64_t gelu_grid(int64_t n, int vec_elems) {
  const int64_t threads = n / vec_elems + n % vec_elems;
  return (threads + kGeluThreads - 1) / kGeluThreads;
}

template <typename T>
cudaError_t gelu_fwd_launch(const void* x, void* y, int64_t n,
                            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(y);
  const int64_t grid = gelu_grid(n, vec ? V : 1);
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec)
    gelu_fwd_kernel<T, V><<<(unsigned)grid, kGeluThreads, 0, stream>>>(xs, ys,
                                                                        n);
  else
    gelu_fwd_kernel<T, 1><<<(unsigned)grid, kGeluThreads, 0, stream>>>(xs, ys,
                                                                        n);
  return cudaGetLastError();
}

// gelu_bwd: 16-byte packs where all three pointers allow it.
template <typename T>
cudaError_t gelu_bwd_launch(const void* x, const void* g, void* dx, int64_t n,
                            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(g) && aligned16(dx);
  const int64_t grid = gelu_grid(n, vec ? V : 1);
  if (grid > INT32_MAX) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(g);
  T* os = static_cast<T*>(dx);
  if (vec)
    gelu_bwd_kernel<T, V><<<(unsigned)grid, kGeluThreads, 0, stream>>>(
        xs, gs, os, n);
  else
    gelu_bwd_kernel<T, 1><<<(unsigned)grid, kGeluThreads, 0, stream>>>(
        xs, gs, os, n);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. dtype: 0 = float32, 1 = bfloat16. Scale, bias, mean, rstd and
// the partials are always float32. A zero-size call launches nothing. The
// LayerNorm and RMSNorm entry points share the one-warp bodies, the
// multi-warp row bodies (RMS template flag), the partials' sum
// (rt_norm_bwd_sum) and the rt_ln_max_d limit; each backward exports the
// rows per partial row it writes (rt_ln_bwd_rows_per_block,
// rt_rms_bwd_rows_per_block).
// ---------------------------------------------------------------------------
extern "C" {

int rt_ln_max_d() { return kMaxD; }

int rt_ln_bwd_rows_per_block() { return kLnBwdRows; }

int rt_rms_bwd_rows_per_block() { return kRmsBwdRows; }

cudaError_t rt_ln_fwd(const void* x, const void* scale, const void* bias,
                      void* y, void* mean, void* rstd, int rows, int d,
                      float eps, int dtype, void* stream) {
  if (rows < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ln_fwd_launch<float>(x, scale, bias, y, mean, rstd, rows, d, eps,
                                s);
  if (dtype == 1)
    return ln_fwd_launch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, rows,
                                        d, eps, s);
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

// parts [k, n, d] (ln_bwd's dscale and dbias partial rows, k = 2; rms_bwd's
// dscale ones, k = 1) -> out [k, d].
cudaError_t rt_norm_bwd_sum(const void* parts, int k, int n, int d, void* out,
                            void* stream) {
  if (k < 1 || k > 65535 || n < 1 || d < 1) return cudaErrorInvalidValue;
  const dim3 grid((d + 31) / 32, k);
  norm_bwd_sum_kernel<<<grid, kSumGroups * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), n, d, static_cast<float*>(out));
  return cudaGetLastError();
}

// RMSNorm: no bias, no mean, no dbias. dres may be null.
cudaError_t rt_rms_fwd(const void* x, const void* scale, void* y, void* rstd,
                       int rows, int d, float eps, int dtype, void* stream) {
  if (rows < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rms_fwd_launch<float>(x, scale, y, rstd, rows, d, eps, s);
  if (dtype == 1)
    return rms_fwd_launch<__nv_bfloat16>(x, scale, y, rstd, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

cudaError_t rt_rms_bwd(const void* x, const void* rstd, const void* scale,
                       const void* dy, const void* dres, void* dx,
                       void* dscale_part, int rows, int d, int dtype,
                       void* stream) {
  if (rows < 0 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rms_bwd_launch<float>(x, rstd, scale, dy, dres, dx, dscale_part,
                                 rows, d, s);
  if (dtype == 1)
    return rms_bwd_launch<__nv_bfloat16>(x, rstd, scale, dy, dres, dx,
                                         dscale_part, rows, d, s);
  return cudaErrorInvalidValue;
}

cudaError_t rt_gelu_fwd(const void* x, void* y, long long n, int dtype,
                        void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gelu_fwd_launch<float>(x, y, n, s);
  if (dtype == 1) return gelu_fwd_launch<__nv_bfloat16>(x, y, n, s);
  return cudaErrorInvalidValue;
}

cudaError_t rt_gelu_bwd(const void* x, const void* g, void* dx, long long n,
                        int dtype, void* stream) {
  if (n < 0 || g == nullptr) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gelu_bwd_launch<float>(x, g, dx, n, s);
  if (dtype == 1) return gelu_bwd_launch<__nv_bfloat16>(x, g, dx, n, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
