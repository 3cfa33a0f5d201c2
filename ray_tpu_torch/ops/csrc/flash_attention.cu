// Flash attention forward and backward for Hopper (sm_90a): the counterparts
// of the Pallas kernels in ray_tpu/ops/flash_attention.py.
//
// Built by ray_tpu_torch/ops/_build.py into a shared library with a plain C
// interface and bound with ctypes from ray_tpu_torch/ops/flash_attention.py.
// Every launcher takes raw device pointers and a cudaStream_t, launches on
// that stream, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// Inputs q, k, v (and dO in the backward) are bf16 [B, T, H, D] with the last
// two dims packed (head stride D, element stride 1) and the batch and time
// strides passed in, so the model's q/k/v views into its fused qkv product
// are read where they lie. Outputs are contiguous [B, T, H, D] bf16; lse and
// delta are contiguous [B, H, T] fp32. D is 64 or 128 (templated).
//
// The arithmetic is the Pallas kernels', in the same order:
//   s = (q . k) * scale in fp32, masked entries set to -1e30 (not -inf, so
//   exp(-1e30 - lse) is 0 and never NaN);
//   forward: online softmax with fp32 running max m, denominator l and
//   accumulator; p is rounded to bf16 before the P.V product; finally
//   l = max(l, 1e-30), out = acc / l, lse = m + log(l);
//   backward: p = exp(s - lse), dS = p * (dO.V^T - delta) * scale, with p and
//   dS rounded to bf16 before the products; dV += P^T dO, dK += dS^T Q,
//   dQ += dS K, all accumulated in fp32.
//
// Design shared by the three kernels (the FlashAttention-2 structure). All
// products go through the tensor cores as mma.sync m16n8k16 (bf16 in, fp32
// accumulate); one warp owns 16 rows of the tile it keeps fixed, so every
// row statistic stays in that warp's registers and no warp waits on another
// except at the tile barriers. Tiles are staged in shared memory by cp.async
// (16 bytes a thread, rows past T zero-filled) in two buffers, so the next
// tile's loads run under the current tile's products. Shared rows are padded
// by 16 bytes, which keeps the ldmatrix reads of 8 rows free of bank
// conflicts. Causal tiles wholly in the future are never visited; only tiles
// that straddle the diagonal, or run past T, pay for the mask.
//
// Bound on the H100 SXM at B=8, T=1024, H=12, D=64 (989 TFLOP/s bf16,
// 3.35 TB/s): the forward is near the balance point (50.7 MB, 12.9 GFLOP
// causal), the two backward kernels are bound by operations (25.8 and
// 19.3 GFLOP). mma.sync reaches only part of the wgmma peak, so these
// kernels aim first at keeping the tensor cores fed: two tiles in flight,
// no [T, T] tensor in device memory, and each exp computed once per kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarpRows = 16;  // rows of the fixed tile one warp owns
constexpr int kBlockFixed = kWarpRows * (kThreads / 32);  // 64
constexpr int kBlockSweep = 64;  // rows of the swept tile (fwd and dq)
constexpr float kNegInf = -1e30f;

// Shared-memory row stride, in elements: D plus 16 bytes of padding.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// Rows of the swept Q/dO tile in the dK/dV kernel. At D = 128 a 64-row tile
// would need 32 more fp32 registers per thread than the launch bound leaves.
template <int D>
__host__ __device__ constexpr int dkv_block_q() { return D == 64 ? 64 : 32; }

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest-even bf16 (as torch's cast), the first
// in the low half: the order of a fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- warp-level tile products -------------------------------------------------
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * group + tig): A holds rows
// group and group + 8, columns 2*tig (+1) and 8 + 2*tig (+1); B holds
// k = 2*tig (+1) and 8 + 2*tig (+1) at n = group; C holds rows group and
// group + 8 at columns 2*tig (+1).

// acc[NT][.] += A . B^T over k in [0, D): A is the 16 rows at a_row0 of the
// row-major tile a, B^T the NT*8 rows of the row-major tile b (so B is read
// as [n][k], which ldmatrix without .trans gives).
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        int a_row0, const bf16* b) {
  constexpr int S = row_stride<D>();
  const int lane = threadIdx.x & 31;
  const int a_r = a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_c = (lane >> 4) * 8;
  const int b_r = (lane & 7) + (lane >> 4) * 8;
  const int b_c = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + a_r * S + a_c + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + b_r) * S + b_c + kk * 16);
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][.] += P . B: P is a 16 x KN tile held as C fragments (rounded to
// bf16 here), B the row-major [KN][D] tile b (read as [k][n], which
// ldmatrix .trans gives). The C fragments of P are its A fragments once
// packed, so P never leaves registers.
template <int D, int KN>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&p)[KN / 8][4],
                                       const bf16* b) {
  constexpr int S = row_stride<D>();
  const int lane = threadIdx.x & 31;
  const int b_r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_c = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    uint32_t af[4];
    af[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    af[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    af[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    af[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + b_r) * S + np * 16 + b_c);
      mma16816(acc[2 * np], af, bf[0], bf[1]);
      mma16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// -- tile loads ---------------------------------------------------------------

// ROWS rows of D bf16 from src (row r at src + (row0 + r) * stride) into the
// padded shared tile dst; rows at or past T are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0, int T) {
  constexpr int S = row_stride<D>();
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * kChunks) % kThreads == 0, "tile not evenly split");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int t = row0 + r;
    const bool live = t < T;
    cp_async16(dst + r * S + c, src + (live ? (long long)t * stride : 0) + c,
               live ? 16 : 0);
  }
}

// ROWS fp32 values of one (b, h) row of lse or delta; zeros past T.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int T) {
  static_assert(ROWS <= kThreads, "one value per thread");
  if (threadIdx.x < ROWS) {
    const int t = row0 + threadIdx.x;
    const bool live = t < T;
    cp_async4(dst + threadIdx.x, src + (live ? t : 0), live ? 4 : 0);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;       // dO (backward)
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T] (backward)
  bf16* out;           // o, dq, or dk
  bf16* out2;          // dv
  float* lse_out;      // forward
  int H, T;
  long long sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, sg_b, sg_t;
  float scale;
  int causal;
};

// Row t of (b, h) in a [B, T, H, D] tensor.
__device__ __forceinline__ long long bthd(int b, int h, int t, int H, int T,
                                          int D) {
  return (((long long)b * T + t) * H + h) * D;
}

// Writes the 16 x D C-fragment tile acc (rows row0 + group, + 8) as bf16
// rows of a contiguous [B, T, H, D] tensor, multiplied by mul[0|1] per row;
// rows at or past T are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int b, int h,
                                           int row0, int H, int T) {
  const int lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + group + r * 8;
    if (t >= T) continue;
    bf16* row = dst + bthd(b, h, t, H, T, D);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nt][2 * r] * mul[r],
                                acc[nt][2 * r + 1] * mul[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd: replaces _fwd_kernel (ray_tpu/ops/flash_attention.py:84).
//
// One CTA per (b*h, 64-row q tile); a loop over the K/V tiles inside the CTA
// takes the place of the TPU's sequential k grid axis. Each warp keeps its
// 16 rows' running max, denominator (fp32) and the 16 x D fp32 accumulator
// in registers across the loop, as m_scr/l_scr/acc_scr do in VMEM. Causal
// q tiles run last-first, so the longest sweeps start first. Writes out in
// bf16 and lse in fp32.
// Bound at GPT-2 small's shape: bytes and operations about equal (~15 us).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int S = row_stride<D>();
  constexpr int kTile = kBlockSweep * S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockFixed * S;  // [2][64][S]
  bf16* v_s = k_s + 2 * kTile;        // [2][64][S]

  const int T = a.T, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (T + kBlockFixed - 1) / kBlockFixed;
  const int qt = a.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kBlockFixed;
  const int n_kt_all = (T + kBlockSweep - 1) / kBlockSweep;
  // Causal: k tiles up to the one holding the tile's last row.
  const int n_kt = a.causal
      ? min(n_kt_all, (q0 + kBlockFixed - 1) / kBlockSweep + 1)
      : n_kt_all;

  const bf16* qp = a.q + (long long)b * a.sq_b + h * D;
  const bf16* kp = a.k + (long long)b * a.sk_b + h * D;
  const bf16* vp = a.v + (long long)b * a.sv_b + h * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int row_base = q0 + warp * kWarpRows + group;  // + r * 8

  load_tile<D, kBlockFixed>(q_s, qp, a.sq_t, q0, T);
  load_tile<D, kBlockSweep>(k_s, kp, a.sk_t, 0, T);
  load_tile<D, kBlockSweep>(v_s, vp, a.sv_t, 0, T);
  cp_async_commit();

  float acc[D / 8][4];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      const int buf = (j + 1) & 1;
      load_tile<D, kBlockSweep>(k_s + buf * kTile, kp, a.sk_t,
                                (j + 1) * kBlockSweep, T);
      load_tile<D, kBlockSweep>(v_s + buf * kTile, vp, a.sv_t,
                                (j + 1) * kBlockSweep, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kc = k_s + (j & 1) * kTile;
    const bf16* vc = v_s + (j & 1) * kTile;

    float s[kBlockSweep / 8][4];
    zero(s);
    mma_abt<D, kBlockSweep / 8>(s, q_s, warp * kWarpRows, kc);

    const int k0 = j * kBlockSweep;
    const bool masked = (a.causal && k0 + kBlockSweep - 1 > q0) ||
                        k0 + kBlockSweep > T;
#pragma unroll
    for (int nt = 0; nt < kBlockSweep / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (masked) {
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          const int row = row_base + (e >> 1) * 8;
          if (col >= T || (a.causal && col > row)) x = kNegInf;
        }
        s[nt][e] = x;
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < kBlockSweep / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      const float m_new = quad_max(mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockSweep / 8; ++nt) {
        s[nt][2 * r] = expf(s[nt][2 * r] - m_new);
        s[nt][2 * r + 1] = expf(s[nt][2 * r + 1] - m_new);
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      l[r] = l[r] * alpha + quad_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
    }
    mma_pb<D, kBlockSweep>(acc, s, vc);
    __syncthreads();  // every warp is done with this buffer before reuse
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
  }
  store_rows<D>(a.out, acc, inv, b, h, q0 + warp * kWarpRows, H, T);
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row_base + r * 8;
      if (t < T) a.lse_out[(long long)bh * T + t] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_dkv: replaces _dkv_kernel (ray_tpu/ops/flash_attention.py:211) on
// the JAX package's long-sequence path (no dQ partials).
//
// One CTA per (b*h, 64-row k tile); each warp owns 16 keys and computes the
// transposed tiles S^T = K Q^T and dP^T = V dO^T for them, so P^T and dS^T
// come out of the tensor cores as C fragments whose rows are the warp's keys
// -- exactly the A operand of dV += P^T dO and dK += dS^T Q. P is recomputed
// from the lse it is given (exp(s - lse)), so a caller may pass a global or
// masking lse. dK and dV accumulate in fp32 registers across the q sweep and
// are written once, in bf16. No dQ is computed here.
// Bound at GPT-2 small's shape: operations (25.8 GFLOP causal, ~26 us).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int S = row_stride<D>();
  constexpr int BQ = dkv_block_q<D>();
  constexpr int kTile = BQ * S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBlockFixed * S;
  bf16* q_s = v_s + kBlockFixed * S;  // [2][BQ][S]
  bf16* g_s = q_s + 2 * kTile;        // [2][BQ][S]
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * kTile);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int T = a.T, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBlockFixed;  // causal: heaviest tiles first
  const int n_qt = (T + BQ - 1) / BQ;
  // Causal: the first q tile whose last row reaches k0.
  const int qt0 = a.causal ? k0 / BQ : 0;

  const bf16* qp = a.q + (long long)b * a.sq_b + h * D;
  const bf16* kp = a.k + (long long)b * a.sk_b + h * D;
  const bf16* vp = a.v + (long long)b * a.sv_b + h * D;
  const bf16* gp = a.g + (long long)b * a.sg_b + h * D;
  const float* lsep = a.lse + (long long)bh * T;
  const float* dlp = a.delta + (long long)bh * T;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int key_base = k0 + warp * kWarpRows + group;  // + r * 8

  load_tile<D, kBlockFixed>(k_s, kp, a.sk_t, k0, T);
  load_tile<D, kBlockFixed>(v_s, vp, a.sv_t, k0, T);
  load_tile<D, BQ>(q_s, qp, a.sq_t, qt0 * BQ, T);
  load_tile<D, BQ>(g_s, gp, a.sg_t, qt0 * BQ, T);
  load_rows<BQ>(lse_s, lsep, qt0 * BQ, T);
  load_rows<BQ>(dl_s, dlp, qt0 * BQ, T);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  for (int i = qt0; i < n_qt; ++i) {
    if (i + 1 < n_qt) {
      const int buf = (i + 1 - qt0) & 1;
      const int r0 = (i + 1) * BQ;
      load_tile<D, BQ>(q_s + buf * kTile, qp, a.sq_t, r0, T);
      load_tile<D, BQ>(g_s + buf * kTile, gp, a.sg_t, r0, T);
      load_rows<BQ>(lse_s + buf * BQ, lsep, r0, T);
      load_rows<BQ>(dl_s + buf * BQ, dlp, r0, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cur = (i - qt0) & 1;
    const bf16* qc = q_s + cur * kTile;
    const bf16* gc = g_s + cur * kTile;
    const float* lc = lse_s + cur * BQ;
    const float* dc = dl_s + cur * BQ;

    float st[BQ / 8][4], dpt[BQ / 8][4];
    zero(st);
    zero(dpt);
    mma_abt<D, BQ / 8>(st, k_s, warp * kWarpRows, qc);
    mma_abt<D, BQ / 8>(dpt, v_s, warp * kWarpRows, gc);

    const int q0 = i * BQ;
    const bool masked = a.causal && k0 + kBlockFixed - 1 > q0;
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + tig * 2 + (e & 1);
        float x = st[nt][e] * a.scale;
        if (masked && key_base + (e >> 1) * 8 > q0 + qi) x = kNegInf;
        const float p = expf(x - lc[qi]);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dc[qi]) * a.scale;
      }
    mma_pb<D, BQ>(dv, st, gc);
    mma_pb<D, BQ>(dk, dpt, qc);
    __syncthreads();  // every warp is done with this buffer before reuse
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(a.out, dk, one, b, h, k0 + warp * kWarpRows, H, T);
  store_rows<D>(a.out2, dv, one, b, h, k0 + warp * kWarpRows, H, T);
}

// ---------------------------------------------------------------------------
// flash_dq: replaces _dq_kernel (ray_tpu/ops/flash_attention.py:269).
//
// One CTA per (b*h, 64-row q tile), sweeping the k tiles as the forward
// does; each warp keeps its 16 rows' lse and delta and the 16 x D fp32 dQ
// accumulator in registers. Each q row is owned by one warp, so dQ needs no
// atomics and is the same on every run. Causal q tiles run last-first.
// Bound at GPT-2 small's shape: operations (19.3 GFLOP causal, ~20 us).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int S = row_stride<D>();
  constexpr int kTile = kBlockSweep * S;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kBlockFixed * S;
  bf16* k_s = g_s + kBlockFixed * S;  // [2][64][S]
  bf16* v_s = k_s + 2 * kTile;        // [2][64][S]

  const int T = a.T, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (T + kBlockFixed - 1) / kBlockFixed;
  const int qt = a.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kBlockFixed;
  const int n_kt_all = (T + kBlockSweep - 1) / kBlockSweep;
  const int n_kt = a.causal
      ? min(n_kt_all, (q0 + kBlockFixed - 1) / kBlockSweep + 1)
      : n_kt_all;

  const bf16* qp = a.q + (long long)b * a.sq_b + h * D;
  const bf16* kp = a.k + (long long)b * a.sk_b + h * D;
  const bf16* vp = a.v + (long long)b * a.sv_b + h * D;
  const bf16* gp = a.g + (long long)b * a.sg_b + h * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int row_base = q0 + warp * kWarpRows + group;  // + r * 8

  load_tile<D, kBlockFixed>(q_s, qp, a.sq_t, q0, T);
  load_tile<D, kBlockFixed>(g_s, gp, a.sg_t, q0, T);
  load_tile<D, kBlockSweep>(k_s, kp, a.sk_t, 0, T);
  load_tile<D, kBlockSweep>(v_s, vp, a.sv_t, 0, T);
  cp_async_commit();

  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row_base + r * 8;
    lse_r[r] = t < T ? a.lse[(long long)bh * T + t] : 0.f;
    dl_r[r] = t < T ? a.delta[(long long)bh * T + t] : 0.f;
  }

  float dq[D / 8][4];
  zero(dq);

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      const int buf = (j + 1) & 1;
      load_tile<D, kBlockSweep>(k_s + buf * kTile, kp, a.sk_t,
                                (j + 1) * kBlockSweep, T);
      load_tile<D, kBlockSweep>(v_s + buf * kTile, vp, a.sv_t,
                                (j + 1) * kBlockSweep, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kc = k_s + (j & 1) * kTile;
    const bf16* vc = v_s + (j & 1) * kTile;

    float s[kBlockSweep / 8][4], dp[kBlockSweep / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, kBlockSweep / 8>(s, q_s, warp * kWarpRows, kc);
    mma_abt<D, kBlockSweep / 8>(dp, g_s, warp * kWarpRows, vc);

    const int k0 = j * kBlockSweep;
    const bool masked = (a.causal && k0 + kBlockSweep - 1 > q0) ||
                        k0 + kBlockSweep > T;
#pragma unroll
    for (int nt = 0; nt < kBlockSweep / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[nt][e] * a.scale;
        if (masked) {
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          if (col >= T || (a.causal && col > row_base + r * 8)) x = kNegInf;
        }
        const float p = expf(x - lse_r[r]);
        s[nt][e] = p * (dp[nt][e] - dl_r[r]) * a.scale;  // dS
      }
    mma_pb<D, kBlockSweep>(dq, s, kc);
    __syncthreads();  // every warp is done with this buffer before reuse
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(a.out, dq, one, b, h, q0 + warp * kWarpRows, H, T);
}

// -- launch -------------------------------------------------------------------

template <int D>
size_t fwd_smem() {
  return (size_t)(kBlockFixed + 4 * kBlockSweep) * row_stride<D>() * sizeof(bf16);
}

template <int D>
size_t dkv_smem() {
  constexpr int BQ = dkv_block_q<D>();
  return (size_t)(2 * kBlockFixed + 4 * BQ) * row_stride<D>() * sizeof(bf16) +
         4 * BQ * sizeof(float);
}

template <int D>
size_t dq_smem() {
  return (size_t)(2 * kBlockFixed + 4 * kBlockSweep) * row_stride<D>() *
         sizeof(bf16);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  // Above 48 KB a kernel's dynamic shared memory has to be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool valid(int B, int H, int T, int D) {
  return B > 0 && H > 0 && T > 0 && (D == 64 || D == 128) &&
         (long long)B * H <= 0x7fffffffLL && (T + 31) / 32 <= 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* delta, void* out, void* out2,
               void* lse_out, int H, int T, long long sq_b, long long sq_t,
               long long sk_b, long long sk_t, long long sv_b, long long sv_t,
               long long sg_b, long long sg_t, float scale, int causal) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = static_cast<bf16*>(out);
  a.out2 = static_cast<bf16*>(out2);
  a.lse_out = static_cast<float*>(lse_out);
  a.H = H;
  a.T = T;
  a.sq_b = sq_b;
  a.sq_t = sq_t;
  a.sk_b = sk_b;
  a.sk_t = sk_t;
  a.sv_b = sv_b;
  a.sv_t = sv_t;
  a.sg_b = sg_b;
  a.sg_t = sg_t;
  a.scale = scale;
  a.causal = causal != 0;
  return a;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. q, k, v, g: bf16 [B, T, H, D] with strides (s*_b, s*_t, D, 1)
// in elements, 16-byte aligned; o, dq, dk, dv: contiguous bf16 [B, T, H, D];
// lse, delta: contiguous fp32 [B, H, T]. D is 64 or 128.
// ---------------------------------------------------------------------------
extern "C" {

cudaError_t rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int T, int D, long long sq_b,
                         long long sq_t, long long sk_b, long long sk_t,
                         long long sv_b, long long sv_t, float scale,
                         int causal, void* stream) {
  if (!valid(B, H, T, D)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse,
                           H, T, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, 0, 0,
                           scale, causal);
  const dim3 grid(B * H, (T + kBlockFixed - 1) / kBlockFixed);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(flash_fwd_kernel<64>, grid, fwd_smem<64>(), a, s);
  return launch(flash_fwd_kernel<128>, grid, fwd_smem<128>(), a, s);
}

cudaError_t rt_flash_dkv(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int T, int D,
                         long long sq_b, long long sq_t, long long sk_b,
                         long long sk_t, long long sv_b, long long sv_t,
                         long long sg_b, long long sg_t, float scale,
                         int causal, void* stream) {
  if (!valid(B, H, T, D)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, lse, delta, dk, dv, nullptr, H, T, sq_b,
                           sq_t, sk_b, sk_t, sv_b, sv_t, sg_b, sg_t, scale,
                           causal);
  const dim3 grid(B * H, (T + kBlockFixed - 1) / kBlockFixed);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(flash_dkv_kernel<64>, grid, dkv_smem<64>(), a, s);
  return launch(flash_dkv_kernel<128>, grid, dkv_smem<128>(), a, s);
}

cudaError_t rt_flash_dq(const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dq, int B, int H, int T, int D, long long sq_b,
                        long long sq_t, long long sk_b, long long sk_t,
                        long long sv_b, long long sv_t, long long sg_b,
                        long long sg_t, float scale, int causal,
                        void* stream) {
  if (!valid(B, H, T, D)) return cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, g, lse, delta, dq, nullptr, nullptr, H, T,
                           sq_b, sq_t, sk_b, sk_t, sv_b, sv_t, sg_b, sg_t,
                           scale, causal);
  const dim3 grid(B * H, (T + kBlockFixed - 1) / kBlockFixed);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(flash_dq_kernel<64>, grid, dq_smem<64>(), a, s);
  return launch(flash_dq_kernel<128>, grid, dq_smem<128>(), a, s);
}

}  // extern "C"
