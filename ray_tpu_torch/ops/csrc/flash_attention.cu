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
// One design for all three: warp-specialised Hopper kernels (below), with
// TMA loads under mbarriers, every product a wgmma, one producer warp and
// two consumer warpgroups that hand the tensor cores back and forth. Every
// exponential is one FFMA and one MUFU ex2, with log2 e folded into the
// scale. Causal tiles wholly in the future are never computed, and only
// tiles that straddle the diagonal, or run past T, pay for the mask.
//
// Bound on the H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at GPT-2 small's
// shape (B=8, T=1024, H=12, D=64, causal) the forward is bound by bytes
// (50.7 MB, 12.9 GFLOP) and the backward kernels by operations (25.8 and
// 19.3 GFLOP); at Llama small's (B=4, T=2048, H=16, D=64) all three by
// operations. No [T, T] tensor reaches device memory, and each
// exponential is computed once per kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInfL2 = kNegInf * kLog2e;  // the sentinel in log2 units

// Rows of the swept Q/dO tile in the dK/dV kernel. A consumer thread holds
// S^T and dP^T (BQ / 2 fp32 each) beside dK and dV (D / 2 each) under the
// 168 registers ptxas allots it; at D = 128 dK and dV take 128 of them.
template <int D>
__host__ __device__ constexpr int dkv_block_q() { return D == 64 ? 64 : 16; }

// Two fp32 values rounded to nearest-even bf16 (as torch's cast), the first
// in the low half: the order of a fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// What a kernel reads besides its tensor maps (the strided q, k, v, dO).
struct Args {
  const float* lse;    // [B, H, T] (backward)
  const float* delta;  // [B, H, T] (backward)
  bf16* out;           // o, dq, or dk
  bf16* out2;          // dv
  float* lse_out;      // forward
  int H, T;
  float scale;
  int causal;
};

// Row t of (b, h) in a [B, T, H, D] tensor.
__device__ __forceinline__ long long bthd(int b, int h, int t, int H, int T,
                                          int D) {
  return (((long long)b * T + t) * H + h) * D;
}

// -- the warp-specialised kernels --------------------------------------------
//
// One CTA of two consumer warpgroups (threads 0-255), which own 64 rows of
// the CTA's 128-row fixed tile each and run every product as wgmma, and
// one producer warp (threads 256-287), which streams the swept tiles into
// a kStages ring of shared-memory buffers by TMA, behind full/empty
// mbarriers. ptxas allots these kernels at most 168 registers a thread
// (65536 / 384, as for three whole warpgroups), with a producer warpgroup
// and setmaxnreg as with this single warp, so the tiles are sized to fit
// 168 and the producer is one warp. Tiles are
// stored as TMA writes them with the 128-byte swizzle: D/64 column blocks
// of 128-byte rows, each block 1024-byte aligned, which is the layout
// wgmma's descriptors read.

constexpr int kWsThreads = 288;
constexpr int kConsumerWarps = 8;
constexpr int kTileRows = 128;      // fixed rows a CTA, 64 a consumer warpgroup
constexpr int kStages = 3;
constexpr uint32_t kSbo = 1024;     // 8 swizzled rows of 128 bytes

// The first 1024-byte aligned address at or after p (swizzled TMA tiles).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// K-major descriptor of k-step kk (16 columns) of a ROWS-row tile at base.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
  return hopper::desc_sw128(base + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16,
                            kSbo);
}

// MN-major descriptor of rows 16kk..16kk+15 and column block hf of a
// ROWS-row tile at base (the B operand of P.V, P^T.dO and dS^T.Q).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk, int hf) {
  return hopper::desc_sw128(base + hf * ROWS * 128 + kk * 16 * 128,
                            ROWS * 128, kSbo);
}

// The A fragments of k-step kk of a C-fragment tile c (as wgmma writes it:
// c[4 * nt + e] is row group (+8 for e >= 2), column 8 nt + 2 tig + (e & 1)),
// rounded to bf16: C fragments of chunks 2kk and 2kk+1 are exactly the
// mma.m16n8k16 A layout, so the tile never leaves registers.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N],
                                       int kk) {
  const int n0 = 8 * kk, n1 = 8 * kk + 4;
  a[0] = pack_bf16(c[n0], c[n0 + 1]);
  a[1] = pack_bf16(c[n0 + 2], c[n0 + 3]);
  a[2] = pack_bf16(c[n1], c[n1 + 1]);
  a[3] = pack_bf16(c[n1 + 2], c[n1 + 3]);
}

// Writes a consumer warpgroup's 64 x D fp32 tile acc (acc[hf] holds column
// block hf as C fragments) as bf16 rows of a contiguous [B, T, H, D]
// tensor, row r of the thread's two scaled by mul[r]; rows past T skipped.
template <int D>
__device__ __forceinline__ void store_wg_rows(bf16* dst,
                                              const float (&acc)[D / 64][32],
                                              const float (&mul)[2], int b,
                                              int h, int row_base, int H,
                                              int T) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row_base + r * 8;
    if (t >= T) continue;
    bf16* row = dst + bthd(b, h, t, H, T, D);
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(row + hf * 64 + nt * 8 + tig * 2) =
            __floats2bfloat162_rn(acc[hf][4 * nt + 2 * r] * mul[r],
                                  acc[hf][4 * nt + 2 * r + 1] * mul[r]);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd: replaces _fwd_kernel (ray_tpu/ops/flash_attention.py:84).
//
// One CTA per (b*h, 128-row q tile); a loop over BK-key K/V tiles inside
// the CTA takes the place of the TPU's sequential k grid axis. Q loads once
// by TMA; K and V stream through the ring. Each consumer warpgroup computes
// S = Q K^T for its 64 rows (wgmma m64nBKk16, both operands in shared
// memory), the online softmax in registers, and O += P V with P as the
// register A operand and V read MN-major (wgmma m64n64k16 per 64 columns).
// Each thread keeps its two rows' running max, denominator and fp32
// accumulator across the loop, as m_scr/l_scr/acc_scr do in VMEM. Causal
// q tiles run last-first, so the longest sweeps start first; tiles wholly
// in the future are never visited.
// Softmax: p = 2^(s * scale * log2 e - m * log2 e), one FFMA and one MUFU
// ex2 a score, with m, l and lse kept in natural-log units. A masked score
// gives p = 0 exactly, as exp(-1e30 - m) does for every m the sweep can
// reach (key tile 0 holds key 0, which every row sees, so m leaves the
// -1e30 floor on the first tile); the running max never drops below -1e30.
// Bound at the Llama-small shape: operations (34.4 GFLOP causal, 35 us at
// the bf16 peak), and the exponentials need about as long on the MUFU
// units, so the design keeps both busy at once. Within a warpgroup, tile
// j's S product is issued together with tile j-1's P V product, and the
// softmax of tile j runs while P V is still on the tensor cores (P of
// tile j-1 waits, packed, in registers). Across the two warpgroups, named
// barriers hand the tensor cores back and forth (ping-pong), so one
// warpgroup issues its products while the other does its softmax.
// ---------------------------------------------------------------------------

// Keys of flash_fwd's swept tile: at D = 128 the accumulator doubles, and a
// 128-key S tile with P held beside it would not fit the 168 registers.
template <int D>
__host__ __device__ constexpr int fwd_block_k() { return D == 64 ? 128 : 64; }

// One online-softmax step on the S tile sc of this thread's two rows
// (row_base, row_base + 8): masks it if `masked`, moves m past the tile's
// max, turns sc into p, adds p's row sums to l, and returns in alpha the
// factor by which the accumulator must be rescaled.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool masked, int k0, int row_base,
                                             const Args& a) {
  const int tig = threadIdx.x & 3;
  if (masked) {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        const int row = row_base + (e >> 1) * 8;
        if (col >= a.T || (a.causal && col > row)) sc[4 * nt + e] = -INFINITY;
      }
  }
  const float c = a.scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mx = fmaxf(mx, fmaxf(sc[4 * nt + 2 * r], sc[4 * nt + 2 * r + 1]));
    // max(s * scale) == scale * max(s) for scale > 0; never below m.
    const float m_new = fmaxf(m[r], quad_max(mx) * a.scale);
    // Unfused products, so equal maxima give exactly ex2(0) = 1.
    const float ml2 = __fmul_rn(m_new, kLog2e);
    alpha[r] = hopper::ex2(__fmul_rn(m[r], kLog2e) - ml2);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        sc[4 * nt + e] = hopper::ex2(fmaf(sc[4 * nt + e], c, -ml2));
        sum += sc[4 * nt + e];
      }
    l[r] = l[r] * alpha[r] + quad_sum(sum);
    m[r] = m_new;
  }
}

// Ping-pong: warpgroup wg waits for its turn at the tensor cores on named
// barrier 1 + wg, and hands the turn to the other on 2 - wg.
__device__ __forceinline__ void turn_wait(int wg) {
  hopper::bar_sync(1 + wg, 256);
}
__device__ __forceinline__ void turn_pass(int wg) {
  hopper::bar_arrive(2 - wg, 256);
}

// Whether a BK-key tile at k0 needs the mask for a warpgroup's rows
// q0w .. q0w + 63 (flash_fwd, flash_dq): it straddles the diagonal or runs
// past T.
template <int BK>
__device__ __forceinline__ bool tile_masked(const Args& a, int k0, int q0w) {
  return (a.causal && k0 + BK - 1 > q0w) || k0 + BK > a.T;
}

// S = Q K^T for a warpgroup's 64 rows, as one commit group.
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<BK>(sc, desc_k<kTileRows>(q_addr, kk),
                         desc_k<BK>(k_addr, kk), kk > 0);
  hopper::wgmma_commit();
}

// O += P V with P from registers, as one commit group.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
      hopper::wgmma_rs_n64_mn(acc[hf], pa[kk], desc_mn<BK>(v_addr, kk, hf));
  hopper::wgmma_commit();
}

// Keeps the accumulator and the packed P in place around an in-flight
// P V product (see hopper::fence_regs).
template <int D, int BK>
__device__ __forceinline__ void fence_tile(float (&acc)[D / 64][32],
                                           uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf) hopper::fence_regs(acc[hf]);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(pa[kk]);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a) {
  constexpr int BK = fwd_block_k<D>();
  constexpr int kQBytes = kTileRows * D * 2;
  constexpr int kKBytes = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + kQBytes;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kKBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int T = a.T, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (T + kTileRows - 1) / kTileRows;
  const int qt = a.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kTileRows;
  const int n_kt_all = (T + BK - 1) / BK;
  // Causal: k tiles up to the one holding the tile's last row.
  const int n_kt =
      a.causal ? min(n_kt_all, (q0 + kTileRows - 1) / BK + 1) : n_kt_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(q_bar, kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(q_s + c * kTileRows * 64, &tm_q, q_bar, c * 64, h,
                            q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        hopper::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kKBytes);
        bf16* k_s = reinterpret_cast<bf16*>(ring + s * 2 * kKBytes);
        bf16* v_s = k_s + BK * D;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(k_s + c * BK * 64, &tm_k, &full[s], c * 64, h,
                              j * BK, b);
          hopper::tma_load_4d(v_s + c * BK * 64, &tm_v, &full[s], c * 64, h,
                              j * BK, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63.
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int tig = lane & 3;
    const int q0w = q0 + wg * 64;
    const int row_base = q0w + warp * 16 + (lane >> 2);  // + r * 8
    const uint32_t q_addr = hopper::smem_u32(q_s) + wg * 64 * 128;
    const uint32_t ring_addr = hopper::smem_u32(ring);

    float acc[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];  // P of the previous tile, packed

    if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
    hopper::mbar_wait(q_bar, 0);
    hopper::mbar_wait(&full[0], 0);
    turn_wait(wg);
    hopper::wgmma_fence();
    issue_s<D, BK>(sc, q_addr, ring_addr);
    turn_pass(wg);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax_step<BK>(sc, m, l, alpha, tile_masked<BK>(a, 0, q0w), 0, row_base,
                     a);  // acc is still 0: nothing to rescale
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], sc, kk);

    for (int j = 1; j < n_kt; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      hopper::mbar_wait(&full[s], (j / kStages) & 1);
      turn_wait(wg);
      fence_tile<D, BK>(acc, pa);
      hopper::wgmma_fence();
      issue_s<D, BK>(sc, q_addr, ring_addr + s * 2 * kKBytes);
      issue_pv<D, BK>(acc, pa, ring_addr + sp * 2 * kKBytes + kKBytes);
      turn_pass(wg);
      hopper::wgmma_wait<1>();  // S of tile j; P V of tile j-1 runs on
      hopper::fence_regs(sc);
      softmax_step<BK>(sc, m, l, alpha, tile_masked<BK>(a, j * BK, q0w),
                       j * BK, row_base, a);
      hopper::wgmma_wait<0>();
      fence_tile<D, BK>(acc, pa);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[sp]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            acc[hf][4 * nt + 2 * r] *= alpha[r];
            acc[hf][4 * nt + 2 * r + 1] *= alpha[r];
          }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], sc, kk);
    }

    // The last tile's P V.
    turn_wait(wg);
    fence_tile<D, BK>(acc, pa);
    hopper::wgmma_fence();
    issue_pv<D, BK>(acc, pa,
                    ring_addr + ((n_kt - 1) % kStages) * 2 * kKBytes + kKBytes);
    if (wg == 0) turn_pass(wg);  // warpgroup 1's last pass went first
    hopper::wgmma_wait<0>();
    fence_tile<D, BK>(acc, pa);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / l[r];
    }
    store_wg_rows<D>(a.out, acc, inv, b, h, row_base, H, T);
    if (tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = row_base + r * 8;
        if (t < T) a.lse_out[(long long)bh * T + t] = m[r] + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_dkv: replaces _dkv_kernel (ray_tpu/ops/flash_attention.py:211) on
// the JAX package's long-sequence path (no dQ partials).
//
// One CTA per (b*h, 128 keys); K and V load once by TMA, and the producer
// streams the q tiles (Q and dO by TMA; lse * log2 e and delta, which TMA
// cannot take at an arbitrary T, by the producer warp's own loads) through
// the ring. Each consumer warpgroup owns 64 keys and computes S^T = K Q^T
// and dP^T = V dO^T (wgmma, both operands in shared memory), so P^T and
// dS^T come out as C fragments whose rows are its keys -- exactly the
// register A operand of dV += P^T dO and dK += dS^T Q, which read dO and Q
// MN-major. P is recomputed from the lse it is given, p = 2^(s * scale *
// log2 e - lse * log2 e), so a caller may pass a global or masking lse
// (+1e30 gives p = 0); a masked score is the -1e30 sentinel, in log2
// units. dK and dV accumulate in fp32 registers across the q sweep and are
// written once, in bf16. Causal: the sweep starts at the first q tile that
// reaches the CTA's keys, and CTAs with the most q tiles come first. No dQ
// is computed here.
// Bound at the Llama-small shape: operations (68.7 GFLOP causal, 70 us at
// the bf16 peak). Registers set the tile: at D = 64 a consumer thread holds
// S^T, dP^T, dK and dV (32 fp32 each) for a 64-row q tile; at D = 128 dK
// and dV double, so the q tile is 16 rows. The two warpgroups ping-pong the
// tensor cores, as in flash_fwd, so one's exponentials run under the
// other's products; overlapping them inside a warpgroup would hold a
// second tile's fragments, past the 168 registers.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_g, const Args a) {
  constexpr int BQ = dkv_block_q<D>();
  constexpr int kKVBytes = kTileRows * D * 2;
  constexpr int kQBytes = BQ * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTileRows * D;
  unsigned char* ring = smem + 2 * kKVBytes;  // stage s: Q, then dO
  float* lse_s = reinterpret_cast<float*>(ring + kStages * 2 * kQBytes);
  float* dl_s = lse_s + kStages * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(dl_s + kStages * BQ);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int T = a.T, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTileRows;  // causal: heaviest tiles first
  const int n_qt = (T + BQ - 1) / BQ;
  // Causal: the first q tile whose last row reaches k0.
  const int qt0 = a.causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: warp 8 keeps the ring full.
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_bar, 2 * kKVBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(k_s + c * kTileRows * 64, &tm_k, kv_bar, c * 64,
                            h, k0, b);
        hopper::tma_load_4d(v_s + c * kTileRows * 64, &tm_v, kv_bar, c * 64,
                            h, k0, b);
      }
    }
    const float* lsep = a.lse + (long long)bh * T;
    const float* dlp = a.delta + (long long)bh * T;
    for (int i = qt0; i < n_qt; ++i) {
      const int it = i - qt0, s = it % kStages;
      hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      // Rows past T: any finite value (their Q and dO rows are zeros).
      for (int x = lane; x < BQ; x += 32) {
        const int t = i * BQ + x;
        lse_s[s * BQ + x] = t < T ? __fmul_rn(lsep[t], kLog2e) : 0.f;
        dl_s[s * BQ + x] = t < T ? dlp[t] : 0.f;
      }
      if (lane == 0) {
        // Arrives after this lane's own stores, as the others do.
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
        bf16* q_s = reinterpret_cast<bf16*>(ring + s * 2 * kQBytes);
        bf16* g_s = q_s + BQ * D;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(q_s + c * BQ * 64, &tm_q, &full[s], c * 64, h,
                              i * BQ, b);
          hopper::tma_load_4d(g_s + c * BQ * 64, &tm_g, &full[s], c * 64, h,
                              i * BQ, b);
        }
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    // Consumers: warpgroup wg owns keys k0 + 64 wg .. + 63.
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int group = lane >> 2, tig = lane & 3;
    const int kw0 = k0 + wg * 64;
    const int key_base = kw0 + warp * 16 + group;  // + r * 8
    const uint32_t k_addr = hopper::smem_u32(k_s) + wg * 64 * 128;
    const uint32_t v_addr = hopper::smem_u32(v_s) + wg * 64 * 128;
    const uint32_t ring_addr = hopper::smem_u32(ring);
    const float c = a.scale * kLog2e;

    float dk[D / 64][32], dv[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[hf][i] = dv[hf][i] = 0.f;

    if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
    hopper::mbar_wait(kv_bar, 0);
    for (int i = qt0; i < n_qt; ++i) {
      const int it = i - qt0, s = it % kStages;
      const int q0 = i * BQ;
      const uint32_t q_addr = ring_addr + s * 2 * kQBytes;
      const uint32_t g_addr = q_addr + kQBytes;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);
      float st[BQ / 2], dpt[BQ / 2];
      turn_wait(wg);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BQ>(st, desc_k<kTileRows>(k_addr, kk),
                             desc_k<BQ>(q_addr, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BQ>(dpt, desc_k<kTileRows>(v_addr, kk),
                             desc_k<BQ>(g_addr, kk), kk > 0);
      hopper::wgmma_commit();
      turn_pass(wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      const bool masked = a.causal && kw0 + 63 > q0;
      const float* lc = lse_s + s * BQ;
      const float* dc = dl_s + s * BQ;
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 ll =
            *reinterpret_cast<const float2*>(lc + nt * 8 + tig * 2);
        const float2 dd =
            *reinterpret_cast<const float2*>(dc + nt * 8 + tig * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + nt * 8 + tig * 2 + (e & 1);
          const float ll2 = (e & 1) ? ll.y : ll.x;
          const float p = hopper::ex2(masked && key_base + (e >> 1) * 8 > qi
                                          ? kNegInfL2 - ll2
                                          : fmaf(st[4 * nt + e], c, -ll2));
          st[4 * nt + e] = p;
          dpt[4 * nt + e] =
              p * (dpt[4 * nt + e] - ((e & 1) ? dd.y : dd.x)) * a.scale;
        }
      }

      // Every A fragment is packed before the fence, so no wgmma waits on a
      // register written between two of them.
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        pack_a(pa[kk], st, kk);
        pack_a(da[kk], dpt, kk);
      }
      turn_wait(wg);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        hopper::fence_regs(dk[hf]);
        hopper::fence_regs(dv[hf]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          hopper::wgmma_rs_n64_mn(dv[hf], pa[kk], desc_mn<BQ>(g_addr, kk, hf));
          hopper::wgmma_rs_n64_mn(dk[hf], da[kk], desc_mn<BQ>(q_addr, kk, hf));
        }
      hopper::wgmma_commit();
      // Every turn is passed once: warpgroup 1 skips its last, which
      // warpgroup 0's first wait took in advance.
      if (wg == 0 || i + 1 < n_qt) turn_pass(wg);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        hopper::fence_regs(dk[hf]);
        hopper::fence_regs(dv[hf]);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        hopper::fence_regs(pa[kk]);
        hopper::fence_regs(da[kk]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_wg_rows<D>(a.out, dk, one, b, h, key_base, H, T);
    store_wg_rows<D>(a.out2, dv, one, b, h, key_base, H, T);
  }
}

// ---------------------------------------------------------------------------
// flash_dq: replaces _dq_kernel (ray_tpu/ops/flash_attention.py:269).
//
// flash_fwd's shape with the online softmax replaced by the known lse and
// delta. One CTA per (b*h, 128-row q tile); Q and dO load once by TMA, and
// the producer streams BK-key K/V tiles through the ring. Each consumer
// warpgroup owns 64 q rows, keeps its two rows' lse * log2 e and delta in
// registers (the rows are fixed, so no ring slot holds them), and for each
// key tile computes S = Q K^T and dP = dO V^T (wgmma, both operands in
// shared memory, one commit group), then p = 2^(s * scale * log2 e -
// lse * log2 e) and dS = p * (dP - delta) * scale in registers, then
// dQ += dS K with dS as the register A operand and K read MN-major (the
// forward's P V with K in place of V). A masked score is the -1e30
// sentinel in log2 units, so a global or masking lse (+1e30 gives p = 0)
// may be passed, as ring attention does. dQ accumulates in fp32 registers
// and is written once, in bf16; each q row belongs to one warpgroup, so no
// atomics, and the result is the same on every run. Causal q tiles run
// last-first, so the longest sweeps start first.
// Bound at the Llama-small shape: operations (51.5 GFLOP causal, 52 us at
// the bf16 peak). Registers set the key tile: a consumer thread holds S
// and dP (32 fp32 each for 64 keys), the packed dS (16) and dQ (D / 2)
// under the 168 registers ptxas allots; at D = 128 that is 144 live values,
// which still fit without spill or serialised wgmma. The two warpgroups
// ping-pong the tensor cores, as in flash_dkv, so one's exponentials run
// under the other's products.
// ---------------------------------------------------------------------------

constexpr int kDqKeys = 64;  // keys of flash_dq's swept tile

// dS = p * (dP - delta) * scale in place of dp, p = 2^(s * scale * log2 e -
// lse * log2 e), for this thread's two rows (row_base, + 8) of a BK-key
// tile at k0. MASK (the tile straddles the diagonal or runs past T): each
// score is checked, and a masked one is the sentinel. Only such tiles take
// that instantiation: a check made in every tile cost a third of the
// kernel's time.
template <int BK, bool MASK>
__device__ __forceinline__ void ds_tile(float (&dp)[BK / 2],
                                        const float (&sc)[BK / 2],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], int k0,
                                        int row_base, const Args& a) {
  const int tig = threadIdx.x & 3;
  const float c = a.scale * kLog2e;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = fmaf(sc[4 * nt + e], c, -lse2[r]);
      if constexpr (MASK) {
        const int col = k0 + nt * 8 + tig * 2 + (e & 1);
        if (col >= a.T || (a.causal && col > row_base + r * 8))
          x = kNegInfL2 - lse2[r];
      }
      const float p = hopper::ex2(x);
      dp[4 * nt + e] = p * (dp[4 * nt + e] - dl[r]) * a.scale;
    }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_g, const Args a) {
  constexpr int BK = kDqKeys;
  constexpr int kQBytes = kTileRows * D * 2;
  constexpr int kKBytes = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* g_s = q_s + kTileRows * D;
  unsigned char* ring = smem + 2 * kQBytes;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kKBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qg_bar = empty + kStages;

  const int T = a.T, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (T + kTileRows - 1) / kTileRows;
  const int qt = a.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kTileRows;
  const int n_kt_all = (T + BK - 1) / BK;
  // Causal: k tiles up to the one holding the tile's last row.
  const int n_kt =
      a.causal ? min(n_kt_all, (q0 + kTileRows - 1) / BK + 1) : n_kt_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(qg_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(qg_bar, 2 * kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(q_s + c * kTileRows * 64, &tm_q, qg_bar, c * 64, h,
                            q0, b);
        hopper::tma_load_4d(g_s + c * kTileRows * 64, &tm_g, qg_bar, c * 64, h,
                            q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        hopper::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * kKBytes);
        bf16* k_s = reinterpret_cast<bf16*>(ring + s * 2 * kKBytes);
        bf16* v_s = k_s + BK * D;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(k_s + c * BK * 64, &tm_k, &full[s], c * 64, h,
                              j * BK, b);
          hopper::tma_load_4d(v_s + c * BK * 64, &tm_v, &full[s], c * 64, h,
                              j * BK, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63.
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int q0w = q0 + wg * 64;
    const int row_base = q0w + warp * 16 + (lane >> 2);  // + r * 8
    const uint32_t q_addr = hopper::smem_u32(q_s) + wg * 64 * 128;
    const uint32_t g_addr = hopper::smem_u32(g_s) + wg * 64 * 128;
    const uint32_t ring_addr = hopper::smem_u32(ring);
    // Causal: warpgroup 0 computes the tiles up to its own last row; the
    // CTA's n_kt is warpgroup 1's.
    const int n_kt_w =
        a.causal ? min(n_kt_all, (q0w + 63) / BK + 1) : n_kt_all;

    // Rows past T: any finite value (their Q and dO rows are zeros).
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row_base + r * 8;
      const long long i = (long long)bh * T + t;
      lse2[r] = t < T ? __fmul_rn(a.lse[i], kLog2e) : 0.f;
      dl[r] = t < T ? a.delta[i] : 0.f;
    }

    float dq[D / 64][32];
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[hf][i] = 0.f;

    if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
    hopper::mbar_wait(qg_bar, 0);
    for (int j = 0; j < n_kt_w; ++j) {
      const int s = j % kStages;
      const uint32_t k_addr = ring_addr + s * 2 * kKBytes;
      const uint32_t v_addr = k_addr + kKBytes;
      hopper::mbar_wait(&full[s], (j / kStages) & 1);
      float sc[BK / 2], dp[BK / 2];
      turn_wait(wg);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BK>(sc, desc_k<kTileRows>(q_addr, kk),
                             desc_k<BK>(k_addr, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BK>(dp, desc_k<kTileRows>(g_addr, kk),
                             desc_k<BK>(v_addr, kk), kk > 0);
      hopper::wgmma_commit();
      turn_pass(wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      const int k0 = j * BK;
      if (tile_masked<BK>(a, k0, q0w))
        ds_tile<BK, true>(dp, sc, lse2, dl, k0, row_base, a);
      else
        ds_tile<BK, false>(dp, sc, lse2, dl, k0, row_base, a);

      // Every A fragment is packed before the fence, so no wgmma waits on a
      // register written between two of them.
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) pack_a(da[kk], dp, kk);
      turn_wait(wg);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) hopper::fence_regs(dq[hf]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf)
          hopper::wgmma_rs_n64_mn(dq[hf], da[kk], desc_mn<BK>(k_addr, kk, hf));
      hopper::wgmma_commit();
      // Every turn is passed once: warpgroup 1 skips its last, which
      // warpgroup 0's first wait took in advance.
      if (wg == 0 || j + 1 < n_kt) turn_pass(wg);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) hopper::fence_regs(dq[hf]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(da[kk]);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    // Causal, warpgroup 0 only: the tiles wholly in its rows' future. No
    // products, but both turns of each tile pass, so the two warpgroups
    // pass the same count, and each stage is released once it has landed
    // (an early arrival would count toward the stage's previous use).
    for (int j = n_kt_w; j < n_kt; ++j) {
      const int s = j % kStages;
      hopper::mbar_wait(&full[s], (j / kStages) & 1);
      turn_wait(wg);
      turn_pass(wg);
      turn_wait(wg);
      turn_pass(wg);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_wg_rows<D>(a.out, dq, one, b, h, row_base, H, T);
  }
}

// -- launch -------------------------------------------------------------------

template <int D>
size_t fwd_smem() {  // alignment slack, Q, the K/V ring, the barriers
  return 1024 + (size_t)(kTileRows + kStages * 2 * fwd_block_k<D>()) * D * 2 +
         (2 * kStages + 1) * 8;
}

template <int D>
size_t dkv_smem() {  // slack, K, V, the Q/dO ring, lse and delta, barriers
  constexpr int BQ = dkv_block_q<D>();
  return 1024 + (size_t)(2 * kTileRows + kStages * 2 * BQ) * D * 2 +
         2 * kStages * BQ * 4 + (2 * kStages + 1) * 8;
}

template <int D>
size_t dq_smem() {  // slack, Q, dO, the K/V ring, the barriers
  return 1024 + (size_t)(2 * kTileRows + kStages * 2 * kDqKeys) * D * 2 +
         (2 * kStages + 1) * 8;
}

// Launches a warp-specialised kernel with its tensor maps (by value, as
// __grid_constant__ parameters) and the Args. Above 48 KB a kernel's
// dynamic shared memory has to be allowed first.
template <typename Kernel, typename... Maps>
cudaError_t launch_ws(Kernel kernel, dim3 grid, size_t smem,
                      cudaStream_t stream, const Args& a,
                      const Maps&... maps) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, smem, stream>>>(maps..., a);
  return cudaGetLastError();
}

bool valid(int B, int H, int T, int D) {
  return B > 0 && H > 0 && T > 0 && (D == 64 || D == 128) &&
         (long long)B * H <= 0x7fffffffLL && (T + 31) / 32 <= 65535;
}

Args make_args(const void* lse, const void* delta, void* out, void* out2,
               void* lse_out, int H, int T, float scale, int causal) {
  Args a;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = static_cast<bf16*>(out);
  a.out2 = static_cast<bf16*>(out2);
  a.lse_out = static_cast<float*>(lse_out);
  a.H = H;
  a.T = T;
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
  const Args a = make_args(nullptr, nullptr, o, nullptr, lse, H, T, scale,
                           causal);
  const int bk = D == 64 ? fwd_block_k<64>() : fwd_block_k<128>();
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_bthd(&tq, q, B, T, H, D, sq_b, sq_t, kTileRows) ||
      !hopper::encode_bthd(&tk, k, B, T, H, D, sk_b, sk_t, bk) ||
      !hopper::encode_bthd(&tv, v, B, T, H, D, sv_b, sv_t, bk))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (T + kTileRows - 1) / kTileRows);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_ws(flash_fwd_kernel<64>, grid, fwd_smem<64>(), s, a, tq, tk,
                     tv);
  return launch_ws(flash_fwd_kernel<128>, grid, fwd_smem<128>(), s, a, tq, tk,
                   tv);
}

cudaError_t rt_flash_dkv(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int H, int T, int D,
                         long long sq_b, long long sq_t, long long sk_b,
                         long long sk_t, long long sv_b, long long sv_t,
                         long long sg_b, long long sg_t, float scale,
                         int causal, void* stream) {
  if (!valid(B, H, T, D)) return cudaErrorInvalidValue;
  const Args a = make_args(lse, delta, dk, dv, nullptr, H, T, scale, causal);
  const int bq = D == 64 ? dkv_block_q<64>() : dkv_block_q<128>();
  CUtensorMap tq, tk, tv, tg;
  if (!hopper::encode_bthd(&tq, q, B, T, H, D, sq_b, sq_t, bq) ||
      !hopper::encode_bthd(&tk, k, B, T, H, D, sk_b, sk_t, kTileRows) ||
      !hopper::encode_bthd(&tv, v, B, T, H, D, sv_b, sv_t, kTileRows) ||
      !hopper::encode_bthd(&tg, g, B, T, H, D, sg_b, sg_t, bq))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (T + kTileRows - 1) / kTileRows);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_ws(flash_dkv_kernel<64>, grid, dkv_smem<64>(), s, a, tq, tk,
                     tv, tg);
  return launch_ws(flash_dkv_kernel<128>, grid, dkv_smem<128>(), s, a, tq, tk,
                   tv, tg);
}

cudaError_t rt_flash_dq(const void* q, const void* k, const void* v,
                        const void* g, const void* lse, const void* delta,
                        void* dq, int B, int H, int T, int D, long long sq_b,
                        long long sq_t, long long sk_b, long long sk_t,
                        long long sv_b, long long sv_t, long long sg_b,
                        long long sg_t, float scale, int causal,
                        void* stream) {
  if (!valid(B, H, T, D)) return cudaErrorInvalidValue;
  const Args a = make_args(lse, delta, dq, nullptr, nullptr, H, T, scale,
                           causal);
  CUtensorMap tq, tk, tv, tg;
  if (!hopper::encode_bthd(&tq, q, B, T, H, D, sq_b, sq_t, kTileRows) ||
      !hopper::encode_bthd(&tk, k, B, T, H, D, sk_b, sk_t, kDqKeys) ||
      !hopper::encode_bthd(&tv, v, B, T, H, D, sv_b, sv_t, kDqKeys) ||
      !hopper::encode_bthd(&tg, g, B, T, H, D, sg_b, sg_t, kTileRows))
    return cudaErrorInvalidValue;
  const dim3 grid(B * H, (T + kTileRows - 1) / kTileRows);
  auto s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_ws(flash_dq_kernel<64>, grid, dq_smem<64>(), s, a, tq, tk,
                     tv, tg);
  return launch_ws(flash_dq_kernel<128>, grid, dq_smem<128>(), s, a, tq, tk,
                   tv, tg);
}

// The dynamic shared memory a launch requests: kernel 0 flash_fwd, 1
// flash_dkv, 2 flash_dq; -1 for an unknown kernel or D.
int rt_flash_smem(int kernel, int D) {
  if (D != 64 && D != 128) return -1;
  const bool d64 = D == 64;
  switch (kernel) {
    case 0: return (int)(d64 ? fwd_smem<64>() : fwd_smem<128>());
    case 1: return (int)(d64 ? dkv_smem<64>() : dkv_smem<128>());
    case 2: return (int)(d64 ? dq_smem<64>() : dq_smem<128>());
  }
  return -1;
}

}  // extern "C"
