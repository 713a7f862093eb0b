// Fused kNN score block + validity mask + per-128-column block maximum.
//
// Replaces the Pallas kernel lemon_tpu/ops/scoremax.py `_kernel` (launched by
// `_fused_padded`, :119). For a query block q (B, D) and a database tile
// db (T, D), both fp32 row-major, it writes
//   s    (B, T)       s[r, c] = q[r] . db[c]            (metric 'ip')
//                     s[r, c] = -((|q_r|^2 - 2 q_r.db_c) + |db_c|^2)   ('l2')
//                     and -inf where start + c >= n_valid;
//   bmax (B, T/128)   the max of each 128-column strip of s.
// Row-major (B, T) is already the (B, T/128, 128) block-major layout the
// candidate gather reads, so no relayout is needed on the GPU. A block owns
// whole 128-column strips, so the strip maximum needs no atomics and no
// state carried between blocks (the TPU kernel carried the row strip across
// its sequential grid instead).
//
// 'high' (the search's default) is the TPU kernel's bf16x3 product,
// hi.hi + (hi.lo + lo.hi) with hi = bf16(x), lo = bf16(x - hi) and lo.lo
// dropped, on Hopper's tensor cores:
// - split pass (split_bf16_kernel<false>): q and db become hi/lo bf16 copies, K-major
//   with D zero-padded to a multiple of 64, so every row is whole 128-byte
//   swizzle atoms and 16-byte aligned for any D;
// - main loop (scores_high_kernel): a 128 x 128 output tile per block of two
//   warpgroups. All 256 threads stream a 3-stage ring of 64-deep bf16 tiles
//   (q_hi, q_lo, db_hi, db_lo: 64 KB a stage) with cp.async into
//   128-byte-swizzled shared memory; each warpgroup then runs, per 16-deep
//   step, three wgmma.mma_async.m64n128k16.f32.bf16.bf16 with both operands
//   K-major from shared memory: hi.hi into one fp32 accumulator, hi.lo and
//   lo.hi into a second. The epilogue adds them in the TPU kernel's order
//   (every product of two bf16 values is exact in fp32; only the order of
//   the fp32 sums differs);
// - epilogue: in the wgmma accumulator layout a row's 128 columns sit in one
//   quad of lanes, so the strip max is a per-thread max and two shuffles;
//   the l2 transform and the mask are applied in registers and s is stored
//   as float2.
// What bounds it on an H100. At the main path's shape (B = 8192, T = 16000,
// D = 512) 'high' is 3 bf16 products, 403 GFLOP (0.41 ms at 989 TFLOP/s),
// against 17 MB of inputs and 0.5 GB of s (0.16 ms at 3.35 TB/s): compute.
// The stores of s are not overlapped with the next tile's loads (one tile
// per block, one block per SM for its 193 KB of shared memory).
//
// 'highest' is the TPU's Precision.HIGHEST (lemon_tpu/ops/scoremax.py:66,
// "HIGHEST's 6" bf16 MXU passes, :56): x = hi + mid + lo with hi = bf16(x),
// mid = bf16(x - hi), lo = bf16((x - hi) - mid) (exact for normal x), and
// the six products hi.hi + (hi.mid + mid.hi + hi.lo + mid.mid + lo.hi);
// mid.lo, lo.mid and lo.lo are below 2^-26 of each term and dropped. (On the
// CPU the port computes 'highest' in fp32, as XLA:CPU does.)
// - split pass: split_bf16_kernel<true> writes the three pieces, laid out as
//   'high''s two (whose hi and lo are this hi and mid);
// - main loop (scores_highest_kernel): hopper.cuh's warp-specialised TMA
//   pipeline. A 128 x 128 output tile; a producer warpgroup whose one thread
//   loads, per 32-deep stage, the six 128-row pieces (8 KB each, 64-byte rows
//   in the 64-byte swizzle) into a ring of 4 stages (192 KB); two consumer
//   warpgroups run, per 16-deep step, six m64n128k16 products: hi.hi into
//   one fp32 accumulator and the five smaller ones into a second, so that
//   they are not rounded at the large sum's ulp; the epilogue adds the two as
//   'high''s does. A consumer keeps one stage's products in flight
//   (wait_group 1) and hands the stage before back. The grid is persistent,
//   one block an SM, over the tiles in grouped order (8 row tiles walk the
//   column tiles together, so the pieces in flight stay in L2), and a tile's
//   epilogue (l2 transform, mask, strip max by quad shuffles, s stored with
//   the streaming hint) overlaps the loads of the next tile's stages.
// What bounds it on an H100. At the main path's shape, 6 bf16 products are
// 805 GFLOP, 0.814 ms at 989 TFLOP/s, against the same 0.16 ms of bytes:
// compute (fp32 products on the CUDA cores, the kernel this one replaced,
// are bound at 2.003 ms). At the full rate a tile's 32-deep stage is 48 KB of
// pieces for 6.3 MFLOP, 7.5 TB/s from L2 over 132 SMs, and the shared
// memory of an SM takes the TMA writes (32 B a clock) and the wgmma operand
// reads of m64n128 (96 B a clock) at its 128 B a clock. The stages are 32
// deep so that four fit and the loads run three stages ahead of the
// products (64-deep stages would fit two). Registers decide the tile: two
// accumulators of m64n128 are 128 of a consumer's 232, which rules out
// m64n256 (one accumulator for all six products loses the small terms
// below the large sum's ulp). Measured on an H100
// (lemon_tpu_torch/benchmarks/k1_highest_limits.py): without its loads the
// kernel takes nearly as long, so the products with their shared-memory
// operand reads bound it and not L2; a cluster that multicasts the shared
// operand would cut only the L2 bytes, and is not used.
//
// Two probes' kernels are template flags (Out) of both kernels, 'ip' only:
// - P3, Out::kMaxOnly, replaces benchmarks/probe_knn_decomp.py `_bmax_kernel`
//   (launched by `bmax_only`, :95): the block maxima alone, no mask and no
//   store of s. Against K1 it prices the store of s: at q 8192 against a
//   131072-row tile that is 4.3 GB (1.28 ms at 3.35 TB/s), while P3 moves
//   0.3 GB and is bound by its products (3.34 ms 'high', 6.67 ms 'highest').
// - P2, Out::kTransposed, replaces benchmarks/probe_scoremax2.py `_kernel_t`
//   (launched by `fused_t`, :61): K1 with the block maxima written
//   transposed, (T/128, B). On the TPU that dodged a lane-store rule; here it
//   only asks which layout suits the block top-k, so the writes are the
//   row-major kernel's with the other index.
// The summation order is the same in every variant, so P3's maxima and P2's
// scores equal K1's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace lemon_hopper;

constexpr unsigned FULL = 0xffffffffu;

// What a kernel writes: K1's s and row-major block maxima, P3's block maxima
// alone, or P2's s and transposed block maxima.
enum class Out { kScoresRowMax, kMaxOnly, kTransposed };

// bmax index of (row, strip): (B, T/128), or (T/128, B) for P2
template <Out OUT>
__device__ __forceinline__ long long bmax_at(int row, int strip, int B, int n_strips) {
  return OUT == Out::kTransposed ? static_cast<long long>(strip) * B + row
                                 : static_cast<long long>(row) * n_strips + strip;
}

// ---------------------------------------------------------------- split

// One thread per 8 consecutive outputs of a row: hi = bf16_rn(x),
// mid = bf16_rn(x - hi) and, with THREE, lo = bf16_rn((x - hi) - mid); zero
// past D. Both differences are exact in fp32, so for a normal x the three
// pieces sum to x exactly.
template <bool THREE>
__global__ void split_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                                  __nv_bfloat16* __restrict__ mid, __nv_bfloat16* __restrict__ lo, long long N,
                                  int D, int Dp) {
  const int groups = Dp / 8;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N * groups) return;
  const long long r = i / groups;
  const int d0 = static_cast<int>(i % groups) * 8;
  __align__(16) __nv_bfloat16 h[8];
  __align__(16) __nv_bfloat16 m[8];
  __align__(16) __nv_bfloat16 l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = d0 + j;
    const float v = d < D ? x[r * D + d] : 0.f;
    h[j] = __float2bfloat16_rn(v);
    const float rest = v - __bfloat162float(h[j]);
    m[j] = __float2bfloat16_rn(rest);
    if (THREE) l[j] = __float2bfloat16_rn(rest - __bfloat162float(m[j]));
  }
  *reinterpret_cast<uint4*>(hi + r * Dp + d0) = *reinterpret_cast<const uint4*>(h);
  *reinterpret_cast<uint4*>(mid + r * Dp + d0) = *reinterpret_cast<const uint4*>(m);
  if (THREE) *reinterpret_cast<uint4*>(lo + r * Dp + d0) = *reinterpret_cast<const uint4*>(l);
}

// ---------------------------------------------------------------- high

constexpr int HM = 128;                    // query rows per block: 2 warpgroups x 64
constexpr int HN = 128;                    // database columns per block: one strip
constexpr int HK = 64;                     // depth of a stage: one 128-byte swizzle atom of bf16
constexpr int HSTAGES = 3;
constexpr int HTHREADS = 256;
constexpr int TILE_BYTES = 128 * HK * 2;   // 128 rows of 128 B
constexpr int STAGE_BYTES = 4 * TILE_BYTES;  // q_hi, q_lo, db_hi, db_lo
constexpr int HIGH_SMEM = HSTAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 B

template <bool L2, Out OUT>
__global__ void __launch_bounds__(HTHREADS, 1)
scores_high_kernel(const __nv_bfloat16* __restrict__ q_hi, const __nv_bfloat16* __restrict__ q_lo,
                   const __nv_bfloat16* __restrict__ db_hi, const __nv_bfloat16* __restrict__ db_lo,
                   const float* __restrict__ qsq, const float* __restrict__ dbsq, float* __restrict__ s,
                   float* __restrict__ bmax, int B, int T, int Dp, long long start, long long n_valid) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = blockIdx.y * HM;
  const int col0 = blockIdx.x * HN;
  const int n_k = Dp / HK;

  // Stage `kt` of the four operands into ring slot `slot`: 128 rows x 8
  // chunks of 16 B per operand, chunk j of row r stored at chunk j ^ (r % 8)
  // (the 128-byte swizzle); query rows past B read as zeros.
  auto load_stage = [&](int kt, int slot) {
    const uint32_t st = ring + slot * STAGE_BYTES;
    const int k0 = kt * HK;
#pragma unroll
    for (int i = 0; i < HM * 8 / HTHREADS; ++i) {
      const int id = tid + i * HTHREADS;
      const int r = id >> 3, j = id & 7;
      const uint32_t off = r * 128 + ((j ^ (r & 7)) << 4);
      const bool ok = row0 + r < B;
      const long long qo = static_cast<long long>(ok ? row0 + r : 0) * Dp + k0 + j * 8;
      const long long dbo = static_cast<long long>(col0 + r) * Dp + k0 + j * 8;
      cp_async16(st + off, q_hi + qo, ok ? 16 : 0);
      cp_async16(st + TILE_BYTES + off, q_lo + qo, ok ? 16 : 0);
      cp_async16(st + 2 * TILE_BYTES + off, db_hi + dbo, 16);
      cp_async16(st + 3 * TILE_BYTES + off, db_lo + dbo, 16);
    }
  };

  float acc[64], acc_x[64];  // hi.hi, and hi.lo + lo.hi
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = acc_x[i] = 0.f;

#pragma unroll
  for (int st = 0; st < HSTAGES - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<HSTAGES - 2>();
    fence_async_barrier();  // every thread's stage kt has landed and is visible to wgmma; slot (kt-1) % HSTAGES is free
    if (kt + HSTAGES - 1 < n_k) load_stage(kt + HSTAGES - 1, (kt + HSTAGES - 1) % HSTAGES);
    cp_async_commit();

    const uint32_t st = ring + (kt % HSTAGES) * STAGE_BYTES;
    const uint32_t a_hi = st + wg * 64 * 128;  // this warpgroup's 64 query rows
    const uint32_t a_lo = a_hi + TILE_BYTES;
    const uint32_t b_hi = st + 2 * TILE_BYTES;
    const uint32_t b_lo = st + 3 * TILE_BYTES;
    fence_operands(acc);
    fence_operands(acc_x);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HK / 16; ++kk) {
      const uint32_t o = kk * 32;  // 16 bf16 further along K, inside the swizzle atom
      wgmma_m64n128k16(acc, smem_desc(a_hi + o), smem_desc(b_hi + o));
      wgmma_m64n128k16(acc_x, smem_desc(a_hi + o), smem_desc(b_lo + o));
      wgmma_m64n128k16(acc_x, smem_desc(a_lo + o), smem_desc(b_hi + o));
    }
    wgmma_commit();
    wgmma_wait();
    fence_operands(acc);
    fence_operands(acc_x);
  }

  // Accumulator layout (m64nNk16, fp32): warp w of the warpgroup holds rows
  // 16w + lane/4 (registers 4i, 4i+1) and 16w + lane/4 + 8 (4i+2, 4i+3), at
  // columns 8i + 2(lane%4) and the next one.
  const int n_strips = T / HN;
  const int rloc = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + rloc + 8 * h;
    const bool row_ok = gr < B;
    const float qs = (L2 && row_ok) ? qsq[gr] : 0.f;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < HN / 8; ++i) {
      const int c = col0 + 8 * i + 2 * (lane & 3);
      float v0 = acc[4 * i + 2 * h] + acc_x[4 * i + 2 * h];
      float v1 = acc[4 * i + 2 * h + 1] + acc_x[4 * i + 2 * h + 1];
      if (L2) {
        v0 = -((qs - 2.f * v0) + dbsq[c]);
        v1 = -((qs - 2.f * v1) + dbsq[c + 1]);
      }
      if (start + c >= n_valid) v0 = -CUDART_INF_F;
      if (start + c + 1 >= n_valid) v1 = -CUDART_INF_F;
      if (OUT != Out::kMaxOnly && row_ok)
        *reinterpret_cast<float2*>(s + static_cast<long long>(gr) * T + c) = make_float2(v0, v1);
      m = fmaxf(m, fmaxf(v0, v1));
    }
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
    if ((lane & 3) == 0 && row_ok) bmax[bmax_at<OUT>(gr, blockIdx.x, B, n_strips)] = m;
  }
}

// ---------------------------------------------------------------- highest

constexpr int XM = 128;                  // query rows of a tile: 2 consumer warpgroups x 64
constexpr int XN = 128;                  // database columns of a tile: one strip
constexpr int XK = 32;                   // depth of a stage: one 64-byte swizzle row of bf16
constexpr int XSTAGES = 4;
constexpr int XGROUP_M = 8;              // row tiles a group of the tile order spans
constexpr int XTILE_BYTES = 128 * XK * 2;        // one piece of one operand: 128 rows of 64 B
constexpr int XSTAGE_BYTES = 6 * XTILE_BYTES;    // q hi, mid, lo; db hi, mid, lo
constexpr int XBAR_OFF = XSTAGES * XSTAGE_BYTES;  // full[XSTAGES], empty[XSTAGES]
constexpr int HIGHEST_SMEM = XBAR_OFF + 2 * XSTAGES * 8 + 1024;  // + slack to align the ring to 1024 B

// The TMA maps of the three pieces of each operand, (rows, Dp) bf16.
struct SplitMaps {
  CUtensorMap q[3];
  CUtensorMap db[3];
};

template <bool L2, Out OUT>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
scores_highest_kernel(const __grid_constant__ SplitMaps maps, const float* __restrict__ qsq,
                      const float* __restrict__ dbsq, float* __restrict__ s, float* __restrict__ bmax, int B, int T,
                      int Dp, long long start, long long n_valid) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  auto full = [&](int st) { return ring + XBAR_OFF + 8 * st; };
  auto empty = [&](int st) { return ring + XBAR_OFF + 8 * (XSTAGES + st); };
  const int n_m = (B + XM - 1) / XM, n_n = T / XN;
  const int n_tiles = n_m * n_n;
  const int n_k = Dp / XK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int st = 0; st < XSTAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);  // one arrival from each consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread keeps the ring full, across tiles. Query rows
    // past B load as zeros.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      RingPos<XSTAGES> pos;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int tm, tn;
        tile_at<XGROUP_M>(tile, n_m, n_n, tm, tn);
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(empty(pos.stage), pos.phase ^ 1);
          const uint32_t st = ring + pos.stage * XSTAGE_BYTES;
          mbar_arrive_expect_tx(full(pos.stage), XSTAGE_BYTES);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            tma_load_2d(st + p * XTILE_BYTES, &maps.q[p], full(pos.stage), kt * XK, tm * XM);
            tma_load_2d(st + (3 + p) * XTILE_BYTES, &maps.db[p], full(pos.stage), kt * XK, tn * XN);
          }
          pos.advance();
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;  // this consumer's 64 rows of the tile
  const int tid = threadIdx.x & 127;
  const bool lead = tid == 0;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_strips = T / XN;
  RingPos<XSTAGES> pos;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int tm, tn;
    tile_at<XGROUP_M>(tile, n_m, n_n, tm, tn);
    float acc[64], acc_x[64];  // hi.hi, and the five smaller products
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = acc_x[i] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(full(pos.stage), pos.phase);
      const uint32_t a = ring + pos.stage * XSTAGE_BYTES + cw * 64 * XK * 2;  // q hi; mid, lo a tile further each
      const uint32_t b = ring + pos.stage * XSTAGE_BYTES + 3 * XTILE_BYTES;  // db hi; mid, lo likewise
      fence_operands(acc);
      fence_operands(acc_x);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < XK / 16; ++kk) {
        const uint32_t o = kk * 32;  // 16 bf16 further along K, inside the 64-byte row
        const uint64_t qh = smem_desc_sw64(a + o), qm = smem_desc_sw64(a + XTILE_BYTES + o),
                       ql = smem_desc_sw64(a + 2 * XTILE_BYTES + o);
        const uint64_t dh = smem_desc_sw64(b + o), dm = smem_desc_sw64(b + XTILE_BYTES + o),
                       dl = smem_desc_sw64(b + 2 * XTILE_BYTES + o);
        wgmma_m64n128k16(acc, qh, dh);
        wgmma_m64n128k16(acc_x, qh, dm);
        wgmma_m64n128k16(acc_x, qm, dh);
        wgmma_m64n128k16(acc_x, qh, dl);
        wgmma_m64n128k16(acc_x, qm, dm);
        wgmma_m64n128k16(acc_x, ql, dh);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand it back
      fence_operands(acc);
      fence_operands(acc_x);
      if (kt > 0 && lead) mbar_arrive(empty(prev));
      prev = pos.stage;
      pos.advance();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(acc_x);
    if (lead) mbar_arrive(empty(prev));

    // Epilogue, while the producer already loads the next tile. Accumulator
    // layout (m64nNk16, fp32): warp w holds rows 16w + lane/4 (registers 4i,
    // 4i+1) and 16w + lane/4 + 8 (4i+2, 4i+3) at columns 8i + 2(lane%4) and
    // the next one. s is stored with the streaming hint: it is not read
    // again here, and the operands should keep L2.
    const int col0 = tn * XN;
    const int rloc = tm * XM + cw * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = rloc + 8 * h;
      const bool row_ok = gr < B;
      const float qs = (L2 && row_ok) ? qsq[gr] : 0.f;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < XN / 8; ++i) {
        const int c = col0 + 8 * i + 2 * (lane & 3);
        float v0 = acc[4 * i + 2 * h] + acc_x[4 * i + 2 * h];
        float v1 = acc[4 * i + 2 * h + 1] + acc_x[4 * i + 2 * h + 1];
        if (L2) {
          v0 = -((qs - 2.f * v0) + dbsq[c]);
          v1 = -((qs - 2.f * v1) + dbsq[c + 1]);
        }
        if (start + c >= n_valid) v0 = -CUDART_INF_F;
        if (start + c + 1 >= n_valid) v1 = -CUDART_INF_F;
        if (OUT != Out::kMaxOnly && row_ok)
          __stcs(reinterpret_cast<float2*>(s + static_cast<long long>(gr) * T + c), make_float2(v0, v1));
        m = fmaxf(m, fmaxf(v0, v1));
      }
      m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
      m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
      if ((lane & 3) == 0 && row_ok) bmax[bmax_at<OUT>(gr, tn, B, n_strips)] = m;
    }
  }
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/scoremax.py).
// Each returns cudaGetLastError() after its launch.

// hi, lo (N, Dp) bf16 from x (N, D) fp32; Dp is a multiple of 64, >= D.
extern "C" int lemon_split_bf16(const float* x, void* hi, void* lo, long long N, int D, int Dp, void* stream) {
  const long long n = N * (Dp / 8);
  const int threads = 256;
  split_bf16_kernel<false><<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, static_cast<__nv_bfloat16*>(hi),
                                                                  static_cast<__nv_bfloat16*>(lo), nullptr, N, D, Dp);
  return static_cast<int>(cudaGetLastError());
}

// hi, mid, lo (N, Dp) bf16 from x (N, D) fp32, as lemon_split_bf16 with a
// third piece; hi and mid are lemon_split_bf16's hi and lo.
extern "C" int lemon_split_bf16x3(const float* x, void* hi, void* mid, void* lo, long long N, int D, int Dp,
                                  void* stream) {
  const long long n = N * (Dp / 8);
  const int threads = 256;
  split_bf16_kernel<true><<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(mid), static_cast<__nv_bfloat16*>(lo), N, D, Dp);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool L2, Out OUT>
int launch_high(const __nv_bfloat16* qh, const __nv_bfloat16* ql, const __nv_bfloat16* dh, const __nv_bfloat16* dl,
                const float* qsq, const float* dbsq, float* s, float* bmax, int B, int T, int Dp, long long start,
                long long n_valid, cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(scores_high_kernel<L2, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, HIGH_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(T / HN, (B + HM - 1) / HM);
  scores_high_kernel<L2, OUT><<<grid, HTHREADS, HIGH_SMEM, st>>>(qh, ql, dh, dl, qsq, dbsq, s, bmax, B, T, Dp, start,
                                                                 n_valid);
  return static_cast<int>(cudaGetLastError());
}

template <bool L2, Out OUT>
int launch_highest(const SplitMaps& maps, const float* qsq, const float* dbsq, float* s, float* bmax, int B, int T,
                   int Dp, long long start, long long n_valid, cudaStream_t st) {
  static int cached[64] = {};
  int sms = 0;
  const int e = prepare_launch(reinterpret_cast<const void*>(scores_highest_kernel<L2, OUT>), HIGHEST_SMEM, cached,
                               &sms);
  if (e != 0) return e;
  const int n_tiles = ((B + XM - 1) / XM) * (T / XN);
  scores_highest_kernel<L2, OUT><<<n_tiles < sms ? n_tiles : sms, PIPE_THREADS, HIGHEST_SMEM, st>>>(
      maps, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 'high' from the split operands: T a multiple of 128, 0 < B <= 65535 * 128,
// Dp a multiple of 64. qsq (B,) and dbsq (T,) are read only when l2 != 0.
// out: 0 K1 (s, bmax (B, T/128)), 1 P3 (bmax only; s is not touched),
// 2 P2 (s, bmax (T/128, B)); 1 and 2 take 'ip' only.
extern "C" int lemon_scores_blockmax_high(const void* q_hi, const void* q_lo, const void* db_hi, const void* db_lo,
                                          const float* qsq, const float* dbsq, float* s, float* bmax, int B, int T,
                                          int Dp, long long start, long long n_valid, int l2, int out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qh = static_cast<const __nv_bfloat16*>(q_hi);
  const auto* ql = static_cast<const __nv_bfloat16*>(q_lo);
  const auto* dh = static_cast<const __nv_bfloat16*>(db_hi);
  const auto* dl = static_cast<const __nv_bfloat16*>(db_lo);
  if (l2 && out != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (l2) return launch_high<true, Out::kScoresRowMax>(qh, ql, dh, dl, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
  if (out == 1) return launch_high<false, Out::kMaxOnly>(qh, ql, dh, dl, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
  if (out == 2)
    return launch_high<false, Out::kTransposed>(qh, ql, dh, dl, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
  return launch_high<false, Out::kScoresRowMax>(qh, ql, dh, dl, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
}

// 'highest' from the three-piece split operands (lemon_split_bf16x3): T a
// multiple of 128, Dp a multiple of 64, (B / 128 rounded up) * (T / 128) < 2^31
// tiles; qsq, dbsq and out as for 'high'. Returns the first error of the
// tensor maps' encoding or of the launch.
extern "C" int lemon_scores_blockmax_highest(const void* q_hi, const void* q_mid, const void* q_lo,
                                             const void* db_hi, const void* db_mid, const void* db_lo,
                                             const float* qsq, const float* dbsq, float* s, float* bmax, int B, int T,
                                             int Dp, long long start, long long n_valid, int l2, int out,
                                             void* stream) {
  if (l2 && out != 0) return static_cast<int>(cudaErrorInvalidValue);
  SplitMaps maps;
  const void* q[3] = {q_hi, q_mid, q_lo};
  const void* db[3] = {db_hi, db_mid, db_lo};
  const cuuint64_t dims_q[2] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(B)};
  const cuuint64_t dims_db[2] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(T)};
  const cuuint64_t row[1] = {static_cast<cuuint64_t>(Dp) * 2};
  const cuuint32_t box[2] = {XK, 128};  // 64 B x 128 rows: XM == XN
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw64 = CU_TENSOR_MAP_SWIZZLE_64B;
  int e = 0;
  for (int p = 0; p < 3 && e == 0; ++p) {
    e = encode_tensor_map(&maps.q[p], bf16, 2, q[p], dims_q, row, box, sw64);
    if (e == 0) e = encode_tensor_map(&maps.db[p], bf16, 2, db[p], dims_db, row, box, sw64);
  }
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l2) return launch_highest<true, Out::kScoresRowMax>(maps, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
  if (out == 1) return launch_highest<false, Out::kMaxOnly>(maps, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
  if (out == 2) return launch_highest<false, Out::kTransposed>(maps, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
  return launch_highest<false, Out::kScoresRowMax>(maps, qsq, dbsq, s, bmax, B, T, Dp, start, n_valid, st);
}
