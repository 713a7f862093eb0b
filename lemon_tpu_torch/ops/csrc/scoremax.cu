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
// - split pass (split_bf16_kernel): q and db become hi/lo bf16 copies, K-major
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
// 'highest' is exact fp32 products on the CUDA cores (67 TFLOP/s): a 64 x 128
// output tile per 256-thread block, q and db staged through shared memory 16
// columns of D at a time (the next slice loaded into registers during the
// current one's products), 8 x 4 accumulators per thread, the strip max a
// warp shuffle reduction.
//
// Two probes' kernels are template flags (Out) of both kernels, 'ip' only:
// - P3, Out::kMaxOnly, replaces benchmarks/probe_knn_decomp.py `_bmax_kernel`
//   (launched by `bmax_only`, :95): the block maxima alone, no mask and no
//   store of s. Against K1 it prices the store of s: at q 8192 against a
//   131072-row tile that is 4.3 GB (1.28 ms at 3.35 TB/s), while P3 moves
//   0.3 GB and is bound by its products (3.34 ms 'high', 16.4 ms 'highest').
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

// ---------------------------------------------------------------- highest

constexpr int BM = 64;   // query rows per block
constexpr int BN = 128;  // database columns per block: one block-max strip
constexpr int BK = 16;   // depth of one shared-memory stage
constexpr int THREADS = 256;
constexpr int ROWS = BM / (THREADS / 32);  // 8 rows per warp
constexpr int COLS = BN / 32;              // 4 columns per lane, strided by 32

// What a kernel writes: K1's s and row-major block maxima, P3's block maxima
// alone, or P2's s and transposed block maxima.
enum class Out { kScoresRowMax, kMaxOnly, kTransposed };

// bmax index of (row, strip): (B, T/128), or (T/128, B) for P2
template <Out OUT>
__device__ __forceinline__ long long bmax_at(int row, int strip, int B, int n_strips) {
  return OUT == Out::kTransposed ? static_cast<long long>(strip) * B + row
                                 : static_cast<long long>(row) * n_strips + strip;
}

template <bool L2, Out OUT>
__global__ void __launch_bounds__(THREADS)
scores_highest_kernel(const float* __restrict__ q, const float* __restrict__ db, const float* __restrict__ qsq,
                      const float* __restrict__ dbsq, float* __restrict__ s, float* __restrict__ bmax, int B, int T,
                      int D, long long start, long long n_valid) {
  // +1 padding spreads the transposed stores over the banks.
  __shared__ float a_s[BK][BM + 1];
  __shared__ float b_s[BK][BN + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[i][j] = 0.f;

  // The next 16-deep slice is loaded into registers while this one is
  // multiplied out of shared memory.
  constexpr int A_PER = BM * BK / THREADS, B_PER = BN * BK / THREADS;
  float ra[A_PER], rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < A_PER; ++it) {
      const int idx = tid + it * THREADS;
      const int gr = row0 + idx / BK, gk = k0 + idx % BK;
      ra[it] = (gr < B && gk < D) ? q[(long long)gr * D + gk] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < B_PER; ++it) {
      const int idx = tid + it * THREADS;
      const int gc = col0 + idx / BK, gk = k0 + idx % BK;
      rb[it] = (gc < T && gk < D) ? db[(long long)gc * D + gk] : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int it = 0; it < A_PER; ++it) a_s[(tid + it * THREADS) % BK][(tid + it * THREADS) / BK] = ra[it];
#pragma unroll
    for (int it = 0; it < B_PER; ++it) b_s[(tid + it * THREADS) % BK][(tid + it * THREADS) / BK] = rb[it];
    __syncthreads();
    if (k0 + BK < D) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[ROWS], b[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = a_s[kk][warp * ROWS + i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) b[j] = b_s[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n_strips = T / BN;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gr = row0 + warp * ROWS + i;
    const bool row_ok = gr < B;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = col0 + lane + 32 * j;
      float v = acc[i][j];
      if (L2) v = -(((row_ok ? qsq[gr] : 0.f) - 2.f * v) + dbsq[c]);
      if (start + c >= n_valid) v = -CUDART_INF_F;
      if (OUT != Out::kMaxOnly && row_ok) s[(long long)gr * T + c] = v;
      m = fmaxf(m, v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    if (lane == 0 && row_ok) bmax[bmax_at<OUT>(gr, blockIdx.x, B, n_strips)] = m;
  }
}

// ---------------------------------------------------------------- split

// One thread per 8 consecutive outputs of a row: hi = bf16_rn(x),
// lo = bf16_rn(x - hi), zero past D.
__global__ void split_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                                  __nv_bfloat16* __restrict__ lo, long long N, int D, int Dp) {
  const int groups = Dp / 8;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N * groups) return;
  const long long r = i / groups;
  const int d0 = static_cast<int>(i % groups) * 8;
  __align__(16) __nv_bfloat16 h[8];
  __align__(16) __nv_bfloat16 l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = d0 + j;
    const float v = d < D ? x[r * D + d] : 0.f;
    h[j] = __float2bfloat16_rn(v);
    l[j] = __float2bfloat16_rn(v - __bfloat162float(h[j]));
  }
  *reinterpret_cast<uint4*>(hi + r * Dp + d0) = *reinterpret_cast<const uint4*>(h);
  *reinterpret_cast<uint4*>(lo + r * Dp + d0) = *reinterpret_cast<const uint4*>(l);
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

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/scoremax.py).
// Each returns cudaGetLastError() after its launch.

// hi, lo (N, Dp) bf16 from x (N, D) fp32; Dp is a multiple of 64, >= D.
extern "C" int lemon_split_bf16(const float* x, void* hi, void* lo, long long N, int D, int Dp, void* stream) {
  const long long n = N * (Dp / 8);
  const int threads = 256;
  split_bf16_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, static_cast<__nv_bfloat16*>(hi),
                                                           static_cast<__nv_bfloat16*>(lo), N, D, Dp);
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
int launch_highest(const float* q, const float* db, const float* qsq, const float* dbsq, float* s, float* bmax, int B,
                   int T, int D, long long start, long long n_valid, cudaStream_t st) {
  const dim3 grid(T / BN, (B + BM - 1) / BM);
  scores_highest_kernel<L2, OUT><<<grid, THREADS, 0, st>>>(q, db, qsq, dbsq, s, bmax, B, T, D, start, n_valid);
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

// 'highest': T a multiple of 128 and 0 < B <= 65535 * 64; out as for 'high'.
extern "C" int lemon_scores_blockmax_highest(const float* q, const float* db, const float* qsq, const float* dbsq,
                                             float* s, float* bmax, int B, int T, int D, long long start,
                                             long long n_valid, int l2, int out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l2 && out != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (l2) return launch_highest<true, Out::kScoresRowMax>(q, db, qsq, dbsq, s, bmax, B, T, D, start, n_valid, st);
  if (out == 1) return launch_highest<false, Out::kMaxOnly>(q, db, qsq, dbsq, s, bmax, B, T, D, start, n_valid, st);
  if (out == 2) return launch_highest<false, Out::kTransposed>(q, db, qsq, dbsq, s, bmax, B, T, D, start, n_valid, st);
  return launch_highest<false, Out::kScoresRowMax>(q, db, qsq, dbsq, s, bmax, B, T, D, start, n_valid, st);
}
