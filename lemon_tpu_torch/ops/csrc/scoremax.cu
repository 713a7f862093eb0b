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
// Both precisions are the TPU's own: products of bf16 pieces of each operand
// on the tensor cores, hi = bf16_rn(x) and each further piece the bf16 of
// what the pieces before it leave (each difference exact in fp32):
// - 'high' (the search's default) is the TPU kernel's bf16x3: two pieces,
//   hi.hi + (hi.lo + lo.hi), lo.lo dropped;
// - 'highest' is the TPU's Precision.HIGHEST (lemon_tpu/ops/scoremax.py:66,
//   "HIGHEST's 6" bf16 MXU passes, :56): three pieces hi, mid, lo (exact for
//   normal x), hi.hi + (hi.mid + mid.hi + hi.lo + mid.mid + lo.hi); mid.lo,
//   lo.mid and lo.lo are below 2^-26 of each term and dropped. (On the CPU
//   the port computes 'highest' in fp32, as XLA:CPU does.)
// Every product of two bf16 values is exact in fp32; only the order of the
// fp32 sums differs from the TPU's.
//
// Two kernels a call.
// - split pass (split_bf16_kernel): q and db become their bf16 pieces,
//   K-major with D zero-padded to a multiple of 64 (whole swizzle rows,
//   16-byte aligned for any D); 'highest''s hi and mid are 'high''s hi, lo.
// - main loop (scores_split_kernel<PIECES>, one template for both): the
//   warp-specialised TMA pipeline of hopper.cuh. A 128 x 128 output tile; a
//   producer warpgroup whose one thread loads, per 32-deep stage, the 2 x
//   PIECES 128-row pieces (8 KB each, 64-byte rows in the 64-byte swizzle)
//   into a ring of 4 stages; two consumer warpgroups run, per 16-deep step,
//   hi.hi into one fp32 accumulator and the smaller products into a second
//   (so that they are not rounded at the large sum's ulp), then add the two.
//   A consumer keeps one stage's products in flight (wait_group 1) and hands
//   the stage before back. The grid is persistent, one block an SM, over the
//   tiles in grouped order (8 row tiles walk the column tiles together, so
//   the pieces in flight stay in L2). A tile's epilogue overlaps the loads
//   of the next tile's stages: the l2 transform and the mask in registers,
//   the strip max by quad shuffles (in the wgmma accumulator layout a row's
//   128 columns sit in one quad of lanes), and s staged in 32-column chunks
//   through shared memory and stored by TMA.
// At two pieces the products are the ones the cp.async kernel this one
// replaced ran, in the same order, into the same two accumulators, over the
// same k16 steps: s and the maxima are that kernel's bit for bit.
//
// What bounds it on an H100. At the main path's shape (B = 8192, T = 16000,
// D = 512) the products are 403 GFLOP at 'high' (0.407 ms at 989 TFLOP/s)
// and 805 GFLOP at 'highest' (0.814 ms), against 17 MB of inputs and 0.52 GB
// of s (0.156 ms at 3.35 TB/s): operations. Registers decide the tile: two
// m64n128 accumulators are 128 of a consumer's 232, which rules out m64n256
// (one accumulator for all products loses the small terms below the large
// sum's ulp). At the full rate a tile's 32-deep stage feeds its products
// with 32 KB of pieces at 'high' (3.1 MFLOP) and 48 KB at 'highest' (6.3
// MFLOP): 10.3 and 7.5 TB/s from L2 over 132 SMs. The shared memory of an SM
// takes the TMA writes and the wgmma operand reads of m64n128 (96 B a clock)
// at its 128 B a clock. Measured on an H100
// (lemon_tpu_torch/benchmarks/k1_limits.py): without its loads the kernel
// takes nearly as long at both piece counts, so the products with their
// shared-memory operand reads set the pace and not L2; at 'high' the loads
// with hi.hi alone take about the products' bound, so they come close
// behind. A cluster that multicasts the shared operand would cut only the
// L2 bytes, and is not used. Staging s for TMA stores, where the consumers
// stored it from registers, took the main kernel at 'high' from 0.68 to
// 0.62-0.64 ms at that shape.
//
// Two probes' kernels are template flags (Out) of the same kernel, 'ip' only:
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

// ---------------------------------------------------------------- main loop

constexpr int TM = 128;                    // query rows of a tile: 2 consumer warpgroups x 64
constexpr int TN = 128;                    // database columns of a tile: one strip
constexpr int TK = 32;                     // depth of a stage: one 64-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int GROUP_M = 8;                 // row tiles a group of the tile order spans
constexpr int PIECE_BYTES = 128 * TK * 2;  // one piece of one operand: 128 rows of 64 B
constexpr int CHUNK_BYTES = 64 * 128;      // an epilogue buffer: 64 rows x 32 columns of s

// Shared memory of the instance with PIECES pieces: the ring, each consumer's
// epilogue buffers, then the barriers full[STAGES] and empty[STAGES].
// 'high' has room for a buffer for each 32-column chunk of its 64 x 128
// quarter of the tile; 'highest' (48 KB stages) for two, used in turn.
template <int PIECES>
struct Layout {
  static constexpr int kStageBytes = 2 * PIECES * PIECE_BYTES;  // q's pieces, then db's
  static constexpr int kEpiBufs = PIECES == 2 ? 4 : 2;
  static constexpr int kEpiOff = STAGES * kStageBytes;
  static constexpr int kBarOff = kEpiOff + 2 * kEpiBufs * CHUNK_BYTES;
  static constexpr int kSmem = kBarOff + 2 * STAGES * 8 + 1024;  // + slack to align the ring to 1024 B
};

// The TMA maps: the pieces of each operand, (rows, Dp) bf16 (the third unused
// at two pieces), and s, (B, T) fp32 in boxes of 64 rows x 32 columns (unused
// by P3).
struct SplitMaps {
  CUtensorMap q[3];
  CUtensorMap db[3];
  CUtensorMap s;
};

// Two neighbouring scores of a row from the two accumulators: the large
// product plus the small ones, the l2 transform, the mask. Every instance
// goes through this one function, so that all of them round alike.
template <bool L2>
__device__ __forceinline__ float2 score_pair(float acc0, float x0, float acc1, float x1, float qs,
                                             const float* __restrict__ dbsq, int c, long long start,
                                             long long n_valid) {
  float v0 = acc0 + x0;
  float v1 = acc1 + x1;
  if (L2) {
    v0 = -((qs - 2.f * v0) + dbsq[c]);
    v1 = -((qs - 2.f * v1) + dbsq[c + 1]);
  }
  if (start + c >= n_valid) v0 = -CUDART_INF_F;
  if (start + c + 1 >= n_valid) v1 = -CUDART_INF_F;
  return make_float2(v0, v1);
}

template <int PIECES, bool L2, Out OUT>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
scores_split_kernel(const __grid_constant__ SplitMaps maps, const float* __restrict__ qsq,
                    const float* __restrict__ dbsq, float* __restrict__ bmax, int B, int T, int Dp, long long start,
                    long long n_valid) {
  using L = Layout<PIECES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);  // swizzle atoms
  const uint32_t ring = smem_u32(base);
  auto full = [&](int st) { return ring + L::kBarOff + 8 * st; };
  auto empty = [&](int st) { return ring + L::kBarOff + 8 * (STAGES + st); };
  const int n_m = (B + TM - 1) / TM, n_n = T / TN;
  const int n_tiles = n_m * n_n;
  const int n_k = Dp / TK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
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
      RingPos<STAGES> pos;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int tm, tn;
        tile_at<GROUP_M>(tile, n_m, n_n, tm, tn);
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(empty(pos.stage), pos.phase ^ 1);
          const uint32_t st = ring + pos.stage * L::kStageBytes;
          mbar_arrive_expect_tx(full(pos.stage), L::kStageBytes);
#pragma unroll
          for (int p = 0; p < PIECES; ++p) {
            tma_load_2d(st + p * PIECE_BYTES, &maps.q[p], full(pos.stage), kt * TK, tm * TM);
            tma_load_2d(st + (PIECES + p) * PIECE_BYTES, &maps.db[p], full(pos.stage), kt * TK, tn * TN);
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
  const int g = lane >> 2, t = lane & 3;
  const int n_strips = T / TN;
  unsigned char* const epi = base + L::kEpiOff + cw * L::kEpiBufs * CHUNK_BYTES;
  int n_stores = 0;
  RingPos<STAGES> pos;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int tm, tn;
    tile_at<GROUP_M>(tile, n_m, n_n, tm, tn);
    float acc[64], acc_x[64];  // hi.hi, and the smaller products
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = acc_x[i] = 0.f;
    int prev = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(full(pos.stage), pos.phase);
      const uint32_t a = ring + pos.stage * L::kStageBytes + cw * 64 * TK * 2;  // q hi; each next piece 8 KB on
      const uint32_t b = ring + pos.stage * L::kStageBytes + PIECES * PIECE_BYTES;  // db hi; likewise
      fence_operands(acc);
      fence_operands(acc_x);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint32_t o = kk * 32;  // 16 bf16 further along K, inside the 64-byte row
        const uint64_t q0 = smem_desc_sw64(a + o), q1 = smem_desc_sw64(a + PIECE_BYTES + o);
        const uint64_t d0 = smem_desc_sw64(b + o), d1 = smem_desc_sw64(b + PIECE_BYTES + o);
        wgmma_m64n128k16(acc, q0, d0);    // hi.hi
        wgmma_m64n128k16(acc_x, q0, d1);  // hi.lo ('high'), hi.mid ('highest')
        wgmma_m64n128k16(acc_x, q1, d0);  // lo.hi, mid.hi
        if constexpr (PIECES == 3) {
          const uint64_t q2 = smem_desc_sw64(a + 2 * PIECE_BYTES + o), d2 = smem_desc_sw64(b + 2 * PIECE_BYTES + o);
          wgmma_m64n128k16(acc_x, q0, d2);  // hi.lo
          wgmma_m64n128k16(acc_x, q1, d1);  // mid.mid
          wgmma_m64n128k16(acc_x, q2, d0);  // lo.hi
        }
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

    // Epilogue, while the producer already loads the next tile, by 32-column
    // chunks. Accumulator layout (m64nNk16, fp32): warp w holds rows 16w + g
    // (registers 4i, 4i+1) and 16w + g + 8 (4i+2, 4i+3) at columns 8i + 2t
    // and the next one. A chunk of s goes into the buffer whose last store
    // has finished reading it, in the 128-byte swizzle the store's tensor
    // map expects, and leaves by TMA, which clips rows past B. The strip
    // maxima are plain stores.
    const int col0 = tn * TN;
    const int row0 = tm * TM + cw * 64;
    float qs[2], m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + warp * 16 + g + 8 * h;
      qs[h] = (L2 && gr < B) ? qsq[gr] : 0.f;
      m[h] = -CUDART_INF_F;
    }
#pragma unroll
    for (int c = 0; c < TN / 32; ++c) {
      unsigned char* const buf = epi + (n_stores % L::kEpiBufs) * CHUNK_BYTES;
      if (OUT != Out::kMaxOnly) {
        if (lead) bulk_wait_read<L::kEpiBufs - 1>();
        named_sync(1 + cw, 128);
      }
#pragma unroll
      for (int ib = 0; ib < 4; ++ib) {
        const int i = 4 * c + ib;
        const int byte = (8 * ib + 2 * t) * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = score_pair<L2>(acc[4 * i + 2 * h], acc_x[4 * i + 2 * h], acc[4 * i + 2 * h + 1],
                                          acc_x[4 * i + 2 * h + 1], qs[h], dbsq, col0 + 8 * i + 2 * t, start,
                                          n_valid);
          m[h] = fmaxf(m[h], fmaxf(v.x, v.y));
          if (OUT != Out::kMaxOnly) {
            const int r = warp * 16 + g + 8 * h;
            *reinterpret_cast<float2*>(buf + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)) = v;
          }
        }
      }
      if (OUT != Out::kMaxOnly) {
        fence_proxy_async();
        named_sync(1 + cw, 128);
        if (lead) {
          tma_store_2d(&maps.s, smem_u32(buf), col0 + 32 * c, row0);
          bulk_commit();
        }
        ++n_stores;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + warp * 16 + g + 8 * h;
      float mh = fmaxf(m[h], __shfl_xor_sync(FULL, m[h], 1));
      mh = fmaxf(mh, __shfl_xor_sync(FULL, mh, 2));
      if (t == 0 && gr < B) bmax[bmax_at<OUT>(gr, tn, B, n_strips)] = mh;
    }
  }
  if (OUT != Out::kMaxOnly && lead) bulk_wait_all();
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

template <int PIECES, bool L2, Out OUT>
int launch(const SplitMaps& maps, const float* qsq, const float* dbsq, float* bmax, int B, int T, int Dp,
           long long start, long long n_valid, cudaStream_t st) {
  static int cached[64] = {};
  int sms = 0;
  const auto kernel = scores_split_kernel<PIECES, L2, OUT>;
  const int e = prepare_launch(reinterpret_cast<const void*>(kernel), Layout<PIECES>::kSmem, cached, &sms);
  if (e != 0) return e;
  const int n_tiles = ((B + TM - 1) / TM) * (T / TN);
  kernel<<<n_tiles < sms ? n_tiles : sms, PIPE_THREADS, Layout<PIECES>::kSmem, st>>>(maps, qsq, dbsq, bmax, B, T, Dp,
                                                                                     start, n_valid);
  return static_cast<int>(cudaGetLastError());
}

template <int PIECES>
int launch_out(const SplitMaps& maps, const float* qsq, const float* dbsq, float* bmax, int B, int T, int Dp,
               long long start, long long n_valid, int l2, int out, cudaStream_t st) {
  if (l2) return launch<PIECES, true, Out::kScoresRowMax>(maps, qsq, dbsq, bmax, B, T, Dp, start, n_valid, st);
  if (out == 1) return launch<PIECES, false, Out::kMaxOnly>(maps, qsq, dbsq, bmax, B, T, Dp, start, n_valid, st);
  if (out == 2) return launch<PIECES, false, Out::kTransposed>(maps, qsq, dbsq, bmax, B, T, Dp, start, n_valid, st);
  return launch<PIECES, false, Out::kScoresRowMax>(maps, qsq, dbsq, bmax, B, T, Dp, start, n_valid, st);
}

}  // namespace

// K1 from the split operands: `pieces` = 2 is 'high' (q0, q1 and db0, db1
// are lemon_split_bf16's hi, lo; q2 and db2 are not read), 3 is 'highest'
// (lemon_split_bf16x3's hi, mid, lo). T a multiple of 128, Dp a multiple of
// 64, (B / 128 rounded up) * (T / 128) < 2^31 tiles. qsq (B,) and dbsq (T,)
// are read only when l2 != 0. out: 0 K1 (s, bmax (B, T/128)), 1 P3 (bmax
// only; s is not touched), 2 P2 (s, bmax (T/128, B)); 1 and 2 take 'ip'
// only. Returns the first error of the tensor maps' encoding or of the
// launch.
extern "C" int lemon_scores_blockmax(const void* q0, const void* q1, const void* q2, const void* db0,
                                     const void* db1, const void* db2, const float* qsq, const float* dbsq, float* s,
                                     float* bmax, int B, int T, int Dp, long long start, long long n_valid,
                                     int pieces, int l2, int out, void* stream) {
  if ((l2 && out != 0) || (pieces != 2 && pieces != 3)) return static_cast<int>(cudaErrorInvalidValue);
  SplitMaps maps;
  const void* q[3] = {q0, q1, q2};
  const void* db[3] = {db0, db1, db2};
  const cuuint64_t dims_q[2] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(B)};
  const cuuint64_t dims_db[2] = {static_cast<cuuint64_t>(Dp), static_cast<cuuint64_t>(T)};
  const cuuint64_t row[1] = {static_cast<cuuint64_t>(Dp) * 2};
  const cuuint32_t box[2] = {TK, 128};  // 64 B x 128 rows: TM == TN
  const auto sw64 = CU_TENSOR_MAP_SWIZZLE_64B;
  int e = 0;
  for (int p = 0; p < pieces && e == 0; ++p) {
    e = encode_tensor_map(&maps.q[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q[p], dims_q, row, box, sw64);
    if (e == 0) e = encode_tensor_map(&maps.db[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, db[p], dims_db, row, box, sw64);
  }
  if (e == 0 && out != 1) {
    const cuuint64_t dims_s[2] = {static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
    const cuuint64_t row_s[1] = {static_cast<cuuint64_t>(T) * 4};
    const cuuint32_t box_s[2] = {32, 64};  // 128 B x 64 rows: a consumer's chunk
    e = encode_tensor_map(&maps.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, s, dims_s, row_s, box_s);
  }
  if (e != 0) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pieces == 2 ? launch_out<2>(maps, qsq, dbsq, bmax, B, T, Dp, start, n_valid, l2, out, st)
                     : launch_out<3>(maps, qsq, dbsq, bmax, B, T, Dp, start, n_valid, l2, out, st);
}
