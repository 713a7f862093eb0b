// Fused candidate gather + exact top-k over global column ids.
//
// Replaces the Pallas kernel lemon_tpu/ops/select.py `_select_kernel`
// (launched by `_fused_padded`, :138). For block-major scores sb (B, nb, 128)
// fp32 and block_ids (B, k) int64, sorted ascending and distinct per row,
// k <= 128, it writes vals (B, k) in descending order and idx (B, k) int64
// global column ids block_id*128 + lane. Ties go to the lower global column
// and -inf entries are taken in ascending column order.
//
// Port of the contract, not of the TPU workaround. The TPU kernel gathered
// with a 0/1 one-hot matmul on the MXU, which turns a -inf score into NaN
// (0 * -inf), so its callers carried a finite MASKED sentinel. A CUDA gather
// is a plain load: masked columns arrive as -inf (the port's K1 writes -inf)
// and come out as -inf. Because the block ids are sorted, global ids rise
// with the staged position, so the lower-position tie rule of the shared
// selection (select_rows.cuh, also K2's) is the lower-global-id rule and the
// ids are rebuilt only for the k winners.
//
// What bounds it on an H100: bytes (the k*128 gathered scores of a row).
// For k <= 8 one warp per row gathers its candidates straight into
// registers and runs K2's warp select (select_rows.cuh, warp_select); for
// larger k persistent CTAs gather each row with k bulk copies into shared
// memory (at most 64 KB a row), the next row's copies in flight while the
// current one's winners are ordered, and run K2's block select there (two
// passes over the row, a sort of the threshold bin's short list, a one-warp
// sort of up to 64 winners). Either way the candidate
// matrix never makes the round trip through device memory that the port's
// unfused tail (torch.gather + K2) pays. A block id outside [0, nb) reads
// as a block of -inf (memory safety only: the contract excludes it).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "select_rows.cuh"

namespace {

constexpr int LANES = 128;
constexpr int MAX_K = 128;

// k > 8: the block select of select_rows.cuh (K2's radix variant) on the
// gathered row, in persistent CTAs, a few an SM, each walking rows in turn.
// kBulk: warp 0 reads the next row's k block ids and issues k bulk copies
// of 512 bytes, one a block, into the staged row as soon as the select has
// filtered the current one (a block id outside [0, nb) is filled with -inf
// by plain stores). kStaged, for sb not 16-byte aligned: plain loads. The
// gathered row never touches global memory; the winners' values come from
// their keys (a zero's sign from sb; a -inf fill never has the zero key).
enum class Load { kBulk, kStaged };

template <int THREADS, Load LOAD>
__global__ void __launch_bounds__(THREADS, lemon_select::MIN_THREADS_PER_SM / THREADS)
gather_topk_kernel(const float* __restrict__ sb, const long long* __restrict__ block_ids,
                   float* __restrict__ vals, long long* __restrict__ idx, int B, int nb, int k) {
  using namespace lemon_hopper;
  extern __shared__ __align__(16) float row[];  // k * 128
  __shared__ lemon_select::SelectSmem sm;
  __shared__ unsigned long long cand[MAX_K];
  __shared__ long long ids[2][MAX_K];  // this row's block ids and the next one's
  __shared__ __align__(8) unsigned long long full;
  const int lane = threadIdx.x & 31;
  const int w = k * LANES;
  // warp 0: row r's block ids into ids[b] and its blocks into the staged row
  auto issue = [&](long long r, int b) {
    const uint32_t bar = smem_u32(&full);
    int valid = 0;
    for (int s = lane; s < k; s += 32) {
      const long long blk = block_ids[r * k + s];
      ids[b][s] = blk;
      valid += blk >= 0 && blk < nb;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) valid += __shfl_xor_sync(lemon_select::FULL, valid, off);
    if (lane == 0) mbar_arrive_expect_tx(bar, static_cast<uint32_t>(valid) * LANES * sizeof(float));
    __syncwarp();
    for (int s = lane; s < k; s += 32) {
      const long long blk = ids[b][s];
      if (blk >= 0 && blk < nb) {
        bulk_load(smem_u32(row + s * LANES), sb + (r * nb + blk) * LANES, LANES * sizeof(float), bar);
      } else {
        for (int e = 0; e < LANES; ++e) row[s * LANES + e] = -CUDART_INF_F;
      }
    }
  };
  if (LOAD == Load::kBulk && threadIdx.x == 0) {
    mbar_init(smem_u32(&full), 1);
    fence_mbar_init();
  }
  lemon_select::clear_hist<THREADS>(sm);
  __syncthreads();
  if (LOAD == Load::kBulk && threadIdx.x < 32 && blockIdx.x < B) issue(blockIdx.x, 0);
  __syncthreads();  // the first row's ids and -inf fills
  int it = 0;
  for (long long r = blockIdx.x; r < B; r += gridDim.x, ++it) {
    const int b = it & 1;
    if (LOAD == Load::kBulk) {
      mbar_wait(smem_u32(&full), it & 1);
    } else {
      for (int s = threadIdx.x; s < k; s += THREADS) ids[b][s] = block_ids[r * k + s];
      __syncthreads();
      const float* src = sb + r * nb * LANES;
      for (int e = threadIdx.x; e < w; e += THREADS) {
        const long long blk = ids[b][e / LANES];
        row[e] = (blk >= 0 && blk < nb) ? src[blk * LANES + e % LANES] : -CUDART_INF_F;
      }
      __syncthreads();
    }
    // every thread, once the row is read no more (all threads are past a
    // barrier after their last read): warp 0 stages the next row; its ids
    // and fills are read after the barrier that ends this row
    auto release = [&]() {
      if (LOAD == Load::kBulk && threadIdx.x < 32 && r + gridDim.x < B) {
        fence_proxy_async();
        issue(r + gridDim.x, b ^ 1);
      }
    };
    if (lemon_select::STOP == 1) {  // select_limits.py: the staging alone
      if (threadIdx.x == 0) vals[r * k] = row[w - 1];
      __syncthreads();
      release();
      __syncthreads();
      continue;
    }
    lemon_select::block_select<THREADS, MAX_K, true>(row, static_cast<unsigned>(w), true, k, cand, sm, release,
                                               [&](int j, int c, unsigned key) {
                                                 const long long blk = ids[b][c / LANES];
                                                 vals[r * k + j] = key == lemon_select::ZERO_KEY
                                                                       ? sb[(r * nb + blk) * LANES + c % LANES]
                                                                       : lemon_select::key_value(key);
                                                 idx[r * k + j] = blk * LANES + c % LANES;
                                               });
    if (lemon_select::STOP >= 2) __syncthreads();
  }
}

// k <= 8 (W = k*128 <= 1024): one warp per row, 8 rows per block, NB
// block slots (k <= NB) of 4 registers a lane. Lane s < k loads block id s
// of its row once; each lane takes every slot's id by a shuffle, and the
// winners' ids come from the same registers, so the emit reads device
// memory only for the sign of a zero. VEC (sb 16-byte aligned, so every
// 512-byte block is): lane l loads float4 l of each block, columns
// s*128 + 4l + q; else lane l loads columns s*128 + l + 32q, 128 contiguous
// bytes a warp and load. Both are select_rows.cuh's layouts, so the tie
// rule sees the gathered position, and through the sorted ids the global
// column. A block id outside [0, nb) reads as a block of -inf.
constexpr int WARP_ROWS = 8;
constexpr int WARP_MAX_K = 8;

template <int NB, bool VEC>
__global__ void __launch_bounds__(WARP_ROWS * 32, NB >= 8 ? 3 : 4)
gather_topk_warp_kernel(const float* __restrict__ sb, const long long* __restrict__ block_ids,
                        float* __restrict__ vals, long long* __restrict__ idx, int B, int nb, int k) {
  constexpr int CAP = 4 * NB;
  __shared__ unsigned long long lists[WARP_ROWS][lemon_select::WARP_LIST];  // k <= 8: warp_list_cap(k) = WARP_LIST
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * WARP_ROWS + w;
  if (r >= B) return;  // the whole warp
  const float* row = sb + r * nb * LANES;
  const long long my_id = lane < k ? block_ids[r * k + lane] : 0;
  unsigned key[CAP];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const long long blk = __shfl_sync(lemon_select::FULL, my_id, s);
    const bool in = s < k, valid = blk >= 0 && blk < nb;
    const float* b = row + blk * LANES;
    if (VEC) {
      const float4 v = in && valid ? reinterpret_cast<const float4*>(b)[lane]
                                   : make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
      key[4 * s] = in ? lemon_select::order_key(v.x) : 0u;
      key[4 * s + 1] = in ? lemon_select::order_key(v.y) : 0u;
      key[4 * s + 2] = in ? lemon_select::order_key(v.z) : 0u;
      key[4 * s + 3] = in ? lemon_select::order_key(v.w) : 0u;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        key[4 * s + q] = in ? lemon_select::order_key(valid ? b[lane + 32 * q] : -CUDART_INF_F) : 0u;
    }
  }
  lemon_select::warp_select<CAP, VEC>(key, static_cast<unsigned>(k), lists[w],
                                      [&](bool ok, unsigned pos, unsigned c, unsigned kv) {
                                        const long long blk = __shfl_sync(lemon_select::FULL, my_id, c / LANES);
                                        if (!ok) return;
                                        vals[r * k + pos] = kv == lemon_select::ZERO_KEY
                                                                ? row[blk * LANES + c % LANES]  // the sign of a zero
                                                                : lemon_select::key_value(kv);
                                        idx[r * k + pos] = blk * LANES + c % LANES;
                                      });
}

template <int NB>
int launch_warp(const float* sb, const long long* block_ids, float* vals, long long* idx, int B, int nb, int k,
                cudaStream_t stream) {
  const int blocks = (B + WARP_ROWS - 1) / WARP_ROWS;
  if (reinterpret_cast<uintptr_t>(sb) % 16 == 0)
    gather_topk_warp_kernel<NB, true><<<blocks, WARP_ROWS * 32, 0, stream>>>(sb, block_ids, vals, idx, B, nb, k);
  else
    gather_topk_warp_kernel<NB, false><<<blocks, WARP_ROWS * 32, 0, stream>>>(sb, block_ids, vals, idx, B, nb, k);
  return static_cast<int>(cudaGetLastError());
}

template <int THREADS, Load LOAD>
int launch_as(const float* sb, const long long* block_ids, float* vals, long long* idx, int B, int nb, int k,
              cudaStream_t stream) {
  static lemon_select::GridCache cache;
  const size_t smem = static_cast<size_t>(k) * LANES * sizeof(float);
  constexpr size_t SMEM_MAX = MAX_K * LANES * sizeof(float);
  int grid = 0;
  const int e = lemon_select::persistent_grid(reinterpret_cast<const void*>(gather_topk_kernel<THREADS, LOAD>),
                                              THREADS, smem, SMEM_MAX, B, cache, &grid);
  if (e) return e;
  gather_topk_kernel<THREADS, LOAD><<<grid, THREADS, smem, stream>>>(sb, block_ids, vals, idx, B, nb, k);
  return static_cast<int>(cudaGetLastError());
}

// The load path by alignment: a bulk copy needs sb 16-byte aligned (each
// block is 512 bytes at a multiple of 512 from it).
template <int THREADS>
int launch(const float* sb, const long long* block_ids, float* vals, long long* idx, int B, int nb, int k,
           cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(sb) % 16 == 0)
    return launch_as<THREADS, Load::kBulk>(sb, block_ids, vals, idx, B, nb, k, stream);
  return launch_as<THREADS, Load::kStaged>(sb, block_ids, vals, idx, B, nb, k, stream);
}

}  // namespace

// How the kernel loads the rows of sb at this k: the warp path (k <= 8)
// into registers, -2 by 16-byte loads, -1 by scalar ones; else staged, 0 by
// bulk copies, 1 by plain loads. chip_smoke.py prints it.
extern "C" int lemon_gather_topk_load(const float* sb, int k) {
  const bool aligned = reinterpret_cast<uintptr_t>(sb) % 16 == 0;
  if (k <= WARP_MAX_K) return aligned ? -2 : -1;
  return aligned ? 0 : 1;
}

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/select.py):
// 0 < k <= min(nb, 128) and 0 < B < 2^31. Returns the launch's error code.
extern "C" int lemon_gather_topk(const float* sb, const long long* block_ids, float* vals,
                                 long long* idx, int B, int nb, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 2) return launch_warp<2>(sb, block_ids, vals, idx, B, nb, k, st);
  if (k <= 4) return launch_warp<4>(sb, block_ids, vals, idx, B, nb, k, st);
  if (k <= 6) return launch_warp<6>(sb, block_ids, vals, idx, B, nb, k, st);
  if (k <= WARP_MAX_K) return launch_warp<8>(sb, block_ids, vals, idx, B, nb, k, st);
  if (k * LANES <= 2048) return launch<128>(sb, block_ids, vals, idx, B, nb, k, st);
  return launch<256>(sb, block_ids, vals, idx, B, nb, k, st);
}

#ifdef LEMON_SELECT_COUNT
// benchmarks/select_limits.py: the block select's passes over whole rows
// since the last call, then 0.
extern "C" unsigned long long lemon_gather_topk_row_passes() {
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  cudaMemcpyFromSymbol(&n, lemon_select::row_passes, sizeof n);
  cudaMemcpyToSymbol(lemon_select::row_passes, &zero, sizeof zero);
  return n;
}
#endif
