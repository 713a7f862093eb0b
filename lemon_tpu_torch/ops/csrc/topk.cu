// Exact row-wise top-k with the FAISS tie rule.
//
// Replaces the Pallas kernel lemon_tpu/ops/topk.py `_topk_kernel` (launched
// by `_pallas_topk_padded`, :80). For x (B, W) fp32 row-major and 0 < k <= W
// it writes vals (B, k) in descending order and idx (B, k) int64, ties going
// to the lower column and -inf entries taken in ascending column order,
// exactly like jax.lax.top_k (-0.0 and +0.0 tie). The TPU kernel stops at
// k = 128; neither variant here has a bound on k below the row width.
//
// What bounds it on an H100: bytes. The function reads B*W floats and
// writes B*k (value, index) pairs, so at the main path's shapes its bound is
// a few microseconds at 3.35 TB/s. Two variants, one launch per call, picked
// by (W, k) in lemon_topk below:
//
// - warp: one warp per row, 8 rows per block, the row in registers
//   (W <= 32 * CAP, CAP entries a lane) and select_rows.cuh's warp_select:
//   the k-th largest lane maximum bounds the winners from below, the few
//   entries at or above it are listed in shared memory and ranked by
//   counting; no round orders the row. Loads are 16 bytes wide where the
//   row start and W allow, else scalar (W = 125: rows 500 bytes apart). For
//   the narrow, small-k rows of the search (the block maxima, W = T/128,
//   and the (k+1)*128 candidates) it takes about twice the row's load.
// - radix: select_rows.cuh's block select in persistent CTAs, each walking
//   rows in turn: 128 threads up to W = 2048, 256 up to 8192 (four CTAs an
//   SM at W = 6528), else 512 (measured the faster at W = 16000, the slower
//   at 6528). A row is staged by one bulk copy, issued as soon as the row
//   before it has been filtered, so the load overlaps the ordering of the
//   winners and the other CTAs' work; then two passes over the staged row
//   (an 11-bit histogram, a filter), rounds over the threshold bin's list
//   until at most 64 entries are left, and one-warp sorts of those and of
//   up to 64 winners. Rows that a bulk copy cannot take (start or length
//   not 16-byte aligned) are staged by plain loads, rows wider than shared
//   memory read from global memory (plan_rows).
//
// P1, the top-k with global column ids (lemon_topk_colids), replaces
// benchmarks/probe_knn_select3.py `_topk_colids_kernel` and
// `_topk_pair_kernel` (launched by `topk_colids`, :89, and `topk_pair`,
// :163), which compute one function: the row top-k of x (B, W) given an
// int32 id cid (B, W) per entry, ascending along each row (the candidate
// blocks' sorted global ids x 128 + lane), returning the values and the
// chosen entries' ids. Ascending ids make position order id order, so the
// same selections run unchanged and the emit step reads cid at the chosen
// positions only: ties go to the lowest id and -inf entries come out by
// ascending id. What bounds it: bytes, x read once, one 32-byte sector of
// cid a chosen entry and the outputs (231 MB at the probe's (8192, 6528)
// k=51), 0.069 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "select_rows.cuh"

namespace {

using lemon_select::order_key;

constexpr int WARP_ROWS = 8;             // rows per block in the warp variant
constexpr int WARP_MAX_W = 32 * 32;      // widest row of the warp variant
constexpr int WARP_MAX_K = 96;           // auto: larger k goes to the radix variant (chip_smoke's K2_CROSSOVER)
constexpr int SORT_CAP = 2048;           // winners sorted at once (16 KB)
// dynamic shared memory of the block select: the SM's 227 KB less the static
// SelectSmem and the barriers
constexpr size_t DYNAMIC_SMEM_MAX = 232448 - sizeof(lemon_select::SelectSmem) - 1024;

// The warp variant: one warp a row, CAP by W in launch_topk; VEC, 16-byte
// loads (x 16-byte aligned, W % 4 == 0). Each warp lists into its own
// warp_list_cap(k) entries of dynamic shared memory. Each emitted entry
// writes its value (from its key; a zero's sign from x) and its column to
// idx, or, when cid is given (P1), its id cid[r, column] to ids. The
// minimum of blocks an SM is what CAP's registers allow without a spill
// (nvcc -Xptxas -v).
__host__ __device__ constexpr int warp_min_blocks(int cap) { return cap >= 32 ? 3 : cap >= 16 ? 4 : cap >= 8 ? 5 : 8; }

template <int CAP, bool VEC>
__global__ void __launch_bounds__(WARP_ROWS * 32, warp_min_blocks(CAP))
topk_warp_kernel(const float* __restrict__ x, const int* __restrict__ cid, float* __restrict__ vals,
                 long long* __restrict__ idx, int* __restrict__ ids, int B, int W, int k) {
  extern __shared__ unsigned long long lists[];
  const unsigned lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * WARP_ROWS + w;
  if (r >= B) return;  // the whole warp
  const float* xr = x + r * W;
  unsigned key[CAP];
  if (VEC) {
#pragma unroll
    for (int u = 0; u < CAP / 4; ++u) {
      const unsigned f = lane + 32 * u;
      const bool in = 4 * f < static_cast<unsigned>(W);
      const float4 v = in ? reinterpret_cast<const float4*>(xr)[f] : make_float4(0.f, 0.f, 0.f, 0.f);
      key[4 * u] = in ? order_key(v.x) : 0u;
      key[4 * u + 1] = in ? order_key(v.y) : 0u;
      key[4 * u + 2] = in ? order_key(v.z) : 0u;
      key[4 * u + 3] = in ? order_key(v.w) : 0u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      const unsigned c = lane + 32 * j;
      key[j] = c < static_cast<unsigned>(W) ? order_key(xr[c]) : 0u;
    }
  }
  lemon_select::warp_select<CAP, VEC>(key, static_cast<unsigned>(k), lists + w * lemon_select::warp_list_cap(k),
                                      [&](bool ok, unsigned pos, unsigned c, unsigned kv) {
                                        if (!ok) return;
                                        vals[r * k + pos] =
                                            kv == lemon_select::ZERO_KEY ? xr[c] : lemon_select::key_value(kv);
                                        if (cid) ids[r * k + pos] = cid[r * W + c];
                                        else idx[r * k + pos] = c;
                                      });
}

// The persistent block select: a few CTAs an SM, each taking rows
// blockIdx.x + i * gridDim.x in turn. How a row reaches shared memory is
// chosen by shape (plan_rows), and each path is a template instance:
// kBulk, one bulk copy a row (W % 4 == 0, x 16-byte aligned, the row fits),
// thread 0 issuing the next row's copy as soon as the select has read the
// current row for the last time (after its filter), so the load overlaps
// the ordering of the winners and the other CTAs' work; kStaged, plain
// loads into the staged row (a start or length not 16-byte aligned, such
// as the block maxima at W = 125); kGlobal, the row read from global memory
// in each pass (wider than shared memory). The winners' values come from
// their keys (a zero's sign from x), so the staged row is free once
// filtered.
enum class Load { kBulk, kStaged, kGlobal };

template <int THREADS, Load LOAD>
__global__ void __launch_bounds__(THREADS, lemon_select::MIN_THREADS_PER_SM / THREADS)
topk_rows_kernel(const float* __restrict__ x, const int* __restrict__ cid, float* __restrict__ vals,
                 long long* __restrict__ idx, int* __restrict__ ids, int B, int W, int k, int cand_slots) {
  using namespace lemon_hopper;
  extern __shared__ __align__(16) unsigned long long smem[];  // cand[cand_slots], then the row
  __shared__ lemon_select::SelectSmem sm;
  __shared__ __align__(8) unsigned long long full;
  unsigned long long* cand = smem;
  float* staged = reinterpret_cast<float*>(smem + cand_slots);
  const uint32_t bytes = static_cast<uint32_t>(W) * sizeof(float);
  auto issue = [&](long long r) {  // thread 0: row r into the staged row
    mbar_arrive_expect_tx(smem_u32(&full), bytes);
    bulk_load(smem_u32(staged), x + r * W, bytes, smem_u32(&full));
  };
  if (LOAD == Load::kBulk && threadIdx.x == 0) {
    mbar_init(smem_u32(&full), 1);
    fence_mbar_init();
  }
  lemon_select::clear_hist<THREADS>(sm);
  __syncthreads();
  if (LOAD == Load::kBulk && threadIdx.x == 0 && blockIdx.x < B) issue(blockIdx.x);
  int it = 0;
  for (long long r = blockIdx.x; r < B; r += gridDim.x, ++it) {
    float* row = LOAD == Load::kGlobal ? const_cast<float*>(x + r * W) : staged;  // never written when global
    if (LOAD == Load::kBulk) {
      mbar_wait(smem_u32(&full), it & 1);
    } else if (LOAD == Load::kStaged) {
      for (int c = threadIdx.x; c < W; c += THREADS) staged[c] = x[r * W + c];
      __syncthreads();
    }
    // every thread, once the row is read no more (all threads are past a
    // barrier after their last read): the next row's copy
    auto release = [&]() {
      if (LOAD == Load::kBulk && threadIdx.x == 0 && r + gridDim.x < B) {
        fence_proxy_async();
        issue(r + gridDim.x);
      }
    };
    if (lemon_select::STOP == 1) {  // select_limits.py: the staging alone
      if (threadIdx.x == 0) vals[r * k] = row[W - 1];
      __syncthreads();
      release();
      continue;
    }
    const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0;
    lemon_select::block_select<THREADS, SORT_CAP, LOAD != Load::kGlobal>(row, static_cast<unsigned>(W), vec4, k, cand,
                                                                          sm, release,
                                                  [&](int j, int c, unsigned key) {
                                                    vals[r * k + j] = key == lemon_select::ZERO_KEY
                                                                          ? x[r * W + c]  // the sign of a zero
                                                                          : lemon_select::key_value(key);
                                                    if (cid) ids[r * k + j] = cid[r * W + c];
                                                    else idx[r * k + j] = c;
                                                  });
    if (lemon_select::STOP >= 2) __syncthreads();
  }
}

template <int CAP, bool VEC>
int launch_warp_as(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                   cudaStream_t stream) {
  static int sms[64];  // the limit of dynamic shared memory, set once a device for the widest list
  int n_sms = 0;
  const int e = lemon_hopper::prepare_launch(
      reinterpret_cast<const void*>(topk_warp_kernel<CAP, VEC>),
      static_cast<int>(WARP_ROWS * lemon_select::warp_list_cap(32 * CAP) * sizeof(unsigned long long)), sms, &n_sms);
  if (e) return e;
  const size_t smem = WARP_ROWS * lemon_select::warp_list_cap(k) * sizeof(unsigned long long);
  topk_warp_kernel<CAP, VEC><<<(B + WARP_ROWS - 1) / WARP_ROWS, WARP_ROWS * 32, smem, stream>>>(x, cid, vals, idx, ids,
                                                                                               B, W, k);
  return 0;
}

template <int CAP>
int launch_warp(bool vec, const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                cudaStream_t stream) {
  return vec ? launch_warp_as<CAP, true>(x, cid, vals, idx, ids, B, W, k, stream)
             : launch_warp_as<CAP, false>(x, cid, vals, idx, ids, B, W, k, stream);
}

// The warp variant's registers a lane for rows of W.
int warp_cap(int W) { return W <= 128 ? 4 : W <= 256 ? 8 : W <= 512 ? 16 : W <= 768 ? 24 : 32; }

bool warp_vec(const float* x, int W) { return W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0; }

template <int THREADS, Load LOAD>
int launch_rows_as(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                   int cand_slots, size_t smem, cudaStream_t stream) {
  static lemon_select::GridCache cache;
  int grid = 0;
  const int e = lemon_select::persistent_grid(reinterpret_cast<const void*>(topk_rows_kernel<THREADS, LOAD>), THREADS,
                                              smem, DYNAMIC_SMEM_MAX, B, cache, &grid);
  if (e) return e;
  topk_rows_kernel<THREADS, LOAD><<<grid, THREADS, smem, stream>>>(x, cid, vals, idx, ids, B, W, k, cand_slots);
  return 0;
}

// The load path by shape (see topk_rows_kernel) and the shared memory it takes.
struct RowPlan {
  Load load;
  int cand_slots;
  size_t smem;
};

RowPlan plan_rows(const float* x, int W, int k) {
  const int cand_slots = std::max(lemon_select::next_pow2(std::min(k, SORT_CAP)), 2);  // 16-byte multiple
  const size_t cand_bytes = static_cast<size_t>(cand_slots) * sizeof(unsigned long long);
  const size_t row_bytes = static_cast<size_t>(W) * sizeof(float);
  if (cand_bytes + row_bytes > DYNAMIC_SMEM_MAX) return {Load::kGlobal, cand_slots, cand_bytes};
  const bool aligned = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return {aligned ? Load::kBulk : Load::kStaged, cand_slots, cand_bytes + row_bytes};
}

template <int THREADS>
int launch_rows(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                cudaStream_t stream) {
  const RowPlan p = plan_rows(x, W, k);
  if (p.load == Load::kBulk)
    return launch_rows_as<THREADS, Load::kBulk>(x, cid, vals, idx, ids, B, W, k, p.cand_slots, p.smem, stream);
  if (p.load == Load::kStaged)
    return launch_rows_as<THREADS, Load::kStaged>(x, cid, vals, idx, ids, B, W, k, p.cand_slots, p.smem, stream);
  return launch_rows_as<THREADS, Load::kGlobal>(x, cid, vals, idx, ids, B, W, k, p.cand_slots, p.smem, stream);
}

// One launch of the variant (W, k) picks (variant 0) or the one asked for.
int launch_topk(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                int variant, cudaStream_t st) {
  if (variant == 0) variant = (W <= WARP_MAX_W && k <= WARP_MAX_K) ? 1 : 2;
  if (variant == 1) {
    if (W > WARP_MAX_W) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = warp_vec(x, W);
    const int cap = warp_cap(W);
    const int e = cap == 4    ? launch_warp<4>(vec, x, cid, vals, idx, ids, B, W, k, st)
                  : cap == 8  ? launch_warp<8>(vec, x, cid, vals, idx, ids, B, W, k, st)
                  : cap == 16 ? launch_warp<16>(vec, x, cid, vals, idx, ids, B, W, k, st)
                  : cap == 24 ? launch_warp<24>(vec, x, cid, vals, idx, ids, B, W, k, st)
                              : launch_warp<32>(vec, x, cid, vals, idx, ids, B, W, k, st);
    if (e) return e;
  } else {
    const int e = W <= 2048   ? launch_rows<128>(x, cid, vals, idx, ids, B, W, k, st)
                  : W <= 8192 ? launch_rows<256>(x, cid, vals, idx, ids, B, W, k, st)
                              : launch_rows<512>(x, cid, vals, idx, ids, B, W, k, st);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrappers (lemon_tpu_torch/ops/topk.py,
// ops/select.py): 0 < k <= W and 0 < B < 2^31. variant: 0 picks by (W, k),
// 1 the warp variant (W <= 1024), 2 the radix variant. Each returns the
// launch's error code.

// vals (B, k) and idx (B, k) int64 columns of the top k of x (B, W).
extern "C" int lemon_topk(const float* x, float* vals, long long* idx, int B, int W, int k, int variant,
                          void* stream) {
  return launch_topk(x, nullptr, vals, idx, nullptr, B, W, k, variant, static_cast<cudaStream_t>(stream));
}

// How the radix variant stages the rows of x (B, W) at this k: 0 by bulk
// copies, 1 by plain loads, 2 not at all (read from global memory).
// chip_smoke.py prints it.
extern "C" int lemon_topk_radix_load(const float* x, int W, int k) {
  return static_cast<int>(plan_rows(x, W, k).load);
}

// The warp variant's instance for the rows of x (B, W):
// (CAP << 1) | (1 for 16-byte loads, 0 for scalar ones). chip_smoke.py
// prints it.
extern "C" int lemon_topk_warp_instance(const float* x, int W) {
  return (warp_cap(W) << 1) | (warp_vec(x, W) ? 1 : 0);
}

// P1: vals (B, k) and ids (B, k) int32 = cid at the top k of x (B, W); cid
// (B, W) int32 ascending along each row.
extern "C" int lemon_topk_colids(const float* x, const int* cid, float* vals, int* ids, int B, int W, int k,
                                 void* stream) {
  return launch_topk(x, cid, vals, nullptr, ids, B, W, k, 0, static_cast<cudaStream_t>(stream));
}

#ifdef LEMON_SELECT_COUNT
// benchmarks/select_limits.py: the block select's passes over whole rows
// since the last call, then 0.
extern "C" unsigned long long lemon_topk_row_passes() {
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  cudaMemcpyFromSymbol(&n, lemon_select::row_passes, sizeof n);
  cudaMemcpyToSymbol(lemon_select::row_passes, &zero, sizeof zero);
  return n;
}
#endif
