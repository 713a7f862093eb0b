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
// a few microseconds at 3.35 TB/s; the work per row is a few passes over
// the row. Two variants, one launch per call, picked by (W, k) in
// lemon_topk below:
//
// - warp: one warp per row, 8 rows per block, the row in registers
//   (W <= 32 * CAP, CAP entries a lane) and select_rows.cuh's warp_top_k:
//   k rounds of 5 shuffles and CAP compares, no __syncthreads. For the
//   narrow, small-k rows of the search (the block maxima, W = T/128, and
//   the (k+1)*128 candidates) this costs less than reading the row.
// - radix: one block per row (128 threads up to W = 2048, else 256), the
//   row staged in shared memory (up to 48K floats; wider rows are read from
//   global memory each pass), and the threshold select of select_rows.cuh:
//   a few histogram passes and a bitonic sort of the k winners, with a
//   barrier count that does not grow with W.
//
// P1, the top-k with global column ids (lemon_topk_colids), replaces
// benchmarks/probe_knn_select3.py `_topk_colids_kernel` and
// `_topk_pair_kernel` (launched by `topk_colids`, :89, and `topk_pair`,
// :163), which compute one function: the row top-k of x (B, W) given an
// int32 id cid (B, W) per entry, ascending along each row (the candidate
// blocks' sorted global ids x 128 + lane), returning the values and the
// chosen entries' ids. Ascending ids make position order id order, so the
// same selections run unchanged and the emit step reads cid at the chosen
// positions: ties go to the lowest id and -inf entries come out by
// ascending id. What bounds it: bytes, x and cid read once (214 MB each at
// the probe's (8192, 6528)), 0.13 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include "select_rows.cuh"

namespace {

using lemon_select::order_key;

constexpr int WARP_ROWS = 8;             // rows per block in the warp variant
constexpr int WARP_MAX_W = 32 * 32;      // widest row of the warp variant
constexpr int WARP_MAX_K = 24;           // auto: larger k goes to the radix variant
constexpr int SORT_CAP = 2048;           // winners sorted at once (16 KB)
constexpr int STAGE_MAX_FLOATS = 48 * 1024;

// Each emitted entry writes its column to idx, or, when cid is given (P1),
// its id cid[r, column] to ids.
template <int CAP>
__global__ void __launch_bounds__(WARP_ROWS * 32)
topk_warp_kernel(const float* __restrict__ x, const int* __restrict__ cid, float* __restrict__ vals,
                 long long* __restrict__ idx, int* __restrict__ ids, int B, int W, int k) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * WARP_ROWS + (threadIdx.x >> 5);
  if (r >= B) return;  // the whole warp
  const float* xr = x + r * W;
  unsigned key[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const int c = lane + 32 * j;
    key[j] = c < W ? order_key(xr[c]) : 0u;
  }
  lemon_select::warp_top_k<CAP>(key, k, [&](int j, int c) {
    vals[r * k + j] = xr[c];
    if (cid) ids[r * k + j] = cid[r * W + c];
    else idx[r * k + j] = c;
  });
}

template <int THREADS, bool STAGED>
__global__ void __launch_bounds__(THREADS)
topk_radix_kernel(const float* __restrict__ x, const int* __restrict__ cid, float* __restrict__ vals,
                  long long* __restrict__ idx, int* __restrict__ ids, int W, int k) {
  extern __shared__ unsigned long long smem[];  // cand[next_pow2(min(k, SORT_CAP))], then the row
  __shared__ lemon_select::Scratch sm;
  const long long r = blockIdx.x;
  const float* xr = x + r * W;
  unsigned long long* cand = smem;
  float* staged = reinterpret_cast<float*>(smem + lemon_select::next_pow2(min(k, SORT_CAP)));
  if (STAGED) {
    for (int c = threadIdx.x; c < W; c += THREADS) staged[c] = xr[c];
    __syncthreads();
  }
  const float* row = STAGED ? staged : xr;
  lemon_select::select_top_k<THREADS, SORT_CAP>(
      [&](unsigned c) { return order_key(row[c]); }, static_cast<unsigned>(W), k, cand, sm, [&](int j, int c) {
        vals[r * k + j] = row[c];
        if (cid) ids[r * k + j] = cid[r * W + c];
        else idx[r * k + j] = c;
      });
}

template <int CAP>
void launch_warp(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                 cudaStream_t stream) {
  const int blocks = (B + WARP_ROWS - 1) / WARP_ROWS;
  topk_warp_kernel<CAP><<<blocks, WARP_ROWS * 32, 0, stream>>>(x, cid, vals, idx, ids, B, W, k);
}

template <int THREADS>
int launch_radix(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                 cudaStream_t stream) {
  const bool staged = W <= STAGE_MAX_FLOATS;
  const size_t smem = lemon_select::next_pow2(k < SORT_CAP ? k : SORT_CAP) * sizeof(unsigned long long) +
                      (staged ? static_cast<size_t>(W) * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        staged ? reinterpret_cast<const void*>(topk_radix_kernel<THREADS, true>)
               : reinterpret_cast<const void*>(topk_radix_kernel<THREADS, false>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (staged) topk_radix_kernel<THREADS, true><<<B, THREADS, smem, stream>>>(x, cid, vals, idx, ids, W, k);
  else topk_radix_kernel<THREADS, false><<<B, THREADS, smem, stream>>>(x, cid, vals, idx, ids, W, k);
  return 0;
}

// One launch of the variant (W, k) picks (variant 0) or the one asked for.
int launch_topk(const float* x, const int* cid, float* vals, long long* idx, int* ids, int B, int W, int k,
                int variant, cudaStream_t st) {
  if (variant == 0) variant = (W <= WARP_MAX_W && k <= WARP_MAX_K) ? 1 : 2;
  if (variant == 1) {
    if (W > WARP_MAX_W) return static_cast<int>(cudaErrorInvalidValue);
    if (W <= 128) launch_warp<4>(x, cid, vals, idx, ids, B, W, k, st);
    else if (W <= 256) launch_warp<8>(x, cid, vals, idx, ids, B, W, k, st);
    else if (W <= 512) launch_warp<16>(x, cid, vals, idx, ids, B, W, k, st);
    else if (W <= 768) launch_warp<24>(x, cid, vals, idx, ids, B, W, k, st);
    else launch_warp<32>(x, cid, vals, idx, ids, B, W, k, st);
  } else {
    const int e = W <= 2048 ? launch_radix<128>(x, cid, vals, idx, ids, B, W, k, st)
                            : launch_radix<256>(x, cid, vals, idx, ids, B, W, k, st);
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

// P1: vals (B, k) and ids (B, k) int32 = cid at the top k of x (B, W); cid
// (B, W) int32 ascending along each row.
extern "C" int lemon_topk_colids(const float* x, const int* cid, float* vals, int* ids, int B, int W, int k,
                                 void* stream) {
  return launch_topk(x, cid, vals, nullptr, ids, B, W, k, 0, static_cast<cudaStream_t>(stream));
}
