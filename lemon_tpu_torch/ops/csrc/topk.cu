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

#include <cuda_runtime.h>

#include "select_rows.cuh"

namespace {

using lemon_select::order_key;

constexpr int WARP_ROWS = 8;             // rows per block in the warp variant
constexpr int WARP_MAX_W = 32 * 32;      // widest row of the warp variant
constexpr int WARP_MAX_K = 24;           // auto: larger k goes to the radix variant
constexpr int SORT_CAP = 2048;           // winners sorted at once (16 KB)
constexpr int STAGE_MAX_FLOATS = 48 * 1024;

template <int CAP>
__global__ void __launch_bounds__(WARP_ROWS * 32)
topk_warp_kernel(const float* __restrict__ x, float* __restrict__ vals, long long* __restrict__ idx, int B, int W,
                 int k) {
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
    idx[r * k + j] = c;
  });
}

template <int THREADS, bool STAGED>
__global__ void __launch_bounds__(THREADS)
topk_radix_kernel(const float* __restrict__ x, float* __restrict__ vals, long long* __restrict__ idx, int W, int k) {
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
        idx[r * k + j] = c;
      });
}

template <int CAP>
void launch_warp(const float* x, float* vals, long long* idx, int B, int W, int k, cudaStream_t stream) {
  const int blocks = (B + WARP_ROWS - 1) / WARP_ROWS;
  topk_warp_kernel<CAP><<<blocks, WARP_ROWS * 32, 0, stream>>>(x, vals, idx, B, W, k);
}

template <int THREADS>
int launch_radix(const float* x, float* vals, long long* idx, int B, int W, int k, cudaStream_t stream) {
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
  if (staged) topk_radix_kernel<THREADS, true><<<B, THREADS, smem, stream>>>(x, vals, idx, W, k);
  else topk_radix_kernel<THREADS, false><<<B, THREADS, smem, stream>>>(x, vals, idx, W, k);
  return 0;
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/topk.py):
// 0 < k <= W and 0 < B < 2^31. variant: 0 picks by (W, k), 1 the warp
// variant (W <= 1024), 2 the radix variant. Returns the launch's error code.
extern "C" int lemon_topk(const float* x, float* vals, long long* idx, int B, int W, int k, int variant,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) variant = (W <= WARP_MAX_W && k <= WARP_MAX_K) ? 1 : 2;
  if (variant == 1) {
    if (W > WARP_MAX_W) return static_cast<int>(cudaErrorInvalidValue);
    if (W <= 128) launch_warp<4>(x, vals, idx, B, W, k, st);
    else if (W <= 256) launch_warp<8>(x, vals, idx, B, W, k, st);
    else if (W <= 512) launch_warp<16>(x, vals, idx, B, W, k, st);
    else if (W <= 768) launch_warp<24>(x, vals, idx, B, W, k, st);
    else launch_warp<32>(x, vals, idx, B, W, k, st);
  } else {
    const int e = W <= 2048 ? launch_radix<128>(x, vals, idx, B, W, k, st)
                            : launch_radix<256>(x, vals, idx, B, W, k, st);
    if (e) return e;
  }
  return static_cast<int>(cudaGetLastError());
}
