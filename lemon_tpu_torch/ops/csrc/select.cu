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
// What bounds it on an H100. One block per row stages its k*128 candidates
// (at most 64 KB; each gathered block is 512 contiguous bytes) in shared
// memory, once, and runs the k selection passes there, so the candidate
// matrix never makes the round trip through device memory that the port's
// unfused tail (torch.gather + K2) pays. The passes are latency-bound, as in
// K2. A block id outside [0, nb) reads as a block of -inf (memory safety
// only: the contract excludes it).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "select_rows.cuh"

namespace {

constexpr int LANES = 128;
constexpr int MAX_K = 128;

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
gather_topk_kernel(const float* __restrict__ sb, const long long* __restrict__ block_ids,
                   float* __restrict__ vals, long long* __restrict__ idx, int nb, int k) {
  extern __shared__ float cand[];  // k * 128
  __shared__ long long ids[MAX_K];
  const long long r = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += THREADS) ids[s] = block_ids[r * k + s];
  __syncthreads();
  const float* row = sb + r * nb * LANES;
  const int w = k * LANES;
  for (int e = threadIdx.x; e < w; e += THREADS) {
    const long long blk = ids[e / LANES];
    cand[e] = (blk >= 0 && blk < nb) ? row[blk * LANES + e % LANES] : -CUDART_INF_F;
  }
  __syncthreads();
  lemon_select::select_top_k<THREADS>(cand, w, k, [&](int j, float v, int c) {
    vals[r * k + j] = v;
    idx[r * k + j] = ids[c / LANES] * LANES + c % LANES;
  });
}

template <int THREADS>
int launch(const float* sb, const long long* block_ids, float* vals, long long* idx, int B,
           int nb, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * LANES * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_topk_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  gather_topk_kernel<THREADS><<<B, THREADS, smem, stream>>>(sb, block_ids, vals, idx, nb, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/select.py):
// 0 < k <= min(nb, 128) and 0 < B < 2^31. Returns the launch's error code.
extern "C" int lemon_gather_topk(const float* sb, const long long* block_ids, float* vals,
                                 long long* idx, int B, int nb, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k * LANES <= 2048) return launch<128>(sb, block_ids, vals, idx, B, nb, k, st);
  return launch<256>(sb, block_ids, vals, idx, B, nb, k, st);
}
