// Block-wide exact top-k of one row, shared by K2 (topk.cu) and K4
// (select.cu).
//
// Removal by index, not by value. The TPU kernels consumed a selected entry
// by overwriting it with -inf, which cannot advance past an entry that
// already is -inf; they mapped -inf to the lowest finite float to work around
// that. Here pass j takes the best entry that comes strictly after pass
// j-1's pick (v, i) in the total order "value descending, column ascending":
// entry (v', i') is eligible iff v' < v or (v' == v and i' > i). Nothing is
// written back, ties and -inf entries advance by column, no sentinel value is
// reserved, and k is bounded only by the row width. Each pass is a strided
// scan plus a block-wide (value, column) argmax: warp shuffles, then one warp
// over the warp winners, with two barriers.

#pragma once

#include <climits>
#include <math_constants.h>

namespace lemon_select {

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The k best entries of row[0, W) in selection order; every thread of the
// block calls it, and emit(j, value, column) runs on one thread per pass.
template <int THREADS, typename Emit>
__device__ void select_top_k(const float* row, int W, int k, Emit emit) {
  constexpr int NW = THREADS / 32;
  __shared__ float red_v[NW];
  __shared__ int red_i[NW];
  __shared__ float sel_v;
  __shared__ int sel_i;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Everything comes after (+inf, -1) in the selection order.
  float pv = CUDART_INF_F;
  int pi = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;  // loses to any real column, -inf ones included
    for (int c = tid; c < W; c += THREADS) {
      const float v = row[c];
      const bool eligible = v < pv || (v == pv && c > pi);
      if (eligible && better(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < NW ? red_v[lane] : -CUDART_INF_F;
      bi = lane < NW ? red_i[lane] : INT_MAX;
      warp_argmax(bv, bi);
      if (lane == 0) {
        sel_v = bv;
        sel_i = bi;
        emit(j, bv, bi);
      }
    }
    __syncthreads();
    pv = sel_v;
    pi = sel_i;
  }
}

}  // namespace lemon_select
