// Flash attention, forward only, fp32.
//
// Replaces the Pallas kernel lemon_tpu/ops/attention.py `_attn_kernel`
// (launched by `_flash_attention`, :101). For q, k, v in the CLIP towers'
// (B, L, H, D) layout it writes o (B, L, H, D) contiguous:
//
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
//
// with scale = D^-0.5 applied to q before the product (attention.py:42) and,
// when causal, only keys j <= i. The (L, L) logits never reach device memory:
// one block owns a 64-row query tile of one (batch, head) and walks the keys
// in 64-row tiles staged in shared memory, carrying the online-softmax state
// (running max, normaliser, accumulator) in fp32 registers. Bounds checks
// replace the TPU kernel's padding to 128 and its -1e30 key mask: keys past L
// or after the query (causal) get -inf logits, query rows past L are computed
// on zeros and never stored, and a causal tile stops at its last query row.
//
// What bounds it on an H100. At the towers' shapes (L 50..256, D 64) the work
// is 4*B*H*L^2*D flops against 16*B*L*H*D bytes moved, about L/4 flops per
// byte: compute-bound on the CUDA cores, since this first version stays in
// fp32 FFMA (no tensor cores, no TMA, no wgmma). Each thread owns 8 query
// rows x 4 key columns of the logits tile and 8 rows x D/16 columns of the
// accumulator, so one shared-memory read feeds 2-3 FMAs; rows are padded by
// one float so the strided reads hit 32 distinct banks. The rows of a logits
// tile sit in 16 lanes of one warp, so the row max and row sum are
// half-warp shuffles. Probabilities go through shared memory to the P.V
// product. 128 threads, 64-66 KB of shared memory at D = 64 (opted in above
// 48 KB), three blocks per SM.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per staged tile
constexpr int THREADS = 128; // 8 row groups x 16 column lanes
constexpr int RPT = 8;       // query rows per thread: tr + 8 * i
constexpr int CPT = 4;       // logits columns per thread: tc + 16 * j
constexpr int PP = BKV + 1;  // padded row stride of the probability tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BKV) * (D + 1) +
                          static_cast<size_t>(BKV) * D + static_cast<size_t>(BQ) * PP);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int L, int H,
                       long long stride_b, long long stride_l, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / 16;  // accumulator columns per thread: tc + 16 * jj
  extern __shared__ float smem[];
  float* sq = smem;              // BQ x DP, already scaled
  float* sk = sq + BQ * DP;      // BKV x DP
  float* sv = sk + BKV * DP;     // BKV x D
  float* sp = sv + BKV * D;      // BQ x PP

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e - (e / D) * D;
    const int row = q0 + r;
    sq[r * DP + d] = row < L ? q[head + row * stride_l + d] * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = 0.f;
  }

  const int kv_end = causal ? min(L, q0 + BQ) : L;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and sq is written)
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, d = e - (e / D) * D;
      const int row = k0 + r;
      const bool in = row < L;
      sk[r * DP + d] = in ? k[head + row * stride_l + d] : 0.f;
      sv[r * D + d] = in ? v[head + row * stride_l + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[RPT], kc[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qr[i] = sq[(tr + 8 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kc[j] = sk[(tc + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + tr + 8 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = k0 + tc + 16 * j;
        if (kj >= L || (causal && kj > qi)) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // every row sees key 0 in the first tile, so m_new is finite; the
      // guard keeps a fully masked row at zero weight instead of NaN
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - base);
        rs += p;
        sp[(tr + 8 * i) * PP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int n_keys = min(BKV, kv_end - k0);
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      float vv[DPT];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) vv[jj] = sv[j * D + tc + 16 * jj];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = sp[(tr + 8 * i) * PP + j];
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

  const long long out_head = (static_cast<long long>(b) * L * H + h) * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + tr + 8 * i;
    if (row >= L) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      o[out_head + static_cast<long long>(row) * H * D + tc + 16 * jj] = acc[i][jj] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int L, int H,
           long long stride_b, long long stride_l, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (L + BQ - 1) / BQ);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, o, L, H, stride_b, stride_l,
                                                             scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/attention.py):
// q, k and v share their strides, with (H, D) contiguous inside each token;
// D is 32, 64 or 128; 0 < B*H < 2^31 and 0 < L. o is (B, L, H, D)
// contiguous. Returns the launch's error code (cudaErrorInvalidValue for an
// unsupported D).
extern "C" int lemon_flash_attention(const float* q, const float* k, const float* v, float* o,
                                     int B, int L, int H, int D, long long stride_b,
                                     long long stride_l, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    case 64: return launch<64>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    case 128: return launch<128>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
