// Tiled matrix product on the tensor cores: c = a . w^T.
//
// Replaces the Pallas kernel benchmarks/probe_pallas_int8.py `_mm_kernel`
// (launched by `pallas_matmul`, :53), the probe that asks whether a hand
// kernel's int8 product beats the compiler's. For a (M, K) and w (N, K),
// both row-major (K contiguous, the layout of a torch.nn.Linear weight and
// of the port's int8 `weight_q`), it writes c (M, N) row-major in one of two
// type pairs:
//   int8 x int8 -> int32, int32 accumulators (exact while |sums| < 2^31);
//   bf16 x bf16 -> bf16, fp32 accumulators rounded once to nearest even.
// M and N are multiples of 128 and K a multiple of 64.
//
// Why w and not the probe's (K, N) b. Integer wgmma (`.s32.s8.s8`, k32)
// takes both operands K-major only; a (K, N) b would have to be transposed
// byte by byte in shared memory. The port keeps its weights (N, K) already,
// so both type pairs take w = b^T, and the probe transposes its constant
// weights once, outside its timed chains. Both then stage alike: rows of 128
// bytes of K a stage (64 bf16 or 128 int8 values), and a wgmma step reads 32
// bytes of each row (k16 bf16, k32 int8).
//
// What bounds it on an H100 at the probe's 4096^3: operations, 137 G of
// them, 0.069 ms at 1979 TOP/s int8 and 0.139 ms at 989 TFLOP/s bf16, against
// 34 MB of inputs and 67 MB (int32) or 34 MB (bf16) of output, 0.03 ms. So
// the tensor cores must never wait: on loads, on the wait for the previous
// product, or on the epilogue.
//
// Design: the warp-specialised pipeline of hopper.cuh. An output tile is
// 128 x 256; each consumer warpgroup runs wgmma m64n256 on its 64 rows (half
// the shared-memory reads per product of m64n128). The producer's one thread
// loads each 128-byte K slice of a (128 rows, 16 KB) and w (256 rows, 32 KB)
// by TMA into a ring of 4 stages (192 KB). A consumer keeps one wgmma group
// in flight (wait_group 1) and hands the stage before it back to the
// producer. The grid is persistent, one block an SM over the tiles in
// grouped order (8 row tiles share each w column tile while it is in L2).
// The epilogue writes 64 x 128-byte chunks of the accumulators into two
// swizzled buffers a warpgroup and stores them by TMA, while the producer
// already loads the next tile. TMA zero-fills what lies past K (int8 at
// K = 64 mod 128) and past N (w rows of a last column tile when
// N = 128 mod 256), and clips the store there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace lemon_hopper;

constexpr int TM = 128;                      // rows of an output tile: 2 consumer warpgroups x 64
constexpr int TN = 256;                      // columns of an output tile
constexpr int TKB = 128;                     // bytes of K a stage: one 128-byte swizzle atom
constexpr int STAGES = 4;
constexpr int GROUP_M = 8;                   // row tiles a group of the tile order spans
constexpr int A_BYTES = TM * TKB;            // 16 KB
constexpr int W_BYTES = TN * TKB;            // 32 KB
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int CHUNK_BYTES = 64 * 128;        // an epilogue buffer: 64 rows of 128 B
constexpr int EPI_OFF = STAGES * STAGE_BYTES;            // two buffers for each consumer warpgroup
constexpr int BAR_OFF = EPI_OFF + 2 * 2 * CHUNK_BYTES;   // full[STAGES], empty[STAGES]
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;    // + slack to align to 1024 B

#define MM_ACC_LIST                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "    \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "     \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "     \
  "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "     \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "     \
  "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "        \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define MM_OP4(c, i) c(d[i]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3])
#define MM_OP16(c, i) MM_OP4(c, i), MM_OP4(c, (i) + 4), MM_OP4(c, (i) + 8), MM_OP4(c, (i) + 12)
#define MM_OP64(c, i) MM_OP16(c, i), MM_OP16(c, (i) + 16), MM_OP16(c, (i) + 32), MM_OP16(c, (i) + 48)
#define MM_OP128(c) MM_OP64(c, 0), MM_OP64(c, 64)

// d (64 x 256, wgmma accumulator layout) += A (64 x 32 B) . B (256 x 32 B)^T,
// both K-major in shared memory: bf16 k16 into fp32, int8 k32 into s32.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MM_ACC_LIST ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MM_OP128("+f")
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " MM_ACC_LIST ", %128, %129, p;\n}\n"
      : MM_OP128("+r")
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The two type pairs: operand, accumulator and output types with their TMA
// types, one wgmma step (32 bytes of K), and the store of two neighbouring
// outputs to shared memory.
struct Int8Mma {
  using In = int8_t;
  using Acc = int;
  using Out = int;
  static constexpr CUtensorMapDataType IN_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType OUT_TYPE = CU_TENSOR_MAP_DATA_TYPE_INT32;
  __device__ static void mma(Acc (&d)[128], uint64_t a, uint64_t b) { wgmma_m64n256k32_s8(d, a, b); }
  __device__ static void store2(unsigned char* p, Acc v0, Acc v1) { *reinterpret_cast<int2*>(p) = make_int2(v0, v1); }
};

struct Bf16Mma {
  using In = __nv_bfloat16;
  using Acc = float;
  using Out = __nv_bfloat16;
  static constexpr CUtensorMapDataType IN_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType OUT_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static void mma(Acc (&d)[128], uint64_t a, uint64_t b) { wgmma_m64n256k16(d, a, b); }
  __device__ static void store2(unsigned char* p, Acc v0, Acc v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
};

template <typename Mma>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
matmul_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_c, int M, int N, int K) {
  constexpr int KE = TKB / sizeof(typename Mma::In);   // elements of K a stage
  constexpr int CW = 128 / sizeof(typename Mma::Out);  // output columns of a 128-byte epilogue chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(base);
  auto full = [&](int s) { return ring + BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return ring + BAR_OFF + 8 * (STAGES + s); };

  const int n_m = M / TM, n_n = (N + TN - 1) / TN;
  const int n_tiles = n_m * n_n;
  const int n_k = (K + KE - 1) / KE;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival from each consumer warpgroup
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread keeps the ring full, across tiles.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      RingPos<STAGES> pos;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int tm, tn;
        tile_at<GROUP_M>(tile, n_m, n_n, tm, tn);
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(empty(pos.stage), pos.phase ^ 1);
          const uint32_t st = ring + pos.stage * STAGE_BYTES;
          mbar_arrive_expect_tx(full(pos.stage), STAGE_BYTES);
          tma_load_2d(st, &map_a, full(pos.stage), kt * KE, tm * TM);
          tma_load_2d(st + A_BYTES, &map_w, full(pos.stage), kt * KE, tn * TN);
          pos.advance();
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;  // this consumer's 64 rows of the tile
    const int tid = threadIdx.x & 127;
    const bool lead = tid == 0;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    unsigned char* const epi = base + EPI_OFF + cw * 2 * CHUNK_BYTES;
    RingPos<STAGES> pos;
    int n_stores = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int tm, tn;
      tile_at<GROUP_M>(tile, n_m, n_n, tm, tn);
      typename Mma::Acc acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      int prev = 0;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(full(pos.stage), pos.phase);
        const uint32_t a_s = ring + pos.stage * STAGE_BYTES + cw * 64 * 128;
        const uint32_t w_s = ring + pos.stage * STAGE_BYTES + A_BYTES;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TKB / 32; ++kk) Mma::mma(acc, smem_desc(a_s + 32 * kk), smem_desc(w_s + 32 * kk));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        fence_operands(acc);
        if (kt > 0 && lead) mbar_arrive(empty(prev));
        prev = pos.stage;
        pos.advance();
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lead) mbar_arrive(empty(prev));

      // Epilogue, by 128-byte column chunks. Accumulator layout (m64nNk*):
      // warp w holds rows 16w + g (registers 4i, 4i+1) and 16w + g + 8
      // (4i+2, 4i+3) at columns 8i + 2t and the next one. A chunk goes into
      // the buffer whose last store has finished reading it, swizzled as the
      // store's tensor map expects; the store clips columns past N.
      const int row0 = tm * TM + cw * 64;
#pragma unroll
      for (int c = 0; c < TN / CW; ++c) {
        const int col0 = tn * TN + c * CW;
        if (col0 >= N) break;
        unsigned char* const buf = epi + (n_stores & 1) * CHUNK_BYTES;
        if (lead) bulk_wait_read<1>();
        named_sync(1 + cw, 128);
#pragma unroll
        for (int ib = 0; ib < CW / 8; ++ib) {
          const int i = c * (CW / 8) + ib;
          const int byte = (8 * ib + 2 * t) * static_cast<int>(sizeof(typename Mma::Out));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            Mma::store2(buf + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15), acc[4 * i + 2 * h],
                        acc[4 * i + 2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_sync(1 + cw, 128);
        if (lead) {
          tma_store_2d(&map_c, smem_u32(buf), col0, row0);
          bulk_commit();
        }
        ++n_stores;
      }
    }
    if (lead) bulk_wait_all();
  }
}

template <typename Mma>
int launch(const void* a, const void* w, void* c, int M, int N, int K, cudaStream_t stream) {
  constexpr cuuint64_t in_bytes = sizeof(typename Mma::In), out_bytes = sizeof(typename Mma::Out);
  CUtensorMap map_a, map_w, map_c;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_w[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t dims_c[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t row_in[1] = {K * in_bytes}, row_out[1] = {N * out_bytes};
  const cuuint32_t box_a[2] = {TKB / in_bytes, TM}, box_w[2] = {TKB / in_bytes, TN}, box_c[2] = {128 / out_bytes, 64};
  int e = encode_tensor_map(&map_a, Mma::IN_TYPE, 2, a, dims_a, row_in, box_a);
  if (e == 0) e = encode_tensor_map(&map_w, Mma::IN_TYPE, 2, w, dims_w, row_in, box_w);
  if (e == 0) e = encode_tensor_map(&map_c, Mma::OUT_TYPE, 2, c, dims_c, row_out, box_c);
  int sms = 0;
  static int cached[64] = {};
  if (e == 0) e = prepare_launch(reinterpret_cast<const void*>(matmul_kernel<Mma>), SMEM, cached, &sms);
  if (e != 0) return e;
  const int n_tiles = (M / TM) * ((N + TN - 1) / TN);
  matmul_kernel<Mma><<<n_tiles < sms ? n_tiles : sms, PIPE_THREADS, SMEM, stream>>>(map_a, map_w, map_c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/matmul.py):
// M and N multiples of 128 (M / 128 <= 65535), K a multiple of 64, pointers
// 16-byte aligned. Each returns the first error of the tensor maps' encoding
// or of the launch.

// c (M, N) int32 = a (M, K) int8 . w (N, K)^T int8
extern "C" int lemon_matmul_int8(const void* a, const void* w, void* c, int M, int N, int K, void* stream) {
  return launch<Int8Mma>(a, w, c, M, N, K, static_cast<cudaStream_t>(stream));
}

// c (M, N) bf16 = a (M, K) bf16 . w (N, K)^T bf16, fp32 sums rounded once
extern "C" int lemon_matmul_bf16(const void* a, const void* w, void* c, int M, int N, int K, void* stream) {
  return launch<Bf16Mma>(a, w, c, M, N, K, static_cast<cudaStream_t>(stream));
}
