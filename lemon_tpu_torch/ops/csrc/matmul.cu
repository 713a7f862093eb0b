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
// M and N are multiples of 128 and K a multiple of 64; a K whose bytes are
// not a whole 128-byte stage (int8 at K = 64 mod 128) is zero-filled.
//
// Why w and not the probe's (K, N) b. Integer wgmma (`.s32.s8.s8`, k32)
// takes both operands K-major only; a (K, N) b would have to be transposed
// byte by byte in shared memory. The port keeps its weights (N, K) already,
// so both type pairs take w = b^T, and the probe transposes its constant
// weights once, outside its timed chains. Both then stage alike: 128 rows of
// 128 bytes an operand per stage (64 bf16 or 128 int8 values of K), and a
// wgmma step reads 32 bytes of each row (k16 bf16, k32 int8).
//
// Design: a 128 x 128 output tile per block of two warpgroups (one 64-row
// half each), all 256 threads streaming a 3-stage ring of a and w tiles with
// cp.async into 128-byte-swizzled shared memory (32 KB a stage, 97 KB a
// block, two blocks an SM), each warpgroup running 4 wgmma m64n128 steps a
// stage from K1 `high`'s descriptors (scoremax.cu, hopper.cuh). The epilogue
// writes each thread's accumulator pairs (int2, or a bf16x2 rounded once).
// What bounds it on an H100 at the probe's 4096^3: operations, 137 G of them,
// 0.069 ms at 1979 TOP/s int8 and 0.139 ms at 989 TFLOP/s bf16, against
// 34 MB of inputs and 67 MB (int32) or 34 MB (bf16) of output, 0.03 ms. This
// first version is written for correctness: no TMA, no warp specialisation,
// no persistence, no overlap of a tile's epilogue with the next one's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace lemon_hopper;

constexpr int TM = 128;                      // rows of a block's output tile: 2 warpgroups x 64
constexpr int TN = 128;                      // columns of a block's output tile
constexpr int TKB = 128;                     // bytes of K a stage: one 128-byte swizzle atom
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TILE_BYTES = 128 * TKB;        // 128 rows of 128 B
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // a, w
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 B

// d (64 x 128 s32, wgmma accumulator layout) += A (64 x 32) . B (128 x 32)^T,
// int8, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The two type pairs: operand, accumulator and output types, one wgmma step
// (32 bytes of K), and the store of two neighbouring outputs.
struct Int8Mma {
  using In = int8_t;
  using Acc = int;
  using Out = int;
  __device__ static void mma(Acc (&d)[64], uint64_t a, uint64_t b) { wgmma_m64n128k32_s8(d, a, b); }
  __device__ static void store2(Out* p, Acc v0, Acc v1) { *reinterpret_cast<int2*>(p) = make_int2(v0, v1); }
};

struct Bf16Mma {
  using In = __nv_bfloat16;
  using Acc = float;
  using Out = __nv_bfloat16;
  __device__ static void mma(Acc (&d)[64], uint64_t a, uint64_t b) { wgmma_m64n128k16(d, a, b); }
  __device__ static void store2(Out* p, Acc v0, Acc v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  }
};

template <typename Mma>
__global__ void __launch_bounds__(THREADS, 2)
matmul_kernel(const typename Mma::In* __restrict__ a, const typename Mma::In* __restrict__ w,
              typename Mma::Out* __restrict__ c, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.y) * TM;
  const long long col0 = static_cast<long long>(blockIdx.x) * TN;
  const long long kbytes = static_cast<long long>(K) * sizeof(typename Mma::In);
  const int n_k = static_cast<int>((kbytes + TKB - 1) / TKB);
  const auto* a_bytes = reinterpret_cast<const unsigned char*>(a);
  const auto* w_bytes = reinterpret_cast<const unsigned char*>(w);

  // Stage `kt` of a and w into ring slot `slot`: 128 rows x 8 chunks of 16 B
  // an operand, chunk j of row r stored at chunk j ^ (r % 8) (the 128-byte
  // swizzle); chunks past K read as zeros.
  auto load_stage = [&](int kt, int slot) {
    const uint32_t st = ring + slot * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < 128 * 8 / THREADS; ++i) {
      const int id = tid + i * THREADS;
      const int r = id >> 3, j = id & 7;
      const uint32_t off = r * 128 + ((j ^ (r & 7)) << 4);
      const long long kb = static_cast<long long>(kt) * TKB + j * 16;
      const bool ok = kb < kbytes;
      const long long k_off = ok ? kb : 0;
      cp_async16(st + off, a_bytes + (row0 + r) * kbytes + k_off, ok ? 16 : 0);
      cp_async16(st + TILE_BYTES + off, w_bytes + (col0 + r) * kbytes + k_off, ok ? 16 : 0);
    }
  };

  typename Mma::Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_async_barrier();  // every thread's stage kt has landed and is visible to wgmma; slot (kt-1) % STAGES is free
    if (kt + STAGES - 1 < n_k) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();

    const uint32_t st = ring + (kt % STAGES) * STAGE_BYTES;
    const uint32_t a_s = st + wg * 64 * 128;  // this warpgroup's 64 rows of a
    const uint32_t w_s = st + TILE_BYTES;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TKB / 32; ++kk) {
      const uint32_t o = kk * 32;  // 32 bytes further along K, inside the swizzle atom
      Mma::mma(acc, smem_desc(a_s + o), smem_desc(w_s + o));
    }
    wgmma_commit();
    wgmma_wait();
    fence_operands(acc);
  }

  // Accumulator layout (m64nNk*): warp w of the warpgroup holds rows
  // 16w + lane/4 (registers 4i, 4i+1) and 16w + lane/4 + 8 (4i+2, 4i+3), at
  // columns 8i + 2(lane%4) and the next one.
  const long long r_base = row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    typename Mma::Out* out = c + (r_base + 8 * h) * N + col0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) Mma::store2(out + 8 * i, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
}

template <typename Mma>
int launch(const void* a, const void* w, void* c, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(matmul_kernel<Mma>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / TN, M / TM);
  matmul_kernel<Mma><<<grid, THREADS, SMEM, stream>>>(static_cast<const typename Mma::In*>(a),
                                                      static_cast<const typename Mma::In*>(w),
                                                      static_cast<typename Mma::Out*>(c), N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/matmul.py):
// M and N multiples of 128 (M / 128 <= 65535), K a multiple of 64. Each
// returns the launch's error code.

// c (M, N) int32 = a (M, K) int8 . w (N, K)^T int8
extern "C" int lemon_matmul_int8(const void* a, const void* w, void* c, int M, int N, int K, void* stream) {
  return launch<Int8Mma>(a, w, c, M, N, K, static_cast<cudaStream_t>(stream));
}

// c (M, N) bf16 = a (M, K) bf16 . w (N, K)^T bf16, fp32 sums rounded once
extern "C" int lemon_matmul_bf16(const void* a, const void* w, void* c, int M, int N, int K, void* stream) {
  return launch<Bf16Mma>(a, w, c, M, N, K, static_cast<cudaStream_t>(stream));
}
