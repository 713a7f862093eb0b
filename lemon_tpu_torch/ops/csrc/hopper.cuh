// Hopper building blocks shared by the kernels on the tensor cores, K1
// (scoremax.cu), K3 (attention.cu) and P4 (matmul.cu), and by the row
// selects of K2, P1 and K4 (topk.cu, select.cu), which stage their rows with
// plain bulk copies onto the same mbarriers. None replaces a TPU kernel
// itself; each kernel's file says which one it ports.
//
// - the wgmma descriptors of K-major 128- and 64-byte-swizzled operands;
// - the TMA pipeline of K1, both K3 kernels and P4: tensor maps encoded
//   on the host (cuTensorMapEncodeTiled, looked up in libcuda at run time,
//   so the library links no -lcuda), bulk tensor loads that complete on an
//   mbarrier, bulk tensor stores, named barriers and the register hand-over
//   between warpgroups (setmaxnreg).
//
// What bounds the kernels built on it is that the tensor cores wait: on
// loads, on the previous product, on an epilogue. A ring of stages in shared
// memory keeps loads in flight: each stage has a "full" mbarrier (an
// arrive.expect_tx, then the bytes of its TMA loads) that the consumers wait
// on, and its reuse waits for the products that read it; a side's phase bit
// flips each time it wraps the ring. The grids are persistent (a block an SM
// or a few, walking a static order of work items), so one item's epilogue
// overlaps the next one's loads. TMA writes the 128-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk j of 128-byte row r at chunk
// j ^ (r % 8), 1024-byte aligned atoms) that smem_desc reads, or the 64-byte
// one that smem_desc_sw64 reads.
//
// K1 and P4 are warp-specialised (PIPE_THREADS): warpgroup 0 is the
// producer, its registers cut to PRODUCER_REGS, one thread issuing every TMA
// load; warpgroups 1 and 2 are consumers, raised to CONSUMER_REGS, that
// release a stage through its "empty" mbarrier (one arrival from each), and
// stage their outputs for TMA stores in buffers of their own. K3's kernels
// run one warpgroup a block that feeds its own ring, but for the fp32
// kernel's split schedule, where a splitter warpgroup feeds two consumers
// (attention.cu says why).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lemon_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major operand in 128-byte-swizzled rows of 128 B: 8-row groups 1024 B
// apart (SBO), the leading offset unused by this layout, swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for 64-byte-swizzled rows of 64 B (CU_TENSOR_MAP_SWIZZLE_64B:
// 16-byte chunk j of row r at chunk j ^ ((r / 2) % 4), 512-byte atoms):
// 8-row groups 512 B apart, swizzle mode 2.
__device__ __forceinline__ uint64_t smem_desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// Keeps a wgmma accumulator in its registers across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps a register A operand alive (unmoved, unreused) until after the
// wgmma that reads it has been waited for.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The same for an integer (s32) accumulator.
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// Waits until at most N of this warpgroup's committed wgmma groups are pending.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy stores to shared memory -> visible to wgmma, then a barrier.
__device__ __forceinline__ void fence_async_barrier() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// d (64 x 128 fp32, wgmma accumulator layout) += A (64 x 16) . B (128 x 16)^T,
// bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// The TMA pipeline.

constexpr int PIPE_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 <= 65536

// Host: a tiled tensor map of `rank` dimensions (innermost first), with the
// byte strides of dimensions 1..rank-1, a box of `box` elements and the
// 128-byte swizzle (or `swizzle`). Elements of a box past the tensor's
// bounds load as zeros (and still count toward the barrier's bytes), and
// are not written by a store. Returns 0 or a cudaError_t.
inline int encode_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                             const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                                           &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Host, once for each kernel on each device (by ordinal, in the caller's
// `cached`, one array for each kernel): the kernel's dynamic shared memory
// raised to `smem` bytes. Returns the SMs of the current device, the
// persistent grids' size, through `sms`, and 0 or a cudaError_t.
inline int prepare_launch(const void* kernel, int smem, int (&cached)[64], int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int n = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached[dev] = n;
  }
  *sms = cached[dev];
  return 0;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// After the barriers' init, before any thread uses them (then a __syncthreads).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA loads to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity` (passes
// at once while the barrier's current phase has the other parity). A phase
// that does not complete within 2^24 polls (far beyond any wait of a working
// pipeline) traps, so that a broken pipeline fails its launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// TMA loads of one box into shared memory, completing on `bar`; coordinates
// in elements, innermost first.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A plain bulk copy of `bytes` contiguous bytes from global to shared
// memory, completing on `bar` (K2, P1 and K4 stage their rows with it):
// src and dst 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// TMA stores of one box from shared memory; the parts past the tensor's
// bounds are not written. Tracked by bulk groups (commit, then wait).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Until at most N of this thread's committed stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until all of this thread's committed stores are complete.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy stores to shared memory -> visible to the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Tile `tile` of the grouped order over n_m x n_n output tiles: GROUP_M row
// tiles walk the column tiles together, so that the blocks in flight share
// their operand tiles in L2.
template <int GROUP_M>
__device__ __forceinline__ void tile_at(int tile, int n_m, int n_n, int& tm, int& tn) {
  const int per_group = GROUP_M * n_n;
  const int group = tile / per_group;
  const int first = group * GROUP_M;
  const int rows = min(n_m - first, GROUP_M);
  const int in_group = tile - group * per_group;
  tm = first + in_group % rows;
  tn = in_group / rows;
}

// One side's position in a ring of S stages: the stage and the parity of the
// phase it waits for.
template <int S>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

}  // namespace lemon_hopper
