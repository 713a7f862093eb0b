// PTX wrappers shared by the kernels that run on Hopper's tensor cores, K1's
// `high` (scoremax.cu) and K3 (attention.cu): shared-memory addresses, the
// cp.async ring, the wgmma descriptor of a K-major 128-byte-swizzled operand,
// and the fences and waits around a wgmma.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lemon_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past `src_bytes` (0 or 16) are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K-major operand in 128-byte-swizzled rows of 128 B: 8-row groups 1024 B
// apart (SBO), the leading offset unused by this layout, swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Generic-proxy and cp.async stores to shared memory -> visible to wgmma,
// then a barrier.
__device__ __forceinline__ void fence_async_barrier() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

}  // namespace lemon_hopper
