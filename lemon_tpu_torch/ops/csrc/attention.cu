// Flash attention, forward only, on Hopper's tensor cores: fp32 in and out in
// 3xTF32, and bf16 in and out with bf16 products (the second kernel, below
// flash_attention_kernel).
//
// Replaces the Pallas kernel lemon_tpu/ops/attention.py `_attn_kernel`
// (launched by `_flash_attention`, :101). For q, k, v in the CLIP towers'
// (B, L, H, D) layout it writes o (B, L, H, D) contiguous:
//
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h]) v[b, j, h]
//
// with scale = D^-0.5 applied to q in fp32 before the product
// (attention.py:42) and, when causal, only keys j <= i. The (L, L) logits
// never reach device memory. A work item is one 64-row query tile of one
// (batch, head); one warpgroup (128 threads) walks its keys in tiles of BKV,
// carrying the online-softmax state (running max, normaliser, accumulator) in
// fp32 registers. Bounds checks replace the TPU kernel's padding to 128 and
// its -1e30 key mask: keys past L or after the query (causal) get -inf
// logits and zero v rows, query rows past L are computed on zeros and never
// stored, and a causal item stops at its last query row.
//
// Precision: 3xTF32. Every operand x is split into TF32 values hi + lo
// (Veltkamp's split, see split()), and each product is hi.hi + hi.lo + lo.hi
// (lo.lo dropped), accumulated in fp32 by wgmma.mma_async.m64nNk8.f32.tf32.
// The product of two TF32 values is exact in fp32, so the result is
// fp32-accurate up to the order of the sums (2e-5 against fp32 attention).
// Both products run on the tensor cores:
// - S = (q * scale) . k^T, both operands K-major (D contiguous) from shared
//   memory: an item's q tile is split and stored once, each k tile once;
// - O += P . V, P from registers, V^T from shared memory. A TF32 wgmma takes
//   only K-major operands, so V is stored transposed (D rows of keys). The
//   S accumulator gives a thread columns 2t and 2t+1 of each 8, while the
//   TF32 A fragment wants k = t and t + 4; the keys of every group of 8 are
//   therefore stored in the order 0, 2, 4, 6, 1, 3, 5, 7, so that the S
//   registers are the A fragment as they stand (no shuffles).
// Shared operands use the 128-byte swizzle (16-byte chunk j of a 128-byte row
// r at chunk j ^ (r % 8), 8-row groups 1024 B apart); a TF32 row of 32
// values is one atom, so D = 64 is two atoms along K and a k-step of 8 moves
// the descriptor 32 bytes inside the atom.
//
// Overlap. The wgmmas are asynchronous: v^T is split and stored while S runs,
// the next k tile while P . V runs, and each tile's global loads go to
// registers one phase ahead of their stores. Generic-proxy stores reach
// wgmma through a fence.proxy.async and a barrier (without it the products
// read stale tiles). The kernel is persistent: as many blocks as fit on the
// card each take every n-th item, n coprime to the query tiles of a head so
// that causal items of all lengths spread evenly, and an item's last key tile
// loads the next item's q and first k and v tiles.
//
// What bounds it on an H100. At the towers' shapes (L 50..256, D 64) the
// three TF32 products are 12*B*H*L^2*D flops against 16*B*L*H*D bytes moved:
// at L = 197 and 256 (causal) the tensor cores at 495 TFLOP/s and the bytes
// at 3.35 TB/s are both near 0.09 ms, at L = 50 and 77 the bytes set it.
// Measured, the products are not what limits it: a tile's integer address
// and split work, the barriers and the latency of each item's first loads
// are, with two or three blocks on an SM. Query tiles are padded to 64 rows
// (197 -> 256). Keys go in 64-key tiles (96 KB of shared memory at D = 64,
// two blocks an SM), or in 32-key tiles (64 KB, three blocks, registers
// capped at 168) where the last 64-key tile would be at most half full
// (L = 77 and 197 pad to 96 and 224 keys instead of 128 and 256); D = 128
// takes 32-key tiles (128 KB, one block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <numeric>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace lemon_hopper;

constexpr int BQ = 64;        // query rows per block: one warpgroup's m64
constexpr int THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int BKV_>
struct Tiles {
  static constexpr int BKV = BKV_;                       // keys per tile
  static constexpr int Q_BYTES = BQ * D * 4;             // one of q_hi, q_lo
  static constexpr int KV_BYTES = BKV * D * 4;           // one of k_hi, k_lo, vt_hi, vt_lo
  static constexpr int SMEM = 2 * Q_BYTES + 4 * KV_BYTES + 1024;  // + slack to align to 1024 B
  static constexpr int Q4 = BQ * D / 4 / THREADS;        // float4 of a q tile per thread
  static constexpr int K4 = BKV * D / 4 / THREADS;       // float4 of a k tile per thread
  static constexpr int VG = D * (BKV / 8) / THREADS;     // (column, 8-key group) items of a v tile per thread
  // 32-key tiles at D <= 64 fit three blocks on an SM (registers capped at 168)
  static constexpr int MIN_BLOCKS = (D <= 64 && BKV == 32) ? 3 : 1;
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// Veltkamp's split in four fp32 operations, rounded to nearest and never
// contracted: hi = x rounded to 11 significant bits (a TF32 value), and
// lo = x - hi exactly, with at most 12 significant bits, of which the tensor
// core reads the TF32 part (the low 13 bits of the container are not used),
// dropping at most 2^-23 of |x|. Needs |x| < 2^114 (8193 x stays finite).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float t = __fmul_rn(x, 8193.f);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ void store_split4(unsigned char* hi_base, unsigned char* lo_base, uint32_t off, float a,
                                             float b, float c, float d) {
  uint4 h, l;
  split(a, h.x, l.x);
  split(b, h.y, l.y);
  split(c, h.z, l.z);
  split(d, h.w, l.w);
  *reinterpret_cast<uint4*>(hi_base + off) = h;
  *reinterpret_cast<uint4*>(lo_base + off) = l;
}

// Byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in one atom
// column of a 128-byte-swizzled operand.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// The accumulator operands of an m64nNk8 product: N/2 floats a thread.
#define ACC4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define ACC16(i) ACC4(i), ACC4((i) + 4), ACC4((i) + 8), ACC4((i) + 12)
#define LIST16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define LIST32 LIST16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define LIST64                                                                                                   \
  LIST32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51," \
         " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N fp32, wgmma accumulator layout) += A (64 x 8) . B (N x 8)^T, both
// TF32 K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" LIST16 "}, %16, %17, p, 1, 1;\n}\n"
      : ACC16(0)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" LIST32 "}, %32, %33, p, 1, 1;\n}\n"
      : ACC16(0), ACC16(16)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x N fp32) += A (64 x 8, TF32 register fragment) . B (N x 8)^T, B TF32
// K-major in shared memory. Fragment of warp w, lane 4g + t: a0 = A[16w + g][t],
// a1 = A[16w + g + 8][t], a2 = A[16w + g][t + 4], a3 = A[16w + g + 8][t + 4].
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" LIST16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC16(0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" LIST32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC16(0), ACC16(16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" LIST64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <int D, int BKV_>
__global__ void __launch_bounds__(THREADS, (Tiles<D, BKV_>::MIN_BLOCKS))
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ o, int B, int L, int H, long long stride_b, long long stride_l,
                       float scale, int causal) {
  using T = Tiles<D, BKV_>;
  constexpr int BKV = T::BKV;
  constexpr int NS = BKV / 2;  // S accumulators a thread
  constexpr int NO = D / 2;    // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sq_hi = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* const sq_lo = sq_hi + T::Q_BYTES;
  unsigned char* const sk_hi = sq_lo + T::Q_BYTES;  // [D / 32 atoms][BKV rows][128 B]
  unsigned char* const sk_lo = sk_hi + T::KV_BYTES;
  unsigned char* const sv_hi = sk_lo + T::KV_BYTES;  // v^T: [BKV / 32 atoms][D rows][128 B], keys permuted
  unsigned char* const sv_lo = sv_hi + T::KV_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_qt = (L + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;

  // A work item is one 64-row query tile of one (batch, head); consecutive
  // items are the query tiles of one head, so the blocks in flight share
  // their k and v in L2.
  struct Item {
    long long in, out;  // offsets of the head's first element in q/k/v and in o
    int q0;
  };
  auto item_at = [&](int it) {
    const int bh = it / n_qt;
    const int b = bh / H, h = bh - b * H;
    return Item{static_cast<long long>(b) * stride_b + static_cast<long long>(h) * D,
                (static_cast<long long>(b) * L * H + h) * D, (it - bh * n_qt) * BQ};
  };

  // Tiles as loaded: float4 rows of q and k (16-byte chunks of D), and for
  // v, 8 consecutive keys of one column (lanes on consecutive columns).
  // Offsets inside a head are 32-bit (the wrapper keeps (L + 64) * stride_l
  // below 2^31).
  const int stride = static_cast<int>(stride_l);
  constexpr int KSTEP = THREADS / (D / 4);  // rows between a thread's float4
  constexpr int VSTEP = 8 * (THREADS / D);  // v rows between a thread's 8-key groups
  const int k_row0 = tid / (D / 4), k_col = (tid % (D / 4)) * 4;
  const int v_row0 = 8 * (tid / D), v_col = tid % D;
  float4 qr[T::Q4];
  float4 kr[T::K4];
  float vr[T::VG][8];
  auto load_q = [&](const Item& it) {
    const int lim = L - it.q0 - k_row0;  // this thread's row i * KSTEP is a query while below lim
    const float* const base = q + it.in + (it.q0 + k_row0) * stride + k_col;
#pragma unroll
    for (int i = 0; i < T::Q4; ++i)
      qr[i] = i * KSTEP < lim ? __ldg(reinterpret_cast<const float4*>(base + i * KSTEP * stride))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto load_k = [&](const Item& it, int k0) {
    const int lim = L - k0 - k_row0;
    const float* const base = k + it.in + (k0 + k_row0) * stride + k_col;
#pragma unroll
    for (int i = 0; i < T::K4; ++i)
      kr[i] = i * KSTEP < lim ? __ldg(reinterpret_cast<const float4*>(base + i * KSTEP * stride))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto load_v = [&](const Item& it, int k0) {
    const int lim = L - k0 - v_row0;
    const float* const base = v + it.in + (k0 + v_row0) * stride + v_col;
#pragma unroll
    for (int i = 0; i < T::VG; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) vr[i][j] = i * VSTEP + j < lim ? __ldg(base + (i * VSTEP + j) * stride) : 0.f;
  };
  auto store_q = [&]() {  // scaled, then split
#pragma unroll
    for (int i = 0; i < T::Q4; ++i) {
      const int r = k_row0 + i * KSTEP, c4 = k_col / 4;
      store_split4(sq_hi, sq_lo, (c4 >> 3) * BQ * 128 + swz(r, c4 & 7), qr[i].x * scale, qr[i].y * scale,
                   qr[i].z * scale, qr[i].w * scale);
    }
  };
  auto store_k = [&]() {
#pragma unroll
    for (int i = 0; i < T::K4; ++i) {
      const int r = k_row0 + i * KSTEP, c4 = k_col / 4;
      store_split4(sk_hi, sk_lo, (c4 >> 3) * BKV * 128 + swz(r, c4 & 7), kr[i].x, kr[i].y, kr[i].z, kr[i].w);
    }
  };
  auto store_v = [&]() {
#pragma unroll
    for (int i = 0; i < T::VG; ++i) {
      const int d = v_col, grp = (v_row0 + i * VSTEP) / 8;
      // keys 8grp..8grp+7 sit at positions 8grp + (0, 4, 1, 5, 2, 6, 3, 7):
      // chunk 2(grp % 4) holds keys 0, 2, 4, 6 and the next chunk 1, 3, 5, 7
      const uint32_t atom = (grp >> 2) * D * 128;
      const int chunk = 2 * (grp & 3);
      store_split4(sv_hi, sv_lo, atom + swz(d, chunk), vr[i][0], vr[i][2], vr[i][4], vr[i][6]);
      store_split4(sv_hi, sv_lo, atom + swz(d, chunk + 1), vr[i][1], vr[i][3], vr[i][5], vr[i][7]);
    }
  };

  // Descriptors of the operands' first k-step; a k-step adds its byte offset / 16.
  const uint64_t dq_hi = smem_desc(smem_u32(sq_hi)), dq_lo = smem_desc(smem_u32(sq_lo));
  const uint64_t dk_hi = smem_desc(smem_u32(sk_hi)), dk_lo = smem_desc(smem_u32(sk_lo));
  const uint64_t dv_hi = smem_desc(smem_u32(sv_hi)), dv_lo = smem_desc(smem_u32(sv_lo));

  const int n_blocks = static_cast<int>(gridDim.x);
  int item = blockIdx.x;
  Item cur = item_at(item);
  load_k(cur, 0);
  load_v(cur, 0);
  load_q(cur);
  for (; item < n_items; item += n_blocks) {
    const bool has_next = item + n_blocks < n_items;
    const Item next = item_at(has_next ? item + n_blocks : item);
    const int q0 = cur.q0;
    const int kv_end = causal ? min(L, q0 + BQ) : L;
    const int n_tiles = (kv_end + BKV - 1) / BKV;
    // This thread's rows of the tile: r0 (accumulators 4i, 4i+1) and r0 + 8
    // (4i+2, 4i+3), at columns 8i + 2t and 8i + 2t + 1.
    const int r0 = q0 + warp * 16 + g;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    store_q();
    store_k();
    fence_async_barrier();

    // Per key tile: S = (q * scale) . k^T is issued, v^T is stored while it
    // runs and the next k tile is loaded; softmax; O += P . v is issued, the
    // next k tile is stored while it runs and the next v tile is loaded. The
    // last key tile loads the next item's first k and v tiles and its q.
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * BKV;
      const bool more = kt + 1 < n_tiles;

      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint32_t qo = ((ks >> 2) * BQ * 128 + (ks & 3) * 32) >> 4;
        const uint32_t ko = ((ks >> 2) * BKV * 128 + (ks & 3) * 32) >> 4;
        wgmma_ss<BKV>(s, dq_hi + qo, dk_hi + ko);
        wgmma_ss<BKV>(s, dq_hi + qo, dk_lo + ko);
        wgmma_ss<BKV>(s, dq_lo + qo, dk_hi + ko);
      }
      wgmma_commit();
      store_v();  // v^T is free: the last P . v finished before the barrier
      if (more) load_k(cur, k0 + BKV);
      else if (has_next) load_k(next, 0);
      wgmma_wait();
      fence_operands(s);

      // Online softmax over this tile; the row max is a quad max.
      if (k0 + BKV > L || (causal && k0 + BKV - 1 > q0)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = r0 + ((i & 2) ? 8 : 0);
          if (col >= L || (causal && col > row)) s[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], nb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // every row sees key 0 in the first tile, so m_new is finite; the
        // guard keeps a fully masked row at zero weight instead of NaN
        const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[r] = ex2((m[r] - base) * LOG2E);
        nb[r] = -base * LOG2E;
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t p_hi[NS], p_lo[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        const float p = ex2(fmaf(s[i], LOG2E, nb[r]));
        l[r] += p;
        split(p, p_hi[i], p_lo[i]);
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
      fence_async_barrier();  // v^T is visible; every warp is done with k

      // O += P . v (keys past L have weight 0 and v rows of 0)
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKV / 8; ++ks) {
        const uint32_t vo = ((ks >> 2) * D * 128 + (ks & 3) * 32) >> 4;
        const int i = 4 * ks;
        wgmma_rs<D>(acc, p_hi[i], p_hi[i + 2], p_hi[i + 1], p_hi[i + 3], dv_hi + vo);
        wgmma_rs<D>(acc, p_hi[i], p_hi[i + 2], p_hi[i + 1], p_hi[i + 3], dv_lo + vo);
        wgmma_rs<D>(acc, p_lo[i], p_lo[i + 2], p_lo[i + 1], p_lo[i + 3], dv_hi + vo);
      }
      wgmma_commit();
      if (more) {
        store_k();
        load_v(cur, k0 + BKV);
      } else if (has_next) {
        load_v(next, 0);
        load_q(next);
      }
      wgmma_wait();
      fence_operands(acc);
      fence_operands(p_hi);
      fence_operands(p_lo);
      fence_async_barrier();  // the next k is visible; every warp is done with q, k and v^T
    }

    const long long row_stride = static_cast<long long>(H) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      const float inv = 1.f / (sum + __shfl_xor_sync(0xffffffffu, sum, 2));
      const int row = r0 + 8 * r;
      if (row >= L) continue;
      float* const out = o + cur.out + row * row_stride + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(out + 8 * i) = make_float2(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
    }
    cur = next;
  }
}

template <int D, int BKV>
int launch(const float* q, const float* k, const float* v, float* o, int B, int L, int H, long long stride_b,
           long long stride_l, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Tiles<D, BKV>::SMEM;
  static int resident[64] = {};  // blocks that fit on the card at once, by device ordinal
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || resident[dev] == 0) {
    e = cudaFuncSetAttribute(flash_attention_kernel<D, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_attention_kernel<D, BKV>, THREADS, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    resident[dev] = per_sm * sms;
  }
  const int n_qt = (L + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;
  // A block takes every n_blocks-th item. With n_blocks coprime to the number
  // of query tiles a head has, each block cycles through all tile positions,
  // so causal heads (later tiles see more keys) spread evenly over the blocks.
  int n_blocks = min(n_items, resident[dev]);
  while (n_blocks > 1 && std::gcd(n_blocks, n_qt) != 1) --n_blocks;
  flash_attention_kernel<D, BKV><<<n_blocks, THREADS, smem, stream>>>(q, k, v, o, B, L, H, stride_b,
                                                                                     stride_l, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3 on bf16 inputs: the JAX towers' compute dtype under attention_impl
// 'pallas' (the TPU kernel upcasts q, k and v, accumulates in fp32 and writes
// q's dtype, attention.py:42, 48-49, 144). For bf16 q, k, v in (B, L, H, D)
// it writes bf16 o (B, L, H, D) contiguous, rounded to nearest even once:
//
//   o[b, i, h] = bf16( sum_j softmax_j(scale * (q[b, i, h] . k[b, j, h])) v[b, j, h] )
//
// - S = q . k^T is one wgmma.mma_async.m64nNk16.f32.bf16.bf16 product: the
//   product of two bf16 values is exact in fp32, so S is the fp32 dot of the
//   upcast values up to the order of the sums. scale = D^-0.5 enters in fp32
//   with the exponent: p = 2^(s * scale * log2(e) - m * scale * log2(e)) for
//   the row max m of S (the TPU kernel scales q first, the plain versions S;
//   each differs from this by an fp32 rounding or two).
// - O += P . V is two bf16 products, p_hi . v + p_lo . v, with the fp32
//   probabilities split into bf16 p_hi = bf16(p) and p_lo = bf16(p - p_hi)
//   (|p - p_hi - p_lo| <= 2^-17 p); v is exact in bf16. One product with P
//   rounded to bf16 would err by as much as the output's own bf16 rounding.
// - Running max, normaliser and accumulator stay in fp32 registers.
//
// Operands. q and k are K-major (D contiguous) in shared memory, 128-byte
// swizzled as TMA writes them: a row of 64 bf16 is one atom, a k16 step
// moves the descriptor 32 bytes inside it, and D = 128 is two atoms (64 rows
// * 128 B apart). For 16-bit types wgmma takes an MN-major B (the transpose
// bit), so v is used as it lies in memory: key rows of 64 columns, 8-key
// groups 1024 B apart (SBO), 64-column atoms 64 * 128 B apart (LBO). The
// fp32 S accumulator, converted pairwise to bf16x2, is the A fragment of the
// following k16 product as it stands (registers 4i..4i+3 of column block i:
// rows g and g + 8 at columns 8i + 2t, 8i + 2t + 1), so P stays in registers.
//
// What bounds it on an H100. By the bytes alone (q, k, v read and o written
// once, 8 B per (token, head, dim) element, at 3.35 TB/s) 0.046 ms at
// (128, 197, 12, 64), against 0.023 ms for the three bf16 products at
// 989 TFLOP/s. But a tile of 64 queries meets its keys in a short chain, S
// -> softmax -> P . V, 4 tiles long at L = 197, and the chain's latency sets
// the pace unless several chains run on each SM and the softmax overlaps the
// products. Padding adds to the work: 197 rows are 256 in 64-row tiles.
//
// Work and memory. A work item is one 64-row query tile of one (batch, head),
// and a block is one warpgroup with a pipeline of its own: its lead thread
// loads the item's q and the 64-key K and V tiles by TMA (4-D (D, H, L, B)
// tensor maps with the wrapper's strides; rows past L load as zeros and get
// -inf logits) into a two-stage ring whose "full" mbarriers the whole
// warpgroup waits on. The loads run ahead of the products across items: a
// stage is refilled as soon as the P . V that read it has completed, and the
// next item's q is loaded once the item's last S has read the current one.
// The grid is persistent: four blocks an SM at D <= 64 (128 registers and
// 50 KB of shared memory each; two at D = 128), each taking every n-th item,
// n coprime to the query tiles of a head, causal heads from their longest
// tile down. S of key tile j is issued with P . V of tile j - 1, and tile
// j's softmax runs while that P . V is in flight. An unmasked item's last
// key tile is only as wide as the keys past the last full tile, rounded up
// to 16 (the kernel's TAIL: 16 at L = 197, so 208 keys meet the queries,
// not 256). O is normalised in registers, written swizzled to a shared tile
// and stored by TMA (rows past L are clipped). D = 32 loads as a 64-column
// box whose upper half lies past D: TMA zero-fills it, the products see zero
// columns, and the store clips them.
//
// Why no producer warp. The warp-specialised layout of hopper.cuh (a
// producer warp or warpgroup, two consumer warpgroups on 128-row items)
// measured slower than the first version of this kernel at the towers'
// shapes: one block an SM runs only two chains, and a second block leaves
// each thread 96 registers (nine warps a block put five on one of the SM's
// four register files), too few for the overlapped softmax. Four self-fed
// warpgroups an SM hold 128 registers each.

// MN-major 16-bit operand in 128-byte-swizzled rows of 64 values: 8-row
// (K) groups 1024 B apart (SBO), 64-column atoms `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// d (64 x N fp32, the first N / 2 of a thread's 32 registers) += A (64 x 16)
// . B (N x 16)^T, bf16, both K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss_bf16<16>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : ACC4(0), ACC4(4)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_bf16<32>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" LIST16 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16(0)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_bf16<48>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {" LIST16 ", %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : ACC16(0), ACC4(16), ACC4(20)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_bf16<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" LIST32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC16(0), ACC16(16)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x N fp32) += A (64 x 16, bf16x2 register fragment) . B (16 x N), B bf16
// MN-major in shared memory (transpose bit set). Fragment of warp w, lane
// 4g + t: a0 = A[16w + g][2t, 2t + 1], a1 = A[16w + g + 8][2t, 2t + 1],
// a2 = A[16w + g][2t + 8, 2t + 9], a3 = A[16w + g + 8][2t + 8, 2t + 9].
template <int N>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs_bf16<64>(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" LIST32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC16(0), ACC16(16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_bf16<128>(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LIST64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

template <int D>
struct Bf16Tiles {
  static constexpr int DP = D < 64 ? 64 : D;  // staged head dim: D = 32 is zero-filled to one 64-column atom
  static constexpr int ATOMS = DP / 64;
  static constexpr int BKV = 64;              // keys per tile
  static constexpr int STAGES = 2;            // K/V tiles in flight
  static constexpr int TILE_BYTES = 64 * DP * 2;  // 64 rows of q, k, v or o
  static constexpr int RING_OFF = 2 * TILE_BYTES;  // after q and the o tile
  static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * TILE_BYTES;  // q_full, full[STAGES]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + STAGES) + 1024;      // + slack to align to 1024 B
  // four blocks an SM at D <= 64 (50 KB of shared memory, 128 registers a
  // thread), two at D = 128
  static constexpr int MIN_BLOCKS = DP == 64 ? 4 : 2;
};

template <int D, int TAIL>
__global__ void __launch_bounds__(THREADS, Bf16Tiles<D>::MIN_BLOCKS)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                            int B, int L, int H, float scale, int causal) {
  using T = Bf16Tiles<D>;
  constexpr int DP = T::DP;
  constexpr int BKV = T::BKV;
  constexpr int STAGES = T::STAGES;
  constexpr int NS = BKV / 2;  // S accumulators a thread
  constexpr int NO = DP / 2;   // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sq = smem_u32(base);
  unsigned char* const o_tile = base + T::TILE_BYTES;
  auto k_tile = [&](int s) { return sq + T::RING_OFF + s * 2 * T::TILE_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + T::TILE_BYTES; };
  const uint32_t q_full = sq + T::BAR_OFF;
  auto full = [&](int s) { return sq + T::BAR_OFF + 8 * (1 + s); };

  const int tid = threadIdx.x;
  const bool lead = tid == 0;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (L + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;
  const float sl2 = scale * LOG2E;

  // Item `it`: the 64-row query tile q0 of (b, h); the query tiles of a head
  // are neighbours in the order, so the blocks in flight share its k and v
  // in L2. Its key tiles: all of L, or under the causal mask those up to its
  // last row; causal heads go from their last (longest) query tile down, so
  // that the grid ends on short items.
  struct Item {
    int b, h, q0, n_kv;
  };
  auto item_at = [&](int it) {
    const int bh = it / n_qt;
    const int qt = it - bh * n_qt;
    const int b = bh / H, h = bh - b * H, q0 = (causal ? n_qt - 1 - qt : qt) * BQ;
    return Item{b, h, q0, ((causal ? min(L, q0 + BQ) : L) + BKV - 1) / BKV};
  };

  // The lead thread's loads run ahead of the products by the ring's depth,
  // across items: `ld` is the next key tile to load (item, tile).
  int ld_it = blockIdx.x, ld_j = 0, ld_count = 0;
  Item ld_item = item_at(ld_it);
  auto load_q = [&](const Item& it) {
    mbar_arrive_expect_tx(q_full, T::TILE_BYTES);
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) tma_load_4d(sq + a * 64 * 128, &map_q, q_full, 64 * a, it.h, it.q0, it.b);
  };
  auto load_next_tile = [&]() {
    if (ld_it >= n_items) return;
    const int st = ld_count % STAGES;
    mbar_arrive_expect_tx(full(st), 2 * T::TILE_BYTES);
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) {
      tma_load_4d(k_tile(st) + a * 64 * 128, &map_k, full(st), 64 * a, ld_item.h, ld_j * BKV, ld_item.b);
      tma_load_4d(v_tile(st) + a * 64 * 128, &map_v, full(st), 64 * a, ld_item.h, ld_j * BKV, ld_item.b);
    }
    ++ld_count;
    if (++ld_j == ld_item.n_kv) {
      ld_j = 0;
      ld_it += gridDim.x;
      if (ld_it < n_items) ld_item = item_at(ld_it);
    }
  };

  if (lead) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    fence_mbar_init();
    load_q(ld_item);  // the grid has no more blocks than items
    for (int s = 0; s < STAGES; ++s) load_next_tile();
  }
  __syncthreads();

  const uint64_t dq = smem_desc(sq);
  float o[NO];
  float s[NS];
  uint32_t p_hi[NS / 2], p_lo[NS / 2];
  float m[2], l[2];
  int cons = 0;  // key tiles consumed by this block

  // A tile's products and softmax take its width W (keys: 64, or TAIL for
  // the last tile of an unmasked item) as a compile-time constant.
  using Full = std::integral_constant<int, BKV>;
  using Tail = std::integral_constant<int, TAIL>;
  // S = q . k^T of the tile in stage `st`
  auto issue_s = [&](int st, auto w) {
    constexpr int W = decltype(w)::value;
    const uint64_t dk = smem_desc(k_tile(st));
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = ((ks >> 2) * 64 * 128 + (ks & 3) * 32) >> 4;
      wgmma_ss_bf16<W>(s, dq + off, dk + off);
    }
    wgmma_commit();
  };
  // O += p_hi . v + p_lo . v of the tile in stage `st` (keys past L have
  // weight 0 and v rows of 0)
  auto issue_pv = [&](int st, auto w) {
    constexpr int W = decltype(w)::value;
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks) {
      const uint64_t dv = smem_desc_mn(v_tile(st) + ks * 2048, BKV * 128);
      wgmma_rs_bf16<DP>(o, p_hi[4 * ks], p_hi[4 * ks + 1], p_hi[4 * ks + 2], p_hi[4 * ks + 3], dv);
      wgmma_rs_bf16<DP>(o, p_lo[4 * ks], p_lo[4 * ks + 1], p_lo[4 * ks + 2], p_lo[4 * ks + 3], dv);
    }
    wgmma_commit();
  };

  int n = 0;  // items of this block so far
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
    const Item cur = item_at(it);
    // This thread's rows: r0 (S registers 4i, 4i+1) and r0 + 8 (4i+2, 4i+3),
    // at columns 8i + 2t and 8i + 2t + 1.
    const int r0 = cur.q0 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;

    // Mask, online softmax of scale * S (keys k0 .. k0 + W): s becomes the
    // unnormalised P; the row max is a quad max. Returns O's rescaling.
    auto softmax = [&](int k0, float (&alpha)[2], auto w) {
      constexpr int W = decltype(w)::value;
#pragma unroll
      if (k0 + W > L || (causal && k0 + W - 1 > cur.q0)) {
#pragma unroll
        for (int i = 0; i < W / 2; ++i) {
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const int row = r0 + ((i & 2) ? 8 : 0);
          if (col >= L || (causal && col > row)) s[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < W / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float nb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // every row sees key 0 in the first tile, so m_new is finite; the
        // guard keeps a fully masked row at zero weight instead of NaN
        const float mb = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[r] = ex2((m[r] - mb) * sl2);
        nb[r] = -mb * sl2;
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const int r = j & 1;
        s[2 * j] = ex2(fmaf(s[2 * j], sl2, nb[r]));
        s[2 * j + 1] = ex2(fmaf(s[2 * j + 1], sl2, nb[r]));
        l[r] += s[2 * j];
        l[r] += s[2 * j + 1];
      }
    };
    // P in bf16x2 pairs (registers 2j, 2j + 1 of S: row (j & 1) of the pair
    // of rows), split into hi and lo
    auto split_p = [&](auto w) {
      constexpr int W = decltype(w)::value;
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
        p_hi[j] = bf16x2_bits(hi);
        p_lo[j] = bf16x2_bits(__floats2bfloat162_rn(s[2 * j] - __low2float(hi), s[2 * j + 1] - __high2float(hi)));
      }
    };
    // Once the item's last S has read q: the next item's q
    auto load_next_q = [&]() {
      if (lead && it + static_cast<int>(gridDim.x) < n_items) load_q(item_at(it + gridDim.x));
    };

    // Key tile j (from 1) of width W: S of tile j is issued, then P . V of
    // tile j - 1 (full width), and both run during tile j's softmax.
    float alpha[2];
    int st = 0, prev = 0;
    auto step = [&](int j, auto w) {
      st = cons % STAGES;
      mbar_wait(full(st), (cons / STAGES) & 1);
      issue_s(st, w);
      issue_pv(prev, Full{});
      wgmma_wait<1>();
      fence_operands(s);
      if (j == cur.n_kv - 1) load_next_q();
      softmax(j * BKV, alpha, w);
      wgmma_wait<0>();
      fence_operands(o);
      fence_operands(p_hi);
      fence_operands(p_lo);
      if (lead) load_next_tile();  // into the stage P . V has just released
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      split_p(w);
      prev = st;
      ++cons;
    };

    // Tile 0 is full width: TAIL < 64 only where an item has several tiles.
    mbar_wait(q_full, n & 1);
    st = cons % STAGES;
    mbar_wait(full(st), (cons / STAGES) & 1);
    issue_s(st, Full{});
    wgmma_wait<0>();
    fence_operands(s);
    if (cur.n_kv == 1) load_next_q();
    softmax(0, alpha, Full{});
    split_p(Full{});
    prev = st;
    ++cons;
    for (int j = 1; j < cur.n_kv - 1; ++j) step(j, Full{});
    if (cur.n_kv > 1) step(cur.n_kv - 1, Tail{});
    issue_pv(prev, Tail{});
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(p_hi);
    fence_operands(p_lo);
    if (lead) load_next_tile();

    // Epilogue: O normalised, written swizzled into the o tile once the last
    // item's store has read it, stored by TMA (rows past L are clipped)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      inv[r] = 1.f / (sum + __shfl_xor_sync(0xffffffffu, sum, 2));
    }
    if (lead) bulk_wait_read<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(o_tile + (i >> 3) * 64 * 128 + row * 128 + ((((i & 7) ^ (row & 7))) << 4) +
                                           4 * t) = __floats2bfloat162_rn(o[4 * i + 2 * r] * inv[r],
                                                                          o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (lead) {
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        tma_store_4d(&map_o, smem_u32(o_tile) + a * 64 * 128, 64 * a, cur.h, cur.q0, cur.b);
      bulk_commit();
    }
  }
  if (lead) bulk_wait_all();
}

template <int D, int TAIL>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int L, int H, long long stride_b,
                long long stride_l, float scale, int causal, cudaStream_t stream) {
  using T = Bf16Tiles<D>;
  // (D, H, L, B) views: the inputs with the wrapper's strides, o contiguous;
  // boxes of 64 columns (D = 32: half past D) by 64 rows
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t in_strides[3] = {2ull * D, 2ull * stride_l, 2ull * stride_b};
  const cuuint64_t out_strides[3] = {2ull * D, 2ull * H * D, 2ull * L * H * D};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  CUtensorMap map_q, map_k, map_v, map_o;
  int e = encode_tensor_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, dims, in_strides, box);
  if (e == 0) e = encode_tensor_map(&map_k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, k, dims, in_strides, box);
  if (e == 0) e = encode_tensor_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, v, dims, in_strides, box);
  if (e == 0) e = encode_tensor_map(&map_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, o, dims, out_strides, box);
  int sms = 0;
  static int cached[64] = {};
  if (e == 0)
    e = prepare_launch(reinterpret_cast<const void*>(flash_attention_bf16_kernel<D, TAIL>), T::SMEM, cached, &sms);
  if (e != 0) return e;
  const int n_qt = (L + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;  // the wrapper keeps it below 2^31
  // A block takes every n_blocks-th item; n_blocks coprime to the query
  // tiles of a head spreads causal items of all lengths evenly.
  int n_blocks = min(n_items, T::MIN_BLOCKS * sms);
  while (n_blocks > 1 && std::gcd(n_blocks, n_qt) != 1) --n_blocks;
  flash_attention_bf16_kernel<D, TAIL><<<n_blocks, THREADS, T::SMEM, stream>>>(map_q, map_k, map_v, map_o, B, L, H,
                                                                               scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are checked by the Python wrapper (lemon_tpu_torch/ops/attention.py):
// q, k and v share their strides, with (H, D) contiguous inside each token,
// 16-byte aligned pointers and strides that are multiples of 4; D is 32, 64
// or 128; 0 < L, B * H * ceil(L / 64) < 2^31 and (L + 64) * stride_l < 2^31.
// o is (B, L, H, D) contiguous. Returns the first CUDA error of the launch
// (cudaErrorInvalidValue for an unsupported D).
extern "C" int lemon_flash_attention(const float* q, const float* k, const float* v, float* o, int B, int L, int H,
                                     int D, long long stride_b, long long stride_l, float scale, int causal,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 64-key tiles take half the barriers a key; 32-key tiles pad fewer keys
  // where the last 64-key tile would be at most half full (L = 77, 197).
  const bool narrow = L % 64 != 0 && L % 64 <= 32;
  switch (D) {
    case 32:
      return narrow ? launch<32, 32>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st)
                    : launch<32, 64>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    case 64:
      return narrow ? launch<64, 32>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st)
                    : launch<64, 64>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    case 128: return launch<128, 32>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 kernel: the same contract with bf16 q, k, v and o, strides and
// pointers 16-byte aligned (strides multiples of 8 elements), as TMA needs
// them. Also returns the first error of the tensor maps' encoding.
extern "C" int lemon_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int L, int H,
                                          int D, long long stride_b, long long stride_l, float scale, int causal,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The width of an unmasked item's last key tile: the keys past the last
  // full tile, rounded up to a k16 step (L = 197: 16, not 64).
  const int tail = causal || L <= 64 || L % 64 == 0 ? 64 : (L % 64 + 15) / 16 * 16;
  switch (D * 4 + tail / 16 - 1) {
#define LEMON_K3_BF16(d, w) \
  case d * 4 + w / 16 - 1: return launch_bf16<d, w>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    LEMON_K3_BF16(32, 16) LEMON_K3_BF16(32, 32) LEMON_K3_BF16(32, 48) LEMON_K3_BF16(32, 64)
    LEMON_K3_BF16(64, 16) LEMON_K3_BF16(64, 32) LEMON_K3_BF16(64, 48) LEMON_K3_BF16(64, 64)
    LEMON_K3_BF16(128, 16) LEMON_K3_BF16(128, 32) LEMON_K3_BF16(128, 48) LEMON_K3_BF16(128, 64)
#undef LEMON_K3_BF16
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
