// Flash attention, forward only, on Hopper's tensor cores: fp32 in and out in
// 3xTF32 (flash_attention_tf32_kernel), and bf16 in and out with bf16
// products (flash_attention_bf16_kernel, below it).
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
// (batch, head); one warpgroup (128 threads) walks its keys in tiles,
// carrying the online-softmax state (running max, normaliser, accumulator) in
// fp32 registers. Bounds checks replace the TPU kernel's padding to 128 and
// its -1e30 key mask: keys past L or after the query (causal) get -inf
// logits and zero v rows, query rows past L are computed on zeros and never
// stored, and a causal item stops at its last query row.
//
// Precision of the fp32 kernel: 3xTF32. Every operand x is split into TF32
// values hi + lo (Veltkamp's split, see split()), and each product is
// hi.hi + hi.lo + lo.hi (lo.lo dropped), accumulated in fp32 by
// wgmma.mma_async.m64nNk8.f32.tf32. The product of two TF32 values is exact
// in fp32, so the result is fp32-accurate up to the order of the sums (2e-5
// against fp32 attention).
//
// Loads. The inputs are read through 4-D (D, H, L, B) tensor maps with the
// wrapper's strides, in boxes of 32 floats (one 128-byte swizzle atom) by 64
// query rows or by a key tile's rows; rows past L load as zeros. With the
// 128-byte swizzle (16-byte chunk j of a 128-byte row r at chunk j ^ (r % 8),
// 8-row groups 1024 B apart) a staged box is the K-major layout that the TF32
// wgmma descriptors read: D = 64 is two atoms along K, and a k-step of 8
// moves the descriptor 32 bytes inside an atom.
//
// The fp32 kernel's operands. A TF32 wgmma takes both shared operands
// K-major (no transpose bit), and its split is not the load:
// - q is scaled and split once per item. At D <= 64 each thread reads its
//   A fragments straight from the staged tile into registers (hi and lo,
//   D / 2 registers each), so S = q . k^T reads only k from shared memory
//   (an m64n32k8 with both operands in shared memory would read 192 bytes a
//   clock, above the 128 that shared memory serves); at D = 128 (128 more
//   registers would not fit) q is split in place in shared memory.
// - a staged k tile is split in place: hi over the raw value, lo into a
//   buffer of its own at the same offset (no address remapping);
// - v is transposed into v^T (D rows of keys) while it is split, the one
//   layout change left to generic-proxy stores. The S accumulator gives a
//   thread columns 2t and 2t+1 of each 8, while the TF32 A fragment wants
//   k = t and t + 4; the keys of every group of 8 are therefore stored in
//   the order 0, 2, 4, 6, 1, 3, 5, 7, so that P is the A fragment of
//   O += P . v^T as it stands (no shuffles).
//
// Two schedules, both with a persistent grid (each block takes every n-th
// item, n coprime to the items of a head, causal heads from their longest
// item down), a TAIL-wide last key tile for unmasked items (the keys past the
// last full tile, rounded up to a quarter tile: 8 keys at L = 197 and D = 64,
// so 200 keys meet the queries) and O normalised in registers, written
// swizzled into a shared tile and stored by TMA (rows past L are clipped).
//
// Self-fed (every shape but one): a warpgroup takes 64-row items and splits
// its own tiles, as the bf16 kernel feeds its own ring. A ring of two stages
// (raw k, raw v) is filled by the lead thread's TMA loads, across items; k's
// lo pieces and v^T have two buffers each, by the tile's parity. Key tile j:
// S_j and then P_{j-1} . v^T_{j-1} are issued; while they run, v_j is
// transposed and split and tile j+1's k is split (the next item's first tile
// at an item's last); S_j's softmax runs while P . v is in flight; one
// barrier, after which the lead thread refills the stage tile j has
// released. o is staged in the v^T buffer of the item's last tile.
//   D = 32:  64-key tiles, q in registers,      88 KB, two blocks an SM
//   D = 64:  32-key tiles, q in registers,      96 KB, two blocks an SM
//   D = 128: 32-key tiles, q split in shared,  224 KB, one block an SM
// Two blocks an SM allow 255 registers a thread (about 215 used).
//
// Split (unmasked heads at D = 64 longer than one query tile: the vision
// towers): the splits leave the warpgroups that run the products. Two
// consumer warpgroups take the two 64-row halves of a 128-row item, and a
// third splits each key tile once for both (k in place, v transposed into
// the stage's v^T) and issues the TMA loads: a ring of four stages of
// 40 KB, released by both consumers once P . v has read them, and q in two
// buffers by item parity (o is staged where its item's q was), 224 KB in
// all, one block of 384 threads an SM.
// Twelve warps leave 168 registers a thread, so a consumer keeps only q's hi
// pieces in registers and S's lo.hi product reads q's lo piece, split in
// place, from shared memory. A consumer's key tile j: S_j and P_{j-1} .
// v^T_{j-1} issued once tile j is split, S_j's softmax while P . v runs, then
// the stage of tile j - 1 released. Under the causal mask the first consumer
// would idle through each item's last two key tiles, and at D = 32 the split
// schedule measured slower: both keep the self-fed one.
//
// What bounds it on an H100. At the towers' shapes (L 50..256, D 64) the
// three TF32 products are 12*B*H*L^2*D flops against 16*B*L*H*D bytes moved:
// at L = 197 and 256 (causal) the tensor cores at 495 TFLOP/s and the bytes
// at 3.35 TB/s are both near 0.09 ms, at L = 50 and 77 the bytes set it.
// Three other floors lie near them: the loads alone (k and v re-read by each
// query tile) take 0.12-0.13 ms at (128, 197, 12, 64); a 32-key tile at
// D = 64 moves 112 KB through shared memory (16 KB staged, 48 KB for the
// splits, 48 KB read by the products), about 0.16 ms in all at 128 bytes a
// clock; and the splits, the softmax (16 ex2 a thread a tile) and the split
// of P take about 500 instructions a thread a tile. They overlap only in
// part (benchmarks/k3_limits.py splits the time). Measured on working trees
// and given up: a three- or four-stage ring (the time is not the loads'
// latency); 128-row items of two self-fed warpgroups sharing each key tile
// and its splits, in lockstep or one trailing the other by half a tile (the
// same time at L = 197, slower at L = 50 and, trailing, under the causal
// mask); a splitter warpgroup feeding one consumer that runs a tile at a
// time (slower everywhere).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <numeric>
#include <type_traits>

#include "hopper.cuh"

#ifndef LEMON_K3_STOP
// benchmarks/k3_limits.py: 1 loads only, 2 and the splits, 3 and S with its
// softmax, 4 all but the splits
#define LEMON_K3_STOP 0
#endif
#ifndef LEMON_K3_SPLITTER
#define LEMON_K3_SPLITTER 1  // benchmarks/k3_limits.py: 0 builds the self-fed kernel for every shape
#endif

namespace {

using namespace lemon_hopper;

constexpr int BQ = 64;        // query rows per block: one warpgroup's m64
constexpr int THREADS = 128;  // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ void split4(float4 x, uint4& h, uint4& l) {
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
}

// The accumulator operands of an m64nNk8 product: N/2 floats a thread.
#define ACC4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define ACC16(i) ACC4(i), ACC4((i) + 4), ACC4((i) + 8), ACC4((i) + 12)
#define LIST16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define LIST32 LIST16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define LIST64                                                                                                   \
  LIST32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51," \
         " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

#define LIST4 "%0, %1, %2, %3"
#define LIST8 LIST4 ", %4, %5, %6, %7"
#define LIST12 LIST8 ", %8, %9, %10, %11"
#define LIST24 LIST16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define ACC8(i) ACC4(i), ACC4((i) + 4)
#define ACC12(i) ACC8(i), ACC4((i) + 8)
#define ACC24(i) ACC16(i), ACC8((i) + 16)
#define ACC32(i) ACC16(i), ACC16((i) + 16)
#define ACC64(i) ACC32(i), ACC32((i) + 32)

// d (64 x N fp32, wgmma accumulator layout: the first N / 2 of the array)
// += A (64 x 8) . B (N x 8)^T, TF32, B K-major in shared memory; A K-major
// in shared memory (ss) or a register fragment (rs: of warp w, lane 4g + t,
// a0 = A[16w + g][t], a1 = A[16w + g + 8][t], a2 = A[16w + g][t + 4],
// a3 = A[16w + g + 8][t + 4]).
template <int N>
struct Tf32Mma;

#define LEMON_TF32_MMA(N, LIST, ACC, SS_AB, SS_P, RS_AB, RS_P)                                                  \
  template <>                                                                                                  \
  struct Tf32Mma<N> {                                                                                          \
    template <int M>                                                                                           \
    __device__ static __forceinline__ void ss(float (&d)[M], uint64_t desc_a, uint64_t desc_b) {               \
      static_assert(M >= N / 2, "accumulator too small");                                                      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"                                           \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" LIST "}, " SS_AB ", p, 1, 1;\n}\n" \
                   : ACC(0)                                                                                    \
                   : "l"(desc_a), "l"(desc_b), "r"(1));                                                        \
    }                                                                                                          \
    template <int M>                                                                                           \
    __device__ static __forceinline__ void rs(float (&d)[M], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, \
                                              uint64_t desc_b) {                                               \
      static_assert(M >= N / 2, "accumulator too small");                                                      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P ", 0;\n"                                           \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" LIST "}, " RS_AB ", p, 1, 1;\n}\n" \
                   : ACC(0)                                                                                    \
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));                                 \
    }                                                                                                          \
  };

LEMON_TF32_MMA(8, LIST4, ACC4, "%4, %5", "%6", "{%4, %5, %6, %7}, %8", "%9")
LEMON_TF32_MMA(16, LIST8, ACC8, "%8, %9", "%10", "{%8, %9, %10, %11}, %12", "%13")
LEMON_TF32_MMA(24, LIST12, ACC12, "%12, %13", "%14", "{%12, %13, %14, %15}, %16", "%17")
LEMON_TF32_MMA(32, LIST16, ACC16, "%16, %17", "%18", "{%16, %17, %18, %19}, %20", "%21")
LEMON_TF32_MMA(48, LIST24, ACC24, "%24, %25", "%26", "{%24, %25, %26, %27}, %28", "%29")
LEMON_TF32_MMA(64, LIST32, ACC32, "%32, %33", "%34", "{%32, %33, %34, %35}, %36", "%37")
LEMON_TF32_MMA(128, LIST64, ACC64, "%64, %65", "%66", "{%64, %65, %66, %67}, %68", "%69")
#undef LEMON_TF32_MMA

// The fp32 kernel's shared memory, from a 1024-byte aligned base.
// Self-fed (one warpgroup, 64-row items):
//   q: the staged tile (raw; at D = 128 then its hi piece | q lo)
//   ring: 2 x (k: raw, then hi | raw v), refilled by TMA
//   k lo: 2 x (a tile's lo piece), by tile parity
//   v^T: 2 x (hi | lo), by tile parity; o is staged in the item's last one
//   mbarriers: q_full, full[2]
// Split (two consumer warpgroups, 128-row items, and a splitter warpgroup):
//   q: 2 buffers (by item parity) x 2 staged 64-row tiles (raw, then the
//      lo piece in place, then the o tile for the TMA store)
//   ring: 4 x (k: raw, then hi | k lo | raw v | v^T hi | v^T lo)
//   mbarriers: q_full[2], full[4], ready[4] (split), empty[4] (read),
//      q_empty[2] (read and stored)
// A staged tile of q, k or v is [D / 32 atoms][rows][128 B], v^T
// [keys / 32 atoms][D rows][128 B], both 128-byte swizzled.
template <int D, bool SPLIT>
struct Tf32Tiles {
  static constexpr int BKV = D == 32 ? 64 : 32;  // keys per tile
  static constexpr bool Q_REGS = D <= 64;        // q's pieces in registers (else split in place)
  static constexpr int CONSUMERS = SPLIT ? 2 : 1;  // warpgroups of 64 query rows
  static constexpr int STAGES = SPLIT ? 4 : 2;
  static constexpr int QBUFS = SPLIT ? 2 : 1;  // q buffers, by item parity
  static constexpr int THREADS = 128 * (CONSUMERS + SPLIT);  // the consumers[, the splitter]
  static constexpr int Q_BYTES = BQ * D * 4;                  // a 64-row tile of q or o
  static constexpr int KV_BYTES = BKV * D * 4;                // a key tile of k, k lo, v, v^T hi or v^T lo
  static constexpr int RING_OFF = QBUFS * CONSUMERS * Q_BYTES * (Q_REGS ? 1 : 2);
  static constexpr int STAGE_BYTES = (SPLIT ? 5 : 2) * KV_BYTES;
  static constexpr int V_OFF = (SPLIT ? 2 : 1) * KV_BYTES;  // raw v in a stage
  static constexpr int KLO_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int VT_OFF = KLO_OFF + (SPLIT ? 0 : 2 * KV_BYTES);
  static constexpr int BAR_OFF = VT_OFF + (SPLIT ? 0 : 2 * 2 * KV_BYTES);
  static constexpr int SMEM = BAR_OFF + 8 * (2 * QBUFS + (SPLIT ? 3 : 1) * STAGES) + 1024;  // + slack to align to 1024 B
  static constexpr int MIN_BLOCKS = Q_REGS && !SPLIT ? 2 : 1;
  static_assert(Q_BYTES <= 2 * KV_BYTES, "the o tile is staged in a v^T buffer");
  static_assert(Q_REGS || !SPLIT, "the split kernel keeps q in registers");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024 && SMEM <= 227 * 1024, "the blocks fit an SM");
};

// The Veltkamp split of a staged tile of BYTES in place, by the 128 threads
// of one warpgroup (`sid`): x * mul -> hi at the same address, lo at the same
// offset from `lo`.
template <int BYTES>
__device__ __forceinline__ void split_in_place(unsigned char* x, unsigned char* lo, float mul, int sid) {
  static_assert(BYTES % (128 * 16) == 0, "a whole number of float4 a thread");
#pragma unroll
  for (int n = 0; n < BYTES / (128 * 16); ++n) {
    const int off = (sid + 128 * n) * 16;
    float4 v = *reinterpret_cast<const float4*>(x + off);
    if (mul != 1.f) v = make_float4(__fmul_rn(v.x, mul), __fmul_rn(v.y, mul), __fmul_rn(v.z, mul), __fmul_rn(v.w, mul));
    uint4 h, l;
    split4(v, h, l);
    *reinterpret_cast<uint4*>(x + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A staged v tile (BKV key rows of D) transposed into v^T (D rows of BKV
// keys, each 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7) and split, by
// the 128 threads of one warpgroup. A unit is one 16-byte chunk of v^T for
// four columns: the keys of one parity of an 8-key group (four 16-byte reads
// of raw rows), written as four chunks of hi and four of lo. Neighbouring
// lanes take the parities and groups, so that their writes fall in distinct
// bank groups (the reads meet 4-way conflicts).
template <int D, int BKV>
__device__ __forceinline__ void transpose_split_v(const unsigned char* v, unsigned char* vt_hi, unsigned char* vt_lo,
                                                  int sid) {
  constexpr int GROUPS = BKV / 8;
  constexpr int UNITS = 2 * GROUPS * (D / 4);
  static_assert(UNITS % 128 == 0, "a whole number of units a thread");
#pragma unroll
  for (int n = 0; n < UNITS / 128; ++n) {
    const int u = sid + 128 * n;
    const int p = u & 1, grp = (u >> 1) % GROUPS, c = (u >> 1) / GROUPS;  // parity, 8-key group, 4-column chunk
    float x[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * grp + p + 2 * e;  // key
      const float4 r =
          *reinterpret_cast<const float4*>(v + (c >> 3) * BKV * 128 + j * 128 + (((c & 7) ^ (j & 7)) << 4));
      x[e][0] = r.x;
      x[e][1] = r.y;
      x[e][2] = r.z;
      x[e][3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * c + i;
      const int off = (grp >> 2) * D * 128 + d * 128 + (((2 * (grp & 3) + p) ^ (d & 7)) << 4);
      uint4 h, l;
      split4(make_float4(x[0][i], x[1][i], x[2][i], x[3][i]), h, l);
      *reinterpret_cast<uint4*>(vt_hi + off) = h;
      *reinterpret_cast<uint4*>(vt_lo + off) = l;
    }
  }
}

template <int D, int TAIL, bool SPLIT>
__global__ void __launch_bounds__(Tf32Tiles<D, SPLIT>::THREADS, Tf32Tiles<D, SPLIT>::MIN_BLOCKS)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_o,
                            int B, int L, int H, float scale, int causal) {
  using T = Tf32Tiles<D, SPLIT>;
  constexpr int BKV = T::BKV;
  constexpr int STAGES = T::STAGES;
  constexpr int KV = T::KV_BYTES;
  constexpr int NS = BKV / 2;  // S accumulators a thread
  constexpr int NO = D / 2;    // O accumulators a thread
  constexpr int NQ = T::Q_REGS ? D / 2 : 1;  // q's TF32 pieces a thread: 4 for each k-step
  // the parts that run (all of them as built; benchmarks/k3_limits.py stops early)
  constexpr bool SPLITS = LEMON_K3_STOP != 1 && LEMON_K3_STOP != 4;
  constexpr bool S_ON = LEMON_K3_STOP == 0 || LEMON_K3_STOP >= 3;
  constexpr bool PV_ON = LEMON_K3_STOP == 0 || LEMON_K3_STOP == 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = smem_u32(base);

  const int tid = threadIdx.x;
  // The consumer warpgroup (-1: the splitter, after the consumers) and the
  // thread in it
  const int cw = tid < 128 * T::CONSUMERS ? tid >> 7 : -1;
  const int ctid = tid & 127;
  const bool lead = SPLIT ? tid == 128 * T::CONSUMERS : tid == 0;  // issues every TMA load
  const int warp = ctid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* q_tile = base + cw * T::Q_BYTES;  // the consumer's: raw, then (D = 128) its hi piece
  unsigned char* const q_lo = base + T::Q_BYTES;
  // Key tile c (counted over the block's items) lies in stage c % STAGES
  // (raw k, then its hi piece; raw v), its lo piece and v^T in the buffers
  // of its parity (split: in the stage)
  auto k_at = [&](int c) { return base + T::RING_OFF + (c % STAGES) * T::STAGE_BYTES; };
  auto klo_at = [&](int c) { return SPLIT ? k_at(c) + KV : base + T::KLO_OFF + (c & 1) * KV; };
  auto vt_at = [&](int c) {  // v^T hi, then v^T lo
    return SPLIT ? k_at(c) + 3 * KV : base + T::VT_OFF + (c & 1) * 2 * KV;
  };
  constexpr int QBUFS = T::QBUFS;
  const uint32_t bars = sb + T::BAR_OFF;
  auto q_full = [&](int b) { return bars + 8 * b; };                           // q buffer b landed
  auto full = [&](int st) { return bars + 8 * (QBUFS + st); };                 // the stage's TMA loads landed
  auto ready = [&](int st) { return bars + 8 * (QBUFS + STAGES + st); };       // split: the stage is split
  auto empty = [&](int st) { return bars + 8 * (QBUFS + 2 * STAGES + st); };   // split: both consumers read it
  auto q_empty = [&](int b) { return bars + 8 * (QBUFS + 3 * STAGES + b); };  // split: both consumers read q
  constexpr int ROWS = T::CONSUMERS * BQ;  // query rows an item

  const int n_qt = (L + ROWS - 1) / ROWS;
  const int n_items = B * H * n_qt;

  // Item `it`: the ROWS query rows from q0 of (b, h); the query tiles of a
  // head are neighbours in the order, so the blocks in flight share its k
  // and v in L2. Its key tiles: all of L, or under the causal mask those up
  // to its last row; causal heads go from their last (longest) query tile
  // down, so that the grid ends on short items.
  struct Item {
    int b, h, q0, n_kv;
  };
  auto item_at = [&](int it) {
    const int bh = it / n_qt;
    const int qt = it - bh * n_qt;
    const int b = bh / H, h = bh - b * H, q0 = (causal ? n_qt - 1 - qt : qt) * ROWS;
    return Item{b, h, q0, ((causal ? min(L, q0 + ROWS) : L) + BKV - 1) / BKV};
  };

  // The lead thread's loads run ahead of the products by the ring's depth,
  // across items: `ld` is the next key tile to load (item, tile).
  int ld_it = blockIdx.x, ld_j = 0, ld_count = 0;
  Item ld_item = item_at(ld_it);
  auto load_q = [&](const Item& it, int b) {  // into q buffer b
    mbar_arrive_expect_tx(q_full(b), T::CONSUMERS * T::Q_BYTES);
#pragma unroll
    for (int w = 0; w < T::CONSUMERS; ++w)
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
        tma_load_4d(sb + (b * T::CONSUMERS + w) * T::Q_BYTES + a * BQ * 128, &map_q, q_full(b), 32 * a, it.h,
                    it.q0 + w * BQ, it.b);
  };
  auto load_next_tile = [&]() {
    if (ld_it >= n_items) return;
    const int st = ld_count % STAGES;
    const uint32_t k_dst = smem_u32(k_at(st));
    mbar_arrive_expect_tx(full(st), 2 * KV);
#pragma unroll
    for (int a = 0; a < D / 32; ++a) {
      tma_load_4d(k_dst + a * BKV * 128, &map_k, full(st), 32 * a, ld_item.h, ld_j * BKV, ld_item.b);
      tma_load_4d(k_dst + T::V_OFF + a * BKV * 128, &map_v, full(st), 32 * a, ld_item.h, ld_j * BKV, ld_item.b);
    }
    ++ld_count;
    if (++ld_j == ld_item.n_kv) {
      ld_j = 0;
      ld_it += gridDim.x;
      if (ld_it < n_items) ld_item = item_at(ld_it);
    }
  };
  auto split_k = [&](int c) { split_in_place<KV>(k_at(c), klo_at(c), 1.f, ctid); };
  auto split_v = [&](int c) { transpose_split_v<D, BKV>(k_at(c) + T::V_OFF, vt_at(c), vt_at(c) + KV, ctid); };

  if (lead) {
    for (int b = 0; b < QBUFS; ++b) mbar_init(q_full(b), 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    if (SPLIT) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(ready(s), 128);
        mbar_init(empty(s), 2 * 128);
      }
      for (int b = 0; b < QBUFS; ++b) mbar_init(q_empty(b), 2 * 128);
    }
    fence_mbar_init();
    load_q(ld_item, 0);  // the grid has no more blocks than items
    if (SPLIT && blockIdx.x + gridDim.x < n_items) load_q(item_at(blockIdx.x + gridDim.x), 1);
    for (int s = 0; s < STAGES; ++s) load_next_tile();
  }
  __syncthreads();

  if constexpr (SPLIT) {
    if (cw < 0) {
      // The splitter: every tile of the block's items, in order, split as
      // soon as it has landed; its lead thread refills the stage of the
      // tile two before once both consumers have read it, and, once an
      // item's last tile is split, loads the next item's q into the buffer
      // of the item before it as soon as both consumers are done with that.
      int c = 0, n = 0;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
        const bool q_next = n > 0 && it + static_cast<int>(gridDim.x) < n_items;
        const int n_kv = item_at(it).n_kv;
        for (int j = 0; j < n_kv; ++j, ++c) {
          mbar_wait(full(c % STAGES), (c / STAGES) & 1);
          if constexpr (SPLITS) {
            split_k(c);
            split_v(c);
          }
          fence_proxy_async();
          mbar_arrive(ready(c % STAGES));
          if (lead && c >= 2) {
            mbar_wait(empty((c - 2) % STAGES), ((c - 2) / STAGES) & 1);
            load_next_tile();
          }
          if (lead && j == n_kv - 1 && q_next) {
            mbar_wait(q_empty((n - 1) & 1), ((n - 1) >> 1) & 1);
            load_q(item_at(it + gridDim.x), (n + 1) & 1);
          }
        }
      }
      return;
    }
  }

  uint32_t qh[NQ], ql[T::Q_REGS && !SPLIT ? NQ : 1];
  float o[NO];
  float s[NS];
  uint32_t p_hi[NS], p_lo[NS];
  float m[2], l[2];

  // q of the item scaled and split: into this thread's A
  // fragments (a k-step ks holds rows r, r + 8 at columns 8 ks + t,
  // 8 ks + t + 4 in qh[4 ks ..]) or in place in shared memory
  auto split_q = [&]() {
    if constexpr (T::Q_REGS) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = warp * 16 + g + 8 * rr;
            float* const x = reinterpret_cast<float*>(q_tile + (ks >> 2) * BQ * 128 + row * 128 +
                                                      (((2 * (ks & 3) + hf) ^ g) << 4) + 4 * t);
            uint32_t lo;
            split(__fmul_rn(*x, scale), qh[4 * ks + 2 * hf + rr], lo);
            if constexpr (SPLIT)
              *reinterpret_cast<uint32_t*>(x) = lo;
            else
              ql[4 * ks + 2 * hf + rr] = lo;
          }
    } else {
      split_in_place<T::Q_BYTES>(q_tile, q_lo, scale, ctid);
    }
  };

  // A tile's products and softmax take its width W (keys: BKV, or TAIL for
  // the last tile of an unmasked item) as a compile-time constant.
  using Full = std::integral_constant<int, BKV>;
  using Tail = std::integral_constant<int, TAIL>;
  // S = (q * scale) . k^T of key tile c: hi.hi, hi.lo, lo.hi
  auto issue_s = [&](int c, auto w) {
    constexpr int W = decltype(w)::value;
    const uint64_t dk_hi = smem_desc(smem_u32(k_at(c))), dk_lo = smem_desc(smem_u32(klo_at(c)));
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t ko = ((ks >> 2) * BKV * 128 + (ks & 3) * 32) >> 4;
      if constexpr (SPLIT) {  // q's lo piece in shared memory
        const int i = 4 * ks;
        const uint32_t qo = ((ks >> 2) * BQ * 128 + (ks & 3) * 32) >> 4;
        Tf32Mma<W>::rs(s, qh[i], qh[i + 1], qh[i + 2], qh[i + 3], dk_hi + ko);
        Tf32Mma<W>::rs(s, qh[i], qh[i + 1], qh[i + 2], qh[i + 3], dk_lo + ko);
        Tf32Mma<W>::ss(s, smem_desc(smem_u32(q_tile)) + qo, dk_hi + ko);
      } else if constexpr (T::Q_REGS) {
        const int i = 4 * ks;
        Tf32Mma<W>::rs(s, qh[i], qh[i + 1], qh[i + 2], qh[i + 3], dk_hi + ko);
        Tf32Mma<W>::rs(s, qh[i], qh[i + 1], qh[i + 2], qh[i + 3], dk_lo + ko);
        Tf32Mma<W>::rs(s, ql[i], ql[i + 1], ql[i + 2], ql[i + 3], dk_hi + ko);
      } else {
        const uint64_t dq_hi = smem_desc(smem_u32(q_tile)), dq_lo = smem_desc(smem_u32(q_lo));
        const uint32_t qo = ((ks >> 2) * BQ * 128 + (ks & 3) * 32) >> 4;
        Tf32Mma<W>::ss(s, dq_hi + qo, dk_hi + ko);
        Tf32Mma<W>::ss(s, dq_hi + qo, dk_lo + ko);
        Tf32Mma<W>::ss(s, dq_lo + qo, dk_hi + ko);
      }
    }
    wgmma_commit();
  };
  // O += P . v of the first W keys of key tile c (keys past L have weight 0
  // and v rows of 0): p_hi.v_hi, p_hi.v_lo, p_lo.v_hi
  auto issue_pv = [&](int c, auto w) {
    constexpr int W = decltype(w)::value;
    const uint64_t dv_hi = smem_desc(smem_u32(vt_at(c))), dv_lo = smem_desc(smem_u32(vt_at(c) + KV));
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < W / 8; ++ks) {
      const uint32_t vo = ((ks >> 2) * D * 128 + (ks & 3) * 32) >> 4;
      const int i = 4 * ks;
      Tf32Mma<D>::rs(o, p_hi[i], p_hi[i + 2], p_hi[i + 1], p_hi[i + 3], dv_hi + vo);
      Tf32Mma<D>::rs(o, p_hi[i], p_hi[i + 2], p_hi[i + 1], p_hi[i + 3], dv_lo + vo);
      Tf32Mma<D>::rs(o, p_lo[i], p_lo[i + 2], p_lo[i + 1], p_lo[i + 3], dv_hi + vo);
    }
    wgmma_commit();
  };
  // The wgmma operands in registers stay put until their products are done.
  auto products_done = [&]() {
    fence_operands(s);
    fence_operands(o);
    fence_operands(p_hi);
    fence_operands(p_lo);
    fence_operands(qh);
    fence_operands(ql);
  };
  // P split into TF32 pieces (registers i: row r0 + 8 ((i >> 1) & 1), key
  // 8 (i >> 2) + 2t + (i & 1))
  auto split_p = [&](auto w) {
    constexpr int W = decltype(w)::value;
#pragma unroll
    for (int i = 0; i < W / 2; ++i) split(s[i], p_hi[i], p_lo[i]);
  };
  auto rescale_o = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
  };
  // Epilogue: O normalised, written swizzled into the o tile (at `dst`,
  // [D / 32 atoms][64 rows][128 B]), stored by TMA from row q0 (rows past L
  // clipped) by the consumer's first thread. `sync` is a barrier over the
  // consumer warpgroup.
  auto store_o = [&](const Item& cur, int q0, unsigned char* dst, auto sync) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      inv[r] = 1.f / (sum + __shfl_xor_sync(0xffffffffu, sum, 2));
    }
    if (ctid == 0) bulk_wait_read<0>();  // the last o tile stored from here has been read
    sync();  // and every warp's last P . v has read the buffer
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        *reinterpret_cast<float2*>(dst + (i >> 2) * BQ * 128 + row * 128 + (((2 * (i & 3) + (t >> 1)) ^ (row & 7)) << 4) +
                                   8 * (t & 1)) = make_float2(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    fence_proxy_async();
    sync();
    if (ctid == 0) {
#pragma unroll
      for (int a = 0; a < D / 32; ++a) tma_store_4d(&map_o, smem_u32(dst) + a * BQ * 128, 32 * a, cur.h, q0, cur.b);
      bulk_commit();
    }
  };

  // Mask, online softmax of S (keys k0 .. k0 + W) for the rows from q0
  // (this thread's: r0, r0 + 8): s becomes the unnormalised P; the row max
  // is a quad max. Returns O's rescaling.
  auto softmax = [&](int k0, int q0, int r0, float (&alpha)[2], auto w) {
    constexpr int W = decltype(w)::value;
    if (k0 + W > L || (causal && k0 + W - 1 > q0)) {
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
      alpha[r] = ex2((m[r] - mb) * LOG2E);
      nb[r] = -mb * LOG2E;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], LOG2E, nb[r]));
      l[r] += s[i];
    }
  };
  auto start_item = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  };

  int n = 0;     // items of this block so far
  int cons = 0;  // key tiles of this block so far
  if constexpr (!SPLIT) {
    // Self-fed: the warpgroup splits its own tiles. Key tile j (the block's
    // tile cons): S_j and then (PV) P_{j-1} . v^T_{j-1} are issued; while they
    // run, v_j is transposed and split and the next tile's k split (the next
    // item's first tile at an item's last); S_j's softmax runs while P . v is
    // in flight. Then one barrier, after which the lead thread refills the
    // stage of tile j with the tile STAGES ahead, and loads the next item's q
    // once this one's is read.
    mbar_wait(full(0), 0);
    if (SPLITS) split_k(0);  // every later tile's k is split during the tile before
    fence_async_barrier();
    for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
      const Item cur = item_at(it);
      const int next_it = it + static_cast<int>(gridDim.x);
      const bool has_next = next_it < n_items;
      const int q0 = cur.q0, r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
      start_item();
      mbar_wait(q_full(0), n & 1);
      if (SPLITS) split_q();
      if (!T::Q_REGS) fence_async_barrier();  // q is split in shared memory

      auto step = [&](int j, auto w, auto pv) {
        constexpr bool PV = decltype(pv)::value && PV_ON;
        float alpha[2];
        if constexpr (S_ON) issue_s(cons, w);
        if constexpr (PV) issue_pv(cons - 1, Full{});
        if (SPLITS) split_v(cons);
        if (j + 1 < cur.n_kv || has_next) {
          const int c1 = cons + 1;
          mbar_wait(full(c1 % STAGES), (c1 / STAGES) & 1);
          if (SPLITS) split_k(c1);
        }
        if constexpr (S_ON) {
          if constexpr (PV) wgmma_wait<1>(); else wgmma_wait<0>();
          fence_operands(s);
          softmax(j * BKV, q0, r0, alpha, w);
        }
        if constexpr (PV) {
          wgmma_wait<0>();
          products_done();
          rescale_o(alpha);
        }
        if constexpr (S_ON) split_p(w);
        if (lead) bulk_wait_read<0>();  // the o tile staged in a v^T buffer has been read
        fence_async_barrier();  // v^T_j and the next k are visible; the stage of tile j is read
        if (lead) {
          load_next_tile();
          if (has_next && j == (T::Q_REGS ? 0 : cur.n_kv - 1)) load_q(item_at(next_it), 0);
        }
        ++cons;
      };
      // Tile 0 is full width: TAIL < BKV only where an item has several tiles.
      step(0, Full{}, std::false_type{});
      for (int j = 1; j < cur.n_kv - 1; ++j) step(j, Full{}, std::true_type{});
      if (cur.n_kv > 1) step(cur.n_kv - 1, Tail{}, std::true_type{});
      if constexpr (PV_ON) {
        issue_pv(cons - 1, Tail{});
        wgmma_wait<0>();
        products_done();
      }
      store_o(cur, q0, vt_at(cons - 1), [] { __syncthreads(); });
    }
  } else {
    // A consumer warpgroup of the split kernel: the item's rows from
    // q0 + 64 cw. Key tile j: S_j and then P_{j-1} . v^T_{j-1} are issued
    // once the splitter has split tile j; S_j's softmax runs while P . v is
    // in flight, after which the stage of tile j - 1 is released. Tiles past
    // the warpgroup's last (the first one's, under the causal mask) are
    // released as they come.
    auto sync = [&] { named_sync(1 + cw, 128); };
    for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++n) {
      const Item cur = item_at(it);
      const int q0 = cur.q0 + cw * BQ, r0 = q0 + warp * 16 + g;
      const int n_kv = q0 >= L ? 0 : ((causal ? min(L, q0 + BQ) : L) + BKV - 1) / BKV;
      start_item();
      if (n > 0) {  // the last item's q buffer, with its o tile stored from it, is free
        if (ctid == 0) bulk_wait_read<0>();
        mbar_arrive(q_empty((n - 1) & 1));
      }
      q_tile = base + ((n & 1) * T::CONSUMERS + cw) * T::Q_BYTES;
      mbar_wait(q_full(n & 1), (n >> 1) & 1);
      if (SPLITS && n_kv > 0) split_q();  // q's lo piece in place, for S's lo.hi
      fence_proxy_async();
      sync();
      auto release = [&](int c) { mbar_arrive(empty(c % STAGES)); };
      auto step = [&](int j, auto w, auto pv) {
        constexpr bool PV = decltype(pv)::value && PV_ON;
        float alpha[2];
        mbar_wait(ready(cons % STAGES), (cons / STAGES) & 1);
        if constexpr (S_ON) issue_s(cons, w);
        if constexpr (PV) issue_pv(cons - 1, Full{});
        if constexpr (S_ON) {
          if constexpr (PV) wgmma_wait<1>(); else wgmma_wait<0>();
          fence_operands(s);
          softmax(j * BKV, q0, r0, alpha, w);
        }
        if constexpr (PV) {
          wgmma_wait<0>();
          products_done();
          rescale_o(alpha);
        }
        if (j > 0) release(cons - 1);
        if constexpr (S_ON) split_p(w);
        ++cons;
      };
      if (n_kv > 0) {
        step(0, Full{}, std::false_type{});
        for (int j = 1; j < n_kv - 1; ++j) step(j, Full{}, std::true_type{});
        if (n_kv > 1) step(n_kv - 1, Tail{}, std::true_type{});
        if constexpr (PV_ON) {
          issue_pv(cons - 1, Tail{});
          wgmma_wait<0>();
          products_done();
        }
        release(cons - 1);
        store_o(cur, q0, q_tile, sync);  // q's lo piece is read
      }
      for (int j = n_kv; j < cur.n_kv; ++j, ++cons) {  // the other consumer's tiles
        mbar_wait(ready(cons % STAGES), (cons / STAGES) & 1);
        release(cons);
      }
    }
  }
  if (cw >= 0 && ctid == 0) bulk_wait_all();
}

template <int D, int TAIL, bool SPLIT>
int launch_tf32(const float* q, const float* k, const float* v, float* o, int B, int L, int H, long long stride_b,
                long long stride_l, float scale, int causal, cudaStream_t stream) {
  using T = Tf32Tiles<D, SPLIT>;
  // (D, H, L, B) views: the inputs with the wrapper's strides, o contiguous;
  // boxes of 32 columns (one swizzle atom) by 64 query rows or a key tile
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t in_strides[3] = {4ull * D, 4ull * stride_l, 4ull * stride_b};
  const cuuint64_t out_strides[3] = {4ull * D, 4ull * H * D, 4ull * L * H * D};
  const cuuint32_t box_q[4] = {32, 1, BQ, 1};
  const cuuint32_t box_kv[4] = {32, 1, T::BKV, 1};
  CUtensorMap map_q, map_k, map_v, map_o;
  int e = encode_tensor_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, dims, in_strides, box_q);
  if (e == 0) e = encode_tensor_map(&map_k, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, dims, in_strides, box_kv);
  if (e == 0) e = encode_tensor_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, v, dims, in_strides, box_kv);
  if (e == 0) e = encode_tensor_map(&map_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, o, dims, out_strides, box_q);
  int sms = 0;
  static int cached[64] = {};
  if (e == 0)
    e = prepare_launch(reinterpret_cast<const void*>(flash_attention_tf32_kernel<D, TAIL, SPLIT>), T::SMEM, cached,
                       &sms);
  if (e != 0) return e;
  const int n_qt = (L + T::CONSUMERS * BQ - 1) / (T::CONSUMERS * BQ);
  const int n_items = B * H * n_qt;  // the wrapper keeps B * H * ceil(L / 64) below 2^31
  // A block takes every n_blocks-th item; n_blocks coprime to the query
  // tiles of a head spreads causal items of all lengths evenly.
  int n_blocks = min(n_items, T::MIN_BLOCKS * sms);
  while (n_blocks > 1 && std::gcd(n_blocks, n_qt) != 1) --n_blocks;
  flash_attention_tf32_kernel<D, TAIL, SPLIT><<<n_blocks, T::THREADS, T::SMEM, stream>>>(map_q, map_k, map_v, map_o,
                                                                                       B, L, H, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 kernel at head dim D: the width of an unmasked item's last key
// tile is the keys past the last full tile, rounded up to a quarter tile (a
// k-step of 8 keys for 32-key tiles, 16 for 64; L = 197 at D = 64: 8).
template <int D, bool SPLIT>
int launch_tail(const float* q, const float* k, const float* v, float* o, int B, int L, int H, long long stride_b,
                long long stride_l, float scale, int causal, cudaStream_t stream) {
  constexpr int BKV = Tf32Tiles<D, SPLIT>::BKV, Q4 = BKV / 4;
  const int tail = causal || L <= BKV || L % BKV == 0 ? BKV : (L % BKV + Q4 - 1) / Q4 * Q4;
  switch (tail / Q4) {
    case 1: return launch_tf32<D, Q4, SPLIT>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, stream);
    case 2: return launch_tf32<D, 2 * Q4, SPLIT>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, stream);
    case 3: return launch_tf32<D, 3 * Q4, SPLIT>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, stream);
    default: return launch_tf32<D, BKV, SPLIT>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, stream);
  }
}

// The split kernel for unmasked heads of more than one 64-row query tile at
// D = 64, else the self-fed one (LEMON_K3_SPLITTER=0: the self-fed one
// everywhere). Under the causal mask the split kernel's first consumer
// idles through the last two key tiles of each item, and at D = 32 (64-key
// tiles) it measured slower than the self-fed kernel.
template <int D>
int dispatch_tf32(const float* q, const float* k, const float* v, float* o, int B, int L, int H, long long stride_b,
                  long long stride_l, float scale, int causal, cudaStream_t stream) {
  if constexpr (D == 64 && LEMON_K3_SPLITTER) {
    if (!causal && L > BQ) return launch_tail<D, true>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, stream);
  }
  return launch_tail<D, false>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, stream);
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
// 16-byte aligned pointers and strides that are multiples of 4 (as TMA needs
// them); D is 32, 64 or 128; 0 < L, B * H * ceil(L / 64) < 2^31 and
// (L + 64) * stride_l < 2^31. o is (B, L, H, D) contiguous. Returns the first
// CUDA error of the tensor maps' encoding or of the launch
// (cudaErrorInvalidValue for an unsupported D).
extern "C" int lemon_flash_attention(const float* q, const float* k, const float* v, float* o, int B, int L, int H,
                                     int D, long long stride_b, long long stride_l, float scale, int causal,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch_tf32<32>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    case 64: return dispatch_tf32<64>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
    case 128: return dispatch_tf32<128>(q, k, v, o, B, L, H, stride_b, stride_l, scale, causal, st);
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
