// Exact top-k of one row, shared by K2 and P1 (topk.cu) and K4 (select.cu):
// a warp select for narrow rows held in registers (warp_select), and a
// block select for the rest (block_select).
//
// The order. Every entry becomes one 64-bit number, packed(v, c) =
// (order_key(v) << 32) | ~c: order_key maps a float to a uint32 whose order
// is the float order (flip the sign bit of a positive value, all bits of a
// negative one), after -0.0 is canonicalised to +0.0 so that the two zeros
// tie as they compare. Larger packed = earlier in "value descending, column
// ascending", so ties go to the lower column and -inf entries come out by
// ascending column with no sentinel; packed values are distinct, so the top
// k under this order is unique.
//
// The block select finds the packed value T of the rank-th entry by a
// radix select, one wide digit over the row and 8-bit digits over the short
// list of its threshold bin, and takes every entry >= T. Two passes over the
// row, which the caller has staged in shared memory (or, for rows too wide
// for it, leaves in global memory):
//
// 1. a histogram of the first digit, the key's top 11 bits (sign, exponent,
//    2 mantissa bits; 2048 bins), one shared atomic an entry; a staged row
//    gets its keys written back over its values. A block-wide scan finds
//    the bin that holds the rank-th entry;
// 2. a filter: entries above that bin are winners and go straight to
//    `cand`; the packed entries of the bin go to a list of at most LIST_CAP.
//
// While the threshold bin holds more than 64 entries, rounds of the next
// 8-bit digit over the list narrow it (column digits that no column below W
// can change skipped); the list's entries above the bin join the winners.
// The bin's own entries are then ordered by one warp in registers: the
// `rank` largest join the winners and the rank-th is T. A bin larger than
// LIST_CAP first takes such rounds over the whole row until it fits; a bin
// whose entries are all taken needs no ordering. The winners are then
// ordered: up to 64 by one warp with shuffles (a bitonic network in
// registers), above that by a bitonic sort in shared memory; k above
// SORT_CAP runs in chunks, each chunk's winners bounded above by the
// previous chunk's T. Barriers in a row whose bin and winners both hold at
// most 64: 3 for the first digit's scan, 1 after the filter and 1 at the
// end; 2 for each round over the list, and 1 after it; 2 more for each round
// over the row; the bitonic sort of n > 64 winners 1 + L + L(L+1)/2 with
// L = log2(n / 64). None grows with W. After the filter the row is not read
// again: the caller may stage the next row while the winners are ordered.
//
// The warp select (narrow rows, W <= 1024): one warp holds a row's keys in
// registers, CAP a lane, and orders nothing it need not. Each lane's
// maximum is one entry of the row, so the k-th largest of the 32 lane
// maxima (k <= 32; rounds of redux.sync max that retire the lanes holding
// the max) is a key T with at least k entries at or above it: no entry
// below T can win. The entries at or above T (usually a few more than k)
// go to a short list in shared memory, each lane's from a slot that
// ballots of the lanes' counts give it, and each is ranked by counting the
// list's entries that precede it in the packed order: the ranks below k
// are the output positions, written by the lanes that hold them. A list
// longer than its capacity (ties at T, or k > 32, where T starts at the key
// of -inf) makes T rise by counts over the registers (lo + 1 first, then
// bisection) until the entries at or above it fit, or until T is the k-th
// key itself; then the entries above T are ranked and the rest of the
// output is T's entries by ascending column, their ranks by ballots in the
// lanes' column order. 32-bit keys everywhere except the list.
//
// Compile-time switches for benchmarks/select_limits.py (never set by the
// port's own build): LEMON_SELECT_STOP = 1 makes the kernels stage (or, in
// the warp select, load) each row and select nothing, 2 stops each row after
// its first histogram and scan (the warp select: after the group's first
// max), 3 after the filter (the warp select: after the list is collected);
// LEMON_SELECT_COUNT counts the block select's passes over whole rows in a
// device counter that each kernel file exports.

#pragma once

#include <cuda_runtime.h>

#include "hopper.cuh"

#ifndef LEMON_SELECT_STOP
#define LEMON_SELECT_STOP 0
#endif

namespace lemon_select {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STOP = LEMON_SELECT_STOP;

#ifdef LEMON_SELECT_COUNT
static __device__ unsigned long long row_passes;
#endif

__device__ __forceinline__ void count_row_pass() {
#ifdef LEMON_SELECT_COUNT
  if (threadIdx.x == 0) atomicAdd(&row_passes, 1ull);
#endif
}

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v + 0.f);  // -0.0 -> +0.0 (round to nearest), one add
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);  // negative: ~b, else b | sign
}

// The float of a key; -0.0 comes back as +0.0 (ZERO_KEY), so a caller that
// must keep the sign of a zero reads it from the input.
constexpr unsigned ZERO_KEY = 0x80000000u;
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float(key ^ (static_cast<unsigned>(static_cast<int>(~key) >> 31) | 0x80000000u));
}

__device__ __forceinline__ unsigned long long packed(unsigned key, unsigned c) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(~c);
}

__device__ __forceinline__ int column_of(unsigned long long p) {
  return static_cast<int>(~static_cast<unsigned>(p));
}

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The digits of the packed value, from the top: d = 0..7 at shifts 53, 45,
// 37, 32, 24, 16, 8, 0 of 11, 8, 8, 5, 8, 8, 8, 8 bits. The first, the
// histogram of the whole row, is wide (2048 bins); the later ones, for the
// rounds over the list (or over the row while the threshold bin is larger
// than the list), are at most 8 bits (a 256-bin scan). Each digit ends
// where the one before it starts.
constexpr int FIRST_BITS = 11;
constexpr int DIGIT_BITS_MAX = 8;
__host__ __device__ constexpr int digit_shift(int d) {
  return d == 0 ? 53 : d == 1 ? 45 : d == 2 ? 37 : d == 3 ? 32 : 56 - 8 * d;
}
__host__ __device__ constexpr int digit_bits(int d) { return d == 0 ? FIRST_BITS : d == 3 ? 5 : 8; }
constexpr int HIST_BINS = 1 << FIRST_BITS;
constexpr unsigned LIST_CAP = 2048;
constexpr unsigned SMALL = 64;  // a bin of at most this many is ordered by one warp

struct SelectSmem {
  unsigned hist[HIST_BINS];            // zero between rounds: each scan clears what it read
  unsigned long long list[LIST_CAP];  // the packed entries of the threshold bin
  unsigned long long small[SMALL];    // the bin's entries once rounds over the list narrowed it
  unsigned long long warp_lo[16], warp_hi[16];  // each warp's least and greatest entry of the bin
  unsigned warp_sum[32];
  unsigned bin, before, count;  // the scan's answer
  unsigned n_cand, n_list, n_small;
  unsigned long long threshold;  // T, once the bin is ordered
};

// The threads an SM that the kernels' registers must allow (64 a thread):
// the block select waits on barriers and shared memory, and more rows in
// flight hide that; shared memory allows four CTAs of 256 at W = 6528.
constexpr int MIN_THREADS_PER_SM = 1024;

// Host: the persistent grid of a block-select kernel, the rows or the SMs
// times the CTAs an SM holds at `smem` bytes of dynamic shared memory,
// whichever is fewer. The shared memory limit and the SMs come from
// lemon_hopper::prepare_launch (once for each device); the occupancy is kept
// for the last `smem` asked on each device (`cache`, one for each kernel).
// Returns 0 or a cudaError_t.
struct GridCache {
  int sms[64] = {};
  size_t smem[64] = {};
  int per_sm[64] = {};
};

inline int persistent_grid(const void* kernel, int threads, size_t smem, size_t smem_max, long long rows,
                           GridCache& cache, int* grid) {
  int sms = 0, dev = 0;
  int e = lemon_hopper::prepare_launch(kernel, static_cast<int>(smem_max), cache.sms, &sms);
  if (e == 0) e = static_cast<int>(cudaGetDevice(&dev));
  if (e) return e;
  if (cache.per_sm[dev] == 0 || cache.smem[dev] != smem) {
    int per_sm = 0;
    const cudaError_t o = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (o != cudaSuccess) return static_cast<int>(o);
    if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    cache.per_sm[dev] = per_sm;
    cache.smem[dev] = smem;
  }
  *grid = static_cast<int>(rows < static_cast<long long>(cache.per_sm[dev]) * sms
                               ? rows
                               : static_cast<long long>(cache.per_sm[dev]) * sms);
  return 0;
}

// Before the first row: the histogram starts at zero.
template <int THREADS>
__device__ __forceinline__ void clear_hist(SelectSmem& sm) {
  for (int i = threadIdx.x; i < HIST_BINS; i += THREADS) sm.hist[i] = 0;
}

// The bin of hist[0, 2^BITS) that holds the rank-th entry counted from the
// top (0 < rank <= the histogram's total): sm.bin, sm.before (entries in the
// bins above it) and sm.count (entries in it). The bins are owned from the
// top in consecutive runs of PER, by every thread for the first digit's
// 4096 bins and by warp 0 alone (8 a lane) for a digit of at most 8 bits;
// each owner sums its run in an order rotated by its lane (fewer bank
// conflicts), the one whose run holds the rank-th entry reads it again in
// order, and each clears its own. Every thread calls it after adding to the
// histogram; its barriers (three for the first digit, two for the others)
// make the histogram complete, the warps' sums visible and the answer
// visible.
template <int THREADS, int BITS>
__device__ void find_bin(SelectSmem& sm, unsigned rank) {
  constexpr int BINS = 1 << BITS;
  constexpr bool ONE_WARP = BINS <= 256;
  constexpr int OWNERS = ONE_WARP ? 32 : THREADS;
  constexpr int NW = OWNERS / 32;
  constexpr int PER = BINS >= OWNERS ? BINS / OWNERS : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool owns = static_cast<int>(threadIdx.x) < OWNERS && (BINS >= OWNERS || static_cast<int>(threadIdx.x) < BINS);
  const int top = BINS - static_cast<int>(threadIdx.x) * PER;  // owns bins top-1 down to top-PER
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < OWNERS) {
    unsigned sum = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) sum += owns ? sm.hist[top - 1 - ((j + lane) & (PER - 1))] : 0u;
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    unsigned before = incl - sum;
    if (!ONE_WARP) {
      if (lane == 31) sm.warp_sum[warp] = incl;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < NW; ++w) before += w < warp ? sm.warp_sum[w] : 0u;
    }
    if (sum > 0 && before < rank && rank <= before + sum) {  // exactly one thread
      unsigned cnt[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) cnt[j] = sm.hist[top - 1 - j];
      bool found = false;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (!found && before + cnt[j] >= rank) {
          found = true;
          sm.bin = static_cast<unsigned>(top - 1 - j);
          sm.before = before;
          sm.count = cnt[j];
        }
        if (!found) before += cnt[j];
      }
    }
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (owns) sm.hist[top - 1 - ((j + lane) & (PER - 1))] = 0;
  }
  __syncthreads();
}

// The first pass: f(order_key(row[c])) for every column c of the row,
// spread over the block's threads, four columns a load when the row is
// 16-byte aligned and W % 4 == 0 (vec4). A staged row (KEYS) gets its keys
// written back in place of the values, for the passes after it.
template <int THREADS, bool KEYS, typename F>
__device__ __forceinline__ void first_pass(float* row, unsigned W, bool vec4, F f) {
  if (vec4) {
    float4* row4 = reinterpret_cast<float4*>(row);
    for (unsigned i = threadIdx.x; i < W / 4; i += THREADS) {
      const float4 v = row4[i];
      const uint4 key = make_uint4(order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
      if (KEYS) reinterpret_cast<uint4*>(row4)[i] = key;
      f(key.x);
      f(key.y);
      f(key.z);
      f(key.w);
    }
  } else {
    for (unsigned c = threadIdx.x; c < W; c += THREADS) {
      const unsigned key = order_key(row[c]);
      if (KEYS) reinterpret_cast<unsigned*>(row)[c] = key;
      f(key);
    }
  }
}

// A later pass: f(c, key of column c) for every column of the row, the
// keys read back (KEYS) or computed again from the values.
template <int THREADS, bool KEYS, typename F>
__device__ __forceinline__ void for_each_key(const float* row, unsigned W, bool vec4, F f) {
  if (vec4) {
    for (unsigned i = threadIdx.x; i < W / 4; i += THREADS) {
      uint4 key;
      if (KEYS) {
        key = reinterpret_cast<const uint4*>(row)[i];
      } else {
        const float4 v = reinterpret_cast<const float4*>(row)[i];
        key = make_uint4(order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
      }
      f(4 * i, key.x);
      f(4 * i + 1, key.y);
      f(4 * i + 2, key.z);
      f(4 * i + 3, key.w);
    }
  } else {
    for (unsigned c = threadIdx.x; c < W; c += THREADS)
      f(c, KEYS ? reinterpret_cast<const unsigned*>(row)[c] : order_key(row[c]));
  }
}

// The next digit that is not fixed by W: a digit of ~c above every column
// below W is all ones, set in `pre` without a round.
__device__ __forceinline__ int next_digit(int d, unsigned W, unsigned long long& pre, int& shift) {
  while (digit_shift(d) < 32 && ((W - 1) >> digit_shift(d)) == 0) {
    pre |= ((1ull << digit_bits(d)) - 1) << digit_shift(d);
    shift = digit_shift(d);
    ++d;
  }
  return d;
}

__device__ __forceinline__ void compare_swap(unsigned long long* a, int i, int size, int stride) {
  const int lo = 2 * i - (i & (stride - 1));
  const int hi = lo + stride;
  const unsigned long long x = a[lo], y = a[hi];
  if ((x < y) == ((lo & size) == 0)) {
    a[lo] = y;
    a[hi] = x;
  }
}

// Bitonic network that leaves a[0, n) in descending order; n is a power of
// two above 64. Strides below 64 pair entries inside one aligned 64-entry
// segment, which one warp runs with __syncwarp (pair i = 32 * segment +
// lane), so the block synchronises only for strides of 64 and more. Ends
// with a barrier.
template <int THREADS>
__device__ void sort_descending(unsigned long long* a, int n) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  auto in_segments = [&](int size_lo, int size_hi) {
    for (int seg = warp; seg * 64 < n; seg += NW) {
      const int i = seg * 32 + lane;
      for (int size = size_lo; size <= size_hi; size <<= 1) {
        for (int stride = min(size, 64) >> 1; stride > 0; stride >>= 1) {
          if (2 * i < n) compare_swap(a, i, size, stride);
          __syncwarp();
        }
      }
    }
    __syncthreads();
  };
  in_segments(2, 64);
  for (int size = 128; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += THREADS) compare_swap(a, i, size, stride);
      __syncthreads();
    }
    in_segments(size, size);
  }
}

// One warp orders a[0, n) (n <= 64) descending in registers: element
// lane + 32 j of the order ends in x[j]. A bitonic network over 64 slots
// (empty ones 0, below every real entry) with 64-bit shuffles.
__device__ __forceinline__ void warp_sort(const unsigned long long* a, int n, unsigned long long (&x)[2]) {
  const int lane = threadIdx.x & 31;
  x[0] = lane < n ? a[lane] : 0ull;
  x[1] = lane + 32 < n ? a[lane + 32] : 0ull;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64, descending: the lower slot keeps the larger
        const unsigned long long hi = x[0] > x[1] ? x[0] : x[1];
        x[1] = x[0] > x[1] ? x[1] : x[0];
        x[0] = hi;
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = lane + 32 * j;
          const unsigned long long o = __shfl_xor_sync(FULL, x[j], stride);
          const bool keep_max = ((e & stride) == 0) == ((e & size) == 0);
          x[j] = keep_max ? (o > x[j] ? o : x[j]) : (o < x[j] ? o : x[j]);
        }
      }
    }
  }
}

// The warp select (see the top of this file). Lane l of the warp holds the
// keys of columns lane_column(l, j), j < CAP (key 0 past the row: below
// every real key, as order_key(-inf) = KEY_FLOOR is the least of them).
constexpr unsigned KEY_FLOOR = 0x007fffffu;
constexpr unsigned WARP_LIST = 64;  // the least list a warp collects into

// The list's capacity for k: at least k (the entries above the k-th key
// are fewer than k).
__host__ __device__ __forceinline__ unsigned warp_list_cap(int k) {
  return static_cast<unsigned>(next_pow2(k > static_cast<int>(WARP_LIST) ? k : static_cast<int>(WARP_LIST)));
}

// The column of register j of lane l: the scalar layout takes columns
// l + 32 j (a warp's load of register j reads 32 consecutive floats), the
// 16-byte layout 4 (l + 32 (j / 4)) + j % 4 (one float4 a lane for each
// four registers). Either way a lane's columns rise with j, and those of
// one register index (scalar) or one float4 index (16-byte) rise with l.
template <bool VEC>
__device__ __forceinline__ unsigned lane_column(unsigned lane, int j) {
  return VEC ? 4u * (lane + 32 * (j / 4)) + (j & 3) : lane + 32 * j;
}

// The k best entries (0 < k <= W) of the row whose keys the warp holds.
// list (warp_list_cap(k) entries) is the warp's own shared memory.
// emit(ok, pos, column, key) is called by all lanes together (it may
// shuffle); a lane with ok writes output pos of the row, each pos in
// [0, k) exactly once.
template <int CAP, bool VEC, typename Emit>
__device__ __forceinline__ void warp_select(const unsigned (&key)[CAP], unsigned k, unsigned long long* list,
                                            Emit emit) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1;  // the lanes below this one
  const unsigned cap = warp_list_cap(static_cast<int>(k));
  if (STOP == 1) {  // select_limits.py: the loads alone
    unsigned acc = 0;
#pragma unroll
    for (int j = 0; j < CAP; ++j) acc ^= key[j];
    emit(acc == 0x9e3779b9u, 0, 0, acc);  // never, in practice: keeps the loads
    return;
  }
  unsigned lmax = 0;
#pragma unroll
  for (int j = 0; j < CAP; ++j) lmax = max(lmax, key[j]);
  if (STOP == 2) {  // select_limits.py: the loads and the warp's first max
    emit(lane == 0, 0, 0, __reduce_max_sync(FULL, lmax));
    return;
  }
  // T: the k-th largest lane maximum (k <= 32), else the key of -inf
  unsigned lo = KEY_FLOOR;
  if (k <= 32) {
    unsigned cur = lmax, need = k;
    for (;;) {
      const unsigned m = __reduce_max_sync(FULL, cur);
      const unsigned n = __popc(__ballot_sync(FULL, cur == m));
      if (n >= need) {
        lo = max(m, KEY_FLOOR);  // fewer than k lanes with an entry (the 16-byte layout): -inf
        break;
      }
      need -= n;
      if (cur == m) cur = 0;
    }
  }
  // the entries with key >= t into the list (the first cap of them) and
  // their count: each lane counts its own, ballots of the counts' bits give
  // each lane its first slot, and the lane writes its entries from there
  auto collect = [&](unsigned t) {
    constexpr int BITS = CAP < 2 ? 1 : CAP < 4 ? 2 : CAP < 8 ? 3 : CAP < 16 ? 4 : CAP < 32 ? 5 : 6;  // c <= CAP
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < CAP; ++j) c += key[j] >= t;
    unsigned slot = 0, total = 0;
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
      const unsigned v = __ballot_sync(FULL, (c >> b) & 1);
      slot += __popc(v & lower) << b;
      total += __popc(v) << b;
    }
    __syncwarp();  // the list of an earlier collect is read
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      if (key[j] >= t) {
        if (slot < cap) list[slot] = packed(key[j], lane_column<VEC>(lane, j));
        ++slot;
      }
    }
    __syncwarp();
    return total;
  };
  // each listed entry's rank: the listed entries that precede it
  auto rank = [&](unsigned n) {
    for (unsigned base = 0; base < n; base += 32) {
      const unsigned e = base + lane;
      const unsigned long long p = e < n ? list[e] : 0ull;
      unsigned r = 0;
#pragma unroll 4
      for (unsigned f = 0; f < n; ++f) r += list[f] > p;
      emit(e < n && r < k, r, static_cast<unsigned>(column_of(p)), static_cast<unsigned>(p >> 32));
    }
  };
  unsigned n = collect(lo);
  if (STOP == 3) {  // select_limits.py: the list collected
    emit(lane == 0, 0, 0, n);
    return;
  }
  if (n <= cap) {
    rank(n);
    return;
  }
  // Too many: T rises (count(>= lo) >= k and > cap, count(>= hi) < k)
  // until the entries at or above it fit, or lo is the k-th key. The
  // first step tries lo + 1 (lo is often the k-th key: ties, or fewer
  // finite entries than k), the next ones bisect.
  unsigned hi = __reduce_max_sync(FULL, lmax) + 1;
  for (unsigned mid = lo + 1; hi - lo > 1; mid = lo + (hi - lo) / 2) {
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < CAP; ++j) c += key[j] >= mid;
    c = __reduce_add_sync(FULL, c);
    if (c < k) {
      hi = mid;
    } else {
      lo = mid;
      n = c;
      if (c <= cap) break;
    }
  }
  if (n <= cap) {
    rank(collect(lo));
    return;
  }
  // lo is the k-th key and has more entries than the list holds: the
  // entries above it (fewer than k), then its own by ascending column
  const unsigned above = collect(lo + 1);
  rank(above);
  constexpr int Q = VEC ? 4 : 1;  // registers of one float4 index
  unsigned done = above;
#pragma unroll
  for (int u = 0; u < CAP / Q; ++u) {
    if (done >= k) break;  // uniform in the warp
    unsigned before = 0, total = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const unsigned b = __ballot_sync(FULL, key[u * Q + q] == lo);
      before += __popc(b & lower);
      total += __popc(b);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool eq = key[u * Q + q] == lo;
      emit(eq && done + before < k, done + before, lane_column<VEC>(lane, u * Q + q), lo);
      before += eq;
    }
    done += total;
  }
}

// The k best entries of the row (W floats at `row`, staged in shared
// memory, KEYS, or in global memory; 16-byte aligned with W % 4 == 0 when
// vec4; 0 < k <= W) in selection order: emit(j, column, key) for j in
// [0, k), spread over the block's threads. A staged row is overwritten by
// its keys. cand holds next_pow2(min(k, SORT_CAP)) values; sm.hist is zero.
// Every thread of the block calls it. release() runs on every thread once
// the row is read for the last time (after the last chunk's filter): the
// caller may then refill it. After its last barrier cand and the list are
// no longer read; warp 0 may still be emitting from its registers.
template <int THREADS, int SORT_CAP, bool KEYS, typename Release, typename Emit>
__device__ void block_select(float* row, unsigned W, bool vec4, int k, unsigned long long* cand, SelectSmem& sm,
                             Release release, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long upper = ~0ull;  // above every packed value of a real entry
  for (int done_out = 0; done_out < k; done_out += SORT_CAP) {
    const int n = min(SORT_CAP, k - done_out);
    const int n_pow = next_pow2(n);
    const bool last = done_out + SORT_CAP >= k;
    if (n_pow > 64)
      for (int i = n + threadIdx.x; i < n_pow; i += THREADS) cand[i] = 0;  // below every real entry
    if (threadIdx.x == 0) {
      sm.n_cand = 0;
      sm.n_list = 0;
      sm.n_small = 0;
    }
    // pass 1: the first digit over the whole row (the keys stored, the
    // first chunk)
    auto add = [&](unsigned key) { atomicAdd(&sm.hist[key >> (digit_shift(0) - 32)], 1u); };
    if (done_out == 0) first_pass<THREADS, KEYS>(row, W, vec4, add);
    else for_each_key<THREADS, KEYS>(row, W, vec4, [&](unsigned, unsigned key) { add(key); });
    count_row_pass();
    unsigned rank = done_out + n;
    find_bin<THREADS, FIRST_BITS>(sm, rank);
    int shift = digit_shift(0);
    unsigned long long pre = static_cast<unsigned long long>(sm.bin) << shift;
    rank -= sm.before;
    unsigned in_bin = sm.count;
    bool done = in_bin == rank;
    if (STOP == 2) {
      release();
      return;
    }
    // a bin larger than the list: more rounds over the whole row
    int d = 1;
    for (; !done && in_bin > LIST_CAP; ++d) {
      d = next_digit(d, W, pre, shift);
      const int s = digit_shift(d);
      const unsigned mask = (1u << digit_bits(d)) - 1;
      const unsigned long long pre_hi = pre >> shift;
      for_each_key<THREADS, KEYS>(row, W, vec4, [&](unsigned c, unsigned key) {
        const unsigned long long p = packed(key, c);
        if ((p >> shift) == pre_hi) atomicAdd(&sm.hist[(p >> s) & mask], 1u);
      });
      count_row_pass();
      find_bin<THREADS, DIGIT_BITS_MAX>(sm, rank);
      pre |= static_cast<unsigned long long>(sm.bin) << s;
      shift = s;
      rank -= sm.before;
      in_bin = sm.count;
      done = in_bin == rank;
    }
    // pass 2: the filter. Above the bin (or in it, once all of it is taken)
    // to the winners, in it to the list; both are rare, so a thread takes
    // its slot with an atomic of its own, and one compare with the bin's
    // lowest key passes over all the rest. The bin is a prefix of the key
    // alone unless a round over the row went into the column digits.
    {
      const bool by_key = shift >= 32;
      const unsigned ks = by_key ? shift - 32 : 0;
      const unsigned pre_key = static_cast<unsigned>(pre >> 32) >> ks;
      const unsigned lo_key = by_key ? pre_key << ks : 0u;
      const unsigned long long pre_hi = pre >> shift;
      for_each_key<THREADS, KEYS>(row, W, vec4, [&](unsigned c, unsigned key) {
        if (key < lo_key) return;
        bool above, in;
        if (by_key) {
          above = (key >> ks) > pre_key;
          in = !above;
        } else {
          const unsigned long long h = packed(key, c) >> shift;
          above = h > pre_hi;
          in = h == pre_hi;
        }
        if (above || (done && in)) {
          const unsigned long long p = packed(key, c);
          if (p < upper) cand[atomicAdd(&sm.n_cand, 1u)] = p;
        } else if (in) {
          sm.list[atomicAdd(&sm.n_list, 1u)] = packed(key, c);
        }
      });
      count_row_pass();
      __syncthreads();
    }
    if (last) release();
    if (STOP == 3) return;
    // The list holds the in_bin entries of the threshold bin. While the bin
    // holds more than SMALL, a round of the next digit over the list narrows
    // it (a warp whose digits are all equal, ties, adds them by one atomic);
    // the list's entries above the bin then join the winners. The bin's own
    // entries (all winners once all are taken, else at most SMALL) are
    // ordered by one warp in registers: the `rank` largest are winners, the
    // rank-th T.
    const unsigned long long* bin_entries = sm.list;
    if (!done && in_bin > SMALL) {
      const unsigned n_list = in_bin;
      for (bool first = d == 1; !done && in_bin > SMALL; first = false) {
        d = next_digit(d, W, pre, shift);
        if (!first) {
          // after a round (over the row or the list) that left more than
          // SMALL (ties): skip the digits that all of the bin's entries
          // share, seen from its least and greatest entry
          const unsigned long long pre_hi = pre >> shift;
          unsigned long long lo = ~0ull, hi = 0ull;
          for (unsigned i = threadIdx.x; i < n_list; i += THREADS) {
            const unsigned long long p = sm.list[i];
            if ((p >> shift) == pre_hi) {
              lo = p < lo ? p : lo;
              hi = p > hi ? p : hi;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long l = __shfl_xor_sync(FULL, lo, off), h = __shfl_xor_sync(FULL, hi, off);
            lo = l < lo ? l : lo;
            hi = h > hi ? h : hi;
          }
          if (lane == 0) {
            sm.warp_lo[warp] = lo;
            sm.warp_hi[warp] = hi;
          }
          __syncthreads();
#pragma unroll
          for (int w = 0; w < THREADS / 32; ++w) {
            lo = sm.warp_lo[w] < lo ? sm.warp_lo[w] : lo;
            hi = sm.warp_hi[w] > hi ? sm.warp_hi[w] : hi;
          }
          while (((lo ^ hi) >> digit_shift(d)) == 0) {  // the bin's entries are distinct: it ends
            pre |= ((lo >> digit_shift(d)) & ((1ull << digit_bits(d)) - 1)) << digit_shift(d);
            shift = digit_shift(d);
            d = next_digit(d + 1, W, pre, shift);
          }
        }
        const int s = digit_shift(d);
        const unsigned mask = (1u << digit_bits(d)) - 1;
        const unsigned long long pre_hi = pre >> shift;
        for (unsigned base = warp * 32; base < n_list; base += THREADS) {
          const unsigned i = base + lane;
          const unsigned long long p = i < n_list ? sm.list[i] : 0ull;
          const bool ok = i < n_list && (p >> shift) == pre_hi;
          const unsigned digit = static_cast<unsigned>(p >> s) & mask;
          const unsigned act = __ballot_sync(FULL, ok);
          if (ok) {
            const int leader = __ffs(act) - 1;
            if (__all_sync(act, digit == __shfl_sync(act, digit, leader))) {
              if (lane == leader) atomicAdd(&sm.hist[digit], __popc(act));
            } else {
              atomicAdd(&sm.hist[digit], 1u);
            }
          }
        }
        find_bin<THREADS, DIGIT_BITS_MAX>(sm, rank);
        pre |= static_cast<unsigned long long>(sm.bin) << s;
        shift = s;
        rank -= sm.before;
        in_bin = sm.count;
        done = in_bin == rank;
        ++d;
      }
      const unsigned long long pre_hi = pre >> shift;
      for (unsigned i = threadIdx.x; i < n_list; i += THREADS) {
        const unsigned long long p = sm.list[i];
        const unsigned long long h = p >> shift;
        if (h > pre_hi || (done && h == pre_hi)) {
          if (p < upper) cand[atomicAdd(&sm.n_cand, 1u)] = p;
        } else if (h == pre_hi) {
          sm.small[atomicAdd(&sm.n_small, 1u)] = p;
        }
      }
      __syncthreads();
      bin_entries = sm.small;
    }
    auto take_bin = [&](unsigned long long (&x)[2]) {  // warp 0, the bin's entries ordered in x
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned e = lane + 32 * j;
        if (e < rank && x[j] < upper) cand[atomicAdd(&sm.n_cand, 1u)] = x[j];
        if (e == rank - 1) sm.threshold = x[j];
      }
    };
    const bool one_warp = !done && n_pow <= 64;  // the bin's winners and the order on warp 0 alone
    if (!done && !one_warp) {
      if (warp == 0) {
        unsigned long long x[2];
        warp_sort(bin_entries, in_bin, x);
        take_bin(x);
      }
      __syncthreads();
    }
    // the order: [T, upper) holds exactly n entries. Up to 64 stay in warp
    // 0's registers, which emits them after the row's last barrier: its
    // stores (and a caller's reads for them) overlap the next row.
    unsigned long long x[2] = {0ull, 0ull};
    if (n_pow <= 64) {
      if (warp == 0) {
        if (one_warp) {
          warp_sort(bin_entries, in_bin, x);
          take_bin(x);
          __syncwarp();
        }
        warp_sort(cand, n, x);
      }
    } else {
      sort_descending<THREADS>(cand, n_pow);
      for (int j = threadIdx.x; j < n; j += THREADS)
        emit(done_out + j, column_of(cand[j]), static_cast<unsigned>(cand[j] >> 32));
    }
    __syncthreads();
    upper = done ? pre : sm.threshold;
    if (n_pow <= 64 && warp == 0) {
      if (lane < n) emit(done_out + lane, column_of(x[0]), static_cast<unsigned>(x[0] >> 32));
      if (lane + 32 < n) emit(done_out + lane + 32, column_of(x[1]), static_cast<unsigned>(x[1] >> 32));
    }
  }
}

}  // namespace lemon_select
