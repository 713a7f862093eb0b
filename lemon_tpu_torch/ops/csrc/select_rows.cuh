// Exact top-k of one row, shared by K2 (topk.cu) and K4 (select.cu): a warp
// selection for narrow rows and small k held in registers (warp_top_k), and
// a block threshold select for the rest (select_top_k).
//
// The order. Every entry becomes one 64-bit number, packed(v, c) =
// (order_key(v) << 32) | ~c: order_key maps a float to a uint32 whose order
// is the float order (flip the sign bit of a positive value, all bits of a
// negative one), after -0.0 is canonicalised to +0.0 so that the two zeros
// tie as they compare. Larger packed = earlier in "value descending, column
// ascending", so ties go to the lower column and -inf entries come out by
// ascending column with no sentinel; packed values are distinct.
//
// The selection. A radix select finds the packed value T of the n-th entry,
// 8 bits at a time from the top: each round is one pass over the row that
// builds a 256-bin histogram in shared memory of the next digit among the
// entries whose higher digits match the prefix so far (a warp's equal
// digits merged into one atomic), then one warp finds the bin that holds the
// n-th entry. It stops as soon as the entries of that bin are all taken, so
// distinct values need at most 4 rounds (the value bits) and a tie at the
// threshold at most 4 more (the column bits, less the digits that no column
// below W can change). Once the bin holds at most 1024 entries and a quarter
// of the row, the next pass also records their columns, and the rounds
// after it scan that list instead of the row. One pass then collects the
// entries in [T, upper) with warp-aggregated slots, a bitonic sort in shared
// memory orders them, and they are emitted. k above the sort buffer runs in
// chunks of SORT_CAP, each chunk's upper bound the previous chunk's
// threshold. Barriers: 2 per round
// and, in the sort of n winners, 1 for n <= 64 and 1 + L + L(L+1)/2 with
// L = log2(n / 64) above (6 at n = 256): none grows with W. Nothing is
// written back to the row.

#pragma once

#include <cuda_runtime.h>

namespace lemon_select {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v == 0.f ? 0.f : v);  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
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

constexpr unsigned LIST_CAP = 1024;

struct Scratch {
  unsigned hist[256];
  unsigned list[LIST_CAP];  // the columns in the prefix's bin, once they are few
  unsigned long long prefix;
  unsigned remaining;  // rank of the wanted entry inside the prefix's bin
  unsigned in_bin;     // entries in the prefix's bin
  unsigned n_list;
  unsigned n_cand;
  int done;
};

// The packed value T with exactly `rank` entries >= T (0 < rank <= W).
// Every thread of the block calls it; it returns after a barrier.
template <int THREADS, typename KeyAt>
__device__ unsigned long long threshold(KeyAt key_at, unsigned W, unsigned rank, Scratch& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 256; i += THREADS) sm.hist[i] = 0;
  if (threadIdx.x == 0) {
    sm.remaining = rank;
    sm.n_list = 0;
    sm.done = 0;
  }
  __syncthreads();
  unsigned long long pre = 0;
  unsigned in_bin = W;
  unsigned n_listed = 0;  // > 0: rounds scan sm.list[0, n_listed) instead of the row
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift < 32 && ((W - 1) >> shift) == 0) {
      pre |= 0xffull << shift;  // ~c of every column c < W has all ones here
      continue;
    }
    // in 32-bit halves: a value round reads the key's bits, a column round
    // needs the key equal to the prefix's and reads the bits of ~c
    const bool col_round = shift < 32;
    const int s = shift & 31;
    const unsigned mask = s == 24 ? 0u : ~0u << (s + 8);
    const unsigned pre_key = static_cast<unsigned>(pre >> 32);
    const unsigned pre_word = col_round ? static_cast<unsigned>(pre) : pre_key;
    // once the bin is at most LIST_CAP and a quarter of the row, this pass
    // records its columns and the later rounds scan only those
    const bool record = n_listed == 0 && in_bin <= LIST_CAP && 4 * in_bin <= W;
    const unsigned n = n_listed ? n_listed : W;
    for (unsigned base = warp * 32; base < n; base += THREADS) {
      const unsigned i = base + lane;
      const unsigned c = n_listed && i < n ? sm.list[i] : i;
      bool ok = false;
      unsigned digit = 0;
      if (i < n) {
        const unsigned key = key_at(c);
        const unsigned word = col_round ? ~c : key;
        ok = (word & mask) == pre_word && (!col_round || key == pre_key);
        digit = (word >> s) & 0xffu;
      }
      const unsigned act = __ballot_sync(FULL, ok);
      if (ok) {
        const int leader = __ffs(act) - 1;
        if (__all_sync(act, digit == __shfl_sync(act, digit, leader))) {
          if (lane == leader) atomicAdd(&sm.hist[digit], __popc(act));
        } else {
          const unsigned peers = __match_any_sync(act, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&sm.hist[digit], __popc(peers));
        }
      }
      if (record && act) {
        const int leader = __ffs(act) - 1;
        unsigned slot = 0;
        if (lane == leader) slot = atomicAdd(&sm.n_list, __popc(act));
        slot = __shfl_sync(FULL, slot, leader) + __popc(act & ((1u << lane) - 1u));
        if (ok) sm.list[slot] = c;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 255-8l down to 248-8l; it reads and clears them
      const unsigned r = sm.remaining;
      unsigned cnt[8];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = sm.hist[255 - 8 * lane - j];
        sm.hist[255 - 8 * lane - j] = 0;
        sum += cnt[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
      }
      unsigned before = incl - sum;
      if (before < r && r <= incl) {
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!found && before + cnt[j] >= r) {
            found = true;
            sm.prefix = pre | (static_cast<unsigned long long>(255 - 8 * lane - j) << shift);
            sm.remaining = r - before;
            sm.in_bin = cnt[j];
            sm.done = cnt[j] == r - before;
          }
          if (!found) before += cnt[j];
        }
      }
    }
    __syncthreads();
    pre = sm.prefix;
    if (record) n_listed = sm.n_list;  // the bin's entries of the round before this one
    in_bin = sm.in_bin;
    if (sm.done) break;
  }
  return pre;
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
// two. Strides below 64 pair entries inside one aligned 64-entry segment,
// which one warp runs with __syncwarp (pair i = 32 * segment + lane), so the
// block synchronises only for strides of 64 and more: n <= 64 costs one
// barrier, n = 256 six. Ends with a barrier.
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
  in_segments(2, min(n, 64));
  for (int size = 128; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += THREADS) compare_swap(a, i, size, stride);
      __syncthreads();
    }
    in_segments(size, size);
  }
}

// The k best entries of a row held in registers by one warp, in selection
// order: lane l holds the keys of columns l + 32 j (j < CAP), key 0 past the
// row (below every real entry, never reached as k <= W). Each lane keeps the
// best entry it has not given out; a round is a 64-bit butterfly max (warp
// shuffles only) and the lane whose entry won rescans its registers.
// emit(j, column) runs on lane j % 32.
template <int CAP, typename Emit>
__device__ __forceinline__ void warp_top_k(const unsigned (&key)[CAP], int k, Emit emit) {
  const unsigned lane = threadIdx.x & 31;
  unsigned long long last = ~0ull;  // the lane's last entry given out
  auto local_best = [&]() {
    unsigned long long b = 0;
#pragma unroll
    for (int j = 0; j < CAP; ++j) {
      const unsigned long long p = packed(key[j], lane + 32 * j);
      if (p < last && p > b) b = p;
    }
    return b;
  };
  unsigned long long best = local_best();
  for (int j = 0; j < k; ++j) {
    unsigned long long m = best;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, m, off);
      m = o > m ? o : m;
    }
    if (lane == (j & 31)) emit(j, column_of(m));
    if (m == best) {  // packed values are distinct: only the owner
      last = best;
      best = local_best();
    }
  }
}

// The k best entries of a row of W (0 < k <= W) in selection order:
// emit(j, column) for j in [0, k), spread over the block's threads. key_at(c)
// is order_key of column c. cand holds next_pow2(min(k, SORT_CAP)) values.
// Every thread of the block calls it.
template <int THREADS, int SORT_CAP, typename KeyAt, typename Emit>
__device__ void select_top_k(KeyAt key_at, unsigned W, int k, unsigned long long* cand, Scratch& sm, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long upper = ~0ull;  // above every packed value of a real entry
  for (int done_out = 0; done_out < k; done_out += SORT_CAP) {
    const int n = min(SORT_CAP, k - done_out);
    if (threadIdx.x == 0) sm.n_cand = 0;
    const unsigned long long thr = threshold<THREADS>(key_at, W, done_out + n, sm);
    for (unsigned base = warp * 32; base < W; base += THREADS) {
      const unsigned c = base + lane;
      unsigned long long p = 0;
      bool take = false;
      if (c < W) {
        p = packed(key_at(c), c);
        take = p >= thr && p < upper;
      }
      const unsigned m = __ballot_sync(FULL, take);
      if (m) {
        const int leader = __ffs(m) - 1;
        unsigned slot = 0;
        if (lane == leader) slot = atomicAdd(&sm.n_cand, __popc(m));
        slot = __shfl_sync(FULL, slot, leader) + __popc(m & ((1u << lane) - 1u));
        if (take) cand[slot] = p;
      }
    }
    const int n_pow = next_pow2(n);
    for (int i = n + threadIdx.x; i < n_pow; i += THREADS) cand[i] = 0;  // below every real entry
    __syncthreads();
    sort_descending<THREADS>(cand, n_pow);
    for (int j = threadIdx.x; j < n; j += THREADS) emit(done_out + j, column_of(cand[j]));
    upper = thr;
    __syncthreads();  // cand is refilled by the next chunk
  }
}

}  // namespace lemon_select
