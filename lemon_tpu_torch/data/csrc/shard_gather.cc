// Native gather for sharded uint8 .npy stores (port of
// lemon_tpu/data/csrc/shard_gather.cc; lemon_tpu_torch/data/streaming.py).
//
// Positioned reads (pread) of the requested rows straight from the shard
// files into the caller's output buffer, fanned out over a thread pool, so
// batch assembly runs at page-cache or disk speed without the interpreter
// lock; the encoder's Prefetcher overlaps it with the card's work on the
// previous batch. It takes the place of the reference's torch DataLoader
// workers for the streaming store.
//
// A plain C interface, bound with ctypes (lemon_tpu_torch/data/native_loader.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
  int fd;
  int64_t first_row;  // global row index of this shard's row 0
  int64_t n_rows;
  int64_t data_off;   // byte offset of row 0 in the file (.npy header size)
};

// Find the shard containing global row r (shards sorted by first_row).
inline const Shard* find_shard(const std::vector<Shard>& shards, int64_t r) {
  size_t lo = 0, hi = shards.size();
  while (lo + 1 < hi) {
    size_t mid = (lo + hi) / 2;
    if (shards[mid].first_row <= r) lo = mid; else hi = mid;
  }
  return &shards[lo];
}

}  // namespace

extern "C" {

// Opens shard files and gathers |n_idx| rows of |row_bytes| bytes each into
// |out| (caller-allocated, n_idx * row_bytes). Returns 0 on success, the
// index of the first failing row + 1 on a short/failed read, or -1 if a
// file fails to open. Thread count is clamped to [1, 64].
int64_t shard_gather(const char** paths, int64_t n_shards,
                     const int64_t* shard_first_row, const int64_t* shard_rows,
                     const int64_t* data_offsets, int64_t row_bytes,
                     const int64_t* indices, int64_t n_idx, uint8_t* out,
                     int32_t n_threads) {
  std::vector<Shard> shards(n_shards);
  for (int64_t s = 0; s < n_shards; ++s) {
    int fd = open(paths[s], O_RDONLY);
    if (fd < 0) {
      for (int64_t t = 0; t < s; ++t) close(shards[t].fd);
      return -1;
    }
    shards[s] = {fd, shard_first_row[s], shard_rows[s], data_offsets[s]};
  }

  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  if (n_threads > n_idx) n_threads = n_idx > 0 ? (int32_t)n_idx : 1;

  std::atomic<int64_t> fail{0};
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const Shard* sh = find_shard(shards, indices[i]);
      int64_t local = indices[i] - sh->first_row;
      off_t off = sh->data_off + local * row_bytes;
      uint8_t* dst = out + i * row_bytes;
      int64_t remaining = row_bytes;
      while (remaining > 0) {
        ssize_t got = pread(sh->fd, dst, remaining, off);
        if (got <= 0) {
          int64_t expected = 0;
          fail.compare_exchange_strong(expected, i + 1);
          return;
        }
        dst += got;
        off += got;
        remaining -= got;
      }
    }
  };

  std::vector<std::thread> pool;
  int64_t per = (n_idx + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t b = t * per, e = std::min<int64_t>(n_idx, b + per);
    if (b >= e) break;
    pool.emplace_back(worker, b, e);
  }
  for (auto& th : pool) th.join();
  for (auto& sh : shards) close(sh.fd);
  return fail.load();
}

}  // extern "C"
