// The CLIP byte-pair encoder on the host, for the rows whose text needs no
// cleaning (models/tokenizer.py: tokenize_batch).
//
// A row is eligible when every byte is printable ASCII (0x20-0x7E), '\t',
// '\n' or '\r', and none is '&'. On such text the Python path's cleaning
// (ftfy or NFC, the double html.unescape, the whitespace collapse) cannot
// change what the pre-token pattern finds, so the row's ids are:
//
//   lowercase, then at each position the first of these that matches:
//   "<|startoftext|>", "<|endoftext|>", 's 't 're 've 'm 'll 'd, a run of
//   letters, one digit, a run of what is neither whitespace, letter nor
//   digit; whitespace is skipped. Each pre-token's bytes become their
//   symbols, the last one in its "</w>" form, and are merged: while some
//   adjacent pair has a rank, every occurrence of the first lowest-ranked
//   pair, left to right. [SOT] + ids + [EOT], cut to the context with EOT
//   forced last, padded with the fill.
//
// The caller gives the symbol ids and the merge table as ids, read from the
// Python tokenizer's own vocabulary. A handle keeps the merged ids of every
// pre-token it has seen (cleared past 1M entries or 256 MiB) and takes a
// mutex for a call, so threads may share it. The interface is plain C for
// ctypes, which releases the interpreter lock while a call runs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kCacheLimit = size_t(1) << 20;  // pre-tokens in the cache before it is cleared
constexpr size_t kCacheBytes = size_t(1) << 28;  // or bytes of their keys or ids (32-bit offsets)
constexpr char kSot[] = "<|startoftext|>";
constexpr char kEot[] = "<|endoftext|>";
constexpr const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};

// A byte's class in an eligible row; kBad marks a byte that makes a row ineligible.
enum : uint8_t { kBad, kSpace, kLetter, kDigit, kOther };

struct Classes {
  uint8_t of[256];
  Classes() {
    for (int c = 0; c < 256; ++c) {
      of[c] = (c >= 0x20 && c <= 0x7E && c != '&') ? kOther : kBad;
      if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')) of[c] = kLetter;
      if (c >= '0' && c <= '9') of[c] = kDigit;
    }
    of[' '] = of['\t'] = of['\n'] = of['\r'] = kSpace;
  }
};
const Classes kClasses;

inline unsigned char lower(unsigned char c) { return (c >= 'A' && c <= 'Z') ? c + ('a' - 'A') : c; }

// Whether s[i:n] starts with the lowercase literal lit, ignoring case.
bool starts_with(const unsigned char* s, int64_t i, int64_t n, const char* lit) {
  for (int64_t j = 0; lit[j]; ++j) {
    if (i + j >= n || lower(s[i + j]) != static_cast<unsigned char>(lit[j])) return false;
  }
  return true;
}

struct Merge {
  int32_t rank;
  int32_t id;
};

inline uint64_t pair_key(int32_t left, int32_t right) {
  return static_cast<uint64_t>(static_cast<uint32_t>(left)) << 32 | static_cast<uint32_t>(right);
}

// The merged ids of each pre-token seen: open addressing on the lowered
// bytes' hash, the bytes and the ids kept in two pools.
class WordCache {
 public:
  // The ids of key[0:n], or null.
  const int32_t* find(const char* key, uint32_t n, uint64_t h, uint32_t* len) const {
    for (size_t i = h & mask_;; i = (i + 1) & mask_) {
      const Slot& e = slots_[i];
      if (e.hash == 0) return nullptr;
      if (e.hash == h && e.key_len == n && std::memcmp(keys_.data() + e.key_off, key, n) == 0) {
        *len = e.ids_len;
        return ids_.data() + e.ids_off;
      }
    }
  }

  void insert(const char* key, uint32_t n, uint64_t h, const std::vector<int32_t>& ids) {
    const bool full = size_ >= kCacheLimit || keys_.size() + n > kCacheBytes ||
                      4 * (ids_.size() + ids.size()) > kCacheBytes;
    if (full) clear();
    if (2 * (size_ + 1) > slots_.size()) grow();
    place({h, static_cast<uint32_t>(keys_.size()), n, static_cast<uint32_t>(ids_.size()),
           static_cast<uint32_t>(ids.size())});
    keys_.append(key, n);
    ids_.insert(ids_.end(), ids.begin(), ids.end());
    ++size_;
  }

  static uint64_t hash(const char* key, uint32_t n) {  // FNV-1a, never 0 (0 marks an empty slot)
    uint64_t h = 1469598103934665603ull;
    for (uint32_t i = 0; i < n; ++i) h = (h ^ static_cast<unsigned char>(key[i])) * 1099511628211ull;
    return h | 1;
  }

 private:
  struct Slot {
    uint64_t hash;
    uint32_t key_off, key_len, ids_off, ids_len;
  };

  void place(const Slot& e) {
    size_t i = e.hash & mask_;
    while (slots_[i].hash != 0) i = (i + 1) & mask_;
    slots_[i] = e;
  }

  void grow() {
    std::vector<Slot> old(std::max<size_t>(1024, 2 * slots_.size()));
    old.swap(slots_);
    mask_ = slots_.size() - 1;
    for (const Slot& e : old) {
      if (e.hash != 0) place(e);
    }
  }

  void clear() {
    slots_.assign(slots_.size(), Slot{});
    keys_.clear();
    ids_.clear();
    size_ = 0;
  }

  std::vector<Slot> slots_ = std::vector<Slot>(1024);
  size_t mask_ = 1023, size_ = 0;
  std::string keys_;
  std::vector<int32_t> ids_;
};

struct Bpe {
  int32_t symbol[256];      // a byte's symbol inside a pre-token
  int32_t symbol_end[256];  // its "</w>" form, for a pre-token's last byte
  int32_t sot, eot;
  std::unordered_map<uint64_t, Merge> merges;  // pair_key(left id, right id) -> rank, merged id
  WordCache cache;
  std::mutex mu;
  std::string key;             // scratch: the lowered pre-token
  std::vector<int32_t> parts;  // scratch: the symbols being merged
};

// The merges of the pre-token in b->key into b->parts.
void merge_word(Bpe* b) {
  std::vector<int32_t>& p = b->parts;
  const std::string& w = b->key;
  p.resize(w.size());
  for (size_t i = 0; i < w.size(); ++i) p[i] = b->symbol[static_cast<unsigned char>(w[i])];
  p.back() = b->symbol_end[static_cast<unsigned char>(w.back())];
  while (p.size() > 1) {
    int32_t best_rank = INT32_MAX, left = 0, right = 0, merged = 0;
    for (size_t i = 0; i + 1 < p.size(); ++i) {
      auto m = b->merges.find(pair_key(p[i], p[i + 1]));
      if (m != b->merges.end() && m->second.rank < best_rank) {
        best_rank = m->second.rank;
        left = p[i], right = p[i + 1], merged = m->second.id;
      }
    }
    if (best_rank == INT32_MAX) break;
    size_t out = 0;
    for (size_t i = 0; i < p.size();) {
      if (i + 1 < p.size() && p[i] == left && p[i + 1] == right) {
        p[out++] = merged;
        i += 2;
      } else {
        p[out++] = p[i++];
      }
    }
    p.resize(out);
  }
}

bool is_eligible(const unsigned char* s, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (kClasses.of[s[i]] == kBad) return false;
  }
  return true;
}

// One eligible row's ids into out[0:context]: [SOT] + ids + [EOT], cut and padded.
void encode_row(Bpe* b, const unsigned char* s, int64_t n, int32_t context, int32_t fill, int32_t* out) {
  const uint8_t* cls = kClasses.of;
  int32_t len = 0;  // tokens of [SOT] + ids met; from context on they are cut
  auto put = [&](int32_t id) {
    if (len < context) out[len] = id;
    ++len;
  };
  put(b->sot);
  int64_t i = 0;
  while (i < n && len < context) {
    const unsigned char c = s[i];
    const uint8_t k = cls[c];
    if (k == kSpace) {
      ++i;
      continue;
    }
    if (c == '<' && starts_with(s, i, n, kSot)) {
      put(b->sot);
      i += sizeof(kSot) - 1;
      continue;
    }
    if (c == '<' && starts_with(s, i, n, kEot)) {
      put(b->eot);
      i += sizeof(kEot) - 1;
      continue;
    }
    int64_t end = i + 1;
    bool contraction = false;
    if (c == '\'') {
      for (const char* lit : kContractions) {
        if (starts_with(s, i, n, lit)) {
          end = i + static_cast<int64_t>(std::strlen(lit));
          contraction = true;
          break;
        }
      }
    }
    if (!contraction && k != kDigit) {  // a run of letters, or of what is neither space, letter nor digit
      while (end < n && cls[s[end]] == k) ++end;
    }
    const uint32_t m = static_cast<uint32_t>(end - i);
    b->key.resize(m);
    for (uint32_t j = 0; j < m; ++j) b->key[j] = static_cast<char>(lower(s[i + j]));
    const uint64_t h = WordCache::hash(b->key.data(), m);
    uint32_t n_ids = 0;
    const int32_t* ids = b->cache.find(b->key.data(), m, h, &n_ids);
    if (ids == nullptr) {
      merge_word(b);
      b->cache.insert(b->key.data(), m, h, b->parts);
      ids = b->parts.data(), n_ids = static_cast<uint32_t>(b->parts.size());
    }
    for (uint32_t j = 0; j < n_ids; ++j) put(ids[j]);
    i = end;
  }
  if (len >= context) {
    out[context - 1] = b->eot;
  } else {
    out[len] = b->eot;
    for (int32_t j = len + 1; j < context; ++j) out[j] = fill;
  }
}

}  // namespace

// symbols: 512 ids, each byte's symbol then its "</w>" form; merges: n rows
// of (left id, right id, rank, merged id). Returns a handle, or null.
extern "C" void* lemon_bpe_load(const int32_t* symbols, const int32_t* merges, int64_t n, int32_t sot, int32_t eot) {
  Bpe* b = new (std::nothrow) Bpe();
  if (b == nullptr) return nullptr;
  std::memcpy(b->symbol, symbols, sizeof(b->symbol));
  std::memcpy(b->symbol_end, symbols + 256, sizeof(b->symbol_end));
  b->sot = sot, b->eot = eot;
  b->merges.reserve(static_cast<size_t>(n));
  for (int64_t r = 0; r < n; ++r) {
    const int32_t* m = merges + 4 * r;
    b->merges[pair_key(m[0], m[1])] = {m[2], m[3]};
  }
  return b;
}

extern "C" void lemon_bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

// rows texts, row r the UTF-8 bytes data[offsets[r]:offsets[r + 1]]; writes
// out (rows, context) and eligible (rows): 1 where the row was encoded here,
// 0 where it needs the Python path (its row of out is then the fill).
// context >= 1. Returns the number of eligible rows.
extern "C" int64_t lemon_bpe_encode_batch(void* handle, const char* data, const int64_t* offsets, int64_t rows,
                                          int32_t context, int32_t fill, int32_t* out, uint8_t* eligible) {
  Bpe* b = static_cast<Bpe*>(handle);
  std::lock_guard<std::mutex> hold(b->mu);
  int64_t n_eligible = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(data) + offsets[r];
    const int64_t n = offsets[r + 1] - offsets[r];
    int32_t* row = out + r * static_cast<int64_t>(context);
    eligible[r] = is_eligible(s, n);
    if (eligible[r]) {
      encode_row(b, s, n, context, fill, row);
      ++n_eligible;
    } else {
      for (int32_t j = 0; j < context; ++j) row[j] = fill;
    }
  }
  return n_eligible;
}
