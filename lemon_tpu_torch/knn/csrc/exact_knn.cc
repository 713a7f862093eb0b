// Host-side exact k-nearest-neighbor search.
//
// Native counterpart of the FAISS IndexFlatIP/IndexFlatL2 role in the
// reference (run_lemon.py:166-177): used when embeddings live in host
// memory (CPU-only runs, oracle checks against the device path). Blocked
// over the database for cache locality, with a per-query bounded insertion
// buffer (k <= 1024); ties broken by ascending database index, matching
// lemon_tpu_torch.knn.index semantics (a copy of the JAX package's
// lemon_tpu/knn/csrc/exact_knn.cc, built by knn/cpp_backend.py).
//
// C ABI only (consumed via ctypes; no pybind11 in this toolchain).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Hit {
  float score;  // internally 'higher is better'
  int32_t index;
};

// insert into a descending-sorted fixed-size buffer; ascending-index
// tiebreak falls out of scanning the database in order and using strict >.
inline void insert_hit(Hit* buf, int k, float score, int32_t index) {
  if (score <= buf[k - 1].score) return;
  int pos = k - 1;
  while (pos > 0 && score > buf[pos - 1].score) {
    buf[pos] = buf[pos - 1];
    --pos;
  }
  buf[pos] = {score, index};
}

}  // namespace

extern "C" {

// metric: 0 = inner product (scores descending), 1 = squared L2 (ascending).
// xb: (n_db, d) row-major; xq: (n_q, d); out_scores/out_idx: (n_q, k).
void exact_knn_search(const float* xb, int64_t n_db, const float* xq,
                      int64_t n_q, int64_t d, int32_t k, int32_t metric,
                      float* out_scores, int32_t* out_idx) {
  const int kk = static_cast<int>(k);
  std::vector<float> db_sqnorm;
  if (metric == 1) {
    db_sqnorm.resize(n_db);
    for (int64_t j = 0; j < n_db; ++j) {
      double acc = 0.0;
      const float* row = xb + j * d;
      for (int64_t t = 0; t < d; ++t) acc += double(row[t]) * row[t];
      db_sqnorm[j] = static_cast<float>(acc);
    }
  }

  constexpr int64_t kBlock = 4096;
  std::vector<Hit> heap(kk);

  for (int64_t i = 0; i < n_q; ++i) {
    const float* q = xq + i * d;
    float q_sq = 0.f;
    if (metric == 1) {
      double acc = 0.0;
      for (int64_t t = 0; t < d; ++t) acc += double(q[t]) * q[t];
      q_sq = static_cast<float>(acc);
    }
    for (int t = 0; t < kk; ++t) heap[t] = {-INFINITY, static_cast<int32_t>(n_db)};

    for (int64_t start = 0; start < n_db; start += kBlock) {
      const int64_t end = std::min(start + kBlock, n_db);
      for (int64_t j = start; j < end; ++j) {
        const float* row = xb + j * d;
        float dot = 0.f;
        for (int64_t t = 0; t < d; ++t) dot += q[t] * row[t];
        const float score = (metric == 0) ? dot : -(q_sq - 2.f * dot + db_sqnorm[j]);
        insert_hit(heap.data(), kk, score, static_cast<int32_t>(j));
      }
    }
    for (int t = 0; t < kk; ++t) {
      out_scores[i * kk + t] = (metric == 0) ? heap[t].score : -heap[t].score;
      out_idx[i * kk + t] = heap[t].index;
    }
  }
}

// Pairwise distance of aligned rows: diag of the (a, b) distance matrix.
// metric 0: 1 - cosine; 1: squared L2.
void pair_distance(const float* a, const float* b, int64_t n, int64_t d,
                   int32_t metric, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* x = a + i * d;
    const float* y = b + i * d;
    if (metric == 0) {
      double dot = 0, nx = 0, ny = 0;
      for (int64_t t = 0; t < d; ++t) {
        dot += double(x[t]) * y[t];
        nx += double(x[t]) * x[t];
        ny += double(y[t]) * y[t];
      }
      out[i] = static_cast<float>(1.0 - dot / std::max(std::sqrt(nx * ny), 1e-30));
    } else {
      double acc = 0;
      for (int64_t t = 0; t < d; ++t) {
        const double diff = double(x[t]) - y[t];
        acc += diff * diff;
      }
      out[i] = static_cast<float>(acc);
    }
  }
}

}  // extern "C"
