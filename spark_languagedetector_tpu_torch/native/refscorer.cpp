// The PyTorch port's copy of spark_languagedetector_tpu/native/refscorer.cpp, built
// by spark_languagedetector_tpu_torch/native/__init__.py into build/native/.
//
// Compiled per-row baseline scorer: the reference hot loop's shape, -O3.
//
// Role: BASELINE.md's north star is ">=50x docs/sec over the Scala-UDF
// baseline", whose hot loop is a JVM hash-map probe per sliding window plus
// a dense vector accumulate and an argmax (reference
// LanguageDetectorModel.scala:139-155: ngrams -> Map.get -> BLAS.axpy ->
// Breeze argmax). No JVM exists in this image, so this file is the faithful
// compiled stand-in: one hash-map probe per window (std::unordered_map over
// arena-backed string_views — no per-window allocation, stronger than the
// JVM's per-window String slice), a double-precision axpy accumulate, and a
// first-max-wins argmax. bench.py times it per config as the `vs_cpp`
// denominator, bracketed by the pure-Python per-row baseline (flattering)
// and the vectorized-numpy baseline (sandbagging).
//
// Pure C ABI like packer.cpp: no exceptions across the boundary, caller owns
// all buffers, sizes explicit, documents passed as pointer+length (embedded
// NULs allowed).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct RefModel {
  // One contiguous arena owns every key's bytes; the map's string_view keys
  // point into it. Weight rows live in one flat [n_keys, L] copy.
  std::vector<char> key_arena;
  std::vector<double> weight_arena;
  std::unordered_map<std::string_view, const double*> grams;
  int64_t L = 0;
};

// Contiguous range partition across up to n_threads threads (same helper
// shape as packer.cpp's parallel_for; duplicated because the two files
// compile as independent translation units into one .so).
template <typename Fn>
void ref_parallel_for(int64_t n, int32_t n_threads, Fn fn) {
  int threads = std::max(1, n_threads);
  threads = static_cast<int>(std::min<int64_t>(threads, n));
  if (threads == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

// Probe one window; on hit, accumulate its weight row (the axpy).
inline void probe_accumulate(const RefModel* m, const char* p, int64_t n,
                             double* acc) {
  auto it = m->grams.find(std::string_view(p, static_cast<size_t>(n)));
  if (it != m->grams.end()) {
    const double* v = it->second;
    for (int64_t j = 0; j < m->L; ++j) acc[j] += v[j];
  }
}

}  // namespace

extern "C" {

// Build the gram map: n_keys byte strings (pointer + length each; duplicates
// keep the first occurrence) with weight rows vecs[[n_keys, L]] (row-major
// doubles, copied). Returns an opaque handle for ref_score/ref_free.
void* ref_build(const uint8_t* const* keys,
                const int64_t* key_lens,
                int64_t n_keys,
                const double* vecs,
                int64_t L) {
  auto* m = new RefModel;
  m->L = L;
  int64_t total = 0;
  for (int64_t i = 0; i < n_keys; ++i) total += key_lens[i];
  m->key_arena.reserve(static_cast<size_t>(total));
  m->weight_arena.assign(vecs, vecs + n_keys * L);
  m->grams.reserve(static_cast<size_t>(n_keys) * 2);
  for (int64_t i = 0; i < n_keys; ++i) {
    size_t off = m->key_arena.size();
    m->key_arena.insert(m->key_arena.end(),
                        reinterpret_cast<const char*>(keys[i]),
                        reinterpret_cast<const char*>(keys[i]) + key_lens[i]);
    m->grams.emplace(
        std::string_view(m->key_arena.data() + off,
                         static_cast<size_t>(key_lens[i])),
        m->weight_arena.data() + i * L);
  }
  return m;
}

void ref_free(void* handle) { delete static_cast<RefModel*>(handle); }

// Score n_docs documents: per gram length, slide every full window through
// the map (documents shorter than the gram length contribute one partial
// window of the whole document — the reference's `sliding` emits a partial
// final group, LanguageDetectorModel.scala:143); accumulate hits into a
// per-document double vector; write the first-max-wins argmax (Breeze
// argmax semantics) to out_labels[i]. n_threads = 1 is the per-row baseline
// measurement; more threads model multi-core executors.
void ref_score(const void* handle,
               const uint8_t* const* docs,
               const int64_t* lens,
               int64_t n_docs,
               const int32_t* gram_lens,
               int32_t n_gl,
               int32_t* out_labels,
               int32_t n_threads) {
  const auto* m = static_cast<const RefModel*>(handle);
  const int64_t L = m->L;
  ref_parallel_for(n_docs, n_threads, [=](int64_t d) {
    std::vector<double> acc(static_cast<size_t>(L), 0.0);
    const char* data = reinterpret_cast<const char*>(docs[d]);
    const int64_t len = lens[d];
    for (int32_t gi = 0; gi < n_gl; ++gi) {
      const int64_t n = gram_lens[gi];
      if (len >= n) {
        for (int64_t i = 0; i + n <= len; ++i)
          probe_accumulate(m, data + i, n, acc.data());
      } else if (len > 0) {
        probe_accumulate(m, data, len, acc.data());
      }
    }
    int32_t best = 0;
    for (int64_t j = 1; j < L; ++j)
      if (acc[j] > acc[best]) best = static_cast<int32_t>(j);
    out_labels[d] = best;
  });
}

}  // extern "C"
