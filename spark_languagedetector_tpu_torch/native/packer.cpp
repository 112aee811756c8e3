// The PyTorch port's copy of spark_languagedetector_tpu/native/packer.cpp, built
// by spark_languagedetector_tpu_torch/native/__init__.py into build/native/.
//
// Native host-side data loader: padded-batch packing and byte preprocessing.
//
// Role: the reference delegates its host-side data plumbing to Spark's JVM
// runtime (row iterators, Tungsten buffers). Here, the equivalent service —
// turning ragged UTF-8 documents into the zero-padded uint8 [B, S] batches
// the device scorer consumes, plus the byte-level text cleanup — is native
// C++ behind a C ABI, loaded via ctypes (no pybind11 in this image). At the
// ≥50×-throughput target the Python per-document copy loop becomes the
// bottleneck long before the device does; these routines are memcpy-bound and
// multithreaded.
//
// Functions are pure C ABI: no exceptions across the boundary, caller owns
// all buffers, sizes given explicitly.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to n_threads threads (contiguous
// range partition; joins before returning).
template <typename Fn>
void parallel_for(int64_t n, int32_t n_threads, Fn fn) {
  int threads = std::max(1, n_threads);
  threads = static_cast<int>(std::min<int64_t>(threads, n));
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

}  // namespace

extern "C" {

// Pack n_docs ragged byte strings into out[n_docs * pad_to] (zero-padded)
// and out_lens[n_docs] (clamped to pad_to). docs[i] points at document i's
// bytes (lens[i] bytes) — pointer array, so Python hands over each bytes
// object's buffer directly with zero staging copies; the memcpy below is the
// only copy of the data on the host.
void pack_batch(const uint8_t* const* docs,
                const int64_t* lens,
                int64_t n_docs,
                int64_t pad_to,
                uint8_t* out,
                int32_t* out_lens,
                int32_t n_threads) {
  if (n_docs <= 0) return;
  std::memset(out, 0, static_cast<size_t>(n_docs) * pad_to);
  parallel_for(n_docs, n_threads, [=](int64_t i) {
    int64_t n = std::min<int64_t>(lens[i], pad_to);
    if (n > 0) std::memcpy(out + i * pad_to, docs[i], n);
    out_lens[i] = static_cast<int32_t>(n);
  });
}

// Ragged packing for the wire-efficient transfer path: copy each document
// into a flat chunk-aligned buffer at a caller-computed chunk offset
// (offs[i] is document i's first chunk index; chunk row 0 is reserved as
// the all-zeros miss row the device-side unpack gather reads for
// out-of-range chunks). The caller zeroes `flat` and sizes it to the
// bucketed chunk count; this routine is the memcpy loop only.
void pack_ragged(const uint8_t* const* docs,
                 const int64_t* lens,
                 int64_t n_docs,
                 int64_t pad_to,
                 int64_t chunk,
                 const int32_t* offs,
                 uint8_t* flat,
                 int32_t* out_lens,
                 int32_t n_threads) {
  if (n_docs <= 0) return;
  parallel_for(n_docs, n_threads, [=](int64_t i) {
    int64_t n = std::min<int64_t>(lens[i], pad_to);
    if (n > 0) std::memcpy(flat + static_cast<int64_t>(offs[i]) * chunk,
                           docs[i], n);
    out_lens[i] = static_cast<int32_t>(n);
  });
}

// Byte-level special-character strip + ASCII-whitespace squash. Multi-byte
// UTF-8 sequences — including Unicode whitespace like NBSP — pass through
// untouched; the str-level SpecialCharPreprocessor owns full semantics.
// Writes cleaned bytes to out (caller sizes out >= len) and returns the
// cleaned length. Strip set: /_[]*()%^&@$#:|{}<>~`"\  — whitespace runs
// collapse to one 0x20.
namespace {
struct StripTable {
  bool strip[256] = {false};
  StripTable() {
    const char* set = "/_[]*()%^&@$#:|{}<>~`\"\\";
    for (const char* p = set; *p; ++p) strip[static_cast<uint8_t>(*p)] = true;
  }
};
const StripTable kStrip;  // thread-safe static init at load time
}  // namespace

int64_t clean_bytes(const uint8_t* in, int64_t len, uint8_t* out) {
  const bool* strip = kStrip.strip;
  int64_t o = 0;
  bool in_space = false;
  for (int64_t i = 0; i < len; ++i) {
    uint8_t c = in[i];
    if (strip[c]) continue;
    bool is_space = (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                     c == '\f' || c == '\v');
    if (is_space) {
      in_space = true;
      continue;
    }
    if (in_space) {
      out[o++] = ' ';
      in_space = false;
    }
    out[o++] = c;
  }
  if (in_space) out[o++] = ' ';
  return o;
}

// ASCII lowercase in place (A-Z only; multi-byte UTF-8 untouched). The
// Unicode/locale-sensitive cases stay in Python; this covers the dominant
// byte range at native speed.
void ascii_lower(uint8_t* buf, int64_t len) {
  for (int64_t i = 0; i < len; ++i) {
    uint8_t c = buf[i];
    if (c >= 'A' && c <= 'Z') buf[i] = c + 32;
  }
}

}  // extern "C"
