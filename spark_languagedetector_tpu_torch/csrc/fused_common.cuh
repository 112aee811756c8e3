// What the fused detect and fused segment kernels share: the inline
// window-id plan and its arithmetic, the accumulator type per table dtype,
// the staged-row column sum, and the launch geometry.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace fused {

constexpr int kMaxInline = 8;
constexpr int kStage = 1024;  // rows staged per window block
constexpr int kMaxColsPerThread = 4;
constexpr int kMaxLangs = 1024 * kMaxColsPerThread;

enum InlineKind { kPoly = 0, kFnvMask = 1, kFnvFold = 2 };

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;

struct InlinePlan {
  int count;
  int n[kMaxInline];
  int kind[kMaxInline];
  uint32_t p1[kMaxInline];
  uint32_t p2[kMaxInline];
};

template <typename T>
struct Accum {
  using type = int32_t;
};
template <>
struct Accum<float> {
  using type = float;
};

// The fused-table row of the window of n bytes at w: POLY (exact polynomial
// id + offset), FNV_MASK (FNV-1a & mask) or FNV_FOLD (exact12: base +
// FNV-1a % modulus), all in native uint32.
__device__ __forceinline__ int inline_row(const uint8_t* w, int n, int kind,
                                          uint32_t p1, uint32_t p2) {
  if (kind == kPoly) {
    uint32_t id = 0;
    for (int i = 0; i < n; ++i) id = id * 256u + w[i];
    return static_cast<int>(id + p1);
  }
  uint32_t h = kFnvOffset;
  for (int i = 0; i < n; ++i) h = (h ^ w[i]) * kFnvPrime;
  if (kind == kFnvMask) return static_cast<int>(h & p1);
  return static_cast<int>(p1 + h % p2);
}

// Sum the staged rows into this thread's columns (tid, tid + nt, ...). Every
// thread reads the same srow[i] (a shared-memory broadcast) and a warp reads
// consecutive columns of one table row. A row outside [0, R) is a masked
// window and contributes nothing.
template <typename T, typename A>
__device__ __forceinline__ void accumulate(A (&acc)[kMaxColsPerThread],
                                           const int32_t* srow, int cnt,
                                           const T* __restrict__ wq, int R,
                                           int L, int tid, int nt) {
#pragma unroll
  for (int m = 0; m < kMaxColsPerThread; ++m) {
    const int c = tid + m * nt;
    if (c < L) {
      A a = acc[m];
      for (int i = 0; i < cnt; ++i) {
        const int r = srow[i];
        if (static_cast<unsigned>(r) < static_cast<unsigned>(R))
          a += static_cast<A>(wq[static_cast<size_t>(r) * L + c]);
      }
      acc[m] = a;
    }
  }
}

// Host side: the plan from the C entry point's arrays; false when it does
// not fit.
inline bool make_plan(InlinePlan& plan, int n_inline, const int* inline_n,
                      const int* inline_kind, const unsigned int* inline_p1,
                      const unsigned int* inline_p2) {
  if (n_inline < 0 || n_inline > kMaxInline) return false;
  plan = InlinePlan{};
  plan.count = n_inline;
  for (int j = 0; j < n_inline; ++j) {
    plan.n[j] = inline_n[j];
    plan.kind[j] = inline_kind[j];
    plan.p1[j] = inline_p1[j];
    plan.p2[j] = inline_p2[j];
  }
  return true;
}

// Host side: threads per block so that every language column has a thread
// (up to kMaxColsPerThread columns each), a whole number of warps, at
// least two.
inline int block_threads(int L) {
  const int cols = (L + 1023) / 1024;
  int threads = (L + cols - 1) / cols;
  threads = ((threads + 31) / 32) * 32;
  return threads < 64 ? 64 : threads;
}

}  // namespace fused
