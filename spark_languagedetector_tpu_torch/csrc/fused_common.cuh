// What the fused detect and fused segment kernels share: the inline
// window-id plan and its arithmetic, the accumulator type per table dtype,
// the launch geometry, and the core both run per block: count the block's
// windows per distinct table row in a shared-memory hash table, then read
// each distinct row of the table once and add count x row into the
// thread's language columns.
//
// The core, per block (one document, or one (document, cell)):
//   1. Count. A pass takes kPassWindows windows per thread and computes
//      their rows first, so their loads overlap. Then, in rounds of one
//      window per thread, lanes of a warp that hold the same row form a
//      group (__match_any_sync) and its lowest lane inserts the group's
//      size, so a hot row costs one atomic per warp. Inserts probe an
//      open-addressing table of kSlots (row -> uint32 count) with
//      atomicCAS/atomicAdd; rows outside [0, R) (masked windows) are
//      dropped first. Each insert round ends with one __syncthreads_count,
//      whose result (the keys new in the round) keeps every thread's copy
//      of the distinct-row count equal.
//   2. Flush. Before a round that could take the table past kMaxFill
//      distinct rows (load factor 1/2), and after the last pass, steps 3-4
//      run on what is held and the table is cleared. Any document length
//      and any cell width work in the same 24 KB of shared memory.
//   3. Order. The occupied slots are compacted into a list and, for f32
//      tables, bitonic-sorted by row: slot order after concurrent inserts
//      is not deterministic, the sorted order is, so two launches on the
//      same batch give bit-identical f32 scores. Integer sums are exact and
//      order-free, so integer tables skip the sort.
//   4. Gather. Every thread owns one (up to four) language columns and sums
//      count x wq[row, column] over the list with eight independent
//      accumulators, eight loads in flight per thread; a warp reads
//      consecutive columns of one table row, so the loads are coalesced.
//      f32 tables: f32 products summed in f32; int8/int16 tables: int32
//      products and sums (exact whenever the wrapper's windows x qmax
//      < 2^31 guard holds, since the counts sum to the windows).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace fused {

constexpr int kMaxInline = 8;
constexpr int kMaxColsPerThread = 4;
constexpr int kMaxThreads = 1024;
constexpr int kMaxLangs = kMaxThreads * kMaxColsPerThread;
constexpr int kSlotBits = 11;
constexpr int kSlots = 1 << kSlotBits;  // hash slots per block
constexpr int kMaxFill = kSlots / 2;    // distinct rows held before a flush
constexpr int kUnroll = 8;              // gather accumulators per column
constexpr int kPassWindows = 4;         // windows per thread in a pass
// A round inserts at most one new row per thread, so a flush before a
// round that could pass kMaxFill always leaves room for the round.
static_assert(kMaxFill >= kMaxThreads, "a round must fit into an empty table");

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

// One block's row counts. keys[s] is -1 for an empty slot; a list entry is
// (row << 32) | count.
struct RowCounts {
  int32_t keys[kSlots];
  uint32_t counts[kSlots];
  unsigned long long list[kMaxFill];
  int fill;
};

__device__ __forceinline__ void clear_counts(RowCounts& t, int tid, int nt) {
  for (int s = tid; s < kSlots; s += nt) {
    t.keys[s] = -1;
    t.counts[s] = 0;
  }
  if (tid == 0) t.fill = 0;
  __syncthreads();
}

// Step 1 for one window per thread; every thread of the block calls it
// (r < 0 where a thread has no window). Returns true to the thread whose
// insert claimed a new slot.
__device__ __forceinline__ bool insert_row(RowCounts& t, int r) {
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  if (r < 0 || static_cast<int>(threadIdx.x & 31) != __ffs(peers) - 1)
    return false;
  const uint32_t c = __popc(peers);
  volatile int32_t* keys = t.keys;
  unsigned s = (static_cast<uint32_t>(r) * 2654435761u) >> (32 - kSlotBits);
  for (;;) {
    int k = keys[s];
    if (k == -1) k = atomicCAS(&t.keys[s], -1, r);
    if (k == -1 || k == r) {
      atomicAdd(&t.counts[s], c);
      return k == -1;
    }
    s = (s + 1) & (kSlots - 1);  // never full: at most kMaxFill keys
  }
}

// Step 3's sort: ascending bitonic sort of list[0, p), p a power of two;
// every stage ends with a barrier.
__device__ __forceinline__ void sort_list(unsigned long long* list, int p,
                                          int tid, int nt) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < (p >> 1); q += nt) {
        const int i = 2 * q - (q & (j - 1));  // the pair (i, i + j)
        const unsigned long long a = list[i];
        const unsigned long long b = list[i + j];
        if ((a > b) == ((i & k) == 0)) {
          list[i] = b;
          list[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Step 4 over list[0, n) into this thread's columns (tid, tid + nt, ...).
template <typename T, typename A>
__device__ __forceinline__ void gather_rows(A (&acc)[kMaxColsPerThread],
                                            const unsigned long long* list,
                                            int n, const T* __restrict__ wq,
                                            int L, int tid, int nt) {
#pragma unroll
  for (int m = 0; m < kMaxColsPerThread; ++m) {
    const int c = tid + m * nt;
    if (c >= L) break;
    A a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = A(0);
    int i = 0;
    for (; i + kUnroll <= n; i += kUnroll) {
      T v[kUnroll];
      uint32_t k[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned long long e = list[i + u];
        k[u] = static_cast<uint32_t>(e);
        v[u] = wq[static_cast<size_t>(e >> 32) * L + c];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a[u] += static_cast<A>(k[u]) * static_cast<A>(v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < n) {
        const unsigned long long e = list[i + u];
        a[u] += static_cast<A>(static_cast<uint32_t>(e)) *
                static_cast<A>(wq[static_cast<size_t>(e >> 32) * L + c]);
      }
    }
    acc[m] += ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
  }
}

// Steps 3-4 on the n distinct rows held, then an empty table. Every thread
// calls it with the same n; it ends with a barrier.
template <typename T, typename A>
__device__ void flush_counts(RowCounts& t, A (&acc)[kMaxColsPerThread], int n,
                             const T* __restrict__ wq, int L, int tid, int nt) {
  if (n == 0) return;
  for (int s = tid; s < kSlots; s += nt) {
    const int k = t.keys[s];
    if (k >= 0) {
      t.list[atomicAdd(&t.fill, 1)] =
          (static_cast<unsigned long long>(k) << 32) | t.counts[s];
      t.keys[s] = -1;
      t.counts[s] = 0;
    }
  }
  if (std::is_same<T, float>::value) {
    int p = 1;
    while (p < n) p <<= 1;
    for (int i = n + tid; i < p; i += nt) t.list[i] = ~0ull;
    __syncthreads();
    sort_list(t.list, p, tid, nt);
  } else {
    __syncthreads();
  }
  gather_rows(acc, t.list, n, wq, L, tid, nt);
  __syncthreads();
  if (tid == 0) t.fill = 0;  // ordered before the next flush by a barrier
}

// Steps 1-2 for the nwin windows w = 0 .. nwin - 1 of one source, whose
// rows row_of(w) gives; `held` is the distinct-row count, equal in every
// thread. A pass computes the rows of kPassWindows windows per thread
// before it inserts any, so their loads are in flight together; then each
// round inserts one window per thread, after a flush if the round could
// take the table past kMaxFill.
template <typename T, typename A, typename RowOf>
__device__ __forceinline__ void count_windows(RowCounts& t, A (&acc)[kMaxColsPerThread],
                                              int& held, int nwin, RowOf row_of,
                                              const T* __restrict__ wq, int R,
                                              int L, int tid, int nt) {
  for (int base = 0; base < nwin; base += kPassWindows * nt) {
    int r[kPassWindows];
#pragma unroll
    for (int u = 0; u < kPassWindows; ++u) {
      const int w = base + u * nt + tid;
      r[u] = w < nwin ? row_of(w) : -1;
      if (static_cast<unsigned>(r[u]) >= static_cast<unsigned>(R)) r[u] = -1;
    }
#pragma unroll
    for (int u = 0; u < kPassWindows; ++u) {
      const int cnt = min(nt, nwin - base - u * nt);  // windows in the round
      if (cnt <= 0) break;
      if (held + cnt > kMaxFill) {
        flush_counts(t, acc, held, wq, L, tid, nt);
        held = 0;
      }
      held += __syncthreads_count(insert_row(t, r[u]));
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
  const int cols = (L + kMaxThreads - 1) / kMaxThreads;
  int threads = (L + cols - 1) / cols;
  threads = ((threads + 31) / 32) * 32;
  return threads < 64 ? 64 : threads;
}

}  // namespace fused
