// What the CUDA kernels of the port share: the count -> order -> gather
// core that the fused detect, fused segment and bigram score kernels run
// per block, and, for the two fused kernels, the inline window-id plan and
// its arithmetic, the accumulator type per table dtype and the launch
// geometry.
//
// The core, per block (one document, or one (document, cell)):
//   1. Count. A pass takes kPassWindows windows per thread and computes
//      their rows first, so their loads overlap. Inserts probe an
//      open-addressing table of kSlots (row -> uint32 count) with
//      atomicCAS/atomicAdd; rows outside [0, R) (masked windows) are
//      dropped first; where the table lists claims (RowCounts), the
//      thread that claims a slot appends it to the block's list. Every
//      lane inserts its own window: grouping a warp's equal rows with
//      __match_any_sync into one insert measured 4-19% slower for the
//      fused kernels (PERF.md). Two window orders, each the faster one
//      where it is used:
//        * strided (the fused kernels): thread t takes windows
//          base + u * nt + t, so a warp's loads are coalesced; in rounds of
//          one window per thread, each ending with one __syncthreads_count,
//          whose result (the rows new in the round) keeps every thread's
//          copy of the distinct-row count equal;
//        * blocked (the bigram score): thread t takes the kPassWindows
//          consecutive windows from base + kPassWindows * t, so it can read
//          their bytes in one wide load, and the pass ends with one barrier
//          behind which the warps' counts of new rows update the
//          distinct-row count; it needs kPassWindows * nt <= kMaxFill.
//   2. Flush. Before a round (or pass) that could take the table past
//      kMaxFill distinct rows (load factor 1/2), and after the last pass,
//      steps 3-4 run on what is held and the claimed slots are emptied.
//      Any document length and any cell width work in the same 25 KB of
//      shared memory.
//   3. Order. The held slots become (row << 32) | count entries and,
//      where the sums are floating point, are bitonic-sorted by row (the
//      stages within 64 entries in registers, through shuffles): slot and
//      claim order after concurrent inserts are not deterministic, the
//      sorted order is, so two launches on the same batch give
//      bit-identical f32 scores. Integer sums are exact and order-free, so
//      integer tables skip the sort.
//   4. Gather: a step of the kernel's own, handed the list. The fused
//      kernels' gather_rows gives every thread one (up to four) language
//      columns and sums count x wq[row, column] over the list with eight
//      independent accumulators, eight loads in flight per thread; a warp
//      reads consecutive columns of one table row, so the loads are
//      coalesced. f32 tables: f32 products summed in f32; int8/int16
//      tables: int32 products and sums (exact whenever the wrapper's
//      windows x qmax < 2^31 guard holds, since the counts sum to the
//      windows). The bigram score kernel gathers whole rows instead, one
//      list entry per thread (bigram_score.cu).

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
static_assert(kMaxFill % 64 == 0, "the sort's chunks tile the list");

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

// One block's row counts. keys[s] is -1 for an empty slot; a flush leaves
// list[0, n) holding the entries (row << 32) | count. With kListClaims the
// thread that claims a slot appends it to list[0, fill) while the block
// counts, so a flush visits only the claimed slots; without, a flush scans
// all kSlots. Listing pays where a block has few rounds per flush (a cell,
// a short document) and costs where it has many, since each append adds an
// atomic to its round: each kernel takes the one measured faster for it
// (PERF.md). new_rows[p & 1][w] is warp w's count of rows new in pass p of
// the blocked order.
template <bool kListClaims>
struct RowCounts {
  static constexpr bool list_claims = kListClaims;
  int32_t keys[kSlots];
  uint32_t counts[kSlots];
  unsigned long long list[kMaxFill];
  int fill;
  int new_rows[2][kMaxThreads / 32];
};

template <typename Table>
__device__ __forceinline__ void clear_counts(Table& t, int tid, int nt) {
  for (int s = tid; s < kSlots; s += nt) {
    t.keys[s] = -1;
    t.counts[s] = 0;
  }
  if (tid == 0) t.fill = 0;
  __syncthreads();
}

// A row's first probe slot.
__device__ __forceinline__ unsigned home_slot(int r) {
  return (static_cast<uint32_t>(r) * 2654435761u) >> (32 - kSlotBits);
}

// Step 1 for one window (r < 0 where the thread has none). Returns true to
// the thread whose insert claimed a new slot.
template <typename Table>
__device__ __forceinline__ bool insert_row(Table& t, int r) {
  if (r < 0) return false;
  volatile int32_t* keys = t.keys;
  unsigned s = home_slot(r);
  for (;;) {
    int k = keys[s];
    if (k == -1) k = atomicCAS(&t.keys[s], -1, r);
    if (k == -1 || k == r) {
      atomicAdd(&t.counts[s], 1u);
      if (Table::list_claims && k == -1) t.list[atomicAdd(&t.fill, 1)] = s;
      return k == -1;
    }
    s = (s + 1) & (kSlots - 1);  // never full: at most kMaxFill keys
  }
}

constexpr int kChunk = 64;  // sort entries a warp holds in registers

// The bitonic stages j = min(k1, kChunk) / 2 .. 1 of the steps k = k0 .. k1
// (powers of two) on every kChunk-entry chunk of list[0, p): a warp takes a
// chunk at a time, lane l holding its entries 2l and 2l + 1 in registers,
// so a stage needs shuffles or nothing, never a barrier. Ends with a
// barrier.
__device__ __forceinline__ void sort_chunks(unsigned long long* list, int p,
                                            int k0, int k1, int tid, int nt) {
  const int lane = tid & 31;
  for (int c = (tid >> 5) * kChunk; c < p; c += (nt >> 5) * kChunk) {
    const int i = c + 2 * lane;  // the lane's first entry
    unsigned long long a0 = list[i], a1 = list[i + 1];
    for (int k = k0; k <= k1; k <<= 1) {
      const bool up = (i & k) == 0;  // ascending run
      for (int j = min(k, kChunk) >> 1; j > 1; j >>= 1) {
        // Partners sit in lanes l and l ^ (j / 2); the one whose entry has
        // bit j clear is the lower of the pair.
        const unsigned long long b0 = __shfl_xor_sync(0xffffffffu, a0, j >> 1);
        const unsigned long long b1 = __shfl_xor_sync(0xffffffffu, a1, j >> 1);
        const bool keep_min = ((i & j) == 0) == up;
        a0 = keep_min ? min(a0, b0) : max(a0, b0);
        a1 = keep_min ? min(a1, b1) : max(a1, b1);
      }
      const unsigned long long lo = min(a0, a1), hi = max(a0, a1);  // j = 1
      a0 = up ? lo : hi;
      a1 = up ? hi : lo;
    }
    list[i] = a0;
    list[i + 1] = a1;
  }
  __syncthreads();
}

// Step 3's sort: ascending bitonic sort of list[0, p), p a power of two and
// at least kChunk. Stages of a step whose pairs lie within kChunk entries
// run in registers (sort_chunks); the wider ones pair entries through
// shared memory, one barrier each. Ends with a barrier.
__device__ __forceinline__ void sort_list(unsigned long long* list, int p,
                                          int tid, int nt) {
  sort_chunks(list, p, 2, kChunk, tid, nt);
  for (int k = 2 * kChunk; k <= p; k <<= 1) {
    for (int j = k >> 1; j >= kChunk; j >>= 1) {
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
    sort_chunks(list, p, k, k, tid, nt);
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

// Steps 3-4 on the n distinct rows held: turn the held slots into list
// entries and empty them, sort the list by row when `sort`, hand it to
// gather(list, n), and leave an empty table. Every thread calls it with the
// same n; it ends with a barrier.
template <typename Table, typename Gather>
__device__ void flush_counts(Table& t, int n, bool sort, int tid, int nt,
                             Gather gather) {
  if (n == 0) return;
  if (Table::list_claims) {
    for (int i = tid; i < n; i += nt) {
      const unsigned s = static_cast<unsigned>(t.list[i]);
      t.list[i] = (static_cast<unsigned long long>(t.keys[s]) << 32) | t.counts[s];
      t.keys[s] = -1;
      t.counts[s] = 0;
    }
  } else {
    for (int s = tid; s < kSlots; s += nt) {
      const int k = t.keys[s];
      if (k >= 0) {
        t.list[atomicAdd(&t.fill, 1)] =
            (static_cast<unsigned long long>(k) << 32) | t.counts[s];
        t.keys[s] = -1;
        t.counts[s] = 0;
      }
    }
  }
  int p = kChunk;
  if (sort) {
    while (p < n) p <<= 1;
    for (int i = n + tid; i < p; i += nt) t.list[i] = ~0ull;
  }
  __syncthreads();
  if (tid == 0) t.fill = 0;  // before the flush's last barrier, so before any insert
  if (sort) sort_list(t.list, p, tid, nt);
  gather(static_cast<const unsigned long long*>(t.list), n);
  __syncthreads();
}

// The fused kernels' flush: steps 3-4 into this thread's language columns,
// the list sorted for f32 tables only.
template <typename Table, typename T, typename A>
__device__ __forceinline__ auto column_flush(Table& t,
                                             A (&acc)[kMaxColsPerThread],
                                             const T* __restrict__ wq, int L,
                                             int tid, int nt) {
  return [&t, &acc, wq, L, tid, nt](int n) {
    flush_counts(t, n, std::is_same<T, float>::value, tid, nt,
                 [&](const unsigned long long* list, int m) {
                   gather_rows(acc, list, m, wq, L, tid, nt);
                 });
  };
}

// Steps 1-2 for nwin windows; `held` is the distinct-row count, equal in
// every thread, and flush(held) runs steps 3-4. Each pass, rows_of(base, r)
// computes this thread's kPassWindows rows (-1 where it has no window)
// before any is inserted, so their loads are in flight together.
//   * Strided order (kBlocked false): r[u] is window base + u * nt + tid.
//     Round u inserts r[u] of every thread, after a flush if the round's
//     windows could take the table past kMaxFill, and ends with a
//     __syncthreads_count of the rows new in it.
//   * Blocked order (kBlocked true): r[u] is window base + kPassWindows *
//     tid + u. The pass inserts all its windows after a flush if they could
//     take the table past kMaxFill (kPassWindows * nt <= kMaxFill), then
//     each warp's count of new rows, summed across the block behind one
//     barrier, updates `held`: one barrier a pass, not one a round.
template <bool kBlocked, typename Table, typename RowsOf, typename Flush>
__device__ __forceinline__ void count_passes(Table& t, int& held, int nwin,
                                             RowsOf rows_of, int R, int nt,
                                             Flush flush) {
  int parity = 0;
  for (int base = 0; base < nwin; base += kPassWindows * nt) {
    int r[kPassWindows];
    rows_of(base, r);
#pragma unroll
    for (int u = 0; u < kPassWindows; ++u)
      if (static_cast<unsigned>(r[u]) >= static_cast<unsigned>(R)) r[u] = -1;
    if (kBlocked) {
      if (held + min(kPassWindows * nt, nwin - base) > kMaxFill) {
        flush(held);
        held = 0;
      }
      int claimed = 0;
#pragma unroll
      for (int u = 0; u < kPassWindows; ++u) claimed += insert_row(t, r[u]);
      claimed = __reduce_add_sync(0xffffffffu, claimed);
      if ((threadIdx.x & 31) == 0) t.new_rows[parity][threadIdx.x >> 5] = claimed;
      __syncthreads();
      for (int w = 0; w < (nt >> 5); ++w) held += t.new_rows[parity][w];
      parity ^= 1;  // the next pass writes the other half while this is read
    } else {
#pragma unroll
      for (int u = 0; u < kPassWindows; ++u) {
        // Windows in the round: an upper bound of the rows it can add.
        const int cnt = min(nt, nwin - base - u * nt);
        if (cnt <= 0) break;
        if (held + cnt > kMaxFill) {
          flush(held);
          held = 0;
        }
        held += __syncthreads_count(insert_row(t, r[u]));
      }
    }
  }
}

// count_passes in the strided order for the windows w = 0 .. nwin - 1 of
// one source, whose rows row_of(w) gives.
template <typename Table, typename RowOf, typename Flush>
__device__ __forceinline__ void count_windows(Table& t, int& held, int nwin,
                                              RowOf row_of, int R, int tid,
                                              int nt, Flush flush) {
  count_passes<false>(
      t, held, nwin,
      [&](int base, int (&r)[kPassWindows]) {
#pragma unroll
        for (int u = 0; u < kPassWindows; ++u) {
          const int w = base + u * nt + tid;
          r[u] = w < nwin ? row_of(w) : -1;
        }
      },
      R, nt, flush);
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
