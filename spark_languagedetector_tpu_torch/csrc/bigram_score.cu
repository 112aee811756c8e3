// Bigram score kernel for Hopper (sm_90a): unigram + bigram scores of up to
// 16 languages, one thread block per document.
//
// Replaces the TPU kernel spark_languagedetector_tpu/ops/score_pallas.py
// ::_build_kernel (:119; its pallas_call is at :366 in score_batch_pallas,
// for at most MAX_PALLAS_LANGS = 16 languages, reached by the pallas
// strategy and the hybrid strategy's n <= 2 part). The function, the same
// as the TPU kernel's:
//
//   out[b, l] = has2 * sum_{s <= len-2, s < lim} w2[bytes[s]*256 + bytes[s+1], l]
//             + has1 * sum_{s <= len-1, s < lim} w1[bytes[s], l]
//
// (the 1-byte partial-window correction is the wrapper's, as on the TPU).
//
// Design: count first, contract once, as the TPU kernel does with its
// [256, 256] bigram histogram in scratch, here with the count -> order ->
// gather core of fused_common.cuh, 128 threads a block.
//   1. Count. One key per window: b0 * 256 + b1 when has2 (windows
//      s < min(len - 1, lim)), else b0 (has1 alone, s < min(len, lim)).
//      The blocked window order gives each thread four consecutive windows
//      a pass, whose five bytes come from one 4-byte load and one byte
//      (byte loads where the batch is not 4-byte aligned), loaded one pass
//      ahead. A pass inserts its 512 windows into the shared-memory hash
//      table and ends in one barrier. The table flushes at kMaxFill keys,
//      so any length fits.
//   2. Order. The claimed keys are compacted and bitonic-sorted, the stages
//      within 64 entries in registers.
//   3. Gather, a row per list entry: thread i takes entries i, i + 128, ...
//      and adds count x w2[key] (has2) and count x w1[key >> 8] (has1 with
//      has2) or count x w1[key] (has1 alone) into L register sums, each row
//      read with the widest aligned vector loads its layout allows (float4
//      where L % 4 == 0, float2 where L is even, else scalars).
//   4. The last byte's unigram window (below); then each warp halves its
//      16 sums per lane in five shuffle steps, so lanes 2l and 2l + 1 hold
//      language l's warp sum, and thread l adds the warps' sums in order.
// The sorted list, the fixed entry-to-thread assignment and the fixed
// reduction tree make two launches on the same batch bit-identical.
//
// Why the unigram fold is exact. With has1 and has2 the unigram windows are
// s < n1 = min(len, lim), the bigram windows s < n2 = min(len - 1, lim), and
// a window's first byte is the same in both. So the unigram histogram is the
// bigram histogram's row sum (each bigram key contributes its count to byte
// key >> 8) plus the one start n2 <= s < n1, which exists exactly when
// len >= 1 and len - 1 < lim: the last byte, added once by thread 0. This
// is _score_from_hist's rule (score_pallas.py). One insert per window
// serves both parts, and w1 is read per distinct key, never staged.
//
// Tolerance class: the same function in another summation order (count x
// row per distinct key, not per window), so scores agree with the plain
// version and the TPU kernel within the reduction-order tolerance
// (atol 1e-4, rtol 1e-5), not bit for bit.
//
// What bounds it on the card. The first design read one w2 row (L scalar
// loads, divergent across a warp) and one staged w1 row per counted window,
// after staging all of w1 in every block: about 11 times the row reads the
// function needs on the config-3 batch. Now a row is read once per distinct
// (document, key) pair, and what is left is per window, the count step's
// shared-memory probe and atomics, and per block the clear, compaction and
// sort of its keys. On an H100 the config-3 batch (832 documents, about
// 2,000 windows and 184 distinct keys each) runs as one wave of blocks, so
// a block's latency is the kernel's time: about 0.023 ms, some 2% of a
// bound that is itself smaller than one empty launch (chip_smoke.py,
// PERF.md). The fused kernels' strided window order measured a third
// slower here.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

constexpr int kThreads = 128;
constexpr int kMaxPallasLangs = 16;
constexpr int kWarps = kThreads / 32;
static_assert(kPassWindows * kThreads <= kMaxFill, "a pass must fit into an empty table");
static_assert(kMaxPallasLangs == 16, "the warp reduction halves 16 sums five times");

// acc[l] += c * row[l] for l < L, V floats a load (row V-float aligned).
template <int V>
__device__ __forceinline__ void add_row(float (&acc)[kMaxPallasLangs],
                                        const float* __restrict__ row, float c,
                                        int L) {
#pragma unroll
  for (int v = 0; v < kMaxPallasLangs / V; ++v) {
    if (v * V >= L) break;
    if constexpr (V == 4) {
      const float4 x = reinterpret_cast<const float4*>(row)[v];
      acc[4 * v] += c * x.x;
      acc[4 * v + 1] += c * x.y;
      acc[4 * v + 2] += c * x.z;
      acc[4 * v + 3] += c * x.w;
    } else if constexpr (V == 2) {
      const float2 x = reinterpret_cast<const float2*>(row)[v];
      acc[2 * v] += c * x.x;
      acc[2 * v + 1] += c * x.y;
    } else {
      acc[v] += c * row[v];
    }
  }
}

// One step of the warp reduction over the first N sums of each lane: lanes
// whose `off` bit is set keep the upper N / 2 sums, the others the lower
// N / 2, each adding the partner lane's (lane ^ off) sums of the same half.
template <int N>
__device__ __forceinline__ void halve(float (&v)[kMaxPallasLangs], int lane, int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The keys of this thread's windows in a pass (the blocked order): windows
// p .. p + 3, so bytes p .. p + 4, a byte read only where it lies inside
// the document; -1 past the last window. Each call also starts the next
// pass's loads, which are in flight while this pass inserts.
struct PassKeys {
  const uint8_t* doc;
  int len, nwin, tid, has2, wide;
  uint32_t word = 0, next = 0;  // bytes p .. p + 3 and p + 4 of the loaded pass

  __device__ __forceinline__ void load(int base) {
    const int p = base + kPassWindows * tid;
    if (wide && p < nwin) {
      // p and S are multiples of 4 and p < len, so p + 3 < S.
      word = *reinterpret_cast<const uint32_t*>(doc + p);
    } else {
      word = 0;
#pragma unroll
      for (int i = 0; i < kPassWindows; ++i)
        word |= (p + i < len ? static_cast<uint32_t>(doc[p + i]) : 0u) << (8 * i);
    }
    next = p + kPassWindows < len ? doc[p + kPassWindows] : 0u;
  }

  __device__ __forceinline__ void operator()(int base, int (&r)[kPassWindows]) {
    if (base == 0) load(0);
    const int p = base + kPassWindows * tid;
    uint32_t c[kPassWindows + 1];
#pragma unroll
    for (int i = 0; i < kPassWindows; ++i) c[i] = (word >> (8 * i)) & 0xffu;
    c[kPassWindows] = next;
    load(base + kPassWindows * kThreads);
#pragma unroll
    for (int u = 0; u < kPassWindows; ++u)
      r[u] = p + u < nwin ? static_cast<int>(has2 ? c[u] * 256u + c[u + 1] : c[u]) : -1;
  }
};

template <int V>
__global__ void __launch_bounds__(kThreads) bigram_score_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim, const float* __restrict__ w1,
    const float* __restrict__ w2, float* __restrict__ out, int S, int L,
    int has1, int has2, int wide) {
  __shared__ RowCounts<true> counts;
  __shared__ float red[kWarps][kMaxPallasLangs];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  const int len = max(0, min(lengths[b], S));
  const int lm = min(lim[b], S);
  // One key per window: bigram windows when has2, else unigram windows.
  const int nwin = has2 ? max(0, min(len - 1, lm)) : has1 ? max(0, min(len, lm)) : 0;
  const uint8_t* doc = bytes + static_cast<size_t>(b) * S;

  float acc[kMaxPallasLangs];
#pragma unroll
  for (int l = 0; l < kMaxPallasLangs; ++l) acc[l] = 0.0f;

  if (nwin > 0) {
    clear_counts(counts, tid, kThreads);
    int held = 0;
    const auto flush = [&](int n) {
      flush_counts(counts, n, true, tid, kThreads,
                   [&](const unsigned long long* list, int m) {
                     for (int i = tid; i < m; i += kThreads) {
                       const unsigned long long e = list[i];
                       const int key = static_cast<int>(e >> 32);
                       const float c = static_cast<float>(static_cast<uint32_t>(e));
                       if (has2) add_row<V>(acc, w2 + static_cast<size_t>(key) * L, c, L);
                       if (has1)
                         add_row<V>(acc, w1 + static_cast<size_t>(has2 ? key >> 8 : key) * L,
                                    c, L);
                     }
                   });
    };
    count_passes<true>(counts, held, nwin, PassKeys{doc, len, nwin, tid, has2, wide},
                       has2 ? 65536 : 256, kThreads, flush);
    flush(held);
  }
  // The last byte's unigram window, which no bigram key holds.
  if (tid == 0 && has1 && has2 && len >= 1 && len - 1 < lm)
    add_row<1>(acc, w1 + static_cast<size_t>(doc[len - 1]) * L, 1.0f, L);

  // Warp sums: four halving steps and one exchange leave lanes 2l and
  // 2l + 1 with language l's sum (l = lane / 2); then the warps' sums are
  // added in warp order.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  halve<16>(acc, lane, 16);
  halve<8>(acc, lane, 8);
  halve<4>(acc, lane, 4);
  halve<2>(acc, lane, 2);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
  if ((lane & 1) == 0 && (lane >> 1) < L) red[warp][lane >> 1] = acc[0];
  __syncthreads();
  if (tid < L) {
    float v = red[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][tid];
    out[static_cast<size_t>(b) * L + tid] = v;
  }
}

}  // namespace

// bytes uint8 [B, S], lengths and lim int32 [B], w1 float32 [256, L], w2
// float32 [65536, L], out float32 [B, L]. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int bigram_score_launch(const void* bytes, const void* lengths,
                                   const void* lim, const void* w1,
                                   const void* w2, void* out, int B, int S,
                                   int L, int has1, int has2, void* stream) {
  if (B <= 0 || S <= 0 || L <= 0 || L > kMaxPallasLangs)
    return static_cast<int>(cudaErrorInvalidValue);
  // Rows of L floats are read V floats a load where L and both tables'
  // addresses allow it; documents 4 bytes a load where S and the batch do.
  const uintptr_t tables = reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  const int V = (L % 4 == 0 && tables % 16 == 0) ? 4 : (L % 2 == 0 && tables % 8 == 0) ? 2 : 1;
  const int wide = ((reinterpret_cast<uintptr_t>(bytes) | static_cast<uintptr_t>(S)) & 3) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bp = static_cast<const uint8_t*>(bytes);
  const int32_t* lp = static_cast<const int32_t*>(lengths);
  const int32_t* mp = static_cast<const int32_t*>(lim);
  const float* w1p = static_cast<const float*>(w1);
  const float* w2p = static_cast<const float*>(w2);
  float* op = static_cast<float*>(out);
  if (V == 4)
    bigram_score_kernel<4><<<B, kThreads, 0, s>>>(bp, lp, mp, w1p, w2p, op, S, L, has1,
                                                  has2, wide);
  else if (V == 2)
    bigram_score_kernel<2><<<B, kThreads, 0, s>>>(bp, lp, mp, w1p, w2p, op, S, L, has1,
                                                  has2, wide);
  else
    bigram_score_kernel<1><<<B, kThreads, 0, s>>>(bp, lp, mp, w1p, w2p, op, S, L, has1,
                                                  has2, wide);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
