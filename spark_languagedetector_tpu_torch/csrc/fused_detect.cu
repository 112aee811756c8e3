// Fused detect kernel for Hopper (sm_90a): window -> id -> row -> accumulate
// -> scale -> argmax, one thread block per document.
//
// Replaces the TPU kernel spark_languagedetector_tpu/ops/score_fused.py
// ::_build_fused_kernel (the pallas_call in _fused_call, reached through
// score_batch_fused and detect_batch_fused). It computes the same function:
// per document, every owned window of every gram length contributes one row
// of the (f32, int16 or int8) weight table; the sum is multiplied by the
// per-language scale; the detect variant takes the first maximum (an
// all-miss document scores all zeros and labels 0).
//
// Two input routes, as on the TPU:
//   * inline lengths: window ids are computed here from the byte plane —
//     POLY (exact polynomial id + offset), FNV_MASK (FNV-1a & mask) and
//     FNV_FOLD (exact12: base + FNV-1a % modulus). FNV-1a and the fold run
//     in native uint32 with an exact `%`; the TPU's float-quotient fold is
//     not needed. A document shorter than n contributes its one partial
//     window, whose row the wrapper precomputed (prow), regardless of the
//     window limit.
//   * rows plane: rows resolved through the LUT by the wrapper, -1 where a
//     window is masked.
//
// Design. The TPU kernel builds a per-document [rows/256 x 256] histogram
// from one-hot x one-hot products on the MXU, then contracts it with the
// table: Sum count x w[row]. This kernel keeps that function shape with
// Hopper's tools (fused_common.cuh): each block counts its document's
// windows per distinct row in a shared-memory hash table (warp-aggregated
// atomics), sorts the distinct rows (f32 tables), and reads each distinct
// row of the table once per flush, count x row into every language column,
// eight independent loads in flight per thread, coalesced along the row.
// f32 tables sum in f32 in the sorted order, so two launches give
// bit-identical scores; int8/int16 tables sum exactly in int32 (the wrapper
// checks that windows x qmax < 2^31) and are scaled once per (document,
// language).
//
// What bounds it on the card. The first design issued one dependent table
// load and one add per (window, language), a repeated gram included: 4.6 G
// loads on the config-5 batch, 3.3 ms whatever the table dtype. Now the
// table loads are distinct (document, row) pairs x L, 224 M there (a
// document repeats a row about 20 times), and the rest is per window: the
// row computation (four windows per thread computed before their inserts,
// so their loads overlap), one or two shared-memory atomics, one barrier
// per round of blockDim windows, and per flush a bitonic sort of up to
// kMaxFill rows. On an H100 that takes about 0.34 ms, some 9.5% of the
// bytes bound (chip_smoke.py, PERF.md); int8 and int16 tables, which
// gather a quarter and half the bytes and skip the sort, are only 15-21%
// faster, so the per-window counting and the latency of the gather's
// loads, not bytes, set the time. Which of the two weighs more is not
// measured: no profiler counters are read on the card.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

__device__ __forceinline__ void arg_better(float& bv, int& bi, float ov, int oi) {
  // First maximum wins: on equal scores the lower language index.
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

template <typename T>
__global__ void __launch_bounds__(1024) fused_detect_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ rows, const T* __restrict__ wq,
    const float* __restrict__ scales, float* __restrict__ scores,
    int32_t* __restrict__ labels, float* __restrict__ best, int S, int K,
    int W, int R, int L, InlinePlan plan) {
  using A = typename Accum<T>::type;
  __shared__ RowCounts<false> counts;  // scans: listing measured slower here
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = lengths[b];
  const int lm = lim[b];

  A acc[kMaxColsPerThread];
#pragma unroll
  for (int m = 0; m < kMaxColsPerThread; ++m) acc[m] = A(0);
  clear_counts(counts, tid, nt);
  int held = 0;  // distinct rows in the table, the same in every thread
  const auto flush = column_flush(counts, acc, wq, L, tid, nt);

  // Inline lengths: owned window starts are s <= len - n and s < lim.
  const uint8_t* doc = bytes + static_cast<size_t>(b) * S;
  for (int j = 0; j < plan.count; ++j) {
    const int n = plan.n[j];
    const bool partial = len < n;
    const int nwin = partial ? (len > 0 ? 1 : 0) : max(0, min(len - n + 1, lm));
    const int pr = partial ? prow[static_cast<size_t>(b) * plan.count + j] : -1;
    const int kind = plan.kind[j];
    const uint32_t p1 = plan.p1[j], p2 = plan.p2[j];
    count_windows(counts, held, nwin, [=](int w) {
      return partial ? pr : inline_row(doc + w, n, kind, p1, p2);
    }, R, tid, nt, flush);
  }

  // Rows plane: K segments of W rows each. No window at or past len is
  // valid (full windows start <= len - n, the partial one at 0), so the
  // scan stops at len.
  for (int k = 0; k < K; ++k) {
    const int32_t* rp = rows + (static_cast<size_t>(b) * K + k) * W;
    count_windows(counts, held, min(W, len), [=](int w) { return rp[w]; }, R,
                  tid, nt, flush);
  }
  flush(held);

  // Epilogue: scale once per (document, language); scores and/or argmax.
  float bv = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int m = 0; m < kMaxColsPerThread; ++m) {
    const int c = tid + m * nt;
    if (c < L) {
      const float v = static_cast<float>(acc[m]) * scales[c];
      if (scores != nullptr) scores[static_cast<size_t>(b) * L + c] = v;
      arg_better(bv, bi, v, c);
    }
  }
  if (labels == nullptr) return;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    arg_better(bv, bi, ov, oi);
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    bv = lane < nw ? red_v[lane] : -INFINITY;
    bi = lane < nw ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      arg_better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      labels[b] = bi;
      best[b] = bv;
    }
  }
}

template <typename T>
void launch(dim3 grid, int threads, cudaStream_t stream, const void* bytes,
            const void* lengths, const void* lim, const void* prow,
            const void* rows, const void* wq, const void* scales, void* scores,
            void* labels, void* best, int S, int K, int W, int R, int L,
            const InlinePlan& plan) {
  fused_detect_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(lim), static_cast<const int32_t*>(prow),
      static_cast<const int32_t*>(rows), static_cast<const T*>(wq),
      static_cast<const float*>(scales), static_cast<float*>(scores),
      static_cast<int32_t*>(labels), static_cast<float*>(best), S, K, W, R, L,
      plan);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8. Returns cudaGetLastError() after
// the launch (0 on success). scores may be null (detect only); labels and
// best are both null (scores only) or both set.
extern "C" int fused_detect_launch(
    const void* bytes, const void* lengths, const void* lim, const void* prow,
    const void* rows, const void* wq, const void* scales, void* scores,
    void* labels, void* best, int B, int S, int K, int W, int R, int L,
    int dtype, int n_inline, const int* inline_n, const int* inline_kind,
    const unsigned int* inline_p1, const unsigned int* inline_p2,
    void* stream) {
  InlinePlan plan;
  if (B <= 0 || L <= 0 || L > kMaxLangs ||
      !make_plan(plan, n_inline, inline_n, inline_kind, inline_p1, inline_p2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_threads(L);
  const dim3 grid(static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(grid, threads, s, bytes, lengths, lim, prow, rows, wq,
                    scales, scores, labels, best, S, K, W, R, L, plan);
      break;
    case 1:
      launch<int16_t>(grid, threads, s, bytes, lengths, lim, prow, rows, wq,
                      scales, scores, labels, best, S, K, W, R, L, plan);
      break;
    case 2:
      launch<int8_t>(grid, threads, s, bytes, lengths, lim, prow, rows, wq,
                     scales, scores, labels, best, S, K, W, R, L, plan);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
