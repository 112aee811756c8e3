// Fused segment kernel for Hopper (sm_90a): window -> id -> row -> accumulate
// -> scale, one sum per cell, one thread block per (document, cell).
//
// Replaces the TPU kernel spark_languagedetector_tpu/ops/score_fused.py
// ::_build_fused_segment_kernel (the pallas_call in _fused_segment_call,
// reached through segment_batch_fused). It computes the same function: a
// cell is a span of `cell` consecutive window START positions; out[b, c, :]
// is the sum of the weight-table rows of every counted window of every gram
// length whose start lies in [c*cell, (c+1)*cell), times the per-language
// scale. The counting rules are the whole-document kernel's
// (fused_detect.cu), per cell:
//   * inline lengths: ids computed here from the bytes; the window at start
//     s counts when s <= len - n and s < lim;
//   * a document with 0 < len < n contributes its one partial window, whose
//     row the wrapper precomputed (prow), in cell 0, regardless of lim;
//   * rows plane: rows resolved through the LUT by the wrapper, -1 where a
//     window is masked; position i of a segment belongs to cell i / cell;
//   * a cell that starts at or past len or lim is all zeros, so an empty or
//     all-miss document is all zeros.
//
// The kernel writes every element of out[B, C, L], the zeros of skipped
// cells included, so the wrapper allocates the output without clearing it.
// S need not be a multiple of cell and W need not reach a cell's end: the
// last cell's block stops at the document's end, at S, and at W.
//
// Design. As in fused_detect.cu, the block runs the count -> order ->
// gather core of fused_common.cuh, here per (document, cell): it counts the
// cell's windows per distinct row in shared memory, sorts the distinct
// rows (f32 tables) and reads each distinct row of the table once per
// flush, count x row into every language column, the loads coalesced along
// a table row. f32 tables sum in f32 in the sorted order (two launches
// give bit-identical cells); int8/int16 tables sum exactly in int32 (the
// wrapper checks that lengths x cell x qmax < 2^31) and are scaled once
// per (document, cell, language). A cell of 256 starts holds at most
// 256 x lengths windows, 1,280 at five lengths; one of more distinct rows
// than the table holds flushes, so any cell width works. The TPU kernel's
// one-hot histogram on the MXU, its (8, 128) padding, document blocks and
// streamed table tiles are that machine's way and are not carried over.
//
// What bounds it on the card. The first design issued one table load and
// one add per (window, language), a gram repeated in a cell included.
// Now the table loads are distinct (document, cell, row) triples x L (a
// cell repeats a row about 8 times on the config-5 batch), and the rest is
// per window (row computation, one or two shared-memory atomics, a barrier
// per round) and per block: clearing the 2,048 slots once, then compacting
// the claimed slots and sorting the rows, which a cell of about 1,200
// windows and 150 distinct rows pays in full. On an H100 that takes about
// 0.75 ms, some 5% of the bytes bound (chip_smoke.py, PERF.md); integer
// tables are 15-19% faster.
// Cells past a document's end cost one block that writes L zeros.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fused_common.cuh"

namespace {

using namespace fused;

template <typename T>
__global__ void __launch_bounds__(1024) fused_segment_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ rows, const T* __restrict__ wq,
    const float* __restrict__ scales, float* __restrict__ out, int S, int cell,
    int C, int K, int W, int R, int L, InlinePlan plan) {
  using A = typename Accum<T>::type;
  __shared__ RowCounts<true> counts;  // lists: scanning measured slower here

  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = lengths[b];
  const int lm = lim[b];
  const int off = c * cell;  // the cell's first window start
  float* dst = out + (static_cast<size_t>(b) * C + c) * L;

  // No window of this cell starts inside the document's owned range.
  if (off >= len || off >= lm) {
#pragma unroll
    for (int m = 0; m < kMaxColsPerThread; ++m) {
      const int col = tid + m * nt;
      if (col < L) dst[col] = 0.0f;
    }
    return;
  }

  A acc[kMaxColsPerThread];
#pragma unroll
  for (int m = 0; m < kMaxColsPerThread; ++m) acc[m] = A(0);
  clear_counts(counts, tid, nt);
  int held = 0;  // distinct rows in the table, the same in every thread
  const auto flush = column_flush(counts, acc, wq, L, tid, nt);

  // Inline lengths: the cell's owned window starts are off <= s < end with
  // end = min(off + cell, len - n + 1, lim). A document shorter than n has
  // its one partial window in cell 0.
  const uint8_t* doc = bytes + static_cast<size_t>(b) * S + off;
  for (int j = 0; j < plan.count; ++j) {
    const int n = plan.n[j];
    const bool partial = len < n;
    const int nwin = partial ? (c == 0 ? 1 : 0)
                             : max(0, min(min(off + cell, lm), len - n + 1) - off);
    const int pr = partial ? prow[static_cast<size_t>(b) * plan.count + j] : -1;
    const int kind = plan.kind[j];
    const uint32_t p1 = plan.p1[j], p2 = plan.p2[j];
    count_windows(counts, held, nwin, [=](int w) {
      return partial ? pr : inline_row(doc + w, n, kind, p1, p2);
    }, R, tid, nt, flush);
  }

  // Rows plane: K segments of W rows each; the cell's entries are positions
  // off <= i < min(off + cell, W, len) (no window at or past len is valid).
  for (int k = 0; k < K; ++k) {
    const int32_t* rp = rows + (static_cast<size_t>(b) * K + k) * W + off;
    const int nwin = max(0, min(min(off + cell, W), len) - off);
    count_windows(counts, held, nwin, [=](int w) { return rp[w]; }, R, tid, nt,
                  flush);
  }
  flush(held);

  // Epilogue: scale once per (document, cell, language).
#pragma unroll
  for (int m = 0; m < kMaxColsPerThread; ++m) {
    const int col = tid + m * nt;
    if (col < L) dst[col] = static_cast<float>(acc[m]) * scales[col];
  }
}

template <typename T>
void launch(dim3 grid, int threads, cudaStream_t stream, const void* bytes,
            const void* lengths, const void* lim, const void* prow,
            const void* rows, const void* wq, const void* scales, void* out,
            int S, int cell, int C, int K, int W, int R, int L,
            const InlinePlan& plan) {
  fused_segment_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(lim), static_cast<const int32_t*>(prow),
      static_cast<const int32_t*>(rows), static_cast<const T*>(wq),
      static_cast<const float*>(scales), static_cast<float*>(out), S, cell, C,
      K, W, R, L, plan);
}

}  // namespace

// dtype: 0 = float32, 1 = int16, 2 = int8. out is f32 [B, C, L] with
// C = ceil(S / cell). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int fused_segment_launch(
    const void* bytes, const void* lengths, const void* lim, const void* prow,
    const void* rows, const void* wq, const void* scales, void* out, int B,
    int S, int cell, int C, int K, int W, int R, int L, int dtype,
    int n_inline, const int* inline_n, const int* inline_kind,
    const unsigned int* inline_p1, const unsigned int* inline_p2,
    void* stream) {
  InlinePlan plan;
  if (B <= 0 || L <= 0 || L > kMaxLangs || cell <= 0 || C <= 0 ||
      static_cast<long long>(C) * cell < S ||
      static_cast<long long>(B) * C > 2147483647LL ||
      !make_plan(plan, n_inline, inline_n, inline_kind, inline_p1, inline_p2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block_threads(L);
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(grid, threads, s, bytes, lengths, lim, prow, rows, wq,
                    scales, out, S, cell, C, K, W, R, L, plan);
      break;
    case 1:
      launch<int16_t>(grid, threads, s, bytes, lengths, lim, prow, rows, wq,
                      scales, out, S, cell, C, K, W, R, L, plan);
      break;
    case 2:
      launch<int8_t>(grid, threads, s, bytes, lengths, lim, prow, rows, wq,
                     scales, out, S, cell, C, K, W, R, L, plan);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
