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
// Design. The TPU kernel builds a one-hot x one-hot histogram on the MXU
// because Mosaic cannot gather. Hopper gathers, so each block stages a
// window block's rows in shared memory, then every thread owns one (up to
// four) language columns and sums wq[row, l] over the staged rows: a warp
// reads consecutive columns of one row, so the loads are coalesced. f32
// tables accumulate in f32; int8/int16 tables accumulate in int32 (exact;
// the wrapper checks that windows x qmax < 2^31) and are scaled once per
// (document, language).
//
// What bounds it on the card. Each thread walks every staged row for its
// column, so the kernel issues one table load and one add per (window,
// language), a gram repeated in a document included. On an H100 the time
// is nearly flat across f32, int16 and int8 tables (chip_smoke.py phase 5,
// PERF.md), so the bytes gathered are not what limits it; which per-load
// cost does (issue rate, latency) has not been read from a profiler
// counter. The design does nothing about it yet: it only keeps the loads
// coalesced and each row id in shared memory. Counting repeated grams per
// document before touching the table (the histogram form the TPU kernel
// used), tensor-core contraction and L2 residency of the table are later
// work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxInline = 8;
constexpr int kStage = 1024;  // rows staged per window block
constexpr int kMaxColsPerThread = 4;

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

__device__ __forceinline__ void arg_better(float& bv, int& bi, float ov, int oi) {
  // First maximum wins: on equal scores the lower language index.
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
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

template <typename T>
__global__ void __launch_bounds__(1024) fused_detect_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim, const int32_t* __restrict__ prow,
    const int32_t* __restrict__ rows, const T* __restrict__ wq,
    const float* __restrict__ scales, float* __restrict__ scores,
    int32_t* __restrict__ labels, float* __restrict__ best, int S, int K,
    int W, int R, int L, InlinePlan plan) {
  using A = typename Accum<T>::type;
  __shared__ int32_t srow[kStage];
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

  // Inline lengths: owned window starts are s <= len - n and s < lim.
  const uint8_t* doc = bytes + static_cast<size_t>(b) * S;
  for (int j = 0; j < plan.count; ++j) {
    const int n = plan.n[j];
    const bool partial = len < n;
    const int nwin = partial ? (len > 0 ? 1 : 0) : max(0, min(len - n + 1, lm));
    for (int base = 0; base < nwin; base += kStage) {
      const int cnt = min(kStage, nwin - base);
      for (int i = tid; i < cnt; i += nt) {
        srow[i] = partial
                      ? prow[static_cast<size_t>(b) * plan.count + j]
                      : inline_row(doc + base + i, n, plan.kind[j], plan.p1[j],
                                   plan.p2[j]);
      }
      __syncthreads();
      accumulate(acc, srow, cnt, wq, R, L, tid, nt);
      __syncthreads();
    }
  }

  // Rows plane: K segments of W rows each. No window at or past len is
  // valid (full windows start <= len - n, the partial one at 0), so the
  // scan stops at len.
  for (int k = 0; k < K; ++k) {
    const int32_t* rp = rows + (static_cast<size_t>(b) * K + k) * W;
    const int nwin = min(W, len);
    for (int base = 0; base < nwin; base += kStage) {
      const int cnt = min(kStage, nwin - base);
      for (int i = tid; i < cnt; i += nt) srow[i] = rp[base + i];
      __syncthreads();
      accumulate(acc, srow, cnt, wq, R, L, tid, nt);
      __syncthreads();
    }
  }

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
  if (n_inline < 0 || n_inline > kMaxInline || B <= 0 || L <= 0 ||
      L > 1024 * kMaxColsPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  InlinePlan plan{};
  plan.count = n_inline;
  for (int j = 0; j < n_inline; ++j) {
    plan.n[j] = inline_n[j];
    plan.kind[j] = inline_kind[j];
    plan.p1[j] = inline_p1[j];
    plan.p2[j] = inline_p2[j];
  }
  const int cols = (L + 1023) / 1024;
  int threads = (L + cols - 1) / cols;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 64) threads = 64;
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
