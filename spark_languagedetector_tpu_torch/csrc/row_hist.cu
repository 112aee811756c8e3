// Row histogram kernel for Hopper (sm_90a): per-document counts of compact
// weight-row ids, one thread block per document.
//
// Replaces the TPU kernel spark_languagedetector_tpu/ops/score_hist.py
// ::_build_kernel (the pallas_call in _hist_from_rows, reached through
// score_batch_hist). The function:
//
//   out[b, r] = #{ w : segment-local start of w < vmax[b], rows[b, w] == r }
//
// over the rows plane [B, K*W] (K per-length segments of width W), for every
// r in [0, R) except the miss row `miss`, which stays 0; a row outside
// [0, R) is not counted either. The TPU kernel counts the miss row too, but
// how many depends on its block granularity (a skipped block drops its miss
// windows); the miss row's weight is zero, so the scores do not depend on
// it, and here it is simply not part of the function. Counts are exact
// integers, returned as float32 [B, R] for the hist @ W contraction that
// follows (ops/score_hist.py).
//
// Design. The TPU kernel builds the histogram as a one-hot(hi) x one-hot(lo)
// product on the MXU, because Mosaic has no scatter. Hopper has
// shared-memory atomics, so each window is one atomicAdd into the block's
// own histogram:
//   * R * 4 bytes fit shared memory (R <= 58,112 rows, 227 KB): counts live
//     in dynamic shared memory as uint32 and are written out once, coalesced;
//   * otherwise (a large LUT profile, e.g. 136k rows) the block zeroes its
//     own output row and adds float 1.0s into it with global atomics, exact
//     below 2^24 counts per entry (the wrapper checks K*W < 2^24).
// Skipping the miss row removes the worst atomic contention: every masked
// window and every padded tail points at it.
//
// What bounds it on the card: the output. A document writes R floats (about
// 200 KB at R = 51,200) and reads K*W row ids; the histogram work is one
// shared atomic per counted window. Not measured with a profiler counter.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the H100 block maximum

__device__ __forceinline__ bool counted(int r, int R, int miss) {
  return static_cast<unsigned>(r) < static_cast<unsigned>(R) && r != miss;
}

__global__ void __launch_bounds__(kThreads) row_hist_shared(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ vmax,
    float* __restrict__ out, int K, int W, int R, int miss) {
  extern __shared__ uint32_t cnt[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < R; i += kThreads) cnt[i] = 0u;
  __syncthreads();
  const int vm = min(max(vmax[b], 0), W);
  const int32_t* rp = rows + static_cast<size_t>(b) * K * W;
  for (int k = 0; k < K; ++k) {
    const int32_t* seg = rp + static_cast<size_t>(k) * W;
    for (int w = tid; w < vm; w += kThreads) {
      const int r = seg[w];
      if (counted(r, R, miss)) atomicAdd(&cnt[r], 1u);
    }
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(b) * R;
  for (int i = tid; i < R; i += kThreads) o[i] = static_cast<float>(cnt[i]);
}

__global__ void __launch_bounds__(kThreads) row_hist_global(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ vmax,
    float* __restrict__ out, int K, int W, int R, int miss) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float* o = out + static_cast<size_t>(b) * R;
  for (int i = tid; i < R; i += kThreads) o[i] = 0.0f;
  // Only this block touches row b of the output, so a block barrier orders
  // the zeroing before the atomics.
  __syncthreads();
  const int vm = min(max(vmax[b], 0), W);
  const int32_t* rp = rows + static_cast<size_t>(b) * K * W;
  for (int k = 0; k < K; ++k) {
    const int32_t* seg = rp + static_cast<size_t>(k) * W;
    for (int w = tid; w < vm; w += kThreads) {
      const int r = seg[w];
      if (counted(r, R, miss)) atomicAdd(&o[r], 1.0f);
    }
  }
}

}  // namespace

// rows int32 [B, K*W], vmax int32 [B], out float32 [B, R]. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int row_hist_launch(const void* rows, const void* vmax, void* out,
                               int B, int K, int W, int R, int miss,
                               void* stream) {
  if (B <= 0 || K <= 0 || W <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(R) * sizeof(uint32_t);
  if (smem <= static_cast<size_t>(kMaxSharedBytes)) {
    cudaError_t e = cudaFuncSetAttribute(
        row_hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    row_hist_shared<<<grid, kThreads, smem, s>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(vmax),
        static_cast<float*>(out), K, W, R, miss);
  } else {
    row_hist_global<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(vmax),
        static_cast<float*>(out), K, W, R, miss);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
