// Bigram histogram kernel for Hopper (sm_90a): per-document byte-pair
// counts [256, 256], two thread blocks per document.
//
// Replaces the TPU kernel spark_languagedetector_tpu/ops/score_pallas.py
// ::_build_hist_kernel (the pallas_call in _hist_batch, reached through
// score_batch_pallas for more than 16 languages and the hybrid strategy's
// n <= 2 part). The function, the same as the TPU kernel's:
//
//   out[b, b0 * 256 + b1] = #{ s : s <= len[b] - mask_n, s < lim[b],
//                                  bytes[b, s] == b0, next(b, s) == b1 }
//
// where next(b, s) is bytes[b, s + 1], or 0 past the padded width (the
// batch is zero-padded, as the TPU kernel's shifted plane is). mask_n is 2
// for bigram vocabs and 1 for unigram-only ones (a row sum of the histogram
// then gives the unigram counts). Counts are exact, returned as float32
// [B, 65536] for the hist @ w2 contraction that follows.
//
// Design. The TPU kernel accumulates one-hot(b0)^T x one-hot(b1) on the MXU
// because Mosaic has no scatter; here each window is one shared-memory
// atomicAdd. 65,536 uint32 counts (256 KB) do not fit one block's 227 KB,
// so the first byte's range is split over two blocks (blockIdx.y): each
// holds 128 x 256 uint32 counts (128 KB), scans the whole document and
// counts the windows whose first byte falls in its half. uint32 counts
// cannot overflow at any document width.
//
// What bounds it on the card: the output, 256 KB per document against a
// few KB of bytes read; not measured with a profiler counter.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kHalf = 128 * 256;  // counts per block

__global__ void __launch_bounds__(kThreads) bigram_hist_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim, float* __restrict__ out, int S,
    int mask_n) {
  extern __shared__ uint32_t cnt[];
  const int b = blockIdx.x;
  const int half = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < kHalf; i += kThreads) cnt[i] = 0u;
  __syncthreads();
  // Counted starts: s <= len - mask_n and s < lim.
  const int nwin = max(0, min(lengths[b] - mask_n + 1, min(lim[b], S)));
  const uint8_t* doc = bytes + static_cast<size_t>(b) * S;
  for (int s = tid; s < nwin; s += kThreads) {
    const int b0 = doc[s];
    if ((b0 >> 7) != half) continue;
    const int b1 = s + 1 < S ? doc[s + 1] : 0;
    atomicAdd(&cnt[(b0 & 127) * 256 + b1], 1u);
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(b) * 65536 + half * kHalf;
  for (int i = tid; i < kHalf; i += kThreads) o[i] = static_cast<float>(cnt[i]);
}

}  // namespace

// bytes uint8 [B, S], lengths and lim int32 [B], out float32 [B, 65536].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bigram_hist_launch(const void* bytes, const void* lengths,
                                  const void* lim, void* out, int B, int S,
                                  int mask_n, void* stream) {
  if (B <= 0 || S <= 0 || (mask_n != 1 && mask_n != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kHalf * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bigram_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(B), 2);
  bigram_hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(lim), static_cast<float*>(out), S, mask_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
