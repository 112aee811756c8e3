// Bigram score kernel for Hopper (sm_90a): unigram + bigram scores of up to
// 16 languages, one thread block per document.
//
// Replaces the TPU kernel spark_languagedetector_tpu/ops/score_pallas.py
// ::_build_kernel (the fused pallas_call of score_batch_pallas for at most
// MAX_PALLAS_LANGS = 16 languages, reached by the pallas strategy and the
// hybrid strategy's n <= 2 part). The function, the same as the TPU
// kernel's:
//
//   out[b, l] = has2 * sum_{s <= len-2, s < lim} w2[bytes[s]*256 + bytes[s+1], l]
//             + has1 * sum_{s <= len-1, s < lim} w1[bytes[s], l]
//
// (the 1-byte partial-window correction is the wrapper's, as on the TPU).
//
// Design. The TPU kernel builds the [256, 256] bigram histogram on the MXU
// and contracts it with w2 [L, 256, 256] per language. Here each window
// adds its weight rows directly: w2 is laid out [65536, L], so a bigram
// window reads L consecutive floats (64 bytes at L = 16; the 4 MB table
// stays in L2), and w1 [256, L] is staged in shared memory. Each thread
// keeps L running sums in registers over its strided windows; a warp
// shuffle and a shared-memory pass reduce them per document.
//
// Tolerance class: the same function in another summation order
// (per-window sums, not histogram x weight), so scores agree with the plain
// version and the TPU kernel within the reduction-order tolerance
// (atol 1e-4, rtol 1e-5), not bit for bit.
//
// What bounds it on the card: one gathered row read (L floats) per counted
// window, served from L2; not measured with a profiler counter.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLangs = 16;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) bigram_score_kernel(
    const uint8_t* __restrict__ bytes, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ lim, const float* __restrict__ w1,
    const float* __restrict__ w2, float* __restrict__ out, int S, int L,
    int has1, int has2) {
  __shared__ float sw1[256 * kMaxLangs];
  __shared__ float red[kWarps][kMaxLangs];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256 * L; i += kThreads) sw1[i] = w1[i];
  __syncthreads();

  const int len = lengths[b];
  const int lm = min(lim[b], S);
  const int n1 = has1 ? max(0, min(len, lm)) : 0;      // s <= len - 1
  const int n2 = has2 ? max(0, min(len - 1, lm)) : 0;  // s <= len - 2
  const int nwin = max(n1, n2);
  const uint8_t* doc = bytes + static_cast<size_t>(b) * S;

  float acc[kMaxLangs];
#pragma unroll
  for (int l = 0; l < kMaxLangs; ++l) acc[l] = 0.0f;
  for (int s = tid; s < nwin; s += kThreads) {
    const int b0 = doc[s];
    if (s < n2) {
      const float* row = w2 + static_cast<size_t>(b0 * 256 + doc[s + 1]) * L;
#pragma unroll
      for (int l = 0; l < kMaxLangs; ++l)
        if (l < L) acc[l] += row[l];
    }
    if (s < n1) {
      const float* row = sw1 + b0 * L;
#pragma unroll
      for (int l = 0; l < kMaxLangs; ++l)
        if (l < L) acc[l] += row[l];
    }
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int l = 0; l < kMaxLangs; ++l) {
    float v = acc[l];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][l] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLangs; ++l) {
      float v = lane < kWarps ? red[lane][l] : 0.0f;
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0 && l < L) out[static_cast<size_t>(b) * L + l] = v;
    }
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
  if (B <= 0 || S <= 0 || L <= 0 || L > kMaxLangs)
    return static_cast<int>(cudaErrorInvalidValue);
  bigram_score_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(lim), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<float*>(out), S, L, has1,
      has2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
