// B7: reference-parity spectrogram columns (spec.cpp:44-66 semantics).
//
// Replaces melonix_tpu/kernels/pallas_columns.py:spectrogram_columns_fused
// (_kernel), the TPU's double-buffered slab DMA + lane-roll realignment +
// four-step MXU DFT + magnitude/colormap kernel.
//
// Contract: column c covers wav[end - N, end) with end = clip(ends[c], 0,
// n + N); samples out of [0, n) are 0; a sample i < starts[c] is scaled by
// expf(neg_decay * (float)(starts[c] - i)) (int distance, float32 product,
// the exact expf: no __expf, no fast math); out[c, k] = |X[k]| * inv_size
// for k < N/2.  With `colormap` the magnitude times kgain is mapped through
// the reference's three-segment colormap (spec-cache.cpp:79-96, pi literal
// 3.141592) and packed as int32 0x00RRGGBB, as pallas_columns.py:152-162.
//
// Design: one block of 512 threads per column.  Threads read the window
// with neighbouring threads on neighbouring samples (coalesced), apply the
// decay and store the samples packed and bit-reversed into dynamic shared
// memory (fft_real.cuh); the real-input FFT runs there; the N/2 outputs go
// out coalesced.  At N = 32768 a column is 128 KB in, 64 KB out and ~1.2
// MFLOP: a 256-column drain moves ~48 MB, so device memory bounds it
// (~14 us at 3.35 TB/s); the 128 KB of shared memory allow one block per
// SM, and the FFT's 14 barrier-separated stages are what the kernel waits
// on in practice.
#include <cstdint>

#include "fft_real.cuh"

namespace {

constexpr int kThreads = 512;
constexpr float kInv85 = static_cast<float>(1.0 / 85.0);
constexpr float kHalfPiRef = static_cast<float>(3.141592 / 2.0);

__device__ __forceinline__ int32_t pack_rgb(float mag, float kgain) {
  const float v = fminf(fmaxf(mag * kgain, 0.0f), 255.0f);
  const float a = (v - 85.0f) * kInv85 * kHalfPiRef;
  float r, g, b;
  if (v < 85.0f) {
    r = v;
    g = 0.0f;
    b = 0.0f;
  } else if (v < 170.0f) {
    r = v * cosf(a);
    g = v * sinf(a);
    b = 0.0f;
  } else {
    r = (v - 170.0f) * 3.0f;
    g = v;
    b = (v - 170.0f) * 3.0f;
  }
  return static_cast<int32_t>(r) * 65536 + static_cast<int32_t>(g) * 256 +
         static_cast<int32_t>(b);
}

__global__ void __launch_bounds__(kThreads)
columns_kernel(const float* __restrict__ wav, long long n,
               const int* __restrict__ starts, const int* __restrict__ ends,
               const float2* __restrict__ tw, mlx::RealDft d, float neg_decay,
               float inv_size, float kgain, int colormap, void* out) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x;
  const long long size = d.n;
  long long end = ends[c];
  end = end < 0 ? 0 : (end > n + size ? n + size : end);
  const long long first = end - size;
  const long long dist0 = static_cast<long long>(starts[c]) - first;
  for (int p = threadIdx.x; p < d.n; p += blockDim.x) {
    const long long idx = first + p;
    float x = 0.0f;
    if (idx >= 0 && idx < n) {
      x = wav[idx];
      const long long dist = dist0 - p;
      if (dist > 0) x *= expf(neg_decay * static_cast<float>(dist));
    }
    mlx::real_dft_put(s, d, p, x);
  }
  mlx::real_dft_fft(s, d, tw);
  mlx::real_dft_post(s, d, tw);
  const int n_bins = d.n / 2;
  const long long row = static_cast<long long>(c) * n_bins;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const float2 v = mlx::real_dft_bin(s, d, tw, k);
    const float mag = sqrtf(v.x * v.x + v.y * v.y) * inv_size;
    if (colormap) {
      static_cast<int32_t*>(out)[row + k] = pack_rgb(mag, kgain);
    } else {
      static_cast<float*>(out)[row + k] = mag;
    }
  }
}

}  // namespace

extern "C" int mlx_spectrogram_columns(const float* wav, long long n,
                                       const int* starts, const int* ends,
                                       const float2* tw, void* out,
                                       int n_cols, int size, float neg_decay,
                                       float inv_size, float kgain,
                                       int colormap, cudaStream_t stream) {
  if (n_cols > 0) {
    const mlx::RealDft d = mlx::make_real_dft(size);
    const size_t smem = mlx::real_dft_smem(d);
    const cudaError_t err = cudaFuncSetAttribute(
        columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the call reports it once
      return static_cast<int>(err);
    }
    columns_kernel<<<n_cols, kThreads, smem, stream>>>(
        wav, n, starts, ends, tw, d, neg_decay, inv_size, kgain, colormap,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}
