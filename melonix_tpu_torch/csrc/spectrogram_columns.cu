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
//
// Above 49,152 points (4 * N bytes no longer fit a block) the column takes
// the four-step route of fft_fourstep.cuh: columns_four_step_cols (one block
// per (column, n1): the real N2-point transforms of the strided samples,
// into a scratch buffer) then columns_four_step_rows (one block per
// (column, k2): twiddles, the complex N1-point transform, the epilogue
// above).  Same contract, two launches.
#include <cstdint>

#include "fft_fourstep.cuh"

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

// Sample p (0 <= p < size) of the column [first, first + size): zero out of
// [0, n), times expf(neg_decay * dist) where dist = dist0 - p > 0.
__device__ __forceinline__ float column_sample(const float* __restrict__ wav,
                                               long long n, long long first,
                                               long long dist0, int p,
                                               float neg_decay) {
  const long long idx = first + p;
  float x = 0.0f;
  if (idx >= 0 && idx < n) {
    x = wav[idx];
    const long long dist = dist0 - p;
    if (dist > 0) x *= expf(neg_decay * static_cast<float>(dist));
  }
  return x;
}

// Bin k of column row `row`: |X| * inv_size, or its packed colormap texel.
__device__ __forceinline__ void store_bin(void* out, long long row, int k,
                                          float2 v, float inv_size,
                                          float kgain, int colormap) {
  const float mag = sqrtf(v.x * v.x + v.y * v.y) * inv_size;
  if (colormap) {
    static_cast<int32_t*>(out)[row + k] = pack_rgb(mag, kgain);
  } else {
    static_cast<float*>(out)[row + k] = mag;
  }
}

// The column's window: (first sample, distance of `starts` from it).
__device__ __forceinline__ void column_span(const int* __restrict__ starts,
                                            const int* __restrict__ ends,
                                            int c, long long n, long long size,
                                            long long* first,
                                            long long* dist0) {
  long long end = ends[c];
  end = end < 0 ? 0 : (end > n + size ? n + size : end);
  *first = end - size;
  *dist0 = static_cast<long long>(starts[c]) - *first;
}

__global__ void __launch_bounds__(kThreads)
columns_kernel(const float* __restrict__ wav, long long n,
               const int* __restrict__ starts, const int* __restrict__ ends,
               const float2* __restrict__ tw, mlx::RealDft d, float neg_decay,
               float inv_size, float kgain, int colormap, void* out) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x;
  long long first, dist0;
  column_span(starts, ends, c, n, d.n, &first, &dist0);
  for (int p = threadIdx.x; p < d.n; p += blockDim.x) {
    mlx::real_dft_put(s, d, p,
                      column_sample(wav, n, first, dist0, p, neg_decay));
  }
  mlx::real_dft_fft(s, d, tw);
  mlx::real_dft_post(s, d, tw);
  const int n_bins = d.n / 2;
  const long long row = static_cast<long long>(c) * n_bins;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    store_bin(out, row, k, mlx::real_dft_bin(s, d, tw, k), inv_size, kgain,
              colormap);
  }
}

// Four-step route, step 1: grid (columns, N1).
__global__ void __launch_bounds__(kThreads)
columns_four_step_cols(const float* __restrict__ wav, long long n,
                       const int* __restrict__ starts,
                       const int* __restrict__ ends,
                       const float2* __restrict__ tw2, mlx::FourStep f,
                       float neg_decay, float2* __restrict__ scratch) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x;
  long long first, dist0;
  column_span(starts, ends, c, n, f.n, &first, &dist0);
  mlx::four_step_column(
      s, f, tw2, blockIdx.y,
      [&](int p) { return column_sample(wav, n, first, dist0, p, neg_decay); },
      scratch + c * mlx::four_step_scratch(f));
}

// Four-step route, steps 2-3: grid (columns, N2).
__global__ void __launch_bounds__(kThreads)
columns_four_step_rows(const float2* __restrict__ tw, mlx::FourStep f,
                       const float2* __restrict__ scratch, float inv_size,
                       float kgain, int colormap, void* out) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x;
  const long long row = static_cast<long long>(c) * (f.n / 2);
  mlx::four_step_row(s, f, tw, blockIdx.y,
                     scratch + c * mlx::four_step_scratch(f),
                     [&](int k, float2 v) {
                       store_bin(out, row, k, v, inv_size, kgain, colormap);
                     });
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

// B7 above 49,152 points: the four-step route.  `scratch` holds n_cols *
// (size / n1 / 2 + 1) * n1 float2 values; tw the size-point table, tw2 the
// (size / n1)-point one.
extern "C" int mlx_spectrogram_columns_4step(
    const float* wav, long long n, const int* starts, const int* ends,
    const float2* tw, const float2* tw2, float2* scratch, void* out,
    int n_cols, int size, int n1, float neg_decay, float inv_size,
    float kgain, int colormap, cudaStream_t stream) {
  if (n_cols > 0) {
    const mlx::FourStep f = mlx::make_four_step(size, n1);
    const size_t smem_cols = mlx::real_dft_smem(f.col);
    const size_t smem_rows = static_cast<size_t>(n1) * sizeof(float2);
    cudaError_t err = mlx::allow_smem(columns_four_step_cols, smem_cols);
    if (err == cudaSuccess) {
      err = mlx::allow_smem(columns_four_step_rows, smem_rows);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    columns_four_step_cols<<<dim3(n_cols, f.n1), kThreads, smem_cols,
                             stream>>>(wav, n, starts, ends, tw2, f,
                                       neg_decay, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    columns_four_step_rows<<<dim3(n_cols, f.n2), kThreads, smem_rows,
                             stream>>>(tw, f, scratch, inv_size, kgain,
                                       colormap, out);
  }
  return static_cast<int>(cudaGetLastError());
}
