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
// Design, by size (kernels/columns.py:route):
// * 16,384, 32,768 and 65,536 points (fft_large.cuh): a column is one real
//   transform packed as N / 2 complex points, on fft_pair.cuh's 8192
//   instance, on Large<16384> in one CTA, or on a 2-CTA cluster (65,536),
//   held in shared memory.  The window's zero fill and decay apply as pass
//   1 reads the samples, and the real split's epilogue stores |X| or the
//   texel.  One launch, one CTA (or cluster) per column.  At 32,768 points
//   a column is 128 KB in and 64 KB out: a 256-column drain moves ~48 MB,
//   so device memory bounds it (~14 us at 3.35 TB/s); each CTA keeps 139 KB
//   of shared memory and fills an SM, so the drain is 1.94 waves of 132
//   CTAs (PERF.md: two CTAs a SM, half a column each on a cluster, measured
//   slower).
// * Other sizes up to 49,152 points: one block of 512 threads per column
//   runs the real-input FFT of fft_real.cuh in shared memory (samples stored
//   packed and bit-reversed, one barrier a radix-2 stage).
// * The other sizes above 49,152 points, 1024 j for j = 49 ... 63 (4 * N
//   bytes no longer fit a block): fft_mixed.cuh on a 2-CTA cluster a
//   column, the frame split between the pair by the parity of its m
//   decimated sub-sequences (N = L m, m odd), read once as it lands, the
//   m-point sums reading the peer's half through distributed shared memory,
//   the epilogue above storing each bin once.  One launch, no scratch: 64
//   columns are 128 CTAs, one wave.
#include <cstdint>

#include "fft_large.cuh"
#include "fft_mixed.cuh"
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

// The decay of column sample p: expf(neg_decay * dist) where dist = dist0 -
// p > 0, else 1 (expf(-0) is 1 exactly: no branch, so a thread's loads are
// not held behind its expf calls).
__device__ __forceinline__ float column_decay(long long dist0, int p,
                                              float neg_decay) {
  const long long dist = dist0 - p;
  return expf(neg_decay * static_cast<float>(dist > 0 ? dist : 0));
}

// Sample p (0 <= p < size) of the column [first, first + size): zero out of
// [0, n), times its decay.
__device__ __forceinline__ float column_sample(const float* __restrict__ wav,
                                               long long n, long long first,
                                               long long dist0, int p,
                                               float neg_decay) {
  const long long idx = first + p;
  const float x = idx >= 0 && idx < n ? __ldg(wav + idx) : 0.0f;
  return x * column_decay(dist0, p, neg_decay);
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

// The on-chip route (fft_large.cuh) at N = 16,384, 32,768 or 65,536: one
// CTA, or one 2-CTA cluster at 65,536, per column; tw is
// kstft.large_twiddles(N).
template <int N>
__global__ void __launch_bounds__(mlx::large::RealPlan<N>::kThreads, 1)
columns_large(const float* __restrict__ wav, long long n,
              const int* __restrict__ starts, const int* __restrict__ ends,
              const float2* __restrict__ tw, float neg_decay, float inv_size,
              float kgain, int colormap, void* out) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x / mlx::large::RealPlan<N>::kCluster;
  long long first, dist0;
  column_span(starts, ends, c, n, N, &first, &dist0);
  const long long row = static_cast<long long>(c) * (N / 2);
  mlx::large::real_fft<N>(
      wav, n, first, [&](int p) { return column_decay(dist0, p, neg_decay); },
      [&](int k, float2 v) {
        store_bin(out, row, k, v, inv_size, kgain, colormap);
      },
      s, tw);
}

// The cluster route (fft_mixed.cuh) at N = 2P m, P = 512 ... 4096, m odd:
// one 2-CTA cluster per column; tw is kcols.cluster_table(N).
template <int P>
__global__ void __launch_bounds__(mlx::mixed::kThreads, 1)
columns_cluster(const float* __restrict__ wav, long long n,
                const int* __restrict__ starts, const int* __restrict__ ends,
                const float2* __restrict__ tw, mlx::mixed::MixedPlan mp,
                float neg_decay, float inv_size, float kgain, int colormap,
                void* out) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x / 2;
  long long first, dist0;
  column_span(starts, ends, c, n, mp.n, &first, &dist0);
  const long long row = static_cast<long long>(c) * (mp.n / 2);
  mlx::mixed::real_fft_cluster<P>(
      mp,
      [&](int p) { return column_sample(wav, n, first, dist0, p, neg_decay); },
      [&](int k, float2 v) {
        store_bin(out, row, k, v, inv_size, kgain, colormap);
      },
      s, tw);
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

template <int N>
int launch_columns_large(const float* wav, long long n, const int* starts,
                         const int* ends, const float2* tw, void* out,
                         int n_cols, float neg_decay, float inv_size,
                         float kgain, int colormap, cudaStream_t stream) {
  return static_cast<int>(mlx::large::launch_real<N>(
      columns_large<N>, n_cols, stream, wav, n, starts, ends, tw, neg_decay,
      inv_size, kgain, colormap, out));
}

// B7 at 16,384, 32,768 and 65,536 points: the on-chip route; tw is
// kstft.large_twiddles(size).  Any other size is refused
// (cudaErrorInvalidValue).
extern "C" int mlx_spectrogram_columns_large(
    const float* wav, long long n, const int* starts, const int* ends,
    const float2* tw, void* out, int n_cols, int size, float neg_decay,
    float inv_size, float kgain, int colormap, cudaStream_t stream) {
  switch (size) {
    case 16384:
      return launch_columns_large<16384>(wav, n, starts, ends, tw, out, n_cols,
                                         neg_decay, inv_size, kgain, colormap,
                                         stream);
    case 32768:
      return launch_columns_large<32768>(wav, n, starts, ends, tw, out, n_cols,
                                         neg_decay, inv_size, kgain, colormap,
                                         stream);
    case 65536:
      return launch_columns_large<65536>(wav, n, starts, ends, tw, out, n_cols,
                                         neg_decay, inv_size, kgain, colormap,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int P>
cudaError_t launch_columns_cluster(const float* wav, long long n,
                                   const int* starts, const int* ends,
                                   const float2* tw, void* out, int n_cols,
                                   int size, float neg_decay, float inv_size,
                                   float kgain, int colormap,
                                   cudaStream_t stream) {
  const mlx::mixed::MixedPlan mp = mlx::mixed::make_mixed_plan(size, P);
  return mlx::launch_clustered(columns_cluster<P>, dim3(2 * n_cols),
                               mlx::mixed::kThreads,
                               mlx::mixed::mixed_smem(mp, P), 2, stream, wav,
                               n, starts, ends, tw, mp, neg_decay, inv_size,
                               kgain, colormap, out);
}

// B7 at 1024 j points, j = 49 ... 63: the cluster route; tw is
// kcols.cluster_table(size).  Any other size is refused
// (cudaErrorInvalidValue); a cluster the card cannot hold is refused at
// launch (cudaErrorLaunchOutOfResources), never run another way.
extern "C" int mlx_spectrogram_columns_cluster(
    const float* wav, long long n, const int* starts, const int* ends,
    const float2* tw, void* out, int n_cols, int size, float neg_decay,
    float inv_size, float kgain, int colormap, cudaStream_t stream) {
  const int m = size / (size & -size);
  if (size % 1024 != 0 || size / 1024 < 49 || size / 1024 > 63 || m < 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cols <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaErrorInvalidValue;
  switch ((size & -size) / 2) {
    case 512:
      err = launch_columns_cluster<512>(wav, n, starts, ends, tw, out, n_cols,
                                        size, neg_decay, inv_size, kgain,
                                        colormap, stream);
      break;
    case 1024:
      err = launch_columns_cluster<1024>(wav, n, starts, ends, tw, out,
                                         n_cols, size, neg_decay, inv_size,
                                         kgain, colormap, stream);
      break;
    case 2048:
      err = launch_columns_cluster<2048>(wav, n, starts, ends, tw, out,
                                         n_cols, size, neg_decay, inv_size,
                                         kgain, colormap, stream);
      break;
    case 4096:
      err = launch_columns_cluster<4096>(wav, n, starts, ends, tw, out,
                                         n_cols, size, neg_decay, inv_size,
                                         kgain, colormap, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}
