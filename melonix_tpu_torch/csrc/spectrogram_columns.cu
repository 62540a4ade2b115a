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
// * The powers of two 1024 ... 65,536 (fft_large.cuh): a column is one
//   real transform packed as N / 2 complex points, on fft_pair.cuh's
//   register transform of N / 2 points up to 16,384 (one CTA of N / 32
//   threads), on Large<16384> in one CTA at 32,768, or on a 2-CTA cluster
//   (65,536), held in shared memory.  The window's zero fill and decay apply
//   as pass 1 reads the samples, and the real split's epilogue stores |X|
//   or the texel.  One launch, one CTA (or cluster) per column.  At 32,768
//   points a column is 128 KB in and 64 KB out: a 256-column drain moves
//   ~48 MB, so device memory bounds it (~14 us at 3.35 TB/s); each CTA
//   keeps 139 KB of shared memory and fills an SM, so the drain is 1.94
//   waves of 132 CTAs (PERF.md: two CTAs a SM, half a column each on a
//   cluster, measured slower).
// * Other sizes up to 49,152 points, N = B m with m odd (3 ... 47): the
//   frame tile of fft_fourstep.cuh (columns_tile), T whole columns a CTA,
//   T capped so that a drain of up to 256 columns still has a CTA for each
//   of the card's 132 SMs (T = 1 there); lanes read a column's samples
//   consecutively (zero fill and decay as they land) into its m packed
//   sub-sequences, then the four-step column tiles' body (batched radix-16
//   Stockham, split, paired m-point sums) and store_bin for the bins below
//   N / 2.
// * The other sizes above 49,152 points, 1024 j for j = 49 ... 63 (4 * N
//   bytes no longer fit a block): fft_mixed.cuh on a 2-CTA cluster a
//   column, the frame split between the pair by the parity of its m
//   decimated sub-sequences (N = L m, m odd), read once as it lands, the
//   m-point sums reading the peer's half through distributed shared memory,
//   the epilogue above storing each bin once.  One launch, no scratch: 64
//   columns are 128 CTAs, one wave.
#include <cstdint>

#include "fft_fourstep.cuh"
#include "fft_large.cuh"
#include "fft_mixed.cuh"

namespace {

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

// The frame tile (mlx::frame_tile) at the sizes up to mlx::kMaxColumn that
// are no power of two: CTA blockIdx.x takes columns T blockIdx.x ... T
// blockIdx.x + T - 1 below n_cols; tab is kstft.four_step_column_table(N);
// (kT, kPts) as mlx::frame_config gives them.
template <int kT, int kPts>
__global__ void __launch_bounds__(kT, kT == 512 ? (kPts == 16 ? 2 : 1)
                                            : kPts == 16 ? 4 : 2)
columns_tile(const float* __restrict__ wav, long long n,
             const int* __restrict__ starts, const int* __restrict__ ends,
             const float2* __restrict__ tab, mlx::ColTile ft, int n_cols,
             float neg_decay, float inv_size, float kgain, int colormap,
             void* out) {
  extern __shared__ float2 s[];
  const int c0 = blockIdx.x * ft.t, half = ft.b * ft.m / 2;
  mlx::frame_tile<kT, kPts>(
      s, ft, tab, min(ft.t, n_cols - c0),
      [&](int j) {
        long long first, dist0;
        column_span(starts, ends, c0 + j, n, 2LL * half, &first, &dist0);
        return [=](int p) {
          return column_sample(wav, n, first, dist0, p, neg_decay);
        };
      },
      [&](int j, int k, float2 v) {
        store_bin(out, static_cast<long long>(c0 + j) * half, k, v, inv_size,
                  kgain, colormap);
      });
}

// The on-chip route (fft_large.cuh) at N = 1024 ... 65,536, a power of two:
// one CTA, or one 2-CTA cluster at 65,536, per column; tw is
// kstft.large_twiddles(N).
template <int N>
__global__ void __launch_bounds__(mlx::large::RealPlan<N>::kThreads,
                                  mlx::large::RealPlan<N>::kMinBlocks)
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

template <int kT, int kPts>
cudaError_t launch_columns_tile(const float* wav, long long n,
                                const int* starts, const int* ends,
                                const float2* tw, void* out, int n_cols,
                                const mlx::ColTile& ft, float neg_decay,
                                float inv_size, float kgain, int colormap,
                                cudaStream_t stream) {
  return mlx::launch_tiles<kT>(columns_tile<kT, kPts>,
                               (n_cols + ft.t - 1) / ft.t,
                               mlx::col_tile_smem(ft), stream, wav, n, starts,
                               ends, tw, ft, n_cols, neg_decay, inv_size,
                               kgain, colormap, out);
}

// B7 at the sizes up to 49,152 that are no power of two: the frame tile, T
// capped so that n_cols columns fill the card's SMs where they can; tw is
// kstft.four_step_column_table(size).  Any other size is refused
// (cudaErrorInvalidValue).
extern "C" int mlx_spectrogram_columns(const float* wav, long long n,
                                       const int* starts, const int* ends,
                                       const float2* tw, void* out,
                                       int n_cols, int size, float neg_decay,
                                       float inv_size, float kgain,
                                       int colormap, cudaStream_t stream) {
  if (!mlx::frame_tile_takes(size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cols <= 0) return static_cast<int>(cudaGetLastError());
  const mlx::ColTile ft = mlx::make_frame_tile(size, n_cols);
  switch (mlx::frame_config(ft)) {
    case 0:
      return static_cast<int>(launch_columns_tile<256, 16>(
          wav, n, starts, ends, tw, out, n_cols, ft, neg_decay, inv_size,
          kgain, colormap, stream));
    case 1:
      return static_cast<int>(launch_columns_tile<256, 32>(
          wav, n, starts, ends, tw, out, n_cols, ft, neg_decay, inv_size,
          kgain, colormap, stream));
    case 2:
      return static_cast<int>(launch_columns_tile<512, 32>(
          wav, n, starts, ends, tw, out, n_cols, ft, neg_decay, inv_size,
          kgain, colormap, stream));
    default:
      return static_cast<int>(launch_columns_tile<512, 16>(
          wav, n, starts, ends, tw, out, n_cols, ft, neg_decay, inv_size,
          kgain, colormap, stream));
  }
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

// B7 at 1024, 2048, 4096, 8192, 16,384, 32,768 and 65,536 points: the
// on-chip route; tw is kstft.large_twiddles(size).  Any other size is
// refused (cudaErrorInvalidValue).
extern "C" int mlx_spectrogram_columns_large(
    const float* wav, long long n, const int* starts, const int* ends,
    const float2* tw, void* out, int n_cols, int size, float neg_decay,
    float inv_size, float kgain, int colormap, cudaStream_t stream) {
  switch (size) {
    case 1024:
      return launch_columns_large<1024>(wav, n, starts, ends, tw, out, n_cols,
                                        neg_decay, inv_size, kgain, colormap,
                                        stream);
    case 2048:
      return launch_columns_large<2048>(wav, n, starts, ends, tw, out, n_cols,
                                        neg_decay, inv_size, kgain, colormap,
                                        stream);
    case 4096:
      return launch_columns_large<4096>(wav, n, starts, ends, tw, out, n_cols,
                                        neg_decay, inv_size, kgain, colormap,
                                        stream);
    case 8192:
      return launch_columns_large<8192>(wav, n, starts, ends, tw, out, n_cols,
                                        neg_decay, inv_size, kgain, colormap,
                                        stream);
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
