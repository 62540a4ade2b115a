// B12: |STFT| * scale of windowed frames at a uniform hop, for the sizes B1
// (stft_mag.cu, 2048 points only) does not take.
//
// Replaces melonix_tpu/kernels/pallas_stft.py:stft_mag_pallas (_kernel),
// the TPU's slab DMA + row-rolled frame views + dense cos/sin DFT-matrix
// contraction on the MXU.
//
// Contract: frame f covers wav[f*hop, f*hop + N), zeros past n; out is
// (n_frames, N/2) float32, bins in natural order,
// out[f, k] = |sum_i win[i] x_f[i] e^{-2 pi i k i / N}| * scale.
//
// Five routes, picked by N alone (kernels/stft.py route):
//
// * N = 512 ... 8192, a power of two: mlx_stft_mag_pair, B1's kernel
//   (stft_mag_pair.cuh) at N: two frames per complex transform on the
//   register-resident fft_pair.cuh, a persistent grid, |X| in the pair
//   split's epilogue.  At 4096/1024 on a 180 s track the frames read 32 MB
//   and write 64 MB: device memory bounds it (~28 us at 3.35 TB/s), not the
//   ~0.15 MFLOP per frame.
//
// * N = 16,384, 32,768 and 65,536: mlx_stft_mag_large, one real frame per
//   transform on fft_large.cuh (fft_pair.cuh's 8192 instance, Large<16384>
//   in one CTA, or a 2-CTA cluster at 65,536), held in shared memory; the
//   window and zero fill as pass 1 reads the frame (frames overlap, so L2
//   serves most reads), |X| * scale in the real split.
//
// * Any other N up to 49,152 points: stft_mag_sizes_kernel, one block of
//   256 threads per frame.  Threads read the frame coalesced, window it and
//   store it packed into dynamic shared memory; the real-input DFT of
//   fft_real.cuh runs there: a power-of-two N is one packed FFT, N = 2^a * m
//   with m odd (1536 = 512 * 3) is m packed radix-2 FFTs of the decimated
//   samples plus a direct m-point sum per output bin.  Shared memory is
//   4*N bytes (the wrapper caps N, kernels/stft.py).
//
// * Other sizes above 49,152 points: the four-step route of
//   fft_fourstep.cuh: stft_four_step_cols (one block per (frame, n1): the
//   windowed strided samples' real N2-point transforms, into a scratch
//   buffer) then stft_four_step_rows (a block per (frame, k2): twiddles, the
//   complex N1-point transform, |X| * scale for the bins below N/2).
//
// * Where N's odd factor is above 12,288 the four-step columns are no FFT:
//   up to N2 = 32,768 mlx_stft_mag_bluestein runs them by Bluestein
//   (stft_four_step_cols_bluestein: two columns a cluster, two 32,768-point
//   transforms on 2 CTAs up to N2 = 16,384, two 65,536-point transforms on
//   4 above), above it stft_four_step_cols_direct sums them directly; the
//   rows stay.
#include "fft_fourstep.cuh"
#include "fft_large.cuh"
#include "stft_mag_pair.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stft_mag_sizes_kernel(const float* __restrict__ wav, long long n,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw, float* __restrict__ out,
                      mlx::RealDft d, int hop, float scale) {
  extern __shared__ float2 s[];
  const long long start = static_cast<long long>(blockIdx.x) * hop;
  for (int i = threadIdx.x; i < d.n; i += blockDim.x) {
    const long long idx = start + i;
    const float x = idx < n ? wav[idx] : 0.0f;
    mlx::real_dft_put(s, d, i, x * win[i]);
  }
  mlx::real_dft_fft(s, d, tw);
  mlx::real_dft_post(s, d, tw);
  const int n_bins = d.n / 2;
  float* row = out + static_cast<long long>(blockIdx.x) * n_bins;
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    const float2 v = mlx::real_dft_bin(s, d, tw, k);
    row[k] = sqrtf(v.x * v.x + v.y * v.y) * scale;
  }
}

// The on-chip route (fft_large.cuh) at N = 16,384, 32,768 or 65,536: one
// CTA, or one 2-CTA cluster at 65,536, per frame; tw is
// kstft.large_twiddles(N).
template <int N>
__global__ void __launch_bounds__(mlx::large::RealPlan<N>::kThreads, 1)
stft_mag_large_kernel(const float* __restrict__ wav, long long n,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw, float* __restrict__ out,
                      int hop, float scale) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x / mlx::large::RealPlan<N>::kCluster;
  const long long start = static_cast<long long>(f) * hop;
  float* row = out + static_cast<long long>(f) * (N / 2);
  mlx::large::real_fft<N>(
      wav, n, start, [&](int i) { return __ldg(win + i); },
      [&](int k, float2 v) { row[k] = sqrtf(v.x * v.x + v.y * v.y) * scale; },
      s, tw);
}

// Four-step route, step 1: grid (frames, N1).
__global__ void __launch_bounds__(kThreads)
stft_four_step_cols(const float* __restrict__ wav, long long n,
                    const float* __restrict__ win,
                    const float2* __restrict__ tw2, mlx::FourStep f, int hop,
                    float2* __restrict__ scratch) {
  extern __shared__ float2 s[];
  const long long start = static_cast<long long>(blockIdx.x) * hop;
  mlx::four_step_column(
      s, f, tw2, blockIdx.y,
      [&](int i) {
        const long long idx = start + i;
        return (idx < n ? wav[idx] : 0.0f) * win[i];
      },
      scratch + blockIdx.x * mlx::four_step_scratch(f));
}

// Four-step route, step 1 by direct sums (mlx::four_step_direct): grid
// (frames, N1); `circle` the whole N2-point table.
__global__ void __launch_bounds__(kThreads)
stft_four_step_cols_direct(const float* __restrict__ wav, long long n,
                           const float* __restrict__ win,
                           const float2* __restrict__ circle, mlx::FourStep f,
                           int hop, float2* __restrict__ scratch) {
  __shared__ float s[mlx::kDirectTile];
  const long long start = static_cast<long long>(blockIdx.x) * hop;
  mlx::four_step_column_direct(
      s, f, circle, blockIdx.y,
      [&](int i) {
        const long long idx = start + i;
        return (idx < n ? wav[idx] : 0.0f) * win[i];
      },
      scratch + blockIdx.x * mlx::four_step_scratch(f));
}

// Four-step route, step 1 by Bluestein (N2 <= mlx::kBluesteinMax): grid
// (N1 * C / 2, frames) in clusters of C CTAs along x (C =
// mlx::bluestein_cluster(N2)), columns 2p and 2p + 1 on cluster p; `tab` is
// kstft.bluestein_table(N2).
template <int C>
__global__ void __launch_bounds__(mlx::large::Large<16384>::kThreads, 1)
stft_four_step_cols_bluestein(const float* __restrict__ wav, long long n,
                              const float* __restrict__ win,
                              const float2* __restrict__ tab,
                              mlx::FourStep f, int hop,
                              float2* __restrict__ scratch) {
  extern __shared__ float2 s[];
  const long long start = static_cast<long long>(blockIdx.y) * hop;
  const int n1a = static_cast<int>(blockIdx.x / C) * 2;
  auto x = [&](int i) {
    const long long idx = start + i;
    return (idx < n ? wav[idx] : 0.0f) * win[i];
  };
  mlx::four_step_column_bluestein<C>(
      s, f, tab, n1a,
      [&](int q) {
        const int i = n1a + f.n1 * q;
        return make_float2(x(i), x(i + 1));
      },
      scratch + blockIdx.y * mlx::four_step_scratch(f));
}

// Four-step route, steps 2-3: grid (frames, min(N2, 65535)), rows k2 =
// blockIdx.y + j * gridDim.y (the direct route's N2 can pass the grid's
// y limit).
__global__ void __launch_bounds__(kThreads)
stft_four_step_rows(const float2* __restrict__ tw, mlx::FourStep f,
                    const float2* __restrict__ scratch,
                    float* __restrict__ out, float scale) {
  extern __shared__ float2 s[];
  float* row = out + static_cast<long long>(blockIdx.x) * (f.n / 2);
  for (int k2 = blockIdx.y; k2 < f.n2; k2 += gridDim.y) {
    if (k2 != static_cast<int>(blockIdx.y)) __syncthreads();  // row read
    mlx::four_step_row(s, f, tw, k2,
                       scratch + blockIdx.x * mlx::four_step_scratch(f),
                       [&](int k, float2 v) {
                         row[k] = sqrtf(v.x * v.x + v.y * v.y) * scale;
                       });
  }
}

}  // namespace

extern "C" int mlx_stft_mag_sizes(const float* wav, long long n,
                                  const float* win, const float2* tw,
                                  float* out, int n_frames, int size, int hop,
                                  float scale, cudaStream_t stream) {
  if (n_frames > 0) {
    const mlx::RealDft d = mlx::make_real_dft(size);
    const size_t smem = mlx::real_dft_smem(d);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          stft_mag_sizes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) {
        cudaGetLastError();  // clear it: the call reports it once
        return static_cast<int>(err);
      }
    }
    stft_mag_sizes_kernel<<<n_frames, kThreads, smem, stream>>>(
        wav, n, win, tw, out, d, hop, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// B12 at the power-of-two sizes of fft_pair.cuh; tw is kpv.pair_twiddles
// of `size`.  Any other size is refused (cudaErrorInvalidValue).
extern "C" int mlx_stft_mag_pair(const float* wav, long long n,
                                 const float* win, const float2* tw,
                                 float* out, int n_frames, int size, int hop,
                                 float scale, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (size) {
    case 512:
      err = mlx::launch_stft_mag_pair<512>(wav, n, win, tw, out, n_frames,
                                           hop, scale, stream);
      break;
    case 1024:
      err = mlx::launch_stft_mag_pair<1024>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    case 2048:
      err = mlx::launch_stft_mag_pair<2048>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    case 4096:
      err = mlx::launch_stft_mag_pair<4096>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    case 8192:
      err = mlx::launch_stft_mag_pair<8192>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

template <int N>
int launch_stft_mag_large(const float* wav, long long n, const float* win,
                          const float2* tw, float* out, int n_frames, int hop,
                          float scale, cudaStream_t stream) {
  return static_cast<int>(mlx::large::launch_real<N>(
      stft_mag_large_kernel<N>, n_frames, stream, wav, n, win, tw, out, hop,
      scale));
}

// B12 at 16,384, 32,768 and 65,536 points: the on-chip route; tw is
// kstft.large_twiddles(size).  Any other size is refused
// (cudaErrorInvalidValue).
extern "C" int mlx_stft_mag_large(const float* wav, long long n,
                                  const float* win, const float2* tw,
                                  float* out, int n_frames, int size, int hop,
                                  float scale, cudaStream_t stream) {
  switch (size) {
    case 16384:
      return launch_stft_mag_large<16384>(wav, n, win, tw, out, n_frames, hop,
                                          scale, stream);
    case 32768:
      return launch_stft_mag_large<32768>(wav, n, win, tw, out, n_frames, hop,
                                          scale, stream);
    case 65536:
      return launch_stft_mag_large<65536>(wav, n, win, tw, out, n_frames, hop,
                                          scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B12 where the four-step columns take Bluestein (an odd factor above
// 12,288, N2 <= 32,768): the columns on clusters of 2 CTAs (N2 <= 16,384)
// or 4, then the four-step rows.  `scratch` as mlx_stft_mag_4step's; tw the
// size-point table, tab kstft.bluestein_table(size / n1).  Other plans are
// refused (cudaErrorInvalidValue); a cluster the card cannot hold is refused
// at launch (cudaErrorLaunchOutOfResources), never run another way.
extern "C" int mlx_stft_mag_bluestein(const float* wav, long long n,
                                      const float* win, const float2* tw,
                                      const float2* tab, float2* scratch,
                                      float* out, int n_frames, int size,
                                      int n1, int hop, float scale,
                                      cudaStream_t stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const mlx::FourStep f = mlx::make_four_step(size, n1);
  if (!mlx::four_step_direct(f) || f.n2 > mlx::kBluesteinMax || n1 % 2 ||
      n_frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using L = mlx::large::Large<16384>;
  const int cluster = mlx::bluestein_cluster(f.n2);
  const dim3 grid(n1 / 2 * cluster, n_frames);
  cudaError_t err =
      cluster == 2
          ? mlx::launch_clustered(stft_four_step_cols_bluestein<2>, grid,
                                  L::kThreads, L::kSmem, 2, stream, wav, n,
                                  win, tab, f, hop, scratch)
          : mlx::launch_clustered(stft_four_step_cols_bluestein<4>, grid,
                                  L::kThreads, L::kSmem, 4, stream, wav, n,
                                  win, tab, f, hop, scratch);
  const size_t smem_rows = static_cast<size_t>(n1) * sizeof(float2);
  if (err == cudaSuccess) err = mlx::allow_smem(stft_four_step_rows, smem_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  stft_four_step_rows<<<dim3(n_frames, min(f.n2, 65535)), kThreads, smem_rows,
                        stream>>>(tw, f, scratch, out, scale);
  return static_cast<int>(cudaGetLastError());
}

// B12 above 49,152 points at the other sizes: the four-step route.
// `scratch` holds n_frames * (size / n1 / 2 + 1) * n1 float2 values; tw the
// size-point table, tw2 the (size / n1)-point one: half the circle, or the
// whole circle where the columns take the direct sums (mlx::four_step_direct
// with N2 above mlx::kBluesteinMax).
extern "C" int mlx_stft_mag_4step(const float* wav, long long n,
                                  const float* win, const float2* tw,
                                  const float2* tw2, float2* scratch,
                                  float* out, int n_frames, int size, int n1,
                                  int hop, float scale, cudaStream_t stream) {
  if (n_frames > 0) {
    const mlx::FourStep f = mlx::make_four_step(size, n1);
    const bool direct = mlx::four_step_direct(f);
    const size_t smem_cols = direct ? 0 : mlx::real_dft_smem(f.col);
    const size_t smem_rows = static_cast<size_t>(n1) * sizeof(float2);
    cudaError_t err = mlx::allow_smem(stft_four_step_cols, smem_cols);
    if (err == cudaSuccess) {
      err = mlx::allow_smem(stft_four_step_rows, smem_rows);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (direct) {
      stft_four_step_cols_direct<<<dim3(n_frames, f.n1), kThreads, 0,
                                   stream>>>(wav, n, win, tw2, f, hop,
                                             scratch);
    } else {
      stft_four_step_cols<<<dim3(n_frames, f.n1), kThreads, smem_cols,
                            stream>>>(wav, n, win, tw2, f, hop, scratch);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stft_four_step_rows<<<dim3(n_frames, min(f.n2, 65535)), kThreads,
                          smem_rows, stream>>>(tw, f, scratch, out, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
