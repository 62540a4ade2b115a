// |STFT| * scale of windowed N-point frames at a uniform hop on the register
// pair transform of fft_pair.cuh: the kernel of B1 (stft_mag.cu, N = 2048)
// and of B12's power-of-two sizes (stft_mag_sizes.cu, N = 512 ... 8192).
//
// Contract: frame f covers wav[f*hop, f*hop + N), zeros past n; out is
// (n_frames, N/2) float32, bins 0..N/2-1 in natural order,
// out[f, k] = |sum_i win[i] x_f[i] e^{-2 pi i k i / N}| * scale.
//
// Design: frames f and f + 1 share one complex transform, z = x_f + i
// x_(f+1), and come apart in the epilogue as
//   X_f[k] = (Z[k] + conj Z[N - k]) / 2,  X_(f+1)[k] = (Z[k] - conj Z[N - k]) / 2i,
// so no arithmetic or shared traffic is spent on a zero imaginary half.  An
// odd frame count pairs its last frame with silence and writes one row.  A
// CTA of N / 16 threads loads its twiddles into registers once and then
// walks the frame pairs blockIdx.x, + gridDim.x, ... (the persistent grid:
// what fits on the card at once).  Each thread loads its 16 samples of both
// frames straight into registers, window and zero fill (idx < n) fused in
// the load: lanes read consecutive samples (coalesced scalar loads; B1's
// hop is any positive integer, so no vector alignment).  The epilogue reads
// Z[k] and Z[N - k] from shared memory and stores both frames' magnitude
// rows coalesced.  Per frame hop * 4 bytes of new samples in (frames
// overlap) and 2 * N bytes out: device memory bounds the kernel, and with
// the transform in registers it should approach that bound.
//
// The kernels sit in an anonymous namespace: each translation unit that
// includes this header instantiates its own copies.
#pragma once

#include "fft_pair.cuh"

namespace mlx {
namespace {

__device__ __forceinline__ float pair_sample(const float* __restrict__ wav,
                                             long long idx, long long n) {
  return idx < n ? wav[idx] : 0.0f;
}

template <int N>
__global__ void __launch_bounds__(pairfft::Pair<N>::kThreads,
                                  pairfft::Pair<N>::kMinBlocks)
stft_mag_pair_kernel(const float* __restrict__ wav, long long n,
                     const float* __restrict__ win,
                     const float2* __restrict__ tw, float* __restrict__ out,
                     int n_frames, int hop, float scale) {
  using P = pairfft::Pair<N>;
  constexpr int kBins = N / 2;
  extern __shared__ float2 pair_smem[];
  pairfft::Twiddles<N> twr;
  pairfft::load_twiddles<N>(twr, tw);
  const int n_pairs = (n_frames + 1) / 2;
  int turn = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, turn ^= 1) {
    const int fa = 2 * p, fb = fa + 1;
    const long long sa = static_cast<long long>(fa) * hop;
    const long long sb = fb < n_frames ? sa + hop : n;  // silence
    float2 v[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const int i = threadIdx.x + P::kThreads * a;
      const float w = win[i];
      v[a] = make_float2(pair_sample(wav, sa + i, n) * w,
                         pair_sample(wav, sb + i, n) * w);
    }
    float2* z = pair_smem + turn * P::kBuf;
    pairfft::fft<N>(v, twr, z, pair_smem + (turn ^ 1) * P::kBuf, -1.0f);
    float* row_a = out + static_cast<long long>(fa) * kBins;
    float* row_b = row_a + kBins;
    for (int k = threadIdx.x; k < kBins; k += P::kThreads) {
      const float2 zk = z[k], zn = z[(N - k) & (N - 1)];
      const float ra = 0.5f * (zk.x + zn.x), ia = 0.5f * (zk.y - zn.y);
      row_a[k] = sqrtf(ra * ra + ia * ia) * scale;
      if (fb < n_frames) {
        const float rb = 0.5f * (zk.y + zn.y), ib = 0.5f * (zn.x - zk.x);
        row_b[k] = sqrtf(rb * rb + ib * ib) * scale;
      }
    }
  }
}

// Launch the kernel of size N on `stream` over a persistent grid.
template <int N>
cudaError_t launch_stft_mag_pair(const float* wav, long long n,
                                 const float* win, const float2* tw,
                                 float* out, int n_frames, int hop,
                                 float scale, cudaStream_t stream) {
  using P = pairfft::Pair<N>;
  if (n_frames <= 0) return cudaGetLastError();
  int grid = 0;
  const cudaError_t err = pairfft::persistent_grid(
      stft_mag_pair_kernel<N>, P::kThreads, P::kSmem, (n_frames + 1) / 2,
      &grid);
  if (err != cudaSuccess) return err;
  stft_mag_pair_kernel<N><<<grid, P::kThreads, P::kSmem, stream>>>(
      wav, n, win, tw, out, n_frames, hop, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mlx
