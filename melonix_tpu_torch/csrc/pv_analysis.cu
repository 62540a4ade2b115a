// B2: windowed 2048-point forward DFT of frames at arbitrary int32 starts.
//
// Replaces melonix_tpu/kernels/pallas_pv.py:analysis (_ana_kernel,
// _fwd_dft), the TPU's double-buffered per-frame DMA + lane realign +
// four-step MXU DFT, which emitted the full 2048-bin spectrum in a
// scrambled bin order (an MXU layout trick).  The port keeps natural order
// and the 1025-bin half spectrum of a real frame.
//
// Contract: frame m covers wav[s, s + 2048) with s = clip(starts[m], 0,
// n-1), zeros past n, times win; re/im are (n_frames, 1025) float32, bins
// 0..1024 in natural order.
//
// Design: one block of 256 threads per frame; each block reads its own
// start (no scalar prefetch on this card), loads the frame coalesced,
// windows it into shared memory bit-reversed, runs fft2048 and writes the
// half spectrum.  8 KB in, 8 KB out per frame; like B1 it is bounded by
// the FFT's shared-memory passes.
#include "fft2048.cuh"

namespace {

constexpr int kBins = mlx::kFftN / 2 + 1;

__global__ void __launch_bounds__(mlx::kFftThreads)
pv_analysis_kernel(const float* __restrict__ wav, long long n,
                   const int* __restrict__ starts,
                   const float* __restrict__ win,
                   const float2* __restrict__ tw, float* __restrict__ re,
                   float* __restrict__ im) {
  __shared__ float2 data[mlx::kFftN];
  __shared__ float2 s_tw[mlx::kFftN / 2];
  mlx::load_twiddles(s_tw, tw);
  long long start = starts[blockIdx.x];
  start = start < 0 ? 0 : (start > n - 1 ? n - 1 : start);
  for (int i = threadIdx.x; i < mlx::kFftN; i += blockDim.x) {
    const long long idx = start + i;
    const float x = idx < n ? wav[idx] : 0.0f;
    data[mlx::bitrev11(i)] = make_float2(x * win[i], 0.0f);
  }
  mlx::fft2048(data, s_tw, -1.0f);
  const long long row = static_cast<long long>(blockIdx.x) * kBins;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) {
    const float2 v = data[k];
    re[row + k] = v.x;
    im[row + k] = v.y;
  }
}

}  // namespace

extern "C" int mlx_pv_analysis(const float* wav, long long n,
                               const int* starts, const float* win,
                               const float2* tw, float* re, float* im,
                               int n_frames, cudaStream_t stream) {
  if (n_frames > 0) {
    pv_analysis_kernel<<<n_frames, mlx::kFftThreads, 0, stream>>>(
        wav, n, starts, win, tw, re, im);
  }
  return static_cast<int>(cudaGetLastError());
}
