// B1: |STFT| * scale of Hann-windowed 2048-point frames at a uniform hop.
//
// Replaces melonix_tpu/kernels/pallas_pv.py:stft_mag_fourstep (_stft_kernel),
// the TPU's fused slab-DMA + four-step MXU DFT + magnitude kernel.
//
// Contract: frame f covers wav[f*hop, f*hop + 2048), zeros past n; out is
// (n_frames, 1024) float32, bins 0..1023 in natural order,
// out[f, k] = |sum_n win[n] x_f[n] e^{-2 pi i k n / 2048}| * scale.
//
// Design: one block of 256 threads per frame.  Threads load the frame with
// neighbouring threads on neighbouring samples (coalesced), window it and
// store it bit-reversed into shared memory; fft2048 transforms it; the
// first 1024 magnitudes go out coalesced.  Each frame moves 8 KB in and
// 4 KB out of device memory and ~0.1 MFLOP: for F ~ 15.5k frames the
// kernel is bounded by the FFT's shared-memory passes, not by HBM.
#include "fft2048.cuh"

namespace {

__global__ void __launch_bounds__(mlx::kFftThreads)
stft_mag_kernel(const float* __restrict__ wav, long long n,
                const float* __restrict__ win, const float2* __restrict__ tw,
                float* __restrict__ out, int hop, float scale) {
  __shared__ float2 data[mlx::kFftN];
  __shared__ float2 s_tw[mlx::kFftN / 2];
  mlx::load_twiddles(s_tw, tw);
  const long long start = static_cast<long long>(blockIdx.x) * hop;
  for (int i = threadIdx.x; i < mlx::kFftN; i += blockDim.x) {
    const long long idx = start + i;
    const float x = idx < n ? wav[idx] : 0.0f;
    data[mlx::bitrev11(i)] = make_float2(x * win[i], 0.0f);
  }
  mlx::fft2048(data, s_tw, -1.0f);
  float* row = out + static_cast<long long>(blockIdx.x) * (mlx::kFftN / 2);
  for (int k = threadIdx.x; k < mlx::kFftN / 2; k += blockDim.x) {
    const float2 v = data[k];
    row[k] = sqrtf(v.x * v.x + v.y * v.y) * scale;
  }
}

}  // namespace

extern "C" int mlx_stft_mag(const float* wav, long long n, const float* win,
                            const float2* tw, float* out, int n_frames,
                            int hop, float scale, cudaStream_t stream) {
  if (n_frames > 0) {
    stft_mag_kernel<<<n_frames, mlx::kFftThreads, 0, stream>>>(
        wav, n, win, tw, out, hop, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mlx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
