// B1: |STFT| * scale of Hann-windowed 2048-point frames at a uniform hop.
//
// Replaces melonix_tpu/kernels/pallas_pv.py:stft_mag_fourstep (_stft_kernel),
// the TPU's fused slab-DMA + four-step MXU DFT + magnitude kernel.
//
// Contract: frame f covers wav[f*hop, f*hop + 2048), zeros past n; out is
// (n_frames, 1024) float32, bins 0..1023 in natural order,
// out[f, k] = |sum_n win[n] x_f[n] e^{-2 pi i k n / 2048}| * scale.
//
// Design: the 2048-point instance of stft_mag_pair.cuh, the kernel B12
// runs at its power-of-two sizes: two hop-strided frames per complex
// transform on the register-resident fft_pair.cuh (radix 16 * 16 * 8,
// three barriers), split into |X_f| and |X_(f+1)| in the epilogue; a
// persistent grid of 128-thread CTAs that load their twiddles once; window
// and zero fill fused into coalesced scalar loads (any hop > 0).  Each
// frame moves ~hop * 4 bytes in (frames overlap) and 4 KB out: for F ~
// 15.5k frames device memory bounds it (~0.028 ms at 3.35 TB/s).
#include "stft_mag_pair.cuh"

extern "C" int mlx_stft_mag(const float* wav, long long n, const float* win,
                            const float2* tw, float* out, int n_frames,
                            int hop, float scale, cudaStream_t stream) {
  return static_cast<int>(mlx::launch_stft_mag_pair<2048>(
      wav, n, win, tw, out, n_frames, hop, scale, stream));
}

extern "C" const char* mlx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
