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
// Design: one block of 256 threads per frame.  Threads read the frame
// coalesced, window it and store it packed into dynamic shared memory; the
// real-input DFT of fft_real.cuh runs there: a power-of-two N is one
// packed FFT, N = 2^a * m with m odd (1536 = 512 * 3) is m packed radix-2
// FFTs of the decimated samples plus a direct m-point sum per output bin.
// Shared memory is 4*N bytes (the wrapper caps N, kernels/stft.py).  At
// 4096/1024 on a 180 s track the frames read 32 MB and write 64 MB: device
// memory bounds it (~28 us at 3.35 TB/s), not the ~0.15 MFLOP per frame.
#include "fft_real.cuh"

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
