// B8: per-frame mean subtraction and linear autocorrelation of the pitch
// engine (Wiener-Khinchin at twice the frame length).
//
// Replaces melonix_tpu/kernels/pallas_pitch.py:pitch_ac_pallas (_kernel),
// the TPU's slab DMA + mean-subtract + forward and inverse four-step bf16x3
// MXU DFTs at N = 4096 in a scrambled bin order (order-free because the
// power spectrum is elementwise).  Here the bins stay in natural order and
// both transforms are the float32 real-input FFT of fft_real.cuh on the
// CUDA cores: no tensor cores, no TF32, no cuFFT.
//
// Contract: frame f covers wav[f*hop, f*hop + 2048), zeros past n;
//   w[f, i]  = x_f[i] - mean(x_f)                        (F, 2048) float32
//   ac[f, t] = irfft(|rfft(w_f, 4096)|^2, 4096)[t], t < 2048
// the linear (not circular) autocorrelation of w_f.
//
// Design: one block of 256 threads per frame, 24 KB of static shared
// memory (the 4096-point transform as 2048 packed complex points, plus the
// 2049-bin power spectrum).
//   1. Threads read the frame coalesced (8 samples each), sum them, and
//      reduce the sum over the block in a fixed order (warp shuffles, then
//      the 8 warp sums in warp order): every thread gets the same mean.
//   2. w goes out coalesced and into shared memory, zero-padded to 4096.
//   3. Forward transform; power |X[k]|^2 for k = 0..2048 into its own
//      shared array (the transform's buffer is rewritten next).
//   4. The power spectrum mirrored to all 4096 points is real and even, so
//      its inverse DFT is the real part of its FORWARD DFT over 4096: the
//      same real-input transform serves both directions.  ac = Re X[t]/4096
//      for t < 2048, out coalesced.
// Bound on the card: 8 KB read + 16 KB written per frame and ~2 x 2.5 N
// log2 N flops at N = 4096: device memory bounds it at the H100's rates;
// the two transforms' 24 barrier-separated shared-memory stages are what a
// block waits on, and 8 blocks per SM hide part of that.
#include "fft_real.cuh"

namespace {

constexpr int kFrame = 2048;
constexpr int kN = 2 * kFrame;  // zero-padded linear-correlation length
constexpr int kBins = kN / 2 + 1;
constexpr int kThreads = 256;
constexpr int kPer = kFrame / kThreads;  // samples per thread
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
pitch_ac_kernel(const float* __restrict__ wav, long long n,
                const float2* __restrict__ tw, float* __restrict__ ac,
                float* __restrict__ w, int hop) {
  __shared__ float2 s[kN / 2];
  __shared__ float pw[kBins];
  __shared__ float warp_sum[kWarps];
  const mlx::RealDft d = mlx::make_real_dft(kN);
  const long long start = static_cast<long long>(blockIdx.x) * hop;
  const long long row = static_cast<long long>(blockIdx.x) * kFrame;

  // 1. frame samples and their block-wide mean
  float x[kPer];
  float part = 0.0f;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long idx = start + threadIdx.x + r * kThreads;
    x[r] = idx < n ? __ldg(wav + idx) : 0.0f;
    part += x[r];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = part;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += warp_sum[i];
  const float mean = total * (1.0f / kFrame);

  // 2. w out, and into the transform zero-padded to kN
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const float v = x[r] - mean;
    w[row + i] = v;
    mlx::real_dft_put(s, d, i, v);
    mlx::real_dft_put(s, d, i + kFrame, 0.0f);
  }

  // 3. forward transform, power spectrum over bins 0..kN/2
  mlx::real_dft_fft(s, d, tw);
  mlx::real_dft_post(s, d, tw);
  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    const float2 v = mlx::real_dft_sub_bin(s, d, 0, k);
    pw[k] = v.x * v.x + v.y * v.y;
  }
  __syncthreads();  // every read of s is done before s is rewritten

  // 4. the mirrored power spectrum's forward transform = its inverse * kN
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    mlx::real_dft_put(s, d, i, pw[i < kBins ? i : kN - i]);
  }
  mlx::real_dft_fft(s, d, tw);
  mlx::real_dft_post(s, d, tw);
  for (int t = threadIdx.x; t < kFrame; t += kThreads) {
    ac[row + t] = mlx::real_dft_sub_bin(s, d, 0, t).x * (1.0f / kN);
  }
}

}  // namespace

extern "C" int mlx_pitch_ac(const float* wav, long long n, const float2* tw,
                            float* ac, float* w, int n_frames, int hop,
                            cudaStream_t stream) {
  if (n_frames <= 0 || hop <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pitch_ac_kernel<<<n_frames, kThreads, 0, stream>>>(wav, n, tw, ac, w, hop);
  return static_cast<int>(cudaGetLastError());
}
