// 2048-point complex FFT in shared memory: the inverse DFT of B3's and
// B10's synthesis (pv_synth.cuh; B1 and B2 run the register-resident
// fft_pair.cuh).
//
// It replaces the four-step bf16x3 MXU factorisation of
// melonix_tpu/kernels/pallas_pv.py (_fwd_dft, _syn_body), which was a
// matrix-unit layout trick of the TPU.  Here the transform is an iterative
// radix-2 decimation-in-time FFT in float32 on the CUDA cores: input in
// bit-reversed order, 11 butterfly stages, one __syncthreads per stage.
// Twiddles come from a float32 table of cos/sin(2*pi*k/2048), k < 1024,
// computed in float64 on the host, so the only rounding is the butterflies'
// own (~11 float32 operations deep: about -130 dB against float64).  No
// tensor cores and no TF32 anywhere.
//
// Bounded on the H100 by shared-memory traffic and the stage barriers,
// not by device memory: a frame is 16 KB of data read once from HBM.
#pragma once

#include <cuda_runtime.h>

namespace mlx {

constexpr int kFftN = 2048;
constexpr int kFftLog2 = 11;
constexpr int kFftThreads = 256;  // block size of every kernel that calls it

__device__ __forceinline__ int bitrev11(int i) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - kFftLog2));
}

// Copy the (1024,) twiddle table from device memory into shared memory.
__device__ __forceinline__ void load_twiddles(float2* s_tw,
                                              const float2* __restrict__ tw) {
  for (int k = threadIdx.x; k < kFftN / 2; k += blockDim.x) s_tw[k] = tw[k];
}

// In-place DFT of `data` (2048 points, given in BIT-REVERSED order; the
// result is in natural order).  sign = -1: forward, X[k] = sum x[n] e^{-i..};
// sign = +1: inverse without the 1/N scale.  Every thread of the block must
// call it; it begins and ends with a barrier.
__device__ __forceinline__ void fft2048(float2* data, const float2* s_tw,
                                        float sign) {
  __syncthreads();
  int tstride = kFftN / 2;  // twiddle index step: angle = 2*pi*pos/(2*half)
  for (int lh = 0; lh < kFftLog2; ++lh, tstride >>= 1) {
    const int half = 1 << lh;
    for (int b = threadIdx.x; b < kFftN / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i = ((b >> lh) << (lh + 1)) + pos;
      const int j = i + half;
      const float2 w = s_tw[pos * tstride];
      const float wr = w.x, wi = sign * w.y;
      const float2 u = data[i], v = data[j];
      const float tr = v.x * wr - v.y * wi;
      const float ti = v.x * wi + v.y * wr;
      data[i] = make_float2(u.x + tr, u.y + ti);
      data[j] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

}  // namespace mlx
