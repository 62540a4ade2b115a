// Real-input DFT of one N-point frame in DYNAMIC shared memory: the DFT body
// of the spectrogram-column kernel (spectrogram_columns.cu, B7) and the
// |STFT| kernel for sizes other than 2048 (stft_mag_sizes.cu, B12).
//
// It replaces two TPU layouts: the four-step MXU factorisation of
// melonix_tpu/kernels/pallas_columns.py (_kernel) and the dense cos/sin
// matrix tiles of melonix_tpu/kernels/pallas_stft.py (_kernel).  Here the
// transform is a float32 FFT on the CUDA cores, no tensor cores, no TF32.
//
// N = L * m with L a power of two and m odd (m = 1 for powers of two).
//   * Decimation by m: x_r[n] = x[n*m + r], r < m, n < L.
//   * Each real x_r is packed as M = L/2 complex points z_r[j] = x_r[2j] +
//     i*x_r[2j+1] and transformed by an M-point radix-2 decimation-in-time
//     FFT (input in bit-reversed order, one __syncthreads per stage; the m
//     sub-transforms share the stages).
//   * The even/odd split post-pass turns Z_r into X_r[0..M-1]; X_r[0] and
//     X_r[M] are real, and X_r[M] is kept in the imaginary slot of X_r[0].
//   * X[k] = sum_r W_N^(r*k) X_r[k mod L] (Hermitian symmetry gives X_r[j]
//     for j > M), one direct m-point sum per output bin.
// Shared memory: m * M complex floats = 4*N bytes (128 KB at N = 32768,
// which is why the real-input packing is needed: a 32768-point complex
// transform would take 256 KB, above the block's 227 KB).
//
// Twiddles come from ONE float32 table tw[j] = (cos, sin)(2*pi*j/N),
// j < N/2, computed in float64 on the host, read through the read-only
// cache: the FFT stages use stride N/(2*half), the post-pass stride m, the
// m-point sum index (r*k) mod N with W^(q + N/2) = -W^q.
#pragma once

#include <cuda_runtime.h>

namespace mlx {

struct RealDft {
  int n;         // N, the real transform size
  int m;         // odd factor of N
  int half;      // M = N / (2m): complex points per sub-transform
  int log_half;  // log2(M)
};

// Split N into (m, L) and describe the transform.  N must be even with a
// power-of-two part of at least 4 (the kernels' callers guarantee far more).
__host__ __device__ inline RealDft make_real_dft(int n) {
  RealDft d;
  d.n = n;
  d.m = n;
  while ((d.m & 1) == 0) d.m >>= 1;
  d.half = n / d.m / 2;
  d.log_half = 0;
  while ((1 << d.log_half) < d.half) ++d.log_half;
  return d;
}

// Shared memory the transform needs, in bytes.
__host__ __device__ inline size_t real_dft_smem(const RealDft& d) {
  return static_cast<size_t>(d.m) * d.half * sizeof(float2);
}

// Store sample i (0 <= i < N) of the real input: it lands bit-reversed in
// its sub-transform, as the real (even n) or imaginary (odd n) part.
__device__ __forceinline__ void real_dft_put(float2* s, const RealDft& d,
                                             int i, float v) {
  int r = 0, q = i;
  if (d.m != 1) {
    q = i / d.m;
    r = i - q * d.m;
  }
  const int j = static_cast<int>(__brev(static_cast<unsigned>(q >> 1)) >>
                                 (32 - d.log_half));
  reinterpret_cast<float*>(s)[2 * (r * d.half + j) + (q & 1)] = v;
}

// W_N^q = exp(-2 pi i q / N) for 0 <= q < N.
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int n, int q) {
  if (q < n / 2) {
    const float2 w = __ldg(tw + q);
    return make_float2(w.x, -w.y);
  }
  const float2 w = __ldg(tw + (q - n / 2));
  return make_float2(-w.x, w.y);
}

// The m sub-transforms: M-point forward FFTs in place, bit-reversed input,
// natural-order output.  Every thread of the block calls it; it begins and
// ends with a barrier.
__device__ __forceinline__ void real_dft_fft(float2* s, const RealDft& d,
                                             const float2* __restrict__ tw) {
  __syncthreads();
  const int quarter = d.half / 2;  // butterflies per sub-transform per stage
  const int count = d.m * quarter;
  for (int lh = 0; lh < d.log_half; ++lh) {
    const int half = 1 << lh;
    const int tstride = d.n >> (lh + 1);  // angle 2*pi*pos/(2*half)
    for (int b = threadIdx.x; b < count; b += blockDim.x) {
      const int r = b >> (d.log_half - 1);
      const int bb = b & (quarter - 1);
      const int pos = bb & (half - 1);
      const int i = r * d.half + ((bb >> lh) << (lh + 1)) + pos;
      const int j = i + half;
      const float2 w = __ldg(tw + pos * tstride);  // W = w.x - i*w.y
      const float2 u = s[i], v = s[j];
      const float tr = v.x * w.x + v.y * w.y;
      const float ti = v.y * w.x - v.x * w.y;
      s[i] = make_float2(u.x + tr, u.y + ti);
      s[j] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// Even/odd split: Z_r (packed) -> X_r[0..M-1] in place, X_r[M] in the
// imaginary slot of X_r[0].  Thread pairs (k, M-k); ends with a barrier.
__device__ __forceinline__ void real_dft_post(float2* s, const RealDft& d,
                                              const float2* __restrict__ tw) {
  const int per = d.half / 2 + 1;  // pairs k = 0..M/2 per sub-transform
  for (int t = threadIdx.x; t < d.m * per; t += blockDim.x) {
    const int r = t / per;
    const int k = t - r * per;
    float2* z = s + r * d.half;
    if (k == 0) {
      const float2 z0 = z[0];
      z[0] = make_float2(z0.x + z0.y, z0.x - z0.y);
      continue;
    }
    const float2 zk = z[k], zm = z[d.half - k];
    const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
    const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
    const float2 w = __ldg(tw + k * d.m);  // W_L^k = w.x - i*w.y
    const float wox = w.x * ox + w.y * oy;
    const float woy = w.x * oy - w.y * ox;
    z[k] = make_float2(ex + wox, ey + woy);
    z[d.half - k] = make_float2(ex - wox, woy - ey);
  }
  __syncthreads();
}

// X_r[j] for 0 <= j < L = 2M, from the post-passed sub-transform r.
__device__ __forceinline__ float2 real_dft_sub_bin(const float2* s,
                                                   const RealDft& d, int r,
                                                   int j) {
  const float2* z = s + r * d.half;
  if (j == 0) return make_float2(z[0].x, 0.0f);
  if (j == d.half) return make_float2(z[0].y, 0.0f);
  if (j < d.half) return z[j];
  const float2 c = z[2 * d.half - j];
  return make_float2(c.x, -c.y);
}

// Bin k (0 <= k < N) of the N-point DFT, after real_dft_post.
__device__ __forceinline__ float2 real_dft_bin(const float2* s,
                                               const RealDft& d,
                                               const float2* __restrict__ tw,
                                               int k) {
  const int l = 2 * d.half;
  if (d.m == 1) return real_dft_sub_bin(s, d, 0, k);
  const int jk = k & (l - 1);
  float2 acc = real_dft_sub_bin(s, d, 0, jk);  // r = 0: W^0 = 1
  int q = 0;
  for (int r = 1; r < d.m; ++r) {
    q += k;
    if (q >= d.n) q -= d.n;
    const float2 w = twiddle(tw, d.n, q);
    const float2 x = real_dft_sub_bin(s, d, r, jk);
    acc.x += w.x * x.x - w.y * x.y;
    acc.y += w.x * x.y + w.y * x.x;
  }
  return acc;
}

}  // namespace mlx
