// The real-input DFT of one N-point frame that does not fit one block's
// shared memory (fft_real.cuh keeps 4*N bytes: at N = 65536 that is 256 KB,
// above the block's 227 KB), as a four-step transform through a scratch
// buffer in device memory.  Used by B7 (spectrogram_columns.cu) and B12
// (stft_mag_sizes.cu) above 49,152 points; below that both keep their
// one-block route.
//
// N = N1 * N2, N1 a power of two; sample x[n1 + N1*n2] (n1 < N1, n2 < N2).
//   1. Columns, one block per (frame, n1): the real N2-point DFT of the
//      strided column x[n1 + N1*n2] over n2; its bins C[n1, k2], k2 <= N2/2,
//      go to the scratch as row k2 (the other half is their mirror: the
//      column is real).  For N2 = 2^b * m (m odd) with b >= 2 and N2 <=
//      kMaxColumn it is fft_real.cuh's one-block route in shared memory,
//      4*N2 bytes; for any other N2 (an odd factor of N above 12,288) a
//      direct sum over n2 per bin, the column passing through shared memory
//      in tiles (four_step_direct).
//   2. Twiddles: Y[n1, k2] = W_N^(n1*k2) C[n1, k2], applied as step 3 reads.
//   3. Rows, one block per (frame, k2), k2 < N2: the complex N1-point DFT
//      over n1 (radix 2, bit-reversed input, 8*N1 bytes of shared memory)
//      gives X[k2 + N2*k1] for every k1; the caller's epilogue takes the
//      bins below N/2.
// The host picks (N1, N2) (kernels/stft.py:four_step_plan).  Twiddles are
// float32 tables (cos, sin)(2*pi*j/M), computed in float64 on the host:
// j < N/2 for M = N (steps 2-3); for step 1, M = N2, j < N2/2 on the FFT
// route and j < N2 (the whole circle: N2 may be odd) on the direct one.
// The direct route costs N * N2 / 2 multiply-adds a frame.  Speed is not this
// route's aim: the columns read strided samples and the rows write strided
// bins (each a sector per value).
#pragma once

#include "fft_real.cuh"

namespace mlx {

// The largest column the one-block real transform takes (4*N2 bytes of
// shared memory); kernels/stft.py's MAX_SIZE.
constexpr int kMaxColumn = 49152;
constexpr int kDirectTile = 1024;  // column samples a tile of the direct sum
constexpr int kDirectBins = 8;     // bins a thread accumulates a pass

struct FourStep {
  int n;       // N
  int n1;      // complex transforms' size, a power of two
  int log_n1;  // log2(N1)
  int n2;      // N / N1
  RealDft col;  // the real N2-point column transforms
};

__host__ __device__ inline FourStep make_four_step(int n, int n1) {
  FourStep f;
  f.n = n;
  f.n1 = n1;
  f.log_n1 = 0;
  while ((1 << f.log_n1) < n1) ++f.log_n1;
  f.n2 = n / n1;
  f.col = make_real_dft(f.n2);
  return f;
}

// Whether step 1 takes the direct sums: an N2 above kMaxColumn or without
// the power-of-two part of 4 that fft_real.cuh needs (the host's test is
// kernels/stft.py:four_step_direct).
__host__ __device__ inline bool four_step_direct(const FourStep& f) {
  return f.n2 > kMaxColumn || (f.n2 & 3) != 0;
}

// Scratch float2 values per frame: rows k2 = 0..N2/2 of N1 values.
__host__ __device__ inline long long four_step_scratch(const FourStep& f) {
  return static_cast<long long>(f.n2 / 2 + 1) * f.n1;
}

// Step 1 for column n1 of one frame: `load(p)` is sample p (0 <= p < N) of
// the frame; `c` the frame's scratch rows.  Every thread of the block calls
// it; `s` holds 4*N2 bytes of dynamic shared memory.
template <class Load>
__device__ __forceinline__ void four_step_column(float2* s,
                                                 const FourStep& f,
                                                 const float2* __restrict__ tw2,
                                                 int n1, Load load,
                                                 float2* __restrict__ c) {
  for (int q = threadIdx.x; q < f.n2; q += blockDim.x) {
    real_dft_put(s, f.col, q, load(n1 + f.n1 * q));
  }
  real_dft_fft(s, f.col, tw2);
  real_dft_post(s, f.col, tw2);
  for (int k2 = threadIdx.x; k2 <= f.n2 / 2; k2 += blockDim.x) {
    c[static_cast<long long>(k2) * f.n1 + n1] =
        real_dft_bin(s, f.col, tw2, k2);
  }
}

// Step 1 for column n1 by a direct sum (four_step_direct): bin k2 is
// sum_n2 x[n1 + N1*n2] W_N2^(n2*k2), the index n2*k2 mod N2 stepped by k2.
// `circle` holds (cos, sin)(2*pi*j/N2) for j < N2; `s` kDirectTile floats.
// Each thread keeps kDirectBins bins of a pass in registers.  Every thread
// of the block calls it.
template <class Load>
__device__ __forceinline__ void four_step_column_direct(
    float* s, const FourStep& f, const float2* __restrict__ circle, int n1,
    Load load, float2* __restrict__ c) {
  const int n_bins = f.n2 / 2 + 1;
  for (int k0 = 0; k0 < n_bins; k0 += kDirectBins * blockDim.x) {
    float2 acc[kDirectBins];
    int q[kDirectBins];  // n2 * k2 mod N2 at the next sample
#pragma unroll
    for (int i = 0; i < kDirectBins; ++i) {
      acc[i] = make_float2(0.0f, 0.0f);
      q[i] = 0;
    }
    for (int t0 = 0; t0 < f.n2; t0 += kDirectTile) {
      const int len = min(kDirectTile, f.n2 - t0);
      __syncthreads();  // the previous tile is read
      for (int p = threadIdx.x; p < len; p += blockDim.x) {
        s[p] = load(n1 + f.n1 * (t0 + p));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kDirectBins; ++i) {
        const int k2 = k0 + threadIdx.x + i * blockDim.x;
        if (k2 < n_bins) {
          float2 a = acc[i];
          int qq = q[i];
          for (int p = 0; p < len; ++p) {
            const float2 w = __ldg(circle + qq);  // W = w.x - i*w.y
            a.x += s[p] * w.x;
            a.y -= s[p] * w.y;
            qq += k2;
            if (qq >= f.n2) qq -= f.n2;
          }
          acc[i] = a;
          q[i] = qq;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDirectBins; ++i) {
      const int k2 = k0 + threadIdx.x + i * blockDim.x;
      if (k2 < n_bins) c[static_cast<long long>(k2) * f.n1 + n1] = acc[i];
    }
  }
}

// Steps 2-3 for row k2 of one frame: `store(k, X)` takes bin k < N/2.
// Every thread of the block calls it; `s` holds 8*N1 bytes.
template <class Store>
__device__ __forceinline__ void four_step_row(float2* s, const FourStep& f,
                                              const float2* __restrict__ tw,
                                              int k2,
                                              const float2* __restrict__ c,
                                              Store store) {
  const bool mirror = k2 > f.n2 / 2;  // C[n1, k2] = conj C[n1, N2 - k2]
  const float2* row =
      c + static_cast<long long>(mirror ? f.n2 - k2 : k2) * f.n1;
  for (int n1 = threadIdx.x; n1 < f.n1; n1 += blockDim.x) {
    float2 v = row[n1];
    if (mirror) v.y = -v.y;
    const float2 w = twiddle(tw, f.n, (n1 * k2) % f.n);  // W_N^(n1 k2)
    const int j = static_cast<int>(__brev(static_cast<unsigned>(n1)) >>
                                   (32 - f.log_n1));
    s[j] = make_float2(w.x * v.x - w.y * v.y, w.x * v.y + w.y * v.x);
  }
  // the N1-point complex FFT: fft_real.cuh's radix-2 stages with one
  // sub-transform of N1 points, twiddles W_N^(pos * N / (2 * half))
  RealDft d;
  d.n = f.n;
  d.m = 1;
  d.half = f.n1;
  d.log_half = f.log_n1;
  real_dft_fft(s, d, tw);
  for (int k1 = threadIdx.x; k1 < f.n1; k1 += blockDim.x) {
    const int k = k2 + f.n2 * k1;
    if (k < f.n / 2) store(k, s[k1]);
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in
// (host side; clears the error it reports).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();  // the call reports it once
  return err;
}

}  // namespace mlx
