// The real-input DFT of one N-point frame that no on-chip route takes, as a
// four-step transform through a scratch buffer in device memory.  B7
// (spectrogram_columns.cu) and B12 (stft_mag_sizes.cu) take it above 49,152
// points at the sizes fft_large.cuh does not (a power of two above 65,536,
// or any other size: 50,176 = 1024 * 49, 98,304 = 3 * 2^15); below that
// both keep their one-block route.
//
// N = N1 * N2, N1 a power of two; sample x[n1 + N1*n2] (n1 < N1, n2 < N2).
//   1. Columns, one block per (frame, n1): the real N2-point DFT of the
//      strided column x[n1 + N1*n2] over n2; its bins C[n1, k2], k2 <= N2/2,
//      go to the scratch as row k2 (the other half is their mirror: the
//      column is real).  For N2 = 2^b * m (m odd) with b >= 2 and N2 <=
//      kMaxColumn it is fft_real.cuh's one-block route in shared memory,
//      4*N2 bytes.  Any other N2 (an odd factor of N above 12,288) takes
//      Bluestein's chirp-z form up to kBluesteinMax (two columns a 2-CTA
//      cluster, four_step_column_bluestein) and above it a direct sum over
//      n2 per bin, the column passing through shared memory in tiles
//      (four_step_direct).
//   2. Twiddles: Y[n1, k2] = W_N^(n1*k2) C[n1, k2], applied as step 3 reads.
//   3. Rows, one block per (frame, k2), k2 < N2: the complex N1-point DFT
//      over n1 (radix 2, bit-reversed input, 8*N1 bytes of shared memory)
//      gives X[k2 + N2*k1] for every k1; the caller's epilogue takes the
//      bins below N/2.
// The host picks (N1, N2) (kernels/stft.py:four_step_plan).  Twiddles are
// float32 tables (cos, sin)(2*pi*j/M), computed in float64 on the host:
// j < N/2 for M = N (steps 2-3); for step 1, M = N2, j < N2/2 on the FFT
// route and j < N2 (the whole circle: N2 may be odd) on the direct one; the
// Bluestein route's table is kernels/stft.py:bluestein_table.  The direct
// route costs N * N2 / 2 multiply-adds a frame, Bluestein's two 32,768-point
// transforms per column pair.  Speed is not this route's aim: the columns
// read strided samples and the rows write strided bins (each a sector per
// value).
#pragma once

#include "fft_large.cuh"
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

// Bluestein's form of step 1 (Large<16384> on a 2-CTA cluster, L = 32,768
// points, N2 <= kBluesteinMax): the columns n1a and n1a + 1 as one complex
// sequence z[n2] = x[n1a + N1 n2] + i x[n1a + 1 + N1 n2], its N2-point DFT
//   Z[k] = conj(b_k) sum_n (z_n conj(b_n)) b_(k-n),  b_n = e^(i pi n^2 / N2)
// a circular convolution of length L >= 2 N2 - 1: the forward transform on
// the cluster (CTA r the points 2m + r, then the cross-CTA radix-2 step),
// the product with the chirp's spectrum (scaled by 1 / L) in registers, and
// the inverse by decimation in frequency (CTA 0 sums P[n] + P[n + L/2] and
// transforms to the even outputs, CTA 1 the twiddled differences to the odd
// ones).  The two real columns come apart by Hermitian symmetry,
// C_a[k] = (Z[k] + conj Z[N2-k]) / 2, C_b[k] = (Z[k] - conj Z[N2-k]) / 2i,
// for k <= N2 / 2, written to the scratch rows as one 16-byte store (n1a is
// even).  `tab` is kernels/stft.py:bluestein_table(N2): b_n (n < N2), the
// spectrum (L), Large<L/2>'s pass table, W_L^k (k < L/2).  `load(n)` is the
// windowed pair (x[n1a + N1 n], x[n1a + 1 + N1 n]).  Every thread of both
// CTAs calls it; `buf` holds Large<16384>::kSmem bytes.
constexpr int kBluesteinL = 32768;
constexpr int kBluesteinMax = kBluesteinL / 2;

template <class Load>
__device__ __forceinline__ void four_step_column_bluestein(
    float2* buf, const FourStep& f, const float2* __restrict__ tab, int n1a,
    Load load, float2* __restrict__ c) {
  namespace cg = cooperative_groups;
  constexpr int H = kBluesteinL / 2, T = large::Large<H>::kThreads;
  const cg::cluster_group cl = cg::this_cluster();
  const int r = static_cast<int>(cl.block_rank()), t = threadIdx.x;
  const int n2 = f.n2;
  const float2* chirp = tab;
  const float2* spec = tab + n2;
  const float2* tw = spec + kBluesteinL;
  const float2* mid = tw + large::Large<H>::kTwiddles;
  // forward: a_n = z_n conj(b_n), zero from N2 on
  large::fft_cluster<H>(
      [&](int n) {
        return n < n2 ? pairfft::ctw(load(n), __ldg(chirp + n), -1.0f)
                      : make_float2(0.0f, 0.0f);
      },
      buf, tw, mid, -1.0f, cl);
  const float2* peer = cl.map_shared_rank(buf, r ^ 1);
  // P[k + r H] = A[k + r H] * spectrum, in place
  for (int k = t; k < H; k += T) {
    buf[k] = pairfft::ctw(buf[k], __ldg(spec + k + r * H), 1.0f);
  }
  cl.sync();  // P complete on both CTAs
  // inverse, decimation in frequency; pass 1's writes wait for the peer's
  // reads of this buffer (the fence)
  large::fft<H>(
      [&](int n) {
        const float2 p0 = r ? peer[n] : buf[n], p1 = r ? buf[n] : peer[n];
        return r ? pairfft::ctw(pairfft::csub(p0, p1), __ldg(mid + n), 1.0f)
                 : pairfft::cadd(p0, p1);
      },
      [&] { cl.sync(); }, buf, tw, 1.0f);
  cl.sync();  // conv[2q + r] is in buf[q] of CTA r
  auto z = [&](int k) {  // Z[k] = conj(b_k) conv[k]
    const float2* src = (k & 1) == r ? buf : peer;
    return pairfft::ctw(src[k >> 1], __ldg(chirp + k), -1.0f);
  };
  for (int k = 2 * t + r; k <= n2 / 2; k += 2 * T) {
    const float2 zk = z(k), zm = z(k == 0 ? 0 : n2 - k);
    *reinterpret_cast<float4*>(c + static_cast<long long>(k) * f.n1 + n1a) =
        make_float4(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y),
                    0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  }
  cl.sync();  // the peer's reads of this buffer are done
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
