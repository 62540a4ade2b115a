// The real-input DFT of one N-point frame that no on-chip route takes, as a
// four-step transform through a scratch buffer in device memory: B12
// (stft_mag_sizes.cu) above 49,152 points at the sizes fft_large.cuh does
// not take (a power of two above 65,536, or any other size: 98,304 = 3 *
// 2^15, 512 * 16,411); below that B12 keeps its one-block route.  B7 takes
// none of it: its sizes above 49,152 run on chip (fft_large.cuh at 65,536,
// fft_mixed.cuh at the others).
//
// N = N1 * N2, N1 a power of two; sample x[n1 + N1*n2] (n1 < N1, n2 < N2).
//   1. Columns, one block per (frame, n1): the real N2-point DFT of the
//      strided column x[n1 + N1*n2] over n2; its bins C[n1, k2], k2 <= N2/2,
//      go to the scratch as row k2 (the other half is their mirror: the
//      column is real).  For N2 = 2^b * m (m odd) with b >= 2 and N2 <=
//      kMaxColumn it is fft_real.cuh's one-block route in shared memory,
//      4*N2 bytes.  Any other N2 (an odd factor of N above 12,288) takes
//      Bluestein's chirp-z form up to kBluesteinMax = 32,768 (two columns a
//      cluster, four_step_column_bluestein: 2 CTAs up to N2 = 16,384, 4
//      above) and above it a direct sum over n2 per bin, the column passing
//      through shared memory in tiles (four_step_direct).
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
// route costs N * N2 / 2 multiply-adds a frame, Bluestein's two L-point
// transforms per column pair.  The FFT columns read strided samples and the
// rows write strided bins (each a sector per value).
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

// Bluestein's form of step 1 (Large<16384> on a cluster of C CTAs, L = C *
// 16,384 points, C = bluestein_cluster(N2): 2 up to N2 = 16,384, 4 up to
// kBluesteinMax): the columns n1a and n1a + 1 as one complex sequence z[n2]
// = x[n1a + N1 n2] + i x[n1a + 1 + N1 n2], its N2-point DFT
//   Z[k] = conj(b_k) sum_n (z_n conj(b_n)) b_(k-n),  b_n = e^(i pi n^2 / N2)
// a circular convolution of length L >= 2 N2 - 1: the forward transform on
// the cluster (CTA r the points C m + r, then the cross-CTA radix-C step),
// whose epilogue multiplies by the chirp's spectrum (scaled by 1 / L), and
// the inverse by decimation in frequency (CTA q sums the C parts of P,
// P[n + j L / C] on CTA j, twiddled by W_C^(-q j), times W_L^(-q n), and
// transforms to the outputs C m + q).  The two real columns come apart by
// Hermitian symmetry, C_a[k] = (Z[k] + conj Z[N2-k]) / 2, C_b[k] = (Z[k] -
// conj Z[N2-k]) / 2i, for k <= N2 / 2, written to the scratch rows as one
// 16-byte store (n1a is even).  `tab` is kernels/stft.py:bluestein_table(N2)
// (BluesteinPlan<C>): b_n (n < N2), the spectrum (L), Large<16384>'s pass
// table, the cluster step's C - 1 rows W_L^(r k) (k < 16,384).  `load(n)`
// is the windowed pair (x[n1a + N1 n], x[n1a + 1 + N1 n]).  Every thread of
// the cluster calls it; `buf` holds Large<16384>::kSmem bytes.
constexpr int kBluesteinM = 16384;  // points a CTA transforms: Large<16384>
constexpr int kBluesteinMax = 2 * kBluesteinM;  // 4 CTAs: 2 N2 - 1 <= 65,536

// The cluster Bluestein takes for an N2-point column: 2 CTAs (L = 32,768)
// up to N2 = 16,384, 4 (L = 65,536) above (kernels/stft.py:bluestein_cluster).
__host__ __device__ constexpr int bluestein_cluster(int n2) {
  return n2 <= kBluesteinM ? 2 : 4;
}

template <int C>
struct BluesteinPlan {
  static constexpr int kL = C * kBluesteinM;  // the convolution's length
  // table offsets past the chirp's N2 entries
  static constexpr int kSpec = 0, kTw = kL;
  static constexpr int kMid = kTw + large::Large<kBluesteinM>::kTwiddles;
  static constexpr int kTable = kMid + (C - 1) * kBluesteinM;
};

template <int C, class Load>
__device__ __forceinline__ void four_step_column_bluestein(
    float2* buf, const FourStep& f, const float2* __restrict__ tab, int n1a,
    Load load, float2* __restrict__ c) {
  namespace cg = cooperative_groups;
  using BP = BluesteinPlan<C>;
  constexpr int H = kBluesteinM, T = large::Large<H>::kThreads;
  const cg::cluster_group cl = cg::this_cluster();
  const int q = static_cast<int>(cl.block_rank()), t = threadIdx.x;
  const int n2 = f.n2;
  const float2* chirp = tab;
  const float2* spec = tab + n2 + BP::kSpec;
  const float2* tw = tab + n2 + BP::kTw;
  const float2* mid = tab + n2 + BP::kMid;
  // forward: a_n = z_n conj(b_n), zero from N2 on; P[k + q H] = A[k + q H]
  // times the spectrum, in place
  large::fft_cluster<H, C>(
      [&](int n) {
        return n < n2 ? pairfft::ctw(load(n), __ldg(chirp + n), -1.0f)
                      : make_float2(0.0f, 0.0f);
      },
      buf, tw, mid, -1.0f, cl,
      [&](int k, float2 a) {
        return pairfft::ctw(a, __ldg(spec + k + q * H), 1.0f);
      });
  const float2* src[C];
#pragma unroll
  for (int j = 0; j < C; ++j) src[j] = cl.map_shared_rank(buf, j);
  // inverse, decimation in frequency; pass 1's writes wait for the peers'
  // reads of this buffer (the fence)
  large::fft<H>(
      [&](int n) {
        float2 acc = src[0][n];
#pragma unroll
        for (int j = 1; j < C; ++j) {
          acc = pairfft::cadd(acc, large::rot4(src[j][n], (4 / C) * q * j,
                                               1.0f));
        }
        return q ? pairfft::ctw(acc, __ldg(mid + (q - 1) * H + n), 1.0f)
                 : acc;
      },
      [&] { cl.sync(); }, buf, tw, 1.0f);
  cl.sync();  // conv[C m + q] is in buf[m] of CTA q
  auto z = [&](int k) {  // Z[k] = conj(b_k) conv[k]
    return pairfft::ctw(src[k % C][k / C], __ldg(chirp + k), -1.0f);
  };
  for (int k = C * t + q; k <= n2 / 2; k += C * T) {
    const float2 zk = z(k), zm = z(k == 0 ? 0 : n2 - k);
    *reinterpret_cast<float4*>(c + static_cast<long long>(k) * f.n1 + n1a) =
        make_float4(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y),
                    0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  }
  cl.sync();  // the peers' reads of this buffer are done
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
