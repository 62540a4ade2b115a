// The real DFT of one N-point frame, N = L m (L = 2P a power of two, P =
// 512 ... 4096; m odd, 7 ... 63), held in the shared memory of a cluster of
// two CTAs: the transform under B7 (spectrogram_columns.cu) at the sizes
// 1024 j, j = 49 ... 63 (50,176 ... 64,512).  It replaces, for these sizes,
// the four-step MXU factorisation of
// melonix_tpu/kernels/pallas_columns.py:spectrogram_columns_fused.
//
// Decimation in time by m: x_s[n] = x[n m + s] (s < m, n < L), X_s its
// L-point DFT, and for k1 < L, k2 < m
//   X[k1 + L k2] = sum_s W_m^(s k2) v_s[k1],  v_s[k1] = W_N^(s k1) X_s[k1].
// A real frame of 196-252 KB does not fit one CTA (227 KB); split by the
// parity of s it fits two, each at most 16,384 complex points.
//   * Load: cluster.sync() (the peer runs), then CTA r reads the samples
//     [r N / 2, (r + 1) N / 2) once, coalesced, through the caller's
//     `sample(p)`, and stores each where its s lives: CTA s mod 2, sub-buffer
//     u = s / 2 (kStride float2 apart, odd, so a warp's stores spread over
//     the banks), packed as z_s[q] = x_s[2q] + i x_s[2q+1], natural order,
//     through distributed shared memory for the peer's half.  A second
//     cluster.sync() and the frame is on chip.
//   * Three Stockham passes (fft_large.cuh's Large<M> with its fourth pass
//     dropped: radix 16, 16 and R = P / 256) transform each CTA's U = (m + 1
//     - r) / 2 sub-sequences together: at most 16,384 points, so passes 1-2
//     are at most 1024 16-point DFTs, two a thread, in registers.  Pass 1
//     reads the staged z and writes its exchange padded (a -> a + a / 16);
//     pass 3 writes where it read.  The result Z_s is in natural order.
//   * Split and twiddle, in place: X_s[k] and X_s[P - k] from Z_s[k] and
//     Z_s[P - k] (fft_large.cuh's split_bin, W_L^k = W_N^(k m)), times
//     W_N^(s k); v_s[P] goes to slot P (the padding).  cluster.sync().
//   * The m-point DFTs over s: CTA 0 takes k1 < P / 2, CTA 1 P / 2 <= k1
//     <= P, each (k1, group of kGroup pairs (p, m - p)) one thread's item; v_s[k1] is read from CTA s mod 2 (half of them
//     through distributed shared memory), the (cos, sin)(2 pi s p / m)
//     from a table staged in shared memory, four multiply-adds a pair:
//     Y[p] = sum v_s W_m^(s p) and Y[m - p] = sum v_s W_m^(-s p).  Y[p] is
//     bin k1 + L p (k1 < P); Y[m - p] is the conjugate of bin (L - k1) +
//     L (p - 1) (k1 > 0); Y[0] is bin k1 (k1 < P).  Every bin k < N / 2 is
//     stored once, by the caller's `store(k, v)` (|v| only: the conjugate
//     does not matter), consecutive k1 on consecutive lanes.  cluster.sync()
//     before exit (the peer's reads).
// One launch, one read of the frame, one write of its bins, no scratch in
// device memory.  Shared memory: (m + 1) / 2 * kStride float2 of
// sub-sequences and m (m - 1) / 2 of the table, at most 155,144 bytes, so
// one CTA a SM: 64 columns are 128 CTAs, one wave.
//
// Twiddles: one float32 table a size, computed in float64 on the host
// (kernels/columns.py:cluster_table; MixedPlan gives the offsets): W_256^x
// (x < 256, pass 2), W_P^x (x < P, pass 3), W_N^x for x < 128 and
// W_N^(128 y) for y < N / 256 (W_N^x for any x < N / 2 as one product of
// the two), the m-point DFT's (cos, sin)(2 pi s p / m) (s < m, 1 <= p <=
// (m - 1) / 2).  No __sincosf, no TF32, no tensor cores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_pair.cuh"

namespace mlx {
namespace mixed {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kGroup = 8;  // pairs (p, m - p) a thread accumulates at once

// Layout of the P-point sub-transforms (L = 2P real points each).
template <int P>
struct Mixed {
  static constexpr int kR = P / 256;  // radix of pass 3
  static constexpr int kQ = P / 16;   // 16-point DFTs a sub-sequence
  // float2 a sub-sequence: pass 1's padded exchange and slot P, odd
  static constexpr int kStride = P + P / 16 + 1;
  static_assert(P >= 512 && P <= 4096 && 256 * kR == P, "P = 512 ... 4096");
};

// The size's m, half count h = (m - 1) / 2 and table offsets (float2).
struct MixedPlan {
  int n, m, h, l;
  int lo, hi, comb;  // W_N^x (x < 128), W_N^(128 y), the m-point DFT's
};

__host__ __device__ inline MixedPlan make_mixed_plan(int n, int p) {
  MixedPlan mp;
  mp.n = n;
  mp.l = 2 * p;
  mp.m = n / mp.l;
  mp.h = (mp.m - 1) / 2;
  mp.lo = 256 + p;
  mp.hi = mp.lo + 128;
  mp.comb = mp.hi + n / 256;
  return mp;
}

// Shared memory of the transform, in bytes.
__host__ __device__ inline size_t mixed_smem(const MixedPlan& mp, int p) {
  const int stride = p + p / 16 + 1;
  return (static_cast<size_t>((mp.m + 1) / 2) * stride +
          static_cast<size_t>(mp.m) * mp.h) *
         sizeof(float2);
}

__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

// (cos, sin)(2 pi x / N) for x < N / 2: the product of two table entries.
__device__ __forceinline__ float2 wn(const float2* __restrict__ tw,
                                     const MixedPlan& mp, int x) {
  const float2 a = __ldg(tw + mp.hi + (x >> 7));
  const float2 b = __ldg(tw + mp.lo + (x & 127));
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The real N-point DFT of the frame x[p] = sample(p) (p < N) on a cluster of
// two CTAs: store(k, X[k]) for every bin k < N / 2, each once, by one of the
// two (up to the sign of X's imaginary part).  tw is the size's table
// (kernels/columns.py:cluster_table); smem holds mixed_smem bytes.  Every
// thread of the cluster calls it once.
template <int P, class Sample, class Store>
__device__ __forceinline__ void real_fft_cluster(const MixedPlan& mp,
                                                 Sample sample, Store store,
                                                 float2* smem,
                                                 const float2* __restrict__ tw) {
  using X = Mixed<P>;
  constexpr int T = kThreads, S = X::kStride, Q = X::kQ, R = X::kR;
  const cg::cluster_group cl = cg::this_cluster();
  const int r = static_cast<int>(cl.block_rank()), t = threadIdx.x;
  const int m = mp.m, h = mp.h, l = mp.l, n_half = mp.n / 2;
  const int n_sub = (m + 1 - r) / 2;  // this CTA's s = 2u + r
  float2* ctab = smem + static_cast<size_t>((m + 1) / 2) * S;
  float2* peer = cl.map_shared_rank(smem, r ^ 1);

  // -- load: this CTA's half of the frame, each sample where its s lives
  cl.sync();  // the peer runs: its shared memory may be written
  {
    float* dst[2] = {reinterpret_cast<float*>(r ? peer : smem),
                     reinterpret_cast<float*>(r ? smem : peer)};
    int p = r * n_half + t;
    int s = p % m, nn = p / m;
    const int ds = T % m, dn = T / m;
    for (; p < (r + 1) * n_half; p += T) {
      dst[s & 1][2 * ((s >> 1) * S + (nn >> 1)) + (nn & 1)] = sample(p);
      s += ds;
      nn += dn;
      if (s >= m) {
        s -= m;
        ++nn;
      }
    }
  }
  for (int i = t; i < m * h; i += T) ctab[i] = __ldg(tw + mp.comb + i);
  cl.sync();  // both halves of the frame are staged

  // -- pass 1 (Ns = 1): the staged z, 16-point DFTs, padded exchange
  float2 v[2][16];
  const int jobs = n_sub * Q;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = t + T * e;
    if (g < jobs) {
      const float2* in = smem + (g / Q) * S + g % Q;
#pragma unroll
      for (int a = 0; a < 16; ++a) v[e][a] = in[Q * a];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = t + T * e;
    if (g < jobs) {
      const int j = g % Q;
      float2* out = smem + (g / Q) * S;
      pairfft::dft_regs<16>(v[e], -1.0f);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        out[17 * j + k] = v[e][pairfft::brev(k, 4)];  // pad(16 j + k)
      }
    }
  }
  __syncthreads();
  // -- pass 2 (Ns = 16): twiddles W_256^((j mod 16) a)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = t + T * e;
    if (g < jobs) {
      const float2* in = smem + (g / Q) * S;
      const int j = g % Q;
#pragma unroll
      for (int a = 0; a < 16; ++a) v[e][a] = in[pad(j + Q * a)];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = t + T * e;
    if (g < jobs) {
      const int j = g % Q, jm = j & 15;
      float2* out = smem + (g / Q) * S + (j >> 4) * 256 + jm;
#pragma unroll
      for (int a = 1; a < 16; ++a) {
        v[e][a] = pairfft::ctw(v[e][a], __ldg(tw + jm * a), -1.0f);
      }
      pairfft::dft_regs<16>(v[e], -1.0f);
#pragma unroll
      for (int k = 0; k < 16; ++k) out[16 * k] = v[e][pairfft::brev(k, 4)];
    }
  }
  __syncthreads();
  // -- pass 3 (Ns = 256, radix R): twiddles W_P^(j a); lands where it read
  for (int g = t; g < n_sub * 256; g += T) {
    const int j = g & 255;
    float2* io = smem + (g >> 8) * S + j;
    float2 u[R];
#pragma unroll
    for (int a = 0; a < R; ++a) u[a] = io[256 * a];
#pragma unroll
    for (int a = 1; a < R; ++a) {
      u[a] = pairfft::ctw(u[a], __ldg(tw + 256 + j * a), -1.0f);
    }
    pairfft::dft_regs<R>(u, -1.0f);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      io[256 * k] = u[pairfft::brev(k, pairfft::ilog2(R))];
    }
  }
  __syncthreads();

  // -- split Z_s into X_s[k], k <= P, and twiddle by W_N^(s k), in place
  for (int g = t; g < n_sub * (P / 2); g += T) {
    const int k = g & (P / 2 - 1), s = 2 * (g / (P / 2)) + r;
    float2* z = smem + (g / (P / 2)) * S;
    if (k == 0) {
      const float2 z0 = z[0], zq = z[P / 2];
      z[0] = make_float2(z0.x + z0.y, 0.0f);
      z[P] = pairfft::ctw(make_float2(z0.x - z0.y, 0.0f), wn(tw, mp, s * P),
                          -1.0f);
      z[P / 2] = pairfft::ctw(make_float2(zq.x, -zq.y),
                              wn(tw, mp, s * (P / 2)), -1.0f);
    } else {
      const float2 zk = z[k], zm = z[P - k], w = wn(tw, mp, k * m);
      const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
      const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
      const float wox = w.x * ox + w.y * oy, woy = w.x * oy - w.y * ox;
      z[k] = pairfft::ctw(make_float2(ex + wox, ey + woy), wn(tw, mp, s * k),
                          -1.0f);
      z[P - k] = pairfft::ctw(make_float2(ex - wox, woy - ey),
                              wn(tw, mp, s * (P - k)), -1.0f);
    }
  }
  cl.sync();  // v_s on both CTAs

  // -- the m-point DFTs over s for this CTA's k1
  const int k_first = r * (P / 2), n_k = P / 2 + r;
  const int n_groups = (h + kGroup - 1) / kGroup;
  for (int item = t; item < n_k * n_groups; item += T) {
    const int grp = item / n_k, k1 = k_first + item % n_k;
    const int p0 = grp * kGroup + 1, cnt = min(kGroup, h - grp * kGroup);
    float2 y0 = make_float2(0.0f, 0.0f);
    float a[kGroup], b[kGroup], c[kGroup], d[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) a[i] = b[i] = c[i] = d[i] = 0.0f;
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const float2* src = (par == r ? smem : peer) + k1;
      for (int s = par; s < m; s += 2) {
        const float2 x = src[(s >> 1) * S];
        const float2* w = ctab + s * h + p0 - 1;
        y0.x += x.x;
        y0.y += x.y;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (i < cnt) {
            const float2 cs = w[i];
            a[i] += x.x * cs.x;
            b[i] += x.y * cs.y;
            c[i] += x.y * cs.x;
            d[i] += x.x * cs.y;
          }
        }
      }
    }
    if (grp == 0 && k1 < P) store(k1, y0);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i < cnt) {
        const int p = p0 + i;
        if (k1 < P) store(k1 + l * p, make_float2(a[i] + b[i], c[i] - d[i]));
        if (k1 > 0) {
          store(l - k1 + l * (p - 1), make_float2(a[i] - b[i], c[i] + d[i]));
        }
      }
    }
  }
  cl.sync();  // the peer's reads of this CTA's buffer are done
}

}  // namespace mixed
}  // namespace mlx
