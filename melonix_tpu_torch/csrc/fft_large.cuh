// A complex FFT of M = 16,384 points in one CTA and of C M points on a
// cluster of C = 2 or 4 CTAs, held in shared memory, and the real-input
// transforms built on them: the transform under B7 (spectrogram_columns.cu)
// at the powers of two 1024 ... 65,536 (up to 16,384 on fft_pair.cuh) and
// B12 (stft_mag_sizes.cu) at 16,384, 32,768 and 65,536 points, and under
// B12's Bluestein columns (fft_fourstep.cuh: 32,768 points on two CTAs,
// 65,536 on four).  It replaces, for these sizes, the four-step MXU
// factorisation of melonix_tpu/kernels/pallas_columns.py and the dense
// DFT-matrix tiles of melonix_tpu/kernels/pallas_stft.py.
//
// Large<M> (M = 16,384 = 4096 * R4, R4 = 4): a CTA of T = M / 32 = 512
// threads, in place in ONE shared buffer of M + M / 16 float2 (139,264
// bytes: two buffers would not fit the block's 227 KB).  Four Stockham
// passes of radix 16, 16, 16 and R4; pass p with Ns = 16^(p-1) (4096 for
// pass 4) takes, for each j < M / R (R its radix), the R points
// in[j + (M / R) r], multiplies point r by W_(R Ns)^((j mod Ns) r), runs an
// R-point DFT in registers (fft_pair.cuh's dft_regs) and writes output k to
// (j / Ns) R Ns + (j mod Ns) + Ns k.  The result is in natural order.
//   * Passes 1-3 are M / 16 16-point DFTs: thread t takes j = t and t + T,
//     32 points in registers.  In place, a pass reads all its points, meets
//     a barrier, then writes; pass 1 reads through the caller's `load` and
//     meets the caller's `fence` instead (a no-op when the input lies
//     elsewhere; a cluster barrier when it is a buffer the peers still
//     read).  Pass 4 writes where it read (j < 4096): no barrier.
//   * Banks: a half-warp's 8-byte accesses fall on distinct banks when their
//     float2 indices differ mod 16.  Every read is along j (consecutive),
//     and so are the writes of passes 2-4; pass 1 writes 16 j + k, so its
//     exchange is padded, a -> a + a / 16 (17 j + k), and pass 2 reads it
//     padded.  tests/test_torch_fft_large.py enumerates every access.
//   * Six barriers a transform, against fourteen for radix-2 stages at
//     32,768 real points.
// fft_cluster<M, C> (C M points): CTA r of the cluster transforms the points
// C m + r with Large<M> in its own buffer, Y_r, then one radix-C step reads
// the peers' buffers through distributed shared memory: CTA q forms
// X[k + q M] = sum_r W_C^(q r) W_(CM)^(r k) Y_r[k], every buffer read at
// the same k.  cluster.sync() orders the steps: before the first remote read
// (the peers' transforms are done), after the last (before a CTA overwrites
// its buffer with its part of X) and before the caller reads X across the
// cluster.
//
// Real input: an N-point real frame packs as z[q] = x[2q] + i x[2q+1], N / 2
// complex points (RealPlan<N>: 1024 ... 16,384 real on fft_pair.cuh's
// Pair<N / 2>, 32,768 on Large<16384>, 65,536 on the cluster of two; B7
// takes all seven, B12 the three from 16,384), and the split X[k]
// = (Z[k] + conj Z[N/2-k]) / 2 - i W_N^k (Z[k] - conj Z[N/2-k]) / 2 gives
// bins k < N / 2 in the caller's `store`.  On the cluster CTA r stores bins
// [r N / 4, (r + 1) N / 4); Z[N/2 - k] is then mostly the peer's.  Sample i
// is wav[first + i] times the caller's `scale(i)` (window, decay), read
// where it lies as pass 1 needs it.
//
// Twiddles: one float32 table per size, computed in float64 on the host
// (kernels/stft.py:large_twiddles; RealPlan<N> gives the offsets):
// the CTA transform's (fft_pair.cuh's, or Large<M>'s pass table: dense
// W_256 and W_4096 tables whose strided reads stay in L1, and W_M^j, j <
// 4096, whose powers pass 4 forms by two products), the cluster step's
// W_2M^k (k < M), the split's W_N^k (k < N / 2).  The cluster step of C CTAs
// reads C - 1 rows, row r - 1 holding W_(CM)^(r k), k < M.  No __sincosf, no
// TF32, no tensor cores.
//
// Bounds on the card: one column or frame of 32,768 real points reads 128
// KB and writes 64 KB; device memory bounds a 256-column drain (~14 us at
// 3.35 TB/s).  Each Large<16384> CTA holds 139 KB of shared memory and 512
// threads at up to 128 registers, so one CTA fills an SM: a 256-column
// drain is 1.94 waves on 132 SMs, and a 64-column drain at 65,536 points is
// 128 CTAs in one wave.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_pair.cuh"

namespace mlx {

// Launch `kernel` on `grid` CTAs of `threads` threads with `smem` bytes of
// dynamic shared memory, in clusters of `cluster` CTAs along x (1: none).
// Allows the kernel the shared memory first; for a cluster, asks whether
// the card can hold one at all and refuses the launch if not.  Returns the
// launch's error (and clears it).
template <class... Exp, class... Act>
cudaError_t launch_clustered(void (*kernel)(Exp...), dim3 grid, int threads,
                             size_t smem, int cluster, cudaStream_t stream,
                             Act&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  if (err == cudaSuccess && cluster > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(kernel), &cfg);
    if (err == cudaSuccess && clusters < 1) {
      err = cudaErrorLaunchOutOfResources;
    }
  }
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  }
  if (err != cudaSuccess) cudaGetLastError();  // the caller reports it once
  return err;
}

namespace large {

namespace cg = cooperative_groups;

template <int M>
struct Large {
  static constexpr int kR4 = M / 4096;        // radix of pass 4
  static constexpr int kThreads = M / 32;     // 512 at 16,384
  static constexpr int kQ = M / 16;           // 16-point DFTs of passes 1-3
  static constexpr int kSets = kQ / kThreads;  // j's a thread takes in them
  static constexpr int kQ4 = M / kR4;         // R4-point DFTs of pass 4
  static constexpr int kBuf = M + M / 16;     // float2: exchange 1 padded
  static constexpr size_t kSmem = kBuf * sizeof(float2);
  // The pass table (kstft.large_pass_table): W_256^x (x < 256) for pass 2,
  // W_4096^x (x < 4096) for pass 3, W_M^j (j < 4096) for pass 4.
  static constexpr int kTw2 = 0, kTw3 = 256, kTw4 = 256 + 4096;
  static constexpr int kTwiddles = kTw4 + 4096;
  static_assert(M == 16384 && kSets == 2 && kQ4 == 4096, "M = 16,384");
};

__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

// Passes 2 and 3 (Ns = 16, 256): read every point of both sets, barrier,
// twiddle, 16-point DFT, write, barrier.
template <int M, int Ns, bool kPaddedIn>
__device__ __forceinline__ void pass16(float2 (&v)[2][16], float2* buf,
                                       const float2* __restrict__ tw,
                                       float sign) {
  using L = Large<M>;
  constexpr int T = L::kThreads, Q = L::kQ;
  // W_(16 Ns)^x, x < 16 Ns, dense: a half-warp's reads stay in L1
  const float2* __restrict__ w = tw + (Ns == 16 ? L::kTw2 : L::kTw3);
  const int t = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int a = t + T * h + Q * r;
      v[h][r] = buf[kPaddedIn ? pad(a) : a];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = t + T * h, jm = j & (Ns - 1);
#pragma unroll
    for (int r = 1; r < 16; ++r) {
      v[h][r] = pairfft::ctw(v[h][r], __ldg(w + jm * r), sign);
    }
    pairfft::dft_regs<16>(v[h], sign);
    const int base = (j / Ns) * 16 * Ns + jm;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      buf[base + Ns * k] = v[h][pairfft::brev(k, 4)];
    }
  }
  __syncthreads();
}

// The M-point transform of z[q] = load(q) (q < M) into buf[0, M) in natural
// order.  sign = -1 forward, +1 inverse without the 1/M scale.  tw is the
// pass table (Large<M>::kTw*).  `fence()` runs after pass 1 has read
// all its points and before it writes buf.  Every thread of the CTA calls
// it; it ends with a barrier.
template <int M, class Load, class Fence>
__device__ __forceinline__ void fft(Load load, Fence fence, float2* buf,
                                    const float2* __restrict__ tw,
                                    float sign) {
  using L = Large<M>;
  constexpr int T = L::kThreads, Q = L::kQ, R4 = L::kR4, Q4 = L::kQ4;
  const int t = threadIdx.x;
  float2 v[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < 16; ++r) v[h][r] = load(t + T * h + Q * r);
  }
  fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pairfft::dft_regs<16>(v[h], sign);
    const int j = t + T * h;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      buf[17 * j + k] = v[h][pairfft::brev(k, 4)];  // pad(16 j + k)
    }
  }
  __syncthreads();
  pass16<M, 16, true>(v, buf, tw, sign);
  pass16<M, 256, false>(v, buf, tw, sign);
#pragma unroll 2
  for (int h = 0; h < Q4 / T; ++h) {
    const int j = t + T * h;  // < 4096: the output lands where it was read
    float2 u[R4];
#pragma unroll
    for (int r = 0; r < R4; ++r) u[r] = buf[j + Q4 * r];
    // W_M^(j r) = (W_M^j)^r: one coalesced read, the powers by products
    const float2 w1 = __ldg(tw + L::kTw4 + j);
    float2 w = w1;
#pragma unroll
    for (int r = 1; r < R4; ++r) {
      u[r] = pairfft::ctw(u[r], w, sign);
      w = make_float2(w.x * w1.x - w.y * w1.y, w.x * w1.y + w.y * w1.x);
    }
    pairfft::dft_regs<R4>(u, sign);
#pragma unroll
    for (int k = 0; k < R4; ++k) {
      buf[j + Q4 * k] = u[pairfft::brev(k, pairfft::ilog2(R4))];
    }
  }
  __syncthreads();
}

// a * e^(sign 2 pi i e / 4), e < 4: exact (a swap and sign changes).
__device__ __forceinline__ float2 rot4(float2 a, int e, float sign) {
  switch (e & 3) {
    case 0: return a;
    case 1: return make_float2(-sign * a.y, sign * a.x);
    case 2: return make_float2(-a.x, -a.y);
    default: return make_float2(sign * a.y, -sign * a.x);
  }
}

// fft_cluster's default epilogue: X as it is.
struct KeepX {
  __device__ __forceinline__ float2 operator()(int, float2 x) const {
    return x;
  }
};

// The C M-point transform (Large<M> on each CTA, C = 2 or 4) of z[q] =
// load(q), q < C M, on a cluster of C CTAs: on return CTA q's buf[k] holds
// post(k, X[k + q M]) and every remote read of the step is ordered (the
// caller reads buf across the cluster and ends with cl.sync() before it
// exits or overwrites buf).  tw: Large<M>'s pass table; mid: C - 1 rows of
// M, row r - 1 the (cos, sin)(2 pi r k / (C M)), k < M.
template <int M, int C, class Load, class Post = KeepX>
__device__ __forceinline__ void fft_cluster(Load load, float2* buf,
                                            const float2* __restrict__ tw,
                                            const float2* __restrict__ mid,
                                            float sign,
                                            const cg::cluster_group& cl,
                                            Post post = Post()) {
  static_assert(C == 2 || C == 4, "a cluster of 2 or 4 CTAs");
  constexpr int T = Large<M>::kThreads, kPer = M / T;
  const int q = static_cast<int>(cl.block_rank()), t = threadIdx.x;
  fft<M>([&](int m) { return load(C * m + q); }, [] {}, buf, tw, sign);
  cl.sync();  // the peers' parts are transformed
  const float2* src[C];
#pragma unroll
  for (int r = 0; r < C; ++r) src[r] = cl.map_shared_rank(buf, r);
  float2 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = t + T * i;
    float2 acc = src[0][k];
#pragma unroll
    for (int r = 1; r < C; ++r) {
      const float2 y = pairfft::ctw(src[r][k], __ldg(mid + (r - 1) * M + k),
                                    sign);
      acc = pairfft::cadd(acc, rot4(y, (4 / C) * q * r, sign));
    }
    x[i] = post(k, acc);
  }
  cl.sync();  // every remote read of buf is done
#pragma unroll
  for (int i = 0; i < kPer; ++i) buf[t + T * i] = x[i];
  cl.sync();  // X is in place on every CTA
}

// Bin k of the N-point real frame from the packed transform's Z[k], Z[M-k]
// and w = (cos, sin)(2 pi k / N).
__device__ __forceinline__ float2 split_bin(float2 zk, float2 zm, float2 w) {
  const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
  const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
  const float wox = w.x * ox + w.y * oy, woy = w.x * oy - w.y * ox;
  return make_float2(ex + wox, ey + woy);
}

// Launch shape and table offsets of the real N-point transform (N = 1024
// ... 65,536, a power of two): 65,536 points do not fit one CTA's shared
// memory and take a 2-CTA cluster.  A CTA holds kM = N / 2 / kCluster
// packed points: up to 8192 fft_pair.cuh's Pair<kM> (N / 32 threads),
// 16,384 Large<16384>.  The table (kstft.large_twiddles): the CTA
// transform's (kpv.pair_twiddles(kM), or Large<16384>'s pass table), on the
// cluster the radix-2 step's W_2kM^k (k < kM) at kMid, then the split's
// W_N^k (k < N / 2) at kSplit.
template <int N>
struct RealPlan {
  static constexpr int kCluster = N == 65536 ? 2 : 1;
  static constexpr int kM = N / 2 / kCluster;
  static constexpr bool kPair = kM <= 8192;
  using P = pairfft::Pair<kPair ? kM : 8192>;
  using L = Large<16384>;
  static constexpr int kThreads = kPair ? P::kThreads : L::kThreads;
  static constexpr int kMinBlocks = kPair ? P::kMinBlocks : 1;
  static constexpr size_t kSmem = kPair ? P::kSmem : L::kSmem;
  static constexpr int kMid = kPair ? P::kTwiddles : L::kTwiddles;
  static constexpr int kSplit = kMid + (kCluster == 2 ? kM : 0);
  static_assert(N >= 1024 && N <= 65536 && (N & (N - 1)) == 0,
                "N = 1024 ... 65,536, a power of two");
};

// The real N-point DFT of the frame x[i] = wav[first + i] * scale(i) (i < N;
// the read is 0 outside [0, n)): store(k, X[k]) for the bins k < N / 2 this
// CTA owns (all of them, or half on the cluster).  Pass 1 reads each sample
// where it lies.  tw is the size's table (RealPlan<N>).  Every thread of the
// CTA (and of the cluster) calls it once; shared memory is
// RealPlan<N>::kSmem bytes.
template <int N, class Scale, class Store>
__device__ __forceinline__ void real_fft(const float* __restrict__ wav,
                                         long long n, long long first,
                                         Scale scale, Store store,
                                         float2* smem,
                                         const float2* __restrict__ tw) {
  using RP = RealPlan<N>;
  constexpr int M = N / 2, T = RP::kThreads;
  const float2* split = tw + RP::kSplit;
  const int t = threadIdx.x;
  auto sample = [&](int i) {
    const long long idx = first + i;
    return (idx >= 0 && idx < n ? __ldg(wav + idx) : 0.0f) * scale(i);
  };
  auto packed = [&](int q) {
    return make_float2(sample(2 * q), sample(2 * q + 1));
  };
  if constexpr (RP::kPair) {
    using P = typename RP::P;
    pairfft::Twiddles<M> twr;
    pairfft::load_twiddles<M>(twr, tw);
    float2 v[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) v[a] = packed(t + T * a);
    pairfft::fft<M>(v, twr, smem, smem + P::kBuf, -1.0f);
    for (int k = t; k < M; k += T) {
      store(k, split_bin(smem[k], smem[(M - k) & (M - 1)], __ldg(split + k)));
    }
  } else if constexpr (RP::kCluster == 1) {
    fft<M>(packed, [] {}, smem, tw, -1.0f);
    for (int k = t; k < M; k += T) {
      store(k, split_bin(smem[k], smem[(M - k) & (M - 1)], __ldg(split + k)));
    }
  } else {
    constexpr int H = M / 2;  // X[q] is on CTA q / H at q mod H
    const cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    fft_cluster<H, 2>(packed, smem, tw, tw + RP::kMid, -1.0f, cl);
    const float2* peer = cl.map_shared_rank(smem, rank ^ 1);
    for (int k = rank * H + t; k < (rank + 1) * H; k += T) {
      const int km = (M - k) & (M - 1);
      const float2 zm = (km / H == rank ? smem : peer)[km & (H - 1)];
      store(k, split_bin(smem[k & (H - 1)], zm, __ldg(split + k)));
    }
    cl.sync();  // the peer's reads of this CTA's buffer are done
  }
}

// Launch `kernel` (a real_fft<N> kernel) over `items` frames: one CTA, or
// one 2-CTA cluster, per frame, RealPlan<N>::kSmem bytes of dynamic shared
// memory.  A cluster the card cannot schedule is refused
// (cudaErrorLaunchOutOfResources), never run another way.
template <int N, class... Exp, class... Act>
cudaError_t launch_real(void (*kernel)(Exp...), int items,
                        cudaStream_t stream, Act&&... args) {
  using P = RealPlan<N>;
  if (items <= 0) return cudaGetLastError();
  return launch_clustered(kernel, dim3(items * P::kCluster), P::kThreads,
                          P::kSmem, P::kCluster, stream,
                          static_cast<Act&&>(args)...);
}

}  // namespace large
}  // namespace mlx
