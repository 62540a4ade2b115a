// A complex FFT of N = 16 * 16 * R points (R = N / 256: N = 512 ... 8192)
// whose radix stages run in registers: the transform under B2
// (pv_analysis.cu, N = 2048) and under B1 and B12's |STFT|
// (stft_mag_pair.cuh, every N here), which pack two real frames into one
// complex transform, z = x_a + i x_b, and, with sign = +1, under the
// synthesis of B3 and B10 (pv_synth.cuh, N = 2048), which packs two
// Hermitian half spectra into one complex inverse, Z = X_a + i X_b; and
// both ways under B8's autocorrelation (pitch_ac.cu, N = 4096: two frames
// forward, their two real power spectra back).
//
// One transform per CTA of T = N / 16 threads; each thread holds 16 points.
// With index n = b + T a (b < T, a < 16), b = c + R a' (c < R) and output
// k = k2 + 16 (q + 16 r) (k2, q < 16, r < R):
//   pass 1: thread b takes z[b + T a] for a < 16 from its caller, runs a
//           16-point DFT over a in registers -> Z_b[k2], and multiplies by
//           W_N^(b k2);  exchange 1 through shared memory, [k2][b];
//   pass 2: thread (k2, c) = (t / R, t % R) takes Y[c + R a] for a < 16,
//           a 16-point DFT over a -> V[q], times W_(16 R)^(c q);
//           exchange 2, [c][p] with p = k2 + 16 q;
//   pass 3: the R-point DFTs over c -> X[p + 256 r], written to shared
//           memory in natural order for the caller's epilogue.  For R <= 16
//           thread t takes p = t + T h (h < 16 / R), an R-point DFT each.
//           For R = 32 two lanes of a warp share each p: lane half e (lanes
//           e * 16 ... e * 16 + 15) takes the 16 points c = 2 j + e, a
//           16-point DFT -> Y_e[s], and one radix-2 step through a warp
//           shuffle finishes the 32-point DFT: X[s] = Y_0[s] + W_32^s Y_1[s]
//           (lane half 0), X[s + 16] = Y_0[s] - W_32^s Y_1[s] (lane half 1).
// Three barriers a transform (a radix-2 transform in shared memory takes
// log2 N); two exchange buffers, 2 * kBuf float2 of dynamic shared memory.
//
// Row strides (Plan<N>, in float2): a half-warp's 8-byte accesses fall on
// distinct banks when their float2 indices differ mod 16.  Exchange 1 is
// written along b (consecutive) and read by pass 2 at k2 * S1 + c + R a:
// for R < 16 a half-warp spans 16 / R rows k2 of R lanes c, so S1 = T + R
// (S1 = R mod 16; 136 at 2048); for R >= 16 it reads within one row, S1 = T.
// Exchange 2 is written by pass 2 at c * S2 + k2 + 16 q and read along p:
// for R < 16 a half-warp spans R rows c of 16 / R lanes k2, so S2 = 256 +
// 16 / R (258 at 2048); for R >= 16 it spans 16 rows c, so S2 = 257 (odd).
// Pass 3's R = 32 reads stay in one row of 16 consecutive p per half-warp.
// tests/test_torch_fft.py checks these rules from the constants below.
//
// The in-register DFTs are radix-2 decimation in frequency, fully unrolled,
// with the 16th (and for R = 32 the 32nd) roots of unity as float32
// constants (1 and +-i exact); the pass twiddles come from a host table of
// float32 cos/sin values computed in float64 (kpv.pair_twiddles), held in
// registers for all the transforms a thread runs (at 8192 points pass 2's
// are read through L1 instead: kHold2).  No __sincosf, no TF32,
// no tensor cores: the rounding is the float32 butterflies' own.
#pragma once

#include <cuda_runtime.h>

namespace mlx {
namespace pairfft {

// Row strides of the two exchanges, in float2 (rules above).
template <int N> struct Plan;
template <> struct Plan<512> { static constexpr int kStride1 = 34, kStride2 = 264; };
template <> struct Plan<1024> { static constexpr int kStride1 = 68, kStride2 = 260; };
template <> struct Plan<2048> { static constexpr int kStride1 = 136, kStride2 = 258; };
template <> struct Plan<4096> { static constexpr int kStride1 = 256, kStride2 = 257; };
template <> struct Plan<8192> { static constexpr int kStride1 = 512, kStride2 = 257; };

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int N>
struct Pair {
  static constexpr int kN = N;
  static constexpr int kR = N / 256;
  static constexpr int kThreads = N / 16;  // one transform per CTA
  static constexpr int kStride1 = Plan<N>::kStride1;  // exchange 1: [k2][b]
  static constexpr int kStride2 = Plan<N>::kStride2;  // exchange 2: [c][p]
  static constexpr int kBuf =  // float2 of one exchange buffer
      cmax(cmax(16 * kStride1, kR * kStride2), N);
  static constexpr int kTw1 = 16 * kThreads;  // W_N^(b k2), [k2][b]
  static constexpr int kTwiddles = kTw1 + 16 * kR;  // then W_(16R)^(c q), [q][c]
  static constexpr size_t kSmem = 2 * kBuf * sizeof(float2);
  // The kernels' __launch_bounds__(kThreads, kMinBlocks): from 128 threads
  // up, 16 warps a SM at 128 registers a thread (B2's budget at 2048;
  // uncapped, 4096 took 140 and fit one CTA a SM).  The 32- and 64-thread
  // CTAs of 512 and 1024 points spill under that cap (136 and 28 bytes) and
  // take what they need instead (166 and 150 registers, 12 warps a SM).
  static constexpr int kMinBlocks = kThreads >= 128 ? 512 / kThreads : 1;
  // Pass 2's twiddles stay in registers up to 256 threads; at 512 (8192
  // points) they are read from the table through L1 at each use, which
  // keeps the thread within its 128 registers (held, ptxas spilled 124
  // bytes).
  static constexpr bool kHold2 = kThreads <= 256;
  static_assert(kR >= 2 && kR <= 32 && 256 * kR == N, "N = 512 ... 8192");
  static_assert(kR >= 16 ? kStride1 >= kThreads
                         : kStride1 >= kThreads && kStride1 % 16 == kR,
                "exchange 1 stride");
  static_assert(kR >= 16 ? kStride2 >= 256 && kStride2 % 2 == 1
                         : kStride2 >= 256 && kStride2 % 16 == 16 / kR,
                "exchange 2 stride");
};

// Bit reversal of k over `bits` bits (the DIF output order), at compile time
// once the loops are unrolled.
__host__ __device__ constexpr int brev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n / 2) : 0;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a * (w.x + i sign w.y): w holds cos and sin of a positive angle.
__device__ __forceinline__ float2 ctw(float2 a, float2 w, float sign) {
  const float wi = sign * w.y;
  return make_float2(a.x * w.x - a.y * wi, a.x * wi + a.y * w.x);
}

// a * e^(sign 2 pi i m / 16), m < 8 (a compile-time constant after
// unrolling): m = 0 and m = 4 exactly, the rest with float32 constants.
__device__ __forceinline__ float2 rot16(float2 a, int m, float sign) {
  constexpr float c1 = 0.923879532511286756128f;  // cos(pi / 8)
  constexpr float s1 = 0.382683432365089771728f;  // sin(pi / 8)
  constexpr float r2 = 0.707106781186547524401f;  // cos(pi / 4)
  switch (m) {
    case 0: return a;
    case 1: return ctw(a, make_float2(c1, s1), sign);
    case 2: return ctw(a, make_float2(r2, r2), sign);
    case 3: return ctw(a, make_float2(s1, c1), sign);
    case 4: return make_float2(-sign * a.y, sign * a.x);
    case 5: return ctw(a, make_float2(-s1, c1), sign);
    case 6: return ctw(a, make_float2(-r2, r2), sign);
    default: return ctw(a, make_float2(-c1, s1), sign);
  }
}

// a * e^(sign 2 pi i s / 32), s < 16: the even s through rot16, the odd
// with float32 constants.
__device__ __forceinline__ float2 rot32(float2 a, int s, float sign) {
  constexpr float c1 = 0.980785280403230449126f;  // cos(pi / 16)
  constexpr float s1 = 0.195090322016128267848f;  // sin(pi / 16)
  constexpr float c3 = 0.831469612302545237079f;  // cos(3 pi / 16)
  constexpr float s3 = 0.555570233019602224743f;  // sin(3 pi / 16)
  switch (s) {
    case 1: return ctw(a, make_float2(c1, s1), sign);
    case 3: return ctw(a, make_float2(c3, s3), sign);
    case 5: return ctw(a, make_float2(s3, c3), sign);
    case 7: return ctw(a, make_float2(s1, c1), sign);
    case 9: return ctw(a, make_float2(-s1, c1), sign);
    case 11: return ctw(a, make_float2(-s3, c3), sign);
    case 13: return ctw(a, make_float2(-c3, s3), sign);
    case 15: return ctw(a, make_float2(-c1, s1), sign);
    default: return rot16(a, s / 2, sign);
  }
}

// In-register L-point DFT (L = 2, 4, 8 or 16), radix-2 decimation in
// frequency: natural-order input, output X[k] in v[brev(k, log2 L)].
template <int L>
__device__ __forceinline__ void dft_regs(float2 (&v)[L], float sign) {
#pragma unroll
  for (int h = L / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i & h) continue;
      const float2 u = v[i], w = v[i + h];
      v[i] = cadd(u, w);
      // the group's twiddle W_(2h)^j = W_16^(j * 8 / h), j = i mod h
      v[i + h] = rot16(csub(u, w), (i & (h - 1)) * (8 / h), sign);
    }
  }
}

// This thread's pass twiddles, loaded once and kept in registers for every
// transform the thread runs (t2 only with kHold2; else row2 points at the
// thread's column of the table and w2 reads it).
template <int N>
struct Twiddles {
  float2 t1[16];  // W_N^(b k2), b = threadIdx.x
  float2 t2[16];  // W_(16R)^(c q), c = threadIdx.x % R
  const float2* __restrict__ row2;
  __device__ __forceinline__ float2 w2(int q) const {
    return Pair<N>::kHold2 ? t2[q] : __ldg(row2 + q * Pair<N>::kR);
  }
};

template <int N>
__device__ __forceinline__ void load_twiddles(Twiddles<N>& tw,
                                              const float2* __restrict__ g) {
  using P = Pair<N>;
  const int t = threadIdx.x;
  tw.row2 = g + P::kTw1 + (t & (P::kR - 1));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tw.t1[i] = g[i * P::kThreads + t];
    if (P::kHold2) tw.t2[i] = tw.row2[i * P::kR];
  }
}

// The transform of the N points whose values v[a] = z[threadIdx.x + T a]
// the T threads hold.  sign = -1: forward, X[k] = sum z[n] e^(-2 pi i n k /
// N); sign = +1: inverse without the 1/N scale.  out and other are two
// distinct buffers of kBuf float2: exchange 1 and the result go to out,
// exchange 2 to other; on return out[k] = X[k] (k < N) for every thread.
// Every thread of the CTA must call it.  A caller that reads only out
// between calls swaps the two buffers from one call to the next: the next
// call's first write then lands in the buffer whose last reads the final
// barrier here has ordered, and its second write behind its own first
// barrier, so no barrier is needed between calls (a caller with a barrier
// of its own between calls keeps them, as pv_synth.cuh does).
template <int N>
__device__ __forceinline__ void fft(float2 (&v)[16], const Twiddles<N>& tw,
                                    float2* out, float2* other, float sign) {
  using P = Pair<N>;
  constexpr int R = P::kR, T = P::kThreads;
  constexpr int S1 = P::kStride1, S2 = P::kStride2;
  const int t = threadIdx.x;
  dft_regs<16>(v, sign);
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) {
    out[k2 * S1 + t] = k2 == 0 ? v[0] : ctw(v[brev(k2, 4)], tw.t1[k2], sign);
  }
  __syncthreads();
  const int k2 = t / R, c = t % R;
#pragma unroll
  for (int a = 0; a < 16; ++a) v[a] = out[k2 * S1 + c + R * a];
  dft_regs<16>(v, sign);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    other[c * S2 + k2 + 16 * q] =
        q == 0 ? v[0] : ctw(v[brev(q, 4)], tw.w2(q), sign);
  }
  __syncthreads();  // also: every read of exchange 1 in out is done
  if constexpr (R <= 16) {
#pragma unroll
    for (int h = 0; h < 16 / R; ++h) {
      const int p = t + T * h;
      float2 u[R];
#pragma unroll
      for (int j = 0; j < R; ++j) u[j] = other[j * S2 + p];
      dft_regs<R>(u, sign);
#pragma unroll
      for (int r = 0; r < R; ++r) out[p + 256 * r] = u[brev(r, ilog2(R))];
    }
  } else {
    const int p = ((t >> 5) << 4) | (t & 15), e = (t >> 4) & 1;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = other[(2 * j + e) * S2 + p];
    dft_regs<16>(v, sign);  // Y_e[s] in v[brev(s, 4)]
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      float2 y = v[brev(s, 4)];
      if (e) y = rot32(y, s, sign);  // W_32^s Y_1[s]
      const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, y.x, 16),
                                   __shfl_xor_sync(0xffffffffu, y.y, 16));
      out[p + 256 * (s + 16 * e)] = e ? csub(o, y) : cadd(y, o);
    }
  }
  __syncthreads();
}

// The persistent grid of `kernel` for `work` items on this device: as many
// CTAs of `threads` threads and `smem` bytes of dynamic shared memory as
// fit on the card at once, at most one per item.  Allows `kernel` the
// shared memory first (above 48 KB that is required).
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            int work, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller reports it once
    return err;
  }
  const int fit = sms * per_sm;
  *grid = work < fit ? work : fit;
  if (*grid < 1) *grid = 1;
  return cudaSuccess;
}

}  // namespace pairfft
}  // namespace mlx
