// A 2048-point complex FFT whose radix stages run in registers: the
// transform under B2 (pv_analysis.cu), which packs two real frames into one
// complex transform, z = x_a + i x_b.  It provides the inverse too (sign =
// +1), for B1 and B3/B10's synthesis, which still run the shared-memory
// radix-2 fft2048.cuh.
//
// One transform per 128-thread CTA; each thread holds 16 points.  With
// 2048 = 16 * 16 * 8, index n = b + 128 a (b < 128, a < 16) and output
// k = k2 + 16 (q + 16 r) (k2, q < 16, r < 8):
//   pass 1: thread b takes z[b + 128 a] for a < 16 from its caller, runs a
//           16-point DFT over a in registers -> Z_b[k2], and multiplies by
//           W_2048^(b k2);  exchange 1 through shared memory, [k2][b];
//   pass 2: thread (k2, c) = (t / 8, t % 8) takes Y[c + 8 a] for a < 16,
//           a 16-point DFT over a -> V[q], times W_128^(c q);  exchange 2,
//           [c][k2 + 16 q];
//   pass 3: thread t takes the pairs p = t and t + 128 (p = k2 + 16 q),
//           an 8-point DFT over c -> X[p + 256 r], written to shared memory
//           in natural order for the caller's epilogue.
// Three barriers a transform, against fft2048.cuh's eleven (two buffers
// taken in turn, 34 KB a CTA; fft2048.cuh's 24 KB held one frame).  The exchanges'
// row strides (136 and 258 float2) keep every half-warp's 8-byte accesses
// on distinct banks: reads of exchange 1 step by 8 a row, writes of
// exchange 2 by 2.  The in-register DFTs are radix-2 decimation in
// frequency, fully unrolled, with the 16th roots of unity as float32
// constants (1 and +-i exact); the pass twiddles come from a host table of
// float32 cos/sin values computed in float64 (kpv.pair_twiddles), held in
// registers for all the transforms a thread runs.  No __sincosf, no TF32,
// no tensor cores: the rounding is the float32 butterflies' own.
#pragma once

#include <cuda_runtime.h>

namespace mlx {
namespace pairfft {

constexpr int kN = 2048;
constexpr int kThreads = 128;     // one transform per CTA of this size
constexpr int kStride1 = 136;     // exchange 1: [k2][b], b < 128, padded
constexpr int kStride2 = 258;     // exchange 2: [c][p], p < 256, padded
constexpr int kBuf = 16 * kStride1;  // float2 of one exchange buffer
constexpr int kTw1 = 16 * 128;    // pass-1 twiddles W_2048^(b k2), [k2][b]
constexpr int kTw2 = 16 * 8;      // pass-2 twiddles W_128^(c q), [q][c]
constexpr int kTwiddles = kTw1 + kTw2;
static_assert(kBuf >= 8 * kStride2 && kBuf >= kN, "exchange buffer size");

// Bit reversal of k over `bits` bits (the DIF output order), at compile time
// once the loops are unrolled.
__host__ __device__ constexpr int brev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
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

// In-register L-point DFT (L = 8 or 16), radix-2 decimation in frequency:
// natural-order input, output X[k] in v[brev(k, log2 L)].
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
// transform the thread runs.
struct Twiddles {
  float2 t1[16];  // W_2048^(b k2), b = threadIdx.x
  float2 t2[16];  // W_128^(c q), c = threadIdx.x % 8
};

__device__ __forceinline__ void load_twiddles(Twiddles& tw,
                                              const float2* __restrict__ g) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tw.t1[i] = g[i * 128 + t];
    tw.t2[i] = g[kTw1 + i * 8 + (t & 7)];
  }
}

// The transform of the 2048 points whose values v[a] = z[threadIdx.x + 128
// a] the 128 threads hold.  sign = -1: forward, X[k] = sum z[n]
// e^(-2 pi i n k / 2048); sign = +1: inverse without the 1/N scale.  out
// and other are two distinct buffers of kBuf float2: exchange 1 and the
// result go to out, exchange 2 to other; on return out[k] = X[k] (k < 2048)
// for every thread.  Every thread of the CTA must call it.  The caller
// swaps the two buffers from one call to the next: the next call's first
// write then lands in the buffer whose last reads the final barrier here
// has ordered, and its second write behind its own first barrier, so no
// barrier is needed between calls.
__device__ __forceinline__ void fft2048(float2 (&v)[16], const Twiddles& tw,
                                        float2* out, float2* other,
                                        float sign) {
  const int t = threadIdx.x;
  dft_regs<16>(v, sign);
#pragma unroll
  for (int k2 = 0; k2 < 16; ++k2) {
    out[k2 * kStride1 + t] =
        k2 == 0 ? v[0] : ctw(v[brev(k2, 4)], tw.t1[k2], sign);
  }
  __syncthreads();
  const int k2 = t >> 3, c = t & 7;
#pragma unroll
  for (int a = 0; a < 16; ++a) v[a] = out[k2 * kStride1 + c + 8 * a];
  dft_regs<16>(v, sign);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    other[c * kStride2 + k2 + 16 * q] =
        q == 0 ? v[0] : ctw(v[brev(q, 4)], tw.t2[q], sign);
  }
  __syncthreads();  // also: every read of exchange 1 in out is done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2 u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = other[j * kStride2 + t + 128 * h];
    dft_regs<8>(u, sign);
#pragma unroll
    for (int r = 0; r < 8; ++r) out[t + 128 * h + 256 * r] = u[brev(r, 3)];
  }
  __syncthreads();
}

}  // namespace pairfft
}  // namespace mlx
