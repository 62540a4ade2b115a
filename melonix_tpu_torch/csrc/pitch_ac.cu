// B8: per-frame mean subtraction and linear autocorrelation of the pitch
// engine (Wiener-Khinchin at twice the frame length).
//
// Replaces melonix_tpu/kernels/pallas_pitch.py:pitch_ac_pallas (_kernel),
// the TPU's slab DMA + mean-subtract + forward and inverse four-step bf16x3
// MXU DFTs at N = 4096 in a scrambled bin order (order-free because the
// power spectrum is elementwise).  Here both transforms are fft_pair.cuh's
// 4096-point register transform in float32 on the CUDA cores: no tensor
// cores, no TF32, no cuFFT.
//
// Contract: frame f covers wav[f*hop, f*hop + 2048), zeros past n;
//   w[f, i]  = x_f[i] - mean(x_f)                        (F, 2048) float32
//   ac[f, t] = irfft(|rfft(w_f, 4096)|^2, 4096)[t], t < 2048
// the linear (not circular) autocorrelation of w_f.
//
// Design: frames a = 2p and b = 2p + 1 share one complex transform each
// way; a CTA of 256 threads (Pair<4096>) loads its twiddles into registers
// once and walks the pairs p = blockIdx.x, + gridDim.x, ... (the persistent
// grid).  An odd count pairs its last frame with silence.  Per pair:
//   1. Thread t holds samples i = t + 256 j (j < 8) of both frames, sums
//      them, and the block reduces the sums in a fixed order (warp xor
//      shuffles, then the 8 warp sums in warp order): every thread gets the
//      same mean, and w keeps the bits of the one-frame-a-block kernel.
//      w goes out coalesced.
//   2. Balance: sum w^2 in float64 (no underflow) in the same fixed order;
//      with sum / 2048 = m 2^x (m in [1/2, 1)) the frame is scaled by 2^-e,
//      e = floor(x / 2), to an rms in [0.70, 1.42) before packing.  Without
//      it the rounding of a loud frame leaks into a quiet partner as the
//      ratio of their POWERS (the inverse packs P_a + i P_b): 100 dB apart
//      the quiet frame's ac is pure leak.  A power of two is exact in
//      float32, so the scale changes no other rounding.  A frame whose w is
//      all zero writes ac = 0 exactly.
//   3. Forward: v[j] = w_a[i] 2^-e_a + i w_b[i] 2^-e_b (j < 8), 0 for j >= 8
//      (the zero pad to 4096); pairfft::fft<4096>(-1) -> Z in natural order.
//   4. Split in place: with Z' = conj Z[(4096 - k) mod 4096],
//      P_a[k] = |Z[k] + Z'|^2 / 4, P_b[k] = |Z[k] - Z'|^2 / 4, and the
//      thread that holds point k of the inverse takes v[j] = P_a + i P_b.
//   5. Inverse: pairfft::fft<4096>(+1) on the buffers swapped.  P_a and P_b
//      are real and even, so their transforms are real: the result is
//      4096 (ac_a + i ac_b) up to rounding.
//   6. ac_a = Re 2^(2 e_a - 12), ac_b = Im 2^(2 e_b - 12) for t < 2048, out
//      coalesced.  No atomics: two calls give the same bits.
// Barriers a pair: 2 reductions + 3 a transform.  The forward writes its
// exchanges to (A, B) and the inverse to (B, A), the order fft_pair.cuh
// allows without barriers between calls.  Per frame 8 KB read (less where
// hops overlap in L2) and 16 KB written; ~2 x 5 N log2 N / 2 flops: the
// bytes bound it at the H100's rates.
#include <math.h>

#include "fft_pair.cuh"

namespace {

using P = mlx::pairfft::Pair<4096>;
constexpr int kFrame = 2048;
constexpr int kN = P::kN;  // zero-padded linear-correlation length
constexpr int kThreads = P::kThreads;  // 256
constexpr int kPer = kFrame / kThreads;  // samples of a frame per thread
constexpr int kWarps = kThreads / 32;
static_assert(kN == 2 * kFrame && kPer == 8, "B8 runs Pair<4096>");

// The sums of every thread's `a` and `b` over the block, each in the fixed
// order of the one-frame-a-block kernel (warp xor tree, then the warp sums
// in warp order), the same on every thread.  One barrier; `slot` must not
// be written again before the caller's next barrier.
template <typename T>
__device__ __forceinline__ void block_sums(T& a, T& b, T (*slot)[kWarps]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    slot[0][threadIdx.x >> 5] = a;
    slot[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = T(0);
  b = T(0);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    a += slot[0][i];
    b += slot[1][i];
  }
}

// The exponent e of the frame's balance scale 2^-e (step 2), from its sum
// of w^2 > 0.
__device__ __forceinline__ int balance_exp(double sum_sq) {
  int x = 0;
  frexp(sum_sq * (1.0 / kFrame), &x);
  return x >> 1;  // floor(x / 2)
}

__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
pitch_ac_kernel(const float* __restrict__ wav, long long n,
                const float2* __restrict__ tw, float* __restrict__ ac,
                float* __restrict__ w, int n_frames, int hop) {
  extern __shared__ float2 pitch_smem[];
  __shared__ float mean_slot[2][kWarps];
  __shared__ double sq_slot[2][kWarps];
  float2* buf_a = pitch_smem;
  float2* buf_b = pitch_smem + P::kBuf;
  mlx::pairfft::Twiddles<kN> twr;
  mlx::pairfft::load_twiddles<kN>(twr, tw);
  const int t = threadIdx.x;
  const int n_pairs = (n_frames + 1) / 2;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x) {
    const int fa = 2 * p;
    const bool has_b = fa + 1 < n_frames;
    const long long sa = static_cast<long long>(fa) * hop;
    const long long sb = sa + hop;

    // 1. both frames' samples, their means, w out
    float xa[kPer], xb[kPer];
    float part_a = 0.0f, part_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long ia = sa + t + j * kThreads, ib = sb + t + j * kThreads;
      xa[j] = ia < n ? __ldg(wav + ia) : 0.0f;
      xb[j] = has_b && ib < n ? __ldg(wav + ib) : 0.0f;
      part_a += xa[j];
      part_b += xb[j];
    }
    block_sums(part_a, part_b, mean_slot);
    const float mean_a = part_a * (1.0f / kFrame);
    const float mean_b = part_b * (1.0f / kFrame);
    float* w_a = w + static_cast<long long>(fa) * kFrame;
    double sq_a = 0.0, sq_b = 0.0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      xa[j] -= mean_a;
      xb[j] -= mean_b;
      w_a[t + j * kThreads] = xa[j];
      if (has_b) w_a[kFrame + t + j * kThreads] = xb[j];
      sq_a += static_cast<double>(xa[j]) * xa[j];
      sq_b += static_cast<double>(xb[j]) * xb[j];
    }

    // 2. balance: each frame at an rms near 1 by an exact power of two
    block_sums(sq_a, sq_b, sq_slot);
    const int ea = sq_a > 0.0 ? balance_exp(sq_a) : 0;
    const int eb = sq_b > 0.0 ? balance_exp(sq_b) : 0;

    // 3. forward transform of the packed, balanced pair
    float2 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] = j < kPer ? make_float2(ldexpf(xa[j], -ea), ldexpf(xb[j], -eb))
                      : make_float2(0.0f, 0.0f);
    }
    mlx::pairfft::fft<kN>(v, twr, buf_a, buf_b, -1.0f);

    // 4. the two power spectra, packed as one complex input
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = t + j * kThreads;
      const float2 zk = buf_a[k], zn = buf_a[(kN - k) & (kN - 1)];
      const float ra = zk.x + zn.x, ia = zk.y - zn.y;
      const float rb = zk.x - zn.x, ib = zk.y + zn.y;
      v[j] = make_float2(0.25f * (ra * ra + ia * ia),
                         0.25f * (rb * rb + ib * ib));
    }

    // 5. inverse transform: 4096 (ac_a + i ac_b)
    mlx::pairfft::fft<kN>(v, twr, buf_b, buf_a, 1.0f);

    // 6. unscale and out (a silent frame's sum is 0: exact zeros)
    float* ac_a = ac + static_cast<long long>(fa) * kFrame;
    const int oa = 2 * ea - 12, ob = 2 * eb - 12;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float2 z = buf_b[t + j * kThreads];
      ac_a[t + j * kThreads] = sq_a > 0.0 ? ldexpf(z.x, oa) : 0.0f;
      if (has_b) {
        ac_a[kFrame + t + j * kThreads] = sq_b > 0.0 ? ldexpf(z.y, ob) : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" int mlx_pitch_ac(const float* wav, long long n, const float2* tw,
                            float* ac, float* w, int n_frames, int hop,
                            cudaStream_t stream) {
  if (n_frames <= 0 || hop <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const cudaError_t err = mlx::pairfft::persistent_grid(
      pitch_ac_kernel, kThreads, P::kSmem, (n_frames + 1) / 2, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  pitch_ac_kernel<<<grid, kThreads, P::kSmem, stream>>>(wav, n, tw, ac, w,
                                                        n_frames, hop);
  return static_cast<int>(cudaGetLastError());
}
