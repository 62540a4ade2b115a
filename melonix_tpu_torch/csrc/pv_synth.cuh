// The synthesis and overlap-add launches shared by B3 (pv_synth_ola_phase.cu)
// and B10 (pv_synth_ola.cu).
//
//   * synth_kernel<mode>: one block per frame fills the bit-reversed,
//     Hermitian-mirrored 2048-point spectrum in shared memory, drops the
//     DC/Nyquist imaginaries as a c2r inverse does, runs the inverse fft2048,
//     scales by 1/2048 and applies the window.  Bounded by the FFT's
//     shared-memory passes.  The mode says what the rows hold:
//       - kSynthHalf: B3's half spectrum (re, im), as its phase scan wrote it;
//       - kSynthLocked: B3's (mag, psi, phi) rows: lock_frame locks the
//         frame's phases first (see below), then masks and rotates;
//       - kSynthPolar: B10's (mag, psi): a polar prologue writes mag * e^{i
//         psi} into the buffer (the caller has masked mag already).
//   * ola_kernel: one thread per output sample sums the size/hop frames that
//     cover it in ascending frame order: a fixed order, no atomics,
//     deterministic.  Bounded by HBM: each frame sample is read once,
//     coalesced.
//
// Each translation unit that includes this header gets its own copy of the
// kernels (anonymous namespace): they are templates and small.
#pragma once

#include "fft2048.cuh"

namespace {

constexpr int kN = mlx::kFftN;
constexpr int kBins = kN / 2 + 1;

enum SynthMode { kSynthHalf = 0, kSynthLocked = 1, kSynthPolar = 2 };

// Bins a thread of the lock prologue owns, and the scans' sentinels.
constexpr int kPer = (kBins + mlx::kFftThreads - 1) / mlx::kFftThreads;
constexpr int kWarps = mlx::kFftThreads / 32;
constexpr int kNoPeakBelow = -1;
constexpr int kNoPeakAbove = 0x7fffffff;
constexpr int kFar = 1 << 30;

__device__ __forceinline__ float mag_or_edge(const float* m, int k) {
  return k >= 0 && k < kBins ? m[k] : -1.0f;
}

// Bin k of a frame as mag * e^{i psi}, and its Hermitian mirror, into the
// bit-reversed buffer `data` (imaginaries of DC and Nyquist dropped).
__device__ __forceinline__ void put_polar(float2* data, int k, float mag,
                                          float psi) {
  float sn, cs;
  sincosf(psi, &sn, &cs);
  const float re = mag * cs;
  const bool real_bin = k == 0 || k == kN / 2;
  const float im = real_bin ? 0.0f : mag * sn;
  data[mlx::bitrev11(k)] = make_float2(re, im);
  if (!real_bin) data[mlx::bitrev11(kN - k)] = make_float2(re, -im);
}

// Identity locking of one frame's (mag, psi, phi) rows, then the live mask
// and mag * e^{i psi} into `data` (bit-reversed, Hermitian-mirrored), ready
// for the inverse FFT.  Every thread of the block must call it.
__device__ void lock_frame(const float* __restrict__ g_mag,
                           const float* __restrict__ g_psi,
                           const float* __restrict__ g_phi, bool live,
                           float2* data) {
  __shared__ float s_mag[kBins], s_psi[kBins], s_phi[kBins];
  __shared__ int s_wlast[kWarps], s_wfirst[kWarps];
  const int t = threadIdx.x;
  for (int k = t; k < kBins; k += blockDim.x) {
    s_mag[k] = g_mag[k];
    s_psi[k] = g_psi[k];
    s_phi[k] = g_phi[k];
  }
  __syncthreads();
  // peaks among this thread's bins [lo, lo + kPer): mag > 0, above k-1 and
  // k-2, at least k+1 and k+2 (edges -1)
  const int lo = t * kPer;
  unsigned peaks = 0;
  int last = kNoPeakBelow, first = kNoPeakAbove;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lo + i;
    if (k >= kBins) break;
    const float m = s_mag[k];
    if (m > 0.0f && m > mag_or_edge(s_mag, k - 1) &&
        m > mag_or_edge(s_mag, k - 2) && m >= mag_or_edge(s_mag, k + 1) &&
        m >= mag_or_edge(s_mag, k + 2)) {
      peaks |= 1u << i;
      last = k;
      if (first == kNoPeakAbove) first = k;
    }
  }
  // last peak below this thread's bins (exclusive max-scan of `last`) and
  // first peak above them (exclusive min-scan of `first` from the right)
  const unsigned full = 0xffffffffu;
  const int lane = t & 31, warp = t >> 5;
  int incl_last = last, incl_first = first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(full, incl_last, o);
    const int down = __shfl_down_sync(full, incl_first, o);
    if (lane >= o) incl_last = max(incl_last, up);
    if (lane + o < 32) incl_first = min(incl_first, down);
  }
  if (lane == 31) s_wlast[warp] = incl_last;
  if (lane == 0) s_wfirst[warp] = incl_first;
  __syncthreads();
  int below = __shfl_up_sync(full, incl_last, 1);
  int above = __shfl_down_sync(full, incl_first, 1);
  if (lane == 0) below = kNoPeakBelow;
  if (lane == 31) above = kNoPeakAbove;
  for (int w = 0; w < warp; ++w) below = max(below, s_wlast[w]);
  for (int w = warp + 1; w < kWarps; ++w) above = min(above, s_wfirst[w]);
  int near_below[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if ((peaks >> i) & 1u) below = lo + i;
    near_below[i] = below;
  }
#pragma unroll
  for (int i = kPer - 1; i >= 0; --i) {
    const int k = lo + i;
    if (k >= kBins) continue;
    if ((peaks >> i) & 1u) above = k;
    const int d_f = near_below[i] != kNoPeakBelow ? k - near_below[i] : kFar;
    const int d_b = above != kNoPeakAbove ? above - k : kFar;
    float th = s_psi[k] - s_phi[k];  // no peak in the frame: phi + theta
    if (min(d_f, d_b) < kFar) {
      const int p = d_f <= d_b ? near_below[i] : above;  // tie: the lower
      th = s_psi[p] - s_phi[p];
    }
    put_polar(data, k, live ? s_mag[k] : 0.0f, s_phi[k] + th);
  }
}

template <int kMode>
__global__ void __launch_bounds__(mlx::kFftThreads)
synth_kernel(const float* __restrict__ s_re, const float* __restrict__ s_im,
             const float* __restrict__ s_phi, const float* __restrict__ win,
             const float2* __restrict__ tw, float* __restrict__ frames,
             int f_real) {
  __shared__ float2 data[kN];
  __shared__ float2 s_tw[kN / 2];
  mlx::load_twiddles(s_tw, tw);
  const long long row = static_cast<long long>(blockIdx.x) * kBins;
  if (kMode == kSynthLocked) {  // (s_re, s_im, s_phi) hold (mag, psi, phi)
    lock_frame(s_re + row, s_im + row, s_phi + row,
               static_cast<int>(blockIdx.x) < f_real, data);
  } else if (kMode == kSynthPolar) {  // (s_re, s_im) hold (mag, psi)
    for (int k = threadIdx.x; k < kBins; k += blockDim.x) {
      put_polar(data, k, s_re[row + k], s_im[row + k]);
    }
  } else {
    for (int k = threadIdx.x; k < kN; k += blockDim.x) {
      float2 x;
      if (k < kBins) {
        const bool real_bin = k == 0 || k == kN / 2;
        x = make_float2(s_re[row + k], real_bin ? 0.0f : s_im[row + k]);
      } else {  // negative frequencies: the Hermitian mirror
        x = make_float2(s_re[row + kN - k], -s_im[row + kN - k]);
      }
      data[mlx::bitrev11(k)] = x;
    }
  }
  mlx::fft2048(data, s_tw, 1.0f);
  float* out = frames + static_cast<long long>(blockIdx.x) * kN;
  for (int i = threadIdx.x; i < kN; i += blockDim.x) {
    out[i] = data[i].x * (1.0f / kN) * win[i];
  }
}

__global__ void ola_kernel(const float* __restrict__ frames,
                           float* __restrict__ y, int n_frames, int hop,
                           long long out_len) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= out_len) return;
  const long long m_hi = min(j / hop, static_cast<long long>(n_frames - 1));
  const long long m_lo = j >= kN ? (j - kN) / hop + 1 : 0;
  float acc = 0.0f;
  for (long long m = m_lo; m <= m_hi; ++m) {
    acc += frames[m * kN + (j - m * hop)];
  }
  y[j] = acc;
}

// The overlap-add launch of F frames at `hop` into (F - 1) * hop + 2048
// samples; returns the launch's error.
inline cudaError_t launch_ola(const float* frames, float* y, int n_frames,
                              int hop, cudaStream_t stream) {
  const long long out_len = static_cast<long long>(n_frames - 1) * hop + kN;
  const int threads = 256;
  ola_kernel<<<static_cast<unsigned>((out_len + threads - 1) / threads),
               threads, 0, stream>>>(frames, y, n_frames, hop, out_len);
  return cudaGetLastError();
}

}  // namespace
