// B3: phase-vocoder phase propagation + inverse DFT + window + overlap-add
// of one stretch chunk, straight from the analysis spectrum (re, im), or,
// on the formant path, from its warped magnitude and phase (mag, phi).
//
// Replaces melonix_tpu/kernels/pallas_pv.py:synth_ola_phase with cart=True
// and cart=False, lock=False and lock=True (_syn_ola_phase_kernel, _atan2,
// _lock_psis, _syn_body), which ran the whole chain in one kernel because
// the TPU's grid is sequential: a (size - hop)-row OLA
// carry and the frame-axis prefix sum rode from one grid step to the next.
// Blocks on this card run in no order, so the carry becomes three launches
// on one stream, each parallel over what it can be:
//
//   1. phase scan (phase_scan_kernel<cart, lock>): one thread per bin walks
//      the chunk's frames in order: mag and phase (the correctly rounded
//      sqrt of r*r + i*i, no contraction, and atan2f of (re, im) with cart,
//      so mag equals the plain twin's; read as given without: the formant
//      path passes the warped mag and phi, pallas_pv.py:728-730), the
//      princarg residual against omega_k * max(da, 1e-3), incr = hop * dphi / da (0 on global frame 0),
//      a running float32 sum added to resid_in, the exact int mod-size
//      ramp, psi = phi0_eff + ramp + resid, the live-frame mask, and
//      mag * e^{i psi} into the half spectrum (with lock: mag, psi and phi,
//      unmasked); it also writes the carries (resid_last, phi_last at frame
//      f_real - 1; phi0_eff).  Formulas of
//      melonix_tpu/engine/phase_vocoder.py:_stretch_chunk_core:374-416.
//      Only 1025 threads: bounded by the latency of each thread's serial
//      atan2f/sincosf chain, not by the card.  Blocking the scan over
//      frames is later work.
//   2. synthesis (synth_kernel<lock>): one block per frame takes the
//      Hermitian half spectrum, drops the DC/Nyquist imaginaries as a c2r
//      inverse does, runs the inverse fft2048, scales by 1/2048 and applies
//      the window.  Bounded by the FFT's shared-memory passes.  With lock a
//      prologue (lock_frame) first locks the frame's phases: locking needs
//      every bin of a frame at once, which the scan (one thread per bin,
//      serial over frames) never has.  It loads the frame's mag, psi and
//      phi rows into shared memory (12 KB beside the FFT's 24 KB), marks
//      the peaks, finds each bin's nearest peak below and above with a
//      block-wide max-scan and min-scan of peak indices (five bins a
//      thread, warp shuffles, then the eight warp totals), and forms
//      phi + (psi - phi)[nearest peak] exactly as the engine's natural-order
//      identity_lock (phase_vocoder.py:129-189; the TPU kernel's scrambled
//      full-spectrum variant, which resolves ties against the mirror
//      image, is not followed), then the live mask and mag * e^{i psi}.
//   3. overlap-add (ola_kernel): one thread per output sample sums the
//      size/hop frames that cover it in ascending frame order: a fixed
//      order, no atomics, deterministic.  Bounded by HBM: each frame
//      sample is read once, coalesced.
//
// The wrapper allocates the (F, 1025) half spectrum (with lock: mag, psi
// and a third (F, 1025) row set for phi) and the (F, 2048) frame matrix as
// scratch; the kernels allocate nothing.
#include "fft2048.cuh"

namespace {

constexpr int kN = mlx::kFftN;
constexpr int kBins = kN / 2 + 1;
constexpr int kScanThreads = 64;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kTwoPiOverN = 6.28318530717958647692f / kN;

// jnp.mod / torch.remainder for float32: the result takes the divisor's sign.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

template <bool kCart, bool kLock>
__global__ void __launch_bounds__(kScanThreads)
phase_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ da,
                  const float* __restrict__ phi0,
                  const float* __restrict__ resid_in,
                  const float* __restrict__ phi_prev,
                  float* __restrict__ s_re, float* __restrict__ s_im,
                  float* __restrict__ s_phi,
                  float* __restrict__ resid_last,
                  float* __restrict__ phi_last,
                  float* __restrict__ phi0_eff, int n_frames, int m0,
                  int f_real, int hop) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= kBins) return;
  const float omega = kTwoPiOverN * static_cast<float>(k);
  const int last = min(max(f_real - 1, 0), n_frames - 1);
  const float rin = resid_in[k];
  float prev = phi_prev[k];
  float p0e = phi0[k];
  float cum = 0.0f;
#pragma unroll 4
  for (int m = 0; m < n_frames; ++m) {
    const long long at = static_cast<long long>(m) * kBins + k;
    float mag, phi;
    if (kCart) {  // (a, b) = (re, im) of the analysis spectrum
      const float r = a[at], i = b[at];
      mag = __fsqrt_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)));
      phi = atan2f(i, r);
    } else {  // (a, b) = (mag, phi), the formant path's warped magnitude
      mag = a[at];
      phi = b[at];
    }
    const float d = fmaxf(da[m], 1e-3f);
    const float dphi = floor_mod(phi - prev - omega * d + kPi, kTwoPi) - kPi;
    float incr = static_cast<float>(hop) * dphi / d;
    if (m == 0 && m0 == 0) {  // global frame 0: no predecessor, psi = phi
      incr = 0.0f;
      p0e = phi;
    }
    cum += incr;
    const float resid = rin + cum;
    // psi = phi0 + (m * hop * omega mod 2 pi) + resid, the ramp in exact
    // integer arithmetic (a float running phase loses whole radians at
    // hour scale).  64-bit: (m0 + m) * hop passes 2^31 past ~4M frames.
    const long long hm = (static_cast<long long>(m0 + m) * hop) % kN;
    const int prod = static_cast<int>((hm * k) % kN);
    const float psi = p0e + kTwoPiOverN * static_cast<float>(prod) + resid;
    if (kLock) {  // the synthesis launch locks, masks and rotates
      s_re[at] = mag;
      s_im[at] = psi;
      s_phi[at] = phi;
    } else {
      const float mag_live = m < f_real ? mag : 0.0f;
      float sn, cs;
      sincosf(psi, &sn, &cs);
      s_re[at] = mag_live * cs;
      s_im[at] = mag_live * sn;
    }
    if (m == last) {
      resid_last[k] = resid;
      phi_last[k] = phi;
    }
    prev = phi;
  }
  phi0_eff[k] = p0e;
}

// Bins a thread of the lock prologue owns, and the scans' sentinels.
constexpr int kPer = (kBins + mlx::kFftThreads - 1) / mlx::kFftThreads;
constexpr int kWarps = mlx::kFftThreads / 32;
constexpr int kNoPeakBelow = -1;
constexpr int kNoPeakAbove = 0x7fffffff;
constexpr int kFar = 1 << 30;

__device__ __forceinline__ float mag_or_edge(const float* m, int k) {
  return k >= 0 && k < kBins ? m[k] : -1.0f;
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
    const float psi = s_phi[k] + th;
    const float mag = live ? s_mag[k] : 0.0f;
    float sn, cs;
    sincosf(psi, &sn, &cs);
    const float re = mag * cs;
    const bool real_bin = k == 0 || k == kN / 2;
    const float im = real_bin ? 0.0f : mag * sn;
    data[mlx::bitrev11(k)] = make_float2(re, im);
    if (!real_bin) data[mlx::bitrev11(kN - k)] = make_float2(re, -im);
  }
}

template <bool kLock>
__global__ void __launch_bounds__(mlx::kFftThreads)
synth_kernel(const float* __restrict__ s_re, const float* __restrict__ s_im,
             const float* __restrict__ s_phi, const float* __restrict__ win,
             const float2* __restrict__ tw, float* __restrict__ frames,
             int f_real) {
  __shared__ float2 data[kN];
  __shared__ float2 s_tw[kN / 2];
  mlx::load_twiddles(s_tw, tw);
  const long long row = static_cast<long long>(blockIdx.x) * kBins;
  if (kLock) {  // (s_re, s_im, s_phi) hold (mag, psi, phi)
    lock_frame(s_re + row, s_im + row, s_phi + row,
               static_cast<int>(blockIdx.x) < f_real, data);
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

}  // namespace

extern "C" int mlx_pv_synth_ola_phase(
    const float* a, const float* b, const float* da, const float* win,
    const float2* tw, const float* phi0, const float* resid_in,
    const float* phi_prev, float* s_re, float* s_im, float* s_phi,
    float* frames, float* y, float* resid_last, float* phi_last,
    float* phi0_eff, int n_frames, int m0, int f_real, int hop, int cart,
    int lock, cudaStream_t stream) {
  if (n_frames <= 0 || hop <= 0 || (lock && s_phi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int scan_blocks = (kBins + kScanThreads - 1) / kScanThreads;
  auto scan = cart ? (lock ? phase_scan_kernel<true, true>
                           : phase_scan_kernel<true, false>)
                   : (lock ? phase_scan_kernel<false, true>
                           : phase_scan_kernel<false, false>);
  scan<<<scan_blocks, kScanThreads, 0, stream>>>(
      a, b, da, phi0, resid_in, phi_prev, s_re, s_im, s_phi, resid_last,
      phi_last, phi0_eff, n_frames, m0, f_real, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto synth = lock ? synth_kernel<true> : synth_kernel<false>;
  synth<<<n_frames, mlx::kFftThreads, 0, stream>>>(s_re, s_im, s_phi, win, tw,
                                                   frames, f_real);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long out_len = static_cast<long long>(n_frames - 1) * hop + kN;
  const int threads = 256;
  ola_kernel<<<static_cast<unsigned>((out_len + threads - 1) / threads),
               threads, 0, stream>>>(frames, y, n_frames, hop, out_len);
  return static_cast<int>(cudaGetLastError());
}
