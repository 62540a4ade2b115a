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
//   2. synthesis (synth_kernel<mode>, pv_synth.cuh, shared with B10's
//      pv_synth_ola.cu): one block per frame takes the Hermitian half
//      spectrum, drops the DC/Nyquist imaginaries as a c2r inverse does,
//      runs the inverse fft2048, scales by 1/2048 and applies the window.
//      Bounded by the FFT's shared-memory passes.  With lock a
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
//   3. overlap-add (ola_kernel, pv_synth.cuh): one thread per output sample
//      sums the size/hop frames that cover it in ascending frame order: a
//      fixed order, no atomics, deterministic.  Bounded by HBM: each frame
//      sample is read once, coalesced.
//
// The wrapper allocates the (F, 1025) half spectrum (with lock: mag, psi
// and a third (F, 1025) row set for phi) and the (F, 2048) frame matrix as
// scratch; the kernels allocate nothing.
#include "pv_synth.cuh"

namespace {

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
  auto synth = lock ? synth_kernel<kSynthLocked> : synth_kernel<kSynthHalf>;
  synth<<<n_frames, mlx::kFftThreads, 0, stream>>>(s_re, s_im, s_phi, win, tw,
                                                   frames, f_real);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ola(frames, y, n_frames, hop, stream));
}
