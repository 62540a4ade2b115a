// B3: phase-vocoder phase propagation + inverse DFT + window + overlap-add
// of one stretch chunk, straight from the analysis spectrum (re, im), or,
// on the formant path, from its warped magnitude and phase (mag, phi).
//
// Replaces melonix_tpu/kernels/pallas_pv.py:synth_ola_phase with cart=True
// and cart=False, lock=False and lock=True (_syn_ola_phase_kernel, _atan2,
// _lock_psis, _syn_body), which ran the whole chain in one kernel because
// the TPU's grid is sequential: a (size - hop)-row OLA carry and the
// frame-axis prefix sum (a lower-triangular matmul per block of frames plus
// a running carry, pallas_pv.py:752-790) rode from one grid step to the
// next.  Blocks on this card run in no order, so the chain becomes four
// launches on one stream (five off the fused overlap-add route), each
// parallel over what it can be:
//
//   1-3. the phase scan, blocked over frames as well as bins
//      (reduce-then-scan; launch_scan below).  Per frame m and bin k:
//      mag and phase (the correctly rounded sqrt of r*r + i*i and atan2f of
//      (re, im) with cart, so mag equals the plain twin's; read as given
//      without: the formant path passes the warped mag and phi,
//      pallas_pv.py:728-730), the princarg residual against
//      omega_k * max(da, 1e-3), incr = hop * dphi / da (0 on global frame
//      0), every product and sum rounded as the twin's torch ops round them
//      (__fmul_rn / __fadd_rn: no contraction), so the kernel's increments
//      are the twin's.  Only the running sum of incr is serial, and it is
//      summed in float64 and rounded once, resid = float(resid_in + sum):
//      the value the twin (a float64 cumsum), the seq-parallel path and the
//      exact sum all form.  The order is fixed, so the output is
//      bit-identical from run to run; no atomics.
//        1. scan_totals_kernel: a CTA covers 32 consecutive bins (one warp
//           reads a 128-byte row) by a tile of kScanTile = 128 frames; each
//           of its 8 rows of threads owns a run of kScanRun = 16 frames and
//           sums its increments serially in float64 (the phase of the frame
//           before the run is recomputed from the input, or phi_prev at
//           frame 0).  Row 0 adds the 8 run totals in order: one float64
//           total per (tile, bin).
//        2. scan_prefix_kernel: one thread per bin forms the exclusive
//           prefix of the tile totals in ascending tile order.
//        3. scan_apply_kernel: the grid of (1) recomputes each run's
//           increments, holds them in registers, forms the run's prefix as
//           tile prefix + the earlier runs' totals in order, then walks the
//           run: prefix += incr, resid = float(resid_in + prefix), the exact
//           int mod-size ramp, psi = phi0_eff + ramp + resid, the live-frame
//           mask and mag * e^{i psi} into the half spectrum (with lock: mag,
//           psi and phi, unmasked).  The thread owning frame f_real - 1
//           writes the carries resid_last and phi_last; phi0_eff is written
//           once a bin.  Formulas of
//           melonix_tpu/engine/phase_vocoder.py:_stretch_chunk_core:374-416.
//      Bounded by HBM: re/im are read twice (launches 1 and 3), the half
//      spectrum written once; the tile totals are (F / 128, 1025) float64.
//   4. synthesis (synth_pair_kernel<mode>, pv_synth.cuh, shared with B10's
//      pv_synth_ola.cu): two frames a 2048-point inverse of the register
//      pair transform (fft_pair.cuh): a CTA of 128 threads stages both
//      Hermitian half spectra in shared memory in natural order (the
//      DC/Nyquist imaginaries dropped as a c2r inverse drops them), forms
//      Z = X_a + i X_b, inverts it, and frame a is the real part, frame b
//      the imaginary, scaled by 1/2048 and windowed.  With lock a prologue
//      (lock_pair) first locks both frames' phases: locking needs every bin
//      of a frame at once, which the scan (a warp per 32 bins) never has.
//      It loads both frames' mag and psi - phi rows into the transform's
//      first exchange buffer, marks the peaks, finds each bin's nearest
//      peak below and above with a CTA-wide max-scan and min-scan of peak
//      indices (nine bins a thread, warp shuffles, then the four warp
//      totals; the two frames' chains side by side), and forms phi +
//      (psi - phi)[nearest peak] exactly as the engine's natural-order
//      identity_lock (phase_vocoder.py:129-189; the TPU kernel's scrambled
//      full-spectrum variant, which resolves ties against the mirror
//      image, is not followed), then the live mask and mag * e^{i psi}.
//   5. overlap-add, by the hop (kpv.ola_route): for 256 <= hop <= 2048 in
//      the synthesis launch itself, carried along each CTA's contiguous
//      range of frame pairs in a shared ring (the TPU kernel's carried OLA,
//      the carry per CTA); otherwise the frame rows go to an (F, 2048)
//      matrix and ola_kernel sums them.  Either way each output sample is
//      summed from 0.0f over its frames in ascending order: a fixed order,
//      no atomics, deterministic, and the two routes give the same bits.
//
// The wrapper allocates the (F, 1025) half spectrum (with lock: mag, psi
// and a third (F, 1025) row set for phi), the scan's 2 x (ceil(F / 128),
// 1025) float64 tile totals and prefixes and, off the fused route, the
// (F, 2048) frame matrix as scratch; the kernels allocate nothing.
// mlx_pv_phase_scan runs launches 1-3 alone (to time the scan).
#include "pv_synth.cuh"

namespace {

constexpr int kScanLanes = 32;  // bins of a CTA: one warp, one 128-byte row
constexpr int kScanRun = 16;    // frames a thread sums serially
constexpr int kScanRuns = 8;    // runs of a tile: the CTA's rows of threads
constexpr int kScanTile = kScanRun * kScanRuns;  // frames of a tile
constexpr int kBinGroups = (kBins + kScanLanes - 1) / kScanLanes;
constexpr int kPrefixThreads = 128;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kTwoPiOverN = 6.28318530717958647692f / kN;

// jnp.mod / torch.remainder for float32: the result takes the divisor's sign.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r = __fadd_rn(r, b);
  return r;
}

// The phase of entry `at`: atan2f of (re, im), or phi as given.
template <bool kCart>
__device__ __forceinline__ float phase_of(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          long long at) {
  return kCart ? atan2f(b[at], a[at]) : b[at];
}

// The magnitude and phase of entry `at`.
template <bool kCart>
__device__ __forceinline__ void mag_phase(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          long long at, float& mag,
                                          float& phi) {
  if (kCart) {  // (a, b) = (re, im) of the analysis spectrum
    const float r = a[at], i = b[at];
    mag = __fsqrt_rn(__fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)));
    phi = atan2f(i, r);
  } else {  // (a, b) = (mag, phi), the formant path's warped magnitude
    mag = a[at];
    phi = b[at];
  }
}

// hop * princarg(phi - prev - omega * d) / d, d = max(da, 1e-3), rounded
// op by op as the twin's torch ops round it; 0 on the chunk's global frame 0.
__device__ __forceinline__ float increment(float phi, float prev, float omega,
                                           float da, int hop, bool first) {
  const float d = fmaxf(da, 1e-3f);
  const float x = __fsub_rn(__fsub_rn(phi, prev), __fmul_rn(omega, d));
  const float dphi = __fsub_rn(floor_mod(__fadd_rn(x, kPi), kTwoPi), kPi);
  return first ? 0.0f
               : __fdiv_rn(__fmul_rn(static_cast<float>(hop), dphi), d);
}

// 1. Each thread: the float64 sum of its run's increments; row 0: the
// tile's total (the 8 run totals added in order).
template <bool kCart>
__global__ void __launch_bounds__(kScanLanes * kScanRuns)
scan_totals_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ da,
                   const float* __restrict__ phi_prev,
                   double* __restrict__ tile_tot, int n_frames, int m0,
                   int hop) {
  __shared__ double s_run[kScanRuns][kScanLanes];
  const int lane = threadIdx.x, run = threadIdx.y, tile = blockIdx.y;
  const int k = blockIdx.x * kScanLanes + lane;
  const int m_lo = tile * kScanTile + run * kScanRun;
  double sum = 0.0;
  if (k < kBins && m_lo < n_frames) {
    const float omega = __fmul_rn(kTwoPiOverN, static_cast<float>(k));
    float prev = m_lo == 0 ? phi_prev[k]
                           : phase_of<kCart>(
                                 a, b, static_cast<long long>(m_lo - 1) * kBins + k);
#pragma unroll
    for (int j = 0; j < kScanRun; ++j) {
      const int m = m_lo + j;
      if (m < n_frames) {
        const float phi =
            phase_of<kCart>(a, b, static_cast<long long>(m) * kBins + k);
        sum += static_cast<double>(
            increment(phi, prev, omega, da[m], hop, m == 0 && m0 == 0));
        prev = phi;
      }
    }
  }
  s_run[run][lane] = sum;
  __syncthreads();
  if (run == 0 && k < kBins) {
    double total = s_run[0][lane];
#pragma unroll
    for (int r = 1; r < kScanRuns; ++r) total += s_run[r][lane];
    tile_tot[static_cast<long long>(tile) * kBins + k] = total;
  }
}

// 2. The exclusive prefix of the tile totals along frames, per bin, in
// ascending tile order.
__global__ void __launch_bounds__(kPrefixThreads)
scan_prefix_kernel(const double* __restrict__ tile_tot,
                   double* __restrict__ tile_pre, int n_tiles) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= kBins) return;
  double acc = 0.0;
#pragma unroll 8
  for (int t = 0; t < n_tiles; ++t) {
    const long long at = static_cast<long long>(t) * kBins + k;
    tile_pre[at] = acc;
    acc += tile_tot[at];
  }
}

// 3. The run's increments again, its prefix, and everything formed from
// resid.  s_re/s_im/s_phi as the synthesis launch reads them.
template <bool kCart, bool kLock>
__global__ void __launch_bounds__(kScanLanes * kScanRuns)
scan_apply_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ da,
                  const float* __restrict__ phi0,
                  const float* __restrict__ resid_in,
                  const float* __restrict__ phi_prev,
                  const double* __restrict__ tile_pre,
                  float* __restrict__ s_re, float* __restrict__ s_im,
                  float* __restrict__ s_phi, float* __restrict__ resid_last,
                  float* __restrict__ phi_last, float* __restrict__ phi0_eff,
                  int n_frames, int m0, int f_real, int hop) {
  __shared__ double s_run[kScanRuns][kScanLanes];
  const int lane = threadIdx.x, run = threadIdx.y, tile = blockIdx.y;
  const int k = blockIdx.x * kScanLanes + lane;
  const int m_lo = tile * kScanTile + run * kScanRun;
  const bool active = k < kBins && m_lo < n_frames;
  float mag[kScanRun], phi[kScanRun], inc[kScanRun];
  double total = 0.0;
  if (active) {
    const float omega = __fmul_rn(kTwoPiOverN, static_cast<float>(k));
    float prev = m_lo == 0 ? phi_prev[k]
                           : phase_of<kCart>(
                                 a, b, static_cast<long long>(m_lo - 1) * kBins + k);
#pragma unroll
    for (int j = 0; j < kScanRun; ++j) {
      const int m = m_lo + j;
      mag[j] = phi[j] = inc[j] = 0.0f;
      if (m < n_frames) {
        mag_phase<kCart>(a, b, static_cast<long long>(m) * kBins + k, mag[j],
                         phi[j]);
        inc[j] = increment(phi[j], prev, omega, da[m], hop, m == 0 && m0 == 0);
        total += static_cast<double>(inc[j]);  // the same sum as launch 1's
        prev = phi[j];
      }
    }
  }
  s_run[run][lane] = total;
  __syncthreads();
  if (!active) return;
  double acc = tile_pre[static_cast<long long>(tile) * kBins + k];
  for (int r = 0; r < run; ++r) acc += s_run[r][lane];
  const double rin = static_cast<double>(resid_in[k]);
  // global frame 0 has no predecessor: psi_0 = phi_0
  const float p0e = m0 == 0 ? phase_of<kCart>(a, b, k) : phi0[k];
  const int last = min(max(f_real - 1, 0), n_frames - 1);
#pragma unroll
  for (int j = 0; j < kScanRun; ++j) {
    const int m = m_lo + j;
    if (m < n_frames) {
      const long long at = static_cast<long long>(m) * kBins + k;
      acc += static_cast<double>(inc[j]);
      const float resid = static_cast<float>(rin + acc);
      // psi = phi0 + (m * hop * omega mod 2 pi) + resid, the ramp in exact
      // integer arithmetic (a float running phase loses whole radians at
      // hour scale).  64-bit: (m0 + m) * hop passes 2^31 past ~4M frames.
      const long long hm = (static_cast<long long>(m0 + m) * hop) % kN;
      const int prod = static_cast<int>((hm * k) % kN);
      const float psi = __fadd_rn(
          __fadd_rn(p0e, __fmul_rn(kTwoPiOverN, static_cast<float>(prod))),
          resid);
      if (kLock) {  // the synthesis launch locks, masks and rotates
        s_re[at] = mag[j];
        s_im[at] = psi;
        s_phi[at] = phi[j];
      } else {
        const float mag_live = m < f_real ? mag[j] : 0.0f;
        float sn, cs;
        sincosf(psi, &sn, &cs);
        s_re[at] = mag_live * cs;
        s_im[at] = mag_live * sn;
      }
      if (m == last) {
        resid_last[k] = resid;
        phi_last[k] = phi[j];
      }
    }
  }
  if (m_lo == 0) phi0_eff[k] = p0e;
}

template <bool kCart, bool kLock>
cudaError_t launch_scan_t(const float* a, const float* b, const float* da,
                          const float* phi0, const float* resid_in,
                          const float* phi_prev, double* scratch,
                          float* s_re, float* s_im, float* s_phi,
                          float* resid_last, float* phi_last,
                          float* phi0_eff, int n_frames, int m0, int f_real,
                          int hop, cudaStream_t stream) {
  const int n_tiles = (n_frames + kScanTile - 1) / kScanTile;
  double* tile_tot = scratch;
  double* tile_pre = scratch + static_cast<long long>(n_tiles) * kBins;
  const dim3 grid(kBinGroups, n_tiles), block(kScanLanes, kScanRuns);
  scan_totals_kernel<kCart><<<grid, block, 0, stream>>>(
      a, b, da, phi_prev, tile_tot, n_frames, m0, hop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_prefix_kernel<<<(kBins + kPrefixThreads - 1) / kPrefixThreads,
                       kPrefixThreads, 0, stream>>>(tile_tot, tile_pre,
                                                    n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_apply_kernel<kCart, kLock><<<grid, block, 0, stream>>>(
      a, b, da, phi0, resid_in, phi_prev, tile_pre, s_re, s_im, s_phi,
      resid_last, phi_last, phi0_eff, n_frames, m0, f_real, hop);
  return cudaGetLastError();
}

// Launches 1-3; scratch holds 2 * ceil(n_frames / kScanTile) * kBins doubles.
cudaError_t launch_scan(const float* a, const float* b, const float* da,
                        const float* phi0, const float* resid_in,
                        const float* phi_prev, double* scratch, float* s_re,
                        float* s_im, float* s_phi, float* resid_last,
                        float* phi_last, float* phi0_eff, int n_frames,
                        int m0, int f_real, int hop, int cart, int lock,
                        cudaStream_t stream) {
  if (n_frames <= 0 || hop <= 0 || (lock && s_phi == nullptr) ||
      (n_frames + kScanTile - 1) / kScanTile > 65535) {
    return cudaErrorInvalidValue;
  }
  auto scan = cart ? (lock ? launch_scan_t<true, true>
                           : launch_scan_t<true, false>)
                   : (lock ? launch_scan_t<false, true>
                           : launch_scan_t<false, false>);
  return scan(a, b, da, phi0, resid_in, phi_prev, scratch, s_re, s_im, s_phi,
              resid_last, phi_last, phi0_eff, n_frames, m0, f_real, hop,
              stream);
}

}  // namespace

extern "C" int mlx_pv_phase_scan(
    const float* a, const float* b, const float* da, const float* phi0,
    const float* resid_in, const float* phi_prev, double* scratch,
    float* s_re, float* s_im, float* s_phi, float* resid_last,
    float* phi_last, float* phi0_eff, int n_frames, int m0, int f_real,
    int hop, int cart, int lock, cudaStream_t stream) {
  return static_cast<int>(launch_scan(
      a, b, da, phi0, resid_in, phi_prev, scratch, s_re, s_im, s_phi,
      resid_last, phi_last, phi0_eff, n_frames, m0, f_real, hop, cart, lock,
      stream));
}

extern "C" int mlx_pv_synth_ola_phase(
    const float* a, const float* b, const float* da, const float* win,
    const float2* tw, const float* phi0, const float* resid_in,
    const float* phi_prev, double* scratch, float* s_re, float* s_im,
    float* s_phi, float* frames, float* y, float* resid_last,
    float* phi_last, float* phi0_eff, int n_frames, int m0, int f_real,
    int hop, int cart, int lock, int fused, cudaStream_t stream) {
  cudaError_t err = launch_scan(a, b, da, phi0, resid_in, phi_prev, scratch,
                                s_re, s_im, s_phi, resid_last, phi_last,
                                phi0_eff, n_frames, m0, f_real, hop, cart,
                                lock, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto synth = lock ? launch_synth<kSynthLocked> : launch_synth<kSynthHalf>;
  return static_cast<int>(synth(s_re, s_im, s_phi, win, tw, frames, y,
                                n_frames, f_real, hop, fused, stream));
}
