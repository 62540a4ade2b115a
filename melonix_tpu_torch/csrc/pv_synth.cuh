// The synthesis and overlap-add shared by B3 (pv_synth_ola_phase.cu) and
// B10 (pv_synth_ola.cu), on the 2048-point inverse of the register pair
// transform (fft_pair.cuh, sign = +1).
//
// Contract: frame m's samples are irfft(X_m)[i] / 2048 * win[i] (i < 2048,
// the DC and Nyquist imaginaries dropped as a c2r inverse drops them), and
// y[j] = sum over the frames m that cover j, in ascending m from 0.0f, of
// frame m's sample j - m * hop; j < (F - 1) * hop + 2048.
//
// Design: two frames a transform.  A c2r inverse has a real output, so the
// Hermitian spectra of frames a and b share one complex inverse,
//   Z[n] = X_a[n] + i X_b[n],  X[n] = conj X[2048 - n] for n > 1024,
// whose result is z = x_a + i x_b: frame a is z.x and frame b z.y.  A CTA
// of Pair<2048>::kThreads = 128 threads loads its pass twiddles into
// registers once (kpv.pair_twiddles(2048)) and walks a contiguous range of
// frame pairs (a, b) = (2p, 2p + 1) in ascending order (the persistent
// grid: what fits on the card at once).  Per pair:
//   1. stage: the two half spectra go to shared buffer B in natural order,
//      one float4 (X_a, X_b) a bin, coalesced row loads.  The mode says
//      what the rows hold:
//        - kSynthHalf: B3's half spectrum (re, im), as its scan wrote it;
//        - kSynthPolar: B10's (mag, psi): mag * e^{i psi} (the caller has
//          masked mag already);
//        - kSynthLocked: B3's (mag, psi, phi): lock_pair finds each bin's
//          nearest peak in both frames side by side from their mag and psi
//          - phi rows in shared memory; the staging then forms phi + that
//          peak's psi - phi, masks the frames at or past f_real and
//          rotates.
//      sincosf (not __sincosf: |psi| reaches ~8e5 rad on a three-minute
//      track), after a float64 reduction by whole turns (polar_bin), runs
//      here, before the transform's points are live in registers, once a
//      bin.  An odd frame count pairs its last frame with a zero spectrum.
//   2. thread t reads Z[t + 128 a] (a < 16) from the staged bins: the
//      bins n <= 1023 directly, the rest as the mirror 2048 - n (a warp's
//      reads run backwards through consecutive bins: whole sectors, no
//      bank conflicts);
//   3. the inverse transform, its result z[i] in buffer A;
//   4. epilogue, on one of two routes picked by the hop (kpv.ola_route):
//        - frames: frame a sample i is z[i].x * (1/2048) * win[i], frame b
//          the same of z[i].y, stored to the (F, 2048) frame matrix; then
//          ola_kernel (one thread an output sample, frames in ascending
//          order) sums them;
//        - fused (kOlaMinHop <= hop <= kOlaMaxHop, so ceil(2048 / hop) <=
//          8): the TPU kernel's carried overlap-add with the carry held in
//          the CTA.  CTA c owns the output samples [2 p_s hop, 2 p_e hop)
//          of its pairs [p_s, p_e) (the last CTA through the end).  It first
//          recomputes the pairs holding the ceil(2048 / hop) - 1 frames
//          before 2 p_s whose support reaches its first sample, then adds
//          each frame, a before b, into a ring of 2048 + 2 hop floats in
//          shared memory that starts at 0.0f.  After pair p the samples
//          before (2p + 2) hop are final (later frames start there): their
//          owner writes each once and zeroes its slot.  Every sample is so
//          summed from 0.0f over its frames in ascending order, the order of
//          ola_kernel, with the same rounded frame samples (__fmul_rn /
//          __fadd_rn: no contraction), and the frame matrix never reaches
//          device memory.  Both routes run the one kernel (a runtime flag),
//          so the transform is the same machine code: they give the same
//          bits.
// Barriers a pair: stage, the transform's three (the lock adds three:
// its rows landed, its scans, its result).  Buffer A (exchange 1, the
// result, read by the epilogue) is next written after the next pair's
// first barrier; buffer B (staging, exchange 2) is last read before the
// transform's final barrier; the ring is last touched before the next
// stage barrier.  The lock's rows (mag and psi - phi of both frames) go to
// buffer B and its result to buffer A, so it takes no shared memory of its
// own (24 KB beside the transform's 34 KB would cost a CTA a SM).
//
// What bounds it: the spectra are read once and y written once (~155 MB at
// the 180 s song's 15,104 frames, ~0.046 ms at 3.35 TB/s); the frames route
// adds the frame matrix's write and read (2 x 124 MB), the fused route
// ~2 / (pairs a CTA) recomputed pairs' reads.
//
// Each translation unit that includes this header gets its own copy of the
// kernels (anonymous namespace): they are templates and small.
#pragma once

#include "fft_pair.cuh"

namespace {

namespace pf = mlx::pairfft;
using SynthPair = pf::Pair<2048>;

constexpr int kN = SynthPair::kN;
constexpr int kBins = kN / 2 + 1;
constexpr int kThreads = SynthPair::kThreads;  // 128
constexpr int kPoints = kN / kThreads;          // 16 a thread

enum SynthMode { kSynthHalf = 0, kSynthLocked = 1, kSynthPolar = 2 };

// The fused overlap-add's hops: ceil(2048 / hop) <= 8, and a pair's span
// (hop + 2048) covers the 2 hop samples it finalises.
constexpr int kOlaMinHop = kN / 8;
constexpr int kOlaMaxHop = kN;

// Shared memory of a CTA, in bytes: the two exchange buffers (A, then B;
// they also hold the staged bins and kSynthLocked's rows) and the fused
// route's ring.
constexpr size_t kSmemPair = 2 * SynthPair::kBuf * sizeof(float2);
static_assert(4 * kBins <= 2 * SynthPair::kBuf,
              "the staged bins and the lock rows fit one buffer");
static_assert(kPoints == 16, "Pair<2048> threads hold 16 points");

__host__ __device__ constexpr int ring_len(int hop) { return kN + 2 * hop; }

inline size_t synth_smem(bool fused, int hop) {
  return kSmemPair + (fused ? sizeof(float) * ring_len(hop) : 0);
}

// Bins a thread of the lock prologue owns, and the scans' sentinels.
constexpr int kPer = (kBins + kThreads - 1) / kThreads;  // 9
constexpr int kWarps = kThreads / 32;                     // 4
constexpr int kNoPeakBelow = -1;
constexpr int kNoPeakAbove = 0x7fffffff;
constexpr int kFar = 1 << 30;
static_assert(kPer <= 32, "a thread's peaks fit one 32-bit mask");

__device__ __forceinline__ float mag_or_edge(const float* m, int k) {
  return k >= 0 && k < kBins ? m[k] : -1.0f;
}

// Bin k as mag * e^{i psi}; the imaginaries of DC and Nyquist dropped.
// psi is reduced by whole turns in float64 first, psi = 2 pi q + r (exact
// to ~1e-10 rad below 2^31 rad), and r = hi + lo in two floats: sincosf(hi)
// takes its fast path (its own reduction walks a table in local memory
// above |psi| ~ 1e5 rad, and the phases of a long track reach ~8e5;
// __sincosf would lose digits there instead), and lo (<= 1.2e-7) enters to
// first order: the result stays within a few float32 spacings of the exact
// values, as sincosf(psi)'s does.
__device__ __forceinline__ float2 polar_bin(int k, float mag, float psi) {
  constexpr double kTwoPi = 6.28318530717958647692;
  const double d = static_cast<double>(psi);
  const double r = fma(-rint(d * (1.0 / kTwoPi)), kTwoPi, d);
  const float hi = static_cast<float>(r);
  const float lo = static_cast<float>(r - static_cast<double>(hi));
  float sn, cs;
  sincosf(hi, &sn, &cs);
  const float s = fmaf(cs, lo, sn), c = fmaf(-sn, lo, cs);
  const bool real_bin = k == 0 || k == kN / 2;
  return make_float2(mag * c, real_bin ? 0.0f : mag * s);
}

// Identity locking of both frames of a pair.  rows (shared memory, kBins
// floats each): mag_a, mag_b, theta_a, theta_b, theta = psi - phi; into
// out (another shared buffer, the same layout) go mag and, for each bin,
// the theta of its nearest peak (the lower on a tie; its own where the
// frame has no peak): the locked phase is phi + that theta.  Thread t owns
// bins [kPer t, kPer t + kPer) of both frames, whose chains run side by
// side.  Every thread of the CTA must call it; one barrier.
__device__ __forceinline__ void lock_pair(const float* rows, float* out,
                                          int (*s_wlast)[kWarps],
                                          int (*s_wfirst)[kWarps]) {
  const int t = threadIdx.x;
  const int lo = t * kPer;
  const unsigned full = 0xffffffffu;
  const int lane = t & 31, warp = t >> 5;
  // peaks among this thread's bins [lo, lo + kPer): mag > 0, above k-1 and
  // k-2, at least k+1 and k+2 (edges -1)
  unsigned peaks[2] = {0u, 0u};
  int incl_last[2], incl_first[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const float* s_mag = rows + f * kBins;
    float m[kPer + 4];  // bins lo - 2 ... lo + kPer + 1
#pragma unroll
    for (int i = 0; i < kPer + 4; ++i) m[i] = mag_or_edge(s_mag, lo - 2 + i);
    int last = kNoPeakBelow, first = kNoPeakAbove;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lo + i;
      const float c = m[i + 2];
      if (k < kBins && c > 0.0f && c > m[i + 1] && c > m[i] &&
          c >= m[i + 3] && c >= m[i + 4]) {
        peaks[f] |= 1u << i;
        last = k;
        if (first == kNoPeakAbove) first = k;
      }
    }
    incl_last[f] = last;
    incl_first[f] = first;
  }
  // last peak below this thread's bins (exclusive max-scan of `last`) and
  // first peak above them (exclusive min-scan of `first` from the right)
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int up = __shfl_up_sync(full, incl_last[f], o);
      const int down = __shfl_down_sync(full, incl_first[f], o);
      if (lane >= o) incl_last[f] = max(incl_last[f], up);
      if (lane + o < 32) incl_first[f] = min(incl_first[f], down);
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    if (lane == 31) s_wlast[f][warp] = incl_last[f];
    if (lane == 0) s_wfirst[f][warp] = incl_first[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const float* s_mag = rows + f * kBins;
    const float* s_theta = rows + (2 + f) * kBins;
    int below = __shfl_up_sync(full, incl_last[f], 1);
    int above = __shfl_down_sync(full, incl_first[f], 1);
    if (lane == 0) below = kNoPeakBelow;
    if (lane == 31) above = kNoPeakAbove;
    for (int w = 0; w < warp; ++w) below = max(below, s_wlast[f][w]);
    for (int w = warp + 1; w < kWarps; ++w) {
      above = min(above, s_wfirst[f][w]);
    }
    int near_below[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if ((peaks[f] >> i) & 1u) below = lo + i;
      near_below[i] = below;
    }
#pragma unroll
    for (int i = kPer - 1; i >= 0; --i) {
      const int k = lo + i;
      if (k >= kBins) continue;
      if ((peaks[f] >> i) & 1u) above = k;
      const int d_f = near_below[i] != kNoPeakBelow ? k - near_below[i] : kFar;
      const int d_b = above != kNoPeakAbove ? above - k : kFar;
      float th = s_theta[k];  // no peak in the frame: phi + theta
      if (min(d_f, d_b) < kFar) {
        th = s_theta[d_f <= d_b ? near_below[i] : above];  // tie: the lower
      }
      out[f * kBins + k] = s_mag[k];
      out[(2 + f) * kBins + k] = th;
    }
  }
}

// One output sample of a frame: x / 2048 * w, each product rounded (the
// frames route stores it, the fused route adds it: the same bits).
__device__ __forceinline__ float frame_sample(float x, float w) {
  return __fmul_rn(__fmul_rn(x, 1.0f / kN), w);
}

// The pair synthesis of F = n_frames rows (s_re, s_im, s_phi as the mode
// says), with `fused` the overlap-add into y, else frame rows into
// `frames` for ola_kernel.  Dynamic shared memory: synth_smem(fused,
// hop).
template <int kMode>
__global__ void __launch_bounds__(kThreads, SynthPair::kMinBlocks)
synth_pair_kernel(const float* __restrict__ s_re,
                  const float* __restrict__ s_im,
                  const float* __restrict__ s_phi,
                  const float* __restrict__ win,
                  const float2* __restrict__ tw, float* __restrict__ frames,
                  float* __restrict__ y, int n_frames, int f_real, int hop,
                  int fused) {
  extern __shared__ float2 synth_smem_buf[];
  float2* buf_a = synth_smem_buf;                     // exchange 1, result
  float2* buf_b = synth_smem_buf + SynthPair::kBuf;   // staging, exchange 2
  float* ring = reinterpret_cast<float*>(synth_smem_buf + 2 * SynthPair::kBuf);
  __shared__ int s_wlast[2][kWarps], s_wfirst[2][kWarps];
  const int t = threadIdx.x;
  pf::Twiddles<kN> twr;
  pf::load_twiddles<kN>(twr, tw);
  const int n_pairs = (n_frames + 1) / 2;
  const int c = blockIdx.x, g = gridDim.x;
  const int p_s = static_cast<int>(static_cast<long long>(n_pairs) * c / g);
  const int p_e =
      static_cast<int>(static_cast<long long>(n_pairs) * (c + 1) / g);
  const int ring_n = ring_len(hop);
  int p0 = p_s;
  long long own_lo = 0, own_hi = 0;
  if (fused) {
    // frames before 2 p_s whose support reaches sample 2 p_s hop
    const int back = (kN + hop - 1) / hop - 1;
    const int m_s = 2 * p_s;
    p0 = m_s >= back ? (m_s - back) / 2 : 0;
    own_lo = static_cast<long long>(m_s) * hop;
    own_hi = c == g - 1
                 ? static_cast<long long>(n_frames - 1) * hop + kN
                 : static_cast<long long>(2 * p_e) * hop;
    for (int i = t; i < ring_n; i += kThreads) ring[i] = 0.0f;
  }
  for (int p = p0; p < p_e; ++p) {
    const int ma = 2 * p, mb = ma + 1;
    const bool has_b = mb < n_frames;
    const long long row_a = static_cast<long long>(ma) * kBins;
    const long long row_b = row_a + kBins;
    // 1. stage both half spectra in natural order: buf_b[k] = (X_a, X_b)
    const float* locked = reinterpret_cast<const float*>(buf_a);
    if (kMode == kSynthLocked) {  // (s_re, s_im, s_phi) hold (mag, psi, phi)
      // mag and theta = psi - phi to buffer B (last read before the last
      // transform's final barrier); lock_pair's result to buffer A (last
      // read by the last epilogue, before the barrier here)
      float* rows = reinterpret_cast<float*>(buf_b);
      for (int k = t; k < kBins; k += kThreads) {
        rows[k] = s_re[row_a + k];
        rows[kBins + k] = has_b ? s_re[row_b + k] : 0.0f;
        rows[2 * kBins + k] = s_im[row_a + k] - s_phi[row_a + k];
        rows[3 * kBins + k] =
            has_b ? s_im[row_b + k] - s_phi[row_b + k] : 0.0f;
      }
      __syncthreads();
      lock_pair(rows, reinterpret_cast<float*>(buf_a), s_wlast, s_wfirst);
      __syncthreads();
    }
    float4* stage = reinterpret_cast<float4*>(buf_b);
    for (int k = t; k < kBins; k += kThreads) {
      float2 xa, xb = make_float2(0.0f, 0.0f);
      if (kMode == kSynthLocked) {  // phi + the nearest peak's theta
        xa = polar_bin(k, ma < f_real ? locked[k] : 0.0f,
                       s_phi[row_a + k] + locked[2 * kBins + k]);
        if (has_b) {
          xb = polar_bin(k, mb < f_real ? locked[kBins + k] : 0.0f,
                         s_phi[row_b + k] + locked[3 * kBins + k]);
        }
      } else if (kMode == kSynthPolar) {  // (s_re, s_im) hold (mag, psi)
        xa = polar_bin(k, s_re[row_a + k], s_im[row_a + k]);
        if (has_b) xb = polar_bin(k, s_re[row_b + k], s_im[row_b + k]);
      } else {
        const bool real_bin = k == 0 || k == kN / 2;
        xa = make_float2(s_re[row_a + k], real_bin ? 0.0f : s_im[row_a + k]);
        if (has_b) {
          xb = make_float2(s_re[row_b + k], real_bin ? 0.0f : s_im[row_b + k]);
        }
      }
      stage[k] = make_float4(xa.x, xa.y, xb.x, xb.y);
    }
    __syncthreads();
    // 2. Z[n] = X_a[n] + i X_b[n] at n = t + 128 a, the mirror for n > 1023
    float2 v[kPoints];
#pragma unroll
    for (int a = 0; a < kPoints; ++a) {
      const int n = t + kThreads * a;
      if (a < kPoints / 2) {  // n <= 1023
        const float4 x = stage[n];
        v[a] = make_float2(x.x - x.w, x.y + x.z);
      } else {  // X[n] = conj X[2048 - n] (n = 1024: Nyquist, imag 0)
        const float4 x = stage[kN - n];
        v[a] = make_float2(x.x + x.w, x.z - x.y);
      }
    }
    // 3. the inverse transform: buf_a[i] = 2048 (x_a[i] + i x_b[i])
    pf::fft<kN>(v, twr, buf_a, buf_b, 1.0f);
    // 4. the epilogue
    if (!fused) {
      float* out_a = frames + static_cast<long long>(ma) * kN;
#pragma unroll 4
      for (int a = 0; a < kPoints; ++a) {
        const int i = t + kThreads * a;
        const float2 zi = buf_a[i];
        const float w = __ldg(win + i);
        out_a[i] = frame_sample(zi.x, w);
        if (has_b) out_a[kN + i] = frame_sample(zi.y, w);
      }
    } else {
      const long long j0 = static_cast<long long>(ma) * hop;
      const int span = has_b ? hop + kN : kN;
      const int fin = p == n_pairs - 1 ? span : 2 * hop;  // final samples
      const int r0 = static_cast<int>(j0 % ring_n);
      for (int o = t; o < span; o += kThreads) {
        const long long j = j0 + o;
        int r = r0 + o;
        if (r >= ring_n) r -= ring_n;
        float s = ring[r];
        if (o < kN) s = __fadd_rn(s, frame_sample(buf_a[o].x, __ldg(win + o)));
        const int ob = o - hop;
        if (has_b && ob >= 0 && ob < kN) {
          s = __fadd_rn(s, frame_sample(buf_a[ob].y, __ldg(win + ob)));
        }
        if (o < fin) {
          if (j >= own_lo && j < own_hi) y[j] = s;
          s = 0.0f;
        }
        ring[r] = s;
      }
    }
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

// The synthesis of F = n_frames rows into y ((F - 1) * hop + 2048 samples):
// with `fused` one launch (kOlaMinHop <= hop <= kOlaMaxHop), else the pair
// synthesis into `frames` ((F, 2048) scratch) and ola_kernel.  Returns the
// first launch error.
template <int kMode>
cudaError_t launch_synth(const float* s_re, const float* s_im,
                         const float* s_phi, const float* win,
                         const float2* tw, float* frames, float* y,
                         int n_frames, int f_real, int hop, int fused,
                         cudaStream_t stream) {
  if (n_frames <= 0 || hop <= 0 ||
      (fused && (hop < kOlaMinHop || hop > kOlaMaxHop)) ||
      (!fused && frames == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = synth_smem(fused != 0, hop);
  int grid = 0;
  cudaError_t err = pf::persistent_grid(synth_pair_kernel<kMode>, kThreads,
                                        smem, (n_frames + 1) / 2, &grid);
  if (err != cudaSuccess) return err;
  synth_pair_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      s_re, s_im, s_phi, win, tw, frames, y, n_frames, f_real, hop, fused);
  err = cudaGetLastError();
  if (err != cudaSuccess || fused) return err;
  const long long out_len = static_cast<long long>(n_frames - 1) * hop + kN;
  const int threads = 256;
  ola_kernel<<<static_cast<unsigned>((out_len + threads - 1) / threads),
               threads, 0, stream>>>(frames, y, n_frames, hop, out_len);
  return cudaGetLastError();
}

}  // namespace
