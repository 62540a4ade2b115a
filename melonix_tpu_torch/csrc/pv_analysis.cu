// B2: windowed 2048-point forward DFT of frames at arbitrary int32 starts.
//
// Replaces melonix_tpu/kernels/pallas_pv.py:analysis (_ana_kernel,
// _fwd_dft), the TPU's double-buffered per-frame DMA + lane realign +
// four-step MXU DFT, which emitted the full 2048-bin spectrum in a
// scrambled bin order (an MXU layout trick).  The port keeps natural order
// and the 1025-bin half spectrum of a real frame.
//
// Contract: frame m covers wav[s, s + 2048) with s = clip(starts[m], 0,
// n-1), zeros past n, times win; re/im are (n_frames, 1025) float32, bins
// 0..1024 in natural order.
//
// Design: two real frames per complex transform, z = x_a + i x_b, on the
// 2048-point instance of the register-resident fft_pair.cuh; the halves
// come apart as
//   X_a[k] = (Z[k] + conj Z[N - k]) / 2,  X_b[k] = (Z[k] - conj Z[N - k]) / 2i,
// so no arithmetic or shared traffic is spent on a zero imaginary half.  A
// CTA of 128 threads loads its twiddles once and then walks frame pairs
// blockIdx.x, + gridDim.x, ... (the grid is what fits on the card at once).
// Each thread loads its 16 samples of both frames straight into registers,
// window and start clamp fused in the load: lanes read consecutive samples
// (coalesced scalar loads; the starts are arbitrary, so no vector
// alignment).  The epilogue reads Z[k] and Z[N - k] from shared memory and
// stores both frames' rows coalesced.  8 KB in and 8 KB out per frame: with
// the transform in registers the kernel should approach its HBM bound.
#include "fft_pair.cuh"

namespace {

namespace pf = mlx::pairfft;
using P = pf::Pair<2048>;

constexpr int kBins = P::kN / 2 + 1;

// Frame m's clamped start; n (all zeros) for a frame past the last, so an
// odd count pairs its last frame with silence.
__device__ __forceinline__ long long frame_start(const int* __restrict__ starts,
                                                 int m, int n_frames,
                                                 long long n) {
  if (m >= n_frames) return n;
  const long long s = starts[m];
  return s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
}

__device__ __forceinline__ float sample(const float* __restrict__ wav,
                                        long long idx, long long n) {
  return idx < n ? wav[idx] : 0.0f;
}

__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
pv_analysis_kernel(const float* __restrict__ wav, long long n,
                   const int* __restrict__ starts,
                   const float* __restrict__ win,
                   const float2* __restrict__ tw, float* __restrict__ re,
                   float* __restrict__ im, int n_frames) {
  extern __shared__ float2 buf[];  // two exchange buffers of P::kBuf
  pf::Twiddles<P::kN> twr;
  pf::load_twiddles<P::kN>(twr, tw);
  const int n_pairs = (n_frames + 1) / 2;
  int turn = 0;
  for (int p = blockIdx.x; p < n_pairs; p += gridDim.x, turn ^= 1) {
    const int ma = 2 * p, mb = 2 * p + 1;
    const long long sa = frame_start(starts, ma, n_frames, n);
    const long long sb = frame_start(starts, mb, n_frames, n);
    float2 v[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) {
      const int i = threadIdx.x + P::kThreads * a;
      const float w = win[i];
      v[a] = make_float2(sample(wav, sa + i, n) * w,
                         sample(wav, sb + i, n) * w);
    }
    float2* z = buf + turn * P::kBuf;
    pf::fft<P::kN>(v, twr, z, buf + (turn ^ 1) * P::kBuf, -1.0f);
    const long long row_a = static_cast<long long>(ma) * kBins;
    const long long row_b = row_a + kBins;
    for (int k = threadIdx.x; k < kBins; k += P::kThreads) {
      const float2 zk = z[k], zn = z[(P::kN - k) & (P::kN - 1)];
      re[row_a + k] = 0.5f * (zk.x + zn.x);
      im[row_a + k] = 0.5f * (zk.y - zn.y);
      if (mb < n_frames) {
        re[row_b + k] = 0.5f * (zk.y + zn.y);
        im[row_b + k] = 0.5f * (zn.x - zk.x);
      }
    }
  }
}

}  // namespace

extern "C" int mlx_pv_analysis(const float* wav, long long n,
                               const int* starts, const float* win,
                               const float2* tw, float* re, float* im,
                               int n_frames, cudaStream_t stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  const cudaError_t err = pf::persistent_grid(
      pv_analysis_kernel, P::kThreads, P::kSmem, (n_frames + 1) / 2, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  pv_analysis_kernel<<<grid, P::kThreads, P::kSmem, stream>>>(
      wav, n, starts, win, tw, re, im, n_frames);
  return static_cast<int>(cudaGetLastError());
}
