// B4: the phase vocoder's variable-rate resample with in-register positions.
//
// Replaces melonix_tpu/kernels/pallas_resample.py:resample_pv_pallas
// (_pv_kernel, expm1_precise), which DMA'd each 2048-sample output block's
// source slab into VMEM and lane-gathered within it, with the per-anchor
// constants scalar-prefetched into SMEM.
//
// Contract (per output sample j < n_out, block b = j / 2048):
//   the last anchor a in [a0[b], a0[b] + cnt[b]) with anc_j[a] <= j gives
//   j0, src0, r, s;  dt = (j - j0) / sr  (exact int32 difference);
//   x = s * dt * ln2/12;  delta_p = |s| < 1e-9 ? dt : expm1(x) / (s * ln2/12);
//   pos = max(src0 + r * (delta_p * sr - expm1(x)), 0)   (block-relative);
//   i0 = base[b] + floor(pos), frac = pos - floor(pos);
//   out[j] = (1 - frac) * y[clamp(i0)] + frac * y[clamp(i0 + 1)],
// indices clamped to [0, n_src - 1] as in
// melonix_tpu/engine/phase_vocoder.py:_lerp_resample_rel_xla.
//
// Design: one thread per output sample; a block's anchors are a handful of
// scalars that every thread of the block reads (L1 broadcasts), and the two
// taps are neighbouring loads whose addresses rise with j (mostly
// coalesced, the rate is near 1).  Bounded by HBM: ~12 bytes moved per
// output sample.  expm1f is CUDA's (max 1 ulp); the plain twin keeps the
// TPU's Horner expm1_precise, and the smoke run compares the two.
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;
constexpr float kLn2Over12 = 0.057762265046662105f;  // ln(2) / 12

__global__ void resample_pv_kernel(
    const float* __restrict__ y, long long n_src,
    const int* __restrict__ base, const int* __restrict__ a0,
    const int* __restrict__ cnt, const int* __restrict__ anc_j,
    const float* __restrict__ anc_src, const float* __restrict__ anc_r,
    const float* __restrict__ anc_s, int n_anc, float* __restrict__ out,
    long long n_out, int sr) {
  const long long jl = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (jl >= n_out) return;
  const int j = static_cast<int>(jl);
  const int b = j / kBlk;
  const int first = a0[b];
  const int count = cnt[b];
  int sel = -1;
  for (int k = 0; k < count; ++k) {
    const int a = min(first + k, n_anc - 1);
    if (anc_j[a] <= j) sel = a;  // ascending: the last one wins
  }
  float pos = 0.0f;
  if (sel >= 0) {
    const float srf = static_cast<float>(sr);
    const float s = anc_s[sel];
    const float dt = static_cast<float>(j - anc_j[sel]) / srf;
    const float x = s * dt * kLn2Over12;
    const float em1 = expm1f(x);
    const bool flat = fabsf(s) < 1e-9f;
    const float delta_p = flat ? dt : em1 / ((flat ? 1.0f : s) * kLn2Over12);
    pos = anc_src[sel] + anc_r[sel] * (delta_p * srf - em1);
  }
  pos = fmaxf(pos, 0.0f);
  const float fl = floorf(pos);
  const float frac = pos - fl;
  const long long i0 = static_cast<long long>(base[b]) +
                       static_cast<long long>(fl);
  const long long lo = min(max(i0, 0LL), n_src - 1);
  const long long hi = min(max(i0 + 1, 0LL), n_src - 1);
  out[jl] = (1.0f - frac) * y[lo] + frac * y[hi];
}

}  // namespace

extern "C" int mlx_resample_pv(const float* y, long long n_src,
                               const int* base, const int* a0,
                               const int* cnt, const int* anc_j,
                               const float* anc_src, const float* anc_r,
                               const float* anc_s, int n_anc, float* out,
                               long long n_out, int sr, cudaStream_t stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0 || n_anc <= 0 || n_out % kBlk != 0 || n_out > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  resample_pv_kernel<<<static_cast<unsigned>((n_out + threads - 1) / threads),
                       threads, 0, stream>>>(y, n_src, base, a0, cnt, anc_j,
                                             anc_src, anc_r, anc_s, n_anc,
                                             out, n_out, sr);
  return static_cast<int>(cudaGetLastError());
}
