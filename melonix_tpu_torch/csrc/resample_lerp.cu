// B11: lerp at given block-relative positions with per-block int32 bases.
//
// Replaces melonix_tpu/kernels/pallas_resample.py:resample_lerp_pallas
// (_kernel, with lane_gather.realign / shift_one / lerp_rows), which
// DMA'd each 2048-sample output block's source slab of `rows` x 128
// samples from a zero-padded copy of the track into VMEM and lane-gathered
// the two taps within it.
//
// Contract (per output sample j < n_out, block b = j / 2048):
//   r = floor(pos[j]), frac = pos[j] - r,
//   rel = clip(int(r), 0, rows * 128 - 2)            (the slab's bound),
//   g[i] = y[base[b] + i], or 0 where base[b] + i >= n_src,
//   out[j] = (1 - frac) * g[rel] + frac * g[rel + 1],
// rounded as XLA's CPU compile of the TPU kernel rounds it (one fused
// multiply-add over frac * g[rel + 1]): the float32 (1 - frac) and
// frac * g[rel + 1], the first product exact in float64, one float64 sum,
// one rounding to float32.  Every step is spelled (__fsub_rn, __fmul_rn,
// __dmul_rn, __dadd_rn, __double2float_rn) as the plain twin's
// (kernels/resample.py:lerp) torch ops take them, so the two are equal bit
// for bit.
//
// Design: one thread per output sample; the two taps are neighbouring loads
// whose addresses rise with j (coalesced where the rate is near 1, and the
// block's slab stays in L1/L2).  Samples past the end read as 0 instead of
// a padded copy of the track per call.  Bounded by device memory: ~12
// bytes per output sample (position, output, taps).
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;

__global__ void resample_lerp_kernel(const float* __restrict__ y,
                                     long long n_src,
                                     const float* __restrict__ pos,
                                     const int* __restrict__ base,
                                     float* __restrict__ out, long long n_out,
                                     int rel_max) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= n_out) return;
  const float p = pos[j];
  const float fl = floorf(p);
  const float frac = __fsub_rn(p, fl);
  const int rel = static_cast<int>(
      fminf(fmaxf(fl, 0.0f), static_cast<float>(rel_max)));
  const long long i0 = static_cast<long long>(base[j / kBlk]) + rel;
  const float lo = i0 < n_src ? y[i0] : 0.0f;
  const float hi = i0 + 1 < n_src ? y[i0 + 1] : 0.0f;
  const double a = __dmul_rn(static_cast<double>(__fsub_rn(1.0f, frac)),
                             static_cast<double>(lo));
  out[j] = __double2float_rn(
      __dadd_rn(a, static_cast<double>(__fmul_rn(frac, hi))));
}

}  // namespace

extern "C" int mlx_resample_lerp(const float* y, long long n_src,
                                 const float* pos, const int* base,
                                 float* out, long long n_out, int rows,
                                 cudaStream_t stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0 || rows < 1 || n_out % kBlk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  resample_lerp_kernel<<<static_cast<unsigned>((n_out + threads - 1) /
                                               threads),
                         threads, 0, stream>>>(y, n_src, pos, base, out,
                                               n_out, rows * 128 - 2);
  return static_cast<int>(cudaGetLastError());
}
