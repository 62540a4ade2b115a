// B5: the granular render's per-step grain resample, step-major.
//
// Replaces melonix_tpu/kernels/pallas_render.py:_render_steps (_kernel),
// which DMA'd each step's grain into a VMEM slab, realigned it with lane
// rolls and lerped through 33 row-masked lane gathers (lane_gather.py).
//
// Contract (step s < n_steps, column i < szmax):
//   x = f32(i) * rate[s];  idx = floor(x);  frac = x - idx;
//   lo = wav[gs[s] + idx], hi = wav[gs[s] + idx + 1]  (0 at or past n);
//   out[s, i] = (1 - frac) * lo + frac * hi  for i < sz[s], else 0.
// Bit-exact against tests/oracle.py: every product, difference and sum is
// rounded on its own (__fmul_rn / __fsub_rn / __fadd_rn), in the oracle's
// order, so nvcc cannot contract the lerp into an FMA.
//
// Design: one block per step, its threads striding over the row: the
// writes are coalesced, and the grain (a few KB, rate ~1) is read through
// L1/L2 by neighbouring threads at neighbouring addresses.  Bounded by the
// writes: S * szmax * 4 bytes (85 MB for a 180 s, 44.1 kHz track at
// szmax 4096), against ~1/3 of that read.
#include <cuda_runtime.h>

namespace {

__global__ void render_steps_kernel(const float* __restrict__ wav,
                                    long long n, const int* __restrict__ gs,
                                    const float* __restrict__ rate,
                                    const int* __restrict__ sz, int szmax,
                                    float* __restrict__ out) {
  const int s = blockIdx.x;
  const long long g0 = gs[s];
  const float r = rate[s];
  const int len = sz[s];
  float* row = out + static_cast<long long>(s) * szmax;
  for (int i = threadIdx.x; i < szmax; i += blockDim.x) {
    float v = 0.0f;
    if (i < len) {
      const float x = __fmul_rn(static_cast<float>(i), r);
      const float fl = floorf(x);
      const float frac = __fsub_rn(x, fl);
      const long long src = g0 + static_cast<long long>(fl);
      const float lo = (src >= 0 && src < n) ? wav[src] : 0.0f;
      const float hi = (src + 1 >= 0 && src + 1 < n) ? wav[src + 1] : 0.0f;
      v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac), lo),
                    __fmul_rn(frac, hi));
    }
    row[i] = v;
  }
}

}  // namespace

extern "C" int mlx_render_steps(const float* wav, long long n, const int* gs,
                                const float* rate, const int* sz, int n_steps,
                                int szmax, float* out, cudaStream_t stream) {
  if (n_steps <= 0 || szmax <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  render_steps_kernel<<<static_cast<unsigned>(n_steps), threads, 0, stream>>>(
      wav, n, gs, rate, sz, szmax, out);
  return static_cast<int>(cudaGetLastError());
}
