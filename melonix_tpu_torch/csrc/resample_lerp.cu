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
// One entry, mlx_resample_lerp_window, computes exactly the samples
// [j0, j0 + n), one thread per sample, and stores them through a device
// address, optionally waiting for them in the same C call:
// - kres.resample_lerp: the whole of its output (j0 = 0) into device memory;
// - kres.LerpReader: one live read, exactly the delivered samples and
//   nothing else of their blocks, into page-locked host memory mapped into
//   the card's address space, waited for.  A read moves a few KB, so it is
//   bound by its launch and its wait, not by bytes: one C call does both,
//   with no allocation and no separate copy.
// Over a whole output the two taps are neighbouring loads whose addresses
// rise with j (coalesced where the rate is near 1, and the block's slab
// stays in L1/L2): bounded by device memory, ~12 bytes per output sample
// (position, output, taps).
//
// mlx_host_device_pointer gives the device address of such host memory,
// and fails where the memory is not mapped.
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;
constexpr int kThreads = 256;

__device__ __forceinline__ float lerp_at(const float* __restrict__ y,
                                         long long n_src,
                                         const float* __restrict__ pos,
                                         const int* __restrict__ base,
                                         long long j, int rel_max) {
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
  return __double2float_rn(
      __dadd_rn(a, static_cast<double>(__fmul_rn(frac, hi))));
}

// out[k] = sample j0 + k, k < n: positions and bases are the stream's whole
// arrays, indexed by the absolute output sample.
__global__ void resample_lerp_window_kernel(const float* __restrict__ y,
                                            long long n_src,
                                            const float* __restrict__ pos,
                                            const int* __restrict__ base,
                                            long long j0, int n,
                                            int rel_max,
                                            float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  out[k] = lerp_at(y, n_src, pos, base, j0 + k, rel_max);
}

}  // namespace

// `out` is a device address (of device memory, or of mapped host memory
// for the live read); `wait` != 0 returns only once the samples are there.
extern "C" int mlx_resample_lerp_window(const float* y, long long n_src,
                                        const float* pos, const int* base,
                                        long long j0, int n, int rows,
                                        float* out, int wait,
                                        cudaStream_t stream) {
  if (n_src <= 0 || rows < 1 || j0 < 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  resample_lerp_window_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                      kThreads),
                                kThreads, 0, stream>>>(
      y, n_src, pos, base, j0, n, rows * 128 - 2, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !wait) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(stream));
}

extern "C" int mlx_host_device_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}
