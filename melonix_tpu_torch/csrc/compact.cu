// B6: step-major render rows -> the flat track, the last step winning.
//
// Replaces melonix_tpu/kernels/pallas_render.py:compact_pallas
// (_compact_kernel), which DMA'd the few step rows overlapping each
// 2048-sample output block into VMEM, placed them with lane rolls and
// selected in ascending step order.
//
// Contract (output sample j < out_len, block b = j / 2048):
//   out[j] = vals[s, j - off[s]] for the LAST step s with
//   off[s] <= j < off[s] + szmax, and 0 where no step covers j -- the
//   ascending fori-loop of dynamic-update-slices of _compact, including
//   duplicate offsets and zero-length steps.  Offsets ascend, so the last
//   step with off[s] <= j is the only candidate: if it does not reach j,
//   no earlier step does.  a0[b] / cnt[b] (host compact_blocks) bound the
//   candidates of block b, at most a handful (kmax).
//
// Design: one thread per output sample scans its block's candidates from
// the last down and stops at the first with off[s] <= j; the candidate
// offsets are a few scalars every thread of the block reads (L1
// broadcast), and the value reads are coalesced runs of a row.  Pure data
// movement, bit-exact; bounded by HBM: one read and one write per sample
// (~32 MB each for a 180 s, 44.1 kHz track).
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;

__global__ void compact_kernel(const float* __restrict__ vals, int n_steps,
                               int szmax, const int* __restrict__ off,
                               const int* __restrict__ a0,
                               const int* __restrict__ cnt,
                               float* __restrict__ out, int out_len) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_len) return;
  const int b = j / kBlk;
  const int first = a0[b];
  float v = 0.0f;
  for (int k = cnt[b] - 1; k >= 0; --k) {
    const int s = min(first + k, n_steps - 1);
    const int o = off[s];
    if (o <= j) {
      if (j - o < szmax) {
        v = vals[static_cast<long long>(s) * szmax + (j - o)];
      }
      break;
    }
  }
  out[j] = v;
}

}  // namespace

extern "C" int mlx_compact(const float* vals, int n_steps, int szmax,
                           const int* off, const int* a0, const int* cnt,
                           float* out, int out_len, cudaStream_t stream) {
  if (n_steps <= 0 || szmax <= 0 || out_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  compact_kernel<<<static_cast<unsigned>((out_len + threads - 1) / threads),
                   threads, 0, stream>>>(vals, n_steps, szmax, off, a0, cnt,
                                         out, out_len);
  return static_cast<int>(cudaGetLastError());
}
