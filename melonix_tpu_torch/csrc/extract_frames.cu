// B9: frames of a track at arbitrary int32 starts, zeros past the end.
//
// Replaces melonix_tpu/kernels/pallas_frames.py:extract_frames_pallas
// (_kernel), which copied each frame's slab into VMEM with a
// double-buffered DMA from a zero-padded (rows, 128) copy of the track and
// realigned it with two lane rolls and a carry select.
//
// Contract: out[m, i] = wav[s + i] with s = clip(starts[m], 0, n - 1), and
// 0 where s + i >= n; (n_frames, size) float32.
//
// Design: one block per frame; its threads read the frame's samples in
// order (neighbouring threads, neighbouring addresses: coalesced, one
// extra transaction for an unaligned start) and write the row.  A sample
// past the end reads as 0, so no padded copy of the track is made.  A pure
// copy: bounded by device memory (4 bytes in and 4 out per sample, the
// overlap of neighbouring frames served from L2), bit-exact with its twin.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_frames_kernel(const float* __restrict__ wav, long long n,
                      const int* __restrict__ starts, float* __restrict__ out,
                      int size) {
  long long s = starts[blockIdx.x];
  s = s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
  float* row = out + static_cast<long long>(blockIdx.x) * size;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const long long idx = s + i;
    row[i] = idx < n ? wav[idx] : 0.0f;
  }
}

}  // namespace

extern "C" int mlx_extract_frames(const float* wav, long long n,
                                  const int* starts, float* out, int n_frames,
                                  int size, cudaStream_t stream) {
  if (n <= 0 || size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames > 0) {
    extract_frames_kernel<<<n_frames, kThreads, 0, stream>>>(wav, n, starts,
                                                             out, size);
  }
  return static_cast<int>(cudaGetLastError());
}
