// B10: windowed overlap-add synthesis from a (mag, psi) spectrum, the
// sequence-parallel phase vocoder's per-shard synthesis.
//
// Replaces melonix_tpu/kernels/pallas_pv.py:synth_ola (_syn_ola_kernel,
// _syn_body): sincos, the inverse four-step DFT keeping the real part, the
// window and a hop-aligned streaming overlap-add whose (size - hop)-row
// carry rode from one step of the TPU's sequential grid to the next, so the
// (F, size) frame matrix never reached HBM.
//
// Contract (natural bin order, the 1025-bin half spectrum, size 2048, any
// hop >= 1): y[j] = sum over frames m of win[j - m*hop] * irfft(mag[m] *
// e^{i psi[m]})[j - m*hop], j < (F - 1) * hop + 2048, unnormalised.  The
// TPU kernel's output was (F // 64 + 1) * 64 * hop long; only this span was
// exact, and it is the only span its caller read (sharded.py:737-738).
//
// Design: B3 without its phase scan, on B3's own launches (pv_synth.cuh):
//   1. synth_kernel<kSynthPolar>: one block per frame; a polar prologue
//      writes mag * e^{i psi} into the bit-reversed Hermitian buffer in
//      shared memory, then the inverse fft2048, 1/2048 and the window.
//   2. ola_kernel: the fixed-order overlap-add, no atomics.
// Blocks on this card run in no order, so the TPU's carried OLA becomes a
// second launch over an (F, 2048) frame matrix in device memory (scratch
// from the wrapper).  What bounds it: mag and psi are read once and y
// written once (~155 MB at the 180 s song's 15,104 frames, ~0.046 ms at
// 3.35 TB/s); the frame matrix's write and read (2 x 124 MB) are what this
// design adds over the bound.
#include "pv_synth.cuh"

extern "C" int mlx_pv_synth_ola(const float* mag, const float* psi,
                                const float* win, const float2* tw,
                                float* frames, float* y, int n_frames,
                                int hop, cudaStream_t stream) {
  if (n_frames <= 0 || hop <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  synth_kernel<kSynthPolar><<<n_frames, mlx::kFftThreads, 0, stream>>>(
      mag, psi, nullptr, win, tw, frames, n_frames);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ola(frames, y, n_frames, hop, stream));
}
