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
// Design: B3 without its phase scan, on B3's own synthesis (pv_synth.cuh):
// the pair synthesis in its polar mode (kSynthPolar: mag * e^{i psi} staged
// once a bin, two frames a 2048-point inverse of fft_pair.cuh), then, by
// the hop (kpv.ola_route), the overlap-add carried in each CTA (fused, 256
// <= hop <= 2048: one launch, the frame matrix never in device memory) or
// the frame matrix (scratch from the wrapper) and ola_kernel.  Blocks on
// this card run in no order, so the TPU's carry from one grid step to the
// next becomes a carry along each CTA's own contiguous range of frames,
// which first recomputes the few frames before it that reach its first
// sample.  What bounds it: mag and psi are read once and y written once
// (~155 MB at the 180 s song's 15,104 frames, ~0.046 ms at 3.35 TB/s).
#include "pv_synth.cuh"

extern "C" int mlx_pv_synth_ola(const float* mag, const float* psi,
                                const float* win, const float2* tw,
                                float* frames, float* y, int n_frames,
                                int hop, int fused, cudaStream_t stream) {
  return static_cast<int>(launch_synth<kSynthPolar>(
      mag, psi, nullptr, win, tw, frames, y, n_frames, n_frames, hop, fused,
      stream));
}
