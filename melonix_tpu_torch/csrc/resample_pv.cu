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
// melonix_tpu/engine/phase_vocoder.py:_lerp_resample_rel_xla.  The host's
// bases (kres.block_bases) lie in [0, n_src), positions are >= 0 and floor
// (pos) is clamped to n_src before the sum, and the entry takes n_src <
// 2^31, so the index arithmetic fits 32 unsigned bits.
//
// Bound: device memory, ~8 bytes moved per output sample (the stretched
// track read about once, the output written once); the anchors are a few
// bytes a block.  What keeps a simple kernel from it is latency: each
// output waits on a chain of dependent loads (its block's a0 and cnt, then
// the anchors, then the taps) before it can store.
//
// Design: one 256-thread CTA per 2048-sample output block.  Warp 0 stages
// the block's anchors (anc_j, anc_src, anc_r, anc_s; a handful, in tiles of
// kAncTile) into shared memory once for the CTA, so the anchor choice is a
// scan of shared memory; each thread keeps only the chosen anchor's index
// for each of its outputs.  Each thread takes 8 outputs, j = b * 2048 + t +
// 256 i, so every warp's loads and stores stay coalesced, and works them in
// two groups of 4: 4 positions, then their 4 tap pairs in flight together.
// __launch_bounds__(256, 8) holds a thread to 32 registers (32-bit unsigned
// indices keep it there without spills), so 8 CTAs share an SM and hide each
// other's latency chains (a0/cnt, then the anchors, then the taps).
// expm1f is CUDA's (max 1 ulp) and the
// divisions are IEEE; the plain twin keeps the TPU's Horner
// expm1_precise, and the smoke run compares the two.
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;
constexpr int kThreads = 256;
constexpr int kPer = kBlk / kThreads;  // outputs a thread
constexpr int kGroup = 4;              // outputs whose taps load together
constexpr int kAncTile = 128;          // anchors staged a pass
constexpr float kLn2Over12 = 0.057762265046662105f;  // ln(2) / 12

__global__ void __launch_bounds__(kThreads, 8) resample_pv_kernel(
    const float* __restrict__ y, unsigned n_src, const int* __restrict__ base,
    const int* __restrict__ a0, const int* __restrict__ cnt,
    const int* __restrict__ anc_j, const float* __restrict__ anc_src,
    const float* __restrict__ anc_r, const float* __restrict__ anc_s,
    int n_anc, float* __restrict__ out, int sr) {
  __shared__ int s_j[kAncTile];
  __shared__ float s_src[kAncTile], s_r[kAncTile], s_s[kAncTile];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int first = a0[b];  // one address for the whole CTA: a broadcast
  const int count = cnt[b];
  const int j_first = b * kBlk + t;

  // For each output, the chosen anchor's offset from `first` (-1: none).
  int sel[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) sel[i] = -1;
  for (int k0 = 0; k0 < count; k0 += kAncTile) {
    const int n_tile = min(count - k0, kAncTile);
    if (k0 > 0) __syncthreads();  // the previous tile is read
    if (t < 32) {
      for (int k = t; k < n_tile; k += 32) {
        const int a = min(first + k0 + k, n_anc - 1);
        s_j[k] = anc_j[a];
        s_src[k] = anc_src[a];
        s_r[k] = anc_r[a];
        s_s[k] = anc_s[a];
      }
    }
    __syncthreads();
    for (int k = 0; k < n_tile; ++k) {  // ascending: the last one wins
      const int jk = s_j[k];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (jk <= j_first + kThreads * i) sel[i] = k0 + k;
      }
    }
  }
  // The chosen constants: shared memory holds them when the block's
  // anchors fit one tile (always, in practice), else global memory does.
  const bool one_tile = count <= kAncTile;
  const unsigned blk_base = static_cast<unsigned>(base[b]);
  const float fl_max = static_cast<float>(n_src);
  const float srf = static_cast<float>(sr);
#pragma unroll
  for (int g = 0; g < kPer; g += kGroup) {
    float frac[kGroup];
    unsigned lo[kGroup], hi[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int i = g + q;
      const int j = j_first + kThreads * i;
      float pos = 0.0f;
      if (sel[i] >= 0) {
        int j0;
        float s, src0, r;
        if (one_tile) {
          const int k = sel[i];
          j0 = s_j[k];
          s = s_s[k];
          src0 = s_src[k];
          r = s_r[k];
        } else {
          const int a = min(first + sel[i], n_anc - 1);
          j0 = anc_j[a];
          s = anc_s[a];
          src0 = anc_src[a];
          r = anc_r[a];
        }
        const float dt = static_cast<float>(j - j0) / srf;
        const float x = s * dt * kLn2Over12;
        const float em1 = expm1f(x);
        const bool flat = fabsf(s) < 1e-9f;
        const float delta_p =
            flat ? dt : em1 / ((flat ? 1.0f : s) * kLn2Over12);
        pos = src0 + r * (delta_p * srf - em1);
      }
      pos = fmaxf(pos, 0.0f);
      const float fl = floorf(pos);
      frac[q] = pos - fl;
      // base < n_src < 2^31 and 0 <= fl <= n_src (as a float: <= 2^31)
      // keep i0 + 1 < 2^32.
      const unsigned i0 = blk_base + static_cast<unsigned>(fminf(fl, fl_max));
      lo[q] = min(i0, n_src - 1);
      hi[q] = min(i0 + 1, n_src - 1);
    }
    float y_lo[kGroup], y_hi[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {  // the group's tap pairs together
      y_lo[q] = y[lo[q]];
      y_hi[q] = y[hi[q]];
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      out[j_first + kThreads * (g + q)] =
          (1.0f - frac[q]) * y_lo[q] + frac[q] * y_hi[q];
    }
  }
}

}  // namespace

extern "C" int mlx_resample_pv(const float* y, long long n_src,
                               const int* base, const int* a0,
                               const int* cnt, const int* anc_j,
                               const float* anc_src, const float* anc_r,
                               const float* anc_s, int n_anc, float* out,
                               long long n_out, int sr, cudaStream_t stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  if (n_src <= 0 || n_src >= (1LL << 31) || n_anc <= 0 || n_out % kBlk != 0 ||
      n_out > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  resample_pv_kernel<<<static_cast<unsigned>(n_out / kBlk), kThreads, 0,
                       stream>>>(y, static_cast<unsigned>(n_src), base, a0, cnt,
                                 anc_j, anc_src, anc_r, anc_s, n_anc, out,
                                 sr);
  return static_cast<int>(cudaGetLastError());
}
