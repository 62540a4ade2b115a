// B5 + B6: the granular render of a plan, indexed by output sample.
//
// Replaces melonix_tpu/kernels/pallas_render.py:_render_steps (_kernel),
// which DMA'd each plan step's grain into a VMEM slab, realigned it with
// lane rolls and lerped through row-masked lane gathers into a step-major
// (S, szmax) array, and compact_pallas (_compact_kernel), which DMA'd the
// few rows overlapping each 2048-sample output block back into VMEM and
// placed them, the last step winning.  Here one pass computes each output
// sample straight from the track: the step-major array (85 MB for a 180 s,
// 44.1 kHz track at szmax 4096) is never written or read.
//
// Contract (output sample j < out_len, block b = j / 2048):
//   s = the LAST candidate min(a0[b] + k, n_steps - 1), k < cnt[b], with
//       off[s] <= j (none: out[j] = 0);  rel = j - off[s];
//   out[j] = 0 unless rel < min(sz[s], szmax), else
//   x = f32(rel) * rate[s];  fl = floor(x);  frac = x - fl;
//   lo = wav[gs[s] + fl], hi = wav[gs[s] + fl + 1]  (0 outside [0, n));
//   out[j] = (1 - frac) * lo + frac * hi.
// That is compact(render_steps(...)) exactly, with duplicate offsets,
// zero-length steps and steps parked at or past out_len: offsets ascend,
// so the last step starting at or before j is the only one that can cover
// j, and past its length j reads its zero tail, never an earlier step
// (the reference overwrites each step's tail with its successor's).
// a0[b] / cnt[b] (host compact_blocks) bound block b's candidates.
// Bit-exact against tests/oracle.py: every product, difference and sum of
// the lerp is rounded on its own (__fmul_rn / __fsub_rn / __fadd_rn), in
// the oracle's order, so nvcc cannot contract it into an FMA.
//
// Bound: device memory, ~8 bytes per output sample (the taps of the grains
// read about once at rate ~1, the track written once) plus a few bytes of
// plan a step.  What keeps a simple kernel from it is latency: each output
// waits on a chain of dependent loads (its block's a0 and cnt, the
// candidates' plan, then the taps) before it can store.
//
// Design (B4's, csrc/resample_pv.cu): one 256-thread CTA per 2048-sample
// output block.  Warp 0 stages the block's candidate steps (off, gs, rate
// and min(sz, szmax); a few, in tiles of kTile where zero-length steps,
// duplicate offsets and steep bends stack them) into shared memory, so
// the step choice is a scan of shared memory and each thread keeps only
// the chosen candidate's index for each of its outputs.  Each thread takes
// 8 outputs, j = b * 2048 + t + 256 i: the stores coalesce, and
// neighbouring threads read neighbouring taps of one grain.  It works them
// in two groups of 4: 4 tap addresses, then their 4 tap pairs in flight
// together.  Output indices, block offsets and lengths are 32-bit
// (out_len < 2^31); the tap index is 64-bit because the track length is.
// __launch_bounds__(256, 8) lets 8 CTAs share an SM and hide each other's
// load chains.
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 2048;
constexpr int kThreads = 256;
constexpr int kPer = kBlk / kThreads;  // outputs a thread
constexpr int kGroup = 4;              // outputs whose taps load together
constexpr int kTile = 128;             // candidate steps staged a pass

__global__ void __launch_bounds__(kThreads, 8) render_granular_kernel(
    const float* __restrict__ wav, long long n, const int* __restrict__ gs,
    const float* __restrict__ rate, const int* __restrict__ sz,
    const int* __restrict__ off, int n_steps, const int* __restrict__ a0,
    const int* __restrict__ cnt, int szmax, float* __restrict__ out,
    int out_len) {
  __shared__ int s_off[kTile], s_gs[kTile], s_len[kTile];
  __shared__ float s_rate[kTile];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int first = a0[b];  // one address for the whole CTA: a broadcast
  const int count = cnt[b];
  // b * 2048 + 2047 < out_len + 2047 < 2^32
  const unsigned j_first = static_cast<unsigned>(b) * kBlk + t;
  const unsigned j_last = static_cast<unsigned>(out_len - 1);
  // output i's sample, clamped into the track for the choice (outputs past
  // out_len are not stored)
  auto jc = [&](int i) {
    return static_cast<int>(min(j_first + kThreads * i, j_last));
  };

  // For each output, the chosen candidate's offset from `first` (-1: none).
  int sel[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) sel[i] = -1;
  for (int k0 = 0; k0 < count; k0 += kTile) {
    const int n_tile = min(count - k0, kTile);
    if (k0 > 0) __syncthreads();  // the previous tile is read
    if (t < 32) {
      for (int k = t; k < n_tile; k += 32) {
        const int s = static_cast<int>(
            min(static_cast<long long>(first) + k0 + k,
                static_cast<long long>(n_steps - 1)));
        s_off[k] = off[s];
        s_gs[k] = gs[s];
        s_rate[k] = rate[s];
        s_len[k] = min(sz[s], szmax);
      }
    }
    __syncthreads();
    for (int k = 0; k < n_tile; ++k) {  // ascending: the last one wins
      const int o = s_off[k];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (o <= jc(i)) sel[i] = k0 + k;
      }
    }
  }
  // The chosen steps' plan: shared memory holds it when the block's
  // candidates fit one tile (always, in practice), else global memory does.
  const bool one_tile = count <= kTile;
#pragma unroll
  for (int g = 0; g < kPer; g += kGroup) {
    float frac[kGroup];
    long long src[kGroup];
    bool live[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int i = g + q;
      frac[q] = 0.0f;
      src[q] = 0;
      live[q] = false;
      if (sel[i] >= 0) {
        int o, g0, len;
        float r;
        if (one_tile) {
          const int k = sel[i];
          o = s_off[k];
          g0 = s_gs[k];
          r = s_rate[k];
          len = s_len[k];
        } else {
          const int s = static_cast<int>(
              min(static_cast<long long>(first) + sel[i],
                  static_cast<long long>(n_steps - 1)));
          o = off[s];
          g0 = gs[s];
          r = rate[s];
          len = min(sz[s], szmax);
        }
        // o <= jc(i), so the difference is in [0, 2^32)
        const unsigned rel =
            static_cast<unsigned>(jc(i)) - static_cast<unsigned>(o);
        if (len > 0 && rel < static_cast<unsigned>(len)) {
          const float x = __fmul_rn(static_cast<float>(static_cast<int>(rel)),
                                    r);
          const float fl = floorf(x);
          frac[q] = __fsub_rn(x, fl);
          src[q] = static_cast<long long>(g0) + static_cast<long long>(fl);
          live[q] = true;
        }
      }
    }
    float lo[kGroup], hi[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {  // the group's tap pairs together
      const long long p = src[q];
      lo[q] = (live[q] && p >= 0 && p < n) ? wav[p] : 0.0f;
      hi[q] = (live[q] && p + 1 >= 0 && p + 1 < n) ? wav[p + 1] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const unsigned j = j_first + kThreads * (g + q);
      if (j <= j_last) {
        out[j] = live[q] ? __fadd_rn(__fmul_rn(__fsub_rn(1.0f, frac[q]), lo[q]),
                                     __fmul_rn(frac[q], hi[q]))
                         : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" int mlx_render_granular(const float* wav, long long n,
                                   const int* gs, const float* rate,
                                   const int* sz, const int* off, int n_steps,
                                   const int* a0, const int* cnt, int szmax,
                                   float* out, int out_len,
                                   cudaStream_t stream) {
  if (n <= 0 || n_steps <= 0 || szmax <= 0 || out_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned n_blocks =
      (static_cast<unsigned>(out_len) + kBlk - 1) / kBlk;
  render_granular_kernel<<<n_blocks, kThreads, 0, stream>>>(
      wav, n, gs, rate, sz, off, n_steps, a0, cnt, szmax, out, out_len);
  return static_cast<int>(cudaGetLastError());
}
