// B12: |STFT| * scale of windowed frames at a uniform hop, for the sizes B1
// (stft_mag.cu, 2048 points only) does not take.
//
// Replaces melonix_tpu/kernels/pallas_stft.py:stft_mag_pallas (_kernel),
// the TPU's slab DMA + row-rolled frame views + dense cos/sin DFT-matrix
// contraction on the MXU.
//
// Contract: frame f covers wav[f*hop, f*hop + N), zeros past n; out is
// (n_frames, N/2) float32, bins in natural order,
// out[f, k] = |sum_i win[i] x_f[i] e^{-2 pi i k i / N}| * scale.
//
// Six routes, picked by N alone (kernels/stft.py route):
//
// * N = 512 ... 8192, a power of two: mlx_stft_mag_pair, B1's kernel
//   (stft_mag_pair.cuh) at N: two frames per complex transform on the
//   register-resident fft_pair.cuh, a persistent grid, |X| in the pair
//   split's epilogue.  At 4096/1024 on a 180 s track the frames read 32 MB
//   and write 64 MB: device memory bounds it (~28 us at 3.35 TB/s), not the
//   ~0.15 MFLOP per frame.
//
// * N = 16,384, 32,768 and 65,536: mlx_stft_mag_large, one real frame per
//   transform on fft_large.cuh (fft_pair.cuh's 8192 instance, Large<16384>
//   in one CTA, or a 2-CTA cluster at 65,536), held in shared memory; the
//   window and zero fill as pass 1 reads the frame (frames overlap, so L2
//   serves most reads), |X| * scale in the real split.
//
// * Any other N up to 49,152 points (N = B m, m odd, 3 <= m <= 95):
//   mlx_stft_mag_sizes, the frame tile of fft_fourstep.cuh
//   (stft_mag_tile_kernel): a CTA takes T whole frames (T = 4 at 1536, 1
//   at 24,576: kstft.frame_tile), its lanes reading each frame's samples
//   consecutively and windowing them into the frame's m packed
//   sub-sequences in shared memory; then the four-step column tiles' body
//   (the batched radix-16 Stockham, the split with W_N^(s k), the paired
//   m-point sums) and |X| * scale stored for the bins below N/2.  Shared
//   memory is about 4 T N bytes (196,680 at 49,152).
//
// * Other sizes above 49,152 points: mlx_stft_mag_4step, the four-step
//   route of fft_fourstep.cuh in coalesced tiles: stft_four_step_cols (a
//   CTA a frame and T consecutive n1: the windowed columns' real N2-point
//   transforms, into a scratch buffer), then stft_four_step_rows (a CTA a
//   frame and K consecutive k2: twiddles, the complex N1-point transforms,
//   |X| * scale for the bins below N/2).
//
// * Where N's odd factor is above 12,288 the four-step columns are
//   Bluestein convolutions: up to N2 = 32,768 mlx_stft_mag_bluestein on
//   clusters (stft_four_step_cols_bluestein: two columns a cluster, two
//   32,768-point transforms on 2 CTAs up to N2 = 16,384, two 65,536-point
//   transforms on 4 above);
//
// * above N2 = 32,768 mlx_stft_mag_bluestein_scratch through device
//   scratch (L = 131,072 ... 8,388,608 points a column pair: forward,
//   middle, inverse and split kernels, the pairs in chunks through one
//   work space of at most 512 MiB).  Both Bluestein routes end in
//   stft_four_step_rows.
#include <algorithm>

#include "fft_fourstep.cuh"
#include "fft_large.cuh"
#include "stft_mag_pair.cuh"

namespace {

// The frame tile (mlx::frame_tile) at the sizes up to mlx::kMaxColumn that
// are no power of two: CTA blockIdx.x takes frames T blockIdx.x ... T
// blockIdx.x + T - 1 below n_frames; `tab` is
// kstft.four_step_column_table(N); (kT, kPts) as mlx::frame_config gives
// them.
template <int kT, int kPts>
__global__ void __launch_bounds__(kT, kT == 512 ? (kPts == 16 ? 2 : 1)
                                            : kPts == 16 ? 4 : 2)
stft_mag_tile_kernel(const float* __restrict__ wav, long long n,
                     const float* __restrict__ win,
                     const float2* __restrict__ tab, mlx::ColTile ft,
                     int n_frames, int hop, float* __restrict__ out,
                     float scale) {
  extern __shared__ float2 s[];
  const int f0 = blockIdx.x * ft.t, half = ft.b * ft.m / 2;
  mlx::frame_tile<kT, kPts>(
      s, ft, tab, min(ft.t, n_frames - f0),
      [&](int j) {
        const long long start = static_cast<long long>(f0 + j) * hop;
        return [=](int i) {
          const long long idx = start + i;
          return (idx < n ? __ldg(wav + idx) : 0.0f) * __ldg(win + i);
        };
      },
      [&](int j, int k, float2 v) {
        out[static_cast<long long>(f0 + j) * half + k] =
            sqrtf(v.x * v.x + v.y * v.y) * scale;
      });
}

// The on-chip route (fft_large.cuh) at N = 16,384, 32,768 or 65,536: one
// CTA, or one 2-CTA cluster at 65,536, per frame; tw is
// kstft.large_twiddles(N).
template <int N>
__global__ void __launch_bounds__(mlx::large::RealPlan<N>::kThreads, 1)
stft_mag_large_kernel(const float* __restrict__ wav, long long n,
                      const float* __restrict__ win,
                      const float2* __restrict__ tw, float* __restrict__ out,
                      int hop, float scale) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x / mlx::large::RealPlan<N>::kCluster;
  const long long start = static_cast<long long>(f) * hop;
  float* row = out + static_cast<long long>(f) * (N / 2);
  mlx::large::real_fft<N>(
      wav, n, start, [&](int i) { return __ldg(win + i); },
      [&](int k, float2 v) { row[k] = sqrtf(v.x * v.x + v.y * v.y) * scale; },
      s, tw);
}

// Four-step route, step 1 in tiles: CTA blockIdx.x = frame * tiles + tile,
// columns tile * T .. tile * T + T - 1 (mlx::four_step_columns); `tab` is
// kstft.four_step_column_table(N2); (kT, kPts) = mlx::tiles::config(P).
template <int kT, int kPts>
__global__ void __launch_bounds__(kT, kT == 512 ? 1 : kPts == 16 ? 4 : 2)
stft_four_step_cols(const float* __restrict__ wav, long long n,
                    const float* __restrict__ win,
                    const float2* __restrict__ tab, mlx::FourStep f,
                    mlx::ColTile ct, int tiles, int hop,
                    float2* __restrict__ scratch) {
  extern __shared__ float2 s[];
  const int frame = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const long long start = static_cast<long long>(frame) * hop;
  mlx::four_step_columns<kT, kPts>(
      s, f, ct, tab, tile * ct.t,
      [&](int i) {
        const long long idx = start + i;
        return (idx < n ? __ldg(wav + idx) : 0.0f) * __ldg(win + i);
      },
      scratch + frame * mlx::four_step_scratch(f));
}

// Four-step route, step 1 by Bluestein (N2 <= mlx::kBluesteinMax): grid
// (N1 * C / 2, frames) in clusters of C CTAs along x (C =
// mlx::bluestein_cluster(N2)), columns 2p and 2p + 1 on cluster p; `tab` is
// kstft.bluestein_table(N2).
template <int C>
__global__ void __launch_bounds__(mlx::large::Large<16384>::kThreads, 1)
stft_four_step_cols_bluestein(const float* __restrict__ wav, long long n,
                              const float* __restrict__ win,
                              const float2* __restrict__ tab,
                              mlx::FourStep f, int hop,
                              float2* __restrict__ scratch) {
  extern __shared__ float2 s[];
  const long long start = static_cast<long long>(blockIdx.y) * hop;
  const int n1a = static_cast<int>(blockIdx.x / C) * 2;
  auto x = [&](int i) {
    const long long idx = start + i;
    return (idx < n ? wav[idx] : 0.0f) * win[i];
  };
  mlx::four_step_column_bluestein<C>(
      s, f, tab, n1a,
      [&](int q) {
        const int i = n1a + f.n1 * q;
        return make_float2(x(i), x(i + 1));
      },
      scratch + blockIdx.y * mlx::four_step_scratch(f));
}

// Bluestein through scratch (N2 > mlx::kBluesteinMax), the pairs item0 +
// blockIdx.y of a chunk: item = frame * N1 / 2 + pair, columns 2 pair and
// 2 pair + 1; work space `work` + blockIdx.y * L.  `tab` is
// kstft.bluestein_scratch_table(N2) (mlx::ScratchPlan).

// CTA (r, item): w[r][k] = W_L^(r k) Y_r[k], Y_r the 16,384-point DFT of
// the chirped pair a[C m + r].
__global__ void __launch_bounds__(mlx::large::Large<16384>::kThreads, 1)
stft_bluestein_forward(const float* __restrict__ wav, long long n,
                       const float* __restrict__ win,
                       const float2* __restrict__ tab, mlx::FourStep f,
                       mlx::ScratchPlan sp, int hop, long long item0,
                       float2* __restrict__ work) {
  extern __shared__ float2 s[];
  constexpr int M = mlx::kBluesteinM;
  const int r = blockIdx.x;
  const long long item = item0 + blockIdx.y;
  const long long start = item / (f.n1 / 2) * hop;
  const int n1a = static_cast<int>(item % (f.n1 / 2)) * 2;
  auto x = [&](long long i) {
    const long long idx = start + i;
    return (idx < n ? __ldg(wav + idx) : 0.0f) * __ldg(win + i);
  };
  auto pair = [&](int q) {
    const long long i = n1a + static_cast<long long>(f.n1) * q;
    return make_float2(x(i), x(i + 1));
  };
  const float2* chirp = tab + static_cast<long long>(r) * M;  // [r][m]
  mlx::large::fft<M>(
      [&](int m) {
        const int nn = sp.c * m + r;
        return nn < f.n2 ? mlx::pairfft::ctw(pair(nn), __ldg(chirp + m), -1.0f)
                         : make_float2(0.0f, 0.0f);
      },
      [] {}, s, tab + sp.pass, -1.0f);
  float2* w = work + blockIdx.y * static_cast<long long>(sp.l) +
              static_cast<long long>(r) * M;
#pragma unroll 8
  for (int k = threadIdx.x; k < M; k += mlx::large::Large<M>::kThreads) {
    w[k] = mlx::pairfft::ctw(s[k], mlx::scratch_twiddle(tab, sp, r, k),
                             -1.0f);
  }
}

// Thread (k, item), C <= 16: across r in registers, both directions, in
// place.
template <int C>
__global__ void __launch_bounds__(256)
stft_bluestein_middle_regs(const float2* __restrict__ tab,
                           mlx::ScratchPlan sp, float2* __restrict__ work) {
  constexpr int M = mlx::kBluesteinM, lc = mlx::pairfft::ilog2(C);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  float2* w = work + blockIdx.y * static_cast<long long>(sp.l) + k;
  float2 v[C];
#pragma unroll
  for (int r = 0; r < C; ++r) v[r] = w[r * M];
  mlx::pairfft::dft_regs<C>(v, -1.0f);  // X[k + q M] in v[brev(q)]
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int b = mlx::pairfft::brev(q, lc);
    v[b] = mlx::pairfft::ctw(v[b], __ldg(tab + sp.spec + k + q * M), 1.0f);
  }
  float2 u[C];
#pragma unroll
  for (int q = 0; q < C; ++q) u[q] = v[mlx::pairfft::brev(q, lc)];
  mlx::pairfft::dft_regs<C>(u, 1.0f);
#pragma unroll
  for (int q = 0; q < C; ++q) {
    w[q * M] = mlx::pairfft::ctw(u[mlx::pairfft::brev(q, lc)],
                                 mlx::scratch_twiddle(tab, sp, q, k), 1.0f);
  }
}

// CTA (tile of mid_tile(C) k's, item), C > 16: across r, both directions,
// in place.
__global__ void __launch_bounds__(mlx::kMidThreads, 2)
stft_bluestein_middle(const float2* __restrict__ tab, mlx::ScratchPlan sp,
                      float2* __restrict__ work) {
  extern __shared__ float2 s[];
  constexpr int M = mlx::kBluesteinM, kT = mlx::kMidThreads;
  const int C = sp.c, KT = mlx::mid_tile(C), S = C + 1;
  const int lg = mlx::ilog2_floor(KT), k0 = blockIdx.x * KT;
  float2* w = work + blockIdx.y * static_cast<long long>(sp.l) + k0;
  auto at = [&](int idx) {  // [r][k] in the work space, tile-relative
    return static_cast<long long>(idx >> lg) * M + (idx & (KT - 1));
  };
  mlx::tiles::staged<kT, float2>(
      C * KT, [&](int idx) { return w[at(idx)]; },
      [&](int idx, float2 v) { s[(idx & (KT - 1)) * S + (idx >> lg)] = v; });
  __syncthreads();
  mlx::tiles::batch_fft<kT, 16>(s, KT, S, C, tab + sp.wc, -1.0f);
  mlx::tiles::staged<kT, float2>(
      C * KT, [&](int idx) { return __ldg(tab + sp.spec + k0 + at(idx)); },
      [&](int idx, float2 v) {
        float2* x = s + (idx & (KT - 1)) * S + (idx >> lg);
        *x = mlx::pairfft::ctw(*x, v, 1.0f);
      });
  __syncthreads();
  mlx::tiles::batch_fft<kT, 16>(s, KT, S, C, tab + sp.wc, 1.0f);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < C * KT; idx += kT) {
    const int q = idx >> lg, kk = idx & (KT - 1);
    w[static_cast<long long>(q) * M + kk] = mlx::pairfft::ctw(
        s[kk * S + q], mlx::scratch_twiddle(tab, sp, q, k0 + kk), 1.0f);
  }
}

// CTA (q', item): w[q'][m] = Z[C m + q'] = conj(b) conv[C m + q'] where C m
// + q' < N2, conv[C m + q'] the inverse 16,384-point DFT of w[q'][.].
__global__ void __launch_bounds__(mlx::large::Large<16384>::kThreads, 1)
stft_bluestein_inverse(const float2* __restrict__ tab, mlx::ScratchPlan sp,
                       float2* __restrict__ work) {
  extern __shared__ float2 s[];
  constexpr int M = mlx::kBluesteinM;
  const int q = blockIdx.x;
  float2* w = work + blockIdx.y * static_cast<long long>(sp.l) +
              static_cast<long long>(q) * M;
  mlx::large::fft<M>([&](int m) { return w[m]; }, [] {}, s, tab + sp.pass,
                     1.0f);
#pragma unroll 8
  for (int m = threadIdx.x; m < M; m += mlx::large::Large<M>::kThreads) {
    if (sp.c * m + q < sp.n2) {
      w[m] = mlx::pairfft::ctw(
          s[m], __ldg(tab + static_cast<long long>(q) * M + m), -1.0f);
    }
  }
}

// CTA (bins k0 .. k0 + 63, items it0 .. it0 + 15 of the chunk): the two
// columns of rows k <= N2 / 2, read along k, stored with the items fastest.
__global__ void __launch_bounds__(256)
stft_bluestein_split(mlx::FourStep f, mlx::ScratchPlan sp, long long item0,
                     int nit, const float2* __restrict__ work,
                     float2* __restrict__ scratch) {
  constexpr int KB = mlx::kSplitBins, KI = mlx::kSplitItems;
  __shared__ float4 tile[KB][KI + 1];
  const int k0 = blockIdx.x * KB, it0 = blockIdx.y * KI, half = f.n2 / 2;
  for (int idx = threadIdx.x; idx < KB * KI; idx += blockDim.x) {
    const int kk = idx % KB, pp = idx / KB, k = k0 + kk;
    if (k <= half && it0 + pp < nit) {
      const float2* w = work + (it0 + pp) * static_cast<long long>(sp.l);
      auto z = [&](int x) {
        return __ldg(w + static_cast<long long>(x & (sp.c - 1)) *
                             mlx::kBluesteinM + (x >> sp.log_c));
      };
      const float2 zk = z(k), zm = z(k == 0 ? 0 : f.n2 - k);
      tile[kk][pp] = make_float4(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y),
                                 0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < KB * KI; idx += blockDim.x) {
    const int pp = idx % KI, kk = idx / KI, k = k0 + kk;
    if (k <= half && it0 + pp < nit) {
      const long long item = item0 + it0 + pp;
      const int frame = static_cast<int>(item / (f.n1 / 2));
      const int n1a = static_cast<int>(item % (f.n1 / 2)) * 2;
      *reinterpret_cast<float4*>(scratch + frame * mlx::four_step_scratch(f) +
                                 static_cast<long long>(k) * f.n1 + n1a) =
          tile[kk][pp];
    }
  }
}

// Four-step route, steps 2-3: CTA blockIdx.x = frame * tiles + tile, rows
// tile * K .. tile * K + K - 1 (mlx::four_step_rows); `tw` is
// kstft.four_step_twiddles(N, N1); (kT, kPts) = mlx::tiles::config(N1).
template <int kT, int kPts>
__global__ void __launch_bounds__(kT, kT == 512 ? 1 : kPts == 16 ? 4 : 2)
stft_four_step_rows(const float2* __restrict__ tw, mlx::FourStep f,
                    mlx::RowTile rt, int tiles,
                    const float2* __restrict__ scratch,
                    float* __restrict__ out, float scale) {
  extern __shared__ float2 s[];
  const int frame = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  float* row = out + static_cast<long long>(frame) * (f.n / 2);
  mlx::four_step_rows<kT, kPts>(s, f, rt, tw, tile * rt.k,
                          scratch + frame * mlx::four_step_scratch(f),
                          [&](int k, float2 v) {
                            row[k] = sqrtf(v.x * v.x + v.y * v.y) * scale;
                          });
}

// The rows of every four-step form, over n_frames frames.
cudaError_t launch_rows(const float2* tw, const mlx::FourStep& f,
                        const float2* scratch, float* out, int n_frames,
                        float scale, cudaStream_t stream) {
  const mlx::RowTile rt = mlx::make_row_tile(f.n1);
  const long long tiles = mlx::row_tiles(f, rt);
  if (tiles * n_frames > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int ctas = static_cast<int>(tiles * n_frames);
  const size_t smem = mlx::row_tile_smem(rt);
  const int tl = static_cast<int>(tiles);
  switch (mlx::tiles::config(f.n1)) {
    case 0:
      return mlx::launch_tiles<256>(stft_four_step_rows<256, 16>, ctas, smem,
                               stream, tw, f, rt, tl, scratch, out, scale);
    case 1:
      return mlx::launch_tiles<256>(stft_four_step_rows<256, 32>, ctas, smem,
                               stream, tw, f, rt, tl, scratch, out, scale);
    default:
      return mlx::launch_tiles<512>(stft_four_step_rows<512, 32>, ctas, smem,
                               stream, tw, f, rt, tl, scratch, out, scale);
  }
}

}  // namespace

// B12 at the sizes up to 49,152 that are no power of two: the frame tile;
// tw is kstft.four_step_column_table(size).  Any other size is refused
// (cudaErrorInvalidValue).
extern "C" int mlx_stft_mag_sizes(const float* wav, long long n,
                                  const float* win, const float2* tw,
                                  float* out, int n_frames, int size, int hop,
                                  float scale, cudaStream_t stream) {
  if (!mlx::frame_tile_takes(size)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const mlx::ColTile ft = mlx::make_frame_tile(size, 0);
  const int ctas = (n_frames + ft.t - 1) / ft.t;
  const size_t smem = mlx::col_tile_smem(ft);
  switch (mlx::frame_config(ft)) {
    case 0:
      return static_cast<int>(mlx::launch_tiles<256>(
          stft_mag_tile_kernel<256, 16>, ctas, smem, stream, wav, n, win, tw,
          ft, n_frames, hop, out, scale));
    case 1:
      return static_cast<int>(mlx::launch_tiles<256>(
          stft_mag_tile_kernel<256, 32>, ctas, smem, stream, wav, n, win, tw,
          ft, n_frames, hop, out, scale));
    case 2:
      return static_cast<int>(mlx::launch_tiles<512>(
          stft_mag_tile_kernel<512, 32>, ctas, smem, stream, wav, n, win, tw,
          ft, n_frames, hop, out, scale));
    default:
      return static_cast<int>(mlx::launch_tiles<512>(
          stft_mag_tile_kernel<512, 16>, ctas, smem, stream, wav, n, win, tw,
          ft, n_frames, hop, out, scale));
  }
}

// B12 at the power-of-two sizes of fft_pair.cuh; tw is kpv.pair_twiddles
// of `size`.  Any other size is refused (cudaErrorInvalidValue).
extern "C" int mlx_stft_mag_pair(const float* wav, long long n,
                                 const float* win, const float2* tw,
                                 float* out, int n_frames, int size, int hop,
                                 float scale, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (size) {
    case 512:
      err = mlx::launch_stft_mag_pair<512>(wav, n, win, tw, out, n_frames,
                                           hop, scale, stream);
      break;
    case 1024:
      err = mlx::launch_stft_mag_pair<1024>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    case 2048:
      err = mlx::launch_stft_mag_pair<2048>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    case 4096:
      err = mlx::launch_stft_mag_pair<4096>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    case 8192:
      err = mlx::launch_stft_mag_pair<8192>(wav, n, win, tw, out, n_frames,
                                            hop, scale, stream);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

template <int N>
int launch_stft_mag_large(const float* wav, long long n, const float* win,
                          const float2* tw, float* out, int n_frames, int hop,
                          float scale, cudaStream_t stream) {
  return static_cast<int>(mlx::large::launch_real<N>(
      stft_mag_large_kernel<N>, n_frames, stream, wav, n, win, tw, out, hop,
      scale));
}

// B12 at 16,384, 32,768 and 65,536 points: the on-chip route; tw is
// kstft.large_twiddles(size).  Any other size is refused
// (cudaErrorInvalidValue).
extern "C" int mlx_stft_mag_large(const float* wav, long long n,
                                  const float* win, const float2* tw,
                                  float* out, int n_frames, int size, int hop,
                                  float scale, cudaStream_t stream) {
  switch (size) {
    case 16384:
      return launch_stft_mag_large<16384>(wav, n, win, tw, out, n_frames, hop,
                                          scale, stream);
    case 32768:
      return launch_stft_mag_large<32768>(wav, n, win, tw, out, n_frames, hop,
                                          scale, stream);
    case 65536:
      return launch_stft_mag_large<65536>(wav, n, win, tw, out, n_frames, hop,
                                          scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B12 where the four-step columns take Bluestein on a cluster (an odd
// factor above 12,288, N2 <= 32,768): the columns on clusters of 2 CTAs
// (N2 <= 16,384) or 4, then the four-step rows.  `scratch` as
// mlx_stft_mag_4step's; tw kstft.four_step_twiddles(size, n1), tab
// kstft.bluestein_table(size / n1).  Other plans are refused
// (cudaErrorInvalidValue); a cluster the card cannot hold is refused at
// launch (cudaErrorLaunchOutOfResources), never run another way.
extern "C" int mlx_stft_mag_bluestein(const float* wav, long long n,
                                      const float* win, const float2* tw,
                                      const float2* tab, float2* scratch,
                                      float* out, int n_frames, int size,
                                      int n1, int hop, float scale,
                                      cudaStream_t stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const mlx::FourStep f = mlx::make_four_step(size, n1);
  if (!mlx::four_step_bluestein(f) || f.n2 > mlx::kBluesteinMax || n1 % 2 ||
      n_frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using L = mlx::large::Large<16384>;
  const int cluster = mlx::bluestein_cluster(f.n2);
  const dim3 grid(n1 / 2 * cluster, n_frames);
  cudaError_t err =
      cluster == 2
          ? mlx::launch_clustered(stft_four_step_cols_bluestein<2>, grid,
                                  L::kThreads, L::kSmem, 2, stream, wav, n,
                                  win, tab, f, hop, scratch)
          : mlx::launch_clustered(stft_four_step_cols_bluestein<4>, grid,
                                  L::kThreads, L::kSmem, 4, stream, wav, n,
                                  win, tab, f, hop, scratch);
  if (err == cudaSuccess) {
    err = launch_rows(tw, f, scratch, out, n_frames, scale, stream);
  }
  return static_cast<int>(err);
}

// B12 where the four-step columns take Bluestein above N2 = 32,768: the
// column pairs through the work space `work` (min(pairs, 512 MiB / (8 L))
// pairs of L float2, kstft.bluestein_work), a chunk of pairs at a time
// (forward, middle, inverse, split), then the four-step rows.  `scratch`
// as mlx_stft_mag_4step's; tw kstft.four_step_twiddles(size, n1), tab
// kstft.bluestein_scratch_table(size / n1).  Other plans are refused
// (cudaErrorInvalidValue), never run another way.
extern "C" int mlx_stft_mag_bluestein_scratch(
    const float* wav, long long n, const float* win, const float2* tw,
    const float2* tab, float2* scratch, float2* work, float* out,
    int n_frames, int size, int n1, int hop, float scale,
    cudaStream_t stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const mlx::FourStep f = mlx::make_four_step(size, n1);
  if (!mlx::four_step_bluestein(f) || f.n2 <= mlx::kBluesteinMax ||
      n1 % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using L = mlx::large::Large<16384>;
  const mlx::ScratchPlan sp = mlx::make_scratch_plan(f.n2);
  const long long items = static_cast<long long>(n_frames) * (n1 / 2);
  const long long chunk =
      std::min(items, mlx::kWorkBytes / (8LL * sp.l));
  const size_t smem_mid =
      static_cast<size_t>(mlx::mid_tile(sp.c)) * (sp.c + 1) * sizeof(float2);
  cudaError_t err = mlx::allow_smem(stft_bluestein_forward, L::kSmem);
  if (err == cudaSuccess) err = mlx::allow_smem(stft_bluestein_inverse, L::kSmem);
  if (err == cudaSuccess) err = mlx::allow_smem(stft_bluestein_middle, smem_mid);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long i0 = 0; i0 < items; i0 += chunk) {
    const int nit = static_cast<int>(std::min(chunk, items - i0));
    stft_bluestein_forward<<<dim3(sp.c, nit), L::kThreads, L::kSmem,
                             stream>>>(wav, n, win, tab, f, sp, hop, i0,
                                       work);
    const dim3 regs(mlx::kBluesteinM / 256, nit);
    switch (sp.c) {
      case 8:
        stft_bluestein_middle_regs<8><<<regs, 256, 0, stream>>>(tab, sp,
                                                                work);
        break;
      case 16:
        stft_bluestein_middle_regs<16><<<regs, 256, 0, stream>>>(tab, sp,
                                                                 work);
        break;
      default:
        stft_bluestein_middle<<<dim3(mlx::kBluesteinM / mlx::mid_tile(sp.c),
                                     nit),
                                mlx::kMidThreads, smem_mid, stream>>>(
            tab, sp, work);
    }
    stft_bluestein_inverse<<<dim3(sp.c, nit), L::kThreads, L::kSmem,
                             stream>>>(tab, sp, work);
    stft_bluestein_split<<<dim3(f.n2 / 2 / mlx::kSplitBins + 1,
                                (nit + mlx::kSplitItems - 1) /
                                    mlx::kSplitItems),
                           256, 0, stream>>>(f, sp, i0, nit, work, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      launch_rows(tw, f, scratch, out, n_frames, scale, stream));
}

// B12 above 49,152 points at the other sizes: the four-step route in tiles.
// `scratch` holds n_frames * (size / n1 / 2 + 1) * n1 float2 values; tw is
// kstft.four_step_twiddles(size, n1), tw2 kstft.four_step_column_table(size
// / n1).  A plan whose columns take Bluestein is refused
// (cudaErrorInvalidValue).
extern "C" int mlx_stft_mag_4step(const float* wav, long long n,
                                  const float* win, const float2* tw,
                                  const float2* tw2, float2* scratch,
                                  float* out, int n_frames, int size, int n1,
                                  int hop, float scale, cudaStream_t stream) {
  if (n_frames <= 0) return static_cast<int>(cudaGetLastError());
  const mlx::FourStep f = mlx::make_four_step(size, n1);
  const mlx::ColTile ct = mlx::make_col_tile(f.n2);
  if (mlx::four_step_bluestein(f) || n1 % ct.t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = n1 / ct.t;
  const size_t smem = mlx::col_tile_smem(ct);
  const int ctas = tiles * n_frames;
  cudaError_t err;
  switch (mlx::tiles::config(ct.p)) {
    case 0:
      err = mlx::launch_tiles<256>(stft_four_step_cols<256, 16>, ctas, smem,
                              stream, wav, n, win, tw2, f, ct, tiles, hop,
                              scratch);
      break;
    case 1:
      err = mlx::launch_tiles<256>(stft_four_step_cols<256, 32>, ctas, smem,
                              stream, wav, n, win, tw2, f, ct, tiles, hop,
                              scratch);
      break;
    default:
      err = mlx::launch_tiles<512>(stft_four_step_cols<512, 32>, ctas, smem,
                              stream, wav, n, win, tw2, f, ct, tiles, hop,
                              scratch);
  }
  if (err == cudaSuccess) {
    err = launch_rows(tw, f, scratch, out, n_frames, scale, stream);
  }
  return static_cast<int>(err);
}
