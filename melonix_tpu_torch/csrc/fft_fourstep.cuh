// The real-input DFT of one N-point frame that no on-chip route takes, as a
// four-step transform through a scratch buffer in device memory: B12
// (stft_mag_sizes.cu) above 49,152 points at the sizes fft_large.cuh does
// not take (a power of two above 65,536, or any other size: 98,304 = 3 *
// 2^15, 512 * 16,411).  B7 takes none of it: its sizes above 49,152 run on
// chip (fft_large.cuh at 65,536, fft_mixed.cuh at the others).  The column
// tiles' body also runs whole frames held on chip: the frame tiles
// (frame_tile) of B7 and B12 at the sizes up to kMaxColumn that are no
// power of two, a CTA T frames (N1 = 1, N2 = N), each read contiguously.
//
// N = N1 * N2, N1 a power of two; sample x[n1 + N1*n2] (n1 < N1, n2 < N2).
//   1. Columns: the real N2-point DFT C[n1, k2] of the strided column
//      x[n1 + N1*n2] over n2; bins k2 <= N2/2 go to the scratch as row k2
//      (the other half is their mirror: the column is real).  Three forms:
//      * N2 = 2^b * m (m odd, b >= 2) up to kMaxColumn: coalesced tiles
//        (four_step_columns, ColTile).  A CTA takes one frame and T
//        consecutive n1 (32, or as many as one Stockham batch holds, at
//        least 1), so a warp reads T adjacent samples of a row n2.  Each
//        real column is decimated by m, x_s[n] = x[n m + s], and each x_s
//        packed as P = 2^(b-1) complex points z_s[q] = x_s[2q] + i
//        x_s[2q+1]; the T * m P-point transforms run together as a batched
//        Stockham in shared memory (tiles::batch_fft: radix-16 passes, then
//        one of 8, 4 or 2); the real split gives X_s[k1], k1 <= P, times
//        W_N2^(s k1); then the m-point sums over s (two outputs p, m - p a
//        multiply-add group, W_m from a table), each bin k2 <= N2/2 stored
//        once, the tile's T columns of a row contiguous.  One real column
//        packed is 4*N2 bytes, so every N2 up to 49,152 fits a CTA; two
//        columns as one complex transform would take 8*N2 bytes, above the
//        CTA's 227 KB from N2 = 29,057 on.
//      * Any other N2 up to kBluesteinMax: Bluestein's chirp-z form, two
//        columns a cluster (four_step_column_bluestein: 2 CTAs up to N2 =
//        16,384, 4 above).
//      * Above kBluesteinMax: the same Bluestein algebra through device
//        scratch (ScratchPlan; stft_mag_sizes.cu's stft_bluestein_forward,
//        _middle_regs / _middle, _inverse and _split), one Large<16384> CTA
//        per part, the cross-part radix-C step a kernel of its own.
//   2-3. Rows (four_step_rows, RowTile): a CTA takes one frame and K
//      consecutive scratch rows k2 <= N2/2; it reads each row's N1 values
//      contiguously and forms both output rows k2 and N2 - k2 (C[n1, N2 -
//      k2] = conj C[n1, k2]), multiplies by the four-step twiddle
//      W_N^(n1*k2), runs the complex N1-point transforms as a batched
//      Stockham in shared memory and stores |X[k2 + N2*k1]| * scale for the
//      bins below N/2, the tile's K bins of each k1 contiguous.  Every
//      column form writes the same untwiddled C; the rows twiddle.
// The host picks (N1, N2) (kernels/stft.py:four_step_plan).  Tables are
// float32, computed in float64 on the host and rounded once: the rows'
// (kernels/stft.py:four_step_twiddles: a row tile's W_N^(n1 k2) = coarse
// [x >> f] * fine[x & (2^f - 1)] at x = n1 k2_0, warp-uniform, times
// W_N^(n1 (k2 - k2_0)) from a lane table read along k2; then W_N1^y for
// the passes), the columns' (four_step_column_table: W_P^y, W_N2^x,
// W_m^x), Bluestein's (bluestein_table, bluestein_scratch_table, whose
// W_L^(r k) is split the same way over k mod 32).  The products add two
// float32 complex products' rounding (< 4e-7).  No __sincosf, no TF32, no
// tensor cores.
#pragma once

#include "fft_large.cuh"

namespace mlx {

// The largest FFT column (4*N2 bytes of shared memory as one real column);
// kernels/stft.py's MAX_SIZE.
constexpr int kMaxColumn = 49152;
// Shared memory a CTA may take (the H100's 227 KB).
constexpr size_t kSmemMax = 232448;

__host__ __device__ inline int ilog2_floor(long long x) {
  int r = 0;
  while ((2LL << r) <= x) ++r;
  return r;
}

struct FourStep {
  int n;      // N
  int n1;     // complex row transforms' size, a power of two
  int n2;     // N / N1
  int log_f;  // the rows' twiddle table: fine W_N^x for x < 2^log_f
  int coarse;  // table offset of the coarse W_N^(x 2^log_f); then W_N1^y
};

__host__ __device__ inline FourStep make_four_step(int n, int n1) {
  FourStep f;
  f.n = n;
  f.n1 = n1;
  f.n2 = n / n1;
  f.log_f = (ilog2_floor(n - 1) + 2) / 2;  // 2^log_f >= sqrt(N)
  f.coarse = 1 << f.log_f;
  return f;
}

// Offset of the rows' pass table W_N1^y (y < N1) in four_step_twiddles;
// after it the lane table W_N^(n1 q) at n1 * kRowLanes + q (q < 16).
__host__ __device__ inline int four_step_pass_table(const FourStep& f) {
  return f.coarse + static_cast<int>((static_cast<long long>(f.n) +
                                      f.coarse - 1) >> f.log_f);
}
constexpr int kRowLanes = 16;  // a row tile's source rows, at most

// Whether step 1 takes Bluestein's form: an N2 above kMaxColumn or without
// the power-of-two part of 4 the tiles need (the host's test is
// kernels/stft.py:four_step_bluestein).
__host__ __device__ inline bool four_step_bluestein(const FourStep& f) {
  return f.n2 > kMaxColumn || (f.n2 & 3) != 0;
}

// Scratch float2 values per frame: rows k2 = 0..N2/2 of N1 values.
__host__ __device__ inline long long four_step_scratch(const FourStep& f) {
  return static_cast<long long>(f.n2 / 2 + 1) * f.n1;
}

// (cos, sin)(2 pi x / N) from a coarse and a fine table.
__device__ __forceinline__ float2 coarse_fine(const float2* __restrict__ fine,
                                              const float2* __restrict__ coarse,
                                              int log_f, long long x) {
  const float2 a = __ldg(coarse + (x >> log_f));
  const float2 b = __ldg(fine + (x & ((1LL << log_f) - 1)));
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

namespace tiles {

// A tile CTA's threads kT and the points kPts a thread holds through a pass
// (tiles::config): 256 x 16 up to P = 256 (four CTAs a SM at 64 registers:
// timed against three at 80 and two at 128, their spills cost less than
// the lost occupancy), 256 x 32 at P = 512 (two), 512 x 32 above (P up to
// 16,384).  A batch of kT kPts points holds at least 16 sequences up to P
// = 1024: a half-warp then takes 16 sequences at one j.
constexpr int kUnroll = 8;  // loads a thread issues before it uses one

// for idx = threadIdx.x + kT i < n, in groups of kUnroll: every load of a
// group is issued before its first use, so a thread keeps kUnroll global
// loads in flight.
template <int kT, class V, class Load, class Use>
__device__ __forceinline__ void staged(int n, Load load, Use use) {
  for (int base = threadIdx.x; base < n; base += kUnroll * kT) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kT;
      if (idx < n) v[u] = load(idx);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kT;
      if (idx < n) use(idx, v[u]);
    }
  }
}

// One radix-R Stockham pass over the sequences q < nq of buf (sequence q at
// buf + q * S, P points, Ns points already combined): item (q, j), j < P /
// R, takes in[j + (P / R) a], twiddles point a by W_(R Ns)^((j mod Ns) a) =
// W_P^((j mod Ns) a P / (R Ns)), runs the R-point DFT in registers and
// writes output k to (j / Ns) R Ns + (j mod Ns) + Ns k.  Items run with q
// fastest, so a half-warp takes 16 sequences at one j: with S odd its
// accesses fall on 16 banks.  All reads, a barrier, all writes, a barrier.
// nq * P <= kT * kPts.
template <int R, int kT, int kPts>
__device__ __forceinline__ void stockham_pass(float2* buf, int nq, int S,
                                              int P, int Ns,
                                              const float2* __restrict__ tw,
                                              float sign) {
  constexpr int E = kPts / R;
  const int per = P / R, jobs = nq * per, stride = P / (R * Ns);
  const int t = threadIdx.x;
  float2 v[E][R];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = t + kT * e;
    if (g < jobs) {
      const float2* in = buf + (g % nq) * S + g / nq;
#pragma unroll
      for (int a = 0; a < R; ++a) v[e][a] = in[per * a];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = t + kT * e;
    if (g < jobs) {
      const int j = g / nq, jm = j & (Ns - 1);
#pragma unroll
      for (int a = 1; a < R; ++a) {
        v[e][a] = pairfft::ctw(v[e][a], __ldg(tw + jm * a * stride), sign);
      }
      pairfft::dft_regs<R>(v[e], sign);
      float2* out = buf + (g % nq) * S + (j - jm) * R + jm;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        out[Ns * k] = v[e][pairfft::brev(k, pairfft::ilog2(R))];
      }
    }
  }
  __syncthreads();
}

// The P-point DFTs (P = 2 ... kT * kPts, a power of two) of the nseq
// sequences of buf, in place, natural order in and out; sign -1 forward, +1
// inverse without the 1/P scale.  Radix-16 passes, then one of 8, 4 or 2
// (timed against 8 8 8 at 512 points and 8 8 at 64: the radix-16 passes
// win).  tw: (cos, sin)(2 pi y / P), y < P.
// Sequences go in batches of kT * kPts / P, every pass of a batch in
// registers.  Every thread of the CTA calls it after a barrier that orders
// the writes of buf; it ends with one.
template <int kT, int kPts>
__device__ __forceinline__ void batch_fft(float2* buf, int nseq, int S, int P,
                                          const float2* __restrict__ tw,
                                          float sign) {
  const int per_batch = kT * kPts / P;
  for (int q0 = 0; q0 < nseq; q0 += per_batch) {
    const int nq = min(per_batch, nseq - q0);
    float2* b = buf + static_cast<long long>(q0) * S;
    int ns = 1;
    for (; ns * 16 <= P; ns *= 16) {
      stockham_pass<16, kT, kPts>(b, nq, S, P, ns, tw, sign);
    }
    if (P / ns == 8) stockham_pass<8, kT, kPts>(b, nq, S, P, ns, tw, sign);
    if (P / ns == 4) stockham_pass<4, kT, kPts>(b, nq, S, P, ns, tw, sign);
    if (P / ns == 2) stockham_pass<2, kT, kPts>(b, nq, S, P, ns, tw, sign);
  }
}

// The tile configuration for P-point transforms: 0 (256 x 16), 1 (256 x
// 32) or 2 (512 x 32).
__host__ __device__ constexpr int config(int p) {
  return p <= 256 ? 0 : p <= 512 ? 1 : 2;
}

}  // namespace tiles

// ---------------------------------------------------------------- columns

constexpr int kColGroup = 4;  // pairs (p, m - p) a thread sums at once

// Layout of one CTA's column tile (kernels/stft.py:column_tile).
struct ColTile {
  int m, h;  // N2's odd factor and (m - 1) / 2
  int b;     // B = N2 / m, a power of two >= 4
  int p;     // P = B / 2, complex points of a sub-transform
  int t;     // columns a CTA, T: 32, or as many as keep T N2 / 2 within
             // one batch (4096, 8192 or 16,384 points), at least 1
  int s;     // float2 stride of a sub-sequence: P + 1 (odd), or P where
             // T m (P + 1) float2 would pass kSmemMax
  // the column table (kernels/stft.py:four_step_column_table): W_P^y (y <
  // P) at 0, W_N2^x (x < N2 / 2) at P, W_m^x (x < m) at P + N2 / 2
};

__host__ __device__ inline ColTile make_col_tile(int n2) {
  ColTile c;
  c.m = n2;
  while ((c.m & 1) == 0) c.m >>= 1;
  c.h = (c.m - 1) / 2;
  c.b = n2 / c.m;
  c.p = c.b / 2;
  // points: one batch of the tile's configuration (tiles::config)
  const int budget = c.p <= 256 ? 4096 : c.p <= 512 ? 8192 : 16384;
  c.t = 32;
  while (c.t > 1 && c.t * (n2 / 2) > budget) c.t /= 2;
  const long long seqs = static_cast<long long>(c.t) * c.m;
  c.s = seqs * (c.p + 1) * 8 <= static_cast<long long>(kSmemMax) ? c.p + 1
                                                                 : c.p;
  return c;
}

__host__ __device__ inline size_t col_tile_smem(const ColTile& c) {
  return static_cast<size_t>(c.t) * c.m * c.s * sizeof(float2);
}

// The body of a column or frame tile after its load: `s` holds the tile's T
// m packed sub-sequences, sequence q = sub * T + j sub-sequence sub of
// column j, at stride ct.s; `tab` is the column table.  The batched
// Stockham, the split times W_N2^(sub k), the paired m-point sums; each bin
// k of column j goes to put(k, j, v), bins k <= N2 / 2 once each (above, the
// mirror of one below, or nothing: put filters).  Every thread of the CTA
// (kT of them) calls it once its stores to `s` are issued; it begins with
// a barrier.
template <int kT, int kPts, class Put>
__device__ __forceinline__ void col_tile_body(float2* s, const ColTile& ct,
                                              const float2* __restrict__ tab,
                                              Put put) {
  const int t = threadIdx.x, T = ct.t, m = ct.m, P = ct.p, S = ct.s;
  const int half = ct.b * m / 2, seqs = T * m;
  const float2* wp = tab;                 // W_P^y
  const float2* wn2 = tab + P;            // W_N2^x, x < N2 / 2
  const float2* wm = tab + P + half;      // W_m^x
  const int lt = ilog2_floor(T), dr = kT >> lt;
  __syncthreads();
  tiles::batch_fft<kT, kPts>(s, seqs, S, P, wp, -1.0f);
  // -- split Z_s into X_s[k], k <= P, times W_N2^(sub k), in place; X_s[0]
  // and X_s[P] (both real) share slot 0
  const int dq = kT % seqs, dk = kT / seqs;
  for (int g = t, q = t % seqs, k = t / seqs; g < seqs * (P / 2);
       g += kT, q += dq, k += dk) {
    if (q >= seqs) {
      q -= seqs;
      ++k;
    }
    const int sub = q >> lt;
    float2* z = s + q * S;
    if (k == 0) {
      const float2 z0 = z[0], zq = z[P / 2];
      z[0] = make_float2(z0.x + z0.y, z0.x - z0.y);
      z[P / 2] = pairfft::ctw(make_float2(zq.x, -zq.y),
                              __ldg(wn2 + sub * (P / 2)), -1.0f);
    } else {
      const float2 zk = z[k], zm = z[P - k], w = __ldg(wn2 + k * m);
      const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
      const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
      const float wox = w.x * ox + w.y * oy, woy = w.x * oy - w.y * ox;
      z[k] = pairfft::ctw(make_float2(ex + wox, ey + woy),
                          __ldg(wn2 + sub * k), -1.0f);
      z[P - k] = pairfft::ctw(make_float2(ex - wox, woy - ey),
                              __ldg(wn2 + sub * (P - k)), -1.0f);
    }
  }
  __syncthreads();
  // -- the m-point sums over sub for each (column j, k1 <= P, group):
  // Y[p] = sum v_sub W_m^(sub p), Y[m - p] with W_m^(-sub p); bin k1 + B k2
  // is Y_k1[k2] for k1 <= P and conj Y_(B-k1)[m - 1 - k2] above
  const int B = ct.b, groups = max(1, (ct.h + kColGroup - 1) / kColGroup);
  const int j = t & (T - 1);
  const int dk1 = dr % (P + 1), dgrp = dr / (P + 1);
  for (int g = t, k1 = (t >> lt) % (P + 1), grp = (t >> lt) / (P + 1);
       g < T * (P + 1) * groups; g += kT, k1 += dk1, grp += dgrp) {
    if (k1 > P) {
      k1 -= P + 1;
      ++grp;
    }
    const int p0 = grp * kColGroup + 1, cnt = min(kColGroup, ct.h - p0 + 1);
    float2 y0 = make_float2(0.0f, 0.0f);
    float a[kColGroup], b[kColGroup], cc[kColGroup], d[kColGroup];
    int qi[kColGroup];
#pragma unroll
    for (int i = 0; i < kColGroup; ++i) {
      a[i] = b[i] = cc[i] = d[i] = 0.0f;
      qi[i] = 0;
    }
    const float2* src = s + j * S + (k1 == P ? 0 : k1);
    for (int sub = 0; sub < m; ++sub) {
      const float2 zz = src[sub * T * S];
      float2 x = zz;
      if (k1 == 0) x = make_float2(zz.x, 0.0f);
      if (k1 == P) {
        x = pairfft::ctw(make_float2(zz.y, 0.0f), __ldg(wn2 + sub * P),
                         -1.0f);
      }
      y0.x += x.x;
      y0.y += x.y;
#pragma unroll
      for (int i = 0; i < kColGroup; ++i) {
        if (i < cnt) {
          const float2 cs = __ldg(wm + qi[i]);
          a[i] += x.x * cs.x;
          b[i] += x.y * cs.y;
          cc[i] += x.y * cs.x;
          d[i] += x.x * cs.y;
          qi[i] += p0 + i;
          if (qi[i] >= m) qi[i] -= m;
        }
      }
    }
    if (grp == 0) put(k1, j, y0);
    const bool mirror = k1 > 0 && k1 < P;
#pragma unroll
    for (int i = 0; i < kColGroup; ++i) {
      if (i < cnt) {
        const int p = p0 + i;
        const float2 yp = make_float2(a[i] + b[i], cc[i] - d[i]);
        const float2 ym = make_float2(a[i] - b[i], cc[i] + d[i]);
        put(k1 + B * p, j, yp);
        put(k1 + B * (m - p), j, ym);
        if (mirror) {
          put(B - k1 + B * (m - 1 - p), j, make_float2(yp.x, -yp.y));
          put(B - k1 + B * (p - 1), j, make_float2(ym.x, -ym.y));
        }
      }
    }
  }
}

// Step 1 for columns n1_0 .. n1_0 + T - 1 of one frame: `sample(i)` is the
// windowed sample i < N of the frame, `c` the frame's scratch rows, `tab`
// the column table, `s` col_tile_smem bytes.  Sequence q = sub * T + j
// holds column n1_0 + j's sub-sequence sub.  Every thread of the CTA (kT =
// tiles::config(P)) calls it once.
template <int kT, int kPts, class Sample>
__device__ __forceinline__ void four_step_columns(
    float2* s, const FourStep& f, const ColTile& ct,
    const float2* __restrict__ tab, int n1_0, Sample sample,
    float2* __restrict__ c) {
  const int t = threadIdx.x, T = ct.t, m = ct.m, S = ct.s;
  const int n2 = f.n2, half = n2 / 2;
  float* sf = reinterpret_cast<float*>(s);
  // -- load: a warp reads T adjacent samples of a row n2; thread t keeps
  // column j and steps its row r = sub + m nn by kT / T (no division)
  constexpr int U = tiles::kUnroll;
  const int lt = ilog2_floor(T), j = t & (T - 1), dr = kT >> lt;
  const int dsub = dr % m, dnn = dr / m;
  int sub = (t >> lt) % m, nn = (t >> lt) / m;
  for (int r0 = t >> lt; r0 < n2; r0 += U * dr) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * dr < n2) x[u] = sample(n1_0 + j + f.n1 * (r0 + u * dr));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * dr < n2) {
        sf[2 * ((sub * T + j) * S + (nn >> 1)) + (nn & 1)] = x[u];
      }
      sub += dsub;
      nn += dnn;
      if (sub >= m) {
        sub -= m;
        ++nn;
      }
    }
  }
  float2* col = c + n1_0;
  col_tile_body<kT, kPts>(s, ct, tab, [&](int k, int jj, float2 v) {
    if (k <= half) col[static_cast<long long>(k) * f.n1 + jj] = v;
  });
}

// ------------------------------------------------------------ frame tiles

// A frame tile (B7 and B12 at the sizes up to kMaxColumn that are no power
// of two): the column tile's body on T whole frames of N = B m points (m
// odd, m >= 3), T as ColTile's budget gives it with N2 = N and, for B7,
// capped by the host so that `count` frames still fill kFrameSms CTAs where
// they can.  The sub-sequence stride is P + 3 for m < 9, P + 1 above: the
// load's lanes run along a frame's samples, sample i = m nn + sub going to
// float 2 (sub T + j) S + nn, and these strides put every half-warp's 16
// stores on 16 banks (tests/test_torch_frame_tile.py enumerates them).
constexpr int kFrameSms = 132;  // the H100's SMs

__host__ __device__ inline bool frame_tile_takes(int n) {
  return n > 0 && n <= kMaxColumn && n % 4 == 0 && (n & (n - 1)) != 0;
}

// kernels/stft.py:frame_tile; count <= 0: no cap.
__host__ __device__ inline ColTile make_frame_tile(int n, int count) {
  ColTile c = make_col_tile(n);
  const int fill = count < kFrameSms ? count : kFrameSms;
  while (count > 0 && c.t > 1 && (count + c.t - 1) / c.t < fill) c.t /= 2;
  c.s = c.p + (c.m < 9 ? 3 : 1);
  return c;
}

// The tile configuration of a frame tile: where one CTA fills a SM's shared
// memory, 512 x 32 (2) whatever P, so that the m-point sums of a large m
// have 16 warps; else tiles::config(P), but 512 x 16 (3: two CTAs a SM at
// 64 registers) for P > 512.
__host__ __device__ inline int frame_config(const ColTile& c) {
  if (2 * col_tile_smem(c) > kSmemMax) return 2;
  const int k = tiles::config(c.p);
  return k == 2 ? 3 : k;
}

// The T frames of a frame tile: `frame(j)` (j < frames <= T) gives the
// sampler of the tile's frame j, x(i) its windowed sample i < N; frames
// from `frames` on are silence.  store(j, k, X[k]) takes bin k < N / 2 of
// frame j < frames, each once.  `s` col_tile_smem(ct) bytes; every thread
// of the CTA ((kT, kPts) of frame_config) calls it once.
template <int kT, int kPts, class Frame, class Store>
__device__ __forceinline__ void frame_tile(float2* s, const ColTile& ct,
                                           const float2* __restrict__ tab,
                                           int frames, Frame frame,
                                           Store store) {
  const int t = threadIdx.x, T = ct.t, m = ct.m, S = ct.s;
  const int n = ct.b * m, half = n / 2;
  const int dsub = kT % m, dnn = kT / m;
  float* sf = reinterpret_cast<float*>(s);
  // -- load: lanes along a frame's samples, the frames one after another;
  // thread t steps its sample i = m nn + sub by kT (no division a sample)
  for (int j = 0; j < T; ++j) {
    int sub = t % m, nn = t / m;
    auto put = [&](int, float v) {
      sf[2 * ((sub * T + j) * S + (nn >> 1)) + (nn & 1)] = v;
      sub += dsub;
      nn += dnn;
      if (sub >= m) {
        sub -= m;
        ++nn;
      }
    };
    if (j < frames) {
      auto x = frame(j);
      tiles::staged<kT, float>(n, x, put);
    } else {
      tiles::staged<kT, float>(n, [](int) { return 0.0f; }, put);
    }
  }
  col_tile_body<kT, kPts>(s, ct, tab, [&](int k, int j, float2 v) {
    if (k < half && j < frames) store(j, k, v);
  });
}

// ------------------------------------------------------------------- rows

// Layout of one CTA's row tile (kernels/stft.py:row_tile).  Up to N1 =
// 8192 (`pair`) a tile takes K source rows k2 <= N2 / 2 and forms from each
// both output rows, k2 and its mirror N2 - k2 (C[n1, N2 - k2] = conj C[n1,
// k2]), so every scratch row is read once: 2K sequences of N1 points.  At
// N1 = 16,384 two rows do not fit a CTA: a tile takes one output row k2 <
// N2, the mirrors reading their source again.  Sequences sit at a float2
// stride of N1 + 1 (odd); at most 16,384 points.
struct RowTile {
  int k;     // source rows a CTA: 8 up to N1 = 1024, then 8192 / N1, 1 at
             // 16,384
  int s;     // N1 + 1
  int pair;  // 1: each source row gives its mirror too
};

__host__ __device__ inline RowTile make_row_tile(int n1) {
  RowTile r;
  r.pair = n1 <= 8192;
  r.k = n1 <= 1024 ? 8 : r.pair ? 8192 / n1 : 1;
  r.s = n1 + 1;
  return r;
}

__host__ __device__ inline int row_tile_seqs(const RowTile& r) {
  return r.pair ? 2 * r.k : r.k;
}

__host__ __device__ inline size_t row_tile_smem(const RowTile& r) {
  return static_cast<size_t>(row_tile_seqs(r)) * r.s * sizeof(float2);
}

// Row tiles of a frame: the source rows k2 <= N2 / 2 (pair) or all N2.
__host__ __device__ inline long long row_tiles(const FourStep& f,
                                               const RowTile& r) {
  const int rows = r.pair ? f.n2 / 2 + 1 : f.n2;
  return (rows + r.k - 1) / r.k;
}

// Steps 2-3 for the row tile of source rows k2_0 .. k2_0 + K - 1 of one
// frame: `c` the frame's scratch rows (untwiddled C), `tw` the rows' table
// (kernels/stft.py:four_step_twiddles), `store(k, X)` takes bin k < N/2,
// `s` row_tile_smem bytes.  Sequence kk < K is output row k2_0 + kk, K + kk
// its mirror.  Every thread of the CTA (kT = tiles::config(N1)) calls it
// once.
template <int kT, int kPts, class Store>
__device__ __forceinline__ void four_step_rows(float2* s, const FourStep& f,
                                               const RowTile& rt,
                                               const float2* __restrict__ tw,
                                               int k2_0,
                                               const float2* __restrict__ c,
                                               Store store) {
  const int t = threadIdx.x, K = rt.k, S = rt.s, n1s = f.n1, n2 = f.n2;
  const int lg = ilog2_floor(n1s), seqs = row_tile_seqs(rt);
  const int last = rt.pair ? n2 / 2 : n2 - 1;  // the tile's source rows
  // output row of sequence q, or -1 where it has none
  auto out_row = [&](int q) {
    const int k2 = k2_0 + (q < K ? q : q - K);
    if (k2 > last) return -1;
    if (q < K) return k2;
    return k2 > 0 && 2 * k2 != n2 ? n2 - k2 : -1;
  };
  tiles::staged<kT, float2>(
      K * n1s,
      [&](int idx) {
        const int k2 = k2_0 + (idx >> lg);
        const int src = k2 > n2 / 2 ? n2 - k2 : k2;  // pair: k2 <= N2 / 2
        return k2 <= last ? c[static_cast<long long>(src) * n1s +
                              (idx & (n1s - 1))]
                          : make_float2(0.0f, 0.0f);
      },
      [&](int idx, float2 v) {
        const int kk = idx >> lg, n1 = idx & (n1s - 1);
        const float2 vc = make_float2(v.x, -v.y);
        s[kk * S + n1] = !rt.pair && k2_0 + kk > n2 / 2 ? vc : v;
        if (rt.pair) s[(K + kk) * S + n1] = vc;
      });
  __syncthreads();
  // the twiddle W_N^(n1 row), q fastest: row = base + q (direct) or base -
  // (q - K) (mirror), W_N^(n1 base) warp-uniform (coarse * fine) times
  // W_N^(+-n1 q) from the lane table, read along q
  const float2* lanes = tw + four_step_pass_table(f) + n1s;
  const int lq = ilog2_floor(seqs);
#pragma unroll 4
  for (int idx = t; idx < seqs * n1s; idx += kT) {
    const int q = idx & (seqs - 1), n1 = idx >> lq;
    const bool mir = q >= K;
    const int base = mir ? n2 - k2_0 : k2_0, d = mir ? q - K : q;
    const float2 a = coarse_fine(tw, tw + f.coarse, f.log_f,
                                 static_cast<long long>(n1) * base);
    float2 b = __ldg(lanes + n1 * kRowLanes + d);
    if (mir) b.y = -b.y;
    float2* x = s + q * S + n1;
    *x = pairfft::ctw(*x, make_float2(a.x * b.x - a.y * b.y,
                                      a.x * b.y + a.y * b.x),
                      -1.0f);
  }
  __syncthreads();
  tiles::batch_fft<kT, kPts>(s, seqs, S, n1s, tw + four_step_pass_table(f),
                             -1.0f);
#pragma unroll 4
  for (int idx = t; idx < seqs * n1s; idx += kT) {
    const int q = idx & (seqs - 1), k1 = idx >> lq, row = out_row(q);
    const int k = row + n2 * k1;  // < N < 2^31
    if (row >= 0 && k < f.n / 2) store(k, s[q * S + k1]);
  }
}

// --------------------------------------------------------------- Bluestein

// Bluestein's form of step 1 (Large<16384> on a cluster of C CTAs, L = C *
// 16,384 points, C = bluestein_cluster(N2): 2 up to N2 = 16,384, 4 up to
// kBluesteinMax): the columns n1a and n1a + 1 as one complex sequence z[n2]
// = x[n1a + N1 n2] + i x[n1a + 1 + N1 n2], its N2-point DFT
//   Z[k] = conj(b_k) sum_n (z_n conj(b_n)) b_(k-n),  b_n = e^(i pi n^2 / N2)
// a circular convolution of length L >= 2 N2 - 1: the forward transform on
// the cluster (CTA r the points C m + r, then the cross-CTA radix-C step),
// whose epilogue multiplies by the chirp's spectrum (scaled by 1 / L), and
// the inverse by decimation in frequency (CTA q sums the C parts of P,
// P[n + j L / C] on CTA j, twiddled by W_C^(-q j), times W_L^(-q n), and
// transforms to the outputs C m + q).  The two real columns come apart by
// Hermitian symmetry, C_a[k] = (Z[k] + conj Z[N2-k]) / 2, C_b[k] = (Z[k] -
// conj Z[N2-k]) / 2i, for k <= N2 / 2, written to the scratch rows as one
// 16-byte store (n1a is even).  `tab` is kernels/stft.py:bluestein_table(N2)
// (BluesteinPlan<C>): b_n (n < N2), the spectrum (L), Large<16384>'s pass
// table, the cluster step's C - 1 rows W_L^(r k) (k < 16,384).  `load(n)`
// is the windowed pair (x[n1a + N1 n], x[n1a + 1 + N1 n]).  Every thread of
// the cluster calls it; `buf` holds Large<16384>::kSmem bytes.
constexpr int kBluesteinM = 16384;  // points a CTA transforms: Large<16384>
constexpr int kBluesteinMax = 2 * kBluesteinM;  // 4 CTAs: 2 N2 - 1 <= 65,536

// The cluster Bluestein takes for an N2-point column: 2 CTAs (L = 32,768)
// up to N2 = 16,384, 4 (L = 65,536) above (kernels/stft.py:bluestein_cluster).
__host__ __device__ constexpr int bluestein_cluster(int n2) {
  return n2 <= kBluesteinM ? 2 : 4;
}

template <int C>
struct BluesteinPlan {
  static constexpr int kL = C * kBluesteinM;  // the convolution's length
  // table offsets past the chirp's N2 entries
  static constexpr int kSpec = 0, kTw = kL;
  static constexpr int kMid = kTw + large::Large<kBluesteinM>::kTwiddles;
  static constexpr int kTable = kMid + (C - 1) * kBluesteinM;
};

template <int C, class Load>
__device__ __forceinline__ void four_step_column_bluestein(
    float2* buf, const FourStep& f, const float2* __restrict__ tab, int n1a,
    Load load, float2* __restrict__ c) {
  namespace cg = cooperative_groups;
  using BP = BluesteinPlan<C>;
  constexpr int H = kBluesteinM, T = large::Large<H>::kThreads;
  const cg::cluster_group cl = cg::this_cluster();
  const int q = static_cast<int>(cl.block_rank()), t = threadIdx.x;
  const int n2 = f.n2;
  const float2* chirp = tab;
  const float2* spec = tab + n2 + BP::kSpec;
  const float2* tw = tab + n2 + BP::kTw;
  const float2* mid = tab + n2 + BP::kMid;
  // forward: a_n = z_n conj(b_n), zero from N2 on; P[k + q H] = A[k + q H]
  // times the spectrum, in place
  large::fft_cluster<H, C>(
      [&](int n) {
        return n < n2 ? pairfft::ctw(load(n), __ldg(chirp + n), -1.0f)
                      : make_float2(0.0f, 0.0f);
      },
      buf, tw, mid, -1.0f, cl,
      [&](int k, float2 a) {
        return pairfft::ctw(a, __ldg(spec + k + q * H), 1.0f);
      });
  const float2* src[C];
#pragma unroll
  for (int j = 0; j < C; ++j) src[j] = cl.map_shared_rank(buf, j);
  // inverse, decimation in frequency; pass 1's writes wait for the peers'
  // reads of this buffer (the fence)
  large::fft<H>(
      [&](int n) {
        float2 acc = src[0][n];
#pragma unroll
        for (int j = 1; j < C; ++j) {
          acc = pairfft::cadd(acc, large::rot4(src[j][n], (4 / C) * q * j,
                                               1.0f));
        }
        return q ? pairfft::ctw(acc, __ldg(mid + (q - 1) * H + n), 1.0f)
                 : acc;
      },
      [&] { cl.sync(); }, buf, tw, 1.0f);
  cl.sync();  // conv[C m + q] is in buf[m] of CTA q
  auto z = [&](int k) {  // Z[k] = conj(b_k) conv[k]
    return pairfft::ctw(src[k % C][k / C], __ldg(chirp + k), -1.0f);
  };
  for (int k = C * t + q; k <= n2 / 2; k += C * T) {
    const float2 zk = z(k), zm = z(k == 0 ? 0 : n2 - k);
    *reinterpret_cast<float4*>(c + static_cast<long long>(k) * f.n1 + n1a) =
        make_float4(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y),
                    0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  }
  cl.sync();  // the peers' reads of this buffer are done
}

// Bluestein through device scratch, for N2 above kBluesteinMax: L the least
// power of two >= 2 N2 - 1, L = C M (M = 16,384, C = 8 ... 512), a column
// pair ("item") owning L float2 of work space, w[r M + k]; the kernels are
// stft_mag_sizes.cu's stft_bluestein_*.
//   forward, CTA (r, item): Y_r = the M-point DFT of a[C m + r]
//     (Large<16384>, pass 1 reading the chirped samples where they lie, the
//     chirp from a table in the same [r][m] order, so its reads coalesce);
//     w[r][k] = W_L^(r k) Y_r[k], contiguous in k.
//   middle: for each k, reads w[r][k] for every r, the forward
//     C-point DFT over r (X[k + q M]), times the spectrum S[k + q M]
//     (scaled by 1 / L), the inverse's C-point step over q (sum_q
//     W_C^(-q q') P[k + q M]) times W_L^(-q' k), written back in place.  Up
//     to C = 16 (N2 <= 131,072) the C-point DFT is one radix-C pass: a
//     thread takes one k and holds its C points in registers, every read
//     and write coalesced along k, no shared memory.  Above, a CTA takes a
//     tile of mid_tile(C) consecutive k and runs a batched Stockham of C
//     points in shared memory, both directions.
//   inverse, CTA (q', item): the inverse M-point DFT of w[q'][.]
//     gives conv[C m + q']; w[q'][m] = Z[C m + q'] = conj(b) conv where C m
//     + q' < N2.
//   split, CTA (kSplitBins bins, kSplitItems items): Z[k] and
//     Z[N2 - k] from w[k mod C][k / C] along k, the two columns apart, a
//     transpose through shared memory, then the 16-byte row stores with the
//     items fastest (16 adjacent pairs: 256 contiguous bytes of a row).  It
//     is a kernel of its own, not the rows' load: the items go in chunks
//     through one work space, and the rows need every pair of a frame.
// Table (kernels/stft.py:bluestein_scratch_table, ScratchPlan): the chirp
// in [r][m] order, b_(C m + r) at r M + m (0 from N2 on; L entries), the
// spectrum (L), Large<16384>'s pass table, W_C^y (y < C), fine W_L^x (x <
// 2^log_f), coarse W_L^(x 2^log_f) (x < L / 2^log_f), the lane table
// W_L^(r kl) at 32 r + kl (r < C, kl < 32): each W_L^(r k) is
// scratch_twiddle's product of three entries.
struct ScratchPlan {
  int n2, l, c, log_c, log_f;
  long long spec, pass, wc, fine, coarse, lane;  // table offsets, float2
};

__host__ __device__ inline ScratchPlan make_scratch_plan(int n2) {
  ScratchPlan sp;
  sp.n2 = n2;
  sp.l = 1;
  while (sp.l < 2 * n2 - 1) sp.l *= 2;
  sp.c = sp.l / kBluesteinM;
  sp.log_c = ilog2_floor(sp.c);
  sp.log_f = (ilog2_floor(sp.l) + 1) / 2;
  sp.spec = sp.l;
  sp.pass = sp.spec + sp.l;
  sp.wc = sp.pass + large::Large<kBluesteinM>::kTwiddles;
  sp.fine = sp.wc + sp.c;
  sp.coarse = sp.fine + (1LL << sp.log_f);
  sp.lane = sp.coarse + (sp.l >> sp.log_f);
  return sp;
}

// (cos, sin)(2 pi r k / L), k = 32 kh + kl: W_L^(32 r kh) from the coarse
// and fine tables (uniform across a warp whose lanes run along k) times
// W_L^(r kl) from the lane table, read along kl.
__device__ __forceinline__ float2 scratch_twiddle(
    const float2* __restrict__ tab, const ScratchPlan& sp, int r, int k) {
  const float2 a = coarse_fine(tab + sp.fine, tab + sp.coarse, sp.log_f,
                               32LL * r * (k >> 5));
  const float2 b = __ldg(tab + sp.lane + r * 32 + (k & 31));
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Work space the entry may use: items in chunks of kWorkBytes / (8 L)
// (kernels/stft.py:BLUESTEIN_WORK).
constexpr long long kWorkBytes = 1LL << 29;
constexpr int kMidThreads = 256;  // 16 points a thread through a pass
constexpr int kSplitBins = 64, kSplitItems = 16;  // a bluestein_split tile
// k's a bluestein_middle CTA takes: 8192 points, two batches
__host__ __device__ constexpr int mid_tile(int c) { return 8192 / c; }

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in
// (host side; clears the error it reports).  `carveout`: ask for the
// largest shared-memory carveout, so several such CTAs share a SM (the
// tiles of 256 threads); without it CUDA keeps more L1, which the
// one-CTA-a-SM kernels' gathers and tables use.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool carveout = false) {
  cudaError_t err = cudaSuccess;
  if (carveout) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) cudaGetLastError();  // the call reports it once
  return err;
}

// Launch a tile kernel of kT threads on `ctas` CTAs with `smem` bytes.
template <int kT, class... Exp, class... Act>
cudaError_t launch_tiles(void (*kernel)(Exp...), int ctas, size_t smem,
                         cudaStream_t stream, Act&&... args) {
  const cudaError_t err = allow_smem(kernel, smem, kT == 256);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kT, smem, stream>>>(static_cast<Act&&>(args)...);
  return cudaGetLastError();
}

}  // namespace mlx
