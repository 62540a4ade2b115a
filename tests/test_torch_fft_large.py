"""The on-chip large transform of B7 and B12, modelled on the CPU.

``csrc/fft_large.cuh`` (a 16,384-point complex FFT in one CTA, a 32,768-point
one on a cluster of two CTAs and a 65,536-point one on four, the real
transforms of 16,384, 32,768 and 65,536 points on them) and the Bluestein
columns of ``csrc/fft_fourstep.cuh`` run only on the card (chip_smoke.py phases 9, 10 and 19 hold their kernels
against their twins there).  These tests hold what the design rests on:

* a NumPy transcription of ``Large<16384>``'s four Stockham passes (radix
  16, 16, 16, 4) in the kernel's index order, with its host table and the
  float32 constants of ``dft_regs``, against ``np.fft.fft`` both ways, pass
  by pass against the partial DFTs the passes compute;
* the cluster's split of the points by rank and its cross-CTA radix-C step
  at 32,768 (C = 2) and 65,536 points (C = 4), each CTA reading the
  buffers at the one index the design names, against ``np.fft.fft``;
* every half-warp's shared-memory accesses of the passes, the cluster step
  and the epilogues on 16 distinct banks, and each exchange a permutation
  within the buffer;
* the real split of the three real sizes against float64 ``np.fft.rfft``;
* Bluestein's identity with the chirp's int64 index at N2 = 12,289 and small
  odd N2, in float64 and as the kernel's float32 transcription on 2 CTAs
  (L = 32,768) and on 4 (L = 65,536, N2 up to 32,768), against
  ``np.fft.fft``; the host tables within 1 ulp of float64;
* the routes of ``kstft.route`` and ``kcols.route`` around every boundary,
  the table offsets the headers read, and the C entry each wrapper calls.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.kernels import columns as kcols
from melonix_tpu_torch.kernels import stft as kstft
from test_torch_fft import pair_model
from test_torch_scan import _dft_regs, _snr, _ulps

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")
CPU = torch.device("cpu")
M = 16384  # Large<M>
T = M // 32  # threads a CTA
Q = M // 16  # 16-point DFTs of passes 1-3
NS = (1, 16, 256)  # Ns of passes 1-3; pass 4 has Ns = 4096, radix 4
L = 2 * M  # Bluestein's convolution on 2 CTAs; 4 CTAs take 2 L


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _w(tab, sign):
    """complex64 cos + i sign sin of a host (cos, sin) table."""
    return (tab[:, 0] + 1j * sign * tab[:, 1]).astype(np.complex64)


def _pad(a):
    return a + (a >> 4)


def large_passes(z, sign):
    """``Large<16384>::fft`` on axis 0 of (M, B) complex64: the buffer after
    each of the four passes, in the buffer's own layout (pass 1's padded).
    The twiddles come from ``kstft.large_pass_table``: dense W_256 and W_4096
    tables for passes 2 and 3; pass 4's W_M^j and its powers, by float32
    complex products as the kernel forms them."""
    tab = kstft.large_pass_table(CPU).numpy()
    w2, w3, w4 = (_w(tab[:256], sign), _w(tab[256:4352], sign),
                  tab[4352:, 0] + 1j * tab[4352:, 1])
    q, r4 = Q, M // 4096
    batch = z.shape[1:]
    ex = (1,) * len(batch)
    j = np.arange(q)
    out = []
    # pass 1: v[r] = z[j + Q r], no twiddle, output k to pad(16 j + k)
    y = _dft_regs(z.reshape((16, q) + batch), sign)  # [k][j]
    buf = np.zeros((M + M // 16,) + batch, np.complex64)
    buf[_pad(16 * j[None, :] + np.arange(16)[:, None])] = y
    out.append(buf.copy())
    for ns, w in ((16, w2), (256, w3)):
        src = np.arange(16)[:, None] * q + j[None, :]  # [r][j]
        v = buf[_pad(src) if ns == 16 else src]
        jm = j % ns
        v = v * w[jm[None, :] * np.arange(16)[:, None]].reshape((16, q) + ex)
        y = _dft_regs(v, sign)
        dst = (j // ns)[None, :] * 16 * ns + jm[None, :] + ns * np.arange(
            16)[:, None]
        buf = np.zeros_like(buf)
        buf[dst] = y
        out.append(buf.copy())
    j4 = np.arange(4096)
    src = np.arange(r4)[:, None] * 4096 + j4[None, :]
    pw = [np.ones(4096, np.complex64), w4.astype(np.complex64)]
    for _ in range(2, r4):
        pw.append((pw[-1] * pw[1]).astype(np.complex64))  # (W_M^j)^r
    tw4 = np.stack([(p_.real + 1j * sign * p_.imag).astype(np.complex64)
                    for p_ in pw])
    v = buf[src] * tw4.reshape((r4, 4096) + ex)
    buf = np.zeros_like(buf)
    buf[src] = _dft_regs(v, sign)  # output k to j + 4096 k: where it read
    out.append(buf)
    return out


def large_model(z, sign):
    """The transform's result: buf[0, M) after pass 4, natural order."""
    return large_passes(z, sign)[-1][:M]


def _rot4(a, e, sign):
    """fft_large.cuh's rot4: a * e^(sign 2 pi i e / 4), exactly."""
    e %= 4
    if e == 0:
        return a
    if e == 2:
        return -a
    s = sign if e == 1 else -sign  # a * (s i)
    out = np.empty_like(a)
    out.real, out.imag = -s * a.imag, s * a.real
    return out


def _mid_rows(length):
    """The cluster step's C - 1 rows (cos, sin)(2 pi r k / length), k < M,
    as the host tables hold them: ``twiddles`` of 32,768 for 2 CTAs,
    ``bluestein_table``'s last rows for 4."""
    if length == 2 * M:
        return kstft.twiddles(2 * M, CPU).numpy()[None]
    return kstft._bluestein_np(7, length)[7 + length + 8448:].reshape(
        length // M - 1, M, 2)


def cluster_model(z, sign):
    """``fft_cluster<16384, C>`` on (C M, B) complex64, C = len(z) / M: CTA
    r transforms z[C m + r] into its own buffer, Y_r; then CTA q reads every
    buffer at k (the only remote reads) and keeps X[k + q M] = sum_r W_C^(q
    r) (W_(CM)^(r k) Y_r[k]), the terms added in order of r."""
    c = z.shape[0] // M
    mid = [_w(row, sign).reshape((M,) + (1,) * (z.ndim - 1))
           for row in _mid_rows(c * M)]
    ys = [large_model(z[r::c], sign) for r in range(c)]
    parts = []
    for q in range(c):
        acc = ys[0]
        for r in range(1, c):
            acc = acc + _rot4(ys[r] * mid[r - 1], (4 // c) * q * r, sign)
        parts.append(acc)
    return np.concatenate(parts)


def _split(zk, zm, w):
    """fft_large.cuh's split_bin in float32."""
    h = np.float32(0.5)
    ex, ey = h * (zk.real + zm.real), h * (zk.imag - zm.imag)
    ox, oy = h * (zk.imag + zm.imag), -h * (zk.real - zm.real)
    wox, woy = w[:, 0] * ox + w[:, 1] * oy, w[:, 0] * oy - w[:, 1] * ox
    return (ex + wox) + 1j * (ey + woy)


def real_model(x, n):
    """``real_fft<N>`` on (n,) float32: the packed transform (the pair
    template's 8192 instance, Large<16384>, or the cluster of two at
    65,536), then the split for bins k < n / 2 from the size's one table."""
    m = n // 2
    tab = kstft.large_twiddles(n, CPU).numpy()
    z = (x[0::2] + 1j * x[1::2]).astype(np.complex64)[:, None]
    if n == 65536:
        zz = cluster_model(z, -1.0)
    elif m == 8192:
        zz = pair_model(z, -1.0, m)
    else:
        zz = large_model(z, -1.0)
    zz = zz[:, 0]
    k = np.arange(m)
    return _split(zz[k], zz[(m - k) % m], tab[len(tab) - m:])


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_large_model_is_the_dft_both_ways(sign):
    """Large<16384>'s model against np.fft.fft (sign -1) and the unscaled
    inverse (sign +1), < -120 dB, on two columns."""
    z = _noise((M, 2), 1)
    got = large_model(z, sign)
    z64 = z.astype(np.complex128)
    want = np.fft.fft(z64, axis=0) if sign < 0 else np.fft.ifft(
        z64, axis=0) * M
    assert _snr(got, want) < -120.0


@pytest.mark.parametrize("p", [1, 2, 3])
def test_large_passes_compute_their_partial_dfts(p):
    """After pass p (Ns' = 16^p points done) the buffer holds, at (j / Ns')
    Ns' * (M / Ns') ... in Stockham order, the Ns'-point DFTs of the
    decimated sequences z[s + (M / Ns') u]: output k of sub-sequence s at
    s * Ns' + k (pass 1's copy padded)."""
    z = _noise((M, 1), 2)
    buf = large_passes(z, -1.0)[p - 1]
    done = 16 ** p
    idx = (np.arange(M // done)[:, None] * done + np.arange(done)[None, :])
    got = buf[_pad(idx) if p == 1 else idx][..., 0]
    sub = z[:, 0].reshape(done, M // done).T  # [s][u] = z[s + (M/done) u]
    want = np.fft.fft(sub.astype(np.complex128), axis=1)
    assert _snr(got, want) < -125.0


@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_cluster_model_is_the_dft(sign, c):
    """The C-CTA transform of C M points (Large<16384> on each CTA; C = 2
    and 4) against np.fft.fft both ways."""
    z = _noise((c * M, 1), 3)
    got = cluster_model(z, sign)
    z64 = z.astype(np.complex128)
    want = np.fft.fft(z64, axis=0) if sign < 0 else np.fft.ifft(
        z64, axis=0) * c * M
    assert _snr(got, want) < -120.0


@pytest.mark.parametrize("n", kstft.LARGE_SIZES)
def test_real_model_matches_rfft(n):
    """Each real size's packed transform and split against float64 rfft of
    the same float32 frame, < -120 dB, bins k < n / 2."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = real_model(x, n)
    want = np.fft.rfft(x.astype(np.float64))[: n // 2]
    assert got.shape == (n // 2,) and _snr(got, want) < -120.0


def _banks_distinct(addr):
    """Each row of 16 float2 indices (one half-warp) on 16 distinct 8-byte
    bank pairs."""
    a = np.asarray(addr).reshape(-1, 16)
    return bool(np.all([len(set(row % 16)) == 16 for row in a]))


def _large_accesses():
    """Every shared-memory access of Large<16384>::fft, one array per
    unrolled step, threads in order (a half-warp is 16 consecutive)."""
    t = np.arange(T)
    acc = {}
    for h in (0, 1):
        j = t + T * h
        acc[f"p1w{h}"] = [_pad(16 * j + k) for k in range(16)]
        acc[f"p2r{h}"] = [_pad(j + Q * r) for r in range(16)]
        acc[f"p2w{h}"] = [(j // 16) * 256 + j % 16 + 16 * k for k in range(16)]
        acc[f"p3r{h}"] = [j + Q * r for r in range(16)]
        acc[f"p3w{h}"] = [(j // 256) * 4096 + j % 256 + 256 * k
                          for k in range(16)]
    for h in range(4096 // T):
        j = t + T * h
        acc[f"p4{h}"] = [j + 4096 * r for r in range(4)]
    return acc


def test_large_strides_keep_half_warps_on_distinct_banks():
    """Every access of the four passes, the cluster step (buf[k] and the
    peer's buf[k] at k = t + 512 i) and the split epilogues (Z[k],
    Z[M - k]) per half-warp on 16 distinct banks; each pass writes a
    permutation of the slots the next one reads, within kBuf."""
    acc = _large_accesses()
    assert all(_banks_distinct(a) for a in acc.values())
    t = np.arange(T)
    k = [t + T * i for i in range(M // T)]
    km = [(M - kk) % M for kk in k]
    assert _banks_distinct(k) and _banks_distinct(km)
    buf = M + M // 16
    for w, r in (("p1w", "p2r"), ("p2w", "p3r"), ("p3w", "p4")):
        hs = range(4096 // T) if r == "p4" else (0, 1)
        wr = np.ravel([acc[f"{w}{h}"] for h in (0, 1)])
        rd = np.ravel([acc[f"{r}{h}"] for h in hs])
        assert np.array_equal(np.sort(wr), np.sort(rd))
        assert len(np.unique(wr)) == M and wr.max() < buf


def test_large_header_constants():
    """fft_large.cuh's layout constants and the tables' offsets
    (RealPlan<N>) are those the models and kstft.large_twiddles use."""
    src = _read("fft_large.cuh")
    assert "static constexpr int kBuf = M + M / 16;" in src
    assert "buf[17 * j + k] = v[h][pairfft::brev(k, 4)];  // pad(16 j + k)" \
        in src
    assert "static constexpr int kTw2 = 0, kTw3 = 256, kTw4 = 256 + 4096;" \
        in src
    assert "static constexpr int kTwiddles = kTw4 + 4096;" in src
    assert "static constexpr int kCluster = N == 65536 ? 2 : 1;" in src
    assert "static_assert(M == 16384 " in src
    assert kstft.LARGE_M == M
    assert kstft.large_pass_table(CPU).shape == (8448, 2)
    assert "static constexpr bool kPair = kM <= 8192;" in src
    assert "using P = pairfft::Pair<kPair ? kM : 8192>;" in src
    for n in kcols.LARGE_SIZES:
        c = 2 if n == 65536 else 1  # RealPlan::kCluster
        m = n // 2 // c
        # RealPlan::kMid: kpv.pair_twiddles(m) (Pair<m>::kTwiddles) up to
        # 8192 packed points, else Large<16384>'s pass table
        mid = m + m // 16 if m <= 8192 else 8448
        split = mid + (m if c == 2 else 0)  # RealPlan::kSplit
        tab = kstft.large_twiddles(n, CPU)
        assert tab.shape[0] == split + n // 2
        assert torch.equal(tab[split:], kstft.twiddles(n, CPU))
        if c == 2:
            assert torch.equal(tab[mid:split], kstft.twiddles(2 * m, CPU))


@pytest.mark.parametrize("large,sibling", [
    ("mlx_stft_mag_large", "mlx_stft_mag_pair"),
    ("mlx_spectrogram_columns_large", "mlx_spectrogram_columns")])
def test_large_entries_take_their_siblings_arguments(large, sibling):
    """Each on-chip entry takes the same arguments as the entry of the route
    it sits beside (no plan argument), in the binding and in the source."""
    assert _build.SIGNATURES[large] == _build.SIGNATURES[sibling]
    src = _read("stft_mag_sizes.cu") + _read("spectrogram_columns.cu")

    def n_args(name):
        head = src[src.index(f'extern "C" int {name}('):]
        return head[: head.index(")")].count(",") + 1

    assert n_args(large) == n_args(sibling) == len(_build.SIGNATURES[large])


@pytest.mark.parametrize("n", kcols.LARGE_SIZES)
def test_large_twiddles_within_one_ulp_of_float64(n):
    """kstft.large_twiddles(n): the transform's table (the pair table of n /
    2 up to 16,384; the pass table of Large<16384>: W_256^x, W_4096^x,
    W_16384^j, j < 4096), the cluster step's W_32768^k (65,536 only) and the
    split's W_n^k, k < n / 2; <= 1 ulp of float64."""
    got = kstft.large_twiddles(n, CPU).numpy()
    if n <= 16384:
        pair = n // 2 + n // 32  # fft_pair.cuh's table, tested there
        head = [np.nan] * pair
        assert np.array_equal(got[:pair], kstft.__dict__["pair_twiddles"](
            n // 2, CPU).numpy())
    else:
        head = list(2 * np.pi * np.concatenate([
            np.arange(256) / 256, np.arange(4096) / 4096,
            np.arange(4096) / 16384]))
    if n == 65536:
        head += list(2 * np.pi * np.arange(16384) / 32768)
    ang = np.array(head + list(2 * np.pi * np.arange(n // 2) / n))
    keep = ~np.isnan(ang)
    assert got.shape == (len(ang), 2) and got.dtype == np.float32
    assert _ulps(got[keep, 0], np.cos(ang[keep])).max() <= 1.0
    assert _ulps(got[keep, 1], np.sin(ang[keep])).max() <= 1.0
    assert kstft.large_twiddles(n, CPU) is kstft.large_twiddles(n, CPU)
    with pytest.raises(ValueError, match="12288"):
        kstft.large_twiddles(12288, CPU)


# ----------------------------------------------------------------------
# Bluestein
# ----------------------------------------------------------------------


def _chirp64(n2):
    n = np.arange(n2, dtype=np.int64)
    return np.exp(1j * np.pi * ((n * n) % (2 * n2)) / n2)


@pytest.mark.parametrize("n2", [12289, 3, 5, 127, 1001, 16383])
def test_bluestein_identity_in_float64(n2):
    """X[k] = conj(b_k) sum_n (x_n conj(b_n)) b_(k-n), the convolution
    circular over L = 32,768 >= 2 N2 - 1, with the chirp's angle from n^2
    mod 2 N2 in int64: the DFT to float64 rounding (< -250 dB)."""
    x = _noise((n2,), n2).astype(np.complex128)
    b = _chirp64(n2)
    c = np.zeros(L, np.complex128)
    c[:n2] = b
    c[L - n2 + 1:] = b[1:][::-1]
    a = np.zeros(L, np.complex128)
    a[:n2] = x * np.conj(b)
    conv = np.fft.ifft(np.fft.fft(a) * np.fft.fft(c))
    got = np.conj(b) * conv[:n2]
    assert _snr(got, np.fft.fft(x)) < -250.0


def bluestein_model(xa, xb, n2, length=None):
    """``four_step_column_bluestein<C>`` on two real columns in float32, L =
    ``length`` (by default C M, C = ``kstft.bluestein_cluster(n2)``): z =
    x_a + i x_b times conj(b_n), zero to L; the cluster's forward transform,
    its epilogue the product with the table's spectrum; the inverse by
    decimation in frequency (CTA q: sum_j W_C^(-q j) P[n + j M], times
    W_L^(-q n) for q > 0, to the outputs C m + q); Z = conj(b_k) conv[k];
    the two columns' bins k <= N2 / 2 apart."""
    length = length or kstft.bluestein_cluster(n2) * M
    c = length // M
    tab = kstft._bluestein_np(n2, length)
    chirp = _w(tab[:n2], 1.0)
    spec = _w(tab[n2: n2 + length], 1.0)
    mid = [_w(row, 1.0) for row in _mid_rows(length)]
    np.testing.assert_array_equal(tab[n2 + length + 8448:].reshape(
        c - 1, M, 2), _mid_rows(length))
    z = (xa + 1j * xb).astype(np.complex64)
    a = np.zeros((length, 1), np.complex64)
    a[:n2, 0] = z * np.conj(chirp)
    p = cluster_model(a, -1.0)[:, 0] * spec
    conv = np.empty(length, np.complex64)
    for q in range(c):
        acc = p[:M]
        for j in range(1, c):
            acc = acc + _rot4(p[j * M: (j + 1) * M], (4 // c) * q * j, 1.0)
        if q:
            acc = acc * mid[q - 1]
        conv[q::c] = large_model(acc[:, None], 1.0)[:, 0]
    zz = np.conj(chirp) * conv[:n2]
    k = np.arange(n2 // 2 + 1)
    zk, zm = zz[k], zz[(n2 - k) % n2]
    half = np.float32(0.5)
    ca = half * (zk + np.conj(zm))
    cb = (half * (zk.imag + zm.imag)) - 1j * (half * (zk.real - zm.real))
    return ca, cb


@pytest.mark.parametrize("n2,length", [
    (12289, None), (7, None), (4099, None),
    (16411, None), (16385, None), (32749, None), (7, 4 * M)])
def test_bluestein_model_matches_rfft(n2, length):
    """The kernel's float32 transcription against float64 rfft of each real
    column (< -110 dB), on 2 CTAs (L = 32,768, N2 <= 16,384) and on 4 (L =
    65,536: N2 above 16,384, and N2 = 7 forced there): Bluestein's float32
    error stays far under the kernel's bars (-80 dB against the twin, -60
    against float64)."""
    rng = np.random.default_rng(n2)
    xa, xb = rng.standard_normal((2, n2)).astype(np.float32)
    ca, cb = bluestein_model(xa, xb, n2, length)
    for got, x in ((ca, xa), (cb, xb)):
        want = np.fft.rfft(x.astype(np.float64))
        assert got.shape == want.shape and _snr(got, want) < -110.0


@pytest.mark.parametrize("n2", [12289, 5, 16411, 32768])
def test_bluestein_table_within_one_ulp_of_float64(n2):
    """kstft.bluestein_table(n2), L = 32,768 up to N2 = 16,384 and 65,536
    above: the chirp from int64 n^2 mod 2 n2, the kernel's spectrum (float64
    FFT / L) and the cluster transform's tables (the pass table, then C - 1
    rows W_L^(r k)), each entry within 1 ulp of its float64 value (the
    spectrum: within 1 ulp of its largest entry); no N2 above 32,768."""
    c = kstft.bluestein_cluster(n2)
    length = c * M
    got = kstft.bluestein_table(n2, CPU).numpy()
    assert c == (2 if n2 <= M else 4)
    assert got.shape == (n2 + length + 8448 + (c - 1) * M, 2)
    assert got.dtype == np.float32
    b = _chirp64(n2)
    assert _ulps(got[:n2, 0], b.real).max() <= 1.0
    assert _ulps(got[:n2, 1], b.imag).max() <= 1.0
    cc = np.zeros(length, np.complex128)
    cc[:n2] = b
    cc[length - n2 + 1:] = b[1:][::-1]
    spec = np.fft.fft(cc) / length
    top = np.spacing(np.float32(np.abs(spec).max()))
    err = np.abs(got[n2: n2 + length, 0] + 1j * got[n2: n2 + length, 1]
                 - spec)
    assert err.max() <= top
    head = n2 + length + 8448
    assert np.array_equal(got[n2 + length: head],
                          kstft.large_pass_table(CPU).numpy())
    ang = 2 * np.pi * (np.arange(1, c)[:, None] * np.arange(M)).ravel(
        ) / length
    assert _ulps(got[head:, 0], np.cos(ang)).max() <= 1.0
    assert _ulps(got[head:, 1], np.sin(ang)).max() <= 1.0
    if c == 2:  # exactly twiddles(32,768)
        assert np.array_equal(got[head:], kstft.twiddles(L, CPU).numpy())
    for bad in (32769, 0):
        with pytest.raises(ValueError, match="32768"):
            kstft.bluestein_table(bad, CPU)


def test_bluestein_header_constants():
    """fft_fourstep.cuh's Bluestein lengths, cap, cluster choice and table
    offsets are the wrapper's."""
    src = _read("fft_fourstep.cuh")
    assert "constexpr int kBluesteinM = 16384;" in src
    assert "constexpr int kBluesteinMax = 2 * kBluesteinM;" in src
    assert "return n2 <= kBluesteinM ? 2 : 4;" in src
    assert "static constexpr int kL = C * kBluesteinM;" in src
    assert "static constexpr int kSpec = 0, kTw = kL;" in src
    assert ("static constexpr int kMid = kTw + large::Large<kBluesteinM>"
            "::kTwiddles;") in src
    assert "static constexpr int kTable = kMid + (C - 1) * kBluesteinM;" \
        in src
    assert kstft.LARGE_M == M and kstft.BLUESTEIN_MAX == 2 * M
    for n2 in (1, M, M + 1, 2 * M):
        c = kstft.bluestein_cluster(n2)
        assert kstft.bluestein_table(n2, CPU).shape[0] == n2 + c * M + 8448 \
            + (c - 1) * M


# ----------------------------------------------------------------------
# Routes and entries
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,b12,b7", [
    (1024, "pair", "large"), (1536, "tile", None), (2048, "pair", "large"),
    (3072, "tile", "tile"), (4096, "pair", "large"),
    (7168, "tile", "tile"), (8192, "pair", "large"),
    (9216, "tile", "tile"), (15360, "tile", "tile"),
    (16384, "large", "large"), (17408, "tile", "tile"),
    (31744, "tile", "tile"), (32768, "large", "large"),
    (33792, "tile", "tile"), (48128, "tile", "tile"),
    (49152, "tile", "tile"), (50176, "four_step", "cluster"),
    (64512, "four_step", "cluster"), (65536, "large", "large"),
    (98304, "four_step", None), (131072, "four_step", None),
    (512 * 12289, "bluestein", None), (1024 * 16381, "bluestein", None),
    (512 * 16387, "bluestein", None),
    (512 * 99999, "bluestein_scratch", None),
    (512 * 16411, "bluestein", None), (512 * 32749, "bluestein", None),
    (512 * 32771, "bluestein_scratch", None),
    (512 * 65537, "bluestein_scratch", None),
    (1 << 30, "bluestein_scratch", None),
])
def test_routes_by_size(size, b12, b7):
    """kstft.route and kcols.route at every supported size around 1024 ...
    8192, 16,384, 32,768, 49,152 and 65,536 (B7's powers of two on chip,
    the other sizes up to 49,152 on the frame tile, 1024 j, j = 49 .. 63, on
    the cluster route; B12 keeps the pair route up to 8192 and the
    four-step route above 49,152), and the four-step columns' three forms
    (FFT tiles, Bluestein up to N2 = 32,768 on 2 CTAs up to 16,384 and 4
    above, Bluestein through scratch above); no route is ``"direct"`` or
    ``"one_block"``."""
    assert kstft.route(size) == b12
    assert kcols.supported(size) == (b7 is not None)
    if b7 is not None:
        assert kcols.route(size) == b7
    if b12 in ("bluestein", "bluestein_scratch"):
        n2 = kstft.four_step_plan(size)[1]
        assert kstft.four_step_bluestein(n2)
        assert (n2 <= kstft.BLUESTEIN_MAX) == (b12 == "bluestein")
        if b12 == "bluestein":
            assert kstft.bluestein_cluster(n2) == (2 if n2 <= M else 4)
        else:
            sp = kstft.bluestein_scratch_plan(n2)
            assert sp["l"] >= 2 * n2 - 1 and 8 <= sp["c"] <= 512


class _Recorder:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []
        self.code = 0  # what every entry returns

    def __getattr__(self, name):
        if name == "mlx_error_string":  # what _build.check reads, unrecorded
            return lambda err: b"refused"
        return lambda *args: self.calls.append((name, args)) or self.code


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on ``meta`` tensors with a recording
    library."""
    rec = _Recorder()
    for fn in (kstft.stft_mag, kcols.spectrogram_columns_fused):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return rec


@pytest.mark.parametrize("size", kstft.LARGE_SIZES)
def test_large_sizes_launch_the_large_entries(fake_cuda, size):
    """B12 and B7 at each on-chip size: one call of ``mlx_stft_mag_large``
    / ``mlx_spectrogram_columns_large`` with (count, size, ...), one launch
    each."""
    meta = torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    b12, b7 = kstft.stft_mag.launches, kcols.spectrogram_columns_fused.launches
    out = kstft.stft_mag(wav, torch.zeros(size).to(meta), size, size // 8, 6)
    assert out.shape == (6, size // 2)
    ends = torch.zeros(5, dtype=torch.int32).to(meta)
    cols = kcols.spectrogram_columns_fused(wav, ends, ends, 1.0, size=size,
                                           colormap=False)
    assert cols.shape == (5, size // 2) and cols.dtype == torch.float32
    (n12, a12), (n7, a7) = fake_cuda.calls
    assert n12 == "mlx_stft_mag_large" and a12[5:9] == (6, size, size // 8,
                                                        1.0)
    assert n7 == "mlx_spectrogram_columns_large" and a7[6:8] == (5, size)
    assert kstft.stft_mag.launches == b12 + 1
    assert kcols.spectrogram_columns_fused.launches == b7 + 1


def test_bluestein_size_launches_the_bluestein_entry(fake_cuda):
    """B12 at 512 * 12,289 (2 CTAs), 512 * 16,411 and 512 * 32,749 (4
    CTAs): one call each of ``mlx_stft_mag_bluestein`` with the four-step
    plan (n_frames, size, N1, hop), one launch each; above N2 = 32,768 (512
    * 32,771, 512 * 65,537) one call each of
    ``mlx_stft_mag_bluestein_scratch`` with the same plan after its work
    space, and ``mlx_stft_mag_4step`` is not called for them."""
    meta = torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    before = kstft.stft_mag.launches
    for size, entry in ((512 * 12289, "mlx_stft_mag_bluestein"),
                        (512 * 16411, "mlx_stft_mag_bluestein"),
                        (512 * 32749, "mlx_stft_mag_bluestein"),
                        (512 * 32771, "mlx_stft_mag_bluestein_scratch"),
                        (512 * 65537, "mlx_stft_mag_bluestein_scratch")):
        kstft.stft_mag(wav, torch.zeros(size).to(meta), size, size // 4, 3)
        name, args = fake_cuda.calls[-1]
        plan = args[8:12] if entry.endswith("scratch") else args[7:11]
        assert name == entry and plan == (3, size, 512, size // 4)
    assert len(fake_cuda.calls) == 5
    assert "mlx_stft_mag_4step" not in [n for n, _ in fake_cuda.calls]
    assert kstft.stft_mag.launches == before + 5


def test_refused_bluestein_launch_raises(fake_cuda, monkeypatch):
    """A code the C entry returns (here cudaErrorLaunchOutOfResources, 7:
    no GPC holds a 4-CTA cluster) raises after its one call, and nothing
    else is called: no scratch route, no four-step route, no CPU twin; the
    launch is not counted."""
    meta = torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    size = 512 * 16411
    monkeypatch.setattr(fake_cuda, "code", 7, raising=False)
    before = kstft.stft_mag.launches
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        kstft.stft_mag(wav, torch.zeros(size).to(meta), size, size // 4, 2)
    assert [n for n, _ in fake_cuda.calls] == ["mlx_stft_mag_bluestein"]
    assert kstft.stft_mag.launches == before


def test_refused_scratch_launch_raises(fake_cuda, monkeypatch):
    """A code the scratch entry returns (cudaErrorInvalidValue, 1: an unfit
    plan, or a refused launch) raises after its one call; no other entry
    and no twin is called, and the launch is not counted."""
    meta = torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    size = 512 * 32771
    monkeypatch.setattr(fake_cuda, "code", 1, raising=False)
    before = kstft.stft_mag.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kstft.stft_mag(wav, torch.zeros(size).to(meta), size, size // 4, 2)
    assert [n for n, _ in fake_cuda.calls] == [
        "mlx_stft_mag_bluestein_scratch"]
    assert kstft.stft_mag.launches == before


def test_scratch_entry_takes_the_work_space(fake_cuda):
    """The scratch entry's binding: (wav, n, win, tw, tab, scratch, work,
    out, n_frames, size, n1, hop, scale, stream), the work space holding
    min(pairs, 512 MiB / (8 L)) pairs of L float2: 512 pairs of 1 MiB at 512
    * 32,771 (one chunk), 256 of 2 MiB at 512 * 65,537 (two chunks of the
    512 pairs of 2 frames)."""
    assert len(_build.SIGNATURES["mlx_stft_mag_bluestein_scratch"]) == 14
    src = _read("stft_mag_sizes.cu")
    head = src[src.index('extern "C" int mlx_stft_mag_bluestein_scratch('):]
    assert head[: head.index(")")].count(",") + 1 == 14
    meta = torch.device("meta")
    for n2, pairs in ((32771, 512), (65537, 256)):
        work = kstft.bluestein_work(2, 512, n2, meta)
        length = kstft.bluestein_scratch_plan(n2)["l"]
        assert work.shape == (pairs, length, 2)
        assert work.numel() * 4 <= kstft.BLUESTEIN_WORK
