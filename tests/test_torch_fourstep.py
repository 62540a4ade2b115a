"""B12's four-step route and its Bluestein columns through scratch, modelled
on the CPU.

``csrc/fft_fourstep.cuh`` (the coalesced column and row tiles, the batched
Stockham they share with the Bluestein middle step, the Bluestein columns
through device scratch) runs only on the card (chip_smoke.py phase 19 holds
its kernels against their twins there).  These tests hold what the design
rests on:

* a NumPy transcription of ``tiles::batch_fft`` (radix-16 passes, then one
  of 8, 4 or 2, in the kernel's index order, the float32 constants of
  ``dft_regs``) against ``np.fft.fft`` at every P it takes;
* the column tile (decimation by m, packed real sub-transforms, the split,
  the m-point sums with their output map) and the row tile (coarse-fine
  twiddle, Stockham, |X|) in float32 against float64 ``rfft`` at 98,304,
  131,072 and 1,048,576 points, and the output map storing every bin once
  at every (B, m) shape;
* every warp's global loads and stores of the tiles covering whole 32-byte
  sectors, every half-warp's shared-memory accesses on distinct banks, and
  every plan's shared memory within the CTA's 227 KB;
* the Bluestein columns through scratch: the three kernels and the split in
  float32, generic over the level-one size M (64 runs C = 8 ... 512; M =
  16,384 at N2 = 32,771 once), against float64 ``np.fft.fft``; the host
  table within one ulp of float64;
* the header constants the wrappers mirror.
"""

import os

import numpy as np
import pytest
import torch

from melonix_tpu_torch.kernels import stft as kstft
from test_torch_fft_large import large_model
from test_torch_scan import _dft_regs, _snr, _ulps

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")
CPU = torch.device("cpu")
SMEM_MAX = 232448


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _w(tab, sign=-1.0):
    """complex64 cos + i sign sin of a host (cos, sin) table."""
    return (tab[..., 0] + 1j * sign * tab[..., 1]).astype(np.complex64)


def _c(tab):
    """complex64 cos + i sin."""
    return _w(tab, 1.0)


def _passes(p):
    """The radices ``batch_fft`` runs for P points: 16 while 16 more fit,
    then the rest (8, 4 or 2) if any."""
    out, ns = [], 1
    while ns * 16 <= p:
        out.append(16)
        ns *= 16
    if p // ns > 1:
        out.append(p // ns)
    return out


def batch_fft_model(z, sign, tw):
    """``tiles::batch_fft`` on axis 1 of (NS, P) complex64: radix-R
    Stockham passes, item (q, j) reading j + (P / R) a, twiddling point a by
    W_P^((j mod Ns) a P / (R Ns)) from the (P, 2) table, writing output k to
    (j / Ns) R Ns + (j mod Ns) + Ns k."""
    nseq, p = z.shape
    w = _w(tw, sign)
    buf = z.astype(np.complex64).copy()
    ns = 1
    for r in _passes(p):
        per = p // r
        j = np.arange(per)
        jm = j % ns
        v = buf[:, j[None, :] + per * np.arange(r)[:, None]]  # [q][a][j]
        tws = w[(jm[None, :] * np.arange(r)[:, None] * (p // (r * ns)))]
        v = (v * tws[None]).astype(np.complex64)
        y = _dft_regs(np.moveaxis(v, 1, 0), sign)  # [k][q][j]
        dst = (j - jm)[None, :] * r + jm[None, :] + ns * np.arange(r)[:, None]
        out = np.empty_like(buf)
        out[:, dst] = np.moveaxis(y, 0, 1)
        buf = out
        ns *= r
    return buf


@pytest.mark.parametrize("p", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                               2048, 8192, 16384])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_batch_fft_model_is_the_dft(p, sign):
    """The batched Stockham at every radix mix it runs against
    np.fft.fft (sign -1) and the unscaled inverse (+1), < -125 dB."""
    rng = np.random.default_rng(p)
    nseq = max(1, 4096 // p)
    z = (rng.standard_normal((nseq, p)) + 1j * rng.standard_normal(
        (nseq, p))).astype(np.complex64)
    got = batch_fft_model(z, sign, kstft.unit_roots(p, p))
    z64 = z.astype(np.complex128)
    want = np.fft.fft(z64, axis=1) if sign < 0 else np.fft.ifft(
        z64, axis=1) * p
    assert _snr(got, want) < -125.0


# ----------------------------------------------------------------------
# Column and row tiles
# ----------------------------------------------------------------------


def _coarse_fine(tab, log_f, x, n_fine_off=0):
    """(cos, sin) of the coarse-fine product W^x as the kernel forms it in
    float32 (fine at n_fine_off, coarse after 2^log_f entries)."""
    fine = tab[n_fine_off: n_fine_off + (1 << log_f)]
    coarse = tab[n_fine_off + (1 << log_f):]
    a, b = coarse[x >> log_f], fine[x & ((1 << log_f) - 1)]
    return np.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                     a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]],
                    axis=-1).astype(np.float32)


def column_model(cols, n2):
    """``four_step_columns`` on (N2, J) float32 real columns (column j =
    x[n1_0 + j + N1 n2]): C[k2, j] for k2 <= N2 / 2, complex64, the
    kernel's float32 steps and its output map."""
    ct = kstft.column_tile(n2)
    m, b, p, h = ct["m"], ct["b"], ct["p"], (ct["m"] - 1) // 2
    tab = kstft.four_step_column_table(n2, CPU).numpy()
    wp, wn2, wm = tab[:p], tab[p: p + n2 // 2], tab[p + n2 // 2:]
    nj = cols.shape[1]
    # x_s[n] = x[n m + s]; z_s[q] = x_s[2q] + i x_s[2q + 1]
    xs = cols.reshape(b, m, nj)  # [n][s][j]
    z = (xs[0::2] + 1j * xs[1::2]).astype(np.complex64)  # [q][s][j]
    zz = batch_fft_model(z.reshape(p, m * nj).T, -1.0, wp).T.reshape(
        p, m, nj)
    half = np.float32(0.5)
    sub = np.arange(m)[None, :, None]
    k = np.arange(1, p // 2)[:, None, None] if p > 2 else np.zeros(
        (0, 1, 1), np.int64)
    x_out = np.zeros((p + 1, m, nj), np.complex64)  # X_s[k1] W_N2^(s k1)
    z0 = zz[0]
    x_out[0] = z0.real + z0.imag
    x_p = (z0.real - z0.imag).astype(np.float32)  # X_s[P], real
    zq = zz[p // 2]
    x_out[p // 2] = np.conj(zq) * _w(wn2[sub[0] * (p // 2)])
    if len(k):
        zk, zm = zz[k[:, 0, 0]], zz[p - k[:, 0, 0]]
        w = wn2[(k * m)[:, :, 0]][:, :, None, :]
        ex, ey = half * (zk.real + zm.real), half * (zk.imag - zm.imag)
        ox, oy = half * (zk.imag + zm.imag), -half * (zk.real - zm.real)
        wox = w[..., 0] * ox + w[..., 1] * oy
        woy = w[..., 0] * oy - w[..., 1] * ox
        x_out[k[:, 0, 0]] = ((ex + wox) + 1j * (ey + woy)).astype(
            np.complex64) * _w(wn2[sub * k])
        x_out[p - k[:, 0, 0]] = ((ex - wox) + 1j * (woy - ey)).astype(
            np.complex64) * _w(wn2[sub * (p - k)])
    x_out[p] = x_p * _w(wn2[sub[0] * p])
    # the m-point sums, terms in order of s, and the output map
    out = np.full((n2 // 2 + 1, nj), np.nan + 0j, np.complex64)
    seen = np.zeros(n2 // 2 + 1, np.int64)

    def put(kk, v):
        if kk <= n2 // 2:
            out[kk] = v
            seen[kk] += 1

    wmc = _w(wm)
    for k1 in range(p + 1):
        v = x_out[k1]  # [s][j]
        put(k1, v.sum(axis=0, dtype=np.complex64))
        for pp in range(1, h + 1):
            q = (np.arange(m) * pp) % m
            yp = (v * wmc[q][:, None]).sum(axis=0, dtype=np.complex64)
            ym = (v * np.conj(wmc[q])[:, None]).sum(axis=0,
                                                   dtype=np.complex64)
            put(k1 + b * pp, yp)
            put(k1 + b * (m - pp), ym)
            if 0 < k1 < p:
                put(b - k1 + b * (m - 1 - pp), np.conj(yp))
                put(b - k1 + b * (pp - 1), np.conj(ym))
    assert np.array_equal(seen, np.ones_like(seen)), "each bin stored once"
    return out


def rows_model(c, size, n1):
    """``four_step_rows`` on (N2 / 2 + 1, N1) complex64 C: the twiddle
    W_N^(n1 k2) from the coarse-fine table (rows above N2 / 2 the mirror),
    the complex N1-point Stockham, bins k2 + N2 k1 below N / 2."""
    n2 = size // n1
    tab = kstft.four_step_twiddles(size, n1, CPU).numpy()
    log_f = ((size - 1).bit_length() - 1 + 2) // 2
    n_coarse = -(-size // (1 << log_f))
    head = (1 << log_f) + n_coarse
    tw, passes = tab[:head], tab[head: head + n1]
    lanes = tab[head + n1:].reshape(n1, kstft.ROW_LANES, 2)
    kt = kstft.row_tile(n1)["k"]
    k2 = np.arange(n2)
    mirror = k2 > n2 // 2
    src = np.where(mirror, n2 - k2, k2)
    rows = c[src]
    rows = np.where(mirror[:, None], np.conj(rows), rows)
    # the tile's W_N^(n1 base) (coarse * fine) times the lane table's
    # W_N^(+-n1 d): base k2_0 (direct) or N2 - k2_0 (mirror), d = src - k2_0
    k2_0 = src // kt * kt
    base = np.where(mirror, n2 - k2_0, k2_0)
    n1s = np.arange(n1)
    a = _coarse_fine(tw, log_f, base[:, None] * n1s[None, :])
    b = lanes[n1s[None, :], (src - k2_0)[:, None]]
    b = np.where(mirror[:, None, None], b * np.float32([1, -1]), b)
    w = np.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                  a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], -1)
    y = (rows * _w(w.astype(np.float32))).astype(np.complex64)
    xk = batch_fft_model(y, -1.0, passes)  # [k2][k1]
    return xk.T.reshape(-1)[: size // 2]  # X[k2 + N2 k1]


@pytest.mark.parametrize("size", [98304, 131072, 1 << 20])
def test_tiles_model_matches_rfft(size):
    """The column tiles then the row tiles of one windowed frame, float32,
    against float64 rfft of the same float32 frame: < -110 dB over the
    bins below N / 2 (the kernel's bar is -80 dB against its twin)."""
    n1, n2 = kstft.four_step_plan(size)
    assert kstft.route(size) == "four_step"
    rng = np.random.default_rng(size)
    x = (rng.standard_normal(size) * np.hanning(size)).astype(np.float32)
    c = column_model(x.reshape(n2, n1), n2)
    got = rows_model(c, size, n1)
    want = np.fft.rfft(x.astype(np.float64))[: size // 2]
    assert _snr(got, want) < -110.0


@pytest.mark.parametrize("n2", [388, 12, 20, 4 * 97, 8 * 3, 256, 3 * 128,
                                4 * 12287, 1 << 15, 3 << 14])
def test_column_output_map_stores_every_bin_once(n2):
    """At every (B, m) shape, from B = 4 with m up to 12,287 to m = 1 at
    32,768: the column model stores each bin k2 <= N2 / 2 exactly once
    (asserted inside) and matches float64 rfft (< -110 dB)."""
    rng = np.random.default_rng(n2)
    nj = 2 if n2 > 4096 else 4
    cols = rng.standard_normal((n2, nj)).astype(np.float32)
    if n2 > 20000 and kstft.column_tile(n2)["m"] > 100:
        cols = cols[:, :1]  # the m-point sums are O(N2 m): one column
    got = column_model(cols, n2)
    want = np.fft.rfft(cols.astype(np.float64), axis=0)
    assert _snr(got, want) < -110.0


@pytest.mark.parametrize("n1,n2", [(256, 384), (512, 256), (1024, 1024),
                                   (512, 32771), (512, 12289), (16384, 65536),
                                   (16384, 32768), (128, 388)])
def test_row_tiles_give_every_row_once(n1, n2):
    """``four_step_rows``'s map from tiles and sequences to output rows: with
    mirrors paired (N1 <= 8192) sequence kk < K is row k2_0 + kk (k2 <= N2 /
    2) and K + kk its mirror N2 - k2 (none for k2 = 0 and 2 k2 = N2); at N1
    = 16,384 a tile is row k2 < N2.  Every row k2 < N2, even or odd N2, once."""
    rt = kstft.row_tile(n1)
    k, pair = rt["k"], rt["pair"]
    last = n2 // 2 if pair else n2 - 1
    tiles = (last + 1 + k - 1) // k
    seen = np.zeros(n2, np.int64)
    for tile in range(tiles):
        for q in range(rt["seqs"]):
            k2 = tile * k + (q if q < k else q - k)
            if k2 > last:
                continue
            if q < k:
                seen[k2] += 1
            elif k2 > 0 and 2 * k2 != n2:
                seen[n2 - k2] += 1
    assert np.array_equal(seen, np.ones(n2, np.int64))


def _sectors_whole(addr_bytes, width):
    """Every 32-byte sector the accesses touch is covered whole."""
    a = np.asarray(addr_bytes, np.int64)
    cover = {}
    for x in a:
        for b in range(x, x + width):
            cover.setdefault(b // 32, set()).add(b % 32)
    return all(len(v) == 32 for v in cover.values())


def _banks_distinct(addr, width=8):
    """Each half-warp's accesses (16 consecutive lanes, ``width``-byte
    words at these word indices) on distinct banks."""
    a = np.asarray(addr).reshape(-1, 16)
    words = 16 if width == 8 else 32
    return bool(np.all([len(set(row % words)) == 16 for row in a]))


PLANS = [98304, 131072, 1 << 20]


@pytest.mark.parametrize("size", PLANS)
def test_tile_global_accesses_cover_whole_sectors(size):
    """Per warp (32 consecutive threads of a tile CTA), at the timed plans: the column tile's sample loads (4 bytes, frame start 128-aligned)
    and its scratch stores (8 bytes), the row tile's scratch loads and its
    bin stores (4 bytes) touch only whole 32-byte sectors."""
    n1, n2 = kstft.four_step_plan(size)
    ct, rt = kstft.column_tile(n2), kstft.row_tile(n1)
    t_, k_ = ct["t"], rt["k"]
    lanes = np.arange(32)
    for w0 in range(0, 512, 32):
        for it in range(0, n2 * t_, ct["config"][0]):
            idx = it + w0 + lanes
            idx = idx[idx < n2 * t_]
            j, r = idx % t_, idx // t_
            assert _sectors_whole(4 * (j + n1 * r), 4)  # n1_0 = 0
        # scratch stores: lanes share (k1, grp), j consecutive
        g = w0 + lanes
        j = g % t_
        for row in np.unique(g // t_):
            assert _sectors_whole(8 * (row * n1 + j[g // t_ == row]), 8)
        for it in range(0, k_ * n1, rt["config"][0]):
            idx = it + w0 + lanes
            kk, nn = idx // n1, idx % n1
            assert _sectors_whole(8 * (kk * n1 + nn), 8)
        seqs = rt["seqs"]
        for it in range(0, seqs * n1, rt["config"][0]):
            idx = it + w0 + lanes
            q, k1 = idx % seqs, idx // seqs  # tile 1: source rows k_ .. 2k_-1
            for kk1 in np.unique(k1):
                sel = (k1 == kk1) & (q < k_)
                assert _sectors_whole(4 * (k_ + q[sel] + n2 * kk1), 4)
                mir = 4 * (n2 - (k_ + q[(k1 == kk1) & (q >= k_)] - k_)
                           + n2 * kk1)
                if len(mir):  # a descending run: whole but for its ends
                    assert len(np.unique(mir // 32)) <= len(mir) * 4 // 32 + 2


def _pass_addrs(nseq, s, p, config):
    """Every shared-memory access of ``batch_fft``'s passes over nseq
    sequences (batches of threads x points / p), one array per unrolled (e,
    a) read and (e, k) write, threads in order."""
    kt, pts = config
    t = np.arange(kt)
    out = []
    per_batch = kt * pts // p
    for q0 in range(0, nseq, per_batch):
        nq = min(per_batch, nseq - q0)
        ns = 1
        for r in _passes(p):
            per = p // r
            for e in range(pts // r):
                g = t + kt * e
                g = g[g < nq * per]
                q, j = q0 + g % nq, g // nq
                jm = j % ns
                for a in range(r):
                    out.append(q * s + j + per * a)
                    out.append(q * s + (j - jm) * r + jm + ns * a)
            ns *= r
    return out


@pytest.mark.parametrize("size", PLANS)
def test_tile_shared_accesses_on_distinct_banks(size):
    """Per half-warp at the timed plans: the column tile's staging stores
    (4-byte, sub-sequence stride S odd), its Stockham passes, split and
    m-point sums; the row tile's staging, passes and bin reads; the
    Bluestein middle step at every C: 16 distinct banks."""
    n1, n2 = kstft.four_step_plan(size)
    ct, rt = kstft.column_tile(n2), kstft.row_tile(n1)
    t_, m, p, s = ct["t"], ct["m"], ct["p"], ct["s"]
    assert s % 2 == 1 and rt["s"] % 2 == 1
    t = np.arange(ct["config"][0])
    # staging: float index 2 ((sub T + j) S + nn / 2) + nn % 2
    j, r = t % t_, t // t_
    assert _banks_distinct(2 * (((r % m) * t_ + j) * s + (r // m) // 2)
                           + (r // m) % 2, 4)
    seqs = t_ * m
    assert all(_banks_distinct(a)
               for a in _pass_addrs(seqs, s, p, ct["config"]))
    g = t[: seqs * max(p // 2, 1) // 16 * 16]
    assert _banks_distinct((g % seqs) * s + g // seqs)
    j, k1 = t % t_, (t // t_) % (p + 1)  # the m-point sums
    assert _banks_distinct(j * s + np.where(k1 == p, 0, k1))
    k_, s_, seqs = rt["k"], rt["s"], rt["seqs"]
    idx = np.arange(rt["config"][0])
    assert _banks_distinct((idx // n1) * s_ + idx % n1)
    assert _banks_distinct((k_ + idx // n1) * s_ + idx % n1)  # the mirrors
    assert all(_banks_distinct(a)
               for a in _pass_addrs(seqs, s_, n1, rt["config"]))
    assert _banks_distinct((idx % seqs) * s_ + idx // seqs)
    for c in (32, 64, 128, 256):  # the middle step's Stockham, 256 threads
        kt_, sc = 8192 // c, c + 1
        idx = np.arange(256)
        assert _banks_distinct((idx % kt_) * sc + idx // kt_)
        assert all(_banks_distinct(a)
                   for a in _pass_addrs(kt_, sc, c, (256, 16)))


def test_every_plan_fits_shared_memory():
    """Every column N2 the tiles take (N2 % 4 == 0, up to MAX_SIZE), every
    row N1 (2 ... MAX_N1) and every Bluestein middle C: the CTA's shared
    memory within 227 KB and a sequence within a batch (P <= threads x
    points a thread)."""
    for n2 in range(4, kstft.MAX_SIZE + 1, 4):
        ct = kstft.column_tile(n2)
        assert ct["smem"] <= SMEM_MAX, n2
        assert ct["p"] <= ct["config"][0] * ct["config"][1], n2
        assert ct["t"] >= 1 and ct["b"] * ct["m"] == n2
    for lg in range(1, 15):
        rt = kstft.row_tile(1 << lg)
        assert rt["smem"] <= SMEM_MAX and rt["k"] >= 1
        assert rt["seqs"] & (rt["seqs"] - 1) == 0
        assert (1 << lg) <= rt["config"][0] * rt["config"][1]
    for c in (8, 16, 32, 64, 128, 256, 512):
        assert (8192 // c) * (c + 1) * 8 <= SMEM_MAX and c <= 256 * 16


def test_tile_header_constants():
    """fft_fourstep.cuh's tile rules and the wrappers' mirrors agree; the
    radix plan multiplies out to P in ceil(log16 P) passes."""
    for bits in range(1, 15):
        rs = _passes(1 << bits)
        assert np.prod(rs) == 1 << bits and len(rs) == (bits + 3) // 4
    src = _read("fft_fourstep.cuh")
    for line in (
            "constexpr size_t kSmemMax = 232448;",
            "return p <= 256 ? 0 : p <= 512 ? 1 : 2;",
            "for (; ns * 16 <= P; ns *= 16) {",
            "const int budget = c.p <= 256 ? 4096 : c.p <= 512 ? 8192 : 16384;",
            "while (c.t > 1 && c.t * (n2 / 2) > budget) c.t /= 2;",
            "r.k = n1 <= 1024 ? 8 : r.pair ? 8192 / n1 : 1;",
            "r.pair = n1 <= 8192;",
            "f.log_f = (ilog2_floor(n - 1) + 2) / 2;",
            "sp.log_f = (ilog2_floor(sp.l) + 1) / 2;",
            "constexpr long long kWorkBytes = 1LL << 29;",
            "__host__ __device__ constexpr int mid_tile(int c) "
            "{ return 8192 / c; }"):
        assert line in src, line
    assert "fft_real.cuh" not in src.split("#pragma once")[1]
    assert kstft.BLUESTEIN_WORK == 1 << 29 and kstft.SMEM_MAX == SMEM_MAX


# ----------------------------------------------------------------------
# Bluestein through scratch
# ----------------------------------------------------------------------


def _chirp64(n2):
    n = np.arange(n2, dtype=np.int64)
    return np.exp(1j * np.pi * ((n * n) % (2 * n2)) / n2)


def scratch_tables(n2, m):
    """The table of the Bluestein columns through scratch for a level-one
    size M = ``m``: ``kstft.bluestein_scratch_table`` itself at 16,384,
    else built by the same rule (chirp, spectrum / L, W_C, fine and coarse
    W_L); returns (chirp, spec, wc, fine_coarse, log_f, L, C)."""
    length = 1 << (2 * n2 - 2).bit_length()
    c = length // m
    if m == kstft.LARGE_M:
        sp = kstft.bluestein_scratch_plan(n2)
        tab = kstft.bluestein_scratch_table(n2, CPU).numpy()
        assert sp["l"] == length and sp["c"] == c
        n = np.arange(n2)
        chirp = tab[(n % c) * m + n // c]  # the [r][m] table, natural order
        return (chirp, tab[sp["spec"]: sp["pass_"]],
                tab[sp["wc"]: sp["fine"]], tab[sp["fine"]:], sp["log_f"],
                length, c)
    log_f = (length.bit_length() - 1 + 1) // 2
    b = _chirp64(n2)
    cc = np.zeros(length, np.complex128)
    cc[:n2] = b
    cc[length - n2 + 1:] = b[1:][::-1]
    spec = np.fft.fft(cc) / length
    f32 = lambda z: np.stack([z.real, z.imag], 1).astype(  # noqa: E731
        np.float32)
    lanes = (np.arange(c)[:, None] * np.arange(32)).ravel()
    return (f32(b), f32(spec), kstft.unit_roots(c, c),
            np.concatenate([kstft._coarse_fine(length, log_f),
                            kstft._roots_at(lanes, length)]), log_f, length, c)


def _level_one(z, sign, m):
    """The level-one M-point transform along axis 1: ``Large<16384>``'s
    model at 16,384, float32 np.fft otherwise."""
    if m == kstft.LARGE_M:
        return np.stack([large_model(row[:, None], sign)[:, 0] for row in z])
    z64 = z.astype(np.complex128)
    y = np.fft.fft(z64, axis=1) if sign < 0 else np.fft.ifft(z64, axis=1) * m
    return y.astype(np.complex64)


def scratch_model(xa, xb, n2, m=kstft.LARGE_M):
    """The Bluestein columns through scratch on two real columns, float32:
    bluestein_forward (Y_r of a[C m' + r], times W_L^(r k)), middle (C-point
    Stockham over r, the spectrum, the inverse C-point step, times
    W_L^(-q' k)), inverse (M-point inverse, times conj b) and split."""
    chirp, spec, wc, fc, log_f, length, c = scratch_tables(n2, m)
    fine_coarse, lanes = fc[: (1 << log_f) + (length >> log_f)], fc[
        (1 << log_f) + (length >> log_f):]
    b = _c(chirp)
    a = np.zeros(length, np.complex64)
    a[:n2] = (xa + 1j * xb).astype(np.complex64) * np.conj(b)
    k = np.arange(m)
    r = np.arange(c)

    def wl(rr, kk):  # scratch_twiddle: W_L^(32 r (k / 32)) * W_L^(r (k % 32))
        u = _coarse_fine(fine_coarse, log_f, 32 * rr * (kk >> 5))
        v = lanes[rr * 32 + (kk & 31)]
        return np.stack([u[..., 0] * v[..., 0] - u[..., 1] * v[..., 1],
                         u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0]],
                        -1).astype(np.float32)

    y = _level_one(a.reshape(m, c).T, -1.0, m)  # [r][k]: a[C k' + r]
    w = (y * _w(wl(r[:, None], k[None, :]))).astype(np.complex64)
    x = batch_fft_model(w.T, -1.0, wc)  # [k][q] = X[k + q M]
    x = (x * _c(spec).reshape(c, m).T).astype(np.complex64)
    g = batch_fft_model(x, 1.0, wc)  # [k][q']
    g = (g * _w(wl(r[None, :], k[:, None]), 1.0)).astype(np.complex64)
    conv = _level_one(g.T, 1.0, m)  # [q'][m'] = conv[C m' + q']
    zz = conv.T.reshape(-1)[:n2] * np.conj(b)  # Z[C m' + q'], natural order
    kk = np.arange(n2 // 2 + 1)
    zk, zm = zz[kk], zz[(n2 - kk) % n2]
    half = np.float32(0.5)
    ca = half * (zk + np.conj(zm))
    cb = (half * (zk.imag + zm.imag)) - 1j * (half * (zk.real - zm.real))
    return ca, cb


@pytest.mark.parametrize("c", [8, 16, 32, 64, 128, 256, 512])
def test_scratch_model_matches_rfft_small_m(c):
    """At M = 64, C = 8 ... 512 (L = 64 C, N2 the largest odd with 2 N2 - 1
    <= L, above L / 4): each real column against float64 rfft, < -110 dB."""
    m = 64
    n2 = (64 * c) // 2 - 1
    rng = np.random.default_rng(c)
    xa, xb = rng.standard_normal((2, n2)).astype(np.float32)
    ca, cb = scratch_model(xa, xb, n2, m)
    for got, xx in ((ca, xa), (cb, xb)):
        want = np.fft.rfft(xx.astype(np.float64))
        assert got.shape == want.shape and _snr(got, want) < -110.0


def test_scratch_model_matches_rfft_at_32771():
    """M = 16,384 (Large<16384>'s model), C = 8, N2 = 32,771 on one pair,
    with the wrapper's own table: < -110 dB against float64 rfft."""
    rng = np.random.default_rng(32771)
    xa, xb = rng.standard_normal((2, 32771)).astype(np.float32)
    ca, cb = scratch_model(xa, xb, 32771)
    for got, xx in ((ca, xa), (cb, xb)):
        assert _snr(got, np.fft.rfft(xx.astype(np.float64))) < -110.0


@pytest.mark.parametrize("n2", [32769, 32771, 65537, 99999])
def test_scratch_table_within_one_ulp_of_float64(n2):
    """kstft.bluestein_scratch_table(n2): the chirp from int64 n^2 mod 2 n2
    (in [r][m] order, zeros from n2 on), W_C^y, the fine, coarse and lane
    W_L within 1 ulp of float64, the spectrum
    within 1 ulp of its largest entry, the pass table as
    ``large_pass_table``; every W_L^(r k) as the kernels form it (coarse *
    fine * lane, two float32 complex products more) within 4e-7."""
    sp = kstft.bluestein_scratch_plan(n2)
    length, c, log_f = sp["l"], sp["c"], sp["log_f"]
    got = kstft.bluestein_scratch_table(n2, CPU).numpy()
    assert got.dtype == np.float32
    assert got.shape == (sp["lane"] + 32 * c, 2)
    assert sp["lane"] == sp["coarse"] + length // (1 << log_f)
    assert length >= 2 * n2 - 1 and length // 2 < 2 * n2 - 1
    b = _chirp64(n2)
    n = np.arange(length)
    at = (n % c) * kstft.LARGE_M + n // c  # b_n sits at [n mod C][n / C]
    assert _ulps(got[at[:n2], 0], b.real).max() <= 1.0
    assert _ulps(got[at[:n2], 1], b.imag).max() <= 1.0
    assert not got[at[n2:]].any()
    cc = np.zeros(length, np.complex128)
    cc[:n2] = b
    cc[length - n2 + 1:] = b[1:][::-1]
    spec = np.fft.fft(cc) / length
    sg = got[sp["spec"]: sp["pass_"]]
    top = np.spacing(np.float32(np.abs(spec).max()))
    assert np.abs(sg[:, 0] + 1j * sg[:, 1] - spec).max() <= top
    assert np.array_equal(got[sp["pass_"]: sp["wc"]],
                          kstft.large_pass_table(CPU).numpy())
    for lo, hi, n, step in ((sp["wc"], sp["fine"], c, 1),
                            (sp["fine"], sp["coarse"], length, 1),
                            (sp["coarse"], sp["lane"], length, 1 << log_f)):
        ang = 2 * np.pi * (np.arange(hi - lo) * step) / n
        assert _ulps(got[lo:hi, 0], np.cos(ang)).max() <= 1.0
        assert _ulps(got[lo:hi, 1], np.sin(ang)).max() <= 1.0
    lane = (np.arange(c)[:, None] * np.arange(32)).ravel()
    ang = 2 * np.pi * lane / length
    assert _ulps(got[sp["lane"]:, 0], np.cos(ang)).max() <= 1.0
    assert _ulps(got[sp["lane"]:, 1], np.sin(ang)).max() <= 1.0
    # scratch_twiddle's W_L^(r k) for every r < C, k < 16,384
    rr, kk = np.meshgrid(np.arange(c), np.arange(0, kstft.LARGE_M, 3),
                         indexing="ij")
    u = _coarse_fine(got[sp["fine"]: sp["lane"]], log_f, 32 * rr * (kk >> 5))
    v = got[sp["lane"] + rr * 32 + (kk & 31)]
    prod = np.stack([u[..., 0] * v[..., 0] - u[..., 1] * v[..., 1],
                     u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0]], -1)
    ang = 2 * np.pi * (rr * kk) / length
    assert np.abs(prod[..., 0] - np.cos(ang)).max() < 4e-7
    assert np.abs(prod[..., 1] - np.sin(ang)).max() < 4e-7
    with pytest.raises(ValueError, match="32768"):
        kstft.bluestein_scratch_plan(32768)


@pytest.mark.parametrize("size,n1", [(98304, 256), (512 * 32771, 512),
                                     ((1 << 31) - 512, 512)])
def test_row_twiddles_within_one_ulp_of_float64(size, n1):
    """kstft.four_step_twiddles: fine and coarse W_N, the rows' pass table
    W_N1 and the lane table W_N^(n1 q) within 1 ulp of float64; a row
    tile's product of the three within 4e-7."""
    got = kstft.four_step_twiddles(size, n1, CPU).numpy()
    log_f = ((size - 1).bit_length() - 1 + 2) // 2
    f = 1 << log_f
    n_coarse = -(-size // f)
    head = f + n_coarse + n1
    assert f * f >= size and got.shape == (head + 16 * n1, 2)
    for lo, hi, n, step in ((0, f, size, 1), (f, f + n_coarse, size, f),
                            (f + n_coarse, head, n1, 1)):
        ang = 2 * np.pi * ((np.arange(hi - lo) * step) % n) / n
        assert _ulps(got[lo:hi, 0], np.cos(ang)).max() <= 1.0
        assert _ulps(got[lo:hi, 1], np.sin(ang)).max() <= 1.0
    lane = (np.arange(n1)[:, None] * np.arange(16)).ravel()
    ang = 2 * np.pi * lane / size
    assert _ulps(got[head:, 0], np.cos(ang)).max() <= 1.0
    assert _ulps(got[head:, 1], np.sin(ang)).max() <= 1.0
    # a row tile's W_N^(n1 (base + d)), d < 16, base + d < N2
    rng = np.random.default_rng(1)
    n1s = rng.integers(0, n1, 100000)
    base = rng.integers(0, size // n1 - 15, 100000)
    d = rng.integers(0, 16, 100000)
    u = _coarse_fine(got[: f + n_coarse], log_f, n1s * base)
    v = got[head + n1s * 16 + d]
    prod = np.stack([u[:, 0] * v[:, 0] - u[:, 1] * v[:, 1],
                     u[:, 0] * v[:, 1] + u[:, 1] * v[:, 0]], -1)
    ang = 2 * np.pi * ((n1s * (base + d)) % size) / size
    assert np.abs(prod[:, 0] - np.cos(ang)).max() < 4e-7
    assert np.abs(prod[:, 1] - np.sin(ang)).max() < 4e-7


def test_scratch_header_constants():
    """fft_fourstep.cuh's Bluestein-through-scratch plan: L the least power
    of two >= 2 N2 - 1, C = L / 16,384, the table offsets the wrapper's (the
    chirp's L entries first), the split's tile."""
    src = _read("fft_fourstep.cuh")
    for line in ("while (sp.l < 2 * n2 - 1) sp.l *= 2;",
                 "sp.c = sp.l / kBluesteinM;",
                 "sp.spec = sp.l;",
                 "sp.pass = sp.spec + sp.l;",
                 "sp.wc = sp.pass + large::Large<kBluesteinM>::kTwiddles;",
                 "sp.fine = sp.wc + sp.c;",
                 "sp.coarse = sp.fine + (1LL << sp.log_f);",
                 "sp.lane = sp.coarse + (sp.l >> sp.log_f);",
                 "constexpr int kSplitBins = 64, kSplitItems = 16;"):
        assert line in src, line
    for n2, (length, c) in ((32769, (131072, 8)), (65536, (131072, 8)),
                            (65537, (262144, 16)),
                            (4194303, (8388608, 512))):
        sp = kstft.bluestein_scratch_plan(n2)
        assert (sp["l"], sp["c"]) == (length, c)
        assert sp["spec"] == length and sp["pass_"] == 2 * length
        assert sp["wc"] == sp["pass_"] + 8448
        assert sp["coarse"] == sp["fine"] + (1 << sp["log_f"])
