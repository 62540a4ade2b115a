"""B7's cluster route (``csrc/fft_mixed.cuh``), modelled on the CPU.

At 1024 j points, j = 49 .. 63, B7 holds a column in the shared memory of a
2-CTA cluster: N = L m (L = 2P, m odd), the m decimated sub-sequences split
by parity between the pair, three batched Stockham passes on each CTA, the
real split and W_N^(s k) twiddles, then the m-point DFTs over s, half their
inputs read from the peer.  The kernel runs only on the card (chip_smoke.py
phase 19 holds it against its twin and float64 there).  These tests hold,
at all 15 sizes:

* the load: which CTA and sub-buffer each sample lands in (every slot of
  each CTA's sub-sequences written once, every index inside the owner's
  buffer), the kernel's incremental (s, n) walk equal to p mod m, p / m;
* a float32 NumPy transcription of the passes, split and sums in the
  kernel's index order from ``kcols.cluster_table``, each bin k < N / 2
  stored once, against float64 ``np.fft.rfft`` (< -110 dB), and every
  read of the sums inside the buffer of the CTA that holds its s;
* the shared-memory banks of the passes and the sums' reads (a half-warp's
  8-byte accesses on 16 distinct banks);
* the header's constants, the table against float64, and the C entry the
  wrapper calls: one call, no scratch, a refused launch raising.
"""

import os

import numpy as np
import pytest
import torch

from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.kernels import columns as kcols
from test_torch_scan import _dft_regs, _snr, _ulps
from torch_fake_card import fake_card

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")
CPU = torch.device("cpu")
T = 512  # threads a CTA
GROUP = 8  # pairs a thread accumulates (kGroup)
SIZES = [1024 * j for j in range(49, 64)]


def _plan(size):
    p, m = kcols.cluster_plan(size)
    return dict(p=p, m=m, h=(m - 1) // 2, l=2 * p, n=size,
                s=p + p // 16 + 1, q=p // 16, r=p // 256,
                u0=(m + 1) // 2)


def _pad(a):
    return a + (a >> 4)


def _w(tab):
    """cos - i sin of a (cos, sin) table: W^x as the kernel forms it."""
    return (tab[..., 0] - 1j * tab[..., 1]).astype(np.complex64)


def _wn(tab, pl, x):
    """fft_mixed.cuh's wn: (cos, sin)(2 pi x / N) as the float32 product of
    the table's W_N^(128 (x >> 7)) and W_N^(x & 127)."""
    lo, hi = 256 + pl["p"], 256 + pl["p"] + 128
    a, b = tab[hi + (x >> 7)], tab[lo + (x & 127)]
    return np.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                     a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], -1)


def load_map(pl):
    """The load of ``real_fft_cluster``: CTA r's thread t takes p = r N / 2
    + t + 512 i, walking (s, n) by (512 mod m, 512 / m) with a carry;
    returns (p, owner CTA, float index in the owner's buffer) for every
    sample."""
    n_half, m = pl["n"] // 2, pl["m"]
    out = []
    for r in (0, 1):
        t = np.arange(T)
        p = r * n_half + t
        s, nn = p % m, p // m
        for _ in range(n_half // T):
            assert np.array_equal(s, p % m) and np.array_equal(nn, p // m)
            out.append((p.copy(), s & 1,
                        2 * ((s >> 1) * pl["s"] + (nn >> 1)) + (nn & 1)))
            p += T
            s, nn = s + T % m, nn + T // m
            wrap = s >= m
            s[wrap] -= m
            nn[wrap] += 1
    return tuple(np.concatenate(a) for a in zip(*out))


def mixed_model(x, size):
    """``real_fft_cluster<P>`` on a float32 frame: (bins k < N / 2 as
    complex64 up to conjugation, how many times each bin was stored)."""
    pl = _plan(size)
    p_, m, h, l_, s_, q_, r_ = (pl[k] for k in "pmhlsqr")
    tab = kcols.cluster_table(size, CPU).numpy()
    bufs = [np.zeros(pl["u0"] * s_, np.complex64) for _ in (0, 1)]
    flat = [b.view(np.float32) for b in bufs]
    p, owner, idx = load_map(pl)
    for r in (0, 1):
        flat[r][idx[owner == r]] = x[p[owner == r]]
    for r in (0, 1):
        buf, n_sub = bufs[r], (m + 1 - r) // 2
        # pass 1 (Ns = 1): read the staged z, 16-point DFTs, padded exchange
        g = np.arange(n_sub * q_)
        u, j = g // q_, g % q_
        v = buf[(u * s_ + j)[None] + q_ * np.arange(16)[:, None]]
        buf[(u * s_ + 17 * j)[None] + np.arange(16)[:, None]] = _dft_regs(
            v, -1.0)
        # pass 2 (Ns = 16): W_256^((j mod 16) a)
        v = buf[u * s_ + _pad(j[None] + q_ * np.arange(16)[:, None])]
        jm = j & 15
        v[1:] = v[1:] * _w(tab[jm[None] * np.arange(1, 16)[:, None]])
        dst = u * s_ + (j >> 4) * 256 + jm
        buf[dst[None] + 16 * np.arange(16)[:, None]] = _dft_regs(v, -1.0)
        # pass 3 (Ns = 256, radix R): W_P^(j a), where it read
        g = np.arange(n_sub * 256)
        io = (g >> 8) * s_ + (g & 255)
        v = buf[io[None] + 256 * np.arange(r_)[:, None]]
        v[1:] = v[1:] * _w(tab[256 + (g & 255)[None]
                               * np.arange(1, r_)[:, None]])
        buf[io[None] + 256 * np.arange(r_)[:, None]] = _dft_regs(v, -1.0)
        # split and twiddle, in place
        g = np.arange(n_sub * (p_ // 2))
        k, u = g & (p_ // 2 - 1), g // (p_ // 2)
        s, base = 2 * u + r, u * s_

        def tw(val, xs):
            w = _wn(tab, pl, xs)
            return (val * (w[..., 0] - 1j * w[..., 1])).astype(np.complex64)

        z0, zq = buf[base[k == 0]], buf[base[k == 0] + p_ // 2]
        s0 = s[k == 0]
        kk, bb, sk = k[k > 0], base[k > 0], s[k > 0]
        zk, zm = buf[bb + kk], buf[bb + p_ - kk]
        w = _wn(tab, pl, kk * m)
        half = np.float32(0.5)
        ex, ey = half * (zk.real + zm.real), half * (zk.imag - zm.imag)
        ox, oy = half * (zk.imag + zm.imag), -half * (zk.real - zm.real)
        wox = w[:, 0] * ox + w[:, 1] * oy
        woy = w[:, 0] * oy - w[:, 1] * ox
        buf[bb + kk] = tw((ex + wox) + 1j * (ey + woy), sk * kk)
        buf[bb + p_ - kk] = tw((ex - wox) + 1j * (woy - ey), sk * (p_ - kk))
        buf[base[k == 0]] = (z0.real + z0.imag).astype(np.complex64)
        buf[base[k == 0] + p_] = tw(z0.real - z0.imag, s0 * p_)
        buf[base[k == 0] + p_ // 2] = tw(np.conj(zq), s0 * (p_ // 2))
    # the m-point sums: CTA r's items (k1, group), reads from CTA s mod 2
    sp = tab[len(tab) - m * h:].reshape(m, h, 2)
    out = np.zeros(size // 2, np.complex64)
    stores = np.zeros(size // 2, np.int64)
    for r in (0, 1):
        k1 = r * (p_ // 2) + np.arange(p_ // 2 + r)
        y0 = np.zeros(len(k1), np.complex64)
        a, b, c, d = (np.zeros((h, len(k1)), np.float32) for _ in range(4))
        for par in (0, 1):
            for s in range(par, m, 2):
                assert s >> 1 < (m + 1 - par) // 2 and k1.max() < s_
                xv = bufs[par][(s >> 1) * s_ + k1]
                y0 += xv
                cs = sp[s][:, :, None]
                a += xv.real * cs[:, 0]
                b += xv.imag * cs[:, 1]
                c += xv.imag * cs[:, 0]
                d += xv.real * cs[:, 1]

        def put(bins, vals, keep):
            np.add.at(stores, bins[keep], 1)
            out[bins[keep]] = vals[keep]

        put(k1, y0, k1 < p_)
        for i in range(h):
            pp = i + 1
            put(k1 + l_ * pp, (a[i] + b[i]) + 1j * (c[i] - d[i]), k1 < p_)
            put(l_ - k1 + l_ * (pp - 1), (a[i] - b[i]) + 1j * (c[i] + d[i]),
                k1 > 0)
    return out, stores


@pytest.mark.parametrize("size", SIZES)
def test_cluster_load_lands_every_sample_once(size):
    """The load at ``size``: every sample p goes to CTA (p mod m) mod 2,
    sub-buffer (p mod m) / 2, packed slot (p / m) / 2, real or imaginary by
    (p / m) mod 2; each CTA's slots of its (m + 1 - r) / 2 sub-sequences
    are written exactly once and every index lies inside the owner's
    buffer, below the padding; each CTA reads [r N / 2, (r + 1) N / 2)."""
    pl = _plan(size)
    p, owner, idx = load_map(pl)
    assert np.array_equal(np.sort(p), np.arange(size))
    m, s_ = pl["m"], pl["s"]
    assert np.array_equal(owner, (p % m) & 1)
    assert np.all(p[: size // 2] < size // 2)  # CTA 0 read the first half
    for r in (0, 1):
        got = np.sort(idx[owner == r])
        n_sub = (m + 1 - r) // 2
        want = np.sort(np.concatenate(
            [2 * u * s_ + np.arange(2 * pl["p"]) for u in range(n_sub)]))
        assert np.array_equal(got, want)
        assert got.max() < 2 * pl["u0"] * s_
    # the route's shapes: P a power of two 512 .. 4096, m odd 7 .. 63, at
    # most 16,384 points a CTA, 155,144 bytes of shared memory
    assert pl["p"] in (512, 1024, 2048, 4096) and m % 2 and 7 <= m <= 63
    assert pl["u0"] * pl["p"] <= 16384
    smem = 8 * (pl["u0"] * s_ + m * pl["h"])
    assert smem <= 155144 and s_ % 2 == 1


@pytest.mark.parametrize("size", SIZES)
def test_cluster_model_matches_rfft(size):
    """The float32 transcription against float64 rfft of the same float32
    column (< -110 dB, magnitudes), every bin k < N / 2 stored once."""
    x = np.random.default_rng(size).standard_normal(size).astype(np.float32)
    got, stores = mixed_model(x, size)
    assert np.all(stores == 1)
    want = np.abs(np.fft.rfft(x.astype(np.float64))[: size // 2])
    assert _snr(np.abs(got), want) < -110.0


def _banks_distinct(addr):
    a = np.asarray(addr).reshape(-1, 16)
    return bool(np.all([len(set(row % 16)) == 16 for row in a]))


@pytest.mark.parametrize("size", [50176, 51200, 53248, 57344])
def test_cluster_passes_keep_half_warps_on_distinct_banks(size):
    """Every 8-byte shared access of the passes and the split at each P (512
    ... 4096), and the sums' reads, per half-warp (16 consecutive jobs of
    one thread set) on 16 distinct banks: each half-warp stays within one
    sub-sequence (jobs a sub-sequence a multiple of 16), whose base u S only
    shifts the pattern."""
    pl = _plan(size)
    q_, s_, p_ = pl["q"], pl["s"], pl["p"]
    assert q_ % 16 == 0 and (p_ // 2) % 16 == 0 and T % 16 == 0
    for n_sub in ((pl["m"] + 1) // 2, (pl["m"] - 1) // 2):
        g = np.arange(n_sub * q_)
        u, j = g // q_, g % q_
        base = u * s_
        for a in range(16):
            assert _banks_distinct(base + j + q_ * a)  # pass 1 reads
            assert _banks_distinct(base + 17 * j + a)  # pass 1 writes
            assert _banks_distinct(base + _pad(j + q_ * a))  # pass 2 reads
            assert _banks_distinct(base + (j >> 4) * 256 + (j & 15) + 16 * a)
        g = np.arange(n_sub * 256)
        for a in range(pl["r"]):
            assert _banks_distinct((g >> 8) * s_ + (g & 255) + 256 * a)
        g = np.arange(n_sub * (p_ // 2))
        k, base = g & (p_ // 2 - 1), (g // (p_ // 2)) * s_
        assert _banks_distinct(np.where(k > 0, base + k, base))
        assert _banks_distinct(np.where(k > 0, base + p_ - k, base + p_))
    for r in (0, 1):  # the sums: consecutive k1 at one s
        k1 = r * (p_ // 2) + np.arange(p_ // 2)
        assert _banks_distinct(3 * s_ + k1)


def test_cluster_header_constants():
    """fft_mixed.cuh's launch shape, stride, group and table offsets are the
    ones the model and kcols.cluster_table use."""
    with open(os.path.join(CSRC, "fft_mixed.cuh")) as f:
        src = f.read()
    assert "constexpr int kThreads = 512;" in src
    assert f"constexpr int kGroup = {GROUP};" in src
    assert "static constexpr int kStride = P + P / 16 + 1;" in src
    assert "static constexpr int kR = P / 256;" in src
    assert "mp.lo = 256 + p;" in src and "mp.hi = mp.lo + 128;" in src
    assert "mp.comb = mp.hi + n / 256;" in src
    assert "const float2 a = __ldg(tw + mp.hi + (x >> 7));" in src
    for size in SIZES:
        pl = _plan(size)
        tab = kcols.cluster_table(size, CPU)
        assert tab.shape == (256 + pl["p"] + 128 + size // 256
                             + pl["m"] * pl["h"], 2)


@pytest.mark.parametrize("size", [50176, 57344, 64512])
def test_cluster_table_within_one_ulp_of_float64(size):
    """kcols.cluster_table: W_256^x, W_P^x, W_N^x (x < 128), W_N^(128 y)
    and (cos, sin)(2 pi s p / m), each within 1 ulp of float64; a size the
    route does not take raises."""
    pl = _plan(size)
    p_, m, h = pl["p"], pl["m"], pl["h"]
    got = kcols.cluster_table(size, CPU).numpy()
    sp = (np.arange(m)[:, None] * np.arange(1, h + 1)[None, :]) % m
    ang = 2 * np.pi * np.concatenate([
        np.arange(256) / 256, np.arange(p_) / p_, np.arange(128) / size,
        128 * np.arange(size // 256) / size, sp.ravel() / m])
    assert got.dtype == np.float32 and got.shape == (len(ang), 2)
    assert _ulps(got[:, 0], np.cos(ang)).max() <= 1.0
    assert _ulps(got[:, 1], np.sin(ang)).max() <= 1.0
    for bad in (49152, 65536, 1024 * 47):
        with pytest.raises(ValueError, match="cluster route"):
            kcols.cluster_table(bad, CPU)


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrapper's CUDA branch on the fake card."""
    return fake_card(monkeypatch)


@pytest.mark.parametrize("size", SIZES)
def test_cluster_sizes_launch_one_entry_without_scratch(fake_cuda, size,
                                                        monkeypatch):
    """B7 at each of the 15 sizes: one call of
    ``mlx_spectrogram_columns_cluster`` with (count, size, ...), the
    size's cluster table, one launch counted, and no tensor allocated but
    the output (no scratch)."""
    meta = torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    ends = torch.zeros(4, dtype=torch.int32).to(meta)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(a)
                        or empty(*a, **k))
    before = kcols.spectrogram_columns_fused.launches
    out = kcols.spectrogram_columns_fused(wav, ends, ends, 1.0, size=size)
    assert out.shape == (4, size // 2) and out.dtype == torch.int32
    (name, args), = fake_cuda.calls
    assert name == "mlx_spectrogram_columns_cluster"
    assert args[6:8] == (4, size)
    assert len(args) == len(_build.SIGNATURES[name])
    assert _build.SIGNATURES[name] == _build.SIGNATURES[
        "mlx_spectrogram_columns"]
    assert made == [((4, size // 2),)]
    assert kcols.spectrogram_columns_fused.launches == before + 1


def test_refused_cluster_launch_raises(fake_cuda):
    """A code the C entry returns (cudaErrorLaunchOutOfResources, 7: no GPC
    holds the cluster) raises after the one call; nothing else runs and the
    launch is not counted."""
    meta = torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    ends = torch.zeros(4, dtype=torch.int32).to(meta)
    fake_cuda.code = 7
    before = kcols.spectrogram_columns_fused.launches
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        kcols.spectrogram_columns_fused(wav, ends, ends, 1.0, size=50176)
    assert [n for n, _ in fake_cuda.calls] == [
        "mlx_spectrogram_columns_cluster"]
    assert kcols.spectrogram_columns_fused.launches == before
