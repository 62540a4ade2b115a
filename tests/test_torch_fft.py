"""The register pair transform of B1, B2 and B12, modelled on the CPU.

``csrc/fft_pair.cuh`` is one template over N = 16 * 16 * R points and runs
only on the card (chip_smoke.py holds its kernels against their twins
there).  These tests hold what the design rests on, at every size the
template takes (``kpv.PAIR_SIZES``):

* a NumPy transcription of its three passes in the kernel's index order
  (pass 3 of R = 32 as two 16-point halves and a radix-2 step), with its
  host twiddle tables and float32 constants, against ``np.fft.fft`` both
  ways; at 2048 points bit for bit equal to B2's model in
  ``tests/test_torch_scan.py``;
* the twiddle tables within 1 ulp of float64;
* the row strides of ``Plan<N>`` (read from the header) keep every
  half-warp's 8-byte shared-memory accesses on distinct banks, and every
  exchange is a permutation inside its buffer;
* a NumPy transcription of ``csrc/stft_mag_pair.cuh`` (frame pairs, the
  last frame of an odd count paired with silence, window and zero fill,
  the pair split, magnitudes) against float64 ``np.fft.rfft`` magnitudes
  and the twin ``stft_mag_plain``;
* the routes of ``kstft.route`` and the entry points the wrappers call.
"""

import os
import re

import numpy as np
import pytest
import torch

from melonix_tpu_torch.engine.spectral import hann_window
from melonix_tpu_torch.kernels import pv as kpv
from melonix_tpu_torch.kernels import stft as kstft
from test_torch_scan import _ROT16, _dft_regs, _snr, _ulps, pair_fft_model
from torch_fake_card import fake_card

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")
SIZES = kpv.PAIR_SIZES
CPU = torch.device("cpu")

_C1 = np.float32(0.980785280403230449126)  # cos(pi / 16)
_S1 = np.float32(0.195090322016128267848)
_C3 = np.float32(0.831469612302545237079)  # cos(3 pi / 16)
_S3 = np.float32(0.555570233019602224743)
_ODD32 = {1: (_C1, _S1), 3: (_C3, _S3), 5: (_S3, _C3), 7: (_S1, _C1),
          9: (-_S1, _C1), 11: (-_S3, _C3), 13: (-_C3, _S3), 15: (-_C1, _S1)}


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _rot32(sign):
    """fft_pair.cuh's rot32 factors W_32^s, s < 16, as complex64."""
    cs = [_ODD32.get(s, _ROT16[s // 2]) for s in range(16)]
    return np.array([np.float32(c) + 1j * sign * np.float32(n)
                     for c, n in cs], np.complex64)


def pair_model(z, sign, n):
    """fft_pair.cuh's transform of z along axis 0 ((n, B) complex64): index
    n = b + T a, b = c + R a', output k = k2 + 16 (q + 16 r)."""
    t, r = n // 16, n // 256
    tab = kpv.pair_twiddles(n, CPU).numpy()
    w = (tab[:, 0] + 1j * sign * tab[:, 1]).astype(np.complex64)
    tw1, tw2 = w[: 16 * t].reshape(16, t), w[16 * t:].reshape(16, r)
    batch = z.shape[1:]
    ex1 = _dft_regs(z.reshape((16, t) + batch), sign)  # [k2][b]
    ex1[1:] *= tw1[1:].reshape((15, t) + (1,) * len(batch))
    v = np.swapaxes(ex1.reshape((16, 16, r) + batch), 0, 1)  # [a][k2][c]
    ex2 = _dft_regs(v, sign)  # [q][k2][c]
    ex2[1:] *= tw2[1:].reshape((15, 1, r) + (1,) * len(batch))
    u = np.moveaxis(ex2, 2, 0).reshape((r, 256) + batch)  # [c][p]
    if r <= 16:
        x = _dft_regs(u, sign)  # [r][p]
    else:  # two 16-point halves over c = 2 j + e, one radix-2 step
        y0 = _dft_regs(u[0::2], sign)
        y1 = _dft_regs(u[1::2], sign) * _rot32(sign).reshape(
            (16,) + (1,) * (1 + len(batch)))
        x = np.concatenate([y0 + y1, y0 - y1])
    return x.reshape((n,) + batch)


def _strides(n):
    """Plan<N>'s row strides by the header's rules: S1 = T + R and S2 =
    256 + 16 / R below R = 16, else S1 = T and S2 = 257."""
    t, r = n // 16, n // 256
    return (t + r, 256 + 16 // r) if r < 16 else (t, 257)


@pytest.mark.parametrize("n", SIZES)
def test_pair_model_is_the_dft_both_ways(n):
    """The forward model against np.fft.fft, and its inverse (sign +1,
    unscaled) of the forward back to z, < -120 dB, on three columns."""
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
         ).astype(np.complex64)
    fwd = pair_model(z, -1.0, n)
    assert _snr(fwd, np.fft.fft(z.astype(np.complex128), axis=0)) < -120.0
    back = pair_model(fwd, 1.0, n) / n
    assert _snr(back, z.astype(np.complex128)) < -120.0


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_model_at_2048_is_b2s_model_bit_for_bit(seed, sign):
    """The template's 2048-point instance is B2's 128-thread transform of
    16 · 16 · 8: the generic model equals test_torch_scan.pair_fft_model
    exactly."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(
        np.complex64)
    got = pair_model(z[:, None], sign, 2048)[:, 0]
    want = pair_fft_model(z, sign)
    assert got.dtype == want.dtype == np.complex64
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", SIZES)
def test_pair_twiddles_within_one_ulp_of_float64(n):
    """kpv.pair_twiddles(n): rows k2 * T + b hold 2 pi b k2 / n, then rows
    n + q * R + c hold 2 pi c q / (16 R); float32 of float64, <= 1 ulp."""
    t, r = n // 16, n // 256
    got = kpv.pair_twiddles(n, CPU).numpy()
    k2, b = np.meshgrid(np.arange(16), np.arange(t), indexing="ij")
    q, c = np.meshgrid(np.arange(16), np.arange(r), indexing="ij")
    ang = np.concatenate([2 * np.pi * (b * k2).ravel() / n,
                          2 * np.pi * (c * q).ravel() / (16 * r)])
    assert got.shape == (n + n // 16, 2) and got.dtype == np.float32
    assert _ulps(got[:, 0], np.cos(ang)).max() <= 1.0
    assert _ulps(got[:, 1], np.sin(ang)).max() <= 1.0
    assert kpv.pair_twiddles(n, CPU) is kpv.pair_twiddles(n, CPU)  # cached


def test_pair_twiddles_refuse_other_sizes():
    with pytest.raises(ValueError, match="1536"):
        kpv.pair_twiddles(1536, CPU)


def test_header_plans_are_the_sizes_the_wrappers_route():
    """Plan<N> in fft_pair.cuh holds the strides the rules give, for exactly
    kpv.PAIR_SIZES; B12's C entry dispatches the same sizes, and B1's
    entry is the 2048-point instance."""
    plans = {int(m[0]): (int(m[1]), int(m[2])) for m in re.findall(
        r"struct Plan<(\d+)> \{ static constexpr int kStride1 = (\d+), "
        r"kStride2 = (\d+); \};", _read("fft_pair.cuh"))}
    assert sorted(plans) == list(SIZES)
    assert all(plans[n] == _strides(n) for n in SIZES)
    cases = re.findall(r"case (\d+):\s*err = mlx::launch_stft_mag_pair<(\d+)>",
                       _read("stft_mag_sizes.cu"))
    assert sorted(int(a) for a, b in cases if a == b) == list(SIZES)
    assert "launch_stft_mag_pair<2048>" in _read("stft_mag.cu")
    assert "Pair<2048>" in _read("pv_analysis.cu")


def _half_warps(t_count):
    """Thread ids of each half-warp of a CTA of t_count threads."""
    return np.arange(t_count).reshape(-1, 16)


def _banks_distinct(addr):
    """Each row of float2 indices (one half-warp) on 16 distinct 8-byte
    bank pairs."""
    a = np.asarray(addr)
    return all(len(set(row % 16)) == 16 for row in a.reshape(-1, 16))


@pytest.mark.parametrize("n", SIZES)
def test_exchange_strides_keep_half_warps_on_distinct_banks(n):
    """Every shared-memory access of fft_pair.cuh's passes and of the
    magnitude epilogue, per half-warp and per unrolled step: 16 distinct
    banks.  Each exchange writes a permutation of its buffer's slots that
    the next pass reads back in full, within kBuf."""
    t, r = n // 16, n // 256
    s1, s2 = _strides(n)
    buf = max(16 * s1, r * s2, n)
    tid = _half_warps(t)
    k2, c = tid // r, tid % r
    w1 = [k * s1 + tid for k in range(16)]  # pass 1 -> exchange 1
    r1 = [k2 * s1 + c + r * a for a in range(16)]  # pass 2 reads
    w2 = [c * s2 + k2 + 16 * q for q in range(16)]  # pass 2 -> exchange 2
    if r <= 16:
        ps = [tid + t * h for h in range(16 // r)]
        r2 = [j * s2 + p for p in ps for j in range(r)]
        w3 = [p + 256 * i for p in ps for i in range(r)]
    else:
        p, e = (tid >> 5) * 16 + (tid & 15), (tid >> 4) & 1
        r2 = [(2 * j + e) * s2 + p for j in range(16)]
        w3 = [p + 256 * (s + 16 * e) for s in range(16)]
    k = [tid + t * i for i in range(n // 2 // t)]  # the epilogue's bins
    epi = k + [(n - kk) % n for kk in k]
    for acc in (w1, r1, w2, r2, w3, epi):
        assert all(_banks_distinct(a) for a in acc)
    for wr, rd in ((w1, r1), (w2, r2)):
        assert np.array_equal(np.sort(np.ravel(wr)), np.sort(np.ravel(rd)))
        assert len(np.unique(np.ravel(wr))) == n and np.max(wr) < buf
    assert np.array_equal(np.sort(np.ravel(w3)), np.arange(n))


def stft_mag_pair_model(x, win, n, hop, n_frames, scale):
    """stft_mag_pair.cuh on the CPU in float32: frames f and f + 1 as z =
    x_f w + i x_(f+1) w (zeros past the track; a frame past the last is
    silence), the pair transform, the split X = (Z[k] + conj Z[N-k]) / 2
    and (Z[k] - conj Z[N-k]) / 2i, |X| * scale for k < N / 2."""
    n_pairs = (n_frames + 1) // 2
    xp = np.concatenate([x, np.zeros(2 * n_pairs * hop + n, np.float32)])
    idx = np.arange(2 * n_pairs)[:, None] * hop + np.arange(n)[None, :]
    fr = np.where(idx < len(x), xp[idx], np.float32(0.0)) * win[None, :]
    fr[n_frames:] = 0.0
    z = (fr[0::2] + 1j * fr[1::2]).astype(np.complex64).T  # (n, pairs)
    zz = pair_model(z, -1.0, n)
    kk = np.arange(n // 2)
    zk, zn = zz[kk], zz[(n - kk) % n]
    half = np.float32(0.5)
    ra, ia = half * (zk.real + zn.real), half * (zk.imag - zn.imag)
    rb, ib = half * (zk.imag + zn.imag), half * (zn.real - zk.real)
    out = np.empty((2 * n_pairs, n // 2), np.float32)
    for row, re_, im_ in ((0, ra, ia), (1, rb, ib)):
        out[row::2] = (np.sqrt(re_ * re_ + im_ * im_) * np.float32(scale)).T
    return out[:n_frames]


_CASES = {  # (track length in frames of n, hop as a share of n, frames)
    "odd_count": (6.3, 4, None),
    "one_frame": (3.0, 4, 1),
    "hop_441": (5.0, None, None),
    "short_track": (0.6, 4, 3),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("n", SIZES)
def test_stft_mag_pair_model_matches_rfft(n, case):
    """The kernel's NumPy transcription against float64 |rfft| of the same
    float32 windowed frames (< -120 dB) and against the twin
    ``stft_mag_plain`` (< -110 dB), shape (n_frames, n / 2): an odd frame
    count (the last frame paired with silence, its row not written), one
    frame, B1's hop of 441 (no multiple of 128), a track shorter than a
    frame (zero fill), and frames past the track's end."""
    length, share, frames = _CASES[case]
    rng = np.random.default_rng(n + len(case))
    x = (0.3 * rng.standard_normal(int(length * n))).astype(np.float32)
    hop = 441 if share is None else n // share
    nf = frames or 1 + (len(x) - n) // hop
    if case == "odd_count" and nf % 2 == 0:
        nf += 1  # one frame past the track's end
    win = hann_window(n)
    got = stft_mag_pair_model(x, win, n, hop, nf, 0.5)
    assert got.shape == (nf, n // 2) and got.dtype == np.float32
    xp = np.concatenate([x, np.zeros(nf * hop + n, np.float32)])
    fr = np.stack([xp[f * hop : f * hop + n] * win for f in range(nf)])
    want = 0.5 * np.abs(np.fft.rfft(fr.astype(np.float64))[:, : n // 2])
    assert _snr(got, want) < -120.0
    twin = kstft.stft_mag_plain(torch.from_numpy(x), torch.from_numpy(win),
                                n, hop, nf, 0.5).numpy()
    assert twin.shape == got.shape and _snr(got, twin) < -110.0


@pytest.mark.parametrize("size,way", [
    (512, "pair"), (1024, "pair"), (2048, "pair"), (4096, "pair"),
    (8192, "pair"), (1536, "tile"), (16384, "large"),
    (49152, "tile"), (65536, "large"), (512 * 12289, "bluestein"),
])
def test_route_is_decided_by_the_size(size, way):
    assert kstft.route(size) == way
    assert kstft.supported(size, size // 4)


def test_route_refuses_sizes_beyond_int32():
    with pytest.raises(NotImplementedError, match="2\\^31"):
        kstft.route(1 << 31)


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on the fake card: which entry would
    launch, with which sizes, without a card."""
    return fake_card(monkeypatch)


@pytest.mark.parametrize("size,hop,entry", [
    (512, 128, "mlx_stft_mag_pair"), (1024, 256, "mlx_stft_mag_pair"),
    (4096, 1024, "mlx_stft_mag_pair"), (8192, 1024, "mlx_stft_mag_pair"),
    (1536, 384, "mlx_stft_mag_sizes"), (16384, 2048, "mlx_stft_mag_large"),
])
def test_b12_launches_the_entry_of_its_route(fake_cuda, size, hop, entry):
    """One call of the route's entry with (n_frames, size, hop), one launch
    counted, whatever the route."""
    meta = torch.device("meta")
    before = kstft.stft_mag.launches
    out = kstft.stft_mag(torch.zeros(50000).to(meta),
                         torch.zeros(size).to(meta), size, hop, 7, 0.25)
    assert out.shape == (7, size // 2) and out.device == meta
    (name, args), = fake_cuda.calls
    assert name == entry and args[5:9] == (7, size, hop, 0.25)
    assert kstft.stft_mag.launches == before + 1


def test_b1_launches_its_entry_with_any_hop(fake_cuda):
    """B1 takes any hop > 0 (here 441) through mlx_stft_mag, whose twiddle
    table is the 2048-point pair table; other sizes raise before a launch."""
    meta = torch.device("meta")
    before = kpv.stft_mag.launches
    out = kpv.stft_mag(torch.zeros(50000).to(meta),
                       torch.zeros(2048).to(meta), 2048, 441, 9)
    assert out.shape == (9, 1024)
    (name, args), = fake_cuda.calls
    assert name == "mlx_stft_mag" and args[5:8] == (9, 441, 1.0)
    assert kpv.pair_twiddles(2048, meta).shape == (2176, 2)
    with pytest.raises(NotImplementedError, match="2048"):
        kpv.stft_mag(torch.zeros(50000).to(meta), torch.zeros(4096).to(meta),
                     4096, 1024, 9)
    assert kpv.stft_mag.launches == before + 1
