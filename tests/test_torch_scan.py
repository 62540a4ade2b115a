"""B3's blocked phase scan and B2's pair transform, modelled on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their twins there).  These tests hold what the kernels' designs rest on:

* the twin's phase sum (``kpv.phase_scan_plain`` / ``synth_ola_phase_plain``)
  equals float32 of a NumPy float64 prefix sum, in all three entries;
* a NumPy model of the scan kernel's blocked float64 order (runs of
  ``SCAN_RUN`` frames, tiles of ``SCAN_TILE``, constants read from the
  wrapper and checked against the CUDA source) rounds to the serial float64
  sum's float32 value;
* the host-built twiddle tables against NumPy float64;
* a NumPy model of ``csrc/fft2048_pair.cuh`` (three passes of 16, 16 and 8
  points in the kernel's index order, its tables and constants) and of
  B2's pair split against ``np.fft.rfft``.
"""

import os
import re

import numpy as np
import pytest
import torch

from melonix_tpu_torch.engine.spectral import hann_window
from melonix_tpu_torch.kernels import pv as kpv

torch.set_num_threads(2)

SIZE = 2048
NB = SIZE // 2 + 1
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk(case, frames=300, seed=3, hop=512):
    """A chunk's operands: a seeded spectrum, stretch factors and carries;
    (re, im) and, for the (mag, phi) entry, its magnitude and phase."""
    rng = np.random.default_rng(seed)
    m0, f_real = (0, frames) if case == "chunk0" else (5 * frames, frames - 23)
    re_ = rng.normal(size=(frames, NB)).astype(np.float32)
    im_ = rng.normal(size=(frames, NB)).astype(np.float32)
    da = (hop * rng.uniform(0.5, 2.0, frames)).astype(np.float32)
    carries = [rng.uniform(lo, hi, NB).astype(np.float32)
               for lo, hi in ((-1, 1), (-3e4, 3e4), (-np.pi, np.pi))]
    return m0, f_real, re_, im_, da, carries


def _entry(entry, re_, im_):
    """(a, b, cart, lock) of B3's entry on a chunk's spectrum."""
    if entry == "mag_phi":
        a, b = _t(re_), _t(im_)
        return torch.sqrt(a * a + b * b), torch.atan2(b, a), False, False
    return _t(re_), _t(im_), True, entry == "lock"


# ----------------------------------------------------------------------
# B3: the twin's float64 phase sum
# ----------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["re_im", "mag_phi", "lock"])
@pytest.mark.parametrize("case", ["chunk0", "later_chunk"])
def test_phase_sum_is_float32_of_a_float64_prefix_sum(case, entry):
    """resid_last and every psi of the twin equal float32 of NumPy's float64
    prefix sum of the same increments, added to resid_in and rounded once;
    the whole-chunk twin returns the same carries."""
    hop = 512
    m0, f_real, re_, im_, da, (phi0, resid_in, phi_prev) = _chunk(case)
    a, b, cart, lock = _entry(entry, re_, im_)
    args = (a, b, _t(da), m0, f_real, _t(phi0), _t(resid_in), _t(phi_prev),
            SIZE, hop)
    s_re, s_im, s_phi, r_last, p_last, p0_eff = kpv.phase_scan_plain(
        *args, cart=cart, lock=True)
    phi = s_phi.numpy()
    incr = kpv.phase_increments(s_phi, _t(da), m0, _t(phi_prev), SIZE,
                                hop).numpy()
    exact = (resid_in.astype(np.float64)[None]
             + np.cumsum(incr.astype(np.float64), axis=0)).astype(np.float32)
    last = min(max(f_real - 1, 0), len(da) - 1)
    assert np.array_equal(r_last.numpy(), exact[last])
    assert np.array_equal(p_last.numpy(), phi[last])
    want_p0 = phi[0] if m0 == 0 else phi0
    assert np.array_equal(p0_eff.numpy(), want_p0)
    step = np.float32(2.0 * np.pi / SIZE)
    hm = ((m0 + np.arange(len(da), dtype=np.int64)) * hop) % SIZE
    ramp = ((hm[:, None] * np.arange(NB)[None, :]) % SIZE).astype(
        np.float32) * step
    psi = (want_p0[None, :] + ramp) + exact
    assert np.array_equal(s_im.numpy(), psi)
    if m0 == 0:
        assert np.all(incr[0] == 0.0)
    # the entry as the render calls it: its carries, and without lock its
    # live-masked half spectrum from the same psi
    scan = kpv.phase_scan_plain(*args, cart=cart, lock=lock)
    whole = kpv.synth_ola_phase_plain(
        a, b, _t(da), _t(hann_window(SIZE)), m0, f_real, _t(phi0),
        _t(resid_in), _t(phi_prev), SIZE, hop, cart=cart, lock=lock)
    for got in (scan[3:], whole[1:]):
        assert all(torch.equal(g, w) for g, w in
                   zip(got, (r_last, p_last, p0_eff)))
    if not lock:
        mag = np.where((np.arange(len(da)) < f_real)[:, None],
                       s_re.numpy(), 0.0).astype(np.float32)
        np.testing.assert_allclose(scan[0].numpy(), mag * np.cos(psi),
                                   rtol=0, atol=2e-6 * mag.max())
        np.testing.assert_allclose(scan[1].numpy(), mag * np.sin(psi),
                                   rtol=0, atol=2e-6 * mag.max())
        assert scan[2] is None


def _blocked_resid(incr, resid_in, run, runs):
    """The scan kernel's float64 order (csrc/pv_synth_ola_phase.cu): serial
    run sums, tile totals as the runs' totals added in order, an exclusive
    prefix over tiles in ascending order, then each frame's prefix as tile
    prefix + earlier runs' totals + the run's increments so far, added to
    resid_in and rounded once to float32."""
    f, nb = incr.shape
    tile = run * runs
    n_tiles = -(-f // tile)
    x = np.zeros((n_tiles * tile, nb))
    x[:f] = incr
    x = x.reshape(n_tiles, runs, run, nb)
    run_tot = np.zeros((n_tiles, runs, nb))
    for j in range(run):
        run_tot += x[:, :, j]
    tile_tot = run_tot[:, 0].copy()
    for r in range(1, runs):
        tile_tot += run_tot[:, r]
    acc = np.zeros((n_tiles, nb))
    cur = np.zeros(nb)
    for t in range(n_tiles):
        acc[t] = cur
        cur = cur + tile_tot[t]
    out = np.empty_like(x)
    for r in range(runs):
        walk = acc.copy()
        for j in range(run):
            walk = walk + x[:, r, j]
            out[:, r, j] = walk
        acc = acc + run_tot[:, r]
    frames = out.reshape(n_tiles * tile, nb)[:f]
    return (resid_in.astype(np.float64)[None] + frames).astype(np.float32)


def test_scan_constants_match_the_kernel():
    """The wrapper's SCAN_RUN / SCAN_RUNS (which size the tile scratch and
    the model below) are the CUDA source's kScanRun / kScanRuns."""
    with open(os.path.join(CSRC, "pv_synth_ola_phase.cu")) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (kScanRuns?) = (\d+);", src))
    assert int(consts["kScanRun"]) == kpv.SCAN_RUN
    assert int(consts["kScanRuns"]) == kpv.SCAN_RUNS
    assert kpv.SCAN_TILE == kpv.SCAN_RUN * kpv.SCAN_RUNS


@pytest.mark.parametrize("frames", [1000, 2 * kpv.SCAN_TILE, 37])
def test_blocked_order_rounds_as_the_serial_float64_sum(frames):
    """Increments of a bent track's size (hop * pi / da, thousands of
    radians summed) through the kernel's blocked order and through one
    serial float64 sum: equal after rounding on >= 99.9% of entries, within
    one float32 spacing on all."""
    hop = 512
    rng = np.random.default_rng(frames)
    phi = _t(rng.uniform(-np.pi, np.pi, (frames, NB)).astype(np.float32))
    da = _t((hop * rng.uniform(0.5, 2.0, frames)).astype(np.float32))
    phi_prev = _t(rng.uniform(-np.pi, np.pi, NB).astype(np.float32))
    resid_in = rng.uniform(-4e4, 4e4, NB).astype(np.float32)
    incr = kpv.phase_increments(phi, da, 1, phi_prev, SIZE, hop).numpy()
    serial = (resid_in.astype(np.float64)[None]
              + np.cumsum(incr.astype(np.float64), axis=0)).astype(np.float32)
    blocked = _blocked_resid(incr.astype(np.float64), resid_in, kpv.SCAN_RUN,
                             kpv.SCAN_RUNS)
    assert blocked.shape == serial.shape == (frames, NB)
    assert np.mean(blocked == serial) >= 0.999
    assert np.all(np.abs(blocked - serial) <= np.spacing(np.abs(serial)))


def test_phase_scan_wrapper_on_cpu_tensors_runs_the_twin():
    m0, f_real, re_, im_, da, (phi0, resid_in, phi_prev) = _chunk(
        "chunk0", frames=40)
    args = (_t(re_), _t(im_), _t(da), m0, f_real, _t(phi0), _t(resid_in),
            _t(phi_prev), SIZE, 512)
    before = kpv.phase_scan.launches
    for lock in (False, True):
        got, want = (kpv.phase_scan(*args, lock=lock),
                     kpv.phase_scan_plain(*args, lock=lock))
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    assert kpv.phase_scan.launches == before


# ----------------------------------------------------------------------
# B2: twiddle tables and the pair transform
# ----------------------------------------------------------------------


def _ulps(table32, want64):
    """|float32 table - float64 value| in float32 spacings of the value."""
    return np.abs(table32.astype(np.float64) - want64) / np.spacing(
        np.abs(want64).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("name", ["pair", "radix2"])
def test_twiddle_tables_within_one_ulp_of_float64(name):
    """B2's pass twiddles (fft2048_pair.cuh) and the radix-2 table of B1 and
    B3's synthesis (fft2048.cuh): cos/sin of float64 angles, <= 1 ulp."""
    if name == "pair":
        got = kpv.pair_twiddles(torch.device("cpu")).numpy()
        k2, b = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
        q, c = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
        ang = np.concatenate([2 * np.pi * (b * k2).ravel() / 2048,
                              2 * np.pi * (c * q).ravel() / 128])
        assert got.shape == (16 * 128 + 16 * 8, 2)
    else:
        got = kpv.twiddles(torch.device("cpu")).numpy()
        ang = 2 * np.pi * np.arange(1024) / 2048
        assert got.shape == (1024, 2)
    assert got.dtype == np.float32
    assert _ulps(got[:, 0], np.cos(ang)).max() <= 1.0
    assert _ulps(got[:, 1], np.sin(ang)).max() <= 1.0


_C1 = np.float32(0.923879532511286756128)
_S1 = np.float32(0.382683432365089771728)
_R2 = np.float32(0.707106781186547524401)
_ROT16 = [(1, 0), (_C1, _S1), (_R2, _R2), (_S1, _C1), (0, 1), (-_S1, _C1),
          (-_R2, _R2), (-_C1, _S1)]  # cos, sin of 2 pi m / 16, m < 8


def _brev(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2)


def _dft_regs(v, sign):
    """fft2048_pair.cuh's dft_regs along axis 0 (complex64): radix-2
    decimation in frequency, the 16th roots as float32 constants; returns
    the output in natural order (the kernel's v[brev(k)])."""
    v = v.copy()
    n = v.shape[0]
    h = n // 2
    while h >= 1:
        for i in range(n):
            if i & h:
                continue
            u, w = v[i].copy(), v[i + h].copy()
            v[i] = u + w
            cs, sn = _ROT16[(i & (h - 1)) * (8 // h)]
            v[i + h] = (u - w) * np.complex64(cs + 1j * sign * sn)
        h //= 2
    return v[[_brev(k, n.bit_length() - 1) for k in range(n)]]


def pair_fft_model(z, sign):
    """The 2048-point transform of fft2048_pair.cuh on (2048,) complex64, in
    its three passes: index n = b + 128 a, output k = k2 + 16 (q + 16 r)."""
    tab = kpv.pair_twiddles(torch.device("cpu")).numpy()
    w = (tab[:, 0] + 1j * sign * tab[:, 1]).astype(np.complex64)
    tw1, tw2 = w[:2048].reshape(16, 128), w[2048:].reshape(16, 8)
    ex1 = _dft_regs(z.reshape(16, 128), sign)  # [k2][b] from z[b + 128 a]
    ex1[1:] *= tw1[1:]  # W_2048^(b k2)
    v = ex1.reshape(16, 16, 8).transpose(1, 0, 2)  # [a][k2][c], b = c + 8 a
    ex2 = _dft_regs(v, sign)  # [q][k2][c]
    ex2[1:] *= tw2[1:, None, :]  # W_128^(c q)
    u = ex2.transpose(2, 0, 1).reshape(8, 256)  # [c][p], p = k2 + 16 q
    return _dft_regs(u, sign).reshape(2048)  # X[p + 256 r]


def _pair_split(zk):
    """B2's epilogue: X_a = (Z[k] + conj Z[N-k]) / 2, X_b = (Z[k] - conj
    Z[N-k]) / 2i, componentwise in float32, k <= 1024."""
    k = np.arange(NB)
    z, zn = zk[k], zk[(2048 - k) % 2048]
    half = np.float32(0.5)
    re_a, im_a = half * (z.real + zn.real), half * (z.imag - zn.imag)
    re_b, im_b = half * (z.imag + zn.imag), half * (zn.real - z.real)
    return re_a + 1j * im_a, re_b + 1j * im_b


def _snr(got, want):
    return 10 * np.log10(np.sum(np.abs(got - want) ** 2)
                         / np.sum(np.abs(want) ** 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_model_splits_two_real_frames_as_rfft(seed):
    """Two windowed frames as one complex transform, then separated: each
    against np.fft.rfft of its frame in float64, SNR < -120 dB (and the
    DC/Nyquist imaginaries exactly 0, as a real input's are)."""
    rng = np.random.default_rng(seed)
    win = hann_window(SIZE)
    xa = (rng.standard_normal(SIZE) * 0.3).astype(np.float32) * win
    xb = (rng.standard_normal(SIZE) * 0.05).astype(np.float32) * win
    z = (xa + 1j * xb).astype(np.complex64)
    ya, yb = _pair_split(pair_fft_model(z, -1.0))
    for got, x in ((ya, xa), (yb, xb)):
        want = np.fft.rfft(x.astype(np.float64))
        assert _snr(got, want) < -120.0
        assert got[0].imag == 0.0 and got[-1].imag == 0.0


def test_pair_model_is_the_dft_both_ways():
    """The model's forward transform against np.fft.fft, and its inverse
    (sign +1, unscaled) of the forward back to 2048 z."""
    rng = np.random.default_rng(7)
    z = (rng.standard_normal(SIZE) + 1j * rng.standard_normal(SIZE)).astype(
        np.complex64)
    fwd = pair_fft_model(z, -1.0)
    assert _snr(fwd, np.fft.fft(z.astype(np.complex128))) < -120.0
    back = pair_fft_model(fwd, 1.0) / SIZE
    assert _snr(back, z.astype(np.complex128)) < -120.0
