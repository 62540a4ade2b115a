"""B3's and B10's pair synthesis and carried overlap-add, modelled on the CPU.

``csrc/pv_synth.cuh`` runs only on the card (chip_smoke.py holds B3 and B10
against their twins there, and the fused overlap-add against the frames
route bit for bit).  These tests hold what its design rests on:

* a NumPy transcription of the synthesis: two frames' half spectra staged
  as one float4 a bin (all three modes: B3's half spectrum, B10's polar
  (mag, psi), B3's locked (mag, psi, phi)), the load map Z[n] = X_a[n] +
  i X_b[n] with the mirror for n > 1023, the 2048-point inverse of
  ``csrc/fft_pair.cuh`` (``test_torch_fft.pair_model``) and the epilogue,
  against float64 ``np.fft.irfft`` times the window, and its overlap-add
  against the twin ``kpv.synth_ola_plain`` and JAX's ``istft_device``;
* the lock prologue at 128 threads (nine bins a thread, four warps, the
  shuffle scans and warp totals) bit for bit against ``kpv.identity_lock``
  and JAX's ``identity_lock``;
* the fused overlap-add's ownership: each sample written once, the
  recomputed frames, and float32 sums bit-equal to ``ola_kernel``'s order;
* the header's constants: the routes' hops, shared memory per CTA;
* which C entry each wrapper calls, with which table and route.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.engine import phase_vocoder as jpv
from melonix_tpu.engine import spectral as jspec

from melonix_tpu_torch.engine.spectral import hann_window
from melonix_tpu_torch.kernels import pv as kpv
from test_torch_fft import pair_model
from torch_fake_card import fake_card
from test_torch_scan import _snr

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")
N = 2048
NB = N // 2 + 1
T = 128  # Pair<2048>::kThreads
PER = -(-NB // T)  # bins a thread of the lock prologue owns
WARPS = T // 32
BIG = 0x7FFFFFFF  # kNoPeakAbove
MODES = ("half", "polar", "locked")
F32 = np.float32


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ----------------------------------------------------------------------
# The lock prologue at 128 threads
# ----------------------------------------------------------------------


def lock_model(psi, phi, mag):
    """lock_pair for one frame as the CUDA threads compute it: (n_bins,)
    float32 in, locked psi out.  Thread t owns bins [9 t, 9 t + 9); a warp's
    inclusive max/min scans of the threads' last/first peaks, the warp
    totals, each thread's exclusive neighbours, then its nine bins."""
    theta = (psi - phi).astype(F32)
    k = np.arange(NB)

    def at(i):
        return np.where((i >= 0) & (i < NB), mag[np.clip(i, 0, NB - 1)],
                        F32(-1.0))

    peak = ((mag > 0) & (mag > at(k - 1)) & (mag > at(k - 2))
            & (mag >= at(k + 1)) & (mag >= at(k + 2)))
    pk = np.zeros(T * PER, bool)
    pk[:NB] = peak
    pk = pk.reshape(T, PER)
    idx = np.arange(T * PER).reshape(T, PER)
    last = np.where(pk, idx, -1).max(axis=1)
    first = np.where(pk, idx, BIG).min(axis=1)
    incl_last = np.maximum.accumulate(last.reshape(WARPS, 32), axis=1)
    incl_first = np.minimum.accumulate(
        first.reshape(WARPS, 32)[:, ::-1], axis=1)[:, ::-1]
    w_last, w_first = incl_last[:, 31], incl_first[:, 0]
    out = np.empty(NB, F32)
    for t in range(T):
        warp, lane = divmod(t, 32)
        below = incl_last[warp, lane - 1] if lane > 0 else -1
        above = incl_first[warp, lane + 1] if lane < 31 else BIG
        below = max([below, *w_last[:warp]])
        above = min([above, *w_first[warp + 1:]])
        near_below = []
        for i in range(PER):
            if pk[t, i]:
                below = t * PER + i
            near_below.append(below)
        for i in reversed(range(PER)):
            kk = t * PER + i
            if kk >= NB:
                continue
            if pk[t, i]:
                above = kk
            d_f = kk - near_below[i] if near_below[i] != -1 else 1 << 30
            d_b = above - kk if above != BIG else 1 << 30
            th = theta[kk]
            if min(d_f, d_b) < 1 << 30:
                th = theta[near_below[i] if d_f <= d_b else above]
            out[kk] = phi[kk] + th
    return out


def _lock_frames(kind, rng, f=6):
    """(psi, phi, mag) float32 (f, 1025) of one kind of frame."""
    phi = rng.uniform(-np.pi, np.pi, (f, NB)).astype(F32)
    psi = (phi + rng.uniform(-40.0, 40.0, (f, NB))).astype(F32)
    if kind == "random":
        mag = rng.exponential(1.0, (f, NB))
    elif kind == "ties":  # few levels, equal distances, at thread and warp
        mag = rng.integers(0, 4, (f, NB)).astype(np.float64)  # edges
        mag[:, 100:110] = 2.0  # a plateau
        mag[:, 200:205] = [1, 3, 1, 3, 1]  # peaks 2 apart: a midpoint tie
        mag[:, 5:14] = [0, 5, 0, 0, 0, 0, 0, 5, 0]  # tie at bin 9 = thread 1
        mag[:, 283:294] = [0, 0, 7, 0, 0, 0, 0, 0, 7, 0, 0]  # warp 1 at 288
    elif kind == "no_peak":  # silent frames (mag > 0 holds nowhere), then
        mag = np.zeros((f, NB))  # one peak, a flat frame (its peak is bin
        mag[3, 700] = 0.5  # 0: the edges are -1) and a two-bin plateau
        mag[4] = 1.0
        mag[5, 1:3] = 2.0
    else:  # edges: peaks at bins 0, 1, 1023 and 1024, alone and together
        mag = np.zeros((f, NB))
        mag[0, 0], mag[1, 1], mag[2, NB - 2], mag[3, NB - 1] = 1, 1, 1, 1
        mag[4, [0, NB - 1]] = 2.0
        mag[5, [1, NB - 2, 512]] = 3.0
    return psi, phi, mag.astype(F32)


@pytest.mark.parametrize("kind", ["random", "ties", "no_peak", "edges"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lock_at_128_threads_is_identity_lock_bit_for_bit(kind, seed):
    """The thread layout of lock_pair (kPer 9, four warps) picks the same
    peak as kpv.identity_lock and JAX's identity_lock for every bin."""
    psi, phi, mag = _lock_frames(kind, np.random.default_rng(seed))
    want = kpv.identity_lock(torch.from_numpy(psi), torch.from_numpy(phi),
                             torch.from_numpy(mag)).numpy()
    want_j = np.asarray(jpv.identity_lock(jnp.asarray(psi), jnp.asarray(phi),
                                          jnp.asarray(mag)))
    assert np.array_equal(want.view(np.uint32), want_j.view(np.uint32))
    for m in range(psi.shape[0]):
        got = lock_model(psi[m], phi[m], mag[m])
        assert np.array_equal(got.view(np.uint32), want[m].view(np.uint32)), m


def test_lock_constants_match_the_header():
    """kPer = ceil(1025 / 128) = 9 bins a thread fit the 32-bit peak mask;
    kWarps = 4; the thread count is Pair<2048>'s."""
    src = _read("pv_synth.cuh")
    assert "constexpr int kPer = (kBins + kThreads - 1) / kThreads;" in src
    assert "constexpr int kWarps = kThreads / 32;" in src
    assert "constexpr int kThreads = SynthPair::kThreads;" in src
    assert "using SynthPair = pf::Pair<2048>;" in src
    assert PER == 9 and WARPS == 4 and PER <= 32


# ----------------------------------------------------------------------
# The pair synthesis
# ----------------------------------------------------------------------


def polar_model(mag, psi):
    """polar_bin's sin and cos: psi reduced by whole turns in float64, the
    remainder as two floats hi + lo, sin/cos of hi in float32 and lo to
    first order (NumPy has no fma: each product rounds, the float64 turn
    count's product as well)."""
    d = psi.astype(np.float64)
    r = d - np.rint(d / (2.0 * np.pi)) * (2.0 * np.pi)
    hi = r.astype(F32)
    lo = (r - hi.astype(np.float64)).astype(F32)
    sn, cs = np.sin(hi), np.cos(hi)
    return mag * (cs - sn * lo), mag * (sn + cs * lo)


@pytest.mark.parametrize("scale", [np.pi, 4e4, 1.2e5, 8e5, 3e7])
def test_polar_reduction_keeps_sincosf_accuracy(scale):
    """Up to the phases a long track reaches (8e5 rad) and past them, the
    float64 reduction plus the first-order remainder stays within 2.5e-7
    of float64 cos/sin of the float32 angle: a few float32 spacings, as
    sincosf's own exact reduction (not __sincosf's, which loses digits)."""
    rng = np.random.default_rng(int(scale))
    psi = rng.uniform(-scale, scale, 200_000).astype(F32)
    psi[:4] = [F32(scale), -F32(scale), F32(np.pi), F32(2 * np.pi)]
    re, im = polar_model(np.ones_like(psi), psi)
    d = psi.astype(np.float64)
    assert np.abs(re - np.cos(d)).max() < 2.5e-7
    assert np.abs(im - np.sin(d)).max() < 2.5e-7


def test_polar_bin_is_the_modelled_reduction():
    """The header's polar_bin: whole turns in float64, hi + lo, sincosf of
    hi, lo to first order with fmaf."""
    src = _read("pv_synth.cuh")
    body = src[src.index("float2 polar_bin("):src.index("// Identity locking")]
    for line in ("const double r = fma(-rint(d * (1.0 / kTwoPi)), kTwoPi, d);",
                 "const float hi = static_cast<float>(r);",
                 "sincosf(hi, &sn, &cs);",
                 "const float s = fmaf(cs, lo, sn), c = fmaf(-sn, lo, cs);"):
        assert line in body, line
    assert "__sincosf" not in body


def _inputs(mode, f, seed):
    """The rows a mode reads, (f, 1025) float32, and (mag, psi) of the
    spectrum they stand for (live-masked, locked) for the twin."""
    rng = np.random.default_rng(seed)
    mag = rng.exponential(0.3, (f, NB)).astype(F32)
    phi = rng.uniform(-np.pi, np.pi, (f, NB)).astype(F32)
    psi = (phi + rng.uniform(-4e3, 4e3, (f, NB))).astype(F32)
    f_real = max(f - 2, 1)
    if mode == "half":  # B3's scan wrote the masked half spectrum
        re, im = polar_model(mag, psi)
        return (re, im), (mag, psi), f_real
    if mode == "polar":  # B10's caller masked mag
        return (mag, psi), (mag, psi), f_real
    locked = np.stack([lock_model(psi[m], phi[m], mag[m]) for m in range(f)])
    live = np.where(np.arange(f)[:, None] < f_real, mag, F32(0.0))
    return (mag, psi, phi), (live, locked), f_real


def stage_model(mode, rows, f_real, ma):
    """The staged bins of the pair (ma, ma + 1): (1025, 4) float32 (X_a.re,
    X_a.im, X_b.re, X_b.im), the DC/Nyquist imaginaries dropped, a frame
    past the last zero."""
    f = rows[0].shape[0]
    out = np.zeros((NB, 4), F32)
    for h, m in enumerate((ma, ma + 1)):
        if m >= f:
            continue
        if mode == "half":
            re, im = rows[0][m], rows[1][m].copy()
        elif mode == "polar":
            re, im = polar_model(rows[0][m], rows[1][m])
        else:
            mag, psi, phi = (r[m] for r in rows)
            live = mag if m < f_real else np.zeros_like(mag)
            re, im = polar_model(live, lock_model(psi, phi, mag))
        im = im.copy()
        im[[0, NB - 1]] = 0.0
        out[:, 2 * h], out[:, 2 * h + 1] = re, im
    return out


def load_model(st):
    """Z[n] for n < 2048 as the threads read it: bins n <= 1023 directly,
    the rest through the mirror 2048 - n, each component one float32 add."""
    n = np.arange(N)
    direct = n < N // 2
    x = st[np.where(direct, n, N - n)]
    re = np.where(direct, x[:, 0] - x[:, 3], x[:, 0] + x[:, 3])
    im = np.where(direct, x[:, 1] + x[:, 2], x[:, 2] - x[:, 1])
    z = np.empty(N, np.complex64)
    z.real, z.imag = re, im
    return z


def synth_model(mode, rows, f_real, win):
    """(F, 2048) float32 frame rows of the pair synthesis, each z / 2048 *
    win with both products rounded."""
    f = rows[0].shape[0]
    pairs = range((f + 1) // 2)
    z = np.stack([load_model(stage_model(mode, rows, f_real, 2 * p))
                  for p in pairs], axis=1)
    x = pair_model(z, 1.0, N)  # (2048, pairs)
    out = np.empty((2 * len(pairs), N), F32)
    out[0::2] = (x.real.T * F32(1.0 / N)) * win
    out[1::2] = (x.imag.T * F32(1.0 / N)) * win
    return out[:f]


def ola_order_model(frames, hop):
    """ola_kernel's sums: each sample from 0.0f over its frames in
    ascending order, float32."""
    f = frames.shape[0]
    y = np.zeros((f - 1) * hop + N, F32)
    for m in range(f):
        y[m * hop : m * hop + N] += frames[m]
    return y


@pytest.mark.parametrize("f", [1, 6, 7])
@pytest.mark.parametrize("mode", MODES)
def test_pair_synthesis_matches_float64_irfft(mode, f):
    """Each frame of the model against float64 irfft of its staged half
    spectrum times the window: < -120 dB over the frames; frame b of an
    odd count's last pair is never produced."""
    win = hann_window(N)
    rows, _spec, f_real = _inputs(mode, f, seed=f)
    got = synth_model(mode, rows, f_real, win)
    assert got.shape == (f, N) and got.dtype == F32
    want = np.empty((f, N))
    for m in range(f):
        st = stage_model(mode, rows, f_real, m - m % 2)[:, 2 * (m % 2):]
        spec = st[:, 0].astype(np.float64) + 1j * st[:, 1]
        want[m] = np.fft.irfft(spec, n=N) * win.astype(np.float64)
    assert _snr(got, want) < -120.0
    if mode == "locked" and f > 2:  # the frames at or past f_real are
        # silent: exactly where both frames of a pair are, to rounding where
        # a live frame shares the transform
        assert np.abs(got[f_real:]).max() <= 1e-6 * np.abs(got).max()


@pytest.mark.parametrize("f", [1, 6, 7])
@pytest.mark.parametrize("mode", MODES)
def test_pair_synthesis_ola_matches_the_twin(mode, f):
    """The model's overlap-add against kpv.synth_ola_plain (torch.polar and
    cuFFT's twin, irfft) and JAX's istft_device on the spectrum the rows
    stand for (masked, locked): two float32 computations, < -110 dB."""
    hop = 512
    win = hann_window(N)
    rows, (mag, psi), f_real = _inputs(mode, f, seed=10 + f)
    got = ola_order_model(synth_model(mode, rows, f_real, win), hop)
    want = kpv.synth_ola_plain(torch.from_numpy(mag), torch.from_numpy(psi),
                               torch.from_numpy(win), N, hop).numpy()
    assert got.shape == want.shape == ((f - 1) * hop + N,)
    assert _snr(got, want) < -110.0
    want_j = np.asarray(jspec.istft_device(
        jnp.asarray(mag) * jnp.exp(1j * jnp.asarray(psi)), jnp.asarray(win),
        N, hop, got.shape[0], normalize=False))
    assert _snr(got, want_j) < -110.0


def test_load_map_reads_whole_rows_of_banks():
    """Each quarter-warp's float4 reads of the staged bins hit eight
    consecutive bins (forward for n <= 1023, backward for the mirror):
    128 contiguous bytes, 32 distinct banks, for every a < 16."""
    for a in range(16):
        for q in range(T // 8):
            n = q * 8 + np.arange(8) + T * a
            k = np.where(n < N // 2, n, N - n)
            assert np.ptp(k) == 7 and len(set(k)) == 8
            banks = {(4 * kk + w) % 32 for kk in k for w in range(4)}
            assert len(banks) == 32


# ----------------------------------------------------------------------
# The fused overlap-add: ownership, recomputation and order
# ----------------------------------------------------------------------


def fused_ola_model(frames, hop, grid):
    """synth_pair_kernel's fused epilogue over a grid of CTAs, each with its
    ring: (y, writes a sample, frames recomputed before each CTA's own)."""
    f = frames.shape[0]
    n_pairs = (f + 1) // 2
    g = min(grid, n_pairs)  # pf::persistent_grid: at most one CTA a pair
    out_len = (f - 1) * hop + N
    y = np.zeros(out_len, F32)
    writes = np.zeros(out_len, np.int64)
    ring_n = N + 2 * hop
    extra = []
    for c in range(g):
        p_s, p_e = n_pairs * c // g, n_pairs * (c + 1) // g
        back = -(-N // hop) - 1
        m_s = 2 * p_s
        p0 = (m_s - back) // 2 if m_s >= back else 0
        own_lo = m_s * hop
        own_hi = out_len if c == g - 1 else 2 * p_e * hop
        extra.append((c, list(range(2 * p0, m_s)), m_s))
        ring = np.zeros(ring_n, F32)
        for p in range(p0, p_e):
            ma, mb = 2 * p, 2 * p + 1
            has_b = mb < f
            j0 = ma * hop
            span = hop + N if has_b else N
            fin = span if p == n_pairs - 1 else 2 * hop
            o = np.arange(span)
            r = j0 % ring_n + o
            r[r >= ring_n] -= ring_n
            assert r.max() < ring_n and len(set(r)) == span
            s = ring[r]
            ia = o < N
            s[ia] = s[ia] + frames[ma, o[ia]]
            ob = o - hop
            ib = (ob >= 0) & (ob < N) & has_b
            if has_b:
                s[ib] = s[ib] + frames[mb, ob[ib]]
            final = o < fin
            j = j0 + o
            own = final & (j >= own_lo) & (j < own_hi)
            y[j[own]] = s[own]
            writes[j[own]] += 1
            s[final] = 0.0
            ring[r] = s
    return y, writes, extra


@pytest.mark.parametrize("grid", [1, 2, 3, 17, 64, 151, 300])
@pytest.mark.parametrize("hop", [512, 441, 1024, 256, 2048])
def test_fused_ola_is_ola_kernel_order_bit_for_bit(hop, grid):
    """Over 301 frames (odd) of random float32 samples: every output sample
    written exactly once, bit-equal to ola_kernel's ascending float32 sums;
    each CTA recomputes every earlier frame that reaches its first sample
    and at most one more (its pair partner)."""
    rng = np.random.default_rng(hop + grid)
    frames = rng.standard_normal((301, N)).astype(F32)
    frames[7] = -0.0  # signed zeros: 0.0f + -0.0f is +0.0f in both orders
    y, writes, extra = fused_ola_model(frames, hop, grid)
    assert (writes == 1).all()
    want = ola_order_model(frames, hop)
    assert np.array_equal(y.view(np.uint32), want.view(np.uint32))
    for _c, redone, m_s in extra:
        needed = [m for m in range(m_s) if m * hop + N > m_s * hop]
        assert set(needed) <= set(redone)
        assert len(redone) - len(needed) <= 1
        assert len(redone) <= -(-N // hop)  # ceil(2048 / hop) - 1, + 1


@pytest.mark.parametrize("f", [1, 2, 3])
def test_fused_ola_at_one_to_three_frames(f):
    """One, two and three frames: one CTA a pair, the last through the end
    (one frame: 2048 samples, nothing before it)."""
    frames = np.random.default_rng(f).standard_normal((f, N)).astype(F32)
    for grid in (1, 2):
        y, writes, _extra = fused_ola_model(frames, 512, grid)
        assert (writes == 1).all()
        assert np.array_equal(y, ola_order_model(frames, 512))


# ----------------------------------------------------------------------
# The header's constants: routes, shared memory
# ----------------------------------------------------------------------


def _pair_buf():
    """Pair<2048>::kBuf from fft_pair.cuh's Plan<2048> strides."""
    s1, s2 = map(int, re.search(
        r"struct Plan<2048> \{ static constexpr int kStride1 = (\d+), "
        r"kStride2 = (\d+); \};", _read("fft_pair.cuh")).groups())
    return max(16 * s1, 8 * s2, N)


def test_route_hops_match_the_header():
    """kOlaMinHop = kN / 8 (ceil(2048 / hop) <= 8) and kOlaMaxHop = kN in
    the header are kpv.OLA_MIN_HOP / OLA_MAX_HOP; the hop alone picks the
    route, hop 1 and hops past the frame take the frames route."""
    src = _read("pv_synth.cuh")
    assert "constexpr int kOlaMinHop = kN / 8;" in src
    assert "constexpr int kOlaMaxHop = kN;" in src
    assert (kpv.OLA_MIN_HOP, kpv.OLA_MAX_HOP) == (N // 8, N)
    assert all(-(-N // h) <= 8 for h in range(kpv.OLA_MIN_HOP, N + 1))
    routes = {h: kpv.ola_route(h) for h in (1, 255, 256, 441, 512, 1024,
                                           2048, 2049, 4096)}
    assert routes == {1: "frames", 255: "frames", 256: "fused",
                      441: "fused", 512: "fused", 1024: "fused",
                      2048: "fused", 2049: "frames", 4096: "frames"}


@pytest.mark.parametrize("hop,fused,ctas", [
    (512, False, 4), (512, True, 4), (256, True, 4), (2048, True, 3),
])
def test_shared_memory_per_cta(hop, fused, ctas):
    """synth_smem: the two exchange buffers (which also hold the staged
    bins and the lock's rows), plus the fused ring of 2048 + 2 hop floats,
    plus the lock's 64 bytes of warp totals: within 227 KB a CTA, and
    `ctas` CTAs a SM, the smaller of what 228 KB holds at 1 KB reserved
    each and the register cap's four (__launch_bounds__(128, 4))."""
    src = _read("pv_synth.cuh")
    assert ("constexpr size_t kSmemPair = 2 * SynthPair::kBuf * "
            "sizeof(float2);") in src
    assert "return kN + 2 * hop;" in src
    assert "return kSmemPair + (fused ? sizeof(float) * ring_len(hop) : 0);" \
        in src
    buf = _pair_buf()
    assert buf == 2176 and 4 * NB <= 2 * buf  # float4 bins / 4 lock rows
    smem = 2 * buf * 8 + (4 * (N + 2 * hop) if fused else 0) + 4 * 2 * 4 * 2
    assert smem <= 227 * 1024
    assert min((228 * 1024) // (smem + 1024), 4) == ctas


# ----------------------------------------------------------------------
# The wrappers: entry, table, route
# ----------------------------------------------------------------------


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on the fake card with a recording twiddle
    table."""
    rec = fake_card(monkeypatch)
    rec.tables = []
    real = kpv.pair_twiddles

    def tables(size, device):
        rec.tables.append(size)
        return real(size, device)

    monkeypatch.setattr(kpv, "pair_twiddles", tables)
    return rec


def _meta(*shape):
    return torch.zeros(shape).to("meta")


@pytest.mark.parametrize("cart,lock", [(True, False), (False, False),
                                       (True, True)])
@pytest.mark.parametrize("hop,fused", [(512, 1), (441, 1), (128, 0)])
def test_b3_launches_its_entry_with_the_pair_table(fake_cuda, cart, lock,
                                                   hop, fused):
    """Every B3 entry calls mlx_pv_synth_ola_phase once with the 2048-point
    pair table; the hop picks the route (no frame matrix when fused)."""
    before = kpv.synth_ola_phase.launches
    f = 15
    y, *_carries = kpv.synth_ola_phase(
        _meta(f, NB), _meta(f, NB), _meta(f), _meta(N), 0, f - 2, _meta(NB),
        _meta(NB), _meta(NB), N, hop, cart=cart, lock=lock)
    assert y.shape == ((f - 1) * hop + N,)
    (name, args), = fake_cuda.calls
    assert name == "mlx_pv_synth_ola_phase"
    assert fake_cuda.tables == [N]
    assert (args[12] is None) == bool(fused)  # frames scratch
    assert (args[11] is None) == (not lock)  # s_phi
    assert args[17:24] == (f, 0, f - 2, hop, int(cart), int(lock), fused)
    assert kpv.synth_ola_phase.launches == before + 1


@pytest.mark.parametrize("hop,route,fused", [
    (512, None, 1), (441, None, 1), (1, None, 0), (255, None, 0),
    (2049, None, 0), (512, "frames", 0), (2048, "fused", 1),
])
def test_b10_launches_its_entry_on_the_hops_route(fake_cuda, hop, route,
                                                  fused):
    """B10 takes any hop >= 1 through mlx_pv_synth_ola with the pair table;
    ``route`` forces the frames route anywhere, the fused one only where
    kpv.ola_route names it."""
    f = 9
    y = kpv.synth_ola(_meta(f, NB), _meta(f, NB), _meta(N), N, hop,
                      route=route)
    assert y.shape == ((f - 1) * hop + N,)
    (name, args), = fake_cuda.calls
    assert name == "mlx_pv_synth_ola" and fake_cuda.tables == [N]
    assert (args[4] is None) == bool(fused)
    assert args[6:9] == (f, hop, fused)


@pytest.mark.parametrize("hop,route", [(128, "fused"), (4096, "fused"),
                                       (512, "carried")])
def test_routes_refused_before_a_launch(fake_cuda, hop, route):
    with pytest.raises(ValueError, match="route"):
        kpv.synth_ola(_meta(3, NB), _meta(3, NB), _meta(N), N, hop,
                      route=route)
    with pytest.raises(ValueError, match="route"):
        kpv.synth_ola_phase(_meta(3, NB), _meta(3, NB), _meta(3), _meta(N),
                            0, 3, _meta(NB), _meta(NB), _meta(NB), N, hop,
                            route=route)
    assert fake_cuda.calls == []


def test_cpu_tensors_run_the_twins_on_either_route():
    """On the CPU the route changes nothing: the wrappers run the twins."""
    rows, (mag, psi), _f_real = _inputs("polar", 5, seed=3)
    win = torch.from_numpy(hann_window(N))
    m, p = torch.from_numpy(mag), torch.from_numpy(psi)
    want = kpv.synth_ola_plain(m, p, win, N, 512)
    for route in (None, "frames", "fused"):
        assert torch.equal(kpv.synth_ola(m, p, win, N, 512, route=route),
                           want)
