"""Identity phase locking, the phase vocoder at other frame sizes and the
multichannel PV render of melonix_tpu_torch (CPU, plain twins) against
melonix_tpu on the CPU.

``identity_lock`` (B3 ``lock=True``'s plain twin) and B9's twin
(``extract_frames_plain``) are exact, so they are held bit for bit.  PV
renders are compared by the JAX suite's convention (test_pallas.py:473-523):
equal length, rms < 5e-3 of the peak, spectral-envelope error < 2e-2.
Every input is made from a seeded numpy generator, and a chunk comparison
carries one PVPlan, built by JAX, into the port (``pv_plan_from_numpy``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.engine import phase_vocoder as jpv
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.session import render_session as j_render_session
from melonix_tpu.engine.spectral import hann_window as j_hann
from melonix_tpu.kernels import pallas_frames
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import phase_vocoder as tpv
from melonix_tpu_torch.kernels import frames as kframes
from melonix_tpu_torch.kernels import pv as kpv

torch.set_num_threads(2)

SR = 8000
N = 3 * SR


def _song(seed=21, n=N, sr=SR):
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    w = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 445 * t)
         + 0.01 * rng.standard_normal(n))
    return w.astype(np.float32)


def _markers(count):
    if count == 1:
        return [(N // 2, 57.0, 0.03, 3.0)]
    rng = np.random.default_rng(1234)
    samples = np.sort(rng.choice(np.arange(500, N - 500), count, replace=False))
    return [(int(s), 57.0, float(rng.uniform(-0.02, 0.02)),
             float(rng.uniform(-4, 4))) for s in samples]


def _knots(markers, sr=SR, n=N):
    return (JMapKnots.from_markers([JMarker(*m) for m in markers], sr, n),
            mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], sr, n))


def _assert_pv_close(got, want, rms_bar=5e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want)
    scale = float(np.abs(want).max())
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rms < rms_bar * scale, rms / scale
    nseg = len(want) // 2048
    f_g = np.abs(np.fft.rfft(got[: nseg * 2048].reshape(nseg, 2048), axis=1))
    f_w = np.abs(np.fft.rfft(want[: nseg * 2048].reshape(nseg, 2048), axis=1))
    env = np.abs(f_g - f_w).max() / f_w.max()
    assert env < 2e-2, env


# ----------------------------------------------------------------------
# identity_lock: bit for bit
# ----------------------------------------------------------------------


def _spectra(kind, rng, f=24, n=1025):
    phi = rng.uniform(-np.pi, np.pi, (f, n)).astype(np.float32)
    psi = (phi + rng.uniform(-40.0, 40.0, (f, n))).astype(np.float32)
    if kind == "random":
        mag = rng.exponential(1.0, (f, n))
    elif kind == "ties":  # few levels: equal neighbours and equal distances
        mag = rng.integers(0, 4, (f, n)).astype(np.float64)
        mag[:, 100:110] = 2.0  # a plateau
        mag[:, 200:205] = [1, 3, 1, 3, 1]  # peaks 2 apart: a midpoint tie
    elif kind == "tones":  # windowed partials, a silent frame, a quiet one
        t = np.arange(2 * (n - 1))
        win = np.hanning(len(t))
        freqs = rng.uniform(5.0, n - 5.0, (f, 3))
        sig = sum(np.sin(2 * np.pi * freqs[:, i : i + 1] * t / len(t))
                  for i in range(3))
        mag = np.abs(np.fft.rfft(sig * win, axis=1))
        mag[3] = 0.0
        mag[4] *= 1e-30
    else:  # edges: peaks at bins 0, 1, n-2 and n-1, one peak only
        mag = np.zeros((f, n))
        mag[0, 0], mag[1, n - 1], mag[2, 1], mag[3, n - 2] = 1, 1, 1, 1
        mag[4, 0] = mag[4, n - 1] = 2.0
        mag[5, 500] = 1.0
        mag[6:] = rng.exponential(1.0, (f - 6, n))
        mag[6:, :2] = 9.0
        mag[6:, -2:] = 9.0
    return psi, phi, mag.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "tones", "edges"])
def test_identity_lock_matches_jax_bit_for_bit(kind):
    psi, phi, mag = _spectra(kind, np.random.default_rng(5))
    want = np.asarray(jax.jit(jpv.identity_lock)(
        jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(mag)))
    got = mt.identity_lock(torch.from_numpy(psi), torch.from_numpy(phi),
                           torch.from_numpy(mag)).numpy()
    np.testing.assert_array_equal(got, want)


def test_identity_lock_region_rules():
    """The JAX suite's region case (test_phase_vocoder.py:171-190) and its
    silent frame, which returns phi + (psi - phi), not psi."""
    mag = np.zeros((1, 16), np.float32)
    mag[0, 3], mag[0, 10] = 1.0, 0.8
    mag[0, 2] = mag[0, 4] = 0.5
    phi = np.linspace(0.0, 3.0, 16, dtype=np.float32)[None]
    psi = (phi[0] + np.linspace(5.0, 9.0, 16, dtype=np.float32))[None]
    out = mt.identity_lock(*(torch.from_numpy(a) for a in (psi, phi, mag)))
    theta = psi - phi
    k = np.arange(16)
    want = phi + np.where((k - 3) <= (10 - k), theta[0, 3], theta[0, 10])
    np.testing.assert_array_equal(out.numpy(), want)
    silent = mt.identity_lock(torch.from_numpy(psi), torch.from_numpy(phi),
                              torch.zeros(1, 16)).numpy()
    np.testing.assert_array_equal(silent, phi + (psi - phi))


# ----------------------------------------------------------------------
# B3 lock=True's twin, both entries, against JAX's natural locked chunk
# ----------------------------------------------------------------------


@pytest.mark.parametrize("formant", [False, True])
def test_locked_chunk_matches_jax(formant):
    """The port's chunk (B2's twin, then B3's twin with lock=True through
    its (re, im) entry, or through (mag, phi) with the formant warp) against
    JAX's natural-order chunk (``_stretch_chunk_core``, fused=False) from
    one JAX plan, a second chunk with carries included."""
    w = _song()
    jk, _pk = _knots(_markers(9))
    jplan = jpv.build_pv_plan(jk, N)
    plan = tpv.pv_plan_from_numpy(
        {k: getattr(jplan, k) for k in jplan.__dataclass_fields__})
    ch, size, hop = 16, jplan.size, jplan.hop
    win = j_hann(size)
    z = jnp.zeros(size // 2 + 1, jnp.float32)

    def j_chunk(m0, carries):
        starts, da, rho, f_real = jpv._chunk_arrays(jplan, m0, ch)
        return jpv._stretch_chunk(  # _stretch_chunk_core, jitted, fused=False
            jnp.asarray(w), jnp.asarray(starts), jnp.asarray(da),
            jnp.asarray(rho), jnp.asarray(win), jnp.int32(m0),
            jnp.int32(f_real), *carries, size=size, hop=hop, n_frames_c=ch,
            formant=formant, lock=True)

    _y0, r0, pl0, p00 = j_chunk(0, (z, z, z))
    y1_j, r1_j, pl1_j, p01_j = j_chunk(ch, (p00, r0, pl0))
    starts, da, rho, f_real = tpv._chunk_arrays(plan, ch, ch)
    y1, r1, pl1, p01 = tpv._stretch_chunk_core(
        torch.from_numpy(w), torch.from_numpy(starts), torch.from_numpy(da),
        torch.from_numpy(win), ch, f_real,
        *(torch.from_numpy(np.array(c)) for c in (p00, r0, pl0)),
        size=size, hop=hop, rho_c=torch.from_numpy(rho), formant=formant,
        lock=True)
    assert np.array_equal(p01.numpy(), np.asarray(p01_j))
    dphi = np.angle(np.exp(1j * (pl1.numpy() - np.asarray(pl1_j))))
    assert np.median(np.abs(dphi)) < 1e-5 and np.abs(dphi).max() < 1e-3
    assert np.median(np.abs(r1.numpy() - np.asarray(r1_j))) < 1e-3
    _assert_pv_close(y1.numpy(), np.asarray(y1_j))


def test_b3_lock_twin_is_classic_plus_identity_lock():
    """B3's lock=True twin on (re, im) equals the classic twin's phase
    formulas followed by identity_lock: the locked output differs from the
    classic one, and its (mag, phi) entry gives the same chunk."""
    rng = np.random.default_rng(9)
    f, size, hop = 12, 2048, 512
    wav = torch.from_numpy(rng.standard_normal(f * hop + size)
                           .astype(np.float32))
    win = torch.from_numpy(j_hann(size))
    starts = torch.arange(f, dtype=torch.int32) * hop
    re, im = kpv.analysis_plain(wav, starts, win, size)
    da = torch.full((f,), float(hop))
    z = torch.zeros(size // 2 + 1)
    args = (da, win, 0, f - 2, z, z, z, size, hop)
    y_l = kpv.synth_ola_phase(re, im, *args, lock=True)
    y_c = kpv.synth_ola_phase(re, im, *args)
    y_m = kpv.synth_ola_phase(torch.sqrt(re * re + im * im),
                              torch.atan2(im, re), *args, cart=False,
                              lock=True)
    assert not torch.allclose(y_l[0], y_c[0])
    for a, b in zip(y_l, y_m):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for a, b in zip(y_l[1:], y_c[1:]):  # locking carries no state
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# Locked renders
# ----------------------------------------------------------------------


@pytest.mark.parametrize("count,formant,chunk", [
    (9, False, None), (9, True, None), (1, False, 32), (9, True, 32),
])
def test_locked_render_matches_jax(monkeypatch, count, formant, chunk):
    """render_track_pv(phase_locking=True) in one chunk and in 32-frame
    chunks (both packages), with and without formants, against JAX."""
    w = _song()
    jk, pk = _knots(_markers(count))
    if chunk:
        monkeypatch.setattr(tpv, "PV_CHUNK_FRAMES", chunk)
        monkeypatch.setattr(jpv, "PV_CHUNK_FRAMES", chunk)
        assert tpv.build_pv_plan(pk, N).n_frames > chunk
    want = jpv.render_track_pv(w, jk, phase_locking=True,
                               preserve_formants=formant)
    got = mt.render_track_pv(w, pk, device="cpu", phase_locking=True,
                             preserve_formants=formant)
    _assert_pv_close(got, want)


def test_chunked_locked_render_matches_one_shot(monkeypatch):
    """Locking carries no state: 32-frame chunks agree with one chunk by the
    bar of test_phase_vocoder.py:245-264 (rms 2e-3 of the signal's rms)."""
    w = _song()
    _jk, pk = _knots(_markers(9))
    single = mt.render_track_pv(w, pk, device="cpu", phase_locking=True)
    monkeypatch.setattr(tpv, "PV_CHUNK_FRAMES", 32)
    chunked = mt.render_track_pv(w, pk, device="cpu", phase_locking=True)
    err = np.sqrt(np.mean((single - chunked) ** 2)) / np.sqrt(np.mean(single ** 2))
    assert len(single) == len(chunked) and err < 2e-3, err


def _mod_index(y, sr):
    """Amplitude-modulation index of the four strongest partials over the
    steady plateau (test_phase_vocoder.py:206-222)."""
    size, hop = 2048, 512
    seg = y[int(1.2 * sr): int(2.8 * sr)]
    n_f = (len(seg) - size) // hop
    fr = np.stack([seg[i * hop: i * hop + size] for i in range(n_f)])
    mags = np.abs(np.fft.rfft(fr * np.hanning(size)))
    mean = mags.mean(0)
    ks: list[int] = []
    for kk in np.argsort(mean)[::-1]:
        if all(abs(int(kk) - j) > 4 for j in ks):
            ks.append(int(kk))
        if len(ks) == 4:
            break
    return float(np.mean([mags[:, kk].std() / mags[:, kk].mean() for kk in ks]))


def test_phase_locking_reduces_phasiness():
    """test_phase_vocoder.py:225-242 on the port: two inharmonic tones
    through a +3 st plateau; locking cuts the partials' amplitude
    modulation at least in half and keeps the energy within 15 %."""
    sr = 22050
    n = 4 * sr
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 311.1 * t)
         + 0.4 * np.sin(2 * np.pi * 554.4 * t)).astype(np.float32)
    knots = mt.MapKnots.from_markers(
        [mt.Marker(n // 4, 57.0, 0.0, 3.0), mt.Marker(3 * n // 4, 57.0, 0.0, 3.0)],
        sr, n)
    classic = mt.render_track_pv(x, knots, device="cpu")
    locked = mt.render_track_pv(x, knots, device="cpu", phase_locking=True)
    r_c, r_l = np.sqrt(np.mean(classic ** 2)), np.sqrt(np.mean(locked ** 2))
    assert abs(r_l - r_c) / r_c < 0.15
    m_c, m_l = _mod_index(classic, sr), _mod_index(locked, sr)
    assert m_l < 0.5 * m_c, (m_c, m_l)


# ----------------------------------------------------------------------
# B9 and the phase vocoder at other frame sizes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size", [1024, 1536])
def test_extract_frames_twin_matches_pallas_exactly(size):
    rng = np.random.default_rng(size)
    n = 5000
    wav = rng.standard_normal(n).astype(np.float32)
    starts = np.concatenate([rng.integers(0, n, 20), [0, n - 1, n - size,
                                                      n - 7, 127, 128]])
    starts = starts.astype(np.int32)
    want = np.asarray(pallas_frames.extract_frames_pallas(
        jnp.asarray(wav), jnp.asarray(starts), size, interpret=True))
    got = kframes.extract_frames(torch.from_numpy(wav),
                                 torch.from_numpy(starts), size).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[starts == n - 1, 1:].any()  # zeros past the end


def test_extract_frames_supported_matches_jax():
    for size in (128, 896, 1000, 1024, 1152, 1536, 2048, 4096, 4100):
        for f in (None, 1, 200_000, 200_001):
            assert kframes.supported(size, f) == pallas_frames.supported(size, f)


@pytest.mark.parametrize("size,hop,count,lock", [
    (4096, 1024, 9, False), (4096, 1024, 1, True), (1536, 384, 9, False),
    (1000, 250, 9, False), (1024, 256, 1, False),
])
def test_render_at_other_sizes_matches_jax(size, hop, count, lock):
    """Frame sizes B2/B3 do not take: B9's route (4096, 1536, 1024) and the
    plain gather (1000) with torch.fft, against JAX's natural path."""
    w = _song()
    jk, pk = _knots(_markers(count))
    want = jpv.render_track_pv(w, jk, size=size, hop=hop, phase_locking=lock)
    got = mt.render_track_pv(w, pk, device="cpu", size=size, hop=hop,
                             phase_locking=lock)
    _assert_pv_close(got, want)


def test_other_size_formant_render_matches_jax():
    w = _song()
    jk, pk = _knots(_markers(9))
    want = jpv.render_track_pv(w, jk, size=4096, hop=1024,
                               preserve_formants=True)
    got = mt.render_track_pv(w, pk, device="cpu", size=4096, hop=1024,
                             preserve_formants=True)
    _assert_pv_close(got, want)


# ----------------------------------------------------------------------
# Multichannel PV
# ----------------------------------------------------------------------


def _stereo():
    a = _song(21)
    b = (0.7 * _song(22)[::-1]).astype(np.float32)
    return np.stack([a, b])


@pytest.mark.parametrize("lock,formant", [(False, False), (True, True)])
def test_render_channels_pv_matches_jax(lock, formant):
    ch = _stereo()
    jk, pk = _knots(_markers(9))
    want = jpv.render_channels_pv(ch, jk, phase_locking=lock,
                                  preserve_formants=formant)
    got = tpv.render_channels_pv(ch, pk, phase_locking=lock,
                                 preserve_formants=formant, device="cpu")
    assert got.shape == want.shape == (2, int(pk.duration() * SR))
    for c in range(2):
        _assert_pv_close(got[c], want[c])
        np.testing.assert_array_equal(  # one shared plan, channel by channel
            got[c], mt.render_track_pv(ch[c], pk, device="cpu",
                                       phase_locking=lock,
                                       preserve_formants=formant))


def test_stereo_pv_session_matches_jax():
    st = np.ascontiguousarray(_stereo().T)
    markers = _markers(9)
    got = mt.render_session(st, [mt.Marker(*m) for m in markers], SR,
                            engine="pv", phase_locking=True, device="cpu")
    want = j_render_session(st, [JMarker(*m) for m in markers], SR,
                            engine="pv", phase_locking=True, mesh=None)
    assert got.shape == want.shape and got.shape[1] == 2
    for c in range(2):
        _assert_pv_close(got[:, c], want[:, c])


def test_render_channels_pv_short_track_is_silent():
    ch = np.zeros((2, 1000), np.float32)  # shorter than one frame
    _jk, pk = _knots([], n=1000)
    got = tpv.render_channels_pv(ch, pk, device="cpu")
    assert got.shape == (2, int(pk.duration() * SR)) and not got.any()


def test_render_channels_pv_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jk, pk = _knots(_markers(1))
    with pytest.raises(RuntimeError, match="cuda"):
        tpv.render_channels_pv(_stereo(), pk)  # device defaults to cuda
