"""The pitch slice of melonix_tpu_torch against melonix_tpu on the CPU.

B8 (per-frame autocorrelation): the port's plain twin against the Pallas
kernel in interpret mode and a float64 Wiener-Khinchin oracle; a float32
model of the CUDA kernel's design (``csrc/pitch_ac.cu``: two frames a
complex transform both ways, each balanced by a power of two) held per
frame against the oracle on a level-stepped fixture, where the unbalanced
packing fails; the host side of its C entry.  The NSDF and
HPS cores and ``pitch_curve`` (nsdf, hps, hybrid) against the JAX engine on
the JAX suite's signals, from seeded NumPy inputs; the even-count median;
the routing of frame sizes; the device rules.  The CUDA kernel is held to
the twin on the card by chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.config import Config as JConfig
from melonix_tpu.engine import pitch as jpitch
from melonix_tpu.kernels import pallas_pitch

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import pitch as tpitch
from melonix_tpu_torch.kernels import pitch as kpitch
from torch_fake_card import fake_card

torch.set_num_threads(2)

SR = 44100


def from_jax(cls, obj):
    """The port's dataclass ``cls`` from the JAX package's instance of its
    counterpart, field by field (how a test carries a JAX ``PitchCurve`` or
    ``Marker`` across)."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tone(freq, sr=SR, seconds=1.0, harmonics=(1.0,)):
    """test_pitch.py:10-13."""
    t = np.arange(int(sr * seconds)) / sr
    x = sum(a * np.sin(2 * np.pi * freq * (i + 1) * t)
            for i, a in enumerate(harmonics))
    return (x / max(1.0, np.abs(x).max())).astype(np.float32)


# ----------------------------------------------------------------------
# B8: autocorrelation
# ----------------------------------------------------------------------


def _ac_input(hop=512, frames=70, extra=0, seed=5):
    """test_pallas.py:694-706's tone + noise, optionally ``extra`` samples
    short of the last frame (zeros past the end)."""
    rng = np.random.default_rng(seed)
    n = (frames - 1) * hop + 2048 - extra
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
    return x, frames


def _ac_f64(x, hop, frames):
    xp = np.pad(x.astype(np.float64), (0, 2048))
    fr = np.lib.stride_tricks.sliding_window_view(xp, 2048)[::hop][:frames]
    w = fr - fr.mean(axis=1, keepdims=True)
    spec = np.fft.rfft(w, n=4096)
    return np.fft.irfft(np.abs(spec) ** 2, n=4096)[:, :2048], w


def test_pitch_ac_plain_matches_pallas_kernel():
    """The inputs and bars of test_pallas.py:694-716: ac within the bf16x3
    bar 3e-4 * max|ac|, w within 1e-5."""
    x, frames = _ac_input()
    ac_j, w_j = pallas_pitch.pitch_ac_pallas(jnp.asarray(x), 2048, 512, frames,
                                             interpret=True)
    ac, w = kpitch.pitch_ac_plain(_t(x), 2048, 512, frames)
    assert ac.shape == w.shape == (frames, 2048)
    assert ac.dtype == w.dtype == torch.float32
    ac_j = np.asarray(ac_j)
    np.testing.assert_allclose(ac.numpy(), ac_j,
                               atol=3e-4 * np.abs(ac_j).max())
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5)


@pytest.mark.parametrize("hop,extra", [(512, 0), (256, 0), (1024, 0),
                                       (512, 777)])
def test_pitch_ac_plain_matches_float64(hop, extra):
    """Against a float64 NumPy Wiener-Khinchin oracle at atol 1e-5 *
    max|ac| (two float32 FFTs), including a last frame past the end."""
    x, frames = _ac_input(hop=hop, extra=extra, seed=hop + extra)
    ac, w = kpitch.pitch_ac_plain(_t(x), 2048, hop, frames)
    ac64, w64 = _ac_f64(x, hop, frames)
    np.testing.assert_allclose(ac.numpy(), ac64, atol=1e-5 * np.abs(ac64).max())
    np.testing.assert_allclose(w.numpy(), w64, atol=1e-6)


def test_pitch_ac_is_the_linear_autocorrelation():
    """ac[f, t] = sum_j w[j] w[j + t] directly (no circular wrap-around)."""
    x, frames = _ac_input(frames=3, seed=9)
    ac, w = kpitch.pitch_ac_plain(_t(x), 2048, 512, frames)
    w64 = w.numpy().astype(np.float64)
    direct = np.stack([np.correlate(r, r, mode="full")[2047:] for r in w64])
    np.testing.assert_allclose(ac.numpy(), direct,
                               atol=1e-5 * np.abs(direct).max())


@pytest.mark.parametrize("frame,hop,n_frames,want", [
    (2048, 512, 100, True), (2048, 128, 1, True), (2048, 2048, 3, True),
    (2048, 384, 10, True), (1024, 256, 10, False), (2048, 500, 10, False),
    (2048, 4096, 10, False), (2048, 512, 0, False), (4096, 512, 10, False),
])
def test_supported_equals_jax(frame, hop, n_frames, want):
    assert kpitch.supported(frame, hop, n_frames) is want
    assert pallas_pitch.supported(frame, hop, n_frames) is want


def test_pitch_ac_wrapper_refuses_other_devices():
    meta = torch.empty(8192, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kpitch.pitch_ac(meta, 2048, 512, 3)
    assert kpitch.pitch_ac.launches == 0


# ----------------------------------------------------------------------
# B8's CUDA design (csrc/pitch_ac.cu), modelled in float32
# ----------------------------------------------------------------------

LEVELS = (1.0, 1e-2, 1e-3, 1e-5, 0.0, 1e-5, 1e-3, 1e-2, 1.0, 1e-5)


def level_steps(sr=8000, seconds=5.0, seed=11):
    """chip_smoke.py's level-stepped fixture at a small size: the song's
    two vibrato partials + noise, scaled per 0.5 s segment through
    ``LEVELS`` (steps of 20 to 100 dB both ways, and a silent segment
    longer than a frame)."""
    t = np.arange(int(sr * seconds)) / sr
    f = 220.0 * 2.0 ** (np.sin(2 * np.pi * 0.25 * t) * 0.5)
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)
    x += 0.2 * np.sin(2 * np.pi * 2.0 * np.cumsum(f) / sr)
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    seg = np.asarray(LEVELS)[(t / 0.5).astype(np.int64) % len(LEVELS)]
    return (x * seg).astype(np.float32)


def _block_sum(parts):
    """The kernel's fixed-order block sum of (..., 256) per-thread parts:
    a warp xor tree, then the 8 warp sums in warp order from 0."""
    lanes = parts.reshape(parts.shape[:-1] + (8, 32))
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    total = np.zeros(parts.shape[:-1], parts.dtype)
    for wi in range(8):
        total = total + lanes[..., wi, 0]
    return total


def _model_frames(x, hop, n_frames):
    xp = np.pad(x, (0, 2048 + hop))
    return np.lib.stride_tricks.sliding_window_view(xp, 2048)[::hop][:n_frames]


def pitch_ac_model(x, hop, n_frames, balance=True):
    """(ac, w) of csrc/pitch_ac.cu's steps 1-6 in float32: the fixed-order
    mean, the power-of-two balance, frames (2p, 2p + 1) packed as one
    complex 4096-point forward transform (an odd count's last beside
    silence), the split into two power spectra packed as one inverse."""
    fr = _model_frames(x, hop, n_frames).astype(np.float32)
    if n_frames % 2:
        fr = np.concatenate([fr, np.zeros((1, 2048), np.float32)])
    thr = fr.reshape(-1, 8, 256)  # [f][j][t]: sample t + 256 j
    part = np.zeros((len(fr), 256), np.float32)
    for j in range(8):  # each thread's sum over j, in order
        part = part + thr[:, j]
    mean = _block_sum(part) * np.float32(1.0 / 2048)
    w = fr - mean[:, None]
    sq = np.zeros((len(fr), 256))
    for j in range(8):
        sq = sq + w.reshape(-1, 8, 256)[:, j].astype(np.float64) ** 2
    sq = _block_sum(sq)
    e = np.where(sq > 0, np.frexp(sq / 2048)[1] >> 1, 0) if balance \
        else np.zeros(len(fr), np.int64)
    ws = np.ldexp(w, -e[:, None]).astype(np.float32)
    z = torch.zeros((len(fr) // 2, 4096), dtype=torch.complex64)
    z[:, :2048] = torch.complex(_t(ws[0::2]), _t(ws[1::2]))
    zf = torch.fft.fft(z)
    zn = torch.roll(torch.flip(zf, [1]), 1, 1)  # Z[(4096 - k) mod 4096]
    ra, ia = zf.real + zn.real, zf.imag - zn.imag
    rb, ib = zf.real - zn.real, zf.imag + zn.imag
    pw = torch.complex(0.25 * (ra * ra + ia * ia), 0.25 * (rb * rb + ib * ib))
    r = torch.fft.ifft(pw) * 4096  # the unscaled +1 transform
    out = torch.stack([r.real, r.imag], 1).reshape(len(fr), 4096)[:, :2048]
    ac = np.ldexp(out.numpy(), (2 * e - 12)[:, None]).astype(np.float32)
    ac[sq == 0] = 0.0
    return ac[:n_frames], w[:n_frames]


def per_frame_excess(ac, ac_ref, w_ref):
    """max_t |ac - ac_ref| / (1e-5 ac_ref[f, 0]) over the frames with
    ac_ref[f, 0] > 0 (<= 1 meets the bar), and whether every frame whose
    w_ref is all zero has ac exactly 0."""
    live = ac_ref[:, 0] > 0
    err = np.abs(ac[live].astype(np.float64) - ac_ref[live]).max(axis=1)
    silent = ~np.any(w_ref != 0, axis=1)
    return (float((err / (1e-5 * ac_ref[live, 0])).max()),
            bool(np.all(ac[silent] == 0)), int(silent.sum()))


@pytest.mark.parametrize("hop", [512, 128, 1024])
def test_balanced_pair_model_meets_the_per_frame_bar(hop):
    """The level-stepped fixture: every frame within 1e-5 ac[0] of the
    float64 oracle, silent frames exactly 0, w within 1e-5 of the twin's."""
    x = level_steps()
    frames = 1 + (len(x) - 2048) // hop
    frames -= 1 - frames % 2  # an odd count: the last frame beside silence
    ac, w = pitch_ac_model(x, hop, frames)
    ac64, w64 = _ac_f64(x, hop, frames)
    excess, zeros, n_silent = per_frame_excess(ac, ac64, w64)
    assert n_silent > 0 and zeros
    assert excess <= 1.0, excess
    ac_p, w_p = kpitch.pitch_ac_plain(_t(x), 2048, hop, frames)
    assert np.abs(w - w_p.numpy()).max() < 1e-5
    assert per_frame_excess(ac_p.numpy(), ac64, w64)[0] <= 1.0


def test_unbalanced_pair_model_fails_the_bar():
    """Without the balance the loud frame's rounding leaks into its quiet
    partner far past the bar: the fixture catches the leak."""
    x = level_steps()
    frames = 1 + (len(x) - 2048) // 512
    ac, _w = pitch_ac_model(x, 512, frames, balance=False)
    ac64, w64 = _ac_f64(x, 512, frames)
    assert per_frame_excess(ac, ac64, w64)[0] > 100.0


@pytest.mark.parametrize("frames", [1, 2, 7])
def test_pair_model_small_counts(frames):
    """F = 1 (one frame beside silence), an even and an odd count: the
    model against the oracle and the twin."""
    x, _ = _ac_input(frames=frames, seed=frames)
    ac, w = pitch_ac_model(x, 512, frames)
    ac64, w64 = _ac_f64(x, 512, frames)
    assert ac.shape == w.shape == (frames, 2048)
    assert per_frame_excess(ac, ac64, w64)[0] <= 1.0
    ac_p, w_p = kpitch.pitch_ac_plain(_t(x), 2048, 512, frames)
    np.testing.assert_allclose(ac, ac_p.numpy(), rtol=0,
                               atol=1e-5 * float(ac_p[:, 0].min()))
    assert np.abs(w - w_p.numpy()).max() < 1e-6


def test_model_mean_is_the_kernels_fixed_order():
    """The block sum of the model is the kernel's xor tree: every lane of a
    warp ends with the same sum, which is the float64 sum to rounding."""
    parts = np.random.default_rng(2).standard_normal((3, 256)).astype(
        np.float32)
    got = _block_sum(parts)
    np.testing.assert_allclose(got, parts.astype(np.float64).sum(1),
                               rtol=1e-6)
    lanes = parts.reshape(3, 8, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ off]
    assert np.all(lanes == lanes[..., :1])


def _pair_walk(n_frames, grid):
    """Rows written by the kernel's persistent walk: CTA c takes pairs
    p = c, c + grid, ...; pair p writes frame 2p and, below n_frames,
    2p + 1."""
    rows = []
    for c in range(grid):
        for p in range(c, (n_frames + 1) // 2, grid):
            rows += [2 * p] + ([2 * p + 1] if 2 * p + 1 < n_frames else [])
    return rows


@pytest.mark.parametrize("frames", [1, 2, 7, 75, 15500])
def test_pair_walk_writes_every_frame_once(frames):
    pairs = (frames + 1) // 2
    for grid in {1, 3, min(pairs, 264)}:
        assert sorted(_pair_walk(frames, grid)) == list(range(frames))
    src = open(kpitch.__file__.replace("kernels/pitch.py",
                                       "csrc/pitch_ac.cu")).read()
    assert "const int n_pairs = (n_frames + 1) / 2;" in src
    assert "p < n_pairs; p += gridDim.x" in src
    assert "P::kSmem, (n_frames + 1) / 2, &grid)" in src
    assert "fft_real.cuh" not in src.split("#include")[-1]


def test_b8_entry_takes_the_4096_pair_table(monkeypatch):
    """The wrapper's CUDA branch on the fake card: one mlx_pitch_ac call
    with (n, F, hop), the 4096-point pair twiddle table, one launch
    counted."""
    from melonix_tpu_torch.kernels import pv as kpv

    rec, tables = fake_card(monkeypatch), []

    def table(size, dev):
        tables.append(size)
        return kpv.pair_twiddles(size, dev)

    monkeypatch.setattr(kpitch, "pair_twiddles", table)
    meta = torch.device("meta")
    before = kpitch.pitch_ac.launches
    for frames in (1, 7, 15500):
        ac, w = kpitch.pitch_ac(torch.zeros(50000).to(meta), 2048, 512,
                                frames)
        assert ac.shape == w.shape == (frames, 2048)
        name, args = rec.calls[-1]
        assert name == "mlx_pitch_ac"
        assert args[1] == 50000 and args[5:7] == (frames, 512)
    assert tables == [4096] * 3
    assert kpitch.pitch_ac.launches == before + 3
    tab = kpv.pair_twiddles(4096, torch.device("cpu")).numpy()
    assert tab.shape == (4096 + 256, 2) and tab.dtype == np.float32
    ang = np.concatenate([(2 * np.pi / 4096) * np.outer(np.arange(16),
                                                        np.arange(256)).ravel(),
                          (2 * np.pi / 256) * np.outer(np.arange(16),
                                                       np.arange(16)).ravel()])
    np.testing.assert_allclose(tab[:, 0], np.cos(ang), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tab[:, 1], np.sin(ang), rtol=0, atol=1e-7)


# ----------------------------------------------------------------------
# NSDF and HPS cores
# ----------------------------------------------------------------------


def _core_frames(frame=2048, sr=SR, seed=3):
    """Mean-subtracted frames of tones, harmonic stacks and quiet noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(frame) / sr
    rows = []
    for f0 in (82.0, 110.0, 196.0, 220.0, 330.0, 440.0, 660.0, 880.0, 1200.0):
        phase = rng.uniform(0, 2 * np.pi)
        rows.append(np.sin(2 * np.pi * f0 * t + phase))
        rows.append(sum(np.sin(2 * np.pi * f0 * h * t + phase) / h
                        for h in (1, 2, 3, 4)))
        rows.append(np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(frame))
    w = np.stack(rows).astype(np.float32)
    return w - w.mean(axis=1, keepdims=True)


def test_pitch_core_matches_jax():
    """On the same w: lag within 1e-3 samples, clarity within 1e-4, energy
    to float32 rounding."""
    w = _core_frames()
    lag_min, lag_max = int(SR / 1760.0), int(SR / 55.0)
    lj, cj, ej = (np.asarray(a) for a in jpitch.pitch_core(
        jnp.asarray(w), 2048, lag_min, lag_max))
    lt, ct, et = (a.numpy() for a in tpitch.pitch_core(
        _t(w), 2048, lag_min, lag_max))
    assert lt.dtype == ct.dtype == np.float32
    np.testing.assert_allclose(lt, lj, atol=1e-3)
    np.testing.assert_allclose(ct, cj, atol=1e-4)
    np.testing.assert_allclose(et, ej, rtol=1e-5)


def test_pitch_core_with_b8_ac_matches_without():
    """pitch_core fed the twin's (ac, w) equals pitch_core deriving ac."""
    x = _tone(220.0, harmonics=(1.0, 0.5, 0.3))
    frames = 1 + (len(x) - 2048) // 512
    ac, w = kpitch.pitch_ac_plain(_t(x), 2048, 512, frames)
    a = tpitch.pitch_core(w, 2048, 25, 801, ac=ac)
    b = tpitch.pitch_core(w, 2048, 25, 801)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=1e-4)


@pytest.mark.parametrize("frame,sr", [(2048, SR), (1024, 8000)])
def test_hps_core_matches_jax(frame, sr):
    """lag within 1e-3 samples, salience within 1e-3."""
    w = _core_frames(frame, sr)
    lag_min, lag_max = max(2, int(sr / 1760.0)), min(frame - 2, int(sr / 55.0))
    lj, sj = (np.asarray(a) for a in jpitch.hps_core(
        jnp.asarray(w), frame, lag_min, lag_max))
    lt, st = (a.numpy() for a in tpitch.hps_core(_t(w), frame, lag_min,
                                                 lag_max))
    np.testing.assert_allclose(lt, lj, atol=1e-3)
    np.testing.assert_allclose(st, sj, atol=1e-3)


def test_hps_core_suite_signals_on_the_port():
    """test_pitch.py:80-104 on the port: a tone and a harmonic stack resolve
    to the fundamental with positive salience; noise has weak evidence."""
    sr, frame = 8000, 1024
    t = np.arange(frame) / sr
    stack = sum(np.sin(2 * np.pi * 220.0 * h * t) / h for h in (1, 2, 3, 4))
    noise = np.random.default_rng(0).standard_normal(frame)
    w = np.stack([np.sin(2 * np.pi * 220.0 * t), stack, noise]).astype(np.float32)
    w -= w.mean(axis=1, keepdims=True)
    lag, sal = (a.numpy() for a in tpitch.hps_core(
        _t(w), frame, int(sr / 1000.0), int(sr / 60.0)))
    for i in (0, 1):
        assert abs(sr / lag[i] - 220.0) < 3.0 and sal[i] > 1.0
    assert sal[2] < sal[0] / 2 and sal[2] < 2.0


@pytest.mark.parametrize("n", [158, 7, 2, 1])
def test_median_averages_the_two_middle_values(n):
    """jnp.nanmedian's convention: an even count (158 in-range HPS bins at
    the defaults) averages the two middle values, where torch.median would
    return the lower one."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)).astype(np.float32)
    got = tpitch._median_rows(_t(x)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if n % 2 == 0:
        lower = torch.median(_t(x), dim=1).values.numpy()
        assert np.abs(lower - want).max() > 1e-3  # the trap is real


def test_median_pin_defaults_bin_count():
    """At 44.1 kHz, fmin 55, fmax 1760 the in-range HPS bins are
    k = 6..163: 158 values, even."""
    lag_min, lag_max = int(SR / 1760.0), min(2046, int(SR / 55.0))
    k_min = max(1, int(np.ceil(4096 / lag_max)))
    k_max = min(513 - 2, int(np.floor(4096 / lag_min)))
    assert (k_min, k_max) == (6, 163)
    x = np.asarray([[4.0, 1.0, 3.0, 2.0]], np.float32)
    assert float(tpitch._median_rows(_t(x))[0]) == 2.5


def test_first_true_is_jnp_argmax_of_a_mask():
    m = np.asarray([[0, 0, 1, 1], [0, 0, 0, 0], [1, 0, 1, 0]], bool)
    got = tpitch._first_true(_t(m)).numpy()
    assert np.array_equal(got, np.asarray(jnp.argmax(jnp.asarray(m), axis=1)))


# ----------------------------------------------------------------------
# pitch_curve
# ----------------------------------------------------------------------


def _alternating_pulses():
    """test_pitch.py:130-137."""
    sr = 8000
    t = np.arange(2 * sr) / sr
    x = np.sin(2 * np.pi * 250.0 * t) * (
        1.0 + 0.12 * np.sign(np.sin(np.pi * 250.0 * t)))
    return x.astype(np.float32), sr, JConfig(), mt.Config()


def _glissando():
    t = np.arange(SR) / SR
    x = np.sin(2 * np.pi * np.cumsum(220.0 * 2 ** t) / SR)
    return x.astype(np.float32), SR, JConfig(), mt.Config()


SIGNALS = {
    "tone110": lambda: (_tone(110.0), SR, JConfig(), mt.Config()),
    "tone220": lambda: (_tone(220.0), SR, JConfig(), mt.Config()),
    "tone440": lambda: (_tone(440.0), SR, JConfig(), mt.Config()),
    "tone880": lambda: (_tone(880.0), SR, JConfig(), mt.Config()),
    "stack220": lambda: (_tone(220.0, harmonics=(1.0, 0.8, 0.6, 0.4)), SR,
                         JConfig(), mt.Config()),
    "silence": lambda: (np.zeros(SR, np.float32), SR, JConfig(), mt.Config()),
    "noise": lambda: ((0.3 * np.random.default_rng(0).standard_normal(SR))
                      .astype(np.float32), SR, JConfig(), mt.Config()),
    "glissando": _glissando,
    "tone55_fmin50": lambda: (_tone(55.0, seconds=1.5), SR,
                              JConfig(pitch_fmin=50.0), mt.Config(pitch_fmin=50.0)),
    "tone220_8k": lambda: (
        (0.5 * np.sin(2 * np.pi * 220.0 * np.arange(16000) / 8000))
        .astype(np.float32), 8000, JConfig(), mt.Config()),
    "pulses_8k": _alternating_pulses,
    "frame1024_8k": lambda: (
        (0.5 * np.sin(2 * np.pi * 196.0 * np.arange(16000) / 8000))
        .astype(np.float32), 8000, JConfig(pitch_frame=1024, pitch_hop=256),
        mt.Config(pitch_frame=1024, pitch_hop=256)),
}


def assert_curves_close(got, want, share=0.99):
    """voiced equal on >= 99% of frames; |delta note| < 0.01 semitone on
    >= 99% of the frames voiced in both."""
    assert got.f0.shape == want.f0.shape and got.hop == want.hop
    assert got.sample_rate == want.sample_rate
    assert got.f0.dtype == got.note.dtype == got.clarity.dtype == np.float32
    assert np.mean(got.voiced == want.voiced) >= share
    both = got.voiced & want.voiced
    if both.any():
        close = np.abs(got.note[both] - want.note[both]) < 0.01
        assert close.mean() >= share, close.mean()


@pytest.mark.parametrize("method", ["nsdf", "hps", "hybrid"])
@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_pitch_curve_matches_jax(name, method):
    x, sr, jcfg, tcfg = SIGNALS[name]()
    want = jpitch.pitch_curve(x, sr, config=jcfg, method=method)
    got = mt.pitch_curve(x, sr, config=tcfg, method=method, device="cpu")
    assert isinstance(got, mt.PitchCurve)
    assert_curves_close(got, want)


@pytest.mark.parametrize("freq", [110.0, 220.0, 440.0, 880.0])
def test_pure_tone_accuracy_on_the_port(freq):
    """test_pitch.py:16-25 on the port."""
    c = mt.pitch_curve(_tone(freq), SR, device="cpu")
    voiced = c.voiced[4:-4]
    assert voiced.mean() > 0.9
    err = 1200 * np.abs(np.log2(c.f0[4:-4][voiced] / freq))
    assert np.median(err) < 10


def test_silence_and_noise_on_the_port():
    c = mt.pitch_curve(np.zeros(SR, np.float32), SR, device="cpu")
    assert not c.voiced.any() and (c.f0 == 0).all()
    x = (0.3 * np.random.default_rng(1).standard_normal(SR)).astype(np.float32)
    assert mt.pitch_curve(x, SR, device="cpu").voiced.mean() < 0.3


def test_short_track_is_one_frame_like_jax():
    x = _tone(220.0, seconds=0.02)  # 882 samples < one frame
    got = mt.pitch_curve(x, SR, device="cpu")
    want = jpitch.pitch_curve(x, SR)
    assert len(got.f0) == len(want.f0) == 1
    assert_curves_close(got, want, share=1.0)


def test_pitch_curve_takes_a_tensor_on_its_device():
    x = _tone(220.0)
    got = mt.pitch_curve(torch.from_numpy(x), SR)  # the tensor's device
    assert_curves_close(got, jpitch.pitch_curve(x, SR))
    with pytest.raises(ValueError):
        mt.pitch_curve(x, SR, method="yin", device="cpu")


def test_note_at_time_and_carry_from_jax():
    want = jpitch.pitch_curve(_tone(440.0), SR)
    carried = from_jax(tpitch.PitchCurve, want)
    for t in (-1.0, 0.0, 0.3, 0.99, 5.0):
        assert carried.note_at_time(t) == want.note_at_time(t)


# ----------------------------------------------------------------------
# Routing and the device rules
# ----------------------------------------------------------------------


def _count_b8(monkeypatch):
    calls = []
    real = kpitch.pitch_ac

    def counting(*a, **k):
        calls.append(a[1:])
        return real(*a, **k)

    monkeypatch.setattr(kpitch, "pitch_ac", counting)
    return calls


def test_frame_2048_routes_through_b8_once(monkeypatch):
    calls = _count_b8(monkeypatch)
    mt.pitch_curve(_tone(220.0), SR, method="hybrid", device="cpu")
    assert calls == [(2048, 512, 1 + (SR - 2048) // 512)]


def test_frame_1024_takes_the_plain_formulation(monkeypatch):
    """test_autotune.py:80's frame 1024: B8 does not take it (as
    pallas_pitch.supported does not), so its wrapper's one call runs the
    plain twin, and the curve still equals JAX's."""
    calls = _count_b8(monkeypatch)
    x, sr, jcfg, tcfg = SIGNALS["frame1024_8k"]()
    got = mt.pitch_curve(x, sr, config=tcfg, device="cpu")
    assert len(calls) == 1 and calls[0][0] == 1024
    assert not kpitch.supported(*calls[0])
    assert_curves_close(got, jpitch.pitch_curve(x, sr, config=jcfg))


def test_hybrid_combiner_override_semantics(monkeypatch):
    """test_pitch.py:147-182 on the port: HPS overrides NSDF only on an
    exact-octave disagreement with salient evidence."""
    sr, n_frames = 8000, 4

    def fake_pitch(*a, **k):
        return (torch.full((n_frames,), 100.0), torch.full((n_frames,), 0.9),
                torch.full((n_frames,), 0.1))

    monkeypatch.setattr(tpitch, "_pitch_device", fake_pitch)
    x = np.zeros(5 * sr, np.float32)
    for hlag, sal, want_hz in ((50.0, 5.0, sr / 50.0), (50.0, 1.0, sr / 100.0),
                               (70.0, 5.0, sr / 100.0),
                               (200.0, 5.0, sr / 200.0)):
        monkeypatch.setattr(
            tpitch, "_hps_device",
            lambda *a, _h=hlag, _s=sal, **k: (torch.full((n_frames,), _h),
                                              torch.full((n_frames,), _s)))
        c = tpitch.pitch_curve(x, sr, method="hybrid", energy_threshold=0.0,
                               device="cpu")
        assert abs(float(c.f0[0]) - want_hz) < 1e-6


def test_cuda_request_without_cuda_raises_and_runs_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(kpitch, "pitch_ac_plain",
                        lambda *a, **k: ran.append("pitch_ac_plain"))
    with pytest.raises(RuntimeError, match="cuda"):
        mt.pitch_curve(_tone(220.0), SR)  # NumPy input defaults to CUDA
    with pytest.raises(RuntimeError, match="cuda"):
        mt.pitch_curve(_tone(220.0), SR, device="cuda")
    assert ran == []
