"""Each CUDA kernel's plain PyTorch twin against melonix_tpu on the CPU.

B1 stft_mag, B2 analysis, B3 synth_ola_phase and B4 resample_pv: the same
numpy inputs (from a seeded generator) go through the JAX function (XLA, or
the Pallas kernel in interpret mode, as the JAX suite runs it on the CPU)
and through the port's twin.  The CUDA kernels themselves are held to these
twins on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.engine import phase_vocoder as jpv
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.spectral import istft_device
from melonix_tpu.engine.spectral import stft_device as j_stft_device
from melonix_tpu.engine.spectral import stft_mags_device as j_stft_mags
from melonix_tpu.kernels import pallas_pv
from melonix_tpu.kernels import pallas_resample
from melonix_tpu.markers import Marker as JMarker

from melonix_tpu_torch.engine import phase_vocoder as tpv
from melonix_tpu_torch.engine.spectral import hann_window, num_frames, stft_device
from melonix_tpu_torch.kernels import pv as kpv
from melonix_tpu_torch.kernels import resample as kres

torch.set_num_threads(2)

SIZE = 2048


def _snr_db(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return 10 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------------
# B1: |STFT|
# ----------------------------------------------------------------------


def _stft_input(hop, seed=11, frames=70):
    rng = np.random.default_rng(seed)
    n = (frames - 1) * hop + SIZE + 37
    x = (rng.standard_normal(n) * 0.4).astype(np.float32)
    return x, hann_window(SIZE), num_frames(n, SIZE, hop)


@pytest.mark.parametrize("hop", [512, 256, 1024])
def test_stft_mag_plain_matches_jax_xla(hop):
    """Against melonix_tpu's stft_mags_device on the CPU (XLA rfft + |.|):
    two float32 FFTs, SNR < -100 dB."""
    x, win, nf = _stft_input(hop)
    want = np.asarray(j_stft_mags(jnp.asarray(x), jnp.asarray(win), SIZE, hop,
                                  nf, scale=0.5))
    got = kpv.stft_mag_plain(_t(x), _t(win), SIZE, hop, nf, scale=0.5).numpy()
    assert got.shape == want.shape == (nf, SIZE // 2)
    assert _snr_db(got, want) < -100.0


def test_stft_device_matches_jax():
    """The plain complex STFT (the frames B1 transforms) against JAX's."""
    x, win, nf = _stft_input(512)
    want = np.asarray(j_stft_device(jnp.asarray(x), jnp.asarray(win), SIZE,
                                    512, nf))
    got = stft_device(_t(x), _t(win), SIZE, 512, nf).numpy()
    assert got.shape == want.shape == (nf, SIZE // 2 + 1)
    assert _snr_db(np.stack([got.real, got.imag]),
                   np.stack([want.real, want.imag])) < -100.0


def test_stft_mag_plain_matches_fourstep_and_float64():
    """Against the TPU kernel B1 (stft_mag_fourstep, interpret mode) and a
    float64 oracle: SNR < -80 dB, the bar of test_pallas.py:720-745."""
    hop = 512
    x, win, nf = _stft_input(hop)
    got = kpv.stft_mag_plain(_t(x), _t(win), SIZE, hop, nf, scale=0.5).numpy()
    tpu = np.asarray(pallas_pv.stft_mag_fourstep(
        jnp.asarray(x), jnp.asarray(win), SIZE, hop, nf, scale=0.5,
        interpret=True))
    frames = np.lib.stride_tricks.sliding_window_view(
        np.pad(x.astype(np.float64), (0, SIZE)), SIZE)[::hop][:nf]
    f64 = 0.5 * np.abs(np.fft.rfft(frames * win.astype(np.float64)))[:, :SIZE // 2]
    assert _snr_db(got, tpu) < -80.0
    assert _snr_db(got, f64) < -80.0


# ----------------------------------------------------------------------
# B2: analysis at arbitrary starts
# ----------------------------------------------------------------------


def _analysis_input(frames=128, seed=5):
    rng = np.random.default_rng(seed)
    n = 40_000
    x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    starts = np.sort(rng.integers(0, n, frames)).astype(np.int32)
    starts[-3:] = [n - 1000, n - 1, n + 50]  # zero fill, clip past the end
    return x, starts, hann_window(SIZE)


def test_analysis_plain_matches_jax_rfft():
    """Against the JAX natural path's gather + rfft
    (phase_vocoder.py:363-365): SNR < -100 dB."""
    x, starts, win = _analysis_input()
    n = len(x)
    s = jnp.clip(jnp.asarray(starts), 0, n - 1)
    idx = s[:, None] + jnp.arange(SIZE, dtype=jnp.int32)[None, :]
    frames = jnp.where(idx < n, jnp.asarray(x)[jnp.clip(idx, 0, n - 1)], 0.0)
    want = np.asarray(jnp.fft.rfft(frames * jnp.asarray(win)[None, :]))
    re, im = kpv.analysis_plain(_t(x), _t(starts), _t(win), SIZE)
    assert re.shape == im.shape == (len(starts), SIZE // 2 + 1)
    assert re.dtype == im.dtype == torch.float32
    got = np.stack([re.numpy(), im.numpy()])
    assert _snr_db(got, np.stack([want.real, want.imag])) < -100.0


def test_analysis_plain_matches_tpu_analysis_kernel():
    """Against the TPU kernel B2 (pallas_pv.analysis, interpret mode),
    unscrambled to natural order, first 1025 bins: SNR < -80 dB."""
    x, starts, win = _analysis_input(frames=pallas_pv.G)
    re_s, im_s = pallas_pv.analysis(jnp.asarray(x), jnp.asarray(starts),
                                    jnp.asarray(win), SIZE, interpret=True)
    bins = pallas_pv.scrambled_bins(SIZE)
    nat_re = np.empty((len(starts), SIZE), np.float32)
    nat_im = np.empty_like(nat_re)
    nat_re[:, bins], nat_im[:, bins] = np.asarray(re_s), np.asarray(im_s)
    re, im = kpv.analysis_plain(_t(x), _t(starts), _t(win), SIZE)
    want = np.stack([nat_re[:, : SIZE // 2 + 1], nat_im[:, : SIZE // 2 + 1]])
    assert _snr_db(np.stack([re.numpy(), im.numpy()]), want) < -80.0


# ----------------------------------------------------------------------
# B3: phase propagation + synthesis + OLA
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["chunk0", "later_chunk"])
def test_synth_ola_phase_plain_matches_jax_pipeline(case):
    """Against the natural-order formulas of _stretch_chunk_core
    (phase_vocoder.py:374-416) written in JAX on the same spectrum, as
    test_pallas.py:748-827 holds the TPU kernel.  mag and phi enter the JAX
    side as the twin computes them (torch and XLA atan2 differ by <= 1 ulp,
    checked here), so the carries compare exactly.  Bins whose dphi grazes
    +-pi flip under any rounding difference and are excluded from the
    resid check."""
    hop, F = 512, 192
    m0, f_real = (0, F) if case == "chunk0" else (3 * F, F - 17)
    nb = SIZE // 2 + 1
    rng = np.random.default_rng(0)
    re = rng.normal(size=(F, nb)).astype(np.float32)
    im = rng.normal(size=(F, nb)).astype(np.float32)
    da = (hop * rng.uniform(0.5, 2.0, F)).astype(np.float32)
    win = hann_window(SIZE)
    phi0 = rng.uniform(-1, 1, nb).astype(np.float32)
    resid_in = rng.uniform(-1, 1, nb).astype(np.float32)
    phi_prev = rng.uniform(-np.pi, np.pi, nb).astype(np.float32)

    y, r_last, p_last, p0_eff = kpv.synth_ola_phase_plain(
        _t(re), _t(im), _t(da), _t(win), m0, f_real, _t(phi0), _t(resid_in),
        _t(phi_prev), SIZE, hop)
    y, r_last, p_last, p0_eff = (v.numpy() for v in (y, r_last, p_last, p0_eff))

    mag_np = torch.sqrt(_t(re) ** 2 + _t(im) ** 2).numpy()
    phi_np = torch.atan2(_t(im), _t(re)).numpy()
    phi_jax = np.asarray(jnp.angle(jnp.asarray(re) + 1j * jnp.asarray(im)))
    assert np.abs(phi_np - phi_jax).max() <= 2 * np.spacing(np.float32(np.pi))

    phi = jnp.asarray(phi_np)
    omega = (2.0 * jnp.pi / SIZE) * jnp.arange(nb, dtype=jnp.float32)
    k_idx = jnp.arange(nb, dtype=jnp.int32)
    d = jnp.maximum(jnp.asarray(da), 1e-3)[:, None]
    prev = jnp.concatenate([jnp.asarray(phi_prev)[None], phi[:-1]], axis=0)
    dphi = jpv._princarg(phi - prev - omega[None, :] * d)
    incr = hop * dphi / d
    incr = incr.at[0].set(jnp.where(m0 == 0, jnp.zeros_like(incr[0]), incr[0]))
    resid = jnp.asarray(resid_in)[None, :] + jnp.cumsum(incr, axis=0)
    hm = jnp.mod((m0 + jnp.arange(F, dtype=jnp.int32)) * hop, SIZE)
    ramp = (2.0 * jnp.pi / SIZE) * jnp.mod(
        hm[:, None] * k_idx[None, :], SIZE).astype(jnp.float32)
    p0_t = jnp.where(m0 == 0, phi[0], jnp.asarray(phi0))
    psis = p0_t[None, :] + ramp + resid
    live = (jnp.arange(F) < f_real)[:, None]
    mag_live = jnp.where(live, jnp.asarray(mag_np), 0.0)
    out_len = (F - 1) * hop + SIZE
    y_t = np.asarray(istft_device(mag_live * jnp.exp(1j * psis),
                                  jnp.asarray(win), SIZE, hop, out_len,
                                  normalize=False, packed=False))
    last = min(max(f_real - 1, 0), F - 1)

    assert y.shape == (out_len,)
    assert np.array_equal(p0_eff, np.asarray(p0_t))
    assert np.array_equal(p_last, phi_np[last])
    near = np.abs(np.abs(np.asarray(dphi)) - np.pi) < 1e-3
    safe = ~near.any(axis=0)
    assert safe.mean() > 0.8, safe.mean()
    assert np.abs((r_last - np.asarray(resid[last]))[safe]).max() < 1e-2
    rms = float(np.sqrt(np.mean((y - y_t) ** 2)))
    assert rms < 2e-2 * float(np.abs(y_t).max()), rms


# ----------------------------------------------------------------------
# B4: variable-rate resample
# ----------------------------------------------------------------------


def _resample_case(seed=1234):
    rng = np.random.default_rng(seed)
    sr, n = 8000, 3 * 8000
    samples = np.sort(rng.choice(np.arange(500, n - 500), 9, replace=False))
    markers = [JMarker(int(s), 57.0, float(rng.uniform(-0.02, 0.02)),
                       float(rng.uniform(-4, 4))) for s in samples]
    jplan = jpv.build_pv_plan(JMapKnots.from_markers(markers, sr, n), n)
    plan = tpv.pv_plan_from_numpy(
        {k: getattr(jplan, k) for k in jplan.__dataclass_fields__})
    y = rng.standard_normal(plan.stretch_len).astype(np.float32)
    anc_j, src, r, s, n_real = plan.anc_np
    anc = [_t(a[:n_real]) for a in (anc_j, src, r, s)]
    got = kres.resample_pv_plain(_t(y), _t(plan.base), *anc, plan.sr,
                                 plan.n_out_pad).numpy()
    return jplan, plan, y, got, anc


def _assert_close(got, want):
    assert np.abs(got - want).max() < 5e-3
    assert _snr_db(got, want) < -60.0


def test_resample_pv_plain_matches_jax_xla():
    """Against _positions_rel_device + _lerp_resample_rel_xla (the JAX
    package's CPU path): atol 5e-3 and SNR < -60 dB (test_pallas.py:430-470).
    """
    jplan, plan, y, got, anc = _resample_case()
    src_rel = jpv._positions_rel_device(*jplan.anc_args, jplan.n_out_pad,
                                        jplan.sr)
    want = np.asarray(jpv._lerp_resample_rel_xla(
        jnp.asarray(y), src_rel, jnp.asarray(jplan.base), jplan.stretch_len,
        pallas_resample.BLK))
    assert got.shape == want.shape == (plan.n_out_pad,)
    _assert_close(got[: plan.n_out], want[: plan.n_out])
    pos = kres.positions_rel_plain(*anc, plan.sr, plan.n_out_pad).numpy()
    assert np.abs(pos - np.asarray(src_rel)).max() < 1e-2  # samples


def test_resample_pv_plain_matches_tpu_kernel():
    """Against the TPU kernel B4 (resample_pv_pallas via _resample_pv_fused,
    interpret mode), same bars."""
    jplan, plan, y, got, _anc = _resample_case()
    rows = pallas_resample.rows_for(max(jplan.rho_max, float(jplan.rho_m.max()),
                                        1.0))
    want = np.asarray(jpv._resample_pv_fused(jplan, jnp.asarray(y), rows,
                                             interpret=True))
    _assert_close(got[: plan.n_out], want[: plan.n_out])


def test_expm1_precise_matches_jax():
    x = np.linspace(-0.9, 0.9, 4097, dtype=np.float32)
    want = np.asarray(pallas_resample.expm1_precise(jnp.asarray(x)))
    got = kres.expm1_precise(_t(x)).numpy()
    horner = np.abs(x) <= 0.7  # bit-equal; exp(x) - 1 past it differs by ulps
    assert np.array_equal(got[horner], want[horner])
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    np.testing.assert_allclose(got, np.expm1(x.astype(np.float64)), rtol=5e-7)


def test_anchor_blocks_cover_every_block():
    _jplan, plan, _y, _got, _anc = _resample_case()
    anc_j = plan.anc_np[0][: plan.anc_np[4]]
    nb = plan.n_out_pad // kres.BLK
    a0, cnt, kmax = kres.pv_anchor_blocks(anc_j, nb)
    assert np.array_equal(anc_j[a0], np.arange(nb) * kres.BLK)
    assert cnt.min() >= 1 and cnt.sum() == len(anc_j) and kmax == cnt.max()


# ----------------------------------------------------------------------
# Wrappers on CPU tensors run the twins, launch nothing
# ----------------------------------------------------------------------


def test_wrappers_on_cpu_tensors_run_the_twins():
    x, starts, win = _analysis_input(frames=64)
    wav, st, w = _t(x), _t(starts), _t(win)
    before = (kpv.stft_mag.launches, kpv.analysis.launches,
              kpv.synth_ola_phase.launches, kres.resample_pv.launches)
    assert torch.equal(kpv.stft_mag(wav, w, SIZE, 512, 9),
                       kpv.stft_mag_plain(wav, w, SIZE, 512, 9))
    re, im = kpv.analysis(wav, st, w, SIZE)
    re_p, im_p = kpv.analysis_plain(wav, st, w, SIZE)
    assert torch.equal(re, re_p) and torch.equal(im, im_p)
    z = torch.zeros(SIZE // 2 + 1)
    da = torch.full((64,), 512.0)
    for a, b in zip(kpv.synth_ola_phase(re, im, da, w, 0, 60, z, z, z, SIZE, 512),
                    kpv.synth_ola_phase_plain(re, im, da, w, 0, 60, z, z, z,
                                              SIZE, 512)):
        assert torch.equal(a, b)
    after = (kpv.stft_mag.launches, kpv.analysis.launches,
             kpv.synth_ola_phase.launches, kres.resample_pv.launches)
    assert after == before
