"""The spectrogram slice of melonix_tpu_torch against melonix_tpu on the CPU.

B7 (reference-parity columns) and B12 (|STFT| at sizes other than 2048):
the same numpy inputs (from seeded generators) go through the JAX function
(the Pallas kernel in interpret mode, or XLA, as the JAX suite runs them on
the CPU) and through the port's plain twin; also the float64 column oracle,
the colormaps, the size predicates, the |STFT| routing, the inverse STFT,
the Hann |STFT| pyramid and the waveform min/max pyramid.  The CUDA kernels
are held to these twins on the card by chip_smoke.py.
"""

import contextlib
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from melonix_tpu.config import Config as JConfig
from melonix_tpu.engine import pyramid as jpyr
from melonix_tpu.engine import spectral as jspec
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.kernels import pallas_columns, pallas_stft
from melonix_tpu.markers import Marker as JMarker
from melonix_tpu.runtime.spec_pyramid import SpecPyramid as JSpecPyramid
from melonix_tpu.ui.colormap import colormap_jax
from melonix_tpu.ui.colormap import colormap_lut as j_colormap_lut
from melonix_tpu.ui.colormap import colormap_np as j_colormap_np

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import pyramid as tpyr
from melonix_tpu_torch.engine import spectral as tspec
from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.kernels import columns as kcols
from melonix_tpu_torch.kernels import pv as kpv
from melonix_tpu_torch.kernels import stft as kstft
from melonix_tpu_torch.runtime.spec_pyramid import SpecPyramid
from melonix_tpu_torch.ui.colormap import colormap_lut, colormap_np, colormap_torch

torch.set_num_threads(2)

SR = 44100


def _snr_db(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return 10 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _song(seconds: float, seed: int = 3) -> np.ndarray:
    """A chirp with a second partial and noise, 44.1 kHz."""
    t = np.arange(int(SR * seconds)) / SR
    x = 0.5 * np.sin(2 * np.pi * (220.0 + 300.0 * t) * t)
    x += 0.2 * np.sin(2 * np.pi * 3.0 * (220.0 + 300.0 * t) * t)
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(t))
    return x.astype(np.float32)


# ----------------------------------------------------------------------
# B7: reference-parity columns
# ----------------------------------------------------------------------


def _awkward_columns(seed=1234):
    """test_pallas.py:101-102's ends: unaligned rem, short window (end <
    size), window past the track end, a fully out-of-range column."""
    size = 4096
    n = 3 * size
    wav = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    ends = np.asarray([size + 37, size // 2, n + size // 4, 0], np.int32)
    starts = ends - np.asarray([300, 100, size // 2, 10], np.int32)
    return size, wav, starts, ends


@pytest.mark.parametrize("colormap", [False, True])
def test_columns_plain_matches_tpu_kernel(colormap):
    """Against pallas_columns.spectrogram_columns_fused in interpret mode:
    magnitudes SNR < -100 dB; packed texels >= 99.9% equal, max diff 1
    (the quantisation bar of test_pallas.py:138-141)."""
    size, wav, starts, ends = _awkward_columns()
    k = 16384.0
    # The twin runs first, on its own copies of the inputs and on one
    # intra-op thread, before this test's JAX work: JAX may alias a
    # 64-byte-aligned NumPy buffer, and the interpret-mode call may be the
    # first computation (client start and compile) of the worker process.
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = kcols.spectrogram_columns_plain(
            _t(wav.copy()), _t(starts.copy()), _t(ends.copy()), k,
            size=size, colormap=colormap).numpy()
    finally:
        torch.set_num_threads(saved)
    want = np.asarray(pallas_columns.spectrogram_columns_fused(
        jnp.asarray(wav), jnp.asarray(starts), jnp.asarray(ends), k,
        size=size, colormap=colormap, interpret=True))
    assert got.shape == want.shape == (4, size // 2)
    assert got.dtype == want.dtype
    if colormap:
        diff = np.abs(kcols.unpack_rgb(got).astype(np.int32)
                      - pallas_columns.unpack_rgb(want).astype(np.int32))
        assert np.mean(diff == 0) >= 0.999 and diff.max() <= 1
    else:
        assert not got[3].any() and not want[3].any()  # out of range: zeros
        assert _snr_db(got[:3], want[:3]) < -100.0
        for i in range(3):  # and the float64 oracle, < -60 dB
            col = oracle.spec_column(wav, int(starts[i]), int(ends[i]),
                                     spectr_size=size)
            assert np.max(np.abs(got[i] - col)) < 1e-3 * np.max(col)


def test_extract_frames_matches_jax():
    """The decayed, end-anchored frames themselves: in-range, short (end <
    size), past the track end and fully out of range."""
    size, wav, starts, ends = _awkward_columns(99)
    want = np.asarray(jspec._extract_frames(jnp.asarray(wav), jnp.asarray(starts),
                                            jnp.asarray(ends), size))
    got = tspec._extract_frames(_t(wav), _t(starts), _t(ends), size).numpy()
    assert got.shape == want.shape == (4, size) and got.dtype == np.float32
    assert np.array_equal(got == 0, want == 0)  # the same zeros
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_columns_plain_reference_size_matches_jax_and_oracle():
    """At 32768 points: against JAX's spectrogram_columns_device (XLA FFT)
    SNR < -100 dB, against the float64 oracle < -60 dB with equal argmax."""
    x = _song(3.0)
    n = len(x)
    ends = np.linspace(32768, n - 1, 24).astype(np.int32)
    ends[-3:] = [5000, n + 9000, 40000]  # short window, past the end
    starts = (ends - int(0.02 * SR)).astype(np.int32)
    want = np.asarray(jspec.spectrogram_columns_device(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends), size=32768))
    got = tspec.spectrogram_columns_device(_t(x), _t(starts), _t(ends),
                                           size=32768).numpy()
    assert got.shape == want.shape == (24, 16384)
    assert _snr_db(got, want) < -100.0
    for i in (0, 11, 21, 22):
        col = oracle.spec_column(x, int(starts[i]), int(ends[i]))
        assert _snr_db(got[i], col) < -60.0
        assert int(np.argmax(got[i])) == int(np.argmax(col))


def test_spectrogram_columns_host_wrapper_matches_jax(chirp):
    x, _sr = chirp
    starts = np.array([0, 1000, 5000, 9000, -500, 11000])
    ends = starts + 1800
    cfg, jcfg = mt.Config(spectr_size=2048), JConfig(spectr_size=2048)
    want = jspec.spectrogram_columns(x, starts, ends, jcfg)
    got = mt.spectrogram_columns(x, starts, ends, cfg, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _snr_db(got, want) < -100.0


def test_view_column_ranges_equal_jax():
    n = 10 * SR
    ms = [(2 * SR, 57.0, 0.2, 3.0), (5 * SR, 60.0, -0.1, -2.0)]
    jk = JMapKnots.from_markers([JMarker(*m) for m in ms], SR, n)
    pk = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], SR, n)
    for width, t0, span in ((1280, 0.0, 10.0), (100, 1.9, 0.5), (333, 4.0, 7.0)):
        js, je = jspec.view_column_ranges(jk, width, t0, span)
        ps, pe = tspec.view_column_ranges(pk, width, t0, span)
        assert ps.dtype == js.dtype == np.int32
        assert np.array_equal(ps, js) and np.array_equal(pe, je)


# ----------------------------------------------------------------------
# Colormaps
# ----------------------------------------------------------------------


def test_colormap_np_and_lut_equal_jax_package():
    mags = np.random.default_rng(8).random(4000).astype(np.float32) * 0.03
    for k in (16384.0, 1234.5):
        assert np.array_equal(colormap_np(mags, k), j_colormap_np(mags, k))
    assert np.array_equal(colormap_lut(), j_colormap_lut())


def test_colormap_torch_matches_colormap_jax():
    mags = np.random.default_rng(9).random(4000).astype(np.float32) * 0.05
    mags[:6] = [0.0, 50.0, 100.0, 200.0, 255.0, 1e9]
    for k in (12345.0, 1.0):
        a = np.asarray(colormap_jax(jnp.asarray(mags), k)).astype(np.int32)
        b = colormap_torch(_t(mags), k).numpy().astype(np.int32)
        assert b.shape == (4000, 3)
        diff = np.abs(a - b)
        assert np.mean(diff == 0) >= 0.999 and diff.max() <= 1


# ----------------------------------------------------------------------
# B12: |STFT| at other sizes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,hop", [(1024, 256), (2048, 1024), (1536, 384)])
def test_stft_mag_sizes_plain_matches_tpu_kernel(size, hop):
    """Against pallas_stft.stft_mag_pallas in interpret mode, with the bars
    of test_pallas.py:37-39."""
    rng = np.random.default_rng(size + hop)
    n = 5 * size + 137  # non-aligned length: a zero tail
    x = rng.standard_normal(n).astype(np.float32)
    win = tspec.hann_window(size)
    nf = tspec.num_frames(n, size, hop)
    want = np.asarray(pallas_stft.stft_mag_pallas(
        jnp.asarray(x), jnp.asarray(win), size, hop, nf, interpret=True))
    got = kstft.stft_mag_plain(_t(x), _t(win), size, hop, nf).numpy()
    assert got.shape == want.shape == (nf, size // 2)
    assert np.max(np.abs(got - want)) < 1e-2 * max(1.0, np.max(want))
    denom = np.maximum(np.abs(want), 1e-3 * np.max(want))
    assert np.median(np.abs(got - want) / denom) < 1e-4
    assert _snr_db(got, want) < -80.0


def test_supported_predicates_equal_jax():
    """Each ``supported`` is its TPU kernel's predicate (the shared-memory
    cap is the wrappers' own check, below)."""
    for size in range(128, 65536 + 1, 128):
        assert kcols.supported(size) == pallas_columns.supported(size), size
        for hop in (128, 256, 384, 512, 640, 1024, 2048, 4096, 500, 2000):
            assert kstft.supported(size, hop) == pallas_stft.supported(
                size, hop), (size, hop)
    assert kcols.supported(32768) and kstft.supported(1536, 384)


@pytest.mark.parametrize("size,hop,route", [
    (2048, 512, "b1"), (4096, 1024, "b12"), (1536, 384, "b12"),
    (1000, 250, "plain"), (2048 * 40, 4096 * 4, "b12"),
])
def test_stft_mags_device_routes_like_jax(monkeypatch, size, hop, route):
    """2048 points go to B1, the shapes pallas_stft took to B12 (raising
    beyond the cap on CUDA), the rest to plain rfft; every route computes
    JAX's stft_mags_device."""
    calls = []
    for mod, name in ((kpv, "b1"), (kstft, "b12")):
        real = mod.stft_mag
        monkeypatch.setattr(mod, "stft_mag", lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(size)
    x = rng.standard_normal(3 * size + 77).astype(np.float32)
    win = tspec.hann_window(size)
    nf = tspec.num_frames(len(x), size, hop)
    got = tspec.stft_mags_device(_t(x), _t(win), size, hop, nf, scale=0.5)
    assert calls == ([] if route == "plain" else [route])
    want = np.asarray(jspec.stft_mags_device(jnp.asarray(x), jnp.asarray(win),
                                             size, hop, nf, scale=0.5))
    assert got.shape == want.shape and _snr_db(got.numpy(), want) < -100.0


@pytest.mark.parametrize("size,route", [
    (4096, "b7"), (2048, "b7"), (3000, "plain"), (1152, "plain"),
])
def test_spectrogram_columns_device_routes_like_jax(monkeypatch, size, route):
    """The sizes pallas_columns took go to B7, the rest to its plain twin
    (JAX runs XLA there); every route computes JAX's columns."""
    calls = []
    for name, tag in (("spectrogram_columns_fused", "b7"),
                      ("spectrogram_columns_plain", "plain")):
        real = getattr(kcols, name)
        monkeypatch.setattr(kcols, name, lambda *a, _r=real, _n=tag, **k:
                            calls.append(_n) or _r(*a, **k))
    x = _song(0.5, seed=size)
    ends = np.asarray([size + 37, size // 2, len(x) + 100, len(x) // 2],
                      np.int32)
    starts = (ends - 300).astype(np.int32)
    got = tspec.spectrogram_columns_device(_t(x), _t(starts), _t(ends),
                                           size=size).numpy()
    assert calls[:1] == [route]
    want = np.asarray(jspec.spectrogram_columns_device(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends), size=size))
    assert got.shape == want.shape == (4, size // 2)
    assert _snr_db(got, want) < -100.0


class _Recorder:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _fake_cuda(monkeypatch):
    """Route the wrappers' CUDA branch onto ``meta`` tensors (allocation
    without memory) with a recording library: what would launch, and with
    which sizes, without a card."""
    rec = _Recorder()
    for fn in (kstft.stft_mag, kcols.spectrogram_columns_fused):
        monkeypatch.setattr(fn, "launches", fn.launches)  # restored after
    monkeypatch.setattr(_build, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return rec


def test_b12_beyond_cap_raises_on_cuda_tensors(monkeypatch):
    """(Named for the behaviour it replaced.)  Above MAX_SIZE B12 and B7
    launch a route instead of raising (ROADMAP C1): at 65,536 points each
    wrapper makes one call of its on-chip ``*_large`` entry; B12 at a size
    the four-step route still takes (98,304) one call of
    ``mlx_stft_mag_4step`` with the host plan's N1, B7 at 50,176 one call
    of its on-chip ``mlx_spectrogram_columns_cluster`` entry, and each
    counts one launch; B12 at a size whose odd factor needs Bluestein
    columns calls ``mlx_stft_mag_bluestein`` with the plan.  Below the cap B12 launches
    the pair transform at 4096, the frame tile at 1536 and the on-chip
    transform at 32,768, as B7 does.  Only a size int32 indices cannot
    reach raises NotImplementedError, naming why, before any launch."""
    rec = _fake_cuda(monkeypatch)
    size, meta = 65536, torch.device("meta")
    wav = torch.zeros(300000).to(meta)
    b12, b7 = kstft.stft_mag.launches, kcols.spectrogram_columns_fused.launches
    out = kstft.stft_mag(wav, torch.zeros(size).to(meta), size, 8192, 5)
    assert out.shape == (5, size // 2)
    name, args = rec.calls[-1]
    assert name == "mlx_stft_mag_large" and args[5:8] == (5, size, 8192)
    ends = torch.zeros(3, dtype=torch.int32).to(meta)
    out = kcols.spectrogram_columns_fused(wav, ends, ends, 1.0, size=size)
    assert out.shape == (3, size // 2) and out.dtype == torch.int32
    name, args = rec.calls[-1]
    assert name == "mlx_spectrogram_columns_large" and args[6:8] == (3, size)
    assert kstft.stft_mag.launches == b12 + 1
    assert kcols.spectrogram_columns_fused.launches == b7 + 1
    # the four-step route at the sizes it keeps
    four = 98304
    n1, _n2 = kstft.four_step_plan(four)
    kstft.stft_mag(wav, torch.zeros(four).to(meta), four, 12288, 5)
    name, args = rec.calls[-1]
    assert name == "mlx_stft_mag_4step" and args[7:11] == (5, four, n1, 12288)
    kcols.spectrogram_columns_fused(wav, ends, ends, 1.0, size=50176)
    name, args = rec.calls[-1]
    assert name == "mlx_spectrogram_columns_cluster"
    assert args[6:8] == (3, 50176)
    # at and below the cap: B12's power-of-two sizes take the pair
    # transform, its other sizes the frame tile's entry; 32,768 points (B12
    # and B7) the on-chip transform
    kstft.stft_mag(wav, torch.zeros(4096).to(meta), 4096, 1024, 5)
    kstft.stft_mag(wav, torch.zeros(1536).to(meta), 1536, 384, 5)
    kstft.stft_mag(wav, torch.zeros(32768).to(meta), 32768, 4096, 5)
    kcols.spectrogram_columns_fused(wav, ends, ends, 1.0, size=32768)
    assert [c[0] for c in rec.calls[-4:]] == ["mlx_stft_mag_pair",
                                             "mlx_stft_mag_sizes",
                                             "mlx_stft_mag_large",
                                             "mlx_spectrogram_columns_large"]
    b12 += 5  # the 65,536, 98,304, 4096, 1536 and 32,768 calls
    # the odd factor 12,289 puts N2 above MAX_SIZE: Bluestein columns,
    # their table the chirp, its spectrum and the cluster transform's
    odd = 512 * 12289
    assert kstft.supported(odd, odd // 4)
    assert kstft.four_step_plan(odd) == (512, 12289)
    kstft.stft_mag(wav, torch.zeros(odd).to(meta), odd, odd // 4, 3)
    name, args = rec.calls[-1]
    assert name == "mlx_stft_mag_bluestein"
    assert args[7:11] == (3, odd, 512, odd // 4)
    assert kstft.bluestein_table(12289, meta).shape == (
        12289 + 32768 + 8448 + 16384, 2)
    # the rows' twiddles: fine W_N (2^12 >= sqrt N), coarse W_N, W_512,
    # the lane table W_N^(n1 q), q < 16
    assert kstft.four_step_twiddles(odd, 512, meta).shape == (
        4096 + -(-odd // 4096) + 512 + 512 * 16, 2)
    assert kstft.stft_mag.launches == b12 + 1
    # beyond int32 indices: no plan, raised before any launch
    big = 1 << 31
    assert kstft.supported(big, big // 4) and kstft.four_step_plan(big) is None
    with pytest.raises(NotImplementedError, match="2\\^31"):
        kstft.stft_mag(wav, None, big, big // 4, 3)
    assert kstft.stft_mag.launches == b12 + 1


def _b12_sizes():
    """Every size B12's predicate takes up to 2^20: multiples of 512."""
    return [s for s in range(512, (1 << 20) + 1, 512)
            if any(kstft.supported(s, s // k) for k in range(1, 9)
                   if s % k == 0)]


@pytest.mark.parametrize("kernel", ["b7", "b12"])
def test_four_step_plan_covers_every_size_above_the_cap(kernel):
    """The host factor plan for every B7 size (1024 * j, j <= 64) and every
    B12 size up to 2^20 above MAX_SIZE: N1 * N2 = size, N1 a power of two
    within MAX_N1, N2 within MAX_SIZE with a power-of-two part of at least
    4 (the column tiles' real packing), N1 the power of two nearest sqrt(size)
    that fits."""
    sizes = ([1024 * j for j in range(1, 65) if kcols.supported(1024 * j)]
             if kernel == "b7" else _b12_sizes())
    above = [s for s in sizes if s > kstft.MAX_SIZE]
    assert above and len(above) == (16 if kernel == "b7" else len(above))
    for size in above:
        n1, n2 = kstft.four_step_plan(size)
        assert n1 * n2 == size and n1 & (n1 - 1) == 0
        assert 2 <= n1 <= kstft.MAX_N1 and n2 <= kstft.MAX_SIZE
        assert (n2 & -n2) >= 4
        gap = abs(np.log2(n1) - np.log2(n2))
        for c in range(1, 15):  # no fitting power of two sits nearer sqrt
            m1 = 1 << c
            if size % (4 * m1) == 0 and size // m1 <= kstft.MAX_SIZE \
                    and m1 <= kstft.MAX_N1:
                assert abs(np.log2(m1) - np.log2(size // m1)) >= gap - 1.0
    assert kstft.four_step_plan(1 << 20) == (1024, 1024)
    assert kstft.four_step_plan(65536) == (256, 256)


@pytest.mark.parametrize("size", [65536, 64512, 50176])
def test_four_step_reference_matches_rfft(size):
    """The decomposition the kernels run, spelled in plain torch
    (``four_step_plain``), against ``torch.fft.rfft`` in float64."""
    x = np.random.default_rng(size).standard_normal((3, size)).astype(np.float32)
    n1, _n2 = kstft.four_step_plan(size)
    got = kstft.four_step_plain(torch.from_numpy(x), n1).to(torch.complex128)
    want = torch.fft.rfft(torch.from_numpy(x).double())[:, : size // 2]
    err = float((got - want).abs().square().sum() / want.abs().square().sum())
    assert 10 * np.log10(err) <= -120.0


@pytest.mark.parametrize("size,plan", [
    (512 * 12289, (512, 12289)),  # the smallest odd factor above 12,288
    (512 * 99999, (512, 99999)),
    (3 * 1024 * 12289, (1024, 3 * 12289)),
    (1 << 30, (kstft.MAX_N1, 1 << 16)),  # a power of two above N1 * N2's cap
    (1 << 31, None), (2 * 12289 + 1, None),
])
def test_four_step_plan_direct_columns(size, plan):
    """(Named for the route it replaced.)  Where no N2 within MAX_SIZE holds
    the odd factor (and a power-of-two part of 4), the plan takes N1 as
    large as fits and the kernel's N2-point columns are Bluestein
    convolutions; sizes int32 cannot index, and odd sizes, have no plan."""
    assert kstft.four_step_plan(size) == plan
    if plan is not None:
        assert kstft.four_step_bluestein(plan[1])
    assert not kstft.four_step_bluestein(256) and not kstft.four_step_bluestein(
        kstft.MAX_SIZE)


def test_four_step_reference_odd_columns_matches_rfft():
    """The decomposition at the Bluestein columns' split, N2 = 12,289 (prime):
    ``four_step_plain`` against ``torch.fft.rfft`` in float64."""
    size = 512 * 12289
    x = np.random.default_rng(7).standard_normal((1, size)).astype(np.float32)
    got = kstft.four_step_plain(torch.from_numpy(x), 512).to(torch.complex128)
    want = torch.fft.rfft(torch.from_numpy(x).double())[:, : size // 2]
    err = float((got - want).abs().square().sum() / want.abs().square().sum())
    assert 10 * np.log10(err) <= -120.0


# ----------------------------------------------------------------------
# Inverse STFT
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,hop,out_len,normalize", [
    (512, 128, 9000, True), (512, 128, 9000, False), (512, 128, 6000, True),
    (500, 120, 9000, True), (500, 120, 5000, False),
])
def test_istft_and_ola_match_jax(size, hop, out_len, normalize):
    rng = np.random.default_rng(size + out_len)
    nf = 40
    spec = (rng.standard_normal((nf, size // 2 + 1))
            + 1j * rng.standard_normal((nf, size // 2 + 1))).astype(np.complex64)
    win = tspec.hann_window(size)
    want = np.asarray(jspec.istft_device(jnp.asarray(spec), jnp.asarray(win),
                                         size, hop, out_len, normalize,
                                         packed=False))
    got = tspec.istft_device(_t(spec), _t(win), size, hop, out_len,
                             normalize).numpy()
    assert got.shape == want.shape == (out_len,)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    t = rng.standard_normal((nf, size)).astype(np.float32)
    want = np.asarray(jspec.ola_device(jnp.asarray(t), jnp.asarray(win), size,
                                       hop, out_len, normalize,
                                       pre_windowed=True))
    got = tspec.ola_device(_t(t), _t(win), size, hop, out_len, normalize,
                           pre_windowed=True).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_stft_istft_roundtrip(chirp):
    x, _sr = chirp
    win = _t(tspec.hann_window(512))
    nf = tspec.num_frames(len(x), 512, 128)
    spec = tspec.stft_device(_t(x), win, 512, 128, nf)
    out = tspec.istft_device(spec, win, 512, 128, len(x)).numpy()
    np.testing.assert_allclose(out[512:-512], x[512:-512], atol=1e-4)


# ----------------------------------------------------------------------
# Hann |STFT| pyramid
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,hop", [(512, 128), (2048, 512), (1536, 384)])
def test_spec_pyramid_matches_jax(chirp, size, hop):
    x, _sr = chirp
    jcfg = JConfig(stft_size=size, stft_hop=hop, tile_source="pyramid")
    cfg = mt.Config(stft_size=size, stft_hop=hop, tile_source="pyramid")
    jp = JSpecPyramid(x, config=jcfg)
    tp = SpecPyramid(x, config=cfg, device="cpu")
    assert tp.hops == jp.hops and tp.nbytes() == jp.nbytes()
    assert len(tp.levels) == len(jp.levels)
    for a, b in zip(tp.levels, jp.levels):
        assert tuple(a.shape) == tuple(b.shape)
        assert _snr_db(a.numpy(), np.asarray(b)) < -100.0
    for spp in (1, hop, 2 * hop, 3 * hop, 10 ** 9):
        assert tp.level_for(spp) == jp.level_for(spp)
    ends = np.asarray([size + 5 * hop, size + 9 * hop, len(x), 100, len(x) + 7])
    starts = ends - np.asarray([hop, 1, len(x) // 3, 50, 4 * hop])
    got, want = tp.compute_columns(starts, ends), jp.compute_columns(starts, ends)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _snr_db(got, want) < -100.0


def test_spec_pyramid_through_tile_server(chirp):
    x, _sr = chirp
    cfg = mt.Config(stft_size=512, stft_hop=128, tile_source="pyramid")
    p = SpecPyramid(x, config=cfg, device="cpu")
    server = mt.TileServer(x, k=cfg.brightness_to_k(), config=cfg,
                           compute=p.compute_columns, synchronous=True,
                           device="cpu")
    tile = server.get_tile(0, 0, cfg.stft_hop * 4)
    server.close()
    assert tile is not None and tile.shape == (cfg.tile_texels, 3)


# ----------------------------------------------------------------------
# Waveform min/max pyramid
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [5000, 3001, 2, 4096])
def test_build_pyramid_equals_jax(n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.5).astype(np.float32)
    want = jpyr.build_pyramid(x, device=False)
    for got in (tpyr.build_pyramid(x, device="cpu"),
                mt.build_pyramid(_t(x))):  # a tensor stays on its device
        assert got.n_levels == want.n_levels
        for lvl in range(want.n_levels):
            assert np.array_equal(got.mins[lvl], want.mins[lvl])
            assert np.array_equal(got.maxs[lvl], want.maxs[lvl])
            assert got.mins[lvl].dtype == np.float32


def test_pyramid_queries_equal_jax(chirp):
    rng = np.random.default_rng(21)
    x = (rng.standard_normal(4096) * 0.5).astype(np.float32)
    jp, tp = jpyr.build_pyramid(x), tpyr.build_pyramid(x, device="cpu")
    starts = np.concatenate([rng.integers(0, 4000, 300), [5, 10, 5, -5, 990]])
    ends = np.concatenate([starts[:300] + rng.integers(1, 900, 300),
                           [5, 8, -3, 10, 4096]])
    for got, want in zip(tpyr.query_min_max(tp, x, starts, ends),
                         jpyr.query_min_max(jp, x, starts, ends)):
        assert np.array_equal(got, want)
    for s, e in [(0, 100), (7, 250), (100, 101), (513, 1800), (2500, 2999)]:
        assert (tpyr.min_max_reference(tp, x, s, e)
                == jpyr.min_max_reference(jp, x, s, e))
    y, sr = chirp
    pk = mt.MapKnots.from_markers([mt.Marker(4000, 57.0, 0.1, 2.0)], sr, len(y))
    jk = JMapKnots.from_markers([JMarker(4000, 57.0, 0.1, 2.0)], sr, len(y))
    got = tpyr.waveform_strip(tpyr.build_pyramid(y, device="cpu"), y, pk, 300,
                              0.0, 1.0)
    want = jpyr.waveform_strip(jpyr.build_pyramid(y), y, jk, 300, 0.0, 1.0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ----------------------------------------------------------------------
# Device rules and the kernel build
# ----------------------------------------------------------------------


def test_new_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(8192, np.float32)
    cfg = mt.Config(spectr_size=1024, stft_size=512, stft_hop=128)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.spectrogram_columns(x, [0], [1024], cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.TileServer(x, k=1.0, config=cfg, synchronous=True)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.SpecPyramid(x, config=cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.build_pyramid(x)


def test_new_wrappers_refuse_other_devices():
    meta = torch.empty(8192, device="meta")
    i32 = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kcols.spectrogram_columns_fused(meta, i32, i32, 1.0, size=4096)
    with pytest.raises(ValueError, match="no kernel"):
        kstft.stft_mag(meta, torch.empty(4096, device="meta"), 4096, 1024, 3)
    assert kcols.spectrogram_columns_fused.launches == 0
    assert kstft.stft_mag.launches == 0


def test_concurrent_library_calls_build_once(monkeypatch):
    """The tile server's worker may launch the first kernel of a process
    while the caller does: library() builds and loads once."""
    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "lib.so"

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "_load", lambda p: loads.append(p) or object())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library()))
               for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and loads == ["lib.so"]
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_build_runs_one_compiler_per_source(monkeypatch, tmp_path):
    """build() starts one ``nvcc -c`` per .cu source, links the objects,
    names its files per thread and keeps every log in nvcc.log; a failing
    source raises with its name.  A shell script stands in for nvcc."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        'for a; do last="$a"; done\n'
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
        "done\n"
        'case "$last" in *bad.cu) echo "bad.cu: error"; exit 2;; esac\n'
        'echo "compiled $last" > "$out"\n'
    )
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    lib = _build.build()
    assert lib.read_text().startswith("compiled ")  # the link's output
    log = (tmp_path / "build" / "nvcc.log").read_text()
    assert log.count(" -c ") == 2 and "a.cu" in log and "b.cu" in log
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        _build.LIB_NAME, _build.LIB_NAME + ".sha256", "nvcc.log"]
    assert _build.build() == lib  # up to date: no rebuild
    (csrc / "bad.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        _build.build()


def test_new_kernel_sources_are_built():
    names = {p.name for p in _build.sources()}
    assert {"fft_fourstep.cuh", "spectrogram_columns.cu",
            "stft_mag_sizes.cu"} <= names and "fft_real.cuh" not in names
