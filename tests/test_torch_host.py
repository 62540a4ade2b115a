"""melonix_tpu_torch host half against melonix_tpu: plans, maps, markers, WAV.

The port's host control plane is float64 NumPy copied from the JAX package,
so it must agree exactly.  Also checks the port's device rules: importing it
pulls in no JAX, and a CUDA request where there is no CUDA raises instead of
running on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from reference_pv import REF as REF_PV

import melonix_tpu.engine.phase_vocoder as jpv
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.io.wav import read_wav as j_read_wav
from melonix_tpu.markers import Marker as JMarker
from melonix_tpu.markers import markers_from_json as j_markers_from_json
from melonix_tpu.markers import markers_to_json as j_markers_to_json

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import phase_vocoder as tpv
from melonix_tpu_torch.engine import pitch as tpitch
from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.kernels import columns as kcols
from melonix_tpu_torch.kernels import frames as kframes
from melonix_tpu_torch.kernels import pitch as kpitch
from melonix_tpu_torch.kernels import pv as kpv
from melonix_tpu_torch.kernels import resample as kres
from melonix_tpu_torch.kernels import stft as kstft
from melonix_tpu_torch.utils import tracing
from torch_fake_card import fake_card

torch.set_num_threads(2)

SR = 8000
N = 3 * SR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _marker_sets():
    rng = np.random.default_rng(42)
    samples = np.sort(rng.choice(np.arange(500, N - 500), 9, replace=False))
    nine = [(int(s), 57.0, float(rng.uniform(-0.02, 0.02)),
             float(rng.uniform(-4, 4))) for s in samples]
    rng = np.random.default_rng(300)
    samples = np.sort(rng.choice(np.arange(500, N - 500), 300, replace=False))
    long_edit = [(int(s), 57.0, float(rng.uniform(0.0, 0.002)),
                  float(rng.uniform(-4, 4))) for s in samples]
    return {
        "none": [],
        "one": [(N // 2, 57.0, 0.03, 3.0)],
        "nine": nine,
        "backward": [(N // 3, 57.0, -0.2, -5.0), (N // 2, 60.0, 0.1, 7.0)],
        "three_hundred": long_edit,
    }


MARKER_SETS = _marker_sets()


def _knots(markers, n=N, sr=SR):
    jk = JMapKnots.from_markers([JMarker(*m) for m in markers], sr, n)
    pk = mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], sr, n)
    return jk, pk


def _autotune_markers(seed, notes=120, note_s=0.25, sr=48000):
    """Autotune's form of edit: one marker a note near its middle, on a
    whole sample, ``d_time`` 0, the bend that snaps a detune of up to 45
    cents, a fifth of the notes bent 1-4 semitones further.  Returns
    (markers, track length)."""
    rng = np.random.default_rng(seed)
    per = int(note_s * sr)
    ms = []
    for i in range(notes):
        pos = i * per + per // 2 + int(rng.uniform(-0.2, 0.2) * per)
        bend = rng.uniform(-0.45, 0.45)
        if rng.uniform() < 0.2:
            bend += rng.uniform(1.0, 4.0) * rng.choice([-1.0, 1.0])
        ms.append((pos, 57.0, 0.0, float(bend)))
    return ms, notes * per


def _fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def _assert_plans_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for name in a:
        if name == "anc_np":
            assert len(a[name]) == len(b[name]) == 5
            for u, v in zip(a[name], b[name]):
                assert np.array_equal(u, v), name
                assert np.asarray(u).dtype == np.asarray(v).dtype, name
        else:
            assert np.array_equal(a[name], b[name]), name
            assert np.asarray(a[name]).dtype == np.asarray(b[name]).dtype, name


def _early_anchors(knots, plan) -> np.ndarray:
    """Indices into the plan's anchors of those at a rate-segment start
    whose time ``(j + 1) / sr`` rounds below the segment's start: where the
    JAX package's search on that time takes the previous segment's rate
    and slope."""
    sr = plan.sr
    t0s = tpv._segment_table(knots, plan.n_out / sr)[0]
    j0 = np.clip(np.ceil(t0s * sr - 1.0 - 1e-9), 0, plan.n_out_pad - 1)
    anc_j = plan.anc_np[0][: plan.anc_np[4]]
    return np.searchsorted(anc_j, j0[(j0 + 1.0) / sr < t0s])


def _assert_positions_hold(plan, markers, n, tol=1e-2):
    """Every output sample's B4 position (its plain twin over the plan's
    anchors and block bases) within ``tol`` samples of the reference's
    float64 position curve ``p(t) sr - rho(t)``."""
    anc_j, src, rho, slope, n_real = plan.anc_np
    pos = kres.positions_rel_plain(
        *(torch.from_numpy(a[:n_real]) for a in (anc_j, src, rho, slope)),
        plan.sr, plan.n_out_pad).double().numpy()
    pos += np.repeat(plan.base.astype(np.float64), kres.BLK)
    want = REF_PV.positions(markers, plan.sr, n, "cpu").numpy()
    assert len(want) == plan.n_out
    assert np.abs(pos[: plan.n_out] - want).max() < tol


def _assert_plan_held(jplan, pplan, knots, markers, n) -> np.ndarray:
    """The port's plan equals the JAX package's in every field, except at
    the anchors where the JAX package is at fault (:func:`_early_anchors`);
    there, and everywhere, the positions hold to the float64 reference.
    Returns those anchors."""
    a, b = _fields(jplan), _fields(pplan)
    early = _early_anchors(knots, pplan)
    keep = np.ones(len(a["anc_np"][0]), bool)
    keep[early] = False
    if a["anc_np"][4] - 1 in set(early.tolist()):
        keep[a["anc_np"][4]:] = False  # the padding repeats the last anchor
    for name in a:
        if name == "anc_np":
            u, v = a[name], b[name]
            assert np.array_equal(u[0], v[0]) and u[4] == v[4]
            for x, y in zip(u[1:4], v[1:4]):
                assert x.dtype == y.dtype == np.float32
                assert np.array_equal(x[keep], y[keep]), name
        else:
            assert np.array_equal(a[name], b[name]), name
            assert np.asarray(a[name]).dtype == np.asarray(b[name]).dtype, name
    _assert_positions_hold(pplan, markers, n)
    return early


@pytest.mark.parametrize("which", sorted(MARKER_SETS))
def test_build_pv_plan_equals_jax(which):
    """Bit for bit the JAX package's plan, but for the one anchor of
    ``backward`` at a whole-sample segment start, which the port takes
    from its own segment and the reference's float64 positions hold."""
    jk, pk = _knots(MARKER_SETS[which])
    jplan, pplan = jpv.build_pv_plan(jk, N), tpv.build_pv_plan(pk, N)
    early = _assert_plan_held(jplan, pplan, pk, MARKER_SETS[which], N)
    assert len(early) == (1 if which == "backward" else 0)
    if not len(early):
        _assert_plans_equal(_fields(jplan), _fields(pplan))
    assert tpv.rate_integral_total(pk, 2.5) == jpv.rate_integral_total(jk, 2.5)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_build_pv_plan_whole_sample_starts(seed):
    """Autotune's edits at 48 kHz (120 markers, ``d_time`` 0): many segment
    starts on a whole sample.  The plan is the JAX package's outside the
    anchors where that package is at fault, and every output sample's
    position lies within 1e-2 samples of the float64 curve."""
    ms, n = _autotune_markers(seed)
    jk, pk = _knots(ms, n, 48000)
    jplan, pplan = jpv.build_pv_plan(jk, n), tpv.build_pv_plan(pk, n)
    early = _assert_plan_held(jplan, pplan, pk, ms, n)
    assert len(early) > 0


def test_pv_plan_from_numpy_carries_the_jax_plan():
    jk, pk = _knots(MARKER_SETS["nine"])
    jplan = jpv.build_pv_plan(jk, N)
    plan = tpv.pv_plan_from_numpy(_fields(jplan))
    _assert_plans_equal(_fields(plan), _fields(tpv.build_pv_plan(pk, N)))
    for m0, ch in ((0, 48), (48, 48), (0, jplan.n_frames)):
        for u, v in zip(jpv._chunk_arrays(jplan, m0, ch),
                        tpv._chunk_arrays(plan, m0, ch)):
            assert np.array_equal(u, v)


def test_empty_render_plan_is_none():
    jk, pk = _knots([])
    assert tpv.build_pv_plan(pk, 1000) is None  # shorter than one frame
    assert jpv.build_pv_plan(jk, 1000) is None


@pytest.mark.parametrize("which", sorted(MARKER_SETS))
def test_mapknots_equal_jax(which):
    jk, pk = _knots(MARKER_SETS[which])
    for name in ("samples", "times", "bends"):
        assert np.array_equal(getattr(jk, name), getattr(pk, name))
    q = np.random.default_rng(3).uniform(-0.5, 4.0, 257)
    assert np.array_equal(jk.time_to_sample(q), pk.time_to_sample(q))
    assert np.array_equal(jk.time_to_sample_float(q), pk.time_to_sample_float(q))
    assert np.array_equal(jk.time_to_pitch_bend(q), pk.time_to_pitch_bend(q))
    s = q * SR
    assert np.array_equal(jk.sample_to_time(s), pk.sample_to_time(s))
    assert jk.duration() == pk.duration()


def test_markers_json_roundtrip_both_ways():
    ms = [mt.Marker(*m) for m in MARKER_SETS["nine"]][::-1]
    text = mt.markers_to_json(ms)
    assert text == j_markers_to_json([JMarker(*m) for m in MARKER_SETS["nine"]][::-1])
    back = mt.markers_from_json(text)
    assert [m.to_dict() for m in back] == [
        m.to_dict() for m in j_markers_from_json(text)
    ]
    assert [m.sample for m in back] == sorted(m.sample for m in ms)
    legacy = '[{"sample": 5, "dTime": 0.5, "pitchBend": 2.0}]'
    assert mt.markers_from_json(legacy)[0].to_dict() == {
        "sample": 5, "note": 0.0, "d_time": 0.5, "pitch_bend": 2.0}


@pytest.mark.parametrize("dtype,channels", [("int16", 1), ("float32", 1),
                                             ("int16", 2)])
def test_wav_roundtrip(tmp_path, dtype, channels):
    rng = np.random.default_rng(9)
    x = (0.8 * rng.uniform(-1, 1, (1001, channels))).astype(np.float32)
    x = x[:, 0] if channels == 1 else x
    path = str(tmp_path / "x.wav")
    mt.write_wav(path, x, 22050, dtype=dtype)
    got, rate = mt.read_wav(path)
    want, rate_j = j_read_wav(path)
    assert rate == rate_j == 22050
    assert np.array_equal(got, want)
    # int16: truncation at x 32767 on write, / 32768 on read
    tol = 2.0 / 32767 if dtype == "int16" else 0.0
    assert np.abs(got - x).max() <= tol


def test_import_pulls_in_no_jax():
    code = (
        "import sys, melonix_tpu_torch, melonix_tpu_torch.cli, "
        "melonix_tpu_torch.runtime.native, melonix_tpu_torch.kernels.render, "
        "melonix_tpu_torch.kernels.pitch, melonix_tpu_torch.engine.autotune; "
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'melonix_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cuda_request_without_cuda_raises_and_runs_nothing(monkeypatch):
    """No fallback: asking for CUDA where there is none raises before any
    twin (or kernel) runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for name in ("stft_mag_plain", "analysis_plain", "synth_ola_phase_plain"):
        monkeypatch.setattr(kpv, name, lambda *a, _n=name, **k: ran.append(_n))
    monkeypatch.setattr(kres, "resample_pv_plain",
                        lambda *a, **k: ran.append("resample_pv_plain"))
    _jk, pk = _knots(MARKER_SETS["one"])
    w = np.zeros(N, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.render_track_pv(w, pk, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        mt.render_track_pv(w, pk)  # NumPy input defaults to CUDA
    assert ran == []


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain twin only for CPU tensors: any other device
    without a kernel raises rather than computing elsewhere."""
    meta = torch.empty(4096, device="meta")
    win = torch.empty(2048, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kpv.stft_mag(meta, win, 2048, 512, 3)
    with pytest.raises(ValueError, match="no kernel"):
        kpv.analysis(meta, torch.zeros(3, dtype=torch.int32, device="meta"),
                     win, 2048)
    with pytest.raises(ValueError, match="no kernel"):
        kres.resample_pv(meta, *[None] * 7, 8000, 2048)
    assert kpv.stft_mag.launches == kpv.analysis.launches == 0


def _m(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).to("meta")


def _wrapper_cases():
    """(wrapper, its arguments with tensors from ``t``, the entries it
    launches and their spans, the output's shape) at a shape its kernel
    takes and one it does not, for every wrapper whose caller once picked
    between the kernel and the twin itself."""
    f, i32 = 6, torch.int32

    def pv(size, hop):
        nb = size // 2 + 1
        return lambda t: (t(f, nb), t(f, nb), t(f), t(size), 0, f - 1,
                          t(nb), t(nb), t(nb), size, hop)

    return {
        "synth_ola_phase-2048": (
            kpv.synth_ola_phase, pv(2048, 512),
            [("mlx_pv_synth_ola_phase", "synth_ola_phase")],
            ((f - 1) * 512 + 2048,)),
        "synth_ola_phase-4096": (kpv.synth_ola_phase, pv(4096, 1024), [],
                                 ((f - 1) * 1024 + 4096,)),
        "analysis-2048": (
            kpv.analysis, lambda t: (t(9000), t(f, dtype=i32), t(2048), 2048),
            [("mlx_pv_analysis", "analysis")], (f, 1025)),
        "analysis-4096": (
            kpv.analysis, lambda t: (t(9000), t(f, dtype=i32), t(4096), 4096),
            [("mlx_extract_frames", "extract_frames")], (f, 2049)),
        "analysis-1000": (
            kpv.analysis, lambda t: (t(9000), t(f, dtype=i32), t(1000), 1000),
            [], (f, 501)),
        "extract_frames-4096": (
            kframes.extract_frames, lambda t: (t(9000), t(f, dtype=i32), 4096),
            [("mlx_extract_frames", "extract_frames")], (f, 4096)),
        "extract_frames-1000": (
            kframes.extract_frames, lambda t: (t(9000), t(f, dtype=i32), 1000),
            [], (f, 1000)),
        "synth_ola-2048": (
            kpv.synth_ola, lambda t: (t(f, 1025), t(f, 1025), t(2048), 2048,
                                      512),
            [("mlx_pv_synth_ola", "synth_ola")], ((f - 1) * 512 + 2048,)),
        "synth_ola-4096": (
            kpv.synth_ola, lambda t: (t(f, 2049), t(f, 2049), t(4096), 4096,
                                      1024),
            [], ((f - 1) * 1024 + 4096,)),
        "columns-4096": (
            kcols.spectrogram_columns_fused,
            lambda t: (t(9000), t(f, dtype=i32), t(f, dtype=i32), 1.0, 4096),
            [("mlx_spectrogram_columns_large", "spectrogram_columns_fused")],
            (f, 2048)),
        "columns-3000": (
            kcols.spectrogram_columns_fused,
            lambda t: (t(9000), t(f, dtype=i32), t(f, dtype=i32), 1.0, 3000),
            [], (f, 1500)),
        "stft_mags-2048": (
            kstft.stft_mags, lambda t: (t(9000), t(2048), 2048, 441, f),
            [("mlx_stft_mag", "stft_mag")], (f, 1024)),
        "stft_mags-1536": (
            kstft.stft_mags, lambda t: (t(9000), t(1536), 1536, 384, f),
            [("mlx_stft_mag_sizes", "stft_mag_sizes")], (f, 768)),
        "stft_mags-1000": (
            kstft.stft_mags, lambda t: (t(9000), t(1000), 1000, 250, f),
            [], (f, 500)),
        "pitch_ac-512": (
            kpitch.pitch_ac, lambda t: (t(9000), 2048, 512, f),
            [("mlx_pitch_ac", "pitch_ac")], (f, 2048)),
        "pitch_ac-441": (kpitch.pitch_ac, lambda t: (t(9000), 2048, 441, f),
                         [], (f, 2048)),
        "pitch_ac-1024": (kpitch.pitch_ac, lambda t: (t(9000), 1024, 256, f),
                          [], (f, 1024)),
    }


@pytest.mark.parametrize("case", list(_wrapper_cases()))
def test_wrapper_picks_kernel_or_twin_by_shape(monkeypatch, case):
    """On the fake card a wrapper launches its kernel (one entry called,
    one launch counted, under the span ``kernel.<name>``) at a shape the
    kernel takes, and at one it does not runs its twin on the tensor's own
    device: no entry called, no launch counted, the twin's shape out.  B2
    at sizes other than 2048 fetches its frames through B9's wrapper,
    which launches at the sizes B9 takes."""
    fn, make, want, shape = _wrapper_cases()[case]
    rec = fake_card(monkeypatch)
    total = sum(w.launches for w in _build.COUNTED)
    tracing.start()
    try:
        out = fn(*make(_m))
    finally:
        tracing.stop()
    out = out[0] if isinstance(out, tuple) else out
    assert tuple(out.shape) == shape and out.device.type == "meta"
    assert [name for name, _args in rec.calls] == [e for e, _s in want]
    assert [r.name for r in tracing.records()] == [
        "kernel." + s for _e, s in want]
    assert sum(w.launches for w in _build.COUNTED) == total + len(want)


@pytest.mark.parametrize("case", list(_wrapper_cases()))
def test_moved_sites_run_the_twin_bit_for_bit(case):
    """On the CPU every such wrapper gives its twin's bits at both shapes
    (B2's at other sizes: B9's twin and ``torch.fft.rfft``), and the
    engine's pitch analysis gives the plain formulation's."""
    fn, make, _want, _shape = _wrapper_cases()[case]
    gen = torch.Generator().manual_seed(len(case))

    def rand(*shape, dtype=torch.float32):
        if dtype == torch.int32:
            return torch.randint(-100, 9100, shape, generator=gen,
                                 dtype=torch.int32)
        return torch.rand(shape, generator=gen, dtype=dtype)

    args = make(rand)
    got = fn(*args)
    plain = {kpv.synth_ola_phase: kpv.synth_ola_phase_plain,
             kpv.analysis: kpv.analysis_plain,
             kframes.extract_frames: kframes.extract_frames_plain,
             kpv.synth_ola: kpv.synth_ola_plain,
             kcols.spectrogram_columns_fused: kcols.spectrogram_columns_plain,
             kstft.stft_mags: kstft.stft_mag_plain,
             kpitch.pitch_ac: kpitch.pitch_ac_plain}[fn]
    want = plain(*args)
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if fn is kpitch.pitch_ac:
        wav, frame, hop, n = args
        lag_range = (40, frame - 40)
        frames = kpv.hop_frames(wav, frame, hop, n)
        centred = frames - frames.mean(dim=1, keepdim=True)
        for g, w in zip(tpitch._pitch_device(wav, frame, hop, n, *lag_range),
                        tpitch.pitch_core(centred, frame, *lag_range)):
            assert torch.equal(g, w)


def test_operand_checks():
    t = torch.zeros((4, 3))
    _build.require(t, "t", torch.float32, (4, 3), t.device)
    with pytest.raises(TypeError):
        _build.require(t.double(), "t", torch.float32, (4, 3), t.device)
    with pytest.raises(ValueError, match="shape"):
        _build.require(t, "t", torch.float32, (3, 4), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(t.T, "t", torch.float32, (3, 4), t.device)


def test_kernel_sources_and_build_hash():
    names = {p.name for p in _build.sources()}
    assert {"fft_pair.cuh", "stft_mag.cu", "pv_analysis.cu",
            "pv_synth_ola_phase.cu", "resample_pv.cu", "render_granular.cu",
            "pitch_ac.cu"} <= names
    assert not {"render_steps.cu", "compact.cu"} & names  # B5 + B6: one kernel
    assert _build.source_hash() == _build.source_hash()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # every C entry point named in SIGNATURES is defined in some source
    text = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name
