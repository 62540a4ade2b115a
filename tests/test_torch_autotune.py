"""Autotune and formant preservation of melonix_tpu_torch against melonix_tpu
on the CPU.

The host half (``snap_note``, ``segment_notes``, ``suggest_markers``) must
agree exactly given one pitch curve; the formant gain to float32 rounding;
formant-preserving PV renders and ``autotune`` by the PV convention of
tests/test_torch_pv.py (rms < 5e-3 of the peak, spectral-envelope error <
2e-2) and granular ones within the granular tests' 2e-6; B3's (mag, phi)
entry against its (re, im) entry; the JAX suite's behavioural checks on the
port; and the CLI's ``pitch``, ``autotune`` and ``render --formant``
against the JAX CLI's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import reference_pv
from test_torch_pitch import assert_curves_close, from_jax
from test_torch_pv import _assert_pv_close

from melonix_tpu.cli import main as j_main
from melonix_tpu.config import Config as JConfig
from melonix_tpu.engine import autotune as jat
from melonix_tpu.engine import phase_vocoder as jpv
from melonix_tpu.engine import pitch as jpitch
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.io.wav import read_wav as j_read_wav
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.cli import main as t_main
from melonix_tpu_torch.engine import autotune as tat
from melonix_tpu_torch.engine import phase_vocoder as tpv
from melonix_tpu_torch.engine import pitch as tpitch
from melonix_tpu_torch.engine.spectral import hann_window
from melonix_tpu_torch.kernels import pv as kpv

torch.set_num_threads(2)

SR = 16000


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _detuned_melody(cents, notes_hz, seconds_each=0.5, sr=SR):
    """test_autotune.py:23-29."""
    t = np.arange(int(sr * seconds_each)) / sr
    segs = [0.5 * np.sin(2 * np.pi * hz * 2.0 ** (c / 1200.0) * t)
            for hz, c in zip(notes_hz, cents)]
    return np.concatenate(segs).astype(np.float32)


def _vibrato(sr=8000):
    """test_autotune.py:79-83: +-70 cents of 2 Hz vibrato around 220 Hz."""
    t = np.arange(3 * sr) / sr
    f_inst = 220.0 * 2.0 ** (0.7 * np.sin(2 * np.pi * 2.0 * t) / 12.0)
    return (0.5 * np.sin(2 * np.pi * np.cumsum(f_inst) / sr)).astype(np.float32)


def _markers_equal(got, want, bend_atol=1e-3):
    """Same count, equal samples, notes and bends within ``bend_atol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, mt.Marker)
        assert g.sample == w.sample and g.d_time == w.d_time
        assert abs(g.note - w.note) < bend_atol
        assert abs(g.pitch_bend - w.pitch_bend) < bend_atol


# ----------------------------------------------------------------------
# Host half
# ----------------------------------------------------------------------


@pytest.mark.parametrize("scale", ["chromatic", "major", "minor"])
def test_snap_note_equals_jax(scale):
    notes = np.random.default_rng(7).uniform(10.0, 90.0, 200)
    for key in tat.KEY_OFFSETS:
        for x in notes:
            assert tat.snap_note(x, scale, key) == jat.snap_note(x, scale, key)
    assert tat.SCALES == jat.SCALES and tat.KEY_OFFSETS == jat.KEY_OFFSETS


def test_snap_note_suite_cases_on_the_port():
    """test_autotune.py:11-20."""
    assert tat.snap_note(57.3) == 57.0 and tat.snap_note(57.6) == 58.0
    assert tat.snap_note(57.0, "major", "a") == 57.0
    assert tat.snap_note(58.0, "major", "a") in (57.0, 59.0)
    assert tat.snap_note(27.2, "major", "c") == 27.0


@pytest.mark.parametrize("split_jump", [0.6, 1.5])
def test_segment_notes_equals_jax_on_one_curve(split_jump):
    """One JAX curve carried across field by field: identical segments."""
    x = np.concatenate([_detuned_melody([40, -35, 0], [220.0, 330.0, 262.0]),
                        np.zeros(SR // 4, np.float32), _vibrato(SR)])
    jc = jpitch.pitch_curve(x, SR)
    got = tat.segment_notes(from_jax(tpitch.PitchCurve, jc),
                            split_jump=split_jump)
    assert got == jat.segment_notes(jc, split_jump=split_jump)
    assert len(got) >= 3


def test_running_median_equals_numpy():
    rng = np.random.default_rng(3)
    med, seen = tat._RunningMedian(), []
    for v in rng.standard_normal(301):
        med.push(float(v))
        seen.append(float(v))
        assert med.median() == pytest.approx(float(np.median(seen)), abs=0)


MELODIES = {
    "detuned": lambda: _detuned_melody([40, -35], [220.0, 330.0]),
    "clean": lambda: _detuned_melody([0, 0], [220.0, 330.0]),
    "long": lambda: _detuned_melody([45], [220.0], seconds_each=1.5),
    "four": lambda: _detuned_melody([25, -30, 15, -45],
                                    [196.0, 247.0, 294.0, 392.0]),
}


@pytest.mark.parametrize("vibrato", [0.0, 1.0])
@pytest.mark.parametrize("name", sorted(MELODIES))
def test_suggest_markers_matches_jax(name, vibrato):
    x = MELODIES[name]()
    want = jat.suggest_markers(x, SR, vibrato=vibrato)
    got = mt.suggest_markers(x, SR, vibrato=vibrato, device="cpu")
    _markers_equal(got, want)


def test_suggest_markers_suite_checks_on_the_port():
    """test_autotune.py:32-42 on the port."""
    bends = [m.pitch_bend for m in mt.suggest_markers(
        MELODIES["detuned"](), SR, device="cpu")]
    assert len(bends) >= 4
    assert any(abs(b + 0.40) < 0.15 for b in bends)
    assert any(abs(b - 0.35) < 0.15 for b in bends)
    assert mt.suggest_markers(MELODIES["clean"](), SR, device="cpu") == []


def test_suggest_markers_scale_key_strength_method_match_jax():
    x = MELODIES["four"]()
    kw = dict(scale="major", key="c", strength=0.7, method="hybrid")
    _markers_equal(mt.suggest_markers(x, SR, device="cpu", **kw),
                   jat.suggest_markers(x, SR, **kw))


# ----------------------------------------------------------------------
# Formant preservation
# ----------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(0.7, 1.4), (1.0, 1.0), (0.94, 1.06)])
def test_formant_gain_matches_jax(lo, hi):
    """Against JAX's natural-order gain (scrambled=False): relative error
    <= 1e-4, on analysis magnitudes of a real chunk."""
    rng = np.random.default_rng(11)
    x = (np.sin(2 * np.pi * 220 * np.arange(40000) / SR)
         + 0.3 * rng.standard_normal(40000)).astype(np.float32)
    starts = np.sort(rng.integers(0, 38000, 48)).astype(np.int32)
    re, im = kpv.analysis_plain(_t(x), _t(starts), _t(hann_window(2048)), 2048)
    mag = torch.sqrt(re * re + im * im)
    rho = rng.uniform(lo, hi, 48).astype(np.float32)
    want = np.asarray(jpv._formant_gain(jnp.asarray(mag.numpy()),
                                        jnp.asarray(rho), 2048, 1025, 40,
                                        scrambled=False))
    got = tpv._formant_gain(mag, _t(rho), 2048).numpy()
    assert got.shape == want.shape == (48, 1025) and got.dtype == np.float32
    assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-4
    if lo == hi == 1.0:
        np.testing.assert_array_equal(got, 1.0)  # no pitch move, no warp


def test_synth_ola_phase_polar_entry_equals_cartesian():
    """B3's twin fed (|X|, angle X) with cart=False equals its (re, im)
    entry within 1e-5 of the peak, carries included."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(30000) * 0.3).astype(np.float32)
    starts = np.sort(rng.integers(0, 28000, 40)).astype(np.int32)
    win = _t(hann_window(2048))
    re, im = kpv.analysis_plain(_t(x), _t(starts), win, 2048)
    da = _t(rng.uniform(300, 700, 40).astype(np.float32))
    carries = [_t(rng.uniform(-3, 3, 1025).astype(np.float32)) for _ in range(3)]
    for m0, f_real in ((0, 40), (96, 33)):
        args = (da, win, m0, f_real, *carries, 2048, 512)
        cart = kpv.synth_ola_phase(re, im, *args)  # cart=True by default
        polar = kpv.synth_ola_phase(torch.sqrt(re * re + im * im),
                                    torch.atan2(im, re), *args, cart=False)
        peak = float(cart[0].abs().max())
        assert torch.allclose(polar[0], cart[0], rtol=0, atol=1e-5 * peak)
        for a, b in zip(polar[1:], cart[1:]):
            assert torch.equal(a, b)


def _pv_pair(markers, n, sr=SR):
    jk = JMapKnots.from_markers([JMarker(*m) for m in markers], sr, n)
    pk = mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], sr, n)
    return jk, pk


def _song(n=3 * SR, seed=21):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    w = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 445 * t)
         + 0.1 * np.sin(2 * np.pi * 1310 * t) + 0.01 * rng.standard_normal(n))
    return w.astype(np.float32)


FORMANT_MARKERS = {
    "one": [(3 * SR // 2, 57.0, 0.03, 3.0)],
    "five": [(int(s), 57.0, d, b) for s, d, b in zip(
        np.linspace(4000, 44000, 5), (0.01, -0.02, 0.0, 0.02, -0.01),
        (-4.0, 2.5, 5.0, -1.5, 3.0))],
}


# Edits on which the JAX package's plan is at fault (a segment starting on
# a whole output sample: "five"'s third marker, autotune's markers), and
# whose renders are held to the float64 reference instead
# (tests/reference_pv.py).
JAX_AT_FAULT = {"five"}


def _formant_oracle(w, which, jk):
    if which in JAX_AT_FAULT:
        return reference_pv.render(w, FORMANT_MARKERS[which], SR,
                                   formants=True)
    return np.asarray(jpv.render_track_pv(w, jk, preserve_formants=True))


@pytest.mark.parametrize("which", sorted(FORMANT_MARKERS))
def test_render_track_pv_formants_matches_jax(which):
    """The JAX package's render, or where its plan is at fault the float64
    reference's, under the PV bar."""
    w = _song()
    jk, pk = _pv_pair(FORMANT_MARKERS[which], len(w))
    want = _formant_oracle(w, which, jk)
    got = mt.render_track_pv(w, pk, preserve_formants=True, device="cpu")
    assert got.dtype == np.float32 and len(got) == int(pk.duration() * SR)
    _assert_pv_close(got, want)
    plain = mt.render_track_pv(w, pk, device="cpu")
    assert np.sqrt(np.mean((got - plain) ** 2)) > 1e-3 * np.abs(plain).max()


def test_multichunk_formant_render_matches_jax(monkeypatch):
    """PV_CHUNK_FRAMES = 32 in both packages (test_phase_vocoder.py:131):
    the per-chunk rho carries the warp across chunks.  "five" has an
    anchor at which the JAX package is at fault: the chunked render is held
    to the float64 reference there."""
    w = _song()
    jk, pk = _pv_pair(FORMANT_MARKERS["five"], len(w))
    single = mt.render_track_pv(w, pk, preserve_formants=True, device="cpu")
    monkeypatch.setattr(tpv, "PV_CHUNK_FRAMES", 32)
    monkeypatch.setattr(jpv, "PV_CHUNK_FRAMES", 32)
    assert tpv.build_pv_plan(pk, len(w)).n_frames > 3 * 32
    chunked = mt.render_track_pv(w, pk, preserve_formants=True, device="cpu")
    _assert_pv_close(chunked, single)
    _assert_pv_close(chunked, _formant_oracle(w, "five", jk))


def test_render_session_pv_formants_matches_jax():
    """On "five", where the JAX package's plan is at fault: held to the
    float64 reference, and the JAX session's length."""
    from melonix_tpu.engine.session import render_session as j_session

    w = _song()
    ms = FORMANT_MARKERS["five"]
    j_out = np.asarray(j_session(w, [JMarker(*m) for m in ms], SR,
                                 engine="pv", preserve_formants=True,
                                 mesh=None))
    want = reference_pv.render(w, ms, SR, formants=True)
    assert j_out.shape == want.shape
    got = mt.render_session(w, [mt.Marker(*m) for m in ms], SR, engine="pv",
                            preserve_formants=True, device="cpu")
    _assert_pv_close(got, want)


# ----------------------------------------------------------------------
# autotune
# ----------------------------------------------------------------------


@pytest.mark.parametrize("engine,formants", [("pv", True), ("pv", False),
                                             ("granular", True)])
def test_autotune_matches_jax(engine, formants):
    x = _detuned_melody([45, -30], [220.0, 294.0], seconds_each=1.5)
    want, wm = jat.autotune(x, SR, engine=engine, preserve_formants=formants)
    got, gm = mt.autotune(x, SR, engine=engine, preserve_formants=formants,
                          device="cpu")
    _markers_equal(gm, wm)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if engine == "pv":
        _assert_pv_close(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _corrected_median(out, sr=SR, cfg=None):
    c = mt.pitch_curve(np.asarray(out, np.float32), sr, device="cpu",
                       **({"config": cfg} if cfg else {}))
    q = len(c.note) // 4
    mid, v = c.note[q : 3 * q], c.voiced[q : 3 * q]
    return float(np.median(mid[v]))


@pytest.mark.parametrize("formants", [False, True])
def test_autotune_corrects_to_within_10_cents(formants):
    """test_autotune.py:45-54 on the port, with the defaults' formant
    preservation too: 220 Hz +45 cents lands on note 48 within 10 cents."""
    x = _detuned_melody([45], [220.0], seconds_each=1.5)
    out, markers = mt.autotune(x, SR, engine="pv",
                               preserve_formants=formants, device="cpu")
    assert len(markers) >= 2
    assert abs(_corrected_median(out) - 48.0) < 0.1


def test_autotune_strength_half_on_the_port():
    """test_autotune.py:57-64 on the port."""
    x = _detuned_melody([44], [220.0], seconds_each=1.5)
    out, _ = mt.autotune(x, SR, strength=0.5, engine="granular", device="cpu")
    c = mt.pitch_curve(out, SR, device="cpu")
    sel = c.voiced & (np.arange(len(c.note)) > len(c.note) // 4)
    assert 0.1 < float(np.median(c.note[sel])) - 48.0 < 0.35


def test_vibrato_flattening_on_the_port():
    """test_autotune.py:67-97 on the port (frame 1024: the plain route)."""
    sr, cfg = 8000, mt.Config(pitch_frame=1024, pitch_hop=256)
    x = _vibrato(sr)
    assert len(mt.suggest_markers(x, sr, vibrato=1.0, config=cfg,
                                  device="cpu")) > 8
    out, _ = mt.autotune(x, sr, vibrato=1.0, engine="pv",
                         preserve_formants=False, config=cfg, device="cpu")
    c_in = mt.pitch_curve(x, sr, config=cfg, device="cpu")
    c_out = mt.pitch_curve(out, sr, config=cfg, device="cpu")
    std_in = float(np.std(c_in.note[c_in.voiced]))
    std_out = float(np.std(c_out.note[c_out.voiced]))
    assert std_in > 0.2 and std_out < 0.5 * std_in
    assert abs(float(np.median(c_out.note[c_out.voiced])) - 48.0) < 0.3


def test_vibrato_autotune_matches_jax():
    sr = 8000
    jcfg = JConfig(pitch_frame=1024, pitch_hop=256)
    tcfg = mt.Config(pitch_frame=1024, pitch_hop=256)
    x = _vibrato(sr)
    want, wm = jat.autotune(x, sr, vibrato=1.0, config=jcfg)
    got, gm = mt.autotune(x, sr, vibrato=1.0, config=tcfg, device="cpu")
    _markers_equal(gm, wm)
    # autotune's markers start segments on whole samples, where the JAX
    # package's plan is at fault: the render is held to the float64
    # reference (formants on, autotune's default), and the JAX length
    ref = reference_pv.render(x, gm, sr, formants=True)
    assert got.shape == ref.shape == np.asarray(want).shape
    _assert_pv_close(got, ref)


def test_autotune_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.autotune(MELODIES["long"](), SR)  # device defaults to cuda


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


def _wav_file(tmp_path, x, sr=SR, name="in.wav"):
    path = str(tmp_path / name)
    mt.write_wav(path, x, sr, dtype="float32")
    return path


@pytest.mark.parametrize("method", ["nsdf", "hybrid"])
def test_cli_pitch_matches_jax_cli(tmp_path, capsys, method):
    x = np.concatenate([MELODIES["four"](), _vibrato(SR)])
    src = _wav_file(tmp_path, np.stack([x, 0.5 * x], axis=1))  # downmixed
    out_t, out_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert t_main(["pitch", src, "-o", out_t, "--method", method,
                   "--device", "cpu"]) == 0
    assert "on cpu" in capsys.readouterr().out
    assert j_main(["pitch", src, "-o", out_j, "--method", method]) == 0
    with open(out_t) as f:
        got = json.load(f)
    with open(out_j) as f:
        want = json.load(f)
    assert got.keys() == want.keys()
    assert got["sample_rate"] == want["sample_rate"] == SR
    assert got["hop"] == want["hop"]
    curve = lambda d: tpitch.PitchCurve(  # noqa: E731
        f0=np.asarray(d["f0_hz"], np.float32), voiced=np.asarray(d["voiced"]),
        clarity=np.zeros(len(d["f0_hz"]), np.float32),
        note=np.asarray(d["note"], np.float32), hop=d["hop"],
        sample_rate=d["sample_rate"])
    assert_curves_close(curve(got), curve(want))


@pytest.mark.parametrize("extra", [[], ["--no-formant"],
                                   ["--engine", "granular"],
                                   ["--scale", "minor", "--key", "d",
                                    "--strength", "0.8"]])
def test_cli_autotune_matches_jax_cli(tmp_path, capsys, extra):
    src = _wav_file(tmp_path, MELODIES["four"]())
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    mk_t, mk_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert t_main(["autotune", src, "-o", out_t, "--dtype", "float32",
                   "--markers-out", mk_t, "--device", "cpu", *extra]) == 0
    assert "autotuned" in capsys.readouterr().out
    assert j_main(["autotune", src, "-o", out_j, "--dtype", "float32",
                   "--markers-out", mk_j, *extra]) == 0
    got, rate = mt.read_wav(out_t)
    want, rate_j = j_read_wav(out_j)
    assert rate == rate_j == SR
    with open(mk_t) as f:
        gm = mt.markers_from_json(f.read())
    with open(mk_j) as f:
        wm = mt.markers_from_json(f.read())
    _markers_equal(gm, wm)
    _assert_pv_close(got, want)
    if "granular" in extra:
        # bends that agree to float32 rounding move granular samples by
        # ~1e-5; from JAX's own markers the port's render is within 2e-6
        x, _ = mt.read_wav(src)
        same = mt.render_session(x, wm, SR, engine="granular", device="cpu")
        np.testing.assert_allclose(same, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("cmd", [["pitch"], ["autotune"]])
def test_cli_analysis_non_wav_input_exits_nonzero(tmp_path, capsys, cmd):
    """``pitch`` and ``autotune`` of a FLAC (once refused with exit 2):
    the native decode, then the same analysis as the JAX CLI's on the same
    file.  The pitch curve by :func:`assert_curves_close`; autotune's
    markers by ``_markers_equal``, and, since bends that agree to float32
    rounding (~4e-6 st on this 16-bit input) move a PV render by ~7e-3 of
    its peak, the port's render from the JAX CLI's markers against the JAX
    CLI's output by the PV convention, as the granular case above does."""
    src = str(tmp_path / "in.flac")
    mt.write_flac(src, MELODIES["four"](), SR)
    ext = ".json" if cmd == ["pitch"] else ".wav"
    out_t, out_j = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    mk_t, mk_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    extra_t, extra_j = [], []
    if cmd == ["autotune"]:
        extra_t = ["--dtype", "float32", "--markers-out", mk_t]
        extra_j = ["--dtype", "float32", "--markers-out", mk_j]
    assert t_main([*cmd, src, "-o", out_t, "--device", "cpu", *extra_t]) == 0
    assert "on cpu" in capsys.readouterr().out
    assert j_main([*cmd, src, "-o", out_j, *extra_j]) == 0
    if cmd == ["pitch"]:
        with open(out_t) as f:
            got = json.load(f)
        with open(out_j) as f:
            want = json.load(f)
        assert got["sample_rate"] == want["sample_rate"] == SR
        curve = lambda d: tpitch.PitchCurve(  # noqa: E731
            f0=np.asarray(d["f0_hz"], np.float32),
            voiced=np.asarray(d["voiced"]),
            clarity=np.zeros(len(d["f0_hz"]), np.float32),
            note=np.asarray(d["note"], np.float32), hop=d["hop"],
            sample_rate=d["sample_rate"])
        assert_curves_close(curve(got), curve(want))
    else:
        got, rate = mt.read_wav(out_t)
        want, rate_j = j_read_wav(out_j)
        assert rate == rate_j == SR and got.shape == want.shape
        with open(mk_t) as f:
            gm = mt.markers_from_json(f.read())
        with open(mk_j) as f:
            wm = mt.markers_from_json(f.read())
        _markers_equal(gm, wm)
        x, _ = mt.load_audio(src)
        same = mt.render_session(x, wm, SR, engine="pv",
                                 preserve_formants=True, device="cpu")
        _assert_pv_close(same, want)
