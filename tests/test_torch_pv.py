"""melonix_tpu_torch's phase-vocoder render (CPU, plain twins) against
melonix_tpu's on the CPU: the whole slice, chunked phase carry, the CLI.

PV phase propagation is chaotic (a cumsum of atan2 noise), so renders are
compared by the JAX suite's convention (test_pallas.py:473-523): equal
length, rms < 5e-3 of the peak, spectral-envelope error < 2e-2.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import melonix_tpu.engine.phase_vocoder as jpv
import oracle
from melonix_tpu.cli import main as j_main
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.spectral import hann_window as j_hann
from melonix_tpu.engine.spectral import stft_mags_device as j_stft_mags
from melonix_tpu.io.wav import read_wav as j_read_wav
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.cli import main as t_main
from melonix_tpu_torch.engine import phase_vocoder as tpv

torch.set_num_threads(2)

SR = 8000
N = 3 * SR


def _song():
    t = np.arange(N) / SR
    rng = np.random.default_rng(21)
    w = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 445 * t)
         + 0.01 * rng.standard_normal(N))
    return w.astype(np.float32)


def _markers(count):
    if count == 1:
        return [(N // 2, 57.0, 0.03, 3.0)]
    rng = np.random.default_rng(1234)
    samples = np.sort(rng.choice(np.arange(500, N - 500), count, replace=False))
    return [(int(s), 57.0, float(rng.uniform(-0.02, 0.02)),
             float(rng.uniform(-4, 4))) for s in samples]


def _knots(markers):
    return (JMapKnots.from_markers([JMarker(*m) for m in markers], SR, N),
            mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], SR, N))


def _assert_pv_close(got, want, rms_bar=5e-3):
    assert len(got) == len(want)
    scale = float(np.abs(want).max())
    rms = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rms < rms_bar * scale, rms / scale
    size = 2048
    nseg = len(want) // size
    f_g = np.abs(np.fft.rfft(got[: nseg * size].reshape(nseg, size), axis=1))
    f_w = np.abs(np.fft.rfft(want[: nseg * size].reshape(nseg, size), axis=1))
    env = np.abs(f_g - f_w).max() / f_w.max()
    assert env < 2e-2, env


@pytest.mark.parametrize("count", [1, 9])
def test_render_track_pv_matches_jax(count):
    w = _song()
    jk, pk = _knots(_markers(count))
    want = np.asarray(jpv.render_track_pv(w, jk))
    got = mt.render_track_pv(w, pk, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert len(got) == int(pk.duration() * SR)
    _assert_pv_close(got, want)


def test_render_track_pv_device_out_stays_a_tensor():
    w = torch.from_numpy(_song())
    _jk, pk = _knots(_markers(1))
    out = mt.render_track_pv(w, pk, device_out=True)  # the tensor's device
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        mt.render_track_pv(w, pk, device="meta")


def test_multichunk_render_holds_the_phase_carry(monkeypatch):
    """PV_CHUNK_FRAMES = 32 in both packages: the port's chunked render
    agrees with its one-shot render (exact phase carry; the bar of
    test_pallas.py:631-659) and with JAX's chunked render."""
    w = _song()
    jk, pk = _knots(_markers(9))
    single = mt.render_track_pv(w, pk, device="cpu")
    monkeypatch.setattr(tpv, "PV_CHUNK_FRAMES", 32)
    monkeypatch.setattr(jpv, "PV_CHUNK_FRAMES", 32)
    assert tpv.build_pv_plan(pk, N).n_frames > 32  # really several chunks
    chunked = mt.render_track_pv(w, pk, device="cpu")
    err = np.sqrt(np.mean((single - chunked) ** 2)) / np.sqrt(np.mean(single ** 2))
    assert err < 2e-3, err
    _assert_pv_close(chunked, np.asarray(jpv.render_track_pv(w, jk)))


def test_chunk_core_from_identical_plan_and_carries():
    """JAX's first chunk hands its carries (phi0_eff, resid, phi_last) to
    the second chunk of BOTH packages, with one plan built by JAX: the
    port's chunk then matches JAX's chunk, carries included."""
    w = _song()
    jk, _pk = _knots(_markers(9))
    jplan = jpv.build_pv_plan(jk, N)
    plan = tpv.pv_plan_from_numpy(
        {k: getattr(jplan, k) for k in jplan.__dataclass_fields__})
    ch, size, hop = 16, jplan.size, jplan.hop  # chunk 1: frames of audio
    win = j_hann(size)
    nb = size // 2 + 1
    z = jnp.zeros(nb, jnp.float32)

    def j_chunk(m0, carries):
        starts, da, rho, f_real = jpv._chunk_arrays(jplan, m0, ch)
        return jpv._stretch_chunk_core(
            jnp.asarray(w), jnp.asarray(starts), jnp.asarray(da),
            jnp.asarray(rho), jnp.asarray(win), jnp.int32(m0),
            jnp.int32(f_real), *carries, size=size, hop=hop, n_frames_c=ch)

    _y0, r0, pl0, p00 = j_chunk(0, (z, z, z))
    y1_j, r1_j, pl1_j, p01_j = j_chunk(ch, (p00, r0, pl0))
    starts, da, _rho, f_real = tpv._chunk_arrays(plan, ch, ch)
    y1, r1, pl1, p01 = tpv._stretch_chunk_core(
        torch.from_numpy(w), torch.from_numpy(starts), torch.from_numpy(da),
        torch.from_numpy(win), ch, f_real,
        *(torch.from_numpy(np.array(c)) for c in (p00, r0, pl0)),
        size=size, hop=hop)
    assert np.array_equal(p01.numpy(), np.asarray(p01_j))  # carried through
    # phi_last: two float32 rffts, mod 2 pi; weak bins carry the FFTs'
    # roundoff relative to their own tiny magnitude (measured 2.3e-4 rad)
    dphi = np.angle(np.exp(1j * (pl1.numpy() - np.asarray(pl1_j))))
    assert np.median(np.abs(dphi)) < 1e-5 and np.abs(dphi).max() < 1e-3
    assert np.median(np.abs(r1.numpy() - np.asarray(r1_j))) < 1e-3
    _assert_pv_close(y1.numpy(), np.asarray(y1_j))


@pytest.mark.parametrize("hop,n_frames,out_len", [
    (512, 64, 63 * 512 + 2048),  # tiled interior + exact head/tail edges
    (512, 64, 50 * 512),  # output shorter than the frames reach
    (512, 3, 2 * 512 + 2048),  # fewer frames than one window span
    (384, 20, 19 * 384 + 2048),  # hop does not divide size
])
def test_ola_wsum_matches_jax(hop, n_frames, out_len):
    win = j_hann(2048)
    want = np.asarray(jpv._ola_wsum(jnp.asarray(win), 2048, hop, n_frames,
                                    out_len))
    got = tpv._ola_wsum(torch.from_numpy(win), 2048, hop, n_frames,
                        out_len).numpy()
    assert got.shape == want.shape == (out_len,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_stft_mags_device_matches_jax():
    w = _song()
    win = j_hann(2048)
    nf = mt.engine.spectral.num_frames(N, 2048, 512)
    want = np.asarray(j_stft_mags(jnp.asarray(w), jnp.asarray(win), 2048, 512, nf))
    got = mt.stft_mags_device(torch.from_numpy(w), torch.from_numpy(win),
                              2048, 512, nf).numpy()
    snr = 10 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))
    assert got.shape == (nf, 1024) and snr < -100.0


def test_short_track_renders_silence_like_jax():
    w = _song()[:1000]  # shorter than one frame: empty plan
    jk = JMapKnots.from_markers([], SR, len(w))
    pk = mt.MapKnots.from_markers([], SR, len(w))
    got = mt.render_track_pv(w, pk, device="cpu")
    want = np.asarray(jpv.render_track_pv(w, jk))
    assert np.array_equal(got, want) and not got.any()


@pytest.mark.parametrize("count", [1, 9])
def test_ported_render_options_phase_locking_matches_jax(count):
    """Identity phase locking (once an unported option): the port's render
    against JAX's, by the PV convention."""
    w = _song()
    jk, pk = _knots(_markers(count))
    want = np.asarray(jpv.render_track_pv(w, jk, phase_locking=True))
    got = mt.render_track_pv(w, pk, device="cpu", phase_locking=True)
    _assert_pv_close(got, want)


@pytest.mark.parametrize("count", [1, 9])
def test_ported_render_options_preserve_formants_matches_jax(count):
    """The formant warp (once an unported option): the port's render
    against JAX's, by the PV convention."""
    w = _song()
    jk, pk = _knots(_markers(count))
    want = np.asarray(jpv.render_track_pv(w, jk, preserve_formants=True))
    got = mt.render_track_pv(w, pk, device="cpu", preserve_formants=True)
    _assert_pv_close(got, want)


def _cli_files(tmp_path, channels=1):
    wav_path, markers_path = str(tmp_path / "in.wav"), str(tmp_path / "m.json")
    x = _song()[: 2 * SR]
    if channels == 2:
        x = np.stack([x, 0.8 * x[::-1]], axis=1)
    mt.write_wav(wav_path, x, SR, dtype="float32" if channels == 2 else "int16")
    with open(markers_path, "w") as f:
        json.dump([{"sample": SR, "note": 57.0, "d_time": 0.05,
                    "pitch_bend": 2.0}], f)
    return wav_path, markers_path


def test_cli_render_pv_matches_jax_cli(tmp_path, capsys):
    wav_path, markers_path = _cli_files(tmp_path)
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    assert t_main(["render", wav_path, "--markers", markers_path, "-o", out_t,
                   "--engine", "pv", "--device", "cpu"]) == 0
    assert j_main(["render", wav_path, "--markers", markers_path, "-o", out_j,
                   "--engine", "pv"]) == 0
    got, rate = mt.read_wav(out_t)
    want, rate_j = j_read_wav(out_j)
    assert rate == rate_j == SR
    assert len(got) == len(want) > 2 * SR  # d_time lengthens the render
    assert "phase-vocoder" in capsys.readouterr().out


def test_cli_ported_flags_formant_matches_jax_cli(tmp_path, capsys):
    """``render --engine pv --formant`` (once an unported flag) against the
    JAX CLI's, float32 output, by the PV convention."""
    wav_path, markers_path = _cli_files(tmp_path)
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    flags = ["--engine", "pv", "--formant", "--dtype", "float32"]
    assert t_main(["render", wav_path, "--markers", markers_path, "-o", out_t,
                   "--device", "cpu", *flags]) == 0
    assert "formant-preserving" in capsys.readouterr().out
    assert j_main(["render", wav_path, "--markers", markers_path, "-o", out_j,
                   *flags]) == 0
    got, rate = mt.read_wav(out_t)
    want, rate_j = j_read_wav(out_j)
    assert rate == rate_j == SR
    _assert_pv_close(got, want)


@pytest.mark.parametrize("extra,label", [
    (["--lock"], "phase-locked"),
    (["--stereo"], "x2ch"),
    (["--stereo", "--lock", "--formant"], "phase-locked"),
])
def test_cli_ported_flags_lock_stereo_match_jax_cli(tmp_path, capsys, extra,
                                                    label):
    """``render --engine pv`` with ``--lock`` and/or ``--stereo`` (once
    unported flags) against the JAX CLI's, float32 output, by the PV
    convention on each channel."""
    wav_path, markers_path = _cli_files(tmp_path, channels=2)
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    flags = ["--engine", "pv", "--dtype", "float32", *extra]
    assert t_main(["render", wav_path, "--markers", markers_path, "-o", out_t,
                   "--device", "cpu", *flags]) == 0
    assert label in capsys.readouterr().out
    assert j_main(["render", wav_path, "--markers", markers_path, "-o", out_j,
                   *flags]) == 0
    got, rate = mt.read_wav(out_t)
    want, rate_j = j_read_wav(out_j)
    assert rate == rate_j == SR and got.shape == want.shape
    assert got.ndim == (2 if "--stereo" in extra else 1)
    for c in range(got.shape[1] if got.ndim == 2 else 1):
        _assert_pv_close(got[:, c] if got.ndim == 2 else got,
                         want[:, c] if want.ndim == 2 else want)


@pytest.mark.parametrize("stereo", [False, True])
def test_cli_render_granular_matches_jax_cli(tmp_path, capsys, stereo):
    """The default engine (granular), mono downmix or --stereo: float32
    output within JAX's own FMA drift of the JAX CLI's (atol 2e-6), and
    equal to oracle.export on the same input."""
    wav_path, markers_path = _cli_files(tmp_path, channels=2)
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    extra = ["--stereo"] if stereo else []
    assert t_main(["render", wav_path, "--markers", markers_path, "-o", out_t,
                   "--dtype", "float32", "--device", "cpu", *extra]) == 0
    assert "granular" in capsys.readouterr().out
    assert j_main(["render", wav_path, "--markers", markers_path, "-o", out_j,
                   "--dtype", "float32", *extra]) == 0
    got, rate = mt.read_wav(out_t)
    want, rate_j = j_read_wav(out_j)
    assert rate == rate_j == SR
    assert got.shape == want.shape and got.ndim == (2 if stereo else 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    src, _ = mt.read_wav(wav_path)
    mono = src.mean(axis=1).astype(np.float32)
    table = mt.build_grain_table(mono)
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    ref = [(SR, 57.0, 0.05, 2.0)]
    chans = [np.ascontiguousarray(src[:, c]) for c in range(2)] if stereo \
        else [mono]
    for c, ch in enumerate(chans):
        np.testing.assert_array_equal(
            got[:, c] if stereo else got, oracle.export(ch, grains, ref, SR))


@pytest.mark.parametrize("extra", [
    ["--engine", "pv", "--rate", "16000"], ["--engine", "pv", "--trace", "tr"],
])
def test_cli_unported_flags_exit_nonzero(tmp_path, capsys, extra):
    """``render --rate`` and ``render --trace`` (once refused with exit 2):
    the port's output at the JAX CLI's rate and by the PV convention against
    it (``--rate`` through both packages' polyphase resamplers); the trace
    directory holds a Chrome trace that parses and names the render's
    profiled operations."""
    wav_path, markers_path = _cli_files(tmp_path)
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    flags = [str(tmp_path / a) if a == "tr" else a for a in extra]
    common = ["--markers", markers_path, "--dtype", "float32"]
    assert t_main(["render", wav_path, "-o", out_t, "--device", "cpu",
                   *common, *flags]) == 0
    rate = 16000 if "--rate" in extra else SR
    assert f"@{rate}Hz" in capsys.readouterr().out
    # the JAX CLI's --trace would start jax.profiler: it renders untraced
    j_flags = extra if "--rate" in extra else extra[:2]
    assert j_main(["render", wav_path, "-o", out_j, *common, *j_flags]) == 0
    got, got_rate = mt.read_wav(out_t)
    want, want_rate = j_read_wav(out_j)
    assert got_rate == want_rate == rate
    _assert_pv_close(got, want)
    if "--trace" in extra:
        (name,) = (tmp_path / "tr").iterdir()
        with open(name) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)


def test_cli_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav_path, _m = _cli_files(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        t_main(["render", wav_path, "-o", str(tmp_path / "o.wav"),
                "--engine", "pv"])  # --device defaults to cuda
