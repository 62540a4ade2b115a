"""The port's CLI on projects and compressed files against the JAX CLI:
ports of ``tests/test_cli.py``'s ``test_info_and_project_roundtrip``,
``test_render_from_project``, ``test_render_stereo_on_project_inputs_warns``,
``test_batch_cli_flac_format``, ``test_batch_cli_projects_carry_their_markers``
and ``test_batch_autotune_layers_on_embedded_markers``, each run through both
CLIs on the same files.

Bars: granular output equal to ``tests/oracle.py``'s export of the same
input, and within JAX's own FMA drift of the JAX CLI's (atol 2e-6 in
float32, one int16 step in 16-bit files), as ``tests/test_torch_granular.py``
holds them; PV at SNR < -60 dB; ``info`` equal JSON; saved projects equal
bytes.
"""

import json
import os

import numpy as np
import pytest
import torch

import oracle
from melonix_tpu.cli import main as j_main
from melonix_tpu.io.audio import load_audio as j_load_audio
from melonix_tpu.io.wav import read_wav as j_read_wav

import melonix_tpu_torch as mt
from melonix_tpu_torch.cli import main as t_main

torch.set_num_threads(2)

STEP = 1.01 / 32767  # one int16 step


@pytest.fixture()
def song(chirp, tmp_path):
    x, sr = chirp
    p = str(tmp_path / "song.wav")
    mt.write_wav(p, x, sr, dtype="float32")
    return p, x, sr


@pytest.fixture()
def marker_file(tmp_path):
    p = str(tmp_path / "markers.json")
    with open(p, "w") as f:
        f.write(mt.markers_to_json([mt.Marker(4000, 60.0, 0.05, 2.0)]))
    return p


def _snr_db(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10.0 * np.log10(max(float(np.sum((got - want) ** 2)), 1e-300)
                           / float(np.sum(want ** 2)))


def _oracle(wav, markers, sr):
    """``oracle.export`` of a mono track under ``markers`` (Marker list)."""
    table = mt.build_grain_table(wav)
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    ref = [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]
    return oracle.export(np.ascontiguousarray(wav, np.float32), grains, ref, sr)


def _both(tmp_path, args, device=True):
    """Run ``args`` through both CLIs; ``{out}`` in an argument becomes
    ``t`` or ``j``.  Returns (port rc, JAX rc)."""
    t = [a.replace("{out}", str(tmp_path / "t")) for a in args]
    j = [a.replace("{out}", str(tmp_path / "j")) for a in args]
    return (t_main(t + (["--device", "cpu"] if device else [])), j_main(j))


def test_info_and_project_roundtrip(song, marker_file, tmp_path, capsys):
    p, x, sr = song
    rc = _both(tmp_path, ["project", p, "--markers", marker_file, "-o",
                          "{out}.mlx"], device=False)
    assert rc == (0, 0)
    t_proj, j_proj = str(tmp_path / "t.mlx"), str(tmp_path / "j.mlx")
    assert open(t_proj, "rb").read() == open(j_proj, "rb").read()
    capsys.readouterr()  # flush the "saved project" lines
    assert t_main(["info", t_proj]) == 0
    got = json.loads(capsys.readouterr().out)
    assert j_main(["info", j_proj]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert got["sample_rate"] == sr and got["markers"] == 1
    assert got["samples"] == len(x)
    assert got["warped_duration_sec"] > got["duration_sec"]  # d_time +0.05
    # and back: project of the project is the same bytes
    assert t_main(["project", t_proj, "-o", str(tmp_path / "again.mlx")]) == 0
    assert open(tmp_path / "again.mlx", "rb").read() == open(t_proj, "rb").read()


@pytest.mark.parametrize("engine", ["granular", "pv"])
@pytest.mark.parametrize("ext", ["mlx", "melonix"])
def test_render_from_project(song, marker_file, tmp_path, ext, engine):
    """A project's own markers drive the render: granular equal to the
    oracle and within 2e-6 of the JAX CLI, PV at SNR < -60 dB."""
    p, x, sr = song
    proj = str(tmp_path / f"sess.{ext}")
    assert t_main(["project", p, "--markers", marker_file, "-o", proj]) == 0
    rc = _both(tmp_path, ["render", proj, "-o", "{out}.wav", "--dtype",
                          "float32", "--engine", engine])
    assert rc == (0, 0)
    got, rate = mt.read_wav(str(tmp_path / "t.wav"))
    want, rate_j = j_read_wav(str(tmp_path / "j.wav"))
    assert rate == rate_j == sr and got.shape == want.shape and len(got) > 0
    if engine == "granular":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        markers = mt.load_project(proj).markers if ext == "mlx" else \
            [mt.Marker(4000, 60.0, 0.05, 2.0)]
        np.testing.assert_array_equal(got, _oracle(x, markers, sr))
    else:
        assert _snr_db(got, want) < -60.0


def test_render_stereo_on_project_inputs_warns(song, marker_file, tmp_path,
                                               capsys):
    """--stereo with a project input loads the mono project with a warning,
    for .mlx and .melonix alike, and renders what the JAX CLI renders."""
    p, x, sr = song
    for ext in ("sess.mlx", "sess.melonix"):
        proj = str(tmp_path / ext)
        assert t_main(["project", p, "--markers", marker_file, "-o",
                       proj]) == 0
        out_t, out_j = str(tmp_path / f"{ext}.t.wav"), str(tmp_path /
                                                           f"{ext}.j.wav")
        assert t_main(["render", proj, "-o", out_t, "--stereo", "--dtype",
                       "float32", "--device", "cpu"]) == 0
        assert "--stereo ignored" in capsys.readouterr().err
        assert j_main(["render", proj, "-o", out_j, "--stereo", "--dtype",
                       "float32"]) == 0
        assert "--stereo ignored" in capsys.readouterr().err
        got, rate = mt.read_wav(out_t)
        want, _ = j_read_wav(out_j)
        assert rate == sr and got.ndim == 1 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_batch_cli_flac_format(song, tmp_path):
    p, x, sr = song
    rc = _both(tmp_path, ["batch", p, "-o", "{out}", "--engine", "granular",
                          "--format", "flac"])
    assert rc == (0, 0)
    assert os.listdir(tmp_path / "t") == ["song.flac"]
    got, rate = mt.load_audio(str(tmp_path / "t" / "song.flac"))
    want, rate_j = j_load_audio(str(tmp_path / "j" / "song.flac"))
    assert rate == rate_j == sr and np.abs(got).max() > 0.05
    assert np.abs(got - want).max() <= STEP
    ref = str(tmp_path / "oracle.flac")
    mt.write_flac(ref, _oracle(x, [], sr), sr)
    assert open(ref, "rb").read() == open(tmp_path / "t" / "song.flac",
                                          "rb").read()


def test_batch_cli_projects_carry_their_markers(song, tmp_path):
    """Project inputs (.mlx) re-render with their own embedded edits."""
    p, x, sr = song
    proj = str(tmp_path / "sess.mlx")
    markers = [mt.Marker(4000, 60.0, 0.0, 7.0)]
    mt.save_project(proj, mt.Project(wav=x, sample_rate=sr, markers=markers))
    assert _both(tmp_path, ["batch", proj, "-o", "{out}", "--engine",
                            "granular"]) == (0, 0)
    out, _ = mt.read_wav(str(tmp_path / "t" / "sess.wav"))
    want, _ = j_read_wav(str(tmp_path / "j" / "sess.wav"))
    assert out.shape == want.shape and np.abs(out - want).max() <= STEP
    ref = str(tmp_path / "oracle.wav")
    mt.write_wav(ref, _oracle(x, markers, sr), sr)
    np.testing.assert_array_equal(out, mt.read_wav(ref)[0])
    # The project's +7-semitone bend must be audible against a plain render
    # of the same source audio.
    assert t_main(["batch", p, "-o", str(tmp_path / "plainout"), "--engine",
                   "granular", "--device", "cpu"]) == 0
    plain, _ = mt.read_wav(str(tmp_path / "plainout" / "song.wav"))
    n = min(len(out), len(plain))
    assert not np.allclose(out[:n], plain[:n], atol=1e-4)


def test_batch_autotune_layers_on_embedded_markers(tmp_path):
    """--autotune composes with a project's own edit instead of replacing
    it, in the port as in the JAX CLI."""
    sr = 8000
    t = np.arange(int(1.5 * sr)) / sr
    tone = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)  # in tune
    proj = str(tmp_path / "bent.mlx")
    mt.save_project(proj, mt.Project(
        wav=tone, sample_rate=sr,
        markers=[mt.Marker(len(tone) // 2, 57.0, 0.0, 7.0)]))
    assert _both(tmp_path, ["batch", proj, "-o", "{out}", "--engine",
                            "granular", "--autotune"]) == (0, 0)
    got, _ = mt.read_wav(str(tmp_path / "t" / "bent.wav"))
    want, _ = j_read_wav(str(tmp_path / "j" / "bent.wav"))
    assert got.shape == want.shape and np.abs(got - want).max() <= STEP

    wavp = str(tmp_path / "plain.wav")
    mt.write_wav(wavp, tone, sr, dtype="float32")
    assert t_main(["batch", wavp, "-o", str(tmp_path / "plain"), "--engine",
                   "granular", "--autotune", "--device", "cpu"]) == 0
    plain, _ = mt.read_wav(str(tmp_path / "plain" / "plain.wav"))
    n = min(len(got), len(plain))
    # The +7-semitone project edit must survive the autotune layer.
    assert not np.allclose(got[:n], plain[:n], atol=1e-4)
