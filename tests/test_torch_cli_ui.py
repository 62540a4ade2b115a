"""The port's CLI ``spectrogram`` and ``ui`` subcommands against
melonix_tpu's on the CPU (``--device cpu``).

``spectrogram`` writes the scene as a PNG: the port's and the JAX CLI's,
from a WAV and from a ``.mlx`` with markers, with and without
``--pyramid``, are held at the scene bars (``tests/scene_bars.py``).
``ui`` builds its server on ``--device`` (``serve`` runs with its blocking
wait interrupted).  Both take the JAX CLI's arguments and defaults, plus
``--device`` (default ``cuda``, which raises without a GPU).
"""

import threading
import time

import numpy as np
import pytest
import torch

from melonix_tpu.cli import build_parser as j_build_parser
from melonix_tpu.cli import main as j_main

from melonix_tpu_torch.cli import build_parser, main
from melonix_tpu_torch.config import Config
from melonix_tpu_torch.io.project import Project, save_project
from melonix_tpu_torch.io.wav import write_wav
from melonix_tpu_torch.markers import Marker
from melonix_tpu_torch.ui import view as tview
from melonix_tpu_torch.ui import web as tweb
from melonix_tpu_torch.ui.colormap import colormap_lut
from melonix_tpu_torch.ui.state import EditorState, Viewport
from scene_bars import assert_scene_bars, decode_png

torch.set_num_threads(2)


@pytest.fixture()
def inputs(chirp, tmp_path):
    x, sr = chirp
    wav = str(tmp_path / "song.wav")
    write_wav(wav, x, sr, dtype="float32")
    mlx = save_project(str(tmp_path / "song.mlx"), Project(
        wav=x, sample_rate=sr,
        markers=[Marker(3000, 55.0, 0.05, 2.0), Marker(8000, 57.0, -0.03,
                                                       -1.5)],
        brightness=60.0, tempo=100.0))
    return {"wav": wav, "mlx": mlx}


@pytest.mark.parametrize("pyramid", [False, True])
@pytest.mark.parametrize("kind", ["wav", "mlx"])
def test_spectrogram_equals_jax(inputs, tmp_path, capsys, kind, pyramid):
    src = inputs[kind]
    extra = ["--width", "160", "--height", "120"] + (
        ["--pyramid"] if pyramid else [])
    got_p, want_p = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert main(["spectrogram", src, "-o", got_p, "--device", "cpu"]
                + extra) == 0
    assert "rendered on cpu" in capsys.readouterr().out
    assert j_main(["spectrogram", src, "-o", want_p] + extra) == 0
    with open(got_p, "rb") as f:
        got = decode_png(f.read())
    with open(want_p, "rb") as f:
        want = decode_png(f.read())
    # The scene's geometry, as the CLI sets it up.
    st = EditorState(config=Config(), viewport=Viewport(160, 120),
                     device="cpu")
    st.open_file(src)
    st.range_time = len(st.wav) / st.sample_rate
    assert len(st.markers) == (2 if kind == "mlx" else 0)
    assert got.shape == (120, 160, 3) and got.sum() > 0
    assert_scene_bars(got, want, tview, st, colormap_lut())


def test_subcommands_take_the_jax_arguments_and_defaults():
    for argv in (["spectrogram", "in.wav", "-o", "x.png"],
                 ["spectrogram", "in.mlx", "-o", "x.png", "--width", "64",
                  "--height", "48", "--start", "1", "--range", "2",
                  "--note-start", "30", "--note-range", "40",
                  "--brightness", "70", "--pyramid", "--markers", "m.json"],
                 ["ui"], ["ui", "in.wav", "--host", "0.0.0.0", "--port", "9",
                          "--pyramid"]):
        got = vars(build_parser().parse_args(argv))
        want = vars(j_build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        got.pop("fn"), want.pop("fn")
        assert got == want
    assert build_parser().parse_args(
        ["ui", "--device", "cpu"]).device == "cpu"


def test_spectrogram_default_device_raises_without_a_gpu(inputs, tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["spectrogram", inputs["wav"], "-o", str(tmp_path / "x.png")])


@pytest.mark.parametrize("pyramid", [False, True])
def test_ui_builds_its_server_on_device(inputs, monkeypatch, capsys,
                                        pyramid):
    """``ui`` opens the input in an editor on ``--device`` and serves it;
    the blocking wait is interrupted on the test's own thread, as Ctrl-C
    would, and the server stops."""
    built = []
    real_sleep = time.sleep
    main_thread = threading.current_thread()

    class Recording(tweb.EditorServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    def sleep(s):
        if threading.current_thread() is main_thread:
            raise KeyboardInterrupt
        real_sleep(s)

    monkeypatch.setattr(tweb, "EditorServer", Recording)
    monkeypatch.setattr(tweb.time, "sleep", sleep)
    monkeypatch.setenv("MELONIX_AUTOSAVE_S", "0")
    argv = ["ui", inputs["mlx"], "--port", "0", "--device", "cpu"]
    assert main(argv + (["--pyramid"] if pyramid else [])) == 0
    (srv,) = built
    assert srv.state.device == torch.device("cpu") and srv.state.loaded
    assert len(srv.state.markers) == 2
    assert (srv.state.spec_pyramid is not None) == pyramid
    assert srv.state.config.tile_source == (
        "pyramid" if pyramid else "reference")
    assert not srv._thread.is_alive()  # stopped
    assert f"editor at http://127.0.0.1:{srv.port}/" in capsys.readouterr().out
    np.testing.assert_array_equal(srv.state.wav.shape, (12000,))
