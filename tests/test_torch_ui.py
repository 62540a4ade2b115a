"""The port's editor state machine and scene renderer against melonix_tpu's
on the CPU (``device="cpu"``: the kernels' plain twins).

The same seeded gesture sequence through both packages' ``EditorState``
must leave exactly equal view, cursor, selection and markers after every
event (float64 host code on both sides).  ``render_scene`` of both is held
at the scene bars (``tests/scene_bars.py``): bit-equal outside the
spectrogram lane, >= 99.9% of lane pixels equal and none more than one
colormap level off inside it; the pitch overlay drawn from one shared
curve is bit-equal.  Then the port's own contracts as tests/test_ui.py
states them for the JAX package: history, follow mode, projects, fail-soft
import, export, black-until-ready, the overlay, the pan memos, the
overlay adds; the frame encoders; no fallback off the asked device; no
JAX in the port.
"""

import ast
import os
import pathlib
import time

import numpy as np
import pytest
import torch

from melonix_tpu.config import Config as JConfig
from melonix_tpu.engine.pitch import PitchCurve as JPitchCurve
from melonix_tpu.ui import png as jpng
from melonix_tpu.ui import view as jview
from melonix_tpu.ui.state import EditorState as JEditorState
from melonix_tpu.ui.state import Viewport as JViewport

import melonix_tpu_torch as mt
from melonix_tpu_torch.config import Config
from melonix_tpu_torch.engine.pitch import PitchCurve
from melonix_tpu_torch.io.wav import read_wav, write_wav
from melonix_tpu_torch.markers import Marker
from melonix_tpu_torch.ui import png as tpng
from melonix_tpu_torch.ui import view as tview
from melonix_tpu_torch.ui.colormap import colormap_lut
from melonix_tpu_torch.ui.state import (BUTTON_LEFT, BUTTON_MIDDLE,
                                        BUTTON_RIGHT, MENU_BAR_PX, MOD_ALT,
                                        MOD_CTRL, EditorState, Viewport)
from melonix_tpu_torch.ui.view import render_scene
from scene_bars import assert_scene_bars, decode_png

torch.set_num_threads(2)

CFG = dict(spectr_size=1024, max_ranges=64)
# The scene comparisons hold the viewport and its margins in the tile
# cache (200 + 2 x 50 columns): below that every drain evicts, and the
# lane is mostly the black of evicted columns on both sides.
CFG_SCENE = dict(spectr_size=1024, max_ranges=1024)
LUT = colormap_lut()
MIDDLE = 1 << (BUTTON_MIDDLE - 1)
LEFT = 1 << (BUTTON_LEFT - 1)


def _close(*states):
    for st in states:
        if st._tile_server is not None:
            st._tile_server.close()


def _pair(path, cfg=CFG, vp=(200, 150), **kw):
    j = JEditorState(config=JConfig(**cfg, **kw), viewport=JViewport(*vp))
    t = EditorState(config=Config(**cfg, **kw), viewport=Viewport(*vp),
                    device="cpu")
    j.open_file(path)
    t.open_file(path)
    return j, t


@pytest.fixture()
def song(chirp, tmp_path):
    x, sr = chirp
    path = str(tmp_path / "song.wav")
    write_wav(path, x, sr, dtype="float32")
    return path


@pytest.fixture()
def editor(song):
    ed = EditorState(config=Config(**CFG), viewport=Viewport(200, 150),
                     device="cpu")
    ed.open_file(song)
    yield ed
    _close(ed)


def _snap(st):
    return (st.start_time, st.range_time, st.start_note, st.range_note,
            st.cursor_sec, st.selected, st.follow_mode, st.is_playing,
            [(m.sample, m.note, m.d_time, m.pitch_bend) for m in st.markers])


def _bent_xy(st, m):
    lane_h = st.viewport.lane_height
    x = int((st.knots.sample_to_time(m.sample) - st.start_time)
            / st.range_time * st.viewport.width)
    y = MENU_BAR_PX + int(
        (1.0 - (m.note - st.start_note + m.pitch_bend) / st.range_note)
        * lane_h)
    return x, y


# ----------------------------------------------------------------------
# The same gestures, the same state
# ----------------------------------------------------------------------


def test_gesture_sequence_equals_jax(song):
    """300 seeded events (pans, zooms, note-axis moves, clicks that add,
    select, drag and delete markers, scrubs, cursor keys, play and follow
    ticks, undo, redo): after each, both states are exactly equal."""
    j, t = _pair(song)
    try:
        rng = np.random.default_rng(19)
        W = t.viewport.width
        lane_h = t.viewport.lane_height
        assert _snap(j) == _snap(t)
        most = drags = 0
        for step in range(300):
            op = rng.random()
            x = float(rng.integers(5, W - 5))
            y = MENU_BAR_PX + float(lane_h * rng.uniform(0.05, 0.95))
            dx, dy = (float(v) for v in rng.integers(-12, 13, 2))
            if op < 0.12:
                calls = [("mouse_motion", (x, y, dx, dy, MIDDLE, 0))]
            elif op < 0.2:
                calls = [("mouse_motion", (x, y, dx, dy, MIDDLE, MOD_CTRL))]
            elif op < 0.28:
                calls = [("mouse_motion", (x, y, dx, dy, MIDDLE, MOD_ALT))]
            elif op < 0.42:
                if t.markers and rng.random() < 0.5:  # hit an existing marker
                    m = t.markers[int(rng.integers(len(t.markers)))]
                    x, y = _bent_xy(t, m)
                calls = [("mouse_button", (x, y, True, BUTTON_LEFT))]
            elif op < 0.55:
                calls = [("mouse_motion", (x, y, dx, dy, LEFT, 0))]
            elif op < 0.62:
                if t.markers and rng.random() < 0.5:
                    m = t.markers[int(rng.integers(len(t.markers)))]
                    x, y = _bent_xy(t, m)
                calls = [("mouse_button", (x, y, True, BUTTON_RIGHT))]
            elif op < 0.67:  # scrub in the waveform lane
                calls = [("mouse_button",
                          (x, MENU_BAR_PX + lane_h + 5, True, BUTTON_LEFT))]
            elif op < 0.74:
                calls = [("cursor_left" if rng.random() < 0.5
                          else "cursor_right", ())]
            elif op < 0.8:
                calls = [("toggle_play", ()), ("tick_follow", ())]
            elif op < 0.86:
                calls = [("tick_follow", ())]
            elif op < 0.93:
                calls = [("undo", ())]
            else:
                calls = [("redo", ())]
            for name, args in calls:
                getattr(j, name)(*args)
                getattr(t, name)(*args)
            assert _snap(t) == _snap(j), (step, calls)
            most = max(most, len(t.markers))
            drags += calls[0][0] == "mouse_motion" and t.selected is not None
        assert most >= 3 and drags >= 5, (most, drags)
    finally:
        _close(j, t)


# ----------------------------------------------------------------------
# The same scene
# ----------------------------------------------------------------------


def _edit(st):
    """A pan, a zoom and a marker added and dragged, as gestures."""
    st.range_time = 1.2
    st.start_time = 0.1
    st.mouse_motion(100, 60, -9, 0, MIDDLE)
    st.mouse_motion(100, 60, 0, -7, MIDDLE, MOD_CTRL)
    st.mouse_motion(100, 60, 4, 30, MIDDLE, MOD_ALT)
    st.mouse_button(120, MENU_BAR_PX + 50, True, BUTTON_LEFT)
    st.mouse_motion(125, MENU_BAR_PX + 44, 5, -6, LEFT)
    st.cursor_sec = 0.5


@pytest.mark.parametrize("source", ["reference", "pyramid"])
def test_scene_equals_jax(song, source):
    j, t = _pair(song, CFG_SCENE, tile_source=source)
    try:
        assert_scene_bars(render_scene(t, synchronous_tiles=True),
                          jview.render_scene(j, synchronous_tiles=True),
                          tview, t, LUT)
        _edit(j)
        _edit(t)
        assert _snap(j) == _snap(t)
        got = render_scene(t, synchronous_tiles=True)
        want = jview.render_scene(j, synchronous_tiles=True)
        bars = assert_scene_bars(got, want, tview, t, LUT)
        lane = got[MENU_BAR_PX: MENU_BAR_PX + int(t.viewport.lane_height)]
        assert lane.sum() > 0 and bars["lane_equal"] >= 0.999
    finally:
        _close(j, t)


def test_pitch_overlay_equals_jax(song):
    """One curve given to both: the overlay is drawn bit for bit alike."""
    j, t = _pair(song, CFG_SCENE)
    try:
        curve = mt.pitch_curve(t.wav, t.sample_rate, config=t.config,
                               device="cpu")
        assert curve.voiced.any()
        fields = dict(f0=curve.f0, voiced=curve.voiced, clarity=curve.clarity,
                      note=curve.note, hop=curve.hop,
                      sample_rate=curve.sample_rate)
        _edit(j)
        _edit(t)
        j.show_pitch = t.show_pitch = True
        j.pitch = JPitchCurve(**fields)
        t.pitch = PitchCurve(**fields)
        got = render_scene(t, synchronous_tiles=True)
        want = jview.render_scene(j, synchronous_tiles=True)
        orange = (got == (255, 160, 40)).all(axis=-1)
        assert orange.sum() > 50
        assert np.array_equal(orange, (want == (255, 160, 40)).all(axis=-1))
        assert_scene_bars(got, want, tview, t, LUT)
    finally:
        _close(j, t)


# ----------------------------------------------------------------------
# The port's own contracts (tests/test_ui.py's, on the port)
# ----------------------------------------------------------------------


def test_import_builds_derived_state(editor):
    assert editor.loaded and editor.device == torch.device("cpu")
    assert len(editor.grains) > 0
    assert editor.pyramid.n_levels > 0
    assert editor.knots is not None and editor.player is not None
    assert editor.save_name == ""


def test_follow_mode(editor):
    editor.is_playing = True
    editor.cursor_sec = editor.start_time + editor.range_time + 1.0
    editor.tick_follow()
    assert editor.follow_mode
    for _ in range(200):
        editor.tick_follow()
    assert editor.start_time == pytest.approx(
        editor.cursor_sec - editor.range_time / 5, abs=1e-6)


@pytest.mark.parametrize("name", ["proj", "session.melonix"])
def test_project_roundtrip(editor, tmp_path, name):
    editor.markers = [Marker(2000, 60.0, 0.1, 2.0),
                      Marker(5000, 62.0, -0.05, -1.5)]
    editor.brightness, editor.tempo = 70.0, 95.0
    editor.invalidate()
    out = editor.save_project_file(str(tmp_path / name))
    assert out.endswith((".mlx", ".melonix"))
    ed2 = EditorState(config=Config(**CFG), viewport=Viewport(200, 150),
                      device="cpu")
    try:
        ed2.open_file(out)
        assert ed2.loaded and len(ed2.grains) > 0
        assert [(m.sample, m.pitch_bend) for m in ed2.markers] == [
            (2000, 2.0), (5000, -1.5)]
        assert ed2.brightness == 70.0 and ed2.tempo == 95.0
        assert ed2.save_name == os.path.abspath(out)
        np.testing.assert_array_equal(ed2.wav, editor.wav)
    finally:
        _close(ed2)


def test_import_error_leaves_session_fully_usable(editor, tmp_path):
    editor.markers = [Marker(2000, 60.0, 0.1, 2.0)]
    editor.invalidate()
    editor.seek(0.5)
    editor.start_time = 0.25
    wav_before = editor.wav
    bad = str(tmp_path / "corrupt.wav")
    with open(bad, "wb") as f:
        f.write(b"not a riff at all" * 3)
    with pytest.raises(Exception):
        editor.open_file(bad)
    with pytest.raises(Exception):
        editor.open_file(str(tmp_path / "missing.melonix"))
    assert editor.loaded and editor.wav is wav_before
    assert len(editor.markers) == 1 and editor.cursor_sec == 0.5
    assert editor.start_time == 0.25
    out = str(tmp_path / "still_works.wav")
    editor.export_wav(out)
    assert os.path.getsize(out) > 1000


@pytest.mark.parametrize("engine", ["granular", "pv"])
def test_export_wav_is_the_render(editor, tmp_path, engine):
    """``export_wav`` writes the render of the session's engine, on the
    session's device, as int16 WAV."""
    editor.markers = [Marker(2000, 60.0, 0.0, 3.0)]
    editor.invalidate()
    editor.set_engine(engine)
    out = str(tmp_path / "out.wav")
    editor.export_wav(out)
    y, rate = read_wav(out)
    if engine == "pv":
        want = mt.render_track_pv(editor.wav, editor.knots,
                                  config=editor.config, device="cpu")
    else:
        want = mt.render_track(editor.wav, editor.grains, editor.knots,
                               config=editor.config, device="cpu")
    want16 = np.trunc(np.asarray(want, np.float64) * 32767.0).astype(np.int16)
    assert rate == editor.sample_rate and len(y) == len(want16)
    assert np.array_equal(np.round(y * 32768.0).astype(np.int16), want16)


def test_render_scene_smoke_and_png(editor, tmp_path):
    editor.markers = [Marker(2000, 50.0, 0.05, 3.0)]
    editor.invalidate()
    editor.selected = 0
    editor.cursor_sec = 0.4
    editor.range_time = 1.5
    img = render_scene(editor, synchronous_tiles=True)
    H, W = editor.viewport.height, editor.viewport.width
    assert img.shape == (H, W, 3)
    assert (img[int(H * 0.9):] == (255, 0, 255)).all(axis=-1).any()
    assert img[MENU_BAR_PX: int(H * 0.9)].sum() > 0
    p = str(tmp_path / "scene.png")
    tpng.write_png(p, img)
    with open(p, "rb") as f:
        assert np.array_equal(decode_png(f.read()), img)


def test_render_async_black_until_ready(song):
    """The tile worker fills the lane after the first, black frame: the
    lane repolls until every tile landed (bounded wait, no sleep-only
    waits), then equals a synchronous render."""
    st = EditorState(config=Config(**CFG_SCENE), viewport=Viewport(200, 150),
                     device="cpu")
    sync = EditorState(config=Config(**CFG_SCENE),
                       viewport=Viewport(200, 150), device="cpu")
    try:
        st.open_file(song)
        sync.open_file(song)
        lane = slice(MENU_BAR_PX, MENU_BAR_PX + int(st.viewport.lane_height))
        first = render_scene(st)
        assert first.shape == (150, 200, 3)
        assert not st.tile_server._synchronous
        deadline = time.monotonic() + 30.0
        while True:
            img = render_scene(st)
            tl = st.tile_server.stats()
            if (tl["pending"] == 0 and tl.get("inflight", 0) == 0
                    and img[lane].sum() > first[lane].sum()):
                img = render_scene(st)
                if np.array_equal(img, render_scene(sync,
                                                    synchronous_tiles=True)):
                    break
            assert time.monotonic() < deadline, tl
            time.sleep(0.01)
    finally:
        _close(st, sync)


def _tone(path, hz, seconds, sr=8000):
    t = np.arange(int(seconds * sr)) / sr
    write_wav(path, (0.5 * np.sin(2 * np.pi * hz * t)).astype(np.float32),
              sr, dtype="float32")


def test_pitch_overlay_draws_on_curve(tmp_path):
    """Off by default; on, orange rows at the tone's note (220 Hz = note
    48); a reopen recomputes the curve for the new samples."""
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    _tone(a, 220.0, 4)
    _tone(b, 330.0, 2)
    st = EditorState(viewport=Viewport(320, 240), device="cpu")
    try:
        st.open_file(a)
        base = render_scene(st, synchronous_tiles=True)
        st.set_show_pitch(True)
        assert st.pitch is not None
        over = render_scene(st, synchronous_tiles=True)
        orange = (over == (255, 160, 40)).all(axis=-1)
        assert orange.sum() > 100
        assert not (base == (255, 160, 40)).all(axis=-1).any()
        _, _, lane_h, spec_top, _, _ = tview._lane_geometry(st)
        rows, _ = np.where(orange)
        yf = 1.0 - (rows.mean() - spec_top) / (lane_h - 1)
        assert abs(st.start_note + yf * st.range_note - 48.0) < 2.0
        first = st.pitch
        st.open_file(b)
        assert st.show_pitch and st.pitch is not None and st.pitch is not first
        over = render_scene(st, synchronous_tiles=True)
        assert (over == (255, 160, 40)).all(axis=-1).sum() > 100
        st.set_show_pitch(False)
        off = render_scene(st, synchronous_tiles=True)
        assert not (off == (255, 160, 40)).all(axis=-1).any()
    finally:
        _close(st)


def test_undo_redo_gestures(editor):
    """Add, drag, delete are one gesture each; undo walks back, redo
    replays, a fresh edit clears redo, a select-only click keeps it."""
    lane_h = editor.viewport.lane_height
    assert not editor.undo()
    editor.mouse_button(100, MENU_BAR_PX + int(lane_h * 0.4), True,
                        BUTTON_LEFT)
    m = editor.markers[0]
    bx, by = _bent_xy(editor, m)
    editor.mouse_button(bx, by, True, BUTTON_LEFT)
    editor.mouse_motion(bx + 8, by - 6, 8, -6, LEFT)
    dragged = (editor.markers[0].d_time, editor.markers[0].pitch_bend)
    assert dragged[0] > 0 and dragged[1] > 0
    assert editor.undo()
    assert (editor.markers[0].d_time, editor.markers[0].pitch_bend) == (0, 0)
    assert editor.undo() and editor.markers == [] and not editor.undo()
    assert editor.redo() and editor.redo()
    assert (editor.markers[0].d_time, editor.markers[0].pitch_bend) == dragged
    assert not editor.redo()
    bx, by = _bent_xy(editor, editor.markers[0])
    editor.mouse_button(bx, by, True, BUTTON_RIGHT)
    assert editor.markers == [] and editor.undo()
    assert editor.undo()  # back to before the drag
    bx, by = _bent_xy(editor, editor.markers[0])
    editor.mouse_button(bx, by, True, BUTTON_LEFT)  # select only
    assert editor.redo()  # the redo branch survived the selection
    editor.mouse_button(30, MENU_BAR_PX + int(lane_h * 0.7), True,
                        BUTTON_LEFT)
    assert not editor.redo()  # a fresh edit orphans it
    editor._cleanup()
    assert editor._undo == [] and editor._redo == []


def test_incremental_pan_matches_full_render(song):
    ed = EditorState(config=Config(**CFG_SCENE), viewport=Viewport(200, 150),
                     device="cpu")
    ed.open_file(song)
    try:
        ed.markers = [Marker(2000, 50.0, 0.0, 2.0)]
        ed.invalidate()
        render_scene(ed, synchronous_tiles=True)
        W = ed.viewport.width
        calls = []
        orig = tview._tile_block
        tview._tile_block = lambda *a, **kw: calls.append(1) or orig(*a, **kw)
        try:
            for step in [3] * 5 + [-4] * 5:
                ed.start_time += step * ed.range_time / W
                inc = render_scene(ed, synchronous_tiles=True)
                assert not calls, "incremental path did not engage"
                ed._lane_memo = ed._wave_memo = None
                full = render_scene(ed, synchronous_tiles=True)
                assert np.array_equal(inc, full)
                calls.clear()
        finally:
            tview._tile_block = orig
    finally:
        _close(ed)


def test_waveform_pan_memo_exact_under_drift(editor):
    editor.markers = [Marker(2000, 50.0, 0.03, 2.0)]
    editor.invalidate()
    W = editor.viewport.width
    tview._waveform_cache(editor, W)
    for step in np.random.default_rng(7).integers(-9, 10, size=300):
        if step == 0:
            continue
        editor.start_time += float(step) * editor.range_time / W
        inc = tview._waveform_cache(editor, W)
        memo, editor._wave_memo = editor._wave_memo, None
        full = tview._waveform_cache(editor, W)
        assert np.array_equal(inc[0], full[0])
        assert np.array_equal(inc[1], full[1])
        editor._wave_memo = memo


def test_reopen_invalidates_lane_memo(tmp_path):
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    _tone(a, 220.0, 2)
    _tone(b, 2000.0, 2)
    st = EditorState(config=Config(**CFG), viewport=Viewport(200, 150),
                     device="cpu")
    st2 = EditorState(config=Config(**CFG), viewport=Viewport(200, 150),
                      device="cpu")
    try:
        st.open_file(a)
        render_scene(st, synchronous_tiles=True)
        render_scene(st, synchronous_tiles=True)
        st.open_file(b)
        got = render_scene(st, synchronous_tiles=True)
        st2.open_file(b)
        assert np.array_equal(got, render_scene(st2, synchronous_tiles=True))
    finally:
        _close(st, st2)


def test_lane_overlays_equal_jax_and_float_reference(editor):
    """The saturated-integer stripe and beat adds equal the JAX package's
    and the reference's float add -> clip -> truncate passes."""
    rng = np.random.default_rng(7)
    H, W = editor.viewport.height, editor.viewport.width
    lane_h = int(editor.viewport.lane_height)
    top = MENU_BAR_PX
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    ref = img.copy()
    i = np.arange(lane_h)
    note = ((i * editor.range_note + lane_h / 2.0) / lane_h
            + editor.start_note).astype(int)
    c = np.where(tview.BLACK_KEYS[note % 12], 128, 255).astype(np.float32)
    boundary = np.zeros(lane_h, bool)
    boundary[1:] = note[1:] != note[:-1]
    c[boundary] = 0.0
    lane = ref[top: top + lane_h].astype(np.float32) + 0.096 * c[::-1, None, None]
    ref[top: top + lane_h] = np.clip(lane, 0, 255).astype(np.uint8)
    beat = 60.0 / editor.tempo
    b = int(editor.start_time / beat)
    lane = ref[top: top + lane_h].astype(np.float32)
    while b * beat < editor.start_time + editor.range_time:
        px = int((b * beat - editor.start_time) * W / editor.range_time)
        if 0 <= px < W:
            lane[:, px] += (0.096 if b % 4 == 0 else 0.04) * 255.0
        b += 1
    ref[top: top + lane_h] = np.clip(lane, 0, 255).astype(np.uint8)
    tview._apply_piano(editor, img[top: top + lane_h], lane_h)
    tview._draw_lane_overlays(editor, img, top, lane_h)
    assert np.array_equal(img, ref)
    assert np.array_equal(tview._piano_row_add(editor, lane_h),
                          jview._piano_row_add(editor, lane_h))
    assert np.array_equal(tview._beat_col_add(editor, W),
                          jview._beat_col_add(editor, W))


# ----------------------------------------------------------------------
# Frame encoders
# ----------------------------------------------------------------------


def _raster():
    return np.random.default_rng(3).integers(0, 256, (37, 53, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("level", [1, 6])
def test_encode_png_equals_jax(level):
    img = _raster()
    got = tpng.encode_png(img, level=level)
    assert got == jpng.encode_png(img, level=level)
    assert np.array_equal(decode_png(got), img)


def test_encode_frame_with_and_without_pillow(monkeypatch):
    img = _raster()
    pytest.importorskip("PIL")
    body, mime = tpng.encode_frame(img)
    assert mime == "image/jpeg" and body[:2] == b"\xff\xd8"
    assert (body, mime) == jpng.encode_frame(img)
    monkeypatch.setattr(tpng, "_PILImage", None)
    body, mime = tpng.encode_frame(img)
    assert mime == "image/png" and body == tpng.encode_png(img, level=1)
    assert np.array_equal(decode_png(body), img)


def test_encode_png_refuses_other_rasters():
    with pytest.raises(ValueError):
        tpng.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        tpng.encode_png(np.zeros((4, 4, 3), np.float32))


# ----------------------------------------------------------------------
# No fallback, no JAX
# ----------------------------------------------------------------------


def test_default_device_raises_without_a_gpu(song, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = EditorState(config=Config(**CFG), viewport=Viewport(200, 150))
    assert st.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        st.open_file(song)
    assert not st.loaded and st.player is None and st._tile_server is None


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    root = pathlib.Path(mt.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert (root / "ui" / "web.py") in files and len(files) > 30
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "melonix_tpu"), (path, name)
