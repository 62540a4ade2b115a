"""The port's browser shell and file dialogs against melonix_tpu's on the
CPU (``device="cpu"``), then the port's own HTTP contracts.

One HTTP script goes to a server of each package, step by step (port 0,
``autosave_interval=0``, ``MELONIX_AUTOSAVE_DIR`` under ``tmp_path``):
``/state`` must be equal but for ``fps``, ``tiles`` and ``metrics``, the
page, ``/markers.json`` and a saved ``.mlx`` byte-equal, a frame equal
outside the spectrogram lane, granular ``/audio.wav`` within one int16
step (the JAX package's CPU granular render is not oracle-exact), PV
``/audio.wav`` at the PV bars (``tests/test_torch_pv.py``), autotune's
markers at the autotune bars, unknown actions and keys 400.  Then, on the
port alone, tests/test_web.py's contracts: black-until-ready, the
delivered-sample cursor, live freshness after a mid-play edit on both
engines, the track-end autostop with the reference tail, the stop fade,
the autosave / recovery / failure-rearm cycle, the dialogs' HTTP flow and
fail-soft on a bad file.  Every connection has a timeout, every wait a
bound; streams read with ``pace=0`` where pacing is not what is tested.
"""

import http.client
import json
import os
import time

import numpy as np
import pytest
import torch

from melonix_tpu.config import Config as JConfig
from melonix_tpu.ui.dialogs import FileOpenDialog as JFileOpenDialog
from melonix_tpu.ui.dialogs import FileSaveAsDialog as JFileSaveAsDialog
from melonix_tpu.ui.state import EditorState as JEditorState
from melonix_tpu.ui.web import EditorServer as JEditorServer

from melonix_tpu_torch.config import Config
from melonix_tpu_torch.engine.player import FADE
from melonix_tpu_torch.io.melonix import load_melonix
from melonix_tpu_torch.io.wav import write_wav
from melonix_tpu_torch.markers import Marker, markers_from_json
from melonix_tpu_torch.ui.dialogs import FileOpenDialog, FileSaveAsDialog
from melonix_tpu_torch.ui.state import MENU_BAR_PX, EditorState
from melonix_tpu_torch.ui.web import EditorServer
from scene_bars import decode_png
from test_torch_autotune import _markers_equal
from test_torch_pv import _assert_pv_close

torch.set_num_threads(2)

CFG = dict(spectr_size=1024, max_ranges=64)
TIMEOUT = 30  # seconds, every connection's socket timeout


@pytest.fixture(autouse=True)
def autosave_dir(tmp_path, monkeypatch):
    d = tmp_path / "autosave"
    monkeypatch.setenv("MELONIX_AUTOSAVE_DIR", str(d))
    return d


def _server(cfg=CFG, **kw):
    st = EditorState(config=Config(**cfg), device="cpu")
    return EditorServer(state=st, autosave_interval=0, **kw)


class Client:
    def __init__(self, port):
        self.port = port
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=TIMEOUT)

    def get(self, path):
        self.conn.request("GET", path)
        r = self.conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type")

    def post(self, path, body):
        self.conn.request("POST", path, json.dumps(body))
        r = self.conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")

    def state(self):
        return json.loads(self.get("/state")[1])

    def stream(self, query):
        s = http.client.HTTPConnection("127.0.0.1", self.port,
                                       timeout=TIMEOUT)
        s.request("GET", "/audio/stream?" + query)
        r = s.getresponse()
        assert r.status == 200 and r.read(44)[:4] == b"RIFF"
        return s, r

    def close(self):
        self.conn.close()


@pytest.fixture()
def song(chirp, tmp_path):
    x, sr = chirp
    path = str(tmp_path / "song.wav")
    write_wav(path, x, sr, dtype="float32")
    return path


@pytest.fixture()
def served(song):
    srv = _server()
    cl = Client(srv.start())
    yield srv, cl, song
    cl.close()
    srv.stop()


def _pcm(body):
    assert body[:4] == b"RIFF"
    return np.frombuffer(body[44:], "<i2")


# ----------------------------------------------------------------------
# Dialog models
# ----------------------------------------------------------------------


def test_dialogs_equal_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    for name in (".hidden", "b.wav", "a.wav", "old.mlx", "sub/in.wav"):
        (tmp_path / name).write_text("x")
    pairs = [(FileOpenDialog(str(tmp_path)), JFileOpenDialog(str(tmp_path))),
             (FileSaveAsDialog(str(tmp_path)),
              JFileSaveAsDialog(str(tmp_path)))]
    for t, j in pairs:
        assert t.entries() == j.entries()
        assert t.entries()[:2] == [("..", True), ("sub", True)]
        assert t.accept() == j.accept()
        t.select("old.mlx")
        j.select("old.mlx")
        assert (t.selected, getattr(t, "filename", None)) == (
            j.selected, getattr(j, "filename", None))
        assert t.activate("sub") == j.activate("sub") is None
        assert t.cwd == j.cwd == str(tmp_path / "sub")
        assert t.activate("in.wav") == j.activate("in.wav") == str(
            tmp_path / "sub" / "in.wav")
        assert t.done and j.done
        t.activate("..")
        assert t.cwd == str(tmp_path)


# ----------------------------------------------------------------------
# One HTTP script, both servers
# ----------------------------------------------------------------------

VOLATILE = ("fps", "tiles", "metrics")


def test_http_script_equals_jax(song, tmp_path):
    j_srv = JEditorServer(state=JEditorState(config=JConfig(**CFG)),
                          autosave_interval=0)
    t_srv = _server()
    jc, tc = Client(j_srv.start()), Client(t_srv.start())
    lane_h = None

    def both(method, path, body=None):
        if method == "get":
            return jc.get(path), tc.get(path)
        return jc.post(path, body), tc.post(path, body)

    def same_state():
        js, ts = jc.state(), tc.state()
        for k in VOLATILE:
            js.pop(k), ts.pop(k)
        assert ts == js
        return ts

    try:
        (js, jb, jt), (ts, tb, tt) = both("get", "/")
        assert (ts, tb, tt) == (js, jb, jt) and b"melonix" in tb
        both("post", "/control", {"action": "open", "value": song})
        assert same_state()["loaded"]
        (_, jb, jt), (_, tb, tt) = both("get", "/frame.png?w=200&h=150")
        assert tt == jt == "image/png"
        jf, tf = decode_png(jb), decode_png(tb)
        lane_h = int(t_srv.state.viewport.lane_height)
        outside = np.ones(150, bool)
        outside[MENU_BAR_PX: MENU_BAR_PX + lane_h] = False
        assert np.array_equal(tf[outside], jf[outside])
        y = MENU_BAR_PX + int(lane_h * 0.4)
        script = [
            ("/event", {"kind": "button", "x": 100, "y": y, "pressed": True,
                        "button": 1}),
            ("/event", {"kind": "motion", "x": 105, "y": y - 4, "dx": 5,
                        "dy": -4, "buttons": 1}),
            ("/event", {"kind": "motion", "x": 90, "y": 60, "dx": -7,
                        "dy": 0, "buttons": 2}),
            ("/event", {"kind": "motion", "x": 90, "y": 60, "dx": 0,
                        "dy": -5, "buttons": 2, "mods": 1}),
            ("/event", {"kind": "motion", "x": 90, "y": 60, "dx": 3,
                        "dy": 20, "buttons": 2, "mods": 2}),
            ("/control", {"action": "marker_bend", "value": 3.0}),
            ("/control", {"action": "marker_dtime", "value": 0.05}),
            ("/event", {"kind": "button", "x": 150, "y": y + 20,
                        "pressed": True, "button": 1}),
            ("/key", {"key": "right"}), ("/key", {"key": "left"}),
            ("/key", {"key": "right"}), ("/key", {"key": "undo"}),
            ("/key", {"key": "redo"}), ("/control", {"action": "undo"}),
            ("/control", {"action": "redo"}),
            ("/control", {"action": "brightness", "value": 70}),
            ("/control", {"action": "tempo", "value": 999}),
            ("/control", {"action": "follow", "value": 1}),
            ("/control", {"action": "follow", "value": 0}),
            ("/event", {"kind": "button", "x": 150, "y": y + 20,
                        "pressed": True, "button": 3}),
        ]
        for path, body in script:
            (js, jbody), (ts, tbody) = both("post", path, body)
            assert ts == js == 200, (path, body, jbody, tbody)
            same_state()
        (_, jm, _), (_, tm, _) = both("get", "/markers.json")
        assert tm == jm and len(markers_from_json(tm.decode())) == 1

        # Audio: granular within one int16 step, then PV at the PV bars.
        (_, jw, jt), (_, tw, tt) = both("get", "/audio.wav")
        assert tt == jt == "audio/wav" and tw[:44] == jw[:44]
        gp, gj = _pcm(tw).astype(np.int32), _pcm(jw).astype(np.int32)
        assert len(gp) == len(gj) and np.abs(gp - gj).max() <= 1
        for action, value in (("engine", "pv"), ("formant", 1), ("lock", 1)):
            both("post", "/control", {"action": action, "value": value})
            same_state()
            (_, jw, _), (_, tw, _) = both("get", "/audio.wav")
            assert tw[:44] == jw[:44]
            _assert_pv_close(_pcm(tw) / 32768.0, _pcm(jw) / 32768.0)
        assert tc.state()["audio_renders"] == 4

        # A saved project, byte for byte (the same path, one after the
        # other, so both sessions keep the same save name).
        proj = str(tmp_path / "sess.mlx")
        saved = []
        for c, srv in ((jc, j_srv), (tc, t_srv)):
            srv._save_dlg.cwd = str(tmp_path)
            status, d = c.post("/dialog/accept",
                               {"mode": "save_as", "filename": "sess"})
            assert status == 200 and d == {"accepted": True, "path": proj}
            with open(proj, "rb") as f:
                saved.append(f.read())
        assert saved[1] == saved[0]
        same_state()

        # Unknown actions and keys: 400 on both, nothing changed.
        for path, body in (("/control", {"action": "egnine", "value": 1}),
                           ("/control", {"act": "engine"}),
                           ("/key", {"key": "spcae"}), ("/key", {"kye": 1})):
            (js, jbody), (ts, tbody) = both("post", path, body)
            assert ts == js == 400 and tbody == jbody
        same_state()

        # Autotune last: its markers come from two pitch analyses.
        both("post", "/control", {"action": "autotune",
                                  "value": {"strength": 1.0}})
        _markers_equal(t_srv.state.markers, j_srv.state.markers)
    finally:
        jc.close()
        tc.close()
        j_srv.stop()
        t_srv.stop()


# ----------------------------------------------------------------------
# The port's own contracts
# ----------------------------------------------------------------------


def test_frame_black_until_ready(song):
    """The first frame's lane waits for the tile worker; polling /state
    until nothing is pending or in flight, the lane fills (a cache that
    holds the viewport and its margins, as the default's 4000 does)."""
    srv = _server(dict(spectr_size=1024, max_ranges=1024))
    cl = Client(srv.start())
    try:
        cl.post("/control", {"action": "open", "value": song})
        q = "/frame.png?w=200&h=150"
        first = decode_png(cl.get(q)[1])
        lane = slice(MENU_BAR_PX,
                     MENU_BAR_PX + int(srv.state.viewport.lane_height))
        deadline = time.monotonic() + TIMEOUT
        while True:
            tl = cl.state()["tiles"]
            if tl["pending"] == 0 and tl.get("inflight", 0) == 0:
                frame = decode_png(cl.get(q)[1])
                if frame[lane].sum() > first[lane].sum():
                    break
            assert time.monotonic() < deadline, tl
            time.sleep(0.01)
        assert cl.get("/frame.png?fmt=jpg&w=200&h=150")[2] in (
            "image/jpeg", "image/png")
    finally:
        cl.close()
        srv.stop()


def test_playback_cursor_tracks_delivered_samples(served):
    srv, cl, wav = served
    cl.post("/control", {"action": "open", "value": wav})
    sr = srv.state.sample_rate
    s, resp = cl.stream("from=0")
    try:
        delivered = len(resp.read(2 * int(0.5 * sr))) // 2
        st = cl.state()
        assert st["playing"] and st["live_streams"] == 1
        slack = (4 * 4096 + 65536 // 2) / sr
        assert delivered / sr - 1e-6 <= st["cursor"] <= delivered / sr + slack
        cl.post("/key", {"key": "space"})
        resp.read()
        assert not cl.state()["playing"]
    finally:
        s.close()


def _freq(raw, sr):
    x = np.frombuffer(raw, "<i2").astype(np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return float(np.argmax(spec) * sr / len(x))


@pytest.mark.parametrize("engine", ["granular", "pv"])
def test_live_stream_edit_freshness_mid_play(tmp_path, engine):
    """An octave-up edit while the paced stream plays is heard within a
    bounded span of served audio, and stays."""
    sr = 8000
    t = np.arange(8 * sr) / sr
    p = str(tmp_path / "tone.wav")
    write_wav(p, (0.5 * np.sin(2 * np.pi * 200.0 * t)).astype(np.float32),
              sr, dtype="float32")
    srv = _server()
    cl = Client(srv.start())
    s = None
    try:
        cl.post("/control", {"action": "open", "value": p})
        cl.post("/control", {"action": "engine", "value": engine})
        assert srv.state.player.engine == engine
        s, resp = cl.stream("from=0")
        pre = resp.read(2 * int(0.8 * sr))
        assert _freq(pre[2 * 1600:], sr) == pytest.approx(200.0, abs=8)
        with srv._lock:
            srv.state.markers = [
                Marker(sample=sr // 2, note=55.0, d_time=0.0, pitch_bend=12.0),
                Marker(sample=15 * sr // 2, note=55.0, d_time=0.0,
                       pitch_bend=12.0)]
            srv.state.invalidate()
        win = sr // 4
        for i in range(16):  # at most 4 s of served audio after the edit
            if _freq(resp.read(2 * win), sr) == pytest.approx(400.0, abs=16):
                break
        else:
            pytest.fail("edit never became audible")
        assert i * 0.25 <= 3.0
        assert _freq(resp.read(2 * sr), sr) == pytest.approx(400.0, abs=16)
        st = cl.state()
        assert st["playing"] and st["engine"] == engine
        assert 0.0 < st["cursor"] <= 8.0
    finally:
        if s is not None:
            s.close()
        cl.close()
        srv.stop()


def test_track_end_autostop_with_reference_tail(tmp_path):
    from melonix_tpu_torch.config import DEFAULT_CONFIG

    sr = 8000
    x = (0.4 * np.sin(2 * np.pi * 330.0 * np.arange(sr) / sr)).astype(
        np.float32)
    p = str(tmp_path / "short.wav")
    write_wav(p, x, sr, dtype="float32")
    srv = _server()
    cl = Client(srv.start())
    s = None
    try:
        cl.post("/control", {"action": "open", "value": p})
        s, resp = cl.stream(f"from={1.0 - 0.3}&pace=0")
        pcm = np.frombuffer(resp.read(), "<i2").astype(np.float64) / 32768.0
        pgs = DEFAULT_CONFIG.preferred_grain_size
        nz = np.nonzero(pcm)[0]
        assert len(nz) > 0
        assert int(nz[-1]) + 1 >= 0.3 * sr - 2 * pgs
        assert len(pcm) - 1 - int(nz[-1]) >= pgs  # the reference's zero tail
        assert not cl.state()["playing"]
        # The whole track unpaced: all of it, then the auto-stop.
        s.close()
        s, resp = cl.stream("from=0&pace=0")
        assert len(resp.read()) >= 2 * len(x) - 2 * 4096
        assert not cl.state()["playing"]
    finally:
        if s is not None:
            s.close()
        cl.close()
        srv.stop()


def test_stop_fade_shape_in_served_bytes(tmp_path):
    sr = 8000
    t = np.arange(6 * sr) / sr
    p = str(tmp_path / "tone.wav")
    write_wav(p, (0.5 * np.sin(2 * np.pi * 200.0 * t)).astype(np.float32),
              sr, dtype="float32")
    srv = _server()
    cl = Client(srv.start())
    s = None
    try:
        cl.post("/control", {"action": "open", "value": p})
        s, resp = cl.stream("from=0")
        body = resp.read(2 * int(0.5 * sr))
        cl.post("/key", {"key": "space"})
        body += resp.read()
        pcm = np.frombuffer(body, "<i2").astype(np.float64) / 32768.0
        assert len(pcm) % 1024 == 0
        fade, silence = pcm[-1024:][:FADE], pcm[-1024:][FADE:]
        np.testing.assert_array_equal(silence, 0.0)
        want = pcm[-1025] * np.linspace(1.0, 0.0, FADE, endpoint=False)
        np.testing.assert_allclose(fade, want, atol=2.5 / 32768.0)
        assert abs(pcm[-1025]) > 10.0 / 32768.0
        assert not cl.state()["playing"]
    finally:
        if s is not None:
            s.close()
        cl.close()
        srv.stop()


def _add_bent_marker(cl, srv, bend):
    lane_h = srv.state.viewport.lane_height
    cl.post("/event", {"kind": "button", "x": 100,
                       "y": MENU_BAR_PX + int(lane_h * 0.4), "pressed": True,
                       "button": 1})
    cl.post("/control", {"action": "marker_bend", "value": bend})


def test_autosave_recovery_cycle(served, autosave_dir):
    """Snapshots of unsaved edits; a fresh open of the source offers them;
    recover, save and discard resolve the offer; autosave pauses while an
    offer stands; a quit with unsaved edits leaves a snapshot."""
    srv, cl, wav = served
    cl.post("/control", {"action": "open", "value": wav})
    assert srv.autosave_now() is None
    assert not srv._state_json()["autosave_available"]
    _add_bent_marker(cl, srv, 3.0)
    p = srv.autosave_now()
    assert p and os.path.exists(p) and p.startswith(str(autosave_dir))
    assert srv.autosave_now() is None

    srv2 = _server()
    srv2.state.open_file(wav)
    assert srv2._state_json()["autosave_available"]
    srv2.state.open_file(wav)  # a pristine reopen is no edit
    assert srv2._state_json()["autosave_available"]
    assert srv2.autosave_now() is None
    srv2.state.push_history()
    srv2.state.markers.append(Marker(100, 50.0, 0.0, 1.0))
    srv2.state.invalidate()
    assert srv2.autosave_now() is None  # paused while offered
    srv2._control("recover", None)
    assert [m.pitch_bend for m in srv2.state.markers] == [3.0]
    assert srv2.state.save_name == ""
    assert srv2.state.source_path == os.path.abspath(wav)
    assert not srv2._state_json()["autosave_available"]
    assert srv2.autosave_now() == p  # recovered is not saved

    srv2.state.save_name = str(autosave_dir.parent / "saved.mlx")
    srv2._control("save", None)
    assert not os.path.exists(p)
    srv3 = _server()
    srv3.state.open_file(wav)
    assert not srv3._state_json()["autosave_available"]
    srv3.state.markers.append(Marker(100, 50.0, 0.0, 2.0))
    srv3.state.invalidate()
    srv3.stop()  # a quit snapshots the unsaved edit
    srv4 = _server()
    srv4.state.open_file(wav)
    assert srv4._state_json()["autosave_available"]
    srv4._control("discard_autosave", None)
    assert not os.path.exists(p)
    assert not srv4._state_json()["autosave_available"]
    for s in (srv2, srv4):
        s.stop()


def test_autosave_failure_rearms(served, tmp_path, monkeypatch):
    srv, cl, wav = served
    blocked = tmp_path / "blocked"
    blocked.write_text("not a dir")
    monkeypatch.setenv("MELONIX_AUTOSAVE_DIR", str(blocked))
    cl.post("/control", {"action": "open", "value": wav})
    _add_bent_marker(cl, srv, 2.0)
    assert srv.autosave_now() is None
    assert srv._edits_pending
    monkeypatch.setenv("MELONIX_AUTOSAVE_DIR", str(tmp_path / "ok"))
    assert srv.autosave_now() is not None


def test_dialog_http_flow(served, tmp_path):
    srv, cl, wav = served
    srv._open_dlg.cwd = os.path.dirname(wav)
    status, body, _ = cl.get("/dialog/list?mode=open")
    d = json.loads(body)
    assert status == 200 and ["song.wav", False] in d["entries"]
    status, d = cl.post("/dialog/activate", {"mode": "open",
                                             "name": "song.wav"})
    assert d["accepted"] and srv.state.loaded
    srv._save_dlg.cwd = str(tmp_path)
    for name, suffix in (("sess", "sess.mlx"), ("sess.melonix",
                                                "sess.melonix")):
        status, d = cl.post("/dialog/accept", {"mode": "save_as",
                                               "filename": name})
        assert d["accepted"] and d["path"].endswith(suffix)
        assert os.path.exists(d["path"])
    assert load_melonix(d["path"]).sample_rate == srv.state.sample_rate
    srv._export_dlg.cwd = str(tmp_path)
    for name, suffix in (("out", "out.wav"), ("mix.flac", "mix.flac")):
        status, d = cl.post("/dialog/accept", {"mode": "export",
                                               "filename": name})
        assert d["accepted"] and d["path"].endswith(suffix)
        assert os.path.getsize(d["path"]) > 1000


def test_fail_soft_bad_file(served, tmp_path):
    srv, cl, wav = served
    cl.post("/control", {"action": "open", "value": wav})
    st0 = cl.state()
    bad = str(tmp_path / "garbage.wav")
    with open(bad, "wb") as f:
        f.write(b"this is not a RIFF file at all........")
    for path in (bad, str(tmp_path / "nope.wav")):
        status, body = cl.post("/control", {"action": "open", "value": path})
        assert status == 500 and "error" in body
        st1 = cl.state()
        assert st1["loaded"] and st1["duration"] == st0["duration"]


def test_no_device_gives_500_and_keeps_serving(song, monkeypatch):
    """A server on the default device opens nothing without a card: the
    open fails as any bad open does (500), and the server keeps serving."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = EditorServer(autosave_interval=0)
    assert srv.state.device == torch.device("cuda")
    cl = Client(srv.start())
    try:
        status, body = cl.post("/control", {"action": "open", "value": song})
        assert status == 500 and "is_available" in body["error"]
        assert not cl.state()["loaded"]
        assert cl.get("/frame.png?w=64&h=48")[0] == 200
    finally:
        cl.close()
        srv.stop()
