"""melonix_tpu_torch's session warm-up (``runtime/warmup.py``) and the
editor's open hook, on the CPU.

Ports ``tests/test_compile_cache.py:54-75`` (the warm-up runs the real
paths; the async form joins); a render after the warm-up is bit-equal to
one before it; a failing path raises from ``warmup_session`` and from the
async thread's ``join``; a CPU ``EditorState`` starts no warm-up, while
one on a (stubbed) card starts the kernel build before the decode and the
warm-up once, after its tile server.
"""

import os

import numpy as np
import pytest
import torch

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import render as trender
from melonix_tpu_torch.runtime import warmup
from melonix_tpu_torch.ui import state as tstate

SR = 8000


def _tone(n, sr=SR):
    return (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(n) / sr)).astype(
        np.float32)


def test_exported_from_the_package():
    assert mt.warmup_session is warmup.warmup_session
    assert mt.warmup_session_async is warmup.warmup_session_async
    assert {"warmup_session", "warmup_session_async"} <= set(mt.__all__)


def test_warmup_session_runs_the_real_paths():
    """test_compile_cache.py:54-67 on the CPU."""
    warmup.warmup_session(4096, SR, engines=("granular",), columns=True,
                          device="cpu")
    x = _tone(4096)
    out = mt.render_track(x, mt.build_grain_table(x),
                          mt.MapKnots.from_markers([], SR, 4096),
                          device="cpu")
    assert np.all(np.isfinite(np.asarray(out)))


def test_warmup_async_joins():
    """test_compile_cache.py:70-73 on the CPU."""
    t = warmup.warmup_session_async(2048, SR, engines=(), columns=True,
                                    device="cpu")
    t.join(timeout=120)
    assert not t.is_alive() and t.error is None
    assert t.daemon and t.name == "melonix-warmup"


def test_renders_after_the_warmup_are_bit_equal():
    n = 2 * SR
    x = _tone(n)
    knots = mt.MapKnots.from_markers(
        [mt.Marker(n // 3, 57.0, 0.05, 2.0), mt.Marker(2 * n // 3, 60.0,
                                                       -0.02, -3.0)], SR, n)
    table = mt.build_grain_table(x)

    def renders():
        stream = mt.PvStream(x, knots, start_sec=0.4, device="cpu")
        return (mt.render_track(x, table, knots, device="cpu"),
                mt.render_track_pv(x, knots, device="cpu"),
                stream.read(4096),
                mt.spectrogram_columns(x, [0, 5000], [1024, 9000],
                                       device="cpu"),
                mt.pitch_curve(x, SR, device="cpu").f0)

    before = renders()
    warmup.warmup_session(n, SR, pitch=True, device="cpu")
    after = renders()
    for a, b in zip(before, after):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_failing_path_raises(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(trender, "render_track", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        warmup.warmup_session(2048, SR, device="cpu")
    t = warmup.warmup_session_async(2048, SR, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        t.join(timeout=120)
    assert not t.is_alive() and isinstance(t.error, RuntimeError)
    assert "launch failed" in capsys.readouterr().err


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        warmup.warmup_session(2048, SR)


@pytest.fixture
def wav_path(tmp_path):
    path = os.path.join(tmp_path, "tone.wav")
    mt.write_wav(path, _tone(SR), SR, dtype="float32")
    return path


@pytest.fixture
def calls(monkeypatch):
    """Records the warm-up's entry points instead of running them."""
    log = []
    monkeypatch.setattr(warmup, "build_async", lambda: log.append("build"))

    def fake_async(n, rate, **kw):
        log.append(("warmup", n, rate, kw))
        return "thread"

    monkeypatch.setattr(warmup, "warmup_session_async", fake_async)
    return log


def test_cpu_state_starts_no_warmup(wav_path, calls):
    st = tstate.EditorState(device="cpu")
    st.open_file(wav_path)
    assert st.loaded and calls == [] and st.warmup is None


def test_card_state_warms_up_after_its_tile_server(wav_path, calls,
                                                   monkeypatch):
    """The open hook on a card, with the device users stubbed: the kernel
    build starts before the decode, the warm-up once after the tile
    server exists, on the state's device; every open warms again."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    real_pyramid, real_load = tstate.build_pyramid, tstate.load_audio
    monkeypatch.setattr(tstate, "build_pyramid",
                        lambda wav, device=None: real_pyramid(wav,
                                                              device="cpu"))

    def load_audio(path):
        calls.append("decode")
        return real_load(path)

    monkeypatch.setattr(tstate, "load_audio", load_audio)

    class Stub:
        def __init__(self, *a, **k):
            calls.append(type(self).__name__)

        def __getattr__(self, name):
            return lambda *a, **k: None

    class TileServer(Stub):
        pass

    class Player(Stub):
        pass

    monkeypatch.setattr("melonix_tpu_torch.runtime.tiles.TileServer",
                        TileServer)
    monkeypatch.setattr("melonix_tpu_torch.engine.player.Player", Player)
    st = tstate.EditorState()
    st.open_file(wav_path)
    warm = ("warmup", SR, SR, {"device": torch.device("cuda")})
    assert calls == ["build", "decode", "Player", "TileServer", warm]
    assert st.warmup == "thread"
    st.open_file(wav_path)
    assert calls[5:] == ["build", "decode", "Player", "TileServer", warm]
    calls.clear()
    off = tstate.EditorState(warm_up=False)
    off.open_file(wav_path)
    assert calls == ["decode", "Player", "TileServer"] and off.warmup is None
