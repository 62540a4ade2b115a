"""A multichannel PV session's layout (``engine/session.py``,
``phase_vocoder.render_channels_pv``): the take goes up as it lies, each
channel renders against the one shared plan, and the render comes down as
(n_out, C) with no downmix and no host pass over the samples.  Every
render is held bit for bit to each channel through ``render_track_pv``
with the same knots, on the CPU device."""

import numpy as np
import pytest

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import phase_vocoder, session

SR = 8000
N = 2 * SR
MARKERS = [(int(0.4 * SR), 57.0, 0.01, 2.0),
           (int(1.1 * SR), 57.0, -0.01, -1.5),
           (int(1.6 * SR), 57.0, 0.0, 1.0)]


def take(channels: int) -> np.ndarray:
    """A C-contiguous (N, channels) float32 take, each channel its own."""
    t = np.arange(N) / SR
    cols = [(0.4 / (c + 1)) * np.sin(2 * np.pi * (220.0 + 55.0 * c) * t)
            + 0.1 * np.sin(2 * np.pi * 660.0 * t + c)
            for c in range(channels)]
    return np.stack(cols, axis=1).astype(np.float32)


def markers():
    return [mt.Marker(*m) for m in MARKERS]


def knots(n: int = N):
    return mt.MapKnots.from_markers(markers(), SR, n)


def each_channel(x: np.ndarray, **opts) -> np.ndarray:
    """The composition the session is held to: each channel of an (n, C)
    take through ``render_track_pv`` with the same knots, stacked on axis
    1."""
    k = knots(x.shape[0])
    return np.stack([mt.render_track_pv(np.ascontiguousarray(x[:, c]), k,
                                        device="cpu", **opts)
                     for c in range(x.shape[1])], axis=1)


def pv_session(x, **opts) -> np.ndarray:
    return session.render_session(x, markers(), SR, engine="pv", mesh=None,
                                  device="cpu", **opts)


OPTS = [{}, {"preserve_formants": True}, {"phase_locking": True},
        {"preserve_formants": True, "phase_locking": True}]
OPT_IDS = ["plain", "formants", "lock", "formants-lock"]


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_a_pv_session_is_each_channel_bit_for_bit(channels, opts):
    x = take(channels)
    got = pv_session(x, **opts)
    want = each_channel(x, **opts)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (int(knots().duration() * SR), channels)
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def strided(x):
    """The same samples as a column slice of a wider array: neither C- nor
    F-contiguous."""
    wide = np.zeros((x.shape[0], 2 * x.shape[1]), np.float32)
    wide[:, ::2] = x
    return wide[:, ::2]


@pytest.mark.parametrize("make", [
    lambda x: x[:, :1],                           # (n, 1)
    lambda x: np.ascontiguousarray(x.T).T,        # a transposed (C, n)
    strided,
    lambda x: x.astype(np.float64),
], ids=["one-channel", "transposed", "strided", "float64"])
def test_a_take_renders_as_its_contiguous_float32_copy(make):
    x = make(take(2))
    want = pv_session(np.ascontiguousarray(x, np.float32))
    got = pv_session(x)
    assert got.flags.c_contiguous and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_a_mono_take_renders_as_its_track():
    x = take(1)[:, 0]
    got = pv_session(x, preserve_formants=True)
    want = mt.render_track_pv(x, knots(), device="cpu",
                              preserve_formants=True)
    assert got.ndim == 1
    np.testing.assert_array_equal(got, want)


def test_only_the_granular_route_downmixes(monkeypatch):
    x = take(2)
    want = pv_session(x)
    called = []

    def downmix(a):
        called.append(a.shape)
        raise RuntimeError("downmix")

    monkeypatch.setattr(session, "downmix_mono", downmix)
    np.testing.assert_array_equal(pv_session(x), want)
    assert called == []
    with pytest.raises(RuntimeError, match="downmix"):
        session.render_session(x, markers(), SR, engine="granular",
                               mesh=None, device="cpu")
    assert called == [x.shape]


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_the_resample_stage_runs_once_a_channel(monkeypatch, channels):
    stage = phase_vocoder._resample_pv_fused
    seen = []

    def count(plan, y):
        seen.append(y.shape)
        return stage(plan, y)

    monkeypatch.setattr(phase_vocoder, "_resample_pv_fused", count)
    pv_session(take(channels), preserve_formants=True)
    assert len(seen) == channels


@pytest.mark.parametrize("layout", ["rows", "transposed", "strided"])
def test_render_channels_pv_keeps_each_channel_and_follows_the_layout(
        layout):
    x = take(3)
    ch = {"rows": np.ascontiguousarray(x.T), "transposed": x.T,
          "strided": strided(x).T}[layout]
    got = phase_vocoder.render_channels_pv(ch, knots(), device="cpu",
                                           preserve_formants=True)
    want = each_channel(x, preserve_formants=True)
    assert got.shape == (3, want.shape[0]) and got.dtype == np.float32
    for c in range(3):
        np.testing.assert_array_equal(got[c], want[:, c])
    # the transpose of an (n, C) take comes back as the transpose of an
    # (n_out, C) array; other layouts as (C, n_out)
    assert (got.T if layout == "transposed" else got).flags.c_contiguous
