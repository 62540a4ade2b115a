"""melonix_tpu_torch's tensor map twins against melonix_tpu's jnp twins.

``pad_knots``, ``sample_to_time_torch``, ``time_to_sample_torch`` and
``time_to_pitch_bend_torch`` on the CPU, for each of ``tests/test_maps.py``'s
marker sets, held against ``pad_knots`` and the ``_jax`` twins of
``melonix_tpu/engine/maps.py`` and against the float64 host maps
(``MapKnots``) at ``test_maps.py``'s bars; float64 tensors against
``MapKnots`` at 1e-9; padding buckets that change no value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.engine import maps as J
from melonix_tpu.markers import Marker as JMarker
from test_maps import MARKER_SETS, N, SR

from melonix_tpu_torch.engine import maps as M
from melonix_tpu_torch.markers import Marker

VALS_S = np.array([-10, 0, 5, 22050, 44100, 100000, N - 1, N + 100],
                  np.float64)
VALS_T = np.linspace(-0.5, 12.0, 301)


def _knots(markers):
    tup = [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]
    return (J.MapKnots.from_markers([JMarker(*t) for t in tup], SR, N),
            M.MapKnots.from_markers([Marker(*t) for t in tup], SR, N))


@pytest.mark.parametrize("bucket", [8, 128])
@pytest.mark.parametrize("markers", MARKER_SETS)
def test_pad_knots_matches_jax(markers, bucket):
    jk, pk = _knots(markers)
    got = M.pad_knots(pk, bucket=bucket, device="cpu")
    want = J.pad_knots(jk, bucket=bucket)
    n = len(pk.samples)
    for g, w, a in zip(got, want, (pk.samples, pk.times, pk.bends)):
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        assert g.shape == w.shape and g.shape[0] % bucket == 0
        np.testing.assert_array_equal(g[:n].numpy(), a)
        assert bool((g[n:] == g[n - 1]).all())  # the last knot, repeated
        # JAX holds the knots in float32 (x64 off)
        np.testing.assert_array_equal(g.numpy().astype(np.float32),
                                      np.asarray(w))


@pytest.mark.parametrize("markers", MARKER_SETS)
def test_twins_match_jax_twins_and_host(markers):
    """test_maps.py:86-100, for the port's twins beside JAX's."""
    jk, pk = _knots(markers)
    ks, ts, bends = M.pad_knots(pk, bucket=8, device="cpu")
    jks, jts, jbends = J.pad_knots(jk, bucket=8)

    got = M.sample_to_time_torch(ks, ts, SR, torch.from_numpy(VALS_S)).numpy()
    jax_ = np.asarray(J.sample_to_time_jax(jks, jts, SR, jnp.asarray(VALS_S)))
    for want in (pk.sample_to_time(VALS_S), jax_):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    got = M.time_to_sample_torch(ks, ts, SR, torch.from_numpy(VALS_T)).numpy()
    jax_ = np.asarray(J.time_to_sample_jax(jks, jts, SR, jnp.asarray(VALS_T)))
    for want in (pk.time_to_sample(VALS_T).astype(np.float64), jax_):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1.5)

    got = M.time_to_pitch_bend_torch(ts, bends, pk.duration(),
                                     torch.from_numpy(VALS_T)).numpy()
    jax_ = np.asarray(J.time_to_pitch_bend_jax(jts, jbends, jk.duration(),
                                               jnp.asarray(VALS_T)))
    for want in (pk.time_to_pitch_bend(VALS_T), jax_):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("markers", MARKER_SETS)
def test_float64_twins_match_host_maps(markers):
    """In float64 the twins are the host maps' arithmetic: 1e-9 (the pitch
    bend after the host's float32 rounding)."""
    _jk, pk = _knots(markers)
    ks, ts, bends = M.pad_knots(pk, bucket=128, device="cpu")
    s = np.concatenate([VALS_S, np.arange(-5, 20), [22049, 22051, 88199]])
    t = np.concatenate([VALS_T, np.linspace(-0.5, 12.0, 997), [0.0, 1e-9]])
    np.testing.assert_allclose(
        M.sample_to_time_torch(ks, ts, SR, s).numpy(), pk.sample_to_time(s),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        M.time_to_sample_torch(ks, ts, SR, t).numpy(),
        pk.time_to_sample_float(t), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(
        np.trunc(M.time_to_sample_torch(ks, ts, SR, t).numpy()).astype(
            np.int64), pk.time_to_sample(t))
    np.testing.assert_allclose(
        M.time_to_pitch_bend_torch(ts, bends, pk.duration(), t).numpy()
        .astype(np.float32), pk.time_to_pitch_bend(t), rtol=0, atol=1e-9)


@pytest.mark.parametrize("markers", MARKER_SETS)
def test_bucket_changes_no_value(markers):
    _jk, pk = _knots(markers)
    q = torch.from_numpy(VALS_T.reshape(7, 43))  # any shape
    outs = []
    for bucket in (8, 128):
        ks, ts, bends = M.pad_knots(pk, bucket=bucket, device="cpu")
        outs.append((M.sample_to_time_torch(ks, ts, SR, q * SR),
                     M.time_to_sample_torch(ks, ts, SR, q),
                     M.time_to_pitch_bend_torch(ts, bends, pk.duration(), q)))
    for a, b in zip(*outs):
        assert a.shape == q.shape
        assert torch.equal(a, b)


def test_twins_run_where_their_inputs_are():
    """Knots and queries in float32 stay float32; a scalar query gives a
    0-d tensor; the default device is the card, with no fallback."""
    _jk, pk = _knots(MARKER_SETS[3])
    ks, ts, bends = (a.float() for a in M.pad_knots(pk, device="cpu"))
    out = M.time_to_sample_torch(ks, ts, SR, torch.tensor(0.75))
    assert out.dtype == torch.float32 and out.dim() == 0
    assert abs(float(out) - pk.time_to_sample_float(0.75)) < 0.5
    assert M.sample_to_time_torch(ks, ts, SR, 22050.0).dtype == torch.float32


def test_pad_knots_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jk, pk = _knots(MARKER_SETS[1])
    with pytest.raises(RuntimeError, match="is_available"):
        M.pad_knots(pk)
