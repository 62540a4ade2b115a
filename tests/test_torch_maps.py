"""melonix_tpu_torch's tensor map twins against melonix_tpu's jnp twins.

``pad_knots``, ``sample_to_time_torch``, ``time_to_sample_torch`` and
``time_to_pitch_bend_torch`` on the CPU, for each of ``tests/test_maps.py``'s
marker sets, held against ``pad_knots`` and the ``_jax`` twins of
``melonix_tpu/engine/maps.py`` and against the float64 host maps
(``MapKnots``) at ``test_maps.py``'s bars; float64 tensors against
``MapKnots`` at 1e-9; padding buckets that change no value.  The host
maps' segment lookup (a sorted search where the knot axis never decreases)
against the JAX package's first-match masks, bit for bit, on both paths.
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


# ----------------------------------------------------------------------
# The host maps' segment lookup against the JAX package's host maps, which
# keep the first-match masks: the same results, bit for bit and dtype.
# ----------------------------------------------------------------------


def _lookup_sets():
    rng = np.random.default_rng(2500)
    gap = N / 14  # the edit cell's form: benchmark/harness/inputs.py
    cell = [(int((i + 1) * gap + rng.uniform(-0.25, 0.25) * gap), 57.0,
             float(rng.uniform(0.005, 0.02) * (1 if i % 2 == 0 else -1)),
             float(rng.uniform(1, 4) * (-1) ** i)) for i in range(12)]
    many = [(int(s), 57.0, float(rng.uniform(0.0, 0.01)),
             float(rng.uniform(-4, 4)))
            for s in np.sort(rng.choice(np.arange(500, N - 500), 300,
                                        replace=False))]
    # name: (markers, times never decrease, samples never decrease)
    return {
        "none": ([], True, True),
        "one": ([(N // 2, 57.0, 0.03, 3.0)], True, True),
        "cell": (cell, True, True),
        "three_hundred": (many, True, True),
        "backward": ([(SR, 60.0, -1.5, 4.0), (2 * SR, 62.0, 0.1, -4.0)],
                     False, True),
        "duplicate_samples": ([(N // 4, 57.0, 0.01, 2.0),
                               (N // 4, 60.0, 0.02, -3.0),
                               (N // 2, 62.0, 0.0, 1.0)], True, True),
        "negative_sample": ([(-2000, 57.0, 0.01, 2.0),
                             (N // 2, 60.0, 0.02, -3.0)], False, False),
        # times 0.5, 0.5 exactly: an empty time segment
        "zero_length": ([(SR // 2, 57.0, 0.0, 2.0), (SR, 60.0, -0.5, -3.0),
                         (2 * SR, 62.0, 0.01, 1.0)], True, True),
    }


LOOKUP_SETS = _lookup_sets()


def _lookup_queries(which, axis, end, rng):
    """Queries of one kind on a knot ``axis`` whose map ends at ``end``."""
    if which == "random":
        return rng.uniform(-0.05 * end, 1.1 * end, 1001)
    if which == "knots":
        return np.concatenate([axis, np.nextafter(axis, -np.inf),
                               np.nextafter(axis, np.inf)])
    if which == "nonpositive":
        return np.array([0.0, -0.0, -1e-12, -1.0, -end])
    if which == "beyond":
        return np.array([end, np.nextafter(end, np.inf), end + 1.0, 2 * end])
    return float(rng.uniform(0, end))  # a scalar


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("queries",
                         ["random", "knots", "nonpositive", "beyond", "scalar"])
@pytest.mark.parametrize("which", sorted(LOOKUP_SETS))
def test_host_maps_equal_the_first_match_masks(which, queries):
    markers, times_up, samples_up = LOOKUP_SETS[which]
    jk, pk = _knots([Marker(*m) for m in markers])
    assert pk._samples_ascending == samples_up
    rng = np.random.default_rng(len(which) * 7 + len(queries))
    dur = pk.duration()
    _same(dur, jk.duration())

    t = _lookup_queries(queries, pk.times, dur, rng)
    _same(pk.time_to_sample_float(t), jk.time_to_sample_float(t))
    _same(pk.time_to_sample(t), jk.time_to_sample(t))
    _same(pk.time_to_pitch_bend(t), jk.time_to_pitch_bend(t))
    a, b, sorted_ = pk.time_to_sample_float_and_bend(t)
    assert sorted_ is times_up
    _same(a, jk.time_to_sample_float(np.atleast_1d(t)))
    _same(b, jk.time_to_pitch_bend(np.atleast_1d(t)))

    s = _lookup_queries(queries, pk.samples, float(N), rng)
    _same(pk.sample_to_time(s), jk.sample_to_time(s))
