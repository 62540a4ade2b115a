"""melonix_tpu_torch's granular export (CPU, plain twins) against melonix_tpu
on the CPU and the reference transcription ``tests/oracle.py``.

Host half (grain tables, render plans, block maps) must equal the JAX
package's exactly.  The render is held to ``oracle.export`` exactly: the
port rounds every float32 operation on its own, as the oracle does, while
JAX's CPU render contracts the lerp into FMAs and sits within 2e-6 of it
(the JAX suite's bar, used where the port is compared with JAX).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from melonix_tpu.engine import grains as jgrains
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.render import build_render_plan as j_build_render_plan
from melonix_tpu.engine.render import render as j_render
from melonix_tpu.engine.render import render_track as j_render_track
from melonix_tpu.engine.session import render_session as j_render_session
from melonix_tpu.kernels import pallas_render
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import grains as tgrains
from melonix_tpu_torch.engine import render as trender
from melonix_tpu_torch.kernels import render as krender
from melonix_tpu_torch.runtime import native

torch.set_num_threads(2)

# tests/test_render.py MARKER_CASES, as (sample, note, d_time, bend) tuples
MARKER_CASES = [
    [],
    [(4000, 60.0, 0.0, 2.0)],  # pitch up 2 semitones at 0.5 s
    [(4000, 60.0, 0.3, -3.0)],  # slow down + pitch down
    [(2000, 60.0, 0.1, 1.0), (8000, 62.0, -0.05, -1.0)],
    [(3000, 60.0, 0.0, 12.0)],  # octave up
]


def _knots(markers, sr, n):
    return (JMapKnots.from_markers([JMarker(*m) for m in markers], sr, n),
            mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], sr, n))


def _noisy_song(seed=3, sr=8000, seconds=2.0):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    x = (0.5 * np.sin(2 * np.pi * 150 * t) + 0.2 * np.sin(2 * np.pi * 331 * t)
         + 0.05 * rng.standard_normal(len(t)))
    return x.astype(np.float32)


def _plan_fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


def _assert_plans_equal(got, want) -> None:
    g, w = _plan_fields(got), _plan_fields(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


# ----------------------------------------------------------------------
# Host half: grains, native runtime, plans
# ----------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "native", "torch", "auto"])
def test_grain_table_equals_jax_and_oracle(chirp, backend):
    x, _sr = chirp
    for sig in (x, _noisy_song()):
        got = mt.build_grain_table(sig, backend=backend)
        want = jgrains.build_grain_table(sig, backend="numpy")
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert got.starts.dtype == got.lengths.dtype == np.int32
        pairs = list(zip(got.starts.tolist(), got.lengths.tolist()))
        assert pairs == oracle.build_grains(sig, 1500)


@pytest.mark.parametrize("look", [3, 7])
def test_zero_crossing_mask_torch_matches_np_and_jax(look):
    x = (np.random.default_rng(9).standard_normal(3000) * 0.3).astype(np.float32)
    got = tgrains.zero_crossing_mask_torch(torch.from_numpy(x), look).numpy()
    np.testing.assert_array_equal(got, tgrains.zero_crossing_mask_np(x, look))
    np.testing.assert_array_equal(
        got, np.asarray(jgrains.zero_crossing_mask_jax(jnp.asarray(x), look)))


def test_auto_backend_builds_and_takes_the_native_runtime(chirp):
    """backend='auto' builds native/melonix_native.cpp into build/native/
    (never the library `make -C native` leaves beside the source) and
    counts its calls."""
    x, sr = chirp
    lib = native.try_load()
    assert lib is not None  # this machine has a C++ compiler
    assert lib._name == str(native.BUILD_DIR / native.LIB_NAME)
    stamp = native.BUILD_DIR / (native.LIB_NAME + ".sha256")
    assert stamp.read_text() == native.source_hash()
    g0, p0 = native.build_grains.calls, native.build_plan.calls
    table = mt.build_grain_table(x)
    mt.build_render_plan(table, _knots([], sr, len(x))[1])
    assert (native.build_grains.calls, native.build_plan.calls) == (g0 + 1,
                                                                    p0 + 1)
    mt.build_grain_table(x, backend="numpy")
    mt.build_render_plan(table, _knots([], sr, len(x))[1], backend="numpy")
    assert (native.build_grains.calls, native.build_plan.calls) == (g0 + 1,
                                                                    p0 + 1)


def test_auto_backend_without_a_compiler_takes_numpy(chirp, monkeypatch):
    x, sr = chirp
    monkeypatch.setattr(native, "compiler", lambda: None)
    native.try_load.cache_clear()
    try:
        calls = native.build_grains.calls, native.build_plan.calls
        table = mt.build_grain_table(x)
        plan = mt.build_render_plan(table, _knots([], sr, len(x))[1])
        assert (native.build_grains.calls, native.build_plan.calls) == calls
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
            mt.build_grain_table(x, backend="native")
    finally:
        native.try_load.cache_clear()
    np.testing.assert_array_equal(
        table.starts, jgrains.build_grain_table(x, backend="numpy").starts)
    assert plan.n_steps > 0


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("case", range(len(MARKER_CASES)))
def test_build_render_plan_equals_jax(chirp, backend, case):
    x, sr = chirp
    jk, pk = _knots(MARKER_CASES[case], sr, len(x))
    jt = jgrains.build_grain_table(x, backend="numpy")
    pt = mt.build_grain_table(x, backend="numpy")
    for kw in ({}, {"min_out": 4000}, {"start_cursor": 0.5, "min_out": 2000}):
        got = mt.build_render_plan(pt, pk, backend=backend, **kw)
        want = j_build_render_plan(jt, jk, backend="numpy", **kw)
        _assert_plans_equal(got, want)


def test_compact_blocks_equal_jax():
    rng = np.random.default_rng(4)
    sizes = rng.integers(0, 3000, 200)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    nb = -(-(int(offsets[-1]) + 4096) // krender.CBLK)
    got = krender.compact_blocks(offsets, nb)
    want = pallas_render.compact_blocks(offsets, nb)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


# ----------------------------------------------------------------------
# B5 / B6 twins against the TPU kernels (interpret mode); on the card both
# run as one kernel (tests/test_torch_render_granular.py)
# ----------------------------------------------------------------------


def _b5_case(name):
    """(wav, plan) at the default bucket (chirp, one marker) or at the
    +-24-semitone buckets (test_pallas.py:218-257)."""
    sr = 8000
    if name == "default":
        t = np.arange(int(sr * 0.6)) / sr
        x = (0.6 * np.sin(2 * np.pi * 190.0 * t)
             + 0.02 * np.sin(2 * np.pi * 41.0 * t)).astype(np.float32)
        markers = [(len(x) // 2, 57.0, 0.03, 4.0)]
    else:
        t = np.arange(int(sr * 0.5)) / sr
        x = (0.5 * np.sin(2 * np.pi * 210.0 * t)).astype(np.float32)
        n, bend = len(x), float(name)
        markers = [(n // 8, 57.0, 0.0, bend), (7 * n // 8, 57.0, 0.0, bend)]
    _jk, pk = _knots(markers, sr, len(x))
    plan = mt.build_render_plan(mt.build_grain_table(x), pk)
    return x, plan


@pytest.mark.parametrize("name", ["default", "24", "-24"])
def test_render_steps_plain_matches_tpu_kernel(name):
    x, plan = _b5_case(name)
    gmax, szmax = krender._buckets(plan)
    assert (gmax, szmax) == pallas_render._buckets(plan)
    gs = plan.grain_start.astype(np.int32)
    sz = plan.sz.astype(np.int32)
    got = krender.render_steps_plain(torch.from_numpy(x), torch.from_numpy(gs),
                                     torch.from_numpy(plan.rate),
                                     torch.from_numpy(sz), szmax).numpy()
    # the TPU kernel's padded 128-lane layout (granular_render_pallas)
    g_rows = gmax // 128 + 2
    total = 128 * -(-(len(x) + gmax + g_rows * 128) // 128)
    wavp = np.zeros(total, np.float32)
    wavp[: len(x)] = x
    want = np.asarray(pallas_render._render_steps(
        jnp.asarray(wavp.reshape(-1, 128)), jnp.asarray(gs),
        jnp.asarray(plan.rate), jnp.asarray(sz), gmax, szmax, interpret=True,
    )).reshape(plan.n_steps, szmax)
    assert got.shape == want.shape
    # the JAX suite's bar (test_pallas.py:213-216): backends may contract
    # the lerp into an FMA; indices and masking must agree exactly
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert np.mean(got == want) > 0.8
    assert not got[:, int(plan.sz.max()):].any()


def test_compact_plain_matches_tpu_kernel_and_fori():
    """Irregular ascending offsets with duplicates and a zero-length step
    (test_pallas.py:662-691): bit-exact against both JAX forms."""
    rng = np.random.default_rng(1234)
    szmax, n_steps = 512, 37
    sizes = rng.integers(1, szmax, n_steps)
    sizes[5] = 0  # zero-length step: next step overwrites at same offset
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out_len = int(offsets[-1]) + szmax
    vals = rng.standard_normal((n_steps, szmax)).astype(np.float32)
    nb = -(-out_len // krender.CBLK)
    a0, cnt, kmax = krender.compact_blocks(offsets, nb)
    got = krender.compact_plain(torch.from_numpy(vals),
                                torch.from_numpy(offsets.astype(np.int32)),
                                out_len).numpy()
    fori = np.asarray(pallas_render._compact(
        jnp.asarray(vals), jnp.asarray(offsets, jnp.int32), out_len, szmax))
    kpow = max(1, 1 << (kmax - 1).bit_length())
    tpu = np.asarray(pallas_render.compact_pallas(
        jnp.asarray(vals), jnp.asarray(offsets, jnp.int32), jnp.asarray(a0),
        jnp.asarray(cnt), out_len, szmax, kpow, interpret=True))
    np.testing.assert_array_equal(got, fori)
    np.testing.assert_array_equal(got, tpu)


def test_render_wrappers_refuse_other_devices():
    """B5 and B6 run on the card as one kernel (render_granular): its wrapper
    refuses a ``meta`` tensor, as does the whole render, without a launch."""
    meta = torch.empty(4096, device="meta")
    i32 = torch.empty(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        krender.render_granular(meta, i32, torch.empty(3, device="meta"), i32,
                                i32, i32[:2], i32[:2], 4096, 1024)
    with pytest.raises(ValueError, match="no kernel"):
        krender.render_full(meta, np.zeros(3, np.int32),
                            np.ones(3, np.float32), np.ones(3, np.int32),
                            np.arange(3), 2048, np.zeros(0, np.int64),
                            np.zeros(0, np.float32), 1024)
    assert krender.render_granular.launches == 0


# ----------------------------------------------------------------------
# The whole render
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(MARKER_CASES)))
def test_render_track_equals_oracle(chirp, case):
    x, sr = chirp
    markers = MARKER_CASES[case]
    jk, pk = _knots(markers, sr, len(x))
    table = mt.build_grain_table(x)
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    want = oracle.export(x, grains, markers, sr)
    got = mt.render_track(x, table, pk, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    jt = jgrains.build_grain_table(x, backend="numpy")
    np.testing.assert_allclose(got, np.asarray(j_render_track(x, jt, jk)),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("case", [1, 3])
def test_render_device_equals_the_twin_pair(chirp, case):
    """The plain two-gather ``render_device`` and the B5 + B6 twin -> fixes
    give the same track, bit for bit."""
    x, sr = chirp
    _jk, pk = _knots(MARKER_CASES[case], sr, len(x))
    plan = mt.build_render_plan(mt.build_grain_table(x), pk)
    total = plan.total_out
    args = trender.render_device_args(plan, x, total)
    t = [torch.from_numpy(np.asarray(a)) for a in args]
    got = trender.render_device(torch.from_numpy(x), t[0], t[1], t[2],
                                int(args[3]), total, t[5], t[6]).numpy()
    np.testing.assert_array_equal(got, trender.render(x, plan, device="cpu"))


def test_export_no_grains():
    """Empty grain table: the first process() call emits 1500 zeros."""
    x = np.zeros(3000, np.float32)
    table = mt.build_grain_table(x)
    assert len(table) == 0
    knots = mt.MapKnots.from_markers([], 8000, len(x))
    launches = krender.render_granular.launches
    out = mt.render_track(x, table, knots, device="cpu")
    assert out.shape == (1500,) and not out.any()
    assert krender.render_granular.launches == launches


def test_streaming_plan_renders_the_full_prefix(chirp):
    """A min_out plan rendered without its tail is an exact prefix of the
    full render; a plan from a mid-track cursor matches JAX's render."""
    x, sr = chirp
    jk, pk = _knots(MARKER_CASES[1], sr, len(x))
    table = mt.build_grain_table(x)
    full = mt.build_render_plan(table, pk)
    part = mt.build_render_plan(table, pk, min_out=4000)
    out_full = trender.render(x, full, device="cpu")
    out_part = trender.render(x, part, include_tail=False, device="cpu")
    assert len(out_part) == part.total_out >= 4000
    np.testing.assert_array_equal(out_part, out_full[: len(out_part)])
    mid = mt.build_render_plan(table, pk, start_cursor=0.5, min_out=2000)
    jmid = j_build_render_plan(jgrains.build_grain_table(x), jk,
                                     start_cursor=0.5, min_out=2000)
    np.testing.assert_allclose(
        trender.render(x, mid, include_tail=False, device="cpu"),
        np.asarray(j_render(x, jmid, include_tail=False)), atol=2e-6)


def test_render_track_device_out_keeps_the_tensor(chirp):
    x, sr = chirp
    _jk, pk = _knots(MARKER_CASES[2], sr, len(x))
    table = mt.build_grain_table(x)
    out = mt.render_track(torch.from_numpy(x), table, pk, device_out=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(),
                                  mt.render_track(x, table, pk, device="cpu"))
    with pytest.raises(ValueError):
        mt.render_track(torch.from_numpy(x), table, pk, device="meta")


# ----------------------------------------------------------------------
# Sessions
# ----------------------------------------------------------------------


def _assert_pv_close(got, want):
    """The JAX suite's PV convention (test_pallas.py:473-523): equal length,
    rms < 5e-3 of the peak, spectral-envelope error < 2e-2."""
    assert len(got) == len(want)
    scale = float(np.abs(want).max())
    assert float(np.sqrt(np.mean((got - want) ** 2))) < 5e-3 * scale
    nseg = len(want) // 2048
    f_g = np.abs(np.fft.rfft(got[: nseg * 2048].reshape(nseg, 2048), axis=1))
    f_w = np.abs(np.fft.rfft(want[: nseg * 2048].reshape(nseg, 2048), axis=1))
    assert np.abs(f_g - f_w).max() / f_w.max() < 2e-2


def _stereo(chirp):
    x, _sr = chirp
    noise = np.random.default_rng(11).standard_normal(len(x)) * 0.01
    return np.stack([x, (0.8 * x + noise).astype(np.float32)], axis=1)


def test_stereo_session_matches_jax(chirp):
    _x, sr = chirp
    st = _stereo(chirp)
    markers = MARKER_CASES[3]
    got = mt.render_session(st, [mt.Marker(*m) for m in markers], sr,
                            device="cpu")
    want = j_render_session(st, [JMarker(*m) for m in markers], sr, mesh=None)
    assert got.shape == want.shape and got.shape[1] == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # one shared plan from the downmix: each channel equals the oracle on
    # that channel with the downmix's grains
    mono = st.mean(axis=1).astype(np.float32)
    table = mt.build_grain_table(mono)
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    for c in range(2):
        np.testing.assert_array_equal(
            got[:, c], oracle.export(np.ascontiguousarray(st[:, c]), grains,
                                     markers, sr))


def test_mono_sessions_match_render_track(chirp):
    x, sr = chirp
    markers = [mt.Marker(*m) for m in MARKER_CASES[2]]
    _jk, pk = _knots(MARKER_CASES[2], sr, len(x))
    got = mt.render_session(x, markers, sr, device="cpu", mesh=None)
    np.testing.assert_array_equal(
        got, mt.render_track(x, mt.build_grain_table(x), pk, device="cpu"))
    pv = mt.render_session(x, markers, sr, engine="pv", device="cpu")
    np.testing.assert_array_equal(pv, mt.render_track_pv(x, pk, device="cpu"))


@pytest.mark.parametrize("kw,item", [
    ({"engine": "granular"}, "item 15"),
])
def test_unported_session_options_raise(chirp, kw, item):
    """(Named, with its case, for the behaviour it replaced: the mesh option
    raised, naming ROADMAP queue A ``item``.)  The option is ported: an
    explicit world-1 mesh renders a mono session exactly as ``mesh=None``
    does."""
    x, sr = chirp
    markers = [mt.Marker(*m) for m in MARKER_CASES[2]]
    mesh = mt.make_audio_mesh(device="cpu")
    got = mt.render_session(x, markers, sr, device="cpu", mesh=mesh, **kw)
    want = mt.render_session(x, markers, sr, device="cpu", mesh=None, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lock", [False, True])
def test_ported_session_options_stereo_pv_matches_jax(chirp, lock):
    """A stereo phase-vocoder session (once unported): (n, 2) out, each
    channel against JAX's by the PV convention and equal to its own mono
    render through the shared plan."""
    _x, sr = chirp
    st = _stereo(chirp)
    markers = MARKER_CASES[3]
    got = mt.render_session(st, [mt.Marker(*m) for m in markers], sr,
                            engine="pv", phase_locking=lock, device="cpu")
    want = j_render_session(st, [JMarker(*m) for m in markers], sr,
                            engine="pv", phase_locking=lock, mesh=None)
    assert got.shape == want.shape and got.shape[1] == 2
    _jk, pk = _knots(markers, sr, len(st))
    for c in range(2):
        _assert_pv_close(got[:, c], want[:, c])
        np.testing.assert_array_equal(
            got[:, c], mt.render_track_pv(np.ascontiguousarray(st[:, c]), pk,
                                          phase_locking=lock, device="cpu"))
