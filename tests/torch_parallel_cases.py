"""The sharded paths of melonix_tpu_torch and of melonix_tpu, run on one
set of inputs, and the bars that hold one against the other.

``port_results(mesh, x, sr)`` runs every function of the port's
``parallel`` package (and the sessions and batch renders that route through
it) on a ``make_audio_mesh`` mesh and returns NumPy arrays by name; it
imports only the port, so the multi-rank workers of
``test_torch_distributed.py`` run it in processes without JAX.
``jax_results(data, seq, x, sr)`` runs the JAX package's counterparts on a
mesh of the same shape over the virtual CPU devices; ``check(name, got,
want)`` applies the bar of ``tests/test_parallel.py`` that belongs to the
result's kind.
"""

from __future__ import annotations

import contextlib

import numpy as np

STFT_SIZE, STFT_HOP = 256, 64
COL_SIZE = 1024
PITCH_FRAME, PITCH_HOP = 1024, 256


def _pv_markers(n):
    """test_parallel.py:_pv_setup's two edits (track x, then x reversed)."""
    return ([(n // 2, 57.0, 0.05, 2.0)],
            [(n // 3, 57.0, 0.0, -3.0), (2 * n // 3, 57.0, 0.02, 1.0)])


GRANULAR_SETS = ([], [(4000, 60.0, 0.0, 2.0)], [(2000, 60.0, 0.1, -1.0)],
                 [(6000, 60.0, -0.05, 5.0)])
SEQ_RENDER_SETS = ([], [(4000, 60.0, 0.05, 2.0)],
                   [(2000, 60.0, 0.1, -1.0), (6000, 60.0, -0.02, 5.0)])
BATCH_SETS = ([(4000, 60.0, 0.02, 2.0)], [],
              [(2000, 60.0, 0.0, -3.0), (6000, 60.0, 0.05, 1.0)])
SESSION_MARKERS = [(3000, 57.0, 0.03, 2.0), (8000, 57.0, -0.02, -1.5)]


def case_names(data: int) -> list[str]:
    """The names ``port_results`` and ``jax_results`` return on a mesh with
    ``data`` data ranks (fixed per shape, so tests can be parametrised)."""
    names = ["seq_pv/0", "seq_pv/1", "seq_pv_lock/0", "seq_pv_formant/0",
             "dp_pv/0", "dp_pv/1", "dp_render/0", "stft/0", "columns/0",
             "pitch_lag/0", "pitch_clarity/0", "pitch_energy/0",
             "step_mags/0", "step_render/0", "full_mags/0", "full_render/0",
             "batch_formant/0", "batch_formant/1"]
    names += [f"seq_render/{i}" for i in range(len(SEQ_RENDER_SETS))]
    names += [f"full_pv/{b}" for b in range(data)]
    names += [f"batch_{e}/{i}" for e in ("granular", "pv")
              for i in range(len(BATCH_SETS))]
    names += [f"session_{c}_{e}/0" for c in ("mono", "stereo")
              for e in ("granular", "pv")]
    return names


def _batch_tracks(x):
    return [x, x[: len(x) * 2 // 3].copy(), x[::-1].copy()]


def _stereo(x):
    noise = np.random.default_rng(11).standard_normal(len(x)) * 0.01
    return np.stack([x, (0.8 * x + noise).astype(np.float32)], axis=1)


def _granular_sets(d):
    sets = list(GRANULAR_SETS[: max(d, 2)])
    while len(sets) % d:
        sets.append([])
    return sets


def _trim(x, n_seq, hop):
    q = n_seq * hop
    return x[: len(x) // q * q]


class _Api:
    """The names one package exposes to the cases below."""

    def __init__(self, mk, pv_plan, grains, render_plan, hann, par, batch,
                 session, to_np, mesh):
        self.Marker, self.MapKnots = mk
        self.build_pv_plan = pv_plan
        self.build_grain_table = grains
        self.build_render_plan = render_plan
        self.hann = hann
        self.par = par
        self.render_batch = batch
        self.render_session = session
        self.np = to_np
        self.mesh = mesh

    def knots(self, markers, sr, n):
        return self.MapKnots.from_markers([self.Marker(*m) for m in markers],
                                          sr, n)


def _results(a: _Api, d: int, n_seq: int, x, sr) -> dict:
    par, mesh, out = a.par, a.mesh, {}
    n = len(x)

    # -- seq-parallel PV: plain (two tracks), formant, locked -------------
    tracks = [x, x[::-1].copy()]
    pv_plans = []
    for i, (w, ms) in enumerate(zip(tracks, _pv_markers(n))):
        p = a.build_pv_plan(a.knots(ms, sr, n), n)
        pv_plans.append(p)
        for tag, extra in (("", {}), ("_lock", {"lock": True})):
            if tag and i:
                continue
            kw, ops = par.seq_pv_args(p, n_seq)
            f = par.seq_parallel_pv(mesh, **kw, **extra)
            out[f"seq_pv{tag}/{i}"] = a.np(
                f(w, *ops[:4], a.hann(kw["size"]), *ops[4:]))[: p.n_out]
    pf = a.build_pv_plan(a.knots([(n // 2, 57.0, 0.0, 5.0)], sr, n), n)
    kw, ops = par.seq_pv_args(pf, n_seq)
    f = par.seq_parallel_pv(mesh, **kw, formant=True)
    out["seq_pv_formant/0"] = a.np(
        f(x, *ops[:4], a.hann(kw["size"]), *ops[4:]))[: pf.n_out]

    # -- data-parallel PV ------------------------------------------------
    rows = list(range(2))
    while len(rows) % d:
        rows.append(0)
    kw, ops = par.pv_batch_args([pv_plans[r] for r in rows])
    f = par.data_parallel_pv(mesh, **kw)
    res = a.np(f(np.stack([tracks[r] for r in rows]), *ops[:4],
                 a.hann(kw["size"]), *ops[4:]))
    for i in range(2):
        out[f"dp_pv/{i}"] = res[i, : pv_plans[i].n_out]

    # -- data-parallel and seq-parallel granular renders ----------------
    table = a.build_grain_table(x, backend="numpy")
    plans = [a.build_render_plan(table, a.knots(ms, sr, n))
             for ms in _granular_sets(d)]
    gs, gl, rt, oo, ss, nv, out_max = par.granular_batch_args(plans)
    out_len = 1024 * -(-out_max // 1024)
    out["dp_render/0"] = a.np(par.data_parallel_render(
        np.tile(x, (len(plans), 1)), gs, gl, rt, oo, ss, nv, mesh, out_len))
    table = a.build_grain_table(x)
    for i, ms in enumerate(SEQ_RENDER_SETS):
        plan = a.build_render_plan(table, a.knots(ms, sr, n))
        blk = n_seq * 1024
        out_len = blk * -(-int(plan.out_offset[-1]) // blk)
        sargs = par.seq_render_args(plan, x, out_len, n_seq)
        out[f"seq_render/{i}"] = a.np(par.seq_parallel_render(
            mesh, x, *sargs[:6], sargs[6], out_len, sargs[7], sargs[8]))

    # -- sharded analyses --------------------------------------------------
    xs = _trim(x, n_seq, STFT_HOP)
    out["stft/0"] = a.np(par.sharded_stft_mags(
        xs, a.hann(STFT_SIZE), mesh, size=STFT_SIZE, hop=STFT_HOP))
    starts = np.arange(0, 8 * n_seq, dtype=np.int32) * 100
    out["columns/0"] = a.np(par.sharded_spectrogram_columns(
        x, starts, starts + 900, mesh, size=COL_SIZE))
    xp = _trim(x, n_seq, PITCH_HOP)
    lag_min, lag_max = max(2, int(sr / 1760.0)), min(PITCH_FRAME - 2,
                                                     int(sr / 55.0))
    for name, v in zip(("lag", "clarity", "energy"), par.sharded_pitch(
            xp, mesh, frame=PITCH_FRAME, hop=PITCH_HOP, lag_min=lag_min,
            lag_max=lag_max)):
        out[f"pitch_{name}/0"] = a.np(v)

    # -- session steps ---------------------------------------------------
    sets = [[] for _ in range(d)]
    plans = [a.build_render_plan(a.build_grain_table(xs, backend="numpy"),
                                 a.knots(ms, sr, len(xs))) for ms in sets]
    gs, gl, rt, oo, ss, nv, out_max = par.granular_batch_args(plans)
    out_len = 1024 * -(-out_max // 1024)
    wav_b = np.tile(xs, (d, 1))
    step = par.session_step(mesh, stft_size=STFT_SIZE, stft_hop=STFT_HOP)
    mags, rendered = step(wav_b, a.hann(STFT_SIZE), gs, gl, rt, oo, ss, nv,
                          out_len)
    out["step_mags/0"], out["step_render/0"] = a.np(mags), a.np(rendered)
    sets = [[(len(xs) // 2, 60.0, 0.0, float(1 + b))] for b in range(d)]
    plans = [a.build_render_plan(a.build_grain_table(xs, backend="numpy"),
                                 a.knots(ms, sr, len(xs))) for ms in sets]
    gs, gl, rt, oo, ss, nv, out_max = par.granular_batch_args(plans)
    out_len = 1024 * -(-out_max // 1024)
    pvp = [a.build_pv_plan(a.knots(ms, sr, len(xs)), len(xs)) for ms in sets]
    pv_kw, pv_ops = par.pv_batch_args(pvp)
    step = par.session_step_full(
        mesh, stft_size=STFT_SIZE, stft_hop=STFT_HOP, pv_size=pv_kw["size"],
        pv_hop=pv_kw["hop"], pv_frames=pv_kw["n_frames"],
        pv_stretch_len=pv_kw["stretch_len"], pv_out_pad=pv_kw["n_out_pad"],
        sr=pv_kw["sr"])
    mags, rendered, pv_out = step(wav_b, a.hann(STFT_SIZE), gs, gl, rt, oo,
                                  ss, nv, out_len, a.hann(pv_kw["size"]),
                                  *pv_ops)
    out["full_mags/0"], out["full_render/0"] = a.np(mags), a.np(rendered)
    pv_out = a.np(pv_out)
    for b, p in enumerate(pvp):
        out[f"full_pv/{b}"] = pv_out[b, : p.n_out]

    # -- render_batch and render_session through the mesh ----------------
    bt = _batch_tracks(x)
    bm = [[a.Marker(*m) for m in ms] for ms in BATCH_SETS]
    for engine in ("granular", "pv"):
        for i, o in enumerate(a.render_batch(bt, bm, sr, engine=engine,
                                             mesh=mesh)):
            out[f"batch_{engine}/{i}"] = o
    fm = [[a.Marker(n // 2, 57.0, 0.0, 5.0)], [a.Marker(n // 3, 57.0, 0.0,
                                                        -4.0)]]
    for i, o in enumerate(a.render_batch([x, x[::-1].copy()], fm, sr,
                                         engine="pv", preserve_formants=True,
                                         mesh=mesh)):
        out[f"batch_formant/{i}"] = o
    sm = [a.Marker(*m) for m in SESSION_MARKERS]
    for engine in ("granular", "pv"):
        out[f"session_mono_{engine}/0"] = a.render_session(
            x, sm, sr, engine=engine, mesh=mesh)
        out[f"session_stereo_{engine}/0"] = a.render_session(
            _stereo(x), sm, sr, engine=engine, mesh=mesh)
    return {k: np.asarray(v) for k, v in out.items()}


def port_results(mesh, x, sr) -> dict:
    """Every case through melonix_tpu_torch on ``mesh`` (its device)."""
    import melonix_tpu_torch as mt
    from melonix_tpu_torch import parallel
    from melonix_tpu_torch.engine.phase_vocoder import build_pv_plan
    from melonix_tpu_torch.engine.spectral import hann_window

    def batch(*args, **kw):
        return mt.render_batch(*args, device=mesh.device, **kw)

    def session(*args, **kw):
        return mt.render_session(*args, device=mesh.device, **kw)

    api = _Api((mt.Marker, mt.MapKnots), build_pv_plan, mt.build_grain_table,
               mt.build_render_plan, hann_window, parallel, batch, session,
               lambda t: t.cpu().numpy() if hasattr(t, "cpu") else
               np.asarray(t), mesh)
    return _results(api, mesh.shape["data"], mesh.shape["seq"], x, sr)


def jax_results(data: int, seq: int, x, sr) -> dict:
    """Every case through melonix_tpu on a (data, seq) mesh of the virtual
    CPU devices."""
    from melonix_tpu.parallel import sharded

    mesh = sharded.make_audio_mesh(data * seq, data=data)
    assert (mesh.shape["data"], mesh.shape["seq"]) == (data, seq)
    with _jitted_granular():
        return _jax_results(mesh, data, seq, x, sr)


@contextlib.contextmanager
def _jitted_granular():
    """The JAX package's two granular shard_maps under ``jax.jit`` for the
    span of a reference run (its sessions and batch renders call them
    unjitted, and eager shard_map costs seconds a call on the CPU); the
    same functions, restored on exit."""
    import jax

    from melonix_tpu import parallel
    from melonix_tpu.parallel import sharded

    saved = (sharded.data_parallel_render, sharded.seq_parallel_render)
    dpr = jax.jit(saved[0], static_argnums=(7, 8))
    spr = jax.jit(saved[1], static_argnums=(0, 9))
    sharded.data_parallel_render = parallel.data_parallel_render = dpr
    sharded.seq_parallel_render = parallel.seq_parallel_render = spr
    try:
        yield
    finally:
        sharded.data_parallel_render = parallel.data_parallel_render = saved[0]
        sharded.seq_parallel_render = parallel.seq_parallel_render = saved[1]


def _jax_results(mesh, data, seq, x, sr) -> dict:
    import jax
    import jax.numpy as jnp

    from melonix_tpu.engine.batch import render_batch
    from melonix_tpu.engine.grains import build_grain_table
    from melonix_tpu.engine.maps import MapKnots
    from melonix_tpu.engine.phase_vocoder import build_pv_plan
    from melonix_tpu.engine.render import build_render_plan
    from melonix_tpu.engine.session import render_session
    from melonix_tpu.engine.spectral import hann_window
    from melonix_tpu.markers import Marker
    from melonix_tpu.parallel import sharded

    class Par:
        """JAX's sharded functions with host (NumPy) operands."""

        seq_pv_args = staticmethod(sharded.seq_pv_args)
        pv_batch_args = staticmethod(sharded.pv_batch_args)
        granular_batch_args = staticmethod(sharded.granular_batch_args)
        seq_render_args = staticmethod(sharded.seq_render_args)

        @staticmethod
        def _jit(fn):
            return lambda *ops: fn(*[jnp.asarray(o) for o in ops])

        def seq_parallel_pv(self, m, **kw):
            return self._jit(sharded.seq_parallel_pv(m, **kw))

        def data_parallel_pv(self, m, **kw):
            return self._jit(sharded.data_parallel_pv(m, **kw))

        @staticmethod
        def data_parallel_render(*ops):
            *arrays, m, out_len = ops
            return sharded.data_parallel_render(
                *[jnp.asarray(o) for o in arrays], m, out_len)

        @staticmethod
        def seq_parallel_render(m, wav, *ops):
            a = [jnp.asarray(o) for o in ops[:6]]
            return sharded.seq_parallel_render(
                m, jnp.asarray(wav), *a, ops[6], ops[7],
                jnp.asarray(ops[8]), jnp.asarray(ops[9]))

        @staticmethod
        def sharded_stft_mags(wav, win, m, **kw):
            return jax.jit(lambda w, v: sharded.sharded_stft_mags(
                w, v, m, **kw))(jnp.asarray(wav), jnp.asarray(win))

        @staticmethod
        def sharded_spectrogram_columns(wav, s, e, m, **kw):
            return jax.jit(lambda w, a, b: sharded.sharded_spectrogram_columns(
                w, a, b, m, **kw))(jnp.asarray(wav), jnp.asarray(s),
                                   jnp.asarray(e))

        @staticmethod
        def sharded_pitch(wav, m, **kw):
            return jax.jit(lambda w: sharded.sharded_pitch(w, m, **kw))(
                jnp.asarray(wav))

        @staticmethod
        def session_step(m, **kw):
            step = sharded.session_step(m, **kw)
            return lambda *ops: step(*[jnp.asarray(o) for o in ops[:-1]],
                                     ops[-1])

        @staticmethod
        def session_step_full(m, **kw):
            step = sharded.session_step_full(m, **kw)

            def run(*ops):
                a = [jnp.asarray(o) for o in ops]
                return step(*a[:8], ops[8], *a[9:])
            return run

    api = _Api((Marker, MapKnots), build_pv_plan, build_grain_table,
               build_render_plan, hann_window, Par(), render_batch,
               render_session, np.asarray, mesh)
    return _results(api, data, seq, x, sr)


# ----------------------------------------------------------------------
# Bars (tests/test_parallel.py)
# ----------------------------------------------------------------------


def _rms_rel(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-12))


def _snr_db(got, want):
    err = got - want
    return float(10 * np.log10((np.mean(err ** 2) + 1e-30)
                               / (np.mean(want ** 2) + 1e-30)))


def _envelope_ok(got, want, sr):
    """Spectral envelope per quarter-second window (test_parallel.py:224-231)."""
    win_n = sr // 4
    for w0 in range(0, len(want) - win_n, win_n):
        a = np.abs(np.fft.rfft(want[w0 : w0 + win_n] * np.hanning(win_n)))
        b = np.abs(np.fft.rfft(got[w0 : w0 + win_n] * np.hanning(win_n)))
        if np.sqrt(np.sum((a - b) ** 2)) / (np.sqrt(np.sum(a ** 2)) + 1e-12) \
                >= 0.02:
            return False
    return True


def _pv_close(got, want):
    """The JAX suite's PV convention (test_pallas.py:473-523)."""
    scale = float(np.abs(want).max())
    assert float(np.sqrt(np.mean((got - want) ** 2))) < 5e-3 * scale
    nseg = len(want) // 2048
    f_g = np.abs(np.fft.rfft(got[: nseg * 2048].reshape(nseg, 2048), axis=1))
    f_w = np.abs(np.fft.rfft(want[: nseg * 2048].reshape(nseg, 2048), axis=1))
    assert np.abs(f_g - f_w).max() / f_w.max() < 2e-2


def _granular_close(got, want):
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert np.array_equal(got == 0.0, want == 0.0)


def check(name: str, got, want, sr: int = 8000) -> None:
    """Hold ``got`` (the port) to ``want`` (JAX) at the bar of the case's
    kind."""
    kind = name.split("/")[0]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    if kind == "seq_pv":  # test_parallel.py:219-231
        assert _rms_rel(got, want) < 2e-3, (name, _rms_rel(got, want))
        assert _envelope_ok(got, want, sr), name
    elif kind in ("seq_pv_formant", "seq_pv_lock"):  # :253-256, :512-515
        assert _rms_rel(got, want) < 2e-3, (name, _rms_rel(got, want))
    elif kind in ("dp_pv", "full_pv", "batch_pv", "batch_formant"):
        # the spectral-parity bar of :186-194, :300-306, :437-441,
        # :462-467 (-60 dB); :190's max abs 2e-4 holds JAX's batch against
        # JAX's single render, one set of XLA ops, and two float32 FFT
        # implementations differ by more near the normaliser's edges
        assert _snr_db(got, want) < -60.0, (name, _snr_db(got, want))
    elif kind in ("dp_render", "seq_render", "step_render", "full_render",
                  "batch_granular", "session_mono_granular",
                  "session_stereo_granular"):  # :116-117, :373-375
        _granular_close(got, want)
    elif kind in ("stft", "step_mags", "full_mags"):  # :45
        np.testing.assert_allclose(got, want, atol=1e-4)
    elif kind == "columns":  # :60
        np.testing.assert_allclose(got, want, atol=1e-5)
    elif kind in ("pitch_lag", "pitch_energy"):  # :328, :330
        np.testing.assert_allclose(got, want, rtol=1e-5)
    elif kind == "pitch_clarity":  # :329
        np.testing.assert_allclose(got, want, rtol=1e-4)
    elif kind in ("session_mono_pv", "session_stereo_pv"):
        if got.ndim == 1:
            _pv_close(got, want)
        else:
            for c in range(got.shape[1]):
                _pv_close(got[:, c], want[:, c])
    else:
        raise KeyError(name)


def tail_check(got, want, size: int = 2048, hop: int = 512) -> None:
    """test_parallel.py:518-540: the last size - hop samples."""
    tail = size - hop
    err = np.sqrt(np.mean((want[-tail:] - got[-tail:]) ** 2)) / (
        np.sqrt(np.mean(want ** 2)) + 1e-12)
    assert err < 2e-3, err
