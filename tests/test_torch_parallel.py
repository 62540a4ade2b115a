"""melonix_tpu_torch's B10, its ``parallel`` package at world size 1, the
batch path and the CLI's ``batch`` against melonix_tpu on the CPU.

* B10's plain twin (``kernels/pv.py:synth_ola_plain``) against the TPU
  kernel in interpret mode on the scrambled, Hermitian-mirrored spectrum of
  the same natural half, a float64 NumPy inverse + overlap-add, and the
  JAX package's unfused route (``istft_device(normalize=False)``).
* ``make_audio_mesh``'s shape policy and the host operand builders, exactly.
* Every sharded function on the port's world-1 mesh against JAX's on a
  one-device mesh (``torch_parallel_cases``, the bars of
  ``tests/test_parallel.py``); the multi-rank runs are
  ``test_torch_distributed.py``.
* ``render_batch`` and ``render_session`` routing, and ``batch`` on three
  WAV files against melonix_tpu's ``batch``.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from melonix_tpu.cli import main as j_cli
from melonix_tpu.engine import spectral as jspec
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.phase_vocoder import build_pv_plan as j_build_pv_plan
from melonix_tpu.engine.render import build_render_plan as j_build_plan
from melonix_tpu.engine.grains import build_grain_table as j_grains
from melonix_tpu.kernels import pallas_pv
from melonix_tpu.markers import Marker as JMarker
from melonix_tpu.parallel import sharded as jsh

import melonix_tpu_torch as mt
from melonix_tpu_torch.cli import main as t_cli
from melonix_tpu_torch.engine.phase_vocoder import build_pv_plan
from melonix_tpu_torch.io.wav import read_wav, write_wav
from melonix_tpu_torch.kernels import pv as kpv
from melonix_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)

SIZE, HOP = 2048, 512


def _snr_db(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return 10 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))


# ----------------------------------------------------------------------
# B10: synth_ola's twin
# ----------------------------------------------------------------------


def _b10_inputs(amp, f=128, seed=5):
    """Natural-order (F, 1025) mag/psi and the same spectrum scrambled and
    Hermitian-mirrored to (F, 2048) for the TPU kernel (psi[N-k] = -psi[k];
    DC and Nyquist keep their own phase, whose imaginary part a c2r inverse
    drops)."""
    rng = np.random.default_rng(seed)
    mag = rng.random((f, SIZE // 2 + 1)).astype(np.float32)
    psi = rng.uniform(-amp, amp, (f, SIZE // 2 + 1)).astype(np.float32)
    b = pallas_pv.scrambled_bins(SIZE).astype(np.int64)
    mirror = b > SIZE // 2
    nat = np.where(mirror, SIZE - b, b)
    mag_s = mag[:, nat]
    psi_s = np.where(mirror[None, :], -psi[:, nat], psi[:, nat])
    return mag, psi, mag_s.astype(np.float32), psi_s.astype(np.float32)


def _ola64(mag, psi, win):
    t = np.fft.irfft(mag.astype(np.float64) * np.exp(1j * psi.astype(np.float64)),
                     n=SIZE) * win.astype(np.float64)
    out = np.zeros((mag.shape[0] - 1) * HOP + SIZE)
    for m in range(mag.shape[0]):
        out[m * HOP : m * HOP + SIZE] += t[m]
    return out


@pytest.mark.parametrize("amp", [np.pi, 4e4], ids=["pi", "4e4"])
def test_b10_twin_matches_pallas_synth_ola(amp):
    mag, psi, mag_s, psi_s = _b10_inputs(amp)
    win = jspec.hann_window(SIZE)
    f = mag.shape[0]
    span = (f - 1) * HOP + SIZE
    got = kpv.synth_ola_plain(torch.from_numpy(mag), torch.from_numpy(psi),
                              torch.from_numpy(win), SIZE, HOP).numpy()
    assert got.shape == (span,)
    want = np.asarray(pallas_pv.synth_ola(
        jnp.asarray(mag_s), jnp.asarray(psi_s), jnp.asarray(win), SIZE, HOP,
        interpret=True))
    assert want.shape == ((f // pallas_pv.G + 1) * pallas_pv.G * HOP,)
    assert _snr_db(got, want[:span]) <= -90.0
    assert _snr_db(got, _ola64(mag, psi, win)) <= -100.0
    unfused = np.asarray(jspec.istft_device(
        jnp.asarray(mag) * jnp.exp(1j * jnp.asarray(psi)), jnp.asarray(win),
        SIZE, HOP, span, normalize=False))
    assert _snr_db(got, unfused) <= -100.0


def test_b10_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    mag, psi, _ms, _ps = _b10_inputs(np.pi, f=16)
    win = torch.from_numpy(jspec.hann_window(SIZE))
    before = kpv.synth_ola.launches
    a = kpv.synth_ola(torch.from_numpy(mag), torch.from_numpy(psi), win,
                      SIZE, 300)
    b = kpv.synth_ola_plain(torch.from_numpy(mag), torch.from_numpy(psi),
                            win, SIZE, 300)
    assert torch.equal(a, b) and a.shape == (15 * 300 + SIZE,)
    assert kpv.synth_ola.launches == before
    with pytest.raises(ValueError):
        kpv.synth_ola(torch.from_numpy(mag).to("meta"), None, None, SIZE, 300)


# ----------------------------------------------------------------------
# Mesh policy and host operands, exactly
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_policy_matches_jax(n):
    m = jsh.make_audio_mesh(n)
    assert tsh.mesh_shape(n) == (m.shape["data"], m.shape["seq"])


def test_world_one_mesh_and_its_limits():
    mesh = mt.make_audio_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.rank == 0
    assert mesh.data is None and mesh.seq is None
    assert mt.make_audio_mesh(1, data=1, device="cpu").shape["seq"] == 1
    with pytest.raises(ValueError, match="world size 4"):
        mt.make_audio_mesh(4, device="cpu")
    with pytest.raises(ValueError):
        tsh.mesh_shape(6, data=4)


def _pv_plans(chirp):
    x, sr = chirp
    out = []
    for ms in cases._pv_markers(len(x)):
        jk = JMapKnots.from_markers([JMarker(*m) for m in ms], sr, len(x))
        tk = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], sr, len(x))
        out.append((j_build_pv_plan(jk, len(x)), build_pv_plan(tk, len(x))))
    return out


def _equal_ops(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("n_seq", [1, 2, 4])
def test_seq_pv_args_equal_jax(chirp, n_seq):
    for jp, tp in _pv_plans(chirp):
        jkw, jops = jsh.seq_pv_args(jp, n_seq)
        tkw, tops = tsh.seq_pv_args(tp, n_seq)
        assert jkw == tkw
        _equal_ops(jops, tops)


def test_pv_batch_args_equal_jax(chirp):
    pairs = _pv_plans(chirp)
    jkw, jops = jsh.pv_batch_args([j for j, _t in pairs] + [pairs[0][0]])
    tkw, tops = tsh.pv_batch_args([t for _j, t in pairs] + [pairs[0][1]])
    assert jkw == tkw
    _equal_ops(jops, tops)


def _granular_plans(chirp):
    x, sr = chirp
    jt, tt = j_grains(x, backend="numpy"), mt.build_grain_table(x,
                                                              backend="numpy")
    out = []
    for ms in cases.SEQ_RENDER_SETS:
        jk = JMapKnots.from_markers([JMarker(*m) for m in ms], sr, len(x))
        tk = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], sr, len(x))
        out.append((j_build_plan(jt, jk), mt.build_render_plan(tt, tk)))
    return out


def test_granular_batch_args_equal_jax(chirp):
    pairs = _granular_plans(chirp)
    _equal_ops(jsh.granular_batch_args([j for j, _t in pairs]),
               tsh.granular_batch_args([t for _j, t in pairs]))


@pytest.mark.parametrize("n_seq", [1, 2, 4])
def test_seq_render_args_equal_jax(chirp, n_seq):
    x, _sr = chirp
    for jp, tp in _granular_plans(chirp):
        blk = n_seq * 1024
        out_len = blk * -(-int(jp.out_offset[-1]) // blk)
        _equal_ops(jsh.seq_render_args(jp, x, out_len, n_seq),
                   tsh.seq_render_args(tp, x, out_len, n_seq))


@pytest.mark.parametrize("size,hop,n_frames,fr,stretch_len", [
    (2048, 512, 64, 50, 64 * 512), (2048, 512, 66, 66, 66 * 512 + 1536),
    (1024, 256, 30, 7, 30 * 256), (1536, 384, 21, 21, 5000),
    (2048, 512, 10, 3, 10 * 512 + 2048 + 3000),
])
def test_wsum_masked_equals_jax(size, hop, n_frames, fr, stretch_len):
    win = jspec.hann_window(size)
    want = np.asarray(jsh._wsum_masked(jnp.asarray(win), jnp.int32(fr), size,
                                       hop, n_frames, stretch_len))
    got = tsh._wsum_masked(torch.from_numpy(win), fr, size, hop, n_frames,
                           stretch_len).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ----------------------------------------------------------------------
# Every sharded function at world size 1 against JAX's one-device mesh
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def world1(chirp):
    x, sr = chirp
    mesh = mt.make_audio_mesh(device="cpu")
    return cases.port_results(mesh, x, sr), cases.jax_results(1, 1, x, sr)


@pytest.mark.parametrize("name", cases.case_names(1))
def test_world1_matches_jax(world1, name):
    got, want = world1
    cases.check(name, got[name], want[name])


def test_world1_seq_pv_tail_not_attenuated(world1):
    got, want = world1
    for i in range(2):
        cases.tail_check(got[f"seq_pv/{i}"], want[f"seq_pv/{i}"])


def test_world1_seq_pv_equals_the_single_device_render(chirp):
    """With one seq shard the sharded stretch is the single-device one up
    to the masked normaliser: the PV convention against render_track_pv."""
    x, sr = chirp
    ms = cases._pv_markers(len(x))[0]
    knots = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], sr, len(x))
    plan = build_pv_plan(knots, len(x))
    kw, ops = tsh.seq_pv_args(plan, 1)
    f = tsh.seq_parallel_pv(mt.make_audio_mesh(device="cpu"), **kw)
    got = f(x, *ops[:4], jspec.hann_window(SIZE), *ops[4:])[: plan.n_out]
    want = mt.render_track_pv(x, knots, device="cpu")
    cases._pv_close(got.numpy(), want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_sum_orders_against_the_exact_sum():
    """The phase sum's order (``chip_smoke.pv_sum_order_render``, 40 s of
    the smoke's song and 12-marker edit).  The seq-parallel PV sums in
    float64 and rounds once, so at world size 1 it is the exact-sum render
    to float32 rounding, as is the single render on the CPU (torch's CPU
    cumsum accumulates float32 in float64).  The float32 orders lie
    farther: two halves summed apart (the JAX package's two-rank order)
    nearer than one serial sum (B3's scan, the single render's order on
    the card).  The card holds the 2-rank seq PV to the exact sum at the
    JAX suite's bars (test_parallel.py:219-231)."""
    cs = _chip_smoke()
    x = cs.make_song(cs.SR, 40.0)
    ms = cs.bench_markers(mt, len(x))
    knots = mt.MapKnots.from_markers(ms, cs.SR, len(x))
    plan = build_pv_plan(knots, len(x))
    exact = cs.pv_sum_order_render(mt, x, ms, "cpu")
    kw, ops = tsh.seq_pv_args(plan, 1)
    f = tsh.seq_parallel_pv(mt.make_audio_mesh(device="cpu"), **kw)
    seq = f(x, *ops[:4], jspec.hann_window(SIZE), *ops[4:])[: plan.n_out]
    single = mt.render_track_pv(x, knots, device="cpu")
    assert cs.rms_rel_env(seq.numpy(), exact, cs.SR)[0] < 1e-6
    assert cs.rms_rel_env(single, exact, cs.SR)[0] < 1e-6
    half = tsh.seq_pv_args(plan, 2)[0]["n_frames"] // 2
    rms_two, env_two = cs.rms_rel_env(
        cs.pv_sum_order_render(mt, x, ms, "cpu", split=half), exact, cs.SR)
    rms_ser, _ = cs.rms_rel_env(
        cs.pv_sum_order_render(mt, x, ms, "cpu", split=0), exact, cs.SR)
    assert 1e-5 < rms_two < rms_ser
    assert rms_two < 2e-3 and env_two < 0.02


# ----------------------------------------------------------------------
# render_batch and render_session routing at world size 1
# ----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["granular", "pv"])
def test_render_batch_auto_at_world_one_loops_render_session(chirp, engine):
    x, sr = chirp
    tracks = cases._batch_tracks(x)
    ms = [[mt.Marker(*m) for m in s] for s in cases.BATCH_SETS]
    got = mt.render_batch(tracks, ms, sr, engine=engine, device="cpu")
    assert len(got) == 3
    for t, m, g in zip(tracks, ms, got):
        want = mt.render_session(t, m, sr, engine=engine, mesh=None,
                                 device="cpu")
        assert np.array_equal(g, want)
    assert mt.render_batch([], [], sr) == []


@pytest.mark.parametrize("engine", ["granular", "pv"])
def test_render_session_world_one_mesh_equals_no_mesh(chirp, engine):
    x, sr = chirp
    ms = [mt.Marker(*m) for m in cases.SESSION_MARKERS]
    mesh = mt.make_audio_mesh(device="cpu")
    got = mt.render_session(x, ms, sr, engine=engine, mesh=mesh,
                            device="cpu")
    want = mt.render_session(x, ms, sr, engine=engine, mesh=None,
                             device="cpu")
    assert np.array_equal(got, want)


def test_stereo_pv_session_on_a_mesh_equals_no_mesh(chirp):
    x, sr = chirp
    st = cases._stereo(x)
    ms = [mt.Marker(*m) for m in cases.SESSION_MARKERS]
    mesh = mt.make_audio_mesh(device="cpu")
    got = mt.render_session(st, ms, sr, engine="pv", mesh=mesh)
    want = mt.render_session(st, ms, sr, engine="pv", mesh=None,
                             device="cpu")
    assert got.shape == want.shape == (want.shape[0], 2)
    assert np.array_equal(got, want)


# ----------------------------------------------------------------------
# CLI batch
# ----------------------------------------------------------------------


def _wav_files(tmp_path, chirp):
    x, sr = chirp
    tracks = cases._batch_tracks(x)
    paths = []
    for i, t in enumerate(tracks):
        p = tmp_path / f"take{i}.wav"
        write_wav(str(p), t, sr, dtype="float32")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("extra", [
    ["--engine", "granular"], ["--engine", "pv"],
    ["--engine", "pv", "--autotune"],
], ids=["granular", "pv", "pv-autotune"])
def test_cli_batch_matches_jax(tmp_path, chirp, extra):
    paths = _wav_files(tmp_path, chirp)
    markers = tmp_path / "m.json"
    markers.write_text(mt.markers_to_json(
        [mt.Marker(*m) for m in cases.BATCH_SETS[2]]))
    glob = str(tmp_path / "take*.wav")
    args = [glob, "--markers", str(markers)] + extra
    assert t_cli(["batch", *args, "-o", str(tmp_path / "t"), "--device",
                  "cpu"]) == 0
    assert j_cli(["batch", *args, "-o", str(tmp_path / "j")]) == 0
    for p in paths:
        name = os.path.basename(p)
        got, rate = read_wav(str(tmp_path / "t" / name))
        want, rate_j = read_wav(str(tmp_path / "j" / name))
        assert rate == rate_j and got.shape == want.shape
        if extra[1] == "granular":  # within one int16 step
            assert np.abs(got - want).max() <= 1.01 / 32767
        else:
            assert _snr_db(got, want) < -60.0


@pytest.mark.parametrize("case", ["mp3-input", "project-input", "flac-out"])
def test_cli_batch_refuses_unported_io(tmp_path, chirp, capsys, case):
    """``batch`` of an MP3 beside a WAV (two rate groups), of a ``.mlx``
    project (its own markers, under the shared ones the WAVs take) and
    with ``--format flac`` (once each refused with exit 2): the port's files
    against the JAX CLI's, granular within one int16 step, PV at SNR < -60
    dB."""
    from melonix_tpu.io.audio import load_audio as j_load_audio
    from melonix_tpu.io.project import Project as JProject
    from melonix_tpu.io.project import save_project as j_save_project

    paths = _wav_files(tmp_path, chirp)
    markers = tmp_path / "m.json"
    markers.write_text(mt.markers_to_json(
        [mt.Marker(*m) for m in cases.BATCH_SETS[2]]))
    engine, fmt = "granular", "wav"
    if case == "mp3-input":
        mp3 = tmp_path / "song.mp3"
        mp3.write_bytes(open(os.path.join(os.path.dirname(__file__),
                                          "fixtures", "tone.mp3"), "rb").read())
        args = [paths[0], str(mp3)]
    elif case == "project-input":
        x, sr = chirp
        proj = str(tmp_path / "session.mlx")
        j_save_project(proj, JProject(wav=x[::-1].copy(), sample_rate=sr,
                                      markers=[JMarker(4000, 60.0, 0.0, 7.0)]))
        args, engine = [paths[0], proj], "pv"
    else:
        args, fmt = paths, "flac"
    flags = ["--markers", str(markers), "--engine", engine, "--format", fmt]
    assert t_cli(["batch", *args, *flags, "-o", str(tmp_path / "t"),
                  "--device", "cpu"]) == 0
    assert f"{len(args)} files" in capsys.readouterr().out
    assert j_cli(["batch", *args, *flags, "-o", str(tmp_path / "j")]) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len(names) == len(args) and all(n.endswith(fmt) for n in names)
    for name in names:
        got, rate = mt.load_audio(str(tmp_path / "t" / name))
        want, rate_j = j_load_audio(str(tmp_path / "j" / name))
        assert rate == rate_j and got.shape == want.shape
        if engine == "granular":  # within one int16 step
            assert np.abs(got - want).max() <= 1.01 / 32767
        else:
            assert _snr_db(got, want) < -60.0


def test_cli_batch_no_match_exits_2(tmp_path):
    assert t_cli(["batch", str(tmp_path / "none*.wav"), "-o",
                  str(tmp_path / "o"), "--device", "cpu"]) == 2
