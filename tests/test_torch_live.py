"""Live playback of melonix_tpu_torch (CPU, plain twins) against
melonix_tpu on the CPU: B11's twin, the streaming phase vocoder
(``PvStream``), the native playback ring and the ``Player``.

B11's twin (``resample_lerp_plain``) and the Player's granular half are
exact, so they are held bit for bit.  PV audio is compared by the JAX
suite's conventions: rms < 5e-3 of the peak plus the spectral envelope
(< 2e-2) between packages, rms 2e-3 of the signal's rms between a stream
and its own offline render (test_pv_stream.py, test_player.py).  Inputs are
made from seeded numpy generators.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from melonix_tpu.engine import phase_vocoder as jpv
from melonix_tpu.engine.grains import build_grain_table as j_build_grain_table
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.player import Player as JPlayer
from melonix_tpu.engine.pv_stream import PvStream as JPvStream
from melonix_tpu.kernels import pallas_resample
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import player as tplayer
from melonix_tpu_torch.engine import pv_stream as tps
from melonix_tpu_torch.kernels import resample as kres
from melonix_tpu_torch.runtime import native

torch.set_num_threads(2)

SR = 8000
BLK = kres.BLK


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sine(f, secs):
    t = np.arange(int(SR * secs)) / SR
    return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _knots(n, markers):
    return (JMapKnots.from_markers([JMarker(*m) for m in markers], SR, n),
            mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], SR, n))


def _read_all(stream, quantum):
    chunks = []
    while not stream.exhausted:
        chunks.append(stream.read(quantum))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _rel_err(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-12))


def _assert_pv_close(got, want):
    assert len(got) == len(want)
    scale = float(np.abs(want).max())
    assert float(np.sqrt(np.mean((got - want) ** 2))) < 5e-3 * scale
    nseg = len(want) // 2048
    f_g = np.abs(np.fft.rfft(got[: nseg * 2048].reshape(nseg, 2048), axis=1))
    f_w = np.abs(np.fft.rfft(want[: nseg * 2048].reshape(nseg, 2048), axis=1))
    assert np.abs(f_g - f_w).max() / f_w.max() < 2e-2


@pytest.fixture(scope="module")
def bent_track():
    x = _sine(330.0, 4.0)
    n = len(x)
    return x, _knots(n, [(n // 3, 52.0, 0.08, 4.0),
                         (2 * n // 3, 52.0, -0.03, -2.0)])


# ----------------------------------------------------------------------
# B11: resample_lerp's twin
# ----------------------------------------------------------------------


def _wandering_case(rng):
    """test_pallas.py:267-293: monotone positions, rate in [0.6, 1.9]."""
    n_src = 9000
    y = rng.standard_normal(n_src).astype(np.float32)
    n_out = 2 * BLK
    rates = (1.25 + 0.65 * np.sin(np.linspace(0, 9, n_out))).astype(np.float64)
    pos64 = np.cumsum(rates) - rates
    base = pallas_resample.block_bases(pos64[::BLK], n_src)
    rel = (pos64 - np.repeat(base.astype(np.float64), BLK)).astype(np.float32)
    return y, rel, base, pallas_resample.rows_for(1.9)


def _hour_case(rng):
    """test_pallas.py:296-319: a slab 1.5e8 samples deep, relative f32."""
    n_src, big = 4096, 150_000_000
    y = rng.standard_normal(n_src).astype(np.float32)
    rates = (1.1 + 0.4 * np.sin(np.linspace(0, 7, BLK))).astype(np.float64)
    pos64 = big + 200.0 + np.cumsum(rates) - rates
    base = np.full(1, 200 - 128, np.int32)
    rel = (pos64 - big - base[0].astype(np.float64)).astype(np.float32)
    return y, rel, base, pallas_resample.rows_for(1.5)


def _tail_case(rng):
    """Positions that run past the source's end, up to the slab's last
    full row, and a negative one (clipped to 0).  (The TPU kernel's
    lane gather leaves the slab's last row out and reads 0 there, where
    the port reads the track: a position ``rows_for`` never lets a block
    reach.)"""
    y = rng.standard_normal(3000).astype(np.float32)
    rel = rng.uniform(0.0, 19 * 128 - 1, 2 * BLK).astype(np.float32)
    rel[:3] = [-0.5, 19 * 128 - 0.1, 19 * 128 - 1.0]
    base = np.array([0, 1500], np.int32)
    return y, rel, base, 20


@pytest.mark.parametrize("case", [_wandering_case, _hour_case, _tail_case])
def test_resample_lerp_twin_matches_pallas_exactly(case):
    y, rel, base, rows = case(np.random.default_rng(1234))
    want = np.asarray(pallas_resample.resample_lerp_pallas(
        jnp.asarray(y), jnp.asarray(rel), jnp.asarray(base), rows,
        interpret=True))
    got = kres.resample_lerp(_t(y), _t(rel), _t(base), rows).numpy()
    np.testing.assert_array_equal(got, want)


def test_lerp_resample_rel_matches_xla():
    """Against ``_lerp_resample_rel_xla`` within one float32 spacing of the
    largest tap: XLA's CPU fusion contracts the lerp's sum into a fused
    multiply-add, on one product or the other, so it rounds one product
    less (at most half a spacing of a tap); the gather and clipping are
    exact."""
    y, rel, base, _rows = _wandering_case(np.random.default_rng(3))
    want = np.asarray(jpv._lerp_resample_rel_xla(
        jnp.asarray(y), jnp.asarray(rel), jnp.asarray(base), len(y), BLK))
    got = kres.lerp_resample_rel(_t(y), _t(rel), _t(base), len(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.abs(y).max()))


def test_resample_lerp_agrees_with_lerp_resample_rel_on_stream_inputs(
        bent_track):
    """On a stream's inputs (its positions, bases and slab rows, and its
    normalised buffer, whose tail is zero) B11's contract and the XLA lerp
    (clipped to the buffer) give the same samples: they differ only at the
    slab's and the track's edges, which a stream never reaches."""
    x, (_jk, pk) = bent_track
    s = tps.PvStream(x, pk, device="cpu")
    _read_all(s, 4096)
    assert not s._y_norm[s.plan.stretch_len:].any()
    n = s.plan.n_out_pad
    got = kres.resample_lerp(s._y_norm, s._pos, s._base, s._rows)
    want = kres.lerp_resample_rel(s._y_norm, s._pos, s._base,
                                  s._y_norm.shape[0])
    assert got.shape == (n,) and torch.equal(got, want)


# ----------------------------------------------------------------------
# PvStream: against JAX's stream and the ports of test_pv_stream.py
# ----------------------------------------------------------------------


@pytest.mark.parametrize("start_sec,lock,formant", [
    (0.0, False, False), (0.0, True, True), (1.3, True, False),
])
def test_stream_matches_jax_stream(bent_track, start_sec, lock, formant,
                                   monkeypatch):
    """The JAX stream on the port's resample anchors: ``bent_track``'s first
    marker starts a segment on a whole output sample, where the JAX
    package's plan takes the previous segment's slope (the port's anchors
    are held to the float64 position curve in test_torch_host.py).  The
    reference has no phase locking, so the JAX package's device half stays
    the oracle of the stream."""
    from melonix_tpu_torch.engine import phase_vocoder as tpv

    monkeypatch.setattr(jpv, "_anchor_table",
                        lambda *a: tpv._anchor_table(*a)[:5])
    x, (jk, pk) = bent_track
    want = _read_all(JPvStream(x, jk, start_sec=start_sec, chunk_frames=96,
                               phase_locking=lock,
                               preserve_formants=formant), 1000)
    got = _read_all(tps.PvStream(x, pk, start_sec=start_sec, chunk_frames=96,
                                 phase_locking=lock,
                                 preserve_formants=formant, device="cpu"),
                    1000)
    _assert_pv_close(got, want)


def test_stream_from_zero_matches_offline(bent_track):
    x, (_jk, pk) = bent_track
    offline = mt.render_track_pv(x, pk, device="cpu")
    stream = tps.PvStream(x, pk, chunk_frames=96, device="cpu")
    got = _read_all(stream, 1000)[: len(offline)]
    assert len(got) == len(offline)
    assert _rel_err(got, offline) < 2e-3


def test_read_granularity_invariant(bent_track):
    x, (_jk, pk) = bent_track
    a = _read_all(tps.PvStream(x, pk, chunk_frames=128, device="cpu"), 977)
    b = _read_all(tps.PvStream(x, pk, chunk_frames=128, device="cpu"), 4096)
    m = min(len(a), len(b))
    np.testing.assert_array_equal(a[:m], b[:m])
    s = tps.PvStream(x, pk, device="cpu")
    _read_all(s, 2048)
    assert np.all(s.read(512) == 0.0)  # past the end: silence


def test_stream_length_matches_warped_duration(bent_track):
    x, (_jk, pk) = bent_track
    s = tps.PvStream(x, pk, device="cpu")
    got = _read_all(s, 2048)
    assert s.n_out == int(pk.duration() * SR)
    assert len(got) - s.n_out < 2048
    assert np.all(got[s.n_out:] == 0.0) and np.any(got[: s.n_out] != 0.0)


def test_midtrack_restart_spectrally_consistent(bent_track):
    """A restart at t0 re-anchors phase: per half second after the splice's
    fade-in, equal rms (5 %) and dominant frequency (1 bin) to the offline
    render."""
    x, (_jk, pk) = bent_track
    offline = mt.render_track_pv(x, pk, device="cpu")
    t0 = 1.3
    j0 = round(t0 * SR)
    got = _read_all(tps.PvStream(x, pk, start_sec=t0, chunk_frames=256,
                                 device="cpu"), 2048)
    ref = offline[j0 : j0 + len(got)]
    got = got[: len(ref)]
    win, skip = SR // 2, 2048
    for w0 in range(skip, len(ref) - win, win):
        a, b = ref[w0 : w0 + win], got[w0 : w0 + win]
        rms_a, rms_b = np.sqrt(np.mean(a ** 2)), np.sqrt(np.mean(b ** 2))
        assert abs(rms_a - rms_b) < 0.05 * (rms_a + 1e-9), (w0, rms_a, rms_b)
        fa = np.argmax(np.abs(np.fft.rfft(a * np.hanning(win))))
        fb = np.argmax(np.abs(np.fft.rfft(b * np.hanning(win))))
        assert abs(int(fa) - int(fb)) <= 1, (w0, fa, fb)


def test_empty_and_degenerate_tracks():
    _jk, pk = _knots(100, [])
    s = tps.PvStream(np.zeros(100, np.float32), pk, device="cpu")
    assert s.read(64).shape == (64,) and s.exhausted


def test_tail_read_in_the_final_odd_block():
    """A seek into the last odd output block, drained in 1024-sample reads,
    against the offline render from there (the JAX case's geometry, with
    no output buckets to cross)."""
    x = _sine(330.0, ((1 << 14) - 2 * BLK // 2 - 4096) / SR)
    _jk, pk = _knots(len(x), [])
    ref = mt.render_track_pv(x, pk, device="cpu")
    n_out = tps.PvStream(x, pk, device="cpu").n_out
    j_seek = (n_out // BLK - 1) * BLK + 7
    if (j_seek // BLK) % 2 == 0:
        j_seek -= BLK
    got = _read_all(tps.PvStream(x, pk, start_sec=j_seek / SR, device="cpu"),
                    1024)
    want = ref[j_seek:]
    m = min(len(got), len(want))
    assert m > 0
    err = np.sqrt(np.mean((got[:m] - want[:m]) ** 2))
    assert err < 5e-3 * max(np.abs(want).max(), 1e-6), err


@pytest.mark.parametrize("option", ["preserve_formants", "phase_locking"])
def test_option_stream_matches_offline(bent_track, option):
    """Formants and locking through the pull API equal the offline render
    with the same option (rms 5e-3 of the peak)."""
    x, (_jk, pk) = bent_track
    ref = mt.render_track_pv(x, pk, device="cpu", **{option: True})
    got = _read_all(tps.PvStream(x, pk, device="cpu", **{option: True}), 4096)
    m = min(len(got), len(ref))
    assert np.sqrt(np.mean((got[:m] - ref[:m]) ** 2)) < 5e-3 * np.abs(ref).max()


def test_tiny_chunk_tail_fully_normalized():
    """chunk_frames * hop < size - hop (test_pv_stream.py:174-212): after
    the last chunk every stretched sample is normalised."""
    n = 62 * 512
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    _jk, pk = _knots(n, [])
    s = tps.PvStream(x, pk, chunk_frames=2, size=4096, hop=512, device="cpu")
    plan = s.plan
    assert s._ch * plan.hop < plan.size - plan.hop
    _read_all(s, 4096)
    assert s._frames_done >= plan.n_frames and s._fin == plan.stretch_len
    L = plan.stretch_len
    torch.testing.assert_close(s._y_norm[:L], s._y[:L] / s._wsum_pad[:L],
                               rtol=1e-5, atol=1e-6)


def test_each_read_resamples_once(bent_track, monkeypatch):
    """Every read that delivers real samples is one B11 call over the
    output blocks covering it; reads past the end make none."""
    x, (_jk, pk) = bent_track
    calls = []
    real = kres.resample_lerp

    def counting(y, pos, base, rows):
        calls.append(pos.shape[0])
        assert pos.shape[0] % BLK == 0 and base.shape[0] == pos.shape[0] // BLK
        return real(y, pos, base, rows)

    monkeypatch.setattr(kres, "resample_lerp", counting)
    s = tps.PvStream(x, pk, device="cpu")
    reads = 0
    while not s.exhausted:
        s.read(1024)
        reads += 1
    s.read(1024)
    assert len(calls) == reads == -(-s.n_out // 1024)


def test_stream_cuda_without_cuda_raises(bent_track, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, (_jk, pk) = bent_track
    with pytest.raises(RuntimeError, match="cuda"):
        tps.PvStream(x, pk)  # device defaults to cuda


# ----------------------------------------------------------------------
# The native ring
# ----------------------------------------------------------------------


def test_native_ring_fifo_wrap_clear_overflow():
    lib = native.try_load()
    assert lib is not None  # a C++ compiler is part of the test setup
    ring = native.Ring(lib, 1024)
    try:
        data = np.arange(600, dtype=np.float32)
        ring.write(data)
        assert ring.avail() == len(ring) == 600
        np.testing.assert_array_equal(ring.read(300), data[:300])
        data2 = np.arange(700, dtype=np.float32) + 1000  # wraps around
        ring.write(data2)
        out = ring.read(2000)
        np.testing.assert_array_equal(out, np.concatenate([data[300:], data2]))
        ring.write(data)
        ring.clear()
        assert ring.avail() == 0 and len(ring.read(10)) == 0
        with pytest.raises(RuntimeError, match="overflow"):
            ring.write(np.zeros(2000, np.float32))
    finally:
        ring.close()
    ring.close()  # closing twice is harmless


# ----------------------------------------------------------------------
# Player: against JAX's Player and the ports of test_player.py
# ----------------------------------------------------------------------


def _players(chirp, markers, engine="granular"):
    x, sr = chirp
    jk, pk = _knots(len(x), markers)
    table = j_build_grain_table(x, backend="numpy")
    return (JPlayer(x, table, jk, engine=engine),
            mt.Player(x, mt.build_grain_table(x, backend="numpy"), pk,
                      engine=engine, device="cpu"))


def _play(player, n=1024, limit=1000):
    player.toggle()
    got = []
    for _ in range(limit):
        got.append(player.callback(n))
        if not player.is_playing:
            break
    return np.concatenate(got)


def test_granular_player_matches_jax_bit_for_bit(chirp):
    """The granular half, with a seek and an edit mid-play."""
    markers = [(4000, 60.0, 0.02, 2.0)]
    jp, tp = _players(chirp, markers)
    x, sr = chirp
    outs = []
    for p in (jp, tp):
        p.toggle()
        bufs = [p.callback(1024) for _ in range(3)]
        p.seek(0.4)
        bufs += [p.callback(700) for _ in range(3)]
        jk, pk = _knots(len(x), [(3000, 60.0, 0.0, -3.0)])
        p.set_knots(jk if p is jp else pk)
        bufs += [p.callback(1024) for _ in range(40)]
        outs.append(np.concatenate(bufs))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert isinstance(tp._backlog, native.Ring)


def test_pv_player_matches_jax(chirp):
    jp, tp = _players(chirp, [(4000, 60.0, 0.02, 2.0)], engine="pv")
    want, got = _play(jp), _play(tp)
    assert not tp.is_playing
    _assert_pv_close(got, want)


def test_playback_matches_export(chirp):
    """From t = 0 the granular player delivers the export exactly, then
    the padding of its last buffer."""
    markers = [(4000, 60.0, 0.02, 2.0)]
    _jp, player = _players(chirp, markers)
    x, _sr = chirp
    want = mt.render_track(x, player.grains, player.knots, device="cpu")
    got = _play(player)
    assert len(got) >= len(want)
    np.testing.assert_array_equal(got[: len(want)], want)
    assert np.abs(got[len(want):]).max(initial=0.0) == 0.0


def test_stops_at_end(chirp):
    _jp, player = _players(chirp, [])
    _play(player, limit=2000)
    assert not player.is_playing
    assert np.abs(player.callback(1024)[100:]).max() == 0.0


def test_cursor_advances_by_emitted(chirp):
    _jp, player = _players(chirp, [])
    player.toggle()
    c0 = player.cursor_sec
    player.callback(1024)
    assert player.cursor_sec == c0 + 1024 / player.sample_rate


def test_seek_and_edit_drop_backlog(chirp):
    _jp, player = _players(chirp, [(4000, 60.0, 0.0, 2.0)])
    x, _sr = chirp
    player.toggle()
    player.callback(1024)
    assert len(player._backlog) > 0
    player.seek(0.5)
    assert len(player._backlog) == 0 and player.cursor_sec == 0.5
    player.callback(1024)
    player.set_knots(_knots(len(x), [(4000, 60.0, 0.0, -3.0)])[1])
    assert len(player._backlog) == 0
    assert np.isfinite(player.callback(1024)).all()


def test_pv_engine_matches_offline_pv(chirp):
    _jp, player = _players(chirp, [(4000, 60.0, 0.02, 2.0)], engine="pv")
    x, _sr = chirp
    want = mt.render_track_pv(x, player.knots, device="cpu")
    got = _play(player)
    assert not player.is_playing and len(got) >= len(want)
    assert _rel_err(got[: len(want)], want) < 2e-3
    assert np.abs(got[len(want):]).max(initial=0.0) == 0.0


def test_pv_engine_edit_and_switch_freshness(chirp):
    """A +7 st edit mid-play moves the next buffers' dominant frequency; an
    engine switch keeps playing."""
    x, sr = chirp
    _jp, player = _players(chirp, [], engine="pv")
    player.toggle()
    before = player.callback(1024)
    assert np.any(before != 0.0)
    player.set_knots(_knots(len(x), [(2000, 60.0, 0.0, 7.0)])[1])
    assert len(player._backlog) == 0
    after = np.concatenate([player.callback(1024) for _ in range(4)])
    fa = np.argmax(np.abs(np.fft.rfft(before * np.hanning(1024))))
    fb = (np.argmax(np.abs(np.fft.rfft(after * np.hanning(len(after)))))
          * 1024 / len(after))
    assert fb > fa * 1.2, (fa, fb)
    player.set_engine("granular")
    assert np.isfinite(player.callback(1024)).all()
    assert player.engine == "granular"
    player.set_engine("pv")
    assert np.isfinite(player.callback(1024)).all()
    with pytest.raises(ValueError):
        player.set_engine("tape")


def test_declick_ramp(chirp):
    _jp, player = _players(chirp, [])
    player.toggle()
    last = player.callback(1024)[-1]
    player.is_playing = False  # the user stops
    buf = player.callback(1024)
    want = last * np.linspace(1.0, 0.0, tplayer.FADE, endpoint=False,
                              dtype=np.float32)
    np.testing.assert_array_equal(buf[: tplayer.FADE], want)
    assert np.abs(buf[tplayer.FADE:]).max() == 0.0


def test_formant_and_lock_toggles(chirp):
    """Formants and locking leave the granular backlog alone; on PV each
    restarts the stream at the cursor."""
    _jp, player = _players(chirp, [(4000, 60.0, 0.02, 2.0)])
    player.toggle()
    player.callback(1024)
    before = player._backlog.avail()
    player.set_formant(True)
    player.set_phase_locking(True)
    assert player._backlog.avail() == before
    player.set_engine("pv")
    player.callback(1024)
    stream = player._pv_stream
    assert stream.preserve_formants and stream.phase_locking
    player.set_phase_locking(False)
    assert player._backlog.avail() == 0 and player._pv_stream is None
    assert np.isfinite(player.callback(1024)).all()
    assert not player._pv_stream.phase_locking


def test_pv_live_refill_watermarks(chirp, monkeypatch):
    """The first stream read after a (re)start covers the deadline plus
    PV_FIRST_READ's bank; the next refill tops up to PV_LIVE_AHEAD, with
    no reads in between (test_player.py:178-219)."""
    _jp, player = _players(chirp, [(4000, 60.0, 0.02, 2.0)])
    player.set_engine("pv")
    player.is_playing = True
    player.callback(1024)
    reads = []
    orig = tps.PvStream.read

    def spy(self, n):
        reads.append(n)
        return orig(self, n)

    monkeypatch.setattr(tps.PvStream, "read", spy)
    player.set_knots(player.knots)
    player.callback(1024)
    pgs = player.config.preferred_grain_size
    assert reads and reads[0] == max(1024 + pgs, tplayer.PV_FIRST_READ)
    n_before = len(reads)
    for _ in range(40):
        avail_before = player._backlog.avail()
        player.callback(1024)
        if len(reads) > n_before:
            break
    assert len(reads) > n_before
    assert reads[n_before] + avail_before == tplayer.PV_LIVE_AHEAD


def test_player_cuda_without_cuda_raises(chirp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _sr = chirp
    _jk, pk = _knots(len(x), [])
    with pytest.raises(RuntimeError, match="cuda"):
        mt.Player(x, mt.build_grain_table(x), pk)  # device defaults to cuda
