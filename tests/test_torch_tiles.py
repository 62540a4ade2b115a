"""The port's spectrogram tile server against melonix_tpu on the CPU.

``_tiles_program`` (B7 magnitudes, log-texel max-pool, nearest fill, uint8
value plane) and ``TileServer(synchronous=True, device="cpu")`` against the
JAX package's on the same requests, then the tile server's contract as
tests/test_tiles.py holds the JAX one: black-until-ready, LRU eviction,
brightness clear, stale drains dropped, the damage log, in-flight settle,
a worker that survives a bad batch, and drains of at most 256 columns.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.config import Config as JConfig
from melonix_tpu.runtime import tiles as jtiles

from melonix_tpu_torch.config import Config
from melonix_tpu_torch.kernels import columns as kcols
from melonix_tpu_torch.runtime import tiles as ttiles
from melonix_tpu_torch.runtime.tiles import LruCache, TileServer
from melonix_tpu_torch.ui.colormap import colormap_lut
from melonix_tpu_torch.utils import registry

torch.set_num_threads(2)

LUT = colormap_lut()
V_OF_RGB = {tuple(rgb): v for v, rgb in enumerate(LUT)}


def _values(tiles) -> np.ndarray:
    """RGB tiles back to their uint8 value planes (the LUT is one to one)."""
    return np.asarray([[V_OF_RGB[tuple(px)] for px in t] for t in tiles],
                      np.int32)


def _assert_planes_close(got, want):
    """The quantisation bar: >= 99.9% of texels equal, none off by more
    than one level (two float32 FFTs round differently at boundaries)."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert np.mean(diff == 0) >= 0.999, np.mean(diff == 0)
    assert diff.max() <= 1


def _song(seconds=3.0, sr=44100):
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * (200.0 + 400.0 * t) * t)
    x += 0.01 * np.random.default_rng(5).standard_normal(len(t))
    return x.astype(np.float32)


def _requests(n, n_cols, span, seed=0):
    rng = np.random.default_rng(seed)
    ends = rng.integers(0, n + 3000, n_cols)
    ends[:4] = [span, 100, n, n + 40000]  # short, tiny, at and past the end
    return [(i, int(e) - span, int(e)) for i, e in enumerate(ends)]


# ----------------------------------------------------------------------
# Log-texel grid and the device program
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n_bins,texels,frac_min", [
    (16384, 2048, 2.5e-4), (256, 64, 1.0 / 128), (2048, 2048, 2.5e-4)])
def test_texel_grid_equals_jax(n_bins, texels, frac_min):
    for a, b in zip(ttiles._resample_tables(n_bins, texels, frac_min),
                    jtiles._resample_tables(n_bins, texels, frac_min)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    frac = np.random.default_rng(2).random(500)
    assert np.array_equal(ttiles.texel_of_frac(frac, texels, frac_min),
                          jtiles.texel_of_frac(frac, texels, frac_min))
    mags = np.random.default_rng(3).random((3, n_bins)).astype(np.float32)
    assert np.array_equal(ttiles.log_resample_np(mags, texels, frac_min),
                          jtiles.log_resample_np(mags, texels, frac_min))


@pytest.mark.parametrize("size", [4096, 32768])
def test_tiles_program_matches_jax(size):
    """The torch value plane against JAX's _tiles_program (XLA path): the
    unsorted segment ids, the dropped segment and the nearest fill."""
    x = _song()
    cfg = Config(spectr_size=size)
    reqs = _requests(len(x), 40 if size == 32768 else 120, 882)
    starts = np.asarray([r[1] for r in reqs], np.int32)
    ends = np.asarray([r[2] for r in reqs], np.int32)
    ids, nearest = ttiles._resample_tables(size // 2, cfg.tile_texels,
                                           cfg.tile_frac_min)
    k = cfg.brightness_to_k()
    want = np.asarray(jtiles._tiles_program(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends),
        jnp.float32(k), jnp.asarray(ids), jnp.asarray(nearest), size=size,
        decay=cfg.spec_decay, texels=cfg.tile_texels, use_pallas=False))
    got = ttiles._tiles_program(
        torch.from_numpy(x), torch.from_numpy(starts), torch.from_numpy(ends),
        k, torch.from_numpy(ids), torch.from_numpy(nearest), size=size,
        decay=cfg.spec_decay, texels=cfg.tile_texels)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert want.max() > 100  # the gain puts the chirp well up the map
    _assert_planes_close(got.numpy(), want)


def test_synchronous_server_matches_jax_server():
    """The same request stream through both synchronous servers: the same
    tiles within the quantisation bar, the same LRU and stats."""
    x = _song(2.0)
    cfg, jcfg = Config(spectr_size=4096, max_ranges=300), JConfig(
        spectr_size=4096, max_ranges=300)
    k = cfg.brightness_to_k()
    srv = TileServer(x, k=k, config=cfg, synchronous=True, device="cpu")
    jsrv = jtiles.TileServer(x, k=k, config=jcfg, synchronous=True)
    reqs = _requests(len(x), 280, 441, seed=4)
    try:
        srv.prefetch(reqs[:200])
        jsrv.prefetch(reqs[:200])
        got = srv.get_tiles(reqs)
        want = jsrv.get_tiles(reqs)
        assert all(t is not None and t.shape == (2048, 3) and t.dtype == np.uint8
                   for t in got)
        _assert_planes_close(_values(got), _values(want))
        assert srv.stats() == jsrv.stats()
        one, jone = srv.get_tile(999, 1000, 2000), jsrv.get_tile(999, 1000, 2000)
        _assert_planes_close(_values([one]), _values([jone]))
        assert srv.stats()["cached"] == jsrv.stats()["cached"] == 281
    finally:
        srv.close()
        jsrv.close()


def test_drains_in_chunks_of_256(monkeypatch):
    """A 600-column drain is three column batches of 256, 256 and 88 (no
    padding), and only the requested rows come back."""
    sizes = []
    real = kcols.spectrogram_columns_fused
    monkeypatch.setattr(kcols, "spectrogram_columns_fused",
                        lambda w, s, e, *a, **k: sizes.append(len(s))
                        or real(w, s, e, *a, **k))
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32)
    cfg = Config(spectr_size=1024, max_ranges=1000)
    srv = TileServer(x, k=1e4, config=cfg, synchronous=True, device="cpu")
    reqs = [(i, 30 * i, 30 * i + 64) for i in range(600)]
    tiles = srv.get_tiles(reqs)
    assert sizes == [256, 256, 88]
    assert len(tiles) == 600 and all(t is not None for t in tiles)
    assert srv.stats() == {"cached": 600, "pending": 0, "inflight": 0,
                           "busy_s": 0.0}


# ----------------------------------------------------------------------
# The contract (tests/test_tiles.py:45-475)
# ----------------------------------------------------------------------


def test_lru_capacity_and_recency():
    lru = LruCache(3)
    for i in range(3):
        assert lru.put(i, i * 10) is False
    assert len(lru) == 3
    assert lru.get(0) == 0  # touch 0 → most recent
    assert lru.put(3, 30) is True  # evicts the oldest (1)
    assert 1 not in lru and 0 in lru and 2 in lru and 3 in lru
    assert lru.get(1) is None
    lru.clear()
    assert len(lru) == 0


def test_black_until_ready_contract(chirp):
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=8)
    server = TileServer(x, k=cfg.brightness_to_k(), config=cfg, device="cpu")
    try:
        t = server.get_tile(0, 0, 500)
        assert t is None  # first poll: pending (black)
        deadline = time.time() + 30
        while t is None and time.time() < deadline:
            time.sleep(0.01)
            t = server.get_tile(0, 0, 500)
        assert t is not None, "worker never produced the tile"
        assert t.shape == (cfg.tile_texels, 3) and t.dtype == np.uint8
    finally:
        server.close()


def test_batched_compute_and_lru_eviction(chirp):
    calls = []
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=4)

    def compute(starts, ends):
        calls.append(len(starts))
        return np.ones((len(starts), 256), np.float32) * 0.01

    server = TileServer(x, k=1000.0, config=cfg, compute=compute,
                        synchronous=True, device="cpu")
    for key in range(6):  # 6 distinct tiles through a capacity-4 cache
        assert server.get_tile(key, key * 100, key * 100 + 400) is not None
    assert server.stats()["cached"] == 4
    n_calls = len(calls)
    assert server.get_tile(5, 500, 900) is not None  # cached: no compute
    assert len(calls) == n_calls
    server.get_tile(0, 0, 400)  # evicted → pending → compute
    assert len(calls) == n_calls + 1


def test_brightness_change_clears(chirp):
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=8)
    server = TileServer(x, k=cfg.brightness_to_k(), config=cfg,
                        synchronous=True, device="cpu")
    assert server.get_tile(0, 0, 400) is not None
    assert server.stats()["cached"] == 1
    server.set_brightness_k(999.0)
    assert server.stats()["cached"] == 0


def test_log_resample_device_matches_np(chirp):
    """The server's device path and the NumPy twin of the resample agree
    to one value level."""
    import oracle

    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=16)
    k = cfg.brightness_to_k()
    srv = TileServer(x, k=k, config=cfg, synchronous=True, device="cpu")
    tile = srv.get_tile(0, 100, 500)
    srv.close()
    mags = oracle.spec_column(x, 100, 500, spectr_size=512)[None, :]
    v = np.uint8(np.round(np.clip(
        ttiles.log_resample_np(mags, cfg.tile_texels, cfg.tile_frac_min)
        * np.float32(k), 0.0, 255.0)))
    _assert_planes_close(_values([tile]), v)


def test_worker_survives_bad_batch():
    """A failing batch must not kill the worker thread (fail-soft): the
    error is counted in tiles.worker_errors and later requests are served."""
    calls = {"n": 0}

    def compute(starts, ends):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected batch failure")
        return np.ones((len(starts), 1024), np.float32)

    srv = TileServer(np.zeros(4096, np.float32), k=512.0,
                     config=Config(spectr_size=2048), compute=compute,
                     poll_interval=0.005, device="cpu")
    try:
        before = registry("tiles.worker_errors").value
        assert srv.get_tile(1, 0, 2048) is None  # queued; the worker fails
        deadline = time.time() + 5.0
        while registry("tiles.worker_errors").value == before:
            assert time.time() < deadline, "worker error never recorded"
            time.sleep(0.01)
        deadline = time.time() + 5.0
        tile = None
        while tile is None and time.time() < deadline:
            tile = srv.get_tile(2, 0, 2048)
            time.sleep(0.01)
        assert tile is not None and tile.shape[1] == 3
    finally:
        srv.close()


def _slow_server(max_ranges=8):
    """A server whose compute blocks until ``release`` is set."""
    release, started = threading.Event(), threading.Event()
    computed: list = []

    def slow_compute(starts, ends):
        computed.append(len(starts))
        started.set()
        release.wait(10.0)
        return np.zeros((len(starts), 64), np.float32)

    srv = TileServer(np.zeros(4096, np.float32), k=1.0,
                     config=Config(max_ranges=max_ranges),
                     compute=slow_compute, poll_interval=0.002, device="cpu")
    return srv, release, started, computed


def _wait(cond, what, limit=5.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit, what
        time.sleep(0.002)


@pytest.mark.parametrize("signal", ["busy_s", "inflight"])
def test_in_flight_batch_is_visible_until_it_lands(signal):
    """stats() shows a batch in flight (busy_s > 0, inflight == 1 with
    pending == 0: the real settled condition is both 0) and returns to 0
    when it lands."""
    srv, release, started, _computed = _slow_server()
    try:
        assert srv.stats()[signal] == 0
        srv.get_tile(0, 0, 256)
        assert started.wait(5.0), "worker never started"
        if signal == "busy_s":
            time.sleep(0.06)
            assert srv.stats()["busy_s"] > 0.0
        else:
            st = srv.stats()
            assert st["pending"] == 0 and st["inflight"] == 1
        assert srv.get_tile(0, 0, 256) is None  # still black
        release.set()
        _wait(lambda: srv.get_tile(0, 0, 256) is not None, "tile never arrived")
        st = srv.stats()
        assert st["busy_s"] == 0.0 and st["inflight"] == 0 and st["pending"] == 0
    finally:
        release.set()
        srv.close()


def test_repoll_during_drain_does_not_recompute():
    srv, release, started, computed = _slow_server(max_ranges=64)
    try:
        reqs = [(i, i * 16, i * 16 + 256) for i in range(8)]
        assert all(t is None for t in srv.get_tiles(reqs))
        assert started.wait(5.0), "worker never started"
        for _ in range(50):  # the UI frame loop re-polling hard
            srv.get_tiles(reqs)
            srv.prefetch(reqs)
            srv.get_tile(*reqs[0])
        release.set()
        _wait(lambda: all(t is not None for t in srv.get_tiles(reqs)),
              "tiles never arrived")
        time.sleep(0.05)  # time for a (wrong) second drain to start
        assert computed == [8], f"expected ONE drain, got {computed}"
    finally:
        release.set()
        srv.close()


@pytest.mark.parametrize("change", ["brightness", "clear"])
def test_change_mid_drain_discards_stale_tiles(change):
    """A brightness change or a clear() (the marker-edit invalidate: the
    same key maps to new ranges) while a batch is on the device must not
    land the stale batch in the cache; the re-request serves new content."""
    release, started = threading.Event(), threading.Event()

    def slow_compute(starts, ends):
        val = 100.0 if int(starts[0]) == 0 else 50.0  # range in the content
        if not started.is_set():
            started.set()
            release.wait(10.0)
        return np.full((len(starts), 64), val, np.float32)

    srv = TileServer(np.zeros(8192, np.float32), k=1.0,
                     config=Config(max_ranges=8), compute=slow_compute,
                     poll_interval=0.002, device="cpu")
    try:
        assert srv.get_tile(0, 0, 256) is None
        assert started.wait(5.0), "worker never started"
        if change == "brightness":
            srv.set_brightness_k(2.0)
            req, want = (0, 0, 256), LUT[200]  # 100 * k=2.0
        else:
            srv.clear()
            req, want = (0, 1024, 1280), LUT[50]  # the post-edit range
            assert srv.get_tile(*req) is None  # not suppressed as in flight
        release.set()
        tile = None
        t0 = time.monotonic()
        while tile is None:
            assert time.monotonic() - t0 < 5.0, "tile never arrived"
            tile = srv.get_tile(*req)
            time.sleep(0.002)
        assert (tile == want).all(), "stale tile served"
    finally:
        release.set()
        srv.close()


def _const_server(max_ranges):
    return TileServer(
        np.zeros(8192, np.float32), k=1.0, config=Config(max_ranges=max_ranges),
        compute=lambda s, e: np.full((len(s), 64), 10.0, np.float32),
        synchronous=True, device="cpu")


def test_damage_log_names_landed_keys():
    srv = _const_server(64)
    assert srv.keys_landed_since(srv.epoch) == frozenset()
    e0 = srv.epoch
    srv.get_tile(3, 0, 256)
    srv.get_tile(7, 256, 512)
    assert srv.keys_landed_since(e0) == frozenset({3, 7})
    e1 = srv.epoch
    srv.get_tile(9, 512, 768)
    assert srv.keys_landed_since(e1) == frozenset({9})
    assert srv.keys_landed_since(e0) == frozenset({3, 7, 9})
    srv.clear()  # unknown damage for any pre-clear epoch...
    assert srv.keys_landed_since(e0) is None
    e2 = srv.epoch  # ...but a fresh epoch tracks again
    srv.get_tile(1, 0, 256)
    assert srv.keys_landed_since(e2) == frozenset({1})
    e3 = srv.epoch
    srv.set_brightness_k(2.0)
    assert srv.keys_landed_since(e3) is None


def test_eviction_invalidates_damage_log():
    srv = _const_server(2)
    e0 = srv.epoch
    srv.get_tile(0, 0, 256)
    srv.get_tile(1, 256, 512)
    assert srv.keys_landed_since(e0) == frozenset({0, 1})  # at capacity
    e1 = srv.epoch
    srv.get_tile(2, 512, 768)  # evicts key 0
    assert srv.keys_landed_since(e1) is None
    assert srv.keys_landed_since(e0) is None


def test_tile_content_invariant_under_trailing_zeros(chirp):
    """Trailing zeros change no tile: out-of-range samples read as zeros
    (spec.cpp:50-54)."""
    x, _sr = chirp
    cfg = Config(spectr_size=512, max_ranges=64)
    k = cfg.brightness_to_k()
    xp = np.concatenate([x, np.zeros(1000, np.float32)])
    a = TileServer(x, k=k, config=cfg, synchronous=True, device="cpu")
    b = TileServer(xp, k=k, config=cfg, synchronous=True, device="cpu")
    for key, lo, hi in [(0, 100, 500), (1, 0, 512),
                        (2, len(x) - 600, len(x) - 1),
                        (3, len(x) - 200, len(x) + 300)]:
        assert np.array_equal(a.get_tile(key, lo, hi), b.get_tile(key, lo, hi))
