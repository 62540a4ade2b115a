"""melonix_tpu_torch's native min/max pyramid, range queries and LRU map.

Ports ``tests/test_native.py:65-126`` to the port's wrappers
(``runtime/native.py``: ``calc_picks``, ``minmax_range``, ``Lru``): the
picks equal to the JAX package's NumPy pyramid (``build_pyramid(x,
device=False)``) and to the port's own pyramid on the CPU, range queries
against brute force, LRU recency and eviction; and the wrappers' checks: a
query outside the track, a level count the track lacks or a short buffer
raise before anything reaches C.
"""

import numpy as np
import pytest

from melonix_tpu.engine.pyramid import build_pyramid as j_build_pyramid

from melonix_tpu_torch.engine.pyramid import build_pyramid
from melonix_tpu_torch.runtime import native


@pytest.fixture(scope="module")
def lib():
    lib = native.try_load()
    if lib is None:
        pytest.skip("no C++ compiler to build the native runtime")
    return lib


def _levels(mins, maxs, n, levels):
    off = 0
    for l in range(levels):
        sz = n >> (l + 1)
        yield mins[off: off + sz], maxs[off: off + sz]
        off += sz


@pytest.mark.parametrize("n", [None, 3, 4, 5, 1023, 1024, 1025])
def test_picks_match_both_pyramids(chirp, lib, n):
    x = chirp[0] if n is None else np.random.default_rng(n).standard_normal(
        n).astype(np.float32)
    levels, mins, maxs = native.calc_picks(lib, x)
    jp = j_build_pyramid(x, device=False)
    tp = build_pyramid(x, device="cpu")
    assert levels == jp.n_levels == tp.n_levels
    if n is None:
        assert levels > 5
    for l, (mn, mx) in enumerate(_levels(mins, maxs, len(x), levels)):
        for pyr in (jp, tp):
            np.testing.assert_array_equal(mn, pyr.mins[l])
            np.testing.assert_array_equal(mx, pyr.maxs[l])


def test_picks_of_a_short_track(lib):
    for n in (0, 1, 2):
        levels, mins, maxs = native.calc_picks(lib, np.ones(n, np.float32))
        assert levels == 0 and len(mins) == len(maxs) == 0


def test_range_queries_against_brute_force(chirp, lib, rng):
    x, _sr = chirp
    n = len(x)
    levels, mins, maxs = native.calc_picks(lib, x)
    qs = rng.integers(0, n - 100, 50)
    qe = qs + rng.integers(1, 90, 50)
    # and long spans that climb the whole pyramid
    qs = np.concatenate([qs, [0, 1, 17, 3]])
    qe = np.concatenate([qe, [n - 1, n - 2, n // 2 + 5, 4099]])
    omn, omx = native.minmax_range(lib, x, mins, maxs, levels,
                                   np.stack([qs, qe], axis=1))
    for i, (s, e) in enumerate(zip(qs, qe)):
        assert omn[i] == x[s:e].min(), (s, e)
        assert omx[i] == x[s:e].max(), (s, e)


def test_empty_range_gives_its_start_sample(chirp, lib):
    x, _sr = chirp
    levels, mins, maxs = native.calc_picks(lib, x)
    omn, omx = native.minmax_range(lib, x, mins, maxs, levels,
                                   [[100, 100], [200, 50]])
    np.testing.assert_array_equal(omn, x[[100, 200]])
    np.testing.assert_array_equal(omx, x[[100, 200]])


@pytest.mark.parametrize("query", [[-1, 10], [10, -1], [0, 12000],
                                   [12000, 12001], [5, 10 ** 12]])
def test_query_outside_the_track_raises(chirp, lib, query):
    x, _sr = chirp
    assert len(x) == 12000
    levels, mins, maxs = native.calc_picks(lib, x)
    with pytest.raises(ValueError, match="outside the track"):
        native.minmax_range(lib, x, mins, maxs, levels, [[0, 10], query])


def test_bad_levels_and_buffers_raise(chirp, lib):
    x, _sr = chirp
    levels, mins, maxs = native.calc_picks(lib, x)
    q = [[0, 10]]
    with pytest.raises(ValueError, match="levels"):
        native.minmax_range(lib, x, mins, maxs, levels + 1, q)
    with pytest.raises(ValueError, match="need"):
        native.minmax_range(lib, x, mins[:-1], maxs[:-1], levels, q)
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        native.minmax_range(lib, x, mins, maxs, levels, [0, 10])
    # fewer levels than stored is a valid pyramid: the rest from raw samples
    omn, omx = native.minmax_range(lib, x, mins, maxs, 2, [[3, 5000]])
    assert omn[0] == x[3:5000].min() and omx[0] == x[3:5000].max()


def test_lru_recency_and_eviction(lib):
    lru = native.Lru(lib, 3)
    try:
        assert lru.get(1) is None
        for k in range(3):
            assert lru.put(k, k * 10) is None
        assert len(lru) == 3
        assert lru.get(0) == 0  # touch
        assert lru.put(3, 30) == 10  # key 1 (oldest) evicted; its value
        assert lru.get(1) is None
        assert lru.get(0) == 0 and lru.get(3) == 30
        assert lru.put(0, 5) is None and lru.get(0) == 5  # update in place
        assert len(lru) == 3
    finally:
        lru.close()
    lru.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        lru.get(0)


def test_lru_refuses_what_c_cannot_hold(lib):
    with pytest.raises(ValueError, match="capacity"):
        native.Lru(lib, 0)
    lru = native.Lru(lib, 2)
    try:
        with pytest.raises(ValueError, match="marks a miss"):
            lru.put(1, -1)
        assert len(lru) == 0
    finally:
        lru.close()
