"""The scene bars: how two renders of one editor scene are compared.

Outside the spectrogram lane two renders must be bit-equal (the waveform,
the menu bar: host code over exact min/max).  Inside the lane, the tile
bars of ``PERF.md`` §2: at least 99.9% of the pixels equal, and no pixel
more than one colormap level from its counterpart (two float32 column
transforms round differently at a level's boundary, as the tile tests'
value planes do).  A lane pixel is ``min(LUT[v] + a, 255)`` per channel,
``a`` the piano-stripe and beat-grid add of its row and column, blended
with the scrubber's pink in the scrubber's column; a pixel's level set is
every ``v`` that composes to it.  Markers and the pitch curve draw over
the lane, so a pixel of theirs that differs has no level and fails.

Imports only NumPy: the CPU tests and ``chip_smoke.py`` (which loads this
file by path) share it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PINK = np.array([255, 0, 128], np.float32)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG whose rows all
    use filter 0 (what ``ui/png.py`` writes)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat = 8, b""
    w = h = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _c, _f, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("not an 8-bit RGB non-interlaced PNG")
        elif tag == b"IDAT":
            idat += body
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError("a row uses a PNG filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()


def _level_sets(px: np.ndarray, add: int, scrub: bool, lut: np.ndarray):
    comp = np.minimum(lut.astype(np.uint16) + add, 255).astype(np.uint8)
    if scrub:
        comp = np.clip(comp.astype(np.float32) * 0.75 + 0.25 * PINK, 0,
                       255).astype(np.uint8)
    return np.nonzero((comp == px[None, :]).all(axis=1))[0]


def scene_bars(got: np.ndarray, want: np.ndarray, view, state,
               lut: np.ndarray) -> dict:
    """Compare two scenes of ``state``'s geometry.  ``view`` is the
    ``ui/view.py`` module that drew them (its lane geometry and overlay
    adds); ``lut`` the (256, 3) colormap table.  Returns the share of lane
    pixels equal, the largest level distance among the others (inf where a
    pixel has no level), whether everything outside the lane is
    bit-equal, and the largest channel difference."""
    if got.shape != want.shape:
        raise ValueError(f"scene shapes differ: {got.shape} {want.shape}")
    W, H, lane_h, top, _wave_top, _wave_h = view._lane_geometry(state)
    outside = np.ones(H, bool)
    outside[top : top + lane_h] = False
    g, w = got[top : top + lane_h], want[top : top + lane_h]
    neq = (g != w).any(axis=-1)
    adds = (view._piano_row_add(state, lane_h).astype(np.int64)[:, None]
            + view._beat_col_add(state, W).astype(np.int64)[None, :])
    x = int((state.cursor_sec - state.start_time) / state.range_time * W)
    worst = 0.0
    for r, c in zip(*np.nonzero(neq)):
        sg = _level_sets(g[r, c], int(adds[r, c]), c == x, lut)
        sw = _level_sets(w[r, c], int(adds[r, c]), c == x, lut)
        if not len(sg) or not len(sw):
            worst = float("inf")
            break
        worst = max(worst, float(np.abs(sg[:, None] - sw[None, :]).min()))
    return {
        "lane_equal": float(1.0 - neq.mean()),
        "lane_max_level": worst,
        "outside_equal": bool(np.array_equal(got[outside], want[outside])),
        "max_channel_diff": int(np.abs(got.astype(np.int16)
                                       - want.astype(np.int16)).max()),
    }


def assert_scene_bars(got, want, view, state, lut) -> dict:
    bars = scene_bars(got, want, view, state, lut)
    assert bars["outside_equal"], bars
    assert bars["lane_equal"] >= 0.999, bars
    assert bars["lane_max_level"] <= 1, bars
    return bars
