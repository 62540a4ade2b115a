"""Piecewise-linear time-warp and pitch-bend maps.

Markers define BOTH a time warp and a pitch-bend curve (reference:
app.cpp:1020-1122).  Each marker ``i`` (sorted by sample) is a knot:

  knot_sample[i+1] = marker[i].sample
  knot_time[i+1]   = knot_time[i]
                     + (knot_sample[i+1] - knot_sample[i]) / sample_rate
                     + marker[i].d_time                      (app.cpp:1035)
  knot_bend[i+1]   = marker[i].pitch_bend

with the implicit origin knot (sample 0, time 0, bend 0).  Between knots all
three maps interpolate linearly; beyond the last knot time advances at 1 s per
``sample_rate`` samples (app.cpp:1047) and the pitch bend relaxes linearly to 0
at ``duration()`` (app.cpp:1115-1119).

Counterpart of ``melonix_tpu/engine/maps.py``; two implementations share
one knot layout:

* a NumPy host version in float64 (:class:`MapKnots`) — the control plane
  of render planning and the UI, bit-comparable with the C++ double
  arithmetic;
* tensor twins (:func:`pad_knots`, :func:`sample_to_time_torch`,
  :func:`time_to_sample_torch`, :func:`time_to_pitch_bend_torch`) that
  evaluate the maps over query tensors of any shape on the device their
  inputs are on.

The reference's segment search is *first match in marker order* (the time
map may be non-monotonic when ``d_time`` makes a segment run backwards,
app.cpp:1067-1068).  The tensor twins reproduce it with an argmax over a
mask; the host maps with one sorted search where the knot axis never
decreases (there the first match is the only one) and the mask elsewhere.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..markers import Marker, sort_markers
from .spectral import resolve_device


@dataclasses.dataclass(frozen=True)
class MapKnots:
    """Precomputed knot arrays; the array representation of an edit.

    ``samples``/``times``/``bends`` have length ``n_markers + 1`` with the
    implicit origin knot at index 0.
    """

    samples: np.ndarray  # float64 (n+1,) — source-sample knots
    times: np.ndarray  # float64 (n+1,) — warped-time knots
    bends: np.ndarray  # float64 (n+1,) — pitch-bend knots (semitones)
    sample_rate: int
    n_samples: int  # length of the source track

    @classmethod
    def from_markers(
        cls, markers: Sequence[Marker], sample_rate: int, n_samples: int
    ) -> "MapKnots":
        ms = sort_markers(markers)
        n = len(ms)
        samples = np.zeros(n + 1, np.float64)
        times = np.zeros(n + 1, np.float64)
        bends = np.zeros(n + 1, np.float64)
        prev_s = 0.0
        prev_t = 0.0
        for i, m in enumerate(ms):
            # app.cpp:1035 — cumulative d_time on top of proportional time
            t = prev_t + (m.sample - prev_s) / sample_rate + m.d_time
            samples[i + 1] = m.sample
            times[i + 1] = t
            bends[i + 1] = m.pitch_bend
            prev_s, prev_t = m.sample, t
        return cls(samples, times, bends, int(sample_rate), int(n_samples))

    # ------------------------------------------------------------------
    # NumPy host implementations (float64, exact reference arithmetic)
    # ------------------------------------------------------------------

    @functools.cached_property
    def _samples_ascending(self) -> bool:
        """Whether ``samples`` never decreases (a negative-sample marker
        breaks it)."""
        return _ascending(self.samples)

    @functools.cached_property
    def _times_ascending(self) -> bool:
        """Whether ``times`` never decreases (a backward ``d_time`` breaks
        it)."""
        return _ascending(self.times)

    def sample_to_time(self, val):
        """Vectorized ``App::sample2Time`` (app.cpp:1020-1050)."""
        v, scalar = _queries(val)
        ks, ts, sr = self.samples, self.times, self.sample_rate

        # Beyond the last knot: constant-rate extension (app.cpp:1047).
        out = ts[-1] + (v - ks[-1]) / sr
        if len(ks) > 1:
            # First segment (in marker order) with v in (ks[i], ks[i+1]]:
            # app.cpp:1036 tests the half-open interval per segment, so
            # empty and backward segments (negative-sample markers,
            # duplicates) never match.
            has, i = _host_segment(ks, self._samples_ascending, v)
            denom = ks[i + 1] - ks[i]
            with np.errstate(divide="ignore", invalid="ignore"):
                interp = ts[i] + (v - ks[i]) * (ts[i + 1] - ts[i]) / denom
            out = np.where(has, interp, out)
        # val <= 0 short-circuits before the marker walk (app.cpp:1024).
        out = np.where(v <= 0, v / sr, out)
        return float(out[0]) if scalar else out

    def time_to_sample(self, val):
        """Vectorized ``App::time2Sample`` (app.cpp:1052-1082).

        Returns int64 (the C++ ``static_cast<int>`` truncates toward zero).
        """
        v, scalar = _queries(val)
        res = np.trunc(self._sample_at(v, self._time_segment(v))).astype(
            np.int64)
        return int(res[0]) if scalar else res

    def time_to_sample_float(self, val):
        """``time_to_sample`` without the int truncation (analysis use)."""
        v, scalar = _queries(val)
        out = self._sample_at(v, self._time_segment(v))
        return float(out[0]) if scalar else out

    def duration(self) -> float:
        """``App::duration`` (app.cpp:1084-1087)."""
        return float(self.sample_to_time(self.n_samples - 1))

    def time_to_pitch_bend(self, val):
        """Vectorized ``App::time2PitchBend`` (app.cpp:1089-1122)."""
        v, scalar = _queries(val)
        out = self._bend_at(v, self._time_segment(v), self.duration())
        return float(out[0]) if scalar else out

    def time_to_sample_float_and_bend(self, val):
        """``(time_to_sample_float(val), time_to_pitch_bend(val), sorted)``,
        the maps as arrays, from one segment lookup and one ``duration()``;
        ``sorted`` says whether that lookup was the sorted search (the time
        map never runs backwards) rather than the first-match mask."""
        v, _ = _queries(val)
        seg = self._time_segment(v)
        return (self._sample_at(v, seg), self._bend_at(v, seg, self.duration()),
                self._times_ascending)

    def _time_segment(self, v: np.ndarray):
        """For times ``v``, the first segment (in marker order) with v in
        (ts[i], ts[i+1]] — the time map may run backwards (app.cpp:
        1067-1068) — as ``(has, i, v - ts[i], ts[i+1] - ts[i])``; None
        without markers."""
        ts = self.times
        if len(ts) == 1:
            return None
        has, i = _host_segment(ts, self._times_ascending, v)
        return has, i, v - ts[i], ts[i + 1] - ts[i]

    def _sample_at(self, v: np.ndarray, seg) -> np.ndarray:
        """``time_to_sample`` before the truncation, given ``seg``."""
        ks, ts, sr = self.samples, self.times, self.sample_rate
        out = ks[-1] + (v - ts[-1]) * sr  # app.cpp:1079
        if seg is not None:
            has, i, dv, denom = seg
            with np.errstate(divide="ignore", invalid="ignore"):
                interp = ks[i] + dv * (ks[i + 1] - ks[i]) / denom
            out = np.where(has, interp, out)
        return np.where(v <= 0, v * sr, out)

    def _bend_at(self, v: np.ndarray, seg, dur: float) -> np.ndarray:
        """``time_to_pitch_bend`` given ``seg`` and ``duration()``."""
        ts, bends = self.times, self.bends
        # Tail: relax to 0 at duration() (app.cpp:1118-1119); 0 beyond.
        denom_tail = dur - ts[-1]
        with np.errstate(divide="ignore", invalid="ignore"):
            tail = bends[-1] + (v - ts[-1]) * (0.0 - bends[-1]) / denom_tail
        tail = np.where(np.isfinite(tail), tail, 0.0)
        out = np.where(v > dur, 0.0, tail)
        if seg is not None:
            has, i, dv, denom = seg
            with np.errstate(divide="ignore", invalid="ignore"):
                interp = bends[i] + dv * (bends[i + 1] - bends[i]) / denom
            out = np.where(has, interp, out)
        out = np.where(v <= 0, 0.0, out)
        # Reference returns float32 (app.cpp:1105).
        return out.astype(np.float32)


def _queries(val) -> tuple[np.ndarray, bool]:
    """``val`` as a float64 array of at least one dimension, and whether it
    was a scalar."""
    v = np.asarray(val, np.float64)
    return np.atleast_1d(v), v.ndim == 0


def _ascending(a: np.ndarray) -> bool:
    return bool(np.all(a[1:] >= a[:-1]))


def _host_segment(axis: np.ndarray, ascending: bool, v: np.ndarray):
    """(has, i): whether each of ``v`` lies in some half-open segment
    (axis[i], axis[i+1]], and the first such i in knot order (0 where none
    does).

    On a non-decreasing axis that segment is the one below ``v``'s sorted
    insertion point: axis[i] < v <= axis[i+1] holds there and nowhere else,
    so one search replaces the (queries, knots) mask.
    """
    if ascending:
        idx = np.searchsorted(axis, v, "left")
        has = (idx > 0) & (idx < len(axis))
        return has, np.where(has, idx - 1, 0)
    match = (v[:, None] > axis[:-1]) & (v[:, None] <= axis[1:])
    return match.any(axis=1), np.argmax(match, axis=1)


# ----------------------------------------------------------------------
# Tensor twins — batched over query tensors of any shape, on the device of
# their inputs.  Knot tensors may be padded to a bucket (``pad_knots``), so
# that one set of shapes serves every marker count up to it.
# ----------------------------------------------------------------------


def pad_knots(knots: MapKnots, bucket: int = 128, device=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The knot arrays as float64 tensors on ``device`` (default
    ``"cuda"``, no fallback), padded to a multiple of ``bucket``.

    Padding repeats the last knot: the extra zero-length segments are empty
    half-open intervals and can never match, preserving semantics.
    """
    dev = resolve_device("cuda" if device is None else device)
    n = len(knots.samples)
    pad = bucket * -(-n // bucket) - n
    return tuple(
        torch.from_numpy(np.pad(a, (0, pad), mode="edge")).to(dev)
        for a in (knots.samples, knots.times, knots.bends))


def _segment(lo_hi: torch.Tensor, v: torch.Tensor):
    """(has, i): whether ``v`` lies in some half-open segment
    (lo_hi[i], lo_hi[i+1]], and the first such i in knot order (0 where
    none does)."""
    lo, hi = lo_hi[:-1], lo_hi[1:]
    vq = v[..., None]
    match = (vq > lo) & (vq <= hi)
    return match.any(dim=-1), match.to(torch.uint8).argmax(dim=-1)


def _interp(x: torch.Tensor, y: torch.Tensor, i: torch.Tensor, v):
    """y[i] + (v - x[i]) * (y[i+1] - y[i]) / (x[i+1] - x[i]), a zero-length
    segment's denominator taken as 1."""
    dx = x[i + 1] - x[i]
    dx = torch.where(dx == 0, 1.0, dx)
    return y[i] + (v - x[i]) * (y[i + 1] - y[i]) / dx


def _query(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor: a tensor stays as it is; anything else goes to
    the knots' device in their dtype."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def sample_to_time_torch(ks, ts, sample_rate, v) -> torch.Tensor:
    """Tensor twin of ``MapKnots.sample_to_time``; ``v`` is any shape."""
    v = _query(v, ks)
    has, i = _segment(ks, v)
    tail = ts[-1] + (v - ks[-1]) / sample_rate
    out = torch.where(has, _interp(ks, ts, i, v), tail)
    return torch.where(v <= 0, v / sample_rate, out)


def time_to_sample_torch(ks, ts, sample_rate, v) -> torch.Tensor:
    """Tensor twin of ``MapKnots.time_to_sample`` (float result, before the
    truncation)."""
    v = _query(v, ts)
    has, i = _segment(ts, v)
    tail = ks[-1] + (v - ts[-1]) * sample_rate
    out = torch.where(has, _interp(ts, ks, i, v), tail)
    return torch.where(v <= 0, v * sample_rate, out)


def time_to_pitch_bend_torch(ts, bends, duration, v) -> torch.Tensor:
    """Tensor twin of ``MapKnots.time_to_pitch_bend`` (in the inputs'
    dtype, not rounded to float32)."""
    v = _query(v, ts)
    has, i = _segment(ts, v)
    dt_tail = duration - ts[-1]
    tail = bends[-1] + (v - ts[-1]) * (0.0 - bends[-1]) / torch.where(
        dt_tail == 0, 1.0, dt_tail)
    out = torch.where(has, _interp(ts, bends, i, v), tail)
    out = torch.where(v > duration, 0.0, out)
    return torch.where(v <= 0, 0.0, out)
