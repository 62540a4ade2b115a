"""Automatic pitch correction: pitch curve -> suggested markers -> render
(counterpart of ``melonix_tpu/engine/autotune.py``).

The pitch engine (``engine/pitch.py``) measures the performance, note
segments are snapped to a scale, and the correction is expressed AS
MARKERS in the edit model the editor manipulates, so an auto-tuned take
stays hand-editable.  The bend curve interpolates linearly between markers
(app.cpp:1089-1122) and is 0 at t <= 0 and at the duration, so a constant
per-note correction takes a marker at BOTH ends of each note segment;
transitions glide across the gap between segments.

Everything here runs on the host (a copy of the JAX package's code); the
device work is the pitch curve and the render, on ``device``.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from ..markers import Marker
from .pitch import PitchCurve, pitch_curve

# Scale degrees in semitones from the key root (the reference note scale is
# A-based: note 24 = 55 Hz = A1, app.cpp:499).
SCALES = {
    "chromatic": tuple(range(12)),
    "major": (0, 2, 4, 5, 7, 9, 11),
    "minor": (0, 2, 3, 5, 7, 8, 10),
}
KEY_OFFSETS = {  # semitones from A
    "a": 0, "a#": 1, "bb": 1, "b": 2, "c": 3, "c#": 4, "db": 4, "d": 5,
    "d#": 6, "eb": 6, "e": 7, "f": 8, "f#": 9, "gb": 9, "g": 10, "g#": 11,
    "ab": 11,
}


def snap_note(note: float, scale: str = "chromatic", key: str = "a") -> float:
    """Nearest scale note (reference note numbering: 24 = A1 = 55 Hz)."""
    degrees = set(SCALES[scale])
    root = KEY_OFFSETS[key.lower()]
    lo = int(np.floor(note)) - 12
    cands = [k for k in range(lo, lo + 26) if (k - 24 - root) % 12 in degrees]
    return float(min(cands, key=lambda k: abs(k - note)))


class _RunningMedian:
    """Streaming median: max-heap of the lower half, min-heap of the upper
    (O(log m) per push, so segmenting an hour-long sustained note stays
    O(m log m))."""

    __slots__ = ("lo", "hi")

    def __init__(self):
        self.lo: list[float] = []  # negated max-heap
        self.hi: list[float] = []

    def push(self, x: float) -> None:
        if self.lo and x > -self.lo[0]:
            heapq.heappush(self.hi, x)
        else:
            heapq.heappush(self.lo, -x)
        if len(self.lo) > len(self.hi) + 1:
            heapq.heappush(self.hi, -heapq.heappop(self.lo))
        elif len(self.hi) > len(self.lo):
            heapq.heappush(self.lo, -heapq.heappop(self.hi))

    def median(self) -> float:
        if len(self.lo) > len(self.hi):
            return -self.lo[0]
        return (-self.lo[0] + self.hi[0]) / 2.0


def segment_notes(curve: PitchCurve, *, min_frames: int = 6,
                  split_jump: float = 0.6):
    """Voiced frame runs with a stable (within ``split_jump`` semitones)
    median -> [(start_frame, end_frame, median_note)] (end exclusive)."""
    segs = []
    note = np.asarray(curve.note, dtype=np.float64)
    voiced = np.asarray(curve.voiced)
    n = len(note)
    i = 0
    while i < n:
        if not voiced[i]:
            i += 1
            continue
        med = _RunningMedian()
        med.push(float(note[i]))
        j = i + 1
        while (j < n and voiced[j]
               and abs(float(note[j]) - med.median()) < split_jump):
            med.push(float(note[j]))
            j += 1
        if j - i >= min_frames:
            segs.append((i, j, med.median()))
        i = j
    return segs


def suggest_markers(
    wav,
    sample_rate: int,
    *,
    scale: str = "chromatic",
    key: str = "a",
    strength: float = 1.0,
    config: Config = DEFAULT_CONFIG,
    method: str = "nsdf",
    vibrato: float = 0.0,
    device=None,
) -> list[Marker]:
    """Markers that pitch-correct each detected note toward the scale.

    ``method`` selects the detector (``engine.pitch.pitch_curve``, run on
    ``device``).  ``vibrato`` in [0, 1] flattens intra-note modulation: 0
    keeps it (a constant bend per segment, two markers), 1 cancels the
    deviation from the note's median (per-frame bend strength * (target -
    med) + vibrato * (med - note_f), as dense markers every 3 frames)."""
    curve = pitch_curve(wav, sample_rate, config=config, method=method,
                        device=device)
    hop = curve.hop
    markers: list[Marker] = []
    # flattening tolerates deeper intra-note modulation before declaring a
    # new note: 0.6 st by default, +0.9 at full flattening
    split = 0.6 + 0.9 * max(0.0, min(1.0, vibrato))
    for f0, f1, med in segment_notes(curve, split_jump=split):
        target = snap_note(med, scale, key)
        bend = strength * (target - med)
        if vibrato <= 0.0:
            if abs(bend) < 0.03:  # < 3 cents: inaudible, below detector bias
                continue
            # anchored inside the segment (frame centres), both ends: flat
            s0 = (f0 * hop) + config.pitch_frame // 2
            s1 = ((f1 - 1) * hop) + config.pitch_frame // 2
            markers.append(Marker(int(s0), med, 0.0, float(bend)))
            if s1 > s0:
                markers.append(Marker(int(s1), med, 0.0, float(bend)))
            continue
        stride = 3  # frames between markers (~35 ms at 512-hop/44.1k)
        frames = list(range(f0, f1, stride))
        if frames[-1] != f1 - 1:
            frames.append(f1 - 1)
        bends = [
            bend + vibrato * (med - float(curve.note[f]))
            if curve.voiced[f] else bend
            for f in frames
        ]
        if all(abs(b) < 0.03 for b in bends):
            continue
        for f, b in zip(frames, bends):
            s = (f * hop) + config.pitch_frame // 2
            markers.append(Marker(int(s), med, 0.0, float(b)))
    return markers


def autotune(
    wav,
    sample_rate: int,
    *,
    scale: str = "chromatic",
    key: str = "a",
    strength: float = 1.0,
    engine: str = "pv",
    preserve_formants: bool = True,
    config: Config = DEFAULT_CONFIG,
    method: str = "nsdf",
    vibrato: float = 0.0,
    device=None,
):
    """Detect -> snap -> render, both device halves on ``device`` (default
    ``"cuda"``, no fallback).  Returns (rendered, markers)."""
    from .session import render_session

    markers = suggest_markers(
        wav, sample_rate, scale=scale, key=key, strength=strength,
        config=config, method=method, vibrato=vibrato, device=device,
    )
    out = render_session(
        wav, markers, sample_rate, engine=engine,
        preserve_formants=preserve_formants, config=config, device=device,
    )
    return out, markers
