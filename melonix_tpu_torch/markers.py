"""Edit model: markers.

A marker simultaneously warps time and bends pitch (reference: marker.hpp:4-9).
``sample`` anchors the marker in *source* samples; ``note`` is the MIDI-like
note the user clicked (A-based, note 0 = 13.75 Hz, see app.cpp:499); ``d_time``
shifts the marker's warped time by a cumulative offset; ``pitch_bend`` is in
semitones and is linearly interpolated between markers (app.cpp:1089-1122).

Markers are kept sorted by ``sample`` (app.cpp:897-899, 938-940).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Sequence


@dataclasses.dataclass
class Marker:
    sample: int
    note: float
    d_time: float = 0.0
    pitch_bend: float = 0.0

    def to_dict(self) -> dict:
        return {
            "sample": int(self.sample),
            "note": float(self.note),
            "d_time": float(self.d_time),
            "pitch_bend": float(self.pitch_bend),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Marker":
        return cls(
            sample=int(d["sample"]),
            note=float(d.get("note", 0.0)),
            d_time=float(d.get("d_time", d.get("dTime", 0.0))),
            pitch_bend=float(d.get("pitch_bend", d.get("pitchBend", 0.0))),
        )


def sort_markers(markers: Iterable[Marker]) -> list[Marker]:
    """Stable sort by source sample (reference keeps this invariant at every
    mutation: app.cpp:897-899)."""
    return sorted(markers, key=lambda m: m.sample)


def markers_to_json(markers: Sequence[Marker]) -> str:
    return json.dumps([m.to_dict() for m in markers], indent=2)


def markers_from_json(text: str) -> list[Marker]:
    return sort_markers(Marker.from_dict(d) for d in json.loads(text))
