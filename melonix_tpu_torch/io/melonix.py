"""Reference ``.melonix`` project interop.

Counterpart of ``melonix_tpu/io/melonix.py``; a saved file is byte for byte
the JAX package's.  The reference saves and loads a versioned binary of
the App's serialized properties via mika314/ser (save app.cpp:1166-1190,
load app.cpp:1124-1154)::

    int32  version                    (== 1, refused otherwise, app.cpp:1145-1149)
    vector wavData  : int32 count, count x float32   (app.hpp:39, 72)
    int32  sampleRate                                 (app.hpp:41, 73)
    float32 brightness                                (app.hpp:53, 74)
    vector markers  : int32 count, count x Marker     (app.hpp:75)
        Marker = int32 sample, float64 note,
                 float64 dTime, float64 pitchBend     (marker.hpp:4-15)
    float32 tempo                                     (app.hpp:64, 76)

All fields little-endian, written field by field with no padding.  A file
that is not such a project raises :class:`ProjectError` and nothing else;
each count is checked against the bytes left before it is used.
"""

from __future__ import annotations

import struct

import numpy as np

from ..markers import Marker, sort_markers
from .project import Project, ProjectError

VERSION = 1  # app.hpp:35
_MARKER = struct.Struct("<iddd")


def save_melonix(path: str, project: Project) -> str:
    """Write a reference-layout .melonix file (app.cpp:1166-1190); appends
    the extension if missing (app.cpp:1168-1170).  Returns the path."""
    if not path.endswith(".melonix"):
        path += ".melonix"
    wav = np.ascontiguousarray(np.asarray(project.wav, np.float32))
    ms = sort_markers(project.markers)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", VERSION))
        f.write(struct.pack("<i", len(wav)))
        f.write(wav.astype("<f4").tobytes())
        f.write(struct.pack("<i", int(project.sample_rate)))
        f.write(struct.pack("<f", float(project.brightness)))
        f.write(struct.pack("<i", len(ms)))
        for m in ms:
            f.write(_MARKER.pack(int(m.sample), m.note, m.d_time,
                                 m.pitch_bend))
        f.write(struct.pack("<f", float(project.tempo)))
    return path


def load_melonix(path: str) -> Project:
    """Read a .melonix file; ProjectError if it is not a valid project."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt: str):
        nonlocal off
        size = struct.calcsize(fmt)
        if off + size > len(data):
            raise ProjectError(f"{path}: truncated .melonix at byte {off}")
        vals = struct.unpack_from(fmt, data, off)
        off += size
        return vals

    (version,) = take("<i")
    if version != VERSION:
        # Version mismatch = refuse load (app.cpp:1145-1149).
        raise ProjectError(
            f"{path}: .melonix version mismatch {version} != {VERSION}")
    (n,) = take("<i")
    if n < 0 or off + 4 * n > len(data):
        raise ProjectError(f"{path}: bad wavData length {n}")
    wav = np.frombuffer(data, "<f4", count=n, offset=off).astype(np.float32)
    off += 4 * n
    (rate,) = take("<i")
    (brightness,) = take("<f")
    (n_markers,) = take("<i")
    if n_markers < 0 or off + _MARKER.size * n_markers > len(data):
        raise ProjectError(f"{path}: bad marker count {n_markers}")
    markers = [Marker(*take("<iddd")) for _ in range(n_markers)]
    (tempo,) = take("<f")
    if rate <= 0:
        raise ProjectError(f"{path}: bad sample rate {rate}")
    return Project(wav=wav, sample_rate=rate, markers=markers,
                   brightness=float(brightness), tempo=float(tempo))
