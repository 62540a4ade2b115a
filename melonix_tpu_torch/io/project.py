"""Project persistence: the ``.mlx`` checkpoint format.

Counterpart of ``melonix_tpu/io/project.py``; a saved file is byte for byte
the JAX package's.  The reference's ``.melonix`` file is its checkpoint: a
version-stamped binary blob of {wavData, sampleRate, brightness, markers,
tempo} (app.hpp:35, 71-76; save app.cpp:1166-1190, load app.cpp:1124-1154).
Everything else (grains, pyramids, spectra, caches) is derived state
rebuilt on load (app.cpp:1153).  ``.mlx`` keeps that shape and contract:
only source samples and edit state with a version int; a mismatched
version is refused (app.cpp:1145-1149).

Layout, little-endian, no padding::

    b"MLXP", uint32 version (1),
    uint32 rate, uint64 n, float32 brightness, float32 tempo,
    uint32 marker count, count x (int32 sample, float64 note,
                                  float64 d_time, float64 pitch_bend),
    n x float32 samples

A file that is not such a project (truncated, corrupt or hostile) raises
:class:`ProjectError` and nothing else: every count is checked against the
bytes the file holds before anything is read or allocated from it.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..markers import Marker, sort_markers

MAGIC = b"MLXP"
VERSION = 1
_HEAD = struct.Struct("<4sI")
_FIELDS = struct.Struct("<IQff")
_COUNT = struct.Struct("<I")
_MARKER = struct.Struct("<iddd")


@dataclasses.dataclass
class Project:
    wav: np.ndarray  # float32 mono source samples
    sample_rate: int
    markers: list[Marker] = dataclasses.field(default_factory=list)
    brightness: float = 50.0
    tempo: float = 130.0


class ProjectError(RuntimeError):
    pass


def save_project(path: str, project: Project) -> str:
    """Write a .mlx file; appends the extension if missing
    (app.cpp:1168-1170).  Returns the path written."""
    if not path.endswith(".mlx"):
        path += ".mlx"
    wav = np.ascontiguousarray(np.asarray(project.wav, np.float32))
    ms = sort_markers(project.markers)
    with open(path, "wb") as f:
        f.write(_HEAD.pack(MAGIC, VERSION))
        f.write(_FIELDS.pack(project.sample_rate, len(wav),
                             project.brightness, project.tempo))
        f.write(_COUNT.pack(len(ms)))
        for m in ms:
            f.write(_MARKER.pack(m.sample, m.note, m.d_time, m.pitch_bend))
        f.write(wav.astype("<f4").tobytes())
    return path


def load_project(path: str) -> Project:
    """Read a .mlx file; ProjectError if it is not a valid project."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _HEAD.size or data[:4] != MAGIC:
        raise ProjectError(f"{path}: not a .mlx project")
    (version,) = struct.unpack_from("<I", data, 4)
    if version != VERSION:
        # Version mismatch = refuse load (app.cpp:1145-1149).
        raise ProjectError(f"{path}: version mismatch {version} != {VERSION}")
    off = _HEAD.size
    if len(data) < off + _FIELDS.size + _COUNT.size:
        raise ProjectError(f"{path}: truncated project header")
    rate, n, brightness, tempo = _FIELDS.unpack_from(data, off)
    off += _FIELDS.size
    (n_markers,) = _COUNT.unpack_from(data, off)
    off += _COUNT.size
    if n_markers > (len(data) - off) // _MARKER.size:
        raise ProjectError(f"{path}: bad marker count {n_markers}")
    markers = [Marker(*_MARKER.unpack_from(data, off + i * _MARKER.size))
               for i in range(n_markers)]
    off += n_markers * _MARKER.size
    if n > (len(data) - off) // 4:
        raise ProjectError(f"{path}: bad sample count {n} for "
                           f"{len(data) - off} bytes of samples")
    wav = np.frombuffer(data, "<f4", count=n, offset=off).astype(np.float32)
    return Project(wav=wav, sample_rate=rate, markers=markers,
                   brightness=brightness, tempo=tempo)
