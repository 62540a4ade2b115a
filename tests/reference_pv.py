"""The benchmark's plain float64 reference of the PV render
(``benchmark/reference/pv.py``: torch, NumPy and math only), loaded by path,
as an oracle for PV renders of edits on which the JAX package's plan is at
fault: a rate segment that starts on a whole output sample, whose resample
anchor that package evaluates a rounding before the segment's start and so
with the previous segment's slope.  The port takes that anchor's constants
from its own segment; the reference has no anchors at all.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "reference", "pv.py")


def _load():
    spec = importlib.util.spec_from_file_location("reference_pv_f64", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load()


def as_tuples(markers) -> list:
    """Markers as ``(sample, note, d_time, pitch_bend)`` tuples."""
    return [m if isinstance(m, tuple) else
            (m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]


def render(wav, markers, sr: int, *, formants: bool = False,
           size: int = 2048, hop: int = 512) -> np.ndarray:
    """(n_out,) float32 of the reference's float64 render of the mono
    ``wav`` through ``markers``."""
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32))
    return REF.render(x, as_tuples(markers), sr, size=size, hop=hop,
                      formants=formants).numpy().astype(np.float32)
