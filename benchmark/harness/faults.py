"""Faults planted under the timed path, by name: for the tests that see
``correct`` come out false, and for ``tools/readings.py``, which reads a
fault's numbers on the card to set a limit's upper end.  A run of the
benchmark never plants one.

Each fault replaces one attribute of the program (as ``spans`` does for a
traced run) with a call of the original whose keyword arguments or result
are broken; :func:`planted` puts it in and takes it out again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math

import numpy as np
import torch


def anchor_drift(out: torch.Tensor, *, spans: int = 12, span: int = 2048,
                 shift: float = 3.0) -> torch.Tensor:
    """Positions a few samples off, as a resample anchor that takes the
    wrong segment's constants gives them: over ``spans`` stretches of
    ``span`` samples spread over the render, each output sample is read
    from a position that falls behind by up to ``shift`` samples, then
    jumps back at the stretch's end."""
    out = out.clone()
    src = out.to(torch.float64)
    n = out.shape[0]
    j = torch.arange(span, dtype=torch.float64, device=out.device)
    for k in range(spans):
        a = int((k + 0.5) * n / spans)
        if a < math.ceil(shift) + 1 or a + span > n:
            continue
        pos = a + j - shift * (j + 1.0) / span
        i0 = pos.floor().long()
        f = pos - i0
        out[a:a + span] = (src[i0] * (1.0 - f) + src[i0 + 1] * f).to(
            out.dtype)
    return out


def voiced_all(curve):
    """Every frame voiced: both thresholds ignored."""
    curve.voiced = np.ones_like(curve.voiced)
    return curve


@dataclasses.dataclass(frozen=True)
class Fault:
    target: str  # package.module.attribute
    after: object = None  # the result broken
    kwargs: tuple = ()  # keyword arguments overridden


PV = "melonix_tpu_torch.engine.phase_vocoder.render_track_pv"
PITCH = "melonix_tpu_torch.engine.pitch.pitch_curve"

FAULTS = {
    "anchor_drift": Fault(PV, after=anchor_drift),
    "voiced_all": Fault(PITCH, after=voiced_all),
    "clarity_ignored": Fault(PITCH, kwargs=(("clarity_threshold",
                                             -math.inf),)),
    "energy_ignored": Fault(PITCH, kwargs=(("energy_threshold",
                                            -math.inf),)),
}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in the program for the ``with`` block."""
    fault = FAULTS[name]
    module_name, attr = fault.target.rsplit(".", 1)
    module = importlib.import_module(module_name)
    orig = getattr(module, attr)

    def broken(*args, **kwargs):
        kwargs.update(fault.kwargs)
        out = orig(*args, **kwargs)
        return fault.after(out) if fault.after is not None else out

    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, orig)
