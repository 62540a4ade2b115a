"""Session rendering on one device (counterpart of
``melonix_tpu/engine/session.py``'s ``render_session`` with ``mesh=None``).

The reference is strictly mono: libswresample downmixes on import
(app.cpp:669-684).  Sessions keep their channels: the *edit model* (grain
boundaries, time-warp map) is derived from the mono downmix so every
channel splices at the same sample positions — a coherent stereo image —
while the samples rendered come from each channel.  A multichannel PV
session renders every channel against one shared PV plan
(:func:`render_channels_pv`).  Multi-device meshes are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from ..io.audio import downmix_mono
from .grains import build_grain_table
from .maps import MapKnots
from .phase_vocoder import render_channels_pv, render_track_pv
from .render import build_render_plan, render


def render_session(
    wav,
    markers,
    sample_rate: int,
    *,
    engine: str = "granular",
    preserve_formants: bool = False,
    phase_locking: bool = False,
    config: Config = DEFAULT_CONFIG,
    mesh="auto",
    device=None,
) -> np.ndarray:
    """Render a (possibly multichannel) session through the marker edit.

    ``wav``: float32 (n,) mono or (n, C) multichannel.  The render runs on
    ``device`` (default ``"cuda"``; no fallback).  ``mesh``: ``"auto"`` or
    None, both the single-device path; a mesh is not ported yet.  Returns
    the rendered audio with the same channel layout.
    """
    if mesh is not None and not (isinstance(mesh, str) and mesh == "auto"):
        raise NotImplementedError(
            "mesh: multi-device sessions are not ported yet (ROADMAP queue "
            "A, item 15)"
        )
    if engine not in ("granular", "pv"):
        raise ValueError(f"unknown engine {engine!r}")
    wav = np.asarray(wav, np.float32)
    multi = wav.ndim == 2
    mono = downmix_mono(wav) if multi else wav
    knots = MapKnots.from_markers(markers, sample_rate, len(mono))

    if engine == "pv":
        if not multi:
            return render_track_pv(
                mono, knots, config=config,
                preserve_formants=preserve_formants,
                phase_locking=phase_locking, device=device,
            )
        out = render_channels_pv(
            wav.T, knots, config=config, preserve_formants=preserve_formants,
            phase_locking=phase_locking, device=device,
        )
        return np.ascontiguousarray(out.T)

    table = build_grain_table(mono, config)
    plan = build_render_plan(table, knots, config=config)
    if not multi:
        return render(mono, plan, device=device)
    chans = [render(np.ascontiguousarray(wav[:, c]), plan, device=device)
             for c in range(wav.shape[1])]
    return np.stack(chans, axis=1)
