"""Session rendering (counterpart of ``melonix_tpu/engine/session.py``).

The reference is strictly mono: libswresample downmixes on import
(app.cpp:669-684).  Sessions keep their channels: the *edit model* is
shared by every channel, so every channel splices at the same sample
positions -- a coherent stereo image -- while the samples rendered come
from each channel.  The time-warp map needs only the take's length; the
granular engine's grain boundaries come from the mono downmix, which only
that engine computes.  A multichannel PV session renders every channel
against one shared PV plan (:func:`render_channels_pv`); on one card the
take goes up in one copy as it lies and the (n_out, C) render comes down in
one, so the session makes no host pass over the samples.  The
``session.host`` spans count the passes it does make (``passes``) and the
bytes they read and wrote.

Routing (session.py:146-203): with a mesh (``parallel.AudioMesh``; "auto"
makes one over the process group when its world size is above 1, on the
rank's own card) the channels of a multichannel session split over the
mesh's ``data`` ranks (``data_parallel_render`` for the granular engine,
``render_channels_pv``'s mesh route for the phase vocoder).  A MONO track
with an EXPLICIT mesh whose ``seq`` axis is above 1 renders through the
sequence-parallel renderers (``seq_render`` / ``seq_parallel_pv``):
opt-in, since the distributed PV phase carry reorders float sums (the PV
convention, not bit equality).
Everything else takes the single-device path on ``device``.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from ..io.audio import downmix_mono
from ..utils import tracing
from .grains import build_grain_table
from .maps import MapKnots
from .phase_vocoder import render_channels_pv, render_track_pv
from .render import build_render_plan, render


def _session_mesh(mesh, device=None):
    """Resolve the ``mesh`` argument: "auto" -> a (data, seq) mesh over the
    process group when its world size is above 1, on this rank's card
    (``parallel.sharded.auto_mesh``), else None (the single-device path);
    anything else as given."""
    if not (isinstance(mesh, str) and mesh == "auto"):
        return mesh
    from ..parallel.sharded import auto_mesh

    return auto_mesh(device)


def _render_channels_granular(wav_ch: np.ndarray, plan, mesh) -> np.ndarray:
    """(C, n) channels through one shared granular plan, channels batched
    over the mesh's ``data`` ranks (zero channels pad to the shard count)."""
    from ..parallel.sharded import data_parallel_render

    C, _n = wav_ch.shape
    d = mesh.shape["data"]
    B = d * -(-C // d)
    wav_b = wav_ch if B == C else np.pad(wav_ch, ((0, B - C), (0, 0)))
    total = plan.total_out
    out_len = 1024 * -(-total // 1024)
    gs = np.tile(plan.grain_start, (B, 1))
    gl = np.tile(plan.grain_len, (B, 1))
    rt = np.tile(plan.rate, (B, 1))
    oo = np.tile(plan.out_offset.astype(np.int32), (B, 1))
    ss = np.tile(plan.seam_src, (B, 1))
    nv = np.full((B,), int(plan.out_offset[-1]), np.int32)
    out = data_parallel_render(wav_b, gs, gl, rt, oo, ss, nv, mesh,
                               out_len)[:C, :total]
    with tracing.span("d2h", bytes=out.nbytes):
        return out.cpu().numpy()


def _mono_seq_mesh(mesh):
    """An EXPLICIT mesh with a seq axis above 1 enables the
    sequence-parallel mono paths; "auto"/None keep the single-device
    renderers."""
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return None
    shape = getattr(mesh, "shape", None)
    return mesh if isinstance(shape, dict) and shape.get("seq", 1) > 1 \
        else None


def _render_mono_granular_seq(mono, plan, mesh) -> np.ndarray:
    """ONE track's granular render, output axis sharded over ``seq``
    (``parallel.seq_render``; the host plan supplies the per-shard
    bases)."""
    from ..parallel.sharded import seq_render

    out, n_grain_out = seq_render(mesh, plan, mono)
    res = np.zeros(plan.total_out, np.float32)
    res[:n_grain_out] = out[:n_grain_out]
    return res  # the reference's 1500-zero tail included via total_out


def _render_mono_pv_seq(mono, knots, mesh, config, preserve_formants,
                        phase_locking=False):
    """ONE track's PV render with stretch frames sharded over ``seq``
    (B10 per rank on CUDA at 2048 points).  Returns None when the track is
    too short for the shard count (each shard must cover the OLA spill):
    the caller then takes the single-device render, as the reference
    routes it."""
    from ..parallel.sharded import seq_parallel_pv, seq_pv_args
    from .phase_vocoder import build_pv_plan
    from .spectral import hann_window

    plan = build_pv_plan(knots, len(mono), config=config)
    if plan is None:
        return None  # empty/degenerate: the single-device path handles it
    n_seq = mesh.shape["seq"]
    kw, ops = seq_pv_args(plan, n_seq)
    if (kw["n_frames"] // n_seq) * plan.hop < plan.size - plan.hop:
        return None  # shard span shorter than the OLA spill
    f = seq_parallel_pv(mesh, **kw, formant=bool(preserve_formants),
                        lock=bool(phase_locking))
    out = f(mono, *ops[:4], hann_window(kw["size"]), *ops[4:])[: plan.n_out]
    with tracing.span("d2h", bytes=out.nbytes):
        return out.cpu().numpy()


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

    ``wav``: float32 (n,) mono or (n, C) multichannel.  ``mesh``: "auto"
    (channels over the process group's ranks when its world size is above
    1), an explicit ``parallel.AudioMesh`` (which also sends a mono track
    with seq > 1 to the sequence-parallel renderers), or None (the
    single-device path).  The single-device path runs on ``device``
    (default ``"cuda"``; no fallback), a mesh route on the mesh's device.
    Returns the rendered audio with the same channel layout.
    """
    if engine not in ("granular", "pv"):
        raise ValueError(f"unknown engine {engine!r}")
    with tracing.span("render_session"):
        with tracing.span("session.host") as sp:
            take, passes, touched = _take(wav, engine)
            multi = take.ndim == 2
            mono = None if multi else take
            if multi and engine == "granular":  # its grain table's signal
                mono = downmix_mono(take)
                passes += 1
                touched += take.nbytes + mono.nbytes
            sp.count(passes=passes, bytes=touched)
        return _render_session(take, mono, markers, sample_rate, engine,
                               preserve_formants, phase_locking, config, mesh,
                               device)


def _take(wav, engine: str) -> tuple:
    """The session's float32 take, with the host passes that made it (0 or
    1) and the bytes they read and wrote.  A multichannel PV take is made
    C-contiguous, so that it goes up in one copy as it lies; anything else
    keeps its strides."""
    pv_multi = engine == "pv" and np.ndim(wav) == 2
    take = (np.ascontiguousarray if pv_multi else np.asarray)(wav, np.float32)
    if isinstance(wav, np.ndarray) and np.may_share_memory(take, wav):
        return take, 0, 0
    return take, 1, getattr(wav, "nbytes", take.nbytes) + take.nbytes


def _render_session(wav, mono, markers, sample_rate: int, engine: str,
                    preserve_formants: bool, phase_locking: bool,
                    config: Config, mesh, device) -> np.ndarray:
    """:func:`render_session` past its host checks.  ``mono`` is the track
    (None for a multichannel PV take, which needs no downmix)."""
    multi = wav.ndim == 2
    knots = MapKnots.from_markers(markers, sample_rate, wav.shape[0])
    use_mesh = _session_mesh(mesh, device) if multi else None
    seq_mesh = _mono_seq_mesh(mesh) if not multi else None

    if engine == "pv":
        if not multi:
            if seq_mesh is not None:
                out = _render_mono_pv_seq(
                    mono, knots, seq_mesh, config, preserve_formants,
                    phase_locking=phase_locking,
                )
                if out is not None:
                    return out
            return render_track_pv(
                mono, knots, config=config,
                preserve_formants=preserve_formants,
                phase_locking=phase_locking, device=device,
            )
        # the single-device route returns the transpose of a C-contiguous
        # (n_out, C) array; the mesh route gathers (C, n_out)
        out = render_channels_pv(
            wav.T, knots, config=config, preserve_formants=preserve_formants,
            phase_locking=phase_locking, mesh=use_mesh, device=device,
        ).T
        if out.flags.c_contiguous:
            return out
        with tracing.span("session.host", passes=1, bytes=2 * out.nbytes):
            return np.ascontiguousarray(out)

    table = build_grain_table(mono, config)
    plan = build_render_plan(table, knots, config=config)
    if not multi:
        if seq_mesh is not None:
            return _render_mono_granular_seq(mono, plan, seq_mesh)
        return render(mono, plan, device=device)
    if use_mesh is not None:
        with tracing.span("session.host", passes=1, bytes=2 * wav.nbytes):
            wav_ch = np.ascontiguousarray(wav.T)
        out = _render_channels_granular(wav_ch, plan, use_mesh)
        with tracing.span("session.host", passes=1, bytes=2 * out.nbytes):
            return np.ascontiguousarray(out.T)
    with tracing.span("session.host", passes=1, bytes=2 * wav.nbytes):
        chans = [np.ascontiguousarray(wav[:, c]) for c in range(wav.shape[1])]
    chans = [render(c, plan, device=device) for c in chans]
    with tracing.span("session.host", passes=1,
                      bytes=2 * sum(c.nbytes for c in chans)):
        return np.stack(chans, axis=1)
