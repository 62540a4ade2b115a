"""Batch rendering of many tracks: the serving path (counterpart of
``melonix_tpu/engine/batch.py``).

``render_batch`` takes a list of (track, markers) jobs at one sample rate
and renders them through the edit model:

* with a mesh (``"auto"`` makes one when the process group's world size is
  above 1, or an explicit ``parallel.AudioMesh``), whole tracks split over
  the mesh's ``data`` ranks, per-track edits bucketed to shared shapes --
  ``parallel.data_parallel_render`` / ``data_parallel_pv``.  Each rank
  plans and uploads only its own block of jobs; one all-gather of a few
  integers agrees the padded shapes and each job's output length;
* otherwise it loops the single-device ``render_session`` on ``device``.

Jobs pad to the longest track in the batch; callers with widely mixed
lengths should bucket first (the CLI ``batch`` command groups by sample
rate and renders each group in slices).
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_CONFIG, Config
from .grains import build_grain_table
from .maps import MapKnots
from .render import build_render_plan
from .session import _session_mesh, render_session

# Per-rank output budget: rows per rank x padded output length (the
# batched renders hold several such arrays per row).
BUDGET = 1 << 26


def render_batch(
    tracks: list[np.ndarray],
    markers_list: list[list],
    sample_rate: int,
    *,
    engine: str = "granular",
    preserve_formants: bool = False,
    phase_locking: bool = False,
    config: Config = DEFAULT_CONFIG,
    mesh="auto",
    device=None,
) -> list[np.ndarray]:
    """Render ``tracks[i]`` through ``markers_list[i]``; returns one mono
    float32 array per job, as ``render_session`` renders each (the granular
    engine within 2e-6 and with equal zeros, the phase vocoder by the PV
    convention, when the jobs go through a mesh)."""
    assert len(tracks) == len(markers_list)
    if not tracks:
        return []
    use_mesh = _session_mesh(mesh, device)

    def loop(eng):
        return [
            render_session(
                t, ms, sample_rate, engine=eng,
                preserve_formants=preserve_formants,
                phase_locking=phase_locking, config=config, mesh=None,
                device=device,
            )
            for t, ms in zip(tracks, markers_list)
        ]

    if use_mesh is None or len(tracks) == 1:
        return loop(engine)

    from ..parallel import sharded

    d = use_mesh.shape["data"]
    tracks = [np.asarray(t, np.float32) for t in tracks]
    n_shared = max(len(t) for t in tracks)
    jobs = list(zip(tracks, markers_list))
    jobs += [jobs[-1]] * ((-len(jobs)) % d)  # repeat the last job to fill
    per_rank = len(jobs) // d
    # this rank plans and uploads only its own block of jobs; one gather
    # of a few integers agrees the padded shapes and every job's length
    own = [jobs[r] for r in sharded._data_rows(use_mesh, len(jobs))]
    wav_b = np.zeros((per_rank, n_shared), np.float32)
    knots_l = []
    for b, (t, ms) in enumerate(own):
        wav_b[b, : len(t)] = t
        knots_l.append(MapKnots.from_markers(ms, sample_rate, len(t)))

    if engine == "pv":
        from .phase_vocoder import PV_CHUNK_FRAMES, build_pv_plan
        from .spectral import hann_window

        plans = [build_pv_plan(k, len(t), config=config)
                 for (t, _), k in zip(own, knots_l)]
        ok = all(p is not None for p in plans)
        dims, n_out = sharded.data_max(
            use_mesh, [int(not ok), *(sharded.pv_dims(plans) if ok
                                      else (0, 0, 0, 0))],
            [p.n_out if p is not None else 0 for p in plans])
        bad, *dims = (int(v) for v in dims)
        if (bad or dims[0] > PV_CHUNK_FRAMES
                or per_rank * dims[1] > BUDGET):
            # degenerate or hour-scale jobs: the single-chunk batched
            # formulation does not apply
            return loop("pv")
        kw, ops = sharded.pv_batch_args(plans, dims)
        f = sharded.data_parallel_pv(
            use_mesh, **kw, formant=bool(preserve_formants),
            lock=bool(phase_locking), local=True)
        out_b = f(wav_b, *ops[:4], hann_window(kw["size"]), *ops[4:])
        return [out_b[b, : n_out[b]].cpu().numpy()
                for b in range(len(tracks))]

    plans = [build_render_plan(build_grain_table(t, config), k, config=config)
             for (t, _), k in zip(own, knots_l)]
    dims, lens = sharded.data_max(
        use_mesh, sharded.granular_dims(plans),
        [v for p in plans for v in (p.total_out, p.out_offset[-1])])
    s_max, out_max = (int(v) for v in dims)
    if per_rank * out_max > BUDGET:
        return loop("granular")
    out_len = 1024 * -(-out_max // 1024)
    out_b = sharded.data_parallel_render(
        wav_b, *sharded.granular_batch_args(plans, (s_max, out_max))[:6],
        use_mesh, out_len, local=True)
    outs = []
    for b in range(len(tracks)):
        total, n_valid = (int(v) for v in lens[2 * b : 2 * b + 2])
        res = np.zeros(total, np.float32)  # 1500-zero tail
        res[:n_valid] = out_b[b, :n_valid].cpu().numpy()
        outs.append(res)
    return outs
