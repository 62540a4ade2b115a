"""Witness for the resample anchors of ``build_pv_plan`` (host only).

    python3 benchmark/tools/anchor_witness.py --seeds 1,2,3 --requests 4

Autotune's markers (one a note, ``d_time`` 0, the bend that snaps the
note's detune, a fifth bent further) on seeded 180 s melodies at 48 kHz.
For each request, the program's own plan for its markers: how many
resample anchors sit at a marker's start but take their constants from
the segment before it (the anchor's time falls a rounding below the
marker's), and the largest gap in samples between the positions the
program's anchors give (its plain twin of B4's position formula) and two
witnesses: the program's own float64 position curve evaluated at every
output sample, and the reference's.  One JSON line a request.  Runs on
the CPU.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--seconds", type=float, default=180.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import melonix_tpu_torch as mt
    from melonix_tpu_torch.engine import phase_vocoder as pv
    from melonix_tpu_torch.kernels import resample as kres

    from benchmark.harness import inputs
    from benchmark.reference import pv as ref_pv

    sr = args.sample_rate
    cfg = mt.Config()
    for seed in (int(s) for s in args.seeds.split(",")):
        for i in range(args.requests):
            notes, cents = inputs.melody_notes(sr, args.seconds, seed, i)
            ms = inputs.snap_markers(inputs.rng(seed, 12, i), sr, notes,
                                     cents, 0.2, 0.2, (1.0, 4.0))
            n = int(len(notes) * int(1.5 * sr))
            knots = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms],
                                             sr, n)
            plan = pv.build_pv_plan(knots, n, config=cfg)
            anc_j, src, rho, slope, n_real = plan.anc_np
            pos = kres.positions_rel_plain(
                *(torch.from_numpy(a[:n_real]) for a in (anc_j, src, rho,
                                                         slope)),
                sr, plan.n_out_pad).double().numpy()
            pos += np.repeat(plan.base.astype(np.float64), kres.BLK)
            pos = pos[: plan.n_out]
            table = pv._segment_table(knots, plan.n_out / sr)
            t = (np.arange(plan.n_out) + 1.0) / sr
            own = pv._src_eval64(table, t, sr)[0]
            k = ref_pv.Knots(ms, sr, n)
            rm = ref_pv.RateMap(k, plan.n_out / sr)
            pr, rr = rm.p_rho(t)
            ref = np.maximum(pr * sr - rr, 0.0)
            t0s = table[0][1:]
            j0 = np.ceil(t0s * sr - 1.0 - 1e-9)
            early = int(np.sum((j0 + 1.0) / sr < t0s))
            print(json.dumps({
                "seed": seed, "request": i, "markers": len(ms),
                "segments": int(len(t0s)), "anchors_early": early,
                "max_gap_vs_own_f64": float(np.abs(pos - own).max()),
                "max_gap_vs_reference": float(np.abs(pos - ref).max()),
                "own_f64_vs_reference": float(np.abs(own - ref).max()),
                "samples_off_by_1e-2": int(np.sum(np.abs(pos - own) > 1e-2)),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
