#!/usr/bin/env python3
"""The granular render's device part of two checkouts, timed in turns on one
NVIDIA GPU.

    python3 granular_turns.py OTHER_ROOT

Runs one process a turn, in the order other, this, this, other; each
imports the ``melonix_tpu_torch`` of its checkout (building its kernels
there at first use), builds the plan of ``chip_smoke.py``'s 180 s song with
its 12 markers, and times on the card, each the median of 5 after a
warm-up:

* the granular kernels on that plan: B5 then B6 (``render_steps``,
  ``compact``) where the checkout has them, else the one kernel
  ``render_granular``; by CUDA events around 10 back-to-back calls, and as
  10 calls captured in one CUDA graph (the device alone);
* ``render_full``, the render's whole device part (uploads, kernels, seam
  fixes), by CUDA events, and the device memory it allocates above its
  inputs (peak).

It prints each turn's numbers and the means of both turns of each
checkout, beside the card's ``nvidia-smi`` name and power limit.  It needs
one GPU and ``nvcc``, and imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(root: str) -> dict:
    """One turn: the numbers of the checkout at ``root``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs  # song, markers and timers (NumPy at import)

    sys.path.insert(0, root)
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.engine import render as grender
    from melonix_tpu_torch.kernels import _build
    from melonix_tpu_torch.kernels import render as krender

    assert os.path.dirname(os.path.dirname(mt.__file__)) == root, mt.__file__
    dev = torch.device("cuda", 0)
    x = cs.make_song(cs.SR, cs.SECONDS)
    n = len(x)
    knots = mt.MapKnots.from_markers(cs.bench_markers(mt, n), cs.SR, n)
    plan = mt.build_render_plan(mt.build_grain_table(x), knots)
    total = plan.total_out
    fix_idx, fix_val = grender.seam_fixes(plan, x, total)
    _gmax, szmax = krender._buckets(plan)
    offs = plan.out_offset[:-1]
    a0, cnt, _kmax = krender.compact_blocks(offs, -(-total // krender.CBLK))
    wav = torch.from_numpy(x).to(dev)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    gs, rate, sz = (put(plan.grain_start, np.int32),
                    put(plan.rate, np.float32), put(plan.sz, np.int32))
    off, a0_d, cnt_d = put(offs, np.int32), put(a0, np.int32), put(cnt, np.int32)
    if hasattr(krender, "render_granular"):
        route = "render_granular"

        def kernels():
            return krender.render_granular(wav, gs, rate, sz, off, a0_d,
                                           cnt_d, total, szmax)
    else:
        route = "render_steps + compact"

        def kernels():
            return krender.compact(krender.render_steps(wav, gs, rate, sz,
                                                        szmax),
                                   off, a0_d, cnt_d, total)

    _build.library()
    full_args = (wav, plan.grain_start, plan.rate, plan.sz, offs, total,
                 fix_idx, fix_val, szmax)
    kernels_ms = cs.cuda_ms(kernels, inner=cs.KERNEL_INNER)
    device_ms = cs.graph_ms(kernels)
    full_ms = cs.cuda_ms(lambda: krender.render_full(*full_args))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    krender.render_full(*full_args)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    return dict(root=root, route=route, steps=plan.n_steps, samples=total,
                kernels_ms=kernels_ms, device_ms=device_ms,
                render_full_ms=full_ms, render_full_peak_mb=peak_mb)


def run_turns(script: str, other_root: str, label) -> tuple[str, dict]:
    """Run ``script --worker ROOT`` once a turn, other, this, this, other
    (this being ``script``'s own checkout), print each turn as ``label(side,
    turn)`` beside the card, and return (the card's ``nvidia-smi`` name and
    power limit, {side: [turn, turn]}); None for a turn that failed, after
    printing its output."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    roots = {"other": os.path.abspath(other_root),
             "this": os.path.dirname(os.path.abspath(script))}
    got: dict[str, list[dict]] = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, os.path.abspath(script), "--worker", roots[side]],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return card, None
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        got[side].append(turn)
        print(f"{label(side, turn)} | {card}", flush=True)
    return card, got


KEYS = ("kernels_ms", "device_ms", "render_full_ms", "render_full_peak_mb")


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(os.path.abspath(argv[1]))))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    card, got = run_turns(__file__, argv[0], lambda side, turn: (
        f"{side} ({turn['route']}): "
        + ", ".join(f"{k} {turn[k]:.4f}" for k in KEYS)))
    if got is None:
        return 1
    for side, turns in got.items():
        mean = {k: sum(t[k] for t in turns) / len(turns) for k in KEYS}
        print(f"{side} mean of two turns ({turns[0]['route']}, "
              f"{turns[0]['steps']} steps, {turns[0]['samples']} samples): "
              + ", ".join(f"{k} {v:.4f}" for k, v in mean.items())
              + f" | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
