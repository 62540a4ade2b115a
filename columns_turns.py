#!/usr/bin/env python3
"""B7 in two checkouts, timed in turns on one NVIDIA GPU.

    python3 columns_turns.py OTHER_ROOT

Runs one process a turn, in the order other, this, this, other; each
imports the ``melonix_tpu_torch`` of its checkout (building its kernels
there at first use) and times ``spectrogram_columns_fused`` (magnitudes) on
columns of ``chip_smoke.py``'s 180 s song: 256 columns (a tile drain) at
8192, 24,576 and 48,128 points, and 64 columns at 50,176, 57,344 and
64,512 points as its phase 19 lays them out: CUDA events around 10
back-to-back calls, the median of 5 after a warm-up.  Each turn names the
route its checkout takes (``kcols.route``).  It prints each turn's times and the
means of both turns of each checkout, beside the card's ``nvidia-smi`` name
and power limit.  It needs one GPU and ``nvcc``, and imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

from granular_turns import run_turns

HERE = os.path.dirname(os.path.abspath(__file__))
# (size, columns)
CASES = ((8192, 256), (24576, 256), (48128, 256), (50176, 64), (57344, 64),
         (64512, 64))
SPAN = 882  # chip_smoke.py's 20 ms columns at 44.1 kHz


def worker(root: str) -> dict:
    """One turn: the times of the checkout at ``root``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the song and the timers (NumPy at import)

    sys.path.insert(0, root)
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.kernels import columns as kcols

    assert os.path.dirname(os.path.dirname(mt.__file__)) == root, mt.__file__
    dev = torch.device("cuda", 0)
    x = cs.make_song(cs.SR, cs.SECONDS)
    wav = torch.from_numpy(x).to(dev)
    got = {}
    for size, cols in CASES:
        ends_np = np.linspace(size // 2, len(x) - 1, cols).astype(np.int32)
        ends = torch.from_numpy(ends_np).to(dev)
        starts = ends - SPAN
        got[f"{size} {kcols.route(size)}"] = cs.cuda_ms(
            lambda: kcols.spectrogram_columns_fused(  # noqa: B023
                wav, starts, ends, 1.0, size=size, colormap=False),
            inner=cs.KERNEL_INNER)
    return got


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(os.path.abspath(argv[1]))))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    card, got = run_turns(__file__, argv[0], lambda side, turn: (
        f"{side}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in turn.items())))
    if got is None:
        return 1
    for side, turns in got.items():
        print(f"{side} mean of two turns: " + ", ".join(
            f"{k} {sum(t[k] for t in turns) / len(turns):.4f} ms"
            for k in turns[0]) + f" | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
