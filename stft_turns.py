#!/usr/bin/env python3
"""B12's four-step route and Bluestein columns in two checkouts, timed in
turns on one NVIDIA GPU.

    python3 stft_turns.py OTHER_ROOT

Runs one process a turn, in the order other, this, this, other; each
imports the ``melonix_tpu_torch`` of its checkout (building its kernels
there at first use) and times ``kstft.stft_mag`` on ``chip_smoke.py``'s
180 s song: over every frame of the song 1536/384, 24,576/3,072 and
48,640/9,728 (the frame tile) and the four-step route at 98,304/12,288,
131,072/16,384 and 1,048,576/131,072; at 512 x 12,287 (N2 =
49,148, m = 12,287) over 2 frames at a quarter-size hop, as phase 19 lays
them out: CUDA events around 10 back-to-back calls, the median of 5 after a
warm-up; and the columns above N2 = 32,768 at 512 x 32,771 (2 frames) at
one call a rep.  Each turn names the route its checkout takes
(``kstft.route``).  It prints each turn's times and the means of both
turns of each checkout, beside the card's ``nvidia-smi`` name and power
limit.  It needs one GPU and ``nvcc``, and imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

from granular_turns import run_turns

HERE = os.path.dirname(os.path.abspath(__file__))
# (size, hop or None for a quarter-size hop over 2 frames, inner calls)
CASES = ((1536, 384, 10), (24576, 3072, 10), (48640, 9728, 10),
         (98304, 12288, 10), (131072, 16384, 10),
         (1 << 20, 131072, 10),
         (512 * 12287, None, 10), (512 * 32771, None, 1))


def worker(root: str) -> dict:
    """One turn: the times of the checkout at ``root``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the song and the timers (NumPy at import)

    sys.path.insert(0, root)
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.engine.spectral import hann_window, num_frames
    from melonix_tpu_torch.kernels import stft as kstft

    assert os.path.dirname(os.path.dirname(mt.__file__)) == root, mt.__file__
    dev = torch.device("cuda", 0)
    x = cs.make_song(cs.SR, cs.SECONDS)
    wav = torch.from_numpy(x).to(dev)
    got = {}
    for size, hop, inner in CASES:
        if hop is None:
            hop, nf = size // 4, 2
        else:
            nf = num_frames(len(x), size, hop)
        win = torch.from_numpy(hann_window(size).astype(np.float32)).to(dev)
        got[f"{size} {kstft.route(size)}"] = cs.cuda_ms(
            lambda: kstft.stft_mag(wav, win, size, hop, nf),  # noqa: B023
            inner=inner)
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
