#!/usr/bin/env python3
"""The CLI's ``batch`` in one process on one card against ``batch``
launched over every visible card, end to end, at several fleet sizes.

    python3 batch_fleet.py [--files 32,256,1024] [--engines pv,granular]
                           [--seconds 20] [--big-only pv]

Writes the largest fleet of takes (``--seconds`` slices of
``chip_smoke.py``'s 180 s song at seeded offsets, float32 WAV) and the
first four of the bench's markers to a temporary directory, builds the
kernels and the native library once, then for each engine and fleet size
times two fresh processes, each from its start to its exit:

* one: ``python -m melonix_tpu_torch batch TAKES --markers M -o OUT
  --engine E --device cuda:0``, one process on one card;
* every: ``parallel.launch`` of the same ``batch`` with ``--device cuda``
  over every visible card (one NCCL rank a card, rank 0 writes).

The two run in turns whose order alternates from size to size.  Every
file of ``every`` is held to the same file of ``one`` (granular within one
int16 step, PV at SNR < -60 dB).  It prints each wall with the CLI's own
time (``batch: ... in T s``: from the first decode to the last write) and,
per engine and mode, the line through the walls (start-up plus seconds a
file), the fleet size above which ``every`` finishes first, and one JSON
line, beside the cards' ``nvidia-smi`` names and power limits.  Sizes above
the first two run only for the engines of ``--big-only``.  It imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def fit(points) -> tuple[float, float]:
    """(intercept s, slope s a file) of the least-squares line."""
    f = np.asarray([p[0] for p in points], np.float64)
    w = np.asarray([p[1] for p in points], np.float64)
    slope, icpt = np.polyfit(f, w, 1)
    return float(icpt), float(slope)


def run(cmd, env) -> tuple[float, float | None, str]:
    """(wall s, the CLI's own ``in T s`` or None, output) of one process."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{cmd[:4]} exited {proc.returncode}:\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    m = re.search(r"^batch: .* in ([0-9.]+)s ->", proc.stdout, re.M)
    return wall, float(m.group(1)) if m else None, proc.stdout


def same_files(a: str, b: str, engine: str, read_wav) -> tuple[int, float]:
    """(files compared, worst: max |diff| in int16 steps for granular, SNR
    dB for PV); raises when a file is missing or fails its bar."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        raise SystemExit(f"file sets differ: {len(names)} vs "
                         f"{len(os.listdir(b))}")
    worst = -np.inf
    for n in names:
        x, _r = read_wav(os.path.join(a, n))
        y, _r = read_wav(os.path.join(b, n))
        if x.shape != y.shape:
            raise SystemExit(f"{n}: shapes {x.shape} vs {y.shape}")
        x = x.astype(np.float64)
        y = y.astype(np.float64)
        if engine == "granular":
            v = float(np.abs(x - y).max()) * 32767
            ok = v <= 1.01
        else:
            v = float(10 * np.log10(max(np.sum((x - y) ** 2), 1e-300)
                                    / max(np.sum(y ** 2), 1e-300)))
            ok = v < -60.0
        if not ok:
            raise SystemExit(f"{n} ({engine}): {v} past its bar")
        worst = max(worst, v)
    return len(names), worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", default="32,256,1024")
    ap.add_argument("--engines", default="pv,granular")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--big-only", default="pv")
    a = ap.parse_args(argv)
    sizes = [int(v) for v in a.files.split(",")]
    engines = a.engines.split(",")
    big = set(a.big_only.split(","))

    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.io.wav import read_wav
    from melonix_tpu_torch.parallel.launch import build_once

    if not torch.cuda.is_available():
        raise SystemExit("batch_fleet.py needs a card")
    n_cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(f"cards: {n_cards}: " + "; ".join(smi), flush=True)

    t0 = time.perf_counter()
    build_once("cuda")
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    env = dict(os.environ, PYTHONPATH=HERE)
    res: dict = {"cards": n_cards, "card": card, "seconds": a.seconds,
                 "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        song = cs.make_song(cs.SR, cs.SECONDS)
        take = int(a.seconds * cs.SR)
        offs = np.random.default_rng(7).integers(0, len(song) - take,
                                                 max(sizes))
        takes = os.path.join(tmp, "takes")
        os.makedirs(takes)
        for i, o in enumerate(offs):
            mt.write_wav(os.path.join(takes, f"take{i:04d}.wav"),
                         song[o : o + take], cs.SR, dtype="float32")
        mjson = os.path.join(tmp, "m.json")
        with open(mjson, "w") as f:
            f.write(mt.markers_to_json(cs.bench_markers(mt, take)[:4]))
        turn = 0
        for engine in engines:
            for k, n_files in enumerate(sizes):
                if k >= 2 and engine not in big:
                    continue
                # the first n_files takes, through a directory of links
                fleet = os.path.join(tmp, f"fleet{n_files}")
                if not os.path.isdir(fleet):
                    os.makedirs(fleet)
                    for i in range(n_files):
                        name = f"take{i:04d}.wav"
                        os.symlink(os.path.join(takes, name),
                                   os.path.join(fleet, name))
                base = ["batch", os.path.join(fleet, "*.wav"), "--markers",
                        mjson, "--engine", engine]
                outs = {m: os.path.join(tmp, f"out_{m}") for m in
                        ("one", "every")}
                every = base + ["-o", outs["every"], "--device", "cuda"]
                cmds = {
                    "one": [sys.executable, "-m", "melonix_tpu_torch", *base,
                            "-o", outs["one"], "--device", "cuda:0"],
                    "every": [sys.executable, "-c",
                              "import sys; from melonix_tpu_torch.parallel."
                              "launch import launch; sys.exit(launch("
                              f"{every!r}, {n_cards}))"]}
                order = ("one", "every") if turn % 2 == 0 else ("every",
                                                                "one")
                turn += 1
                got = {}
                for mode in order:
                    wall, own, _out = run(cmds[mode], env)
                    got[mode] = (wall, own)
                    print(f"{engine} {n_files} files, {mode}: wall "
                          f"{wall:.3f} s, the CLI's own {own} s | {card}",
                          flush=True)
                n_cmp, worst = same_files(outs["every"], outs["one"], engine,
                                          read_wav)
                print(f"     every vs one: {n_cmp} files, worst "
                      f"{'int16 steps' if engine == 'granular' else 'SNR dB'}"
                      f" {worst:.3f}", flush=True)
                for m in outs.values():
                    shutil.rmtree(m)
                res["runs"].append({
                    "engine": engine, "files": n_files,
                    "one_s": got["one"][0], "one_own_s": got["one"][1],
                    "every_s": got["every"][0],
                    "every_own_s": got["every"][1], "worst": worst})
    for engine in engines:
        rows = [r for r in res["runs"] if r["engine"] == engine]
        lines = {m: fit([(r["files"], r[f"{m}_s"]) for r in rows])
                 for m in ("one", "every")}
        (a1, b1), (a4, b4) = lines["one"], lines["every"]
        even = (a4 - a1) / (b1 - b4) if b1 > b4 else float("inf")
        res[f"{engine}_fit"] = {"one": lines["one"], "every": lines["every"],
                                "break_even_files": even}
        print(f"{engine}: one process {a1:.3f} s + {b1 * 1e3:.2f} ms a file; "
              f"over {n_cards} cards {a4:.3f} s + {b4 * 1e3:.2f} ms a file; "
              f"the launched batch finishes first above {even:.1f} files | "
              f"{card}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
