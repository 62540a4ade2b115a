"""Cold-build times of the port's CUDA kernels, two ways.

    python -m melonix_tpu_torch.kernels.build_times

"parallel" is :func:`_build.build` as the kernels are built at first use:
one ``nvcc -c`` per source, all started together, then one link.  "single"
is one ``nvcc -shared`` over every source, with the same compile flags.
Each build starts from an empty directory under ``build/kernels/``, in the
order single, parallel, parallel, single; the script prints each wall time,
the host's CPU count and the card's ``nvidia-smi`` name and power limit.
It needs ``nvcc`` (the card itself only for the ``nvidia-smi`` line).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from . import _build


def single(out_dir: Path) -> None:
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
           "-o", str(out_dir / _build.LIB_NAME),
           *[str(p) for p in _build.sources() if p.suffix == ".cu"]]
    subprocess.run(cmd, check=True, capture_output=True)


def parallel(out_dir: Path) -> None:
    saved = _build.BUILD_DIR
    _build.BUILD_DIR = out_dir
    try:
        _build.build()
    finally:
        _build.BUILD_DIR = saved


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "no nvidia-smi"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times: dict[str, list[float]] = {"single": [], "parallel": []}
    for name in ("single", "parallel", "parallel", "single"):
        out_dir = Path(tempfile.mkdtemp(prefix="timing.", dir=_build.BUILD_DIR))
        try:
            t0 = time.perf_counter()
            (single if name == "single" else parallel)(out_dir)
            times[name].append(time.perf_counter() - t0)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        print(f"{name}: cold build {times[name][-1]:.2f} s | "
              f"{os.cpu_count()} CPUs | {card}", flush=True)
    print(json.dumps({"build_s": times, "cpus": os.cpu_count(),
                      "sources": len([p for p in _build.sources()
                                      if p.suffix == ".cu"]),
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
