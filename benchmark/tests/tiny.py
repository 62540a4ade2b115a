"""Small sizes at which a CPU test drives a whole run of a cell."""

import time

import torch

from benchmark.harness import core
from benchmark.harness.manifest import Manifest

from .conftest import ROOT

# A 6 s take and a short window: the program's plain twins and the
# reference both run in about a second on the CPU.
TINY = {"config": {"seconds": 6.0}}
CPU = torch.device("cpu")


def run(cell: str, *, seed: int = 20_000_000_001, seconds: float = 0.3,
        trace: bool = False, control: bool = False, manifest=None,
        overrides=None) -> dict:
    """One run of ``cell`` on the CPU at the tiny size."""
    return core.run_cell(manifest or Manifest(ROOT), cell, seed, seconds,
                         trace, CPU, time.perf_counter(),
                         overrides=overrides or TINY, control=control)
