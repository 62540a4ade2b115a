"""The manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists configurations,
cells and metrics.  Everything else is found by name under the benchmark's
folder, so that a later change adds a cell or a metric by adding files and
entries, never by editing a file that is there:

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``request`` names the
  request kind, ``requests/<request>.py``;
- a cell's limits for its correctness numbers: ``limits/<cell>.json``;
- a metric, end-to-end or per-layer: ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file loaded by path under its own module name."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    key = f"benchmark_file.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names; ``root`` is the
    checkout's root (the manifest's folder), ``bench`` the benchmark's."""

    def __init__(self, root: Path, bench: Path = BENCH_DIR):
        self.root, self.bench = Path(root), Path(bench)
        self.data = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return load_json(self.root / self.config_entry(name)["file"])

    def traffic(self, name: str) -> dict:
        return load_json(self.bench / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.bench / "limits" / f"{cell}.json")

    def request_kind(self, kind: str):
        return load_module(self.bench / "requests" / f"{kind}.py",
                           f"requests.{kind}")

    def metric_reader(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py",
                           f"metrics.{name}")

    def metrics_for(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (true): those that list it under ``workloads``, and those
        with no ``workloads`` that move a metric the cell reports."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
