"""BENCHMARK.json against the contract's form, and every file a cell needs
found by name."""

import json
import re
import shutil

import pytest

from benchmark.harness.manifest import Manifest

from . import tiny
from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def test_top_level_form(manifest):
    d = manifest.data
    assert set(d) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
        assert not p.rstrip("/").endswith("_torch")
    assert len(d["command"]) <= 32 and all(line_ok(w) for w in d["command"])
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51


def test_names_units_and_keys(manifest):
    d = manifest.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    cells = {w["name"] for w in d["workloads"]}
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in d["end_to_end"]}


def test_every_cell_reports_enough(manifest):
    for w in manifest.data["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_for(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = manifest.metrics_for(w["name"], True)
        assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_every_cell_finds_its_files(manifest):
    for w in manifest.data["workloads"]:
        cell, config, traffic, kind = tiny.core.load_cell(manifest,
                                                          w["name"])
        assert hasattr(kind, "Workload")
        assert manifest.config_entry(w["config"])["file"].startswith(
            "benchmark/")
        assert config["name"] == w["config"]
        assert set(manifest.limits(w["name"]))
        for trace in (False, True):
            for m in manifest.metrics_for(w["name"], trace):
                assert callable(manifest.metric_reader(m["name"]).read)


def test_config_files_are_unique_and_hold_what_runs(manifest):
    files = [c["file"] for c in manifest.data["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in manifest.data["workloads"]}
    assert used == {c["name"] for c in manifest.data["configs"]}


def test_a_cell_added_as_files_is_found_and_runs(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, each a
    file of its own plus manifest entries: no harness file is edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "song_mono44k.json").read_text())
    cfg.update(name="song_mono44k_short", seconds=5.0)
    (bench / "configs" / "song_mono44k_short.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "edit_render.json").read_text())
    traffic["markers"]["count"] = 3
    (bench / "traffic" / "edit_three.json").write_text(json.dumps(traffic))
    cell = "song_mono44k_short.edit_three"
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(
        json.loads((bench / "limits" / "song_mono44k.edit_render.json")
                   .read_text())))
    (bench / "metrics" / "requests_done.py").write_text(
        '"""requests_done: completed requests in the window."""\n\n\n'
        "def read(view):\n    return len(view.requests)\n")
    data["configs"].append({"name": "song_mono44k_short",
                            "source": "a test", "reduced": ["seconds"],
                            "why": "a test",
                            "file": "benchmark/configs/song_mono44k_short.json"})
    data["workloads"].append({"name": cell, "config": "song_mono44k_short",
                              "traffic": "edit_three", "chips": 1,
                              "why": "a test"})
    data["end_to_end"][1]["workloads"].append(cell)
    for m in data["per_layer"]:
        if m["name"] == "pv_plan_ms":
            m["workloads"].append(cell)
    data["per_layer"].append({"name": "requests_done", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry points",
                              "moves": "render_x_realtime",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(tmp_path, tmp_path / "benchmark")
    res = tiny.run(cell, manifest=man, trace=True, overrides={"traffic": {}})
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_done"]["value"] >= 1
    assert "pv_plan_ms" in res["metrics"]
