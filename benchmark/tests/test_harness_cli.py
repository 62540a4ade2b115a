"""The command line: no card, no result; no JAX loaded; a checkout without
the program fails; and, on a card, every cell once."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import core

from . import tiny
from .conftest import ROOT

RUN = ["benchmark/run.py", "--seed", "2147483653", "--seconds", "1",
       "--trace", "0"]


def cells():
    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def env():
    e = dict(os.environ)
    e.pop("PYTHONPATH", None)
    return e


def test_no_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot run here")
    p = subprocess.run([sys.executable] + RUN[:1] + ["--workload",
                                                      cells()[0]] + RUN[1:],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=env())
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "melonix_tpu_torch_extra",
                        types.ModuleType("melonix_tpu_torch_extra"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "melonix_tpu.engine",
                        types.ModuleType("melonix_tpu.engine"))
    assert core.forbidden_modules() == ["jax.numpy", "melonix_tpu.engine"]


def test_a_run_loads_no_jax():
    """A whole CPU run of every cell in a fresh process leaves no module
    named jax, jaxlib, flax or melonix_tpu (compared whole), and its
    result is printed; then a run whose comparison loads a module named
    jax prints no result: the look comes after the check."""
    code = (
        "import sys, types\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.harness import core\n"
        "from benchmark.harness.manifest import Manifest\n"
        f"for c in {cells()!r}:\n"
        "    r = tiny.run(c, trace=True)\n"
        "    assert r['correct'] and core.finish(r) == 0\n"
        "print(core.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "m = Manifest(tiny.ROOT)\n"
        f"cell = {cells()[0]!r}\n"
        "kind = m.request_kind(m.traffic(m.cell(cell)['traffic'])['request'])\n"
        "check = kind.Workload.check\n"
        "def loads_jax(self, kept):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return check(self, kept)\n"
        "kind.Workload.check = loads_jax\n"
        "r = tiny.run(cell)\n"
        "sys.stdout.flush()\n"
        "print('rc', core.finish(r))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600, env=env())
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-1] == "rc 4"
    assert "jax" in p.stderr.splitlines()[-1]
    assert lines[-3] == "[]"
    tops = set(eval(lines[-2]))
    assert "melonix_tpu_torch" in tops
    assert not tops & set(core.FORBIDDEN)
    results = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(results) == len(cells())


def test_a_checkout_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: a run cannot import
    the program, exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark.harness import core\n"
        "from benchmark.harness.manifest import Manifest\n"
        "r = core.run_cell(Manifest('.'), sys.argv[1], 5, 0.2, False,\n"
        "                  torch.device('cpu'), time.perf_counter(),\n"
        "                  overrides={'config': {'seconds': 4.0}})\n"
        "core.report(r)\n")
    p = subprocess.run([sys.executable, "-c", code, cells()[0]],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env())
    assert p.returncode != 0
    assert "melonix_tpu_torch" in p.stderr
    assert "{" not in p.stdout
    q = subprocess.run([sys.executable] + RUN[:1] + ["--workload",
                                                      cells()[0]] + RUN[1:],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env())
    assert q.returncode != 0 and "{" not in q.stdout


@pytest.mark.chip
def test_every_cell_on_the_card():
    """On a card: each cell once, a short window, traced and not."""
    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA card")
    for cell in cells():
        for trace in ("0", "1"):
            p = subprocess.run(
                [sys.executable, "benchmark/run.py", "--workload", cell,
                 "--seed", "2147483659", "--seconds", "2", "--trace", trace],
                cwd=ROOT, capture_output=True, text=True, timeout=1200,
                env=env())
            assert p.returncode == 0, p.stderr[-3000:]
            res = json.loads(p.stdout.strip().splitlines()[-1])
            assert res["correct"], res["checks"]
            assert res["device"]["platform"] == "gpu"
