"""The metrics read from the program's own spans
(``harness/program_spans.py``): what a CPU run of each cell reads, how
records are given to the window's requests, and that only a traced run
starts the program's recorder."""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark.harness import core
from melonix_tpu_torch.utils import tracing

from . import tiny
from .conftest import ROOT

EDIT = "song_mono44k.edit_render"
PITCH = "song_mono44k.pitch_scan"


@pytest.mark.parametrize("cell, numbers, silent", [
    (EDIT, ("pv_knots_ms", "render_glue_ms"), ()),
    (PITCH, ("pitch_tail_ms",), ("pageable_upload_mb",)),
])
def test_a_traced_cpu_run_reads_the_host_spans_and_no_device_ones(
        cell, numbers, silent):
    res = tiny.run(cell, trace=True)
    assert res["correct"], res["checks"]
    for name in numbers:
        assert res["metrics"][name]["value"] > 0, name
    # a CPU run copies nothing between devices: those metrics read None,
    # and the line leaves them out
    for name in silent:
        assert name not in res["metrics"], name


def bytes_of(rec, recs):
    return rec.counts["bytes"] if rec.counts else None


@pytest.fixture
def program_spans():
    """The helper, imported here: importing it starts the recorder."""
    from benchmark.harness import program_spans

    return program_spans


def test_each_record_goes_to_the_request_that_holds_its_root(program_spans):
    tracing.start()
    with tracing.span("warm-up", bytes=1000):
        pass
    reqs = []
    for i, b in enumerate((10, 30)):
        t0 = time.perf_counter()
        with tracing.span("request"):
            with tracing.span("h2d", bytes=b, pageable=1):
                with tracing.span("inner", bytes=1):
                    pass
        reqs.append(core.Request(i, t0, time.perf_counter(), True))
    with tracing.span("traced window", bytes=5000):
        pass
    view = SimpleNamespace(requests=reqs)
    assert program_spans.per_request(view, bytes_of) == (10 + 1 + 30 + 1) / 2
    # no record read: None, not 0
    assert program_spans.per_request(view, lambda r, recs: None) is None
    assert program_spans.per_request(SimpleNamespace(requests=[]),
                                     bytes_of) is None


def test_a_window_the_buffer_could_not_hold_reads_none(program_spans,
                                                       monkeypatch):
    tracing.start()
    monkeypatch.setattr(tracing, "CAPACITY", 2)
    t0 = time.perf_counter()
    for b in (1, 2, 3):
        with tracing.span("h2d", bytes=b):
            pass
    view = SimpleNamespace(requests=[core.Request(0, t0, time.perf_counter(),
                                                  True)])
    assert tracing.dropped() == 1
    assert program_spans.per_request(view, bytes_of) is None
    # records dropped after the window leave it whole
    tracing.start()
    t0 = time.perf_counter()
    with tracing.span("h2d", bytes=4):
        pass
    view = SimpleNamespace(requests=[core.Request(0, t0, time.perf_counter(),
                                                  True)])
    for b in (5, 6):
        with tracing.span("h2d", bytes=b):
            pass
    assert tracing.dropped() == 1
    assert program_spans.per_request(view, bytes_of) == 4


def test_a_program_without_the_recorder_reads_none(program_spans,
                                                     monkeypatch):
    monkeypatch.setattr(program_spans, "RECORDER", None)
    t0 = time.perf_counter()
    view = SimpleNamespace(requests=[core.Request(0, t0, t0 + 1.0, True)])
    assert program_spans.per_request(view, bytes_of) is None


def test_an_untraced_run_leaves_the_recorder_off():
    """In a fresh interpreter, a --trace 0 run of each cell loads no
    metric of the program's spans and starts no recorder."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests import tiny\n"
        f"for c in {[EDIT, PITCH]!r}:\n"
        "    tiny.run(c)\n"
        "from melonix_tpu_torch.utils import tracing\n"
        "print(tracing.enabled(), tracing.records(),\n"
        "      'benchmark.harness.program_spans' in sys.modules)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "False [] False"
