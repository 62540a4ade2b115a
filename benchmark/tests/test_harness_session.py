"""The stereo export cell (``session_stereo48k.formant_export``) on the
CPU twins at the tiny size: a sound run is correct, the control and an
anchor fault on each channel are not, its reference is the plain reference
run on each channel, and each of its per-layer metrics reads None where it
has nothing to read."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import core, faults
from benchmark.harness.manifest import Manifest
from benchmark.reference import pv as ref_pv

from . import tiny
from .conftest import ROOT

CELL = "session_stereo48k.formant_export"
NEW_METRICS = ("formant_roofline", "session_host_ms", "device_idle_pct.export")


@pytest.fixture(scope="module")
def traced():
    return tiny.run(CELL, trace=True)


def test_the_export_is_correct(traced):
    assert traced["correct"], traced["checks"]
    assert traced["failed"] == 0 and traced["attempted"] >= 1
    assert set(traced["checks"]) == {"length_diff", "spec_rel",
                                     "resample_gap"}


def test_the_control_is_not_correct():
    res = tiny.run(CELL, control=True)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_an_anchor_fault_on_each_channel_is_not_correct(monkeypatch):
    """Each channel's render read up to 3 samples behind over a dozen
    stretches, as a resample anchor with the previous segment's slope
    reads it: ``resample_gap`` sees it."""
    from melonix_tpu_torch.engine import session

    orig = session.render_session

    def drifted(*args, **kwargs):
        out = orig(*args, **kwargs)
        cols = [faults.anchor_drift(torch.from_numpy(
            np.ascontiguousarray(out[:, c]))) for c in range(out.shape[1])]
        return torch.stack(cols, dim=1).numpy()

    monkeypatch.setattr(session, "render_session", drifted)
    res = tiny.run(CELL)
    c = res["checks"]["resample_gap"]
    assert not res["correct"] and c["value"] > c["limit"]


def test_the_reference_is_the_plain_reference_on_each_channel():
    man = Manifest(ROOT)
    _cell, config, traffic, kind = core.load_cell(man, CELL, tiny.TINY)
    w = kind.Workload(config, traffic, 7, tiny.CPU)
    assert w.take.shape == (int(48000 * 6.0), 2)
    assert w.take.dtype == np.float32 and isinstance(w.take, np.ndarray)
    ms = w.markers(3)
    assert len(ms) == 4 and all(m[2] == 0.0 for m in ms)
    for c in range(2):
        want = ref_pv.render(torch.from_numpy(w.take[:, c].copy()), ms,
                             48000, size=2048, hop=512, formants=True)
        assert torch.equal(w.reference(3, c), want)
    out = w.request(3)
    assert out.shape == (want.shape[0], 2) and out.dtype == np.float32


def test_new_metrics_read_none_with_nothing_to_read(traced):
    man = Manifest(ROOT)
    # a CPU run: no device times and no device trace, but host spans
    assert "formant_roofline" not in traced["metrics"]
    assert "device_idle_pct.export" not in traced["metrics"]
    assert traced["metrics"]["session_host_ms"]["value"] > 0
    empty = SimpleNamespace(requests=[], spans=None, trace=None)
    for name in NEW_METRICS:
        assert man.metric_reader(name).read(empty) is None, name


def test_formant_work_counts_the_gain():
    from benchmark.harness.manifest import load_module

    m = load_module(ROOT / "benchmark" / "metrics" / "formant_roofline.py",
                    "metrics.formant_roofline")
    assert m.work(16, 1025, 40) == (4 * (2 * 16 * 1025 + 16),
                                     6 * 16 * 1025 * 39)
