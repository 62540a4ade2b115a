"""The plain references against the port's CPU twins at small sizes, and
the references' independence from the program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import compare, inputs
from benchmark.reference import pitch as ref_pitch
from benchmark.reference import pv as ref_pv

from . import tiny

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def test_references_import_nothing_of_the_program():
    for path in sorted(REF_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top in ("__future__", "math", "numpy", "torch"), \
                    f"{path.name} imports {n}"


@pytest.mark.parametrize("cell", ["song_mono44k.edit_render",
                                  "song_mono44k.pitch_scan"])
def test_cell_correct_on_cpu_twins(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("seed", [3, 4])
def test_pv_reference_with_formants_agrees(seed):
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.engine import phase_vocoder as pv

    sr = 48000
    x, _, _ = inputs.melody(sr, 6.0, seed, "cpu", 1)
    x = x[:, 0].contiguous()
    ms = inputs.edit_markers(inputs.rng(seed, 10, 0), len(x), 6, 0.25,
                             (0.005, 0.02), (1.0, 4.0))
    knots = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], sr, len(x))
    got = torch.from_numpy(pv.render_track_pv(x, knots, device="cpu",
                                              preserve_formants=True))
    ref = ref_pv.render(x, ms, sr, size=2048, hop=512, formants=True)
    gaps = compare.audio_gaps(got, ref)
    assert gaps["length_diff"] == 0 and gaps["spec_rel"] < 2e-3


def test_pitch_reference_on_a_tone():
    sr, f0 = 44100, 220.0
    t = torch.arange(sr * 2, dtype=torch.float64) / sr
    x = (0.5 * torch.sin(2 * np.pi * f0 * t)).float()
    r = ref_pitch.curve(x, sr, frame=2048, hop=512, fmin=55.0, fmax=1760.0)
    assert r["voiced"].all()
    assert np.abs(r["note"] - (24 + 12 * np.log2(f0 / 55.0))).max() < 0.05


def test_empty_edit_renders_the_take():
    sr = 8000
    x = inputs.song(sr, 2.0, 1, "cpu")
    y = ref_pv.render(x, [], sr, size=512, hop=128)
    assert abs(y.shape[0] - x.shape[0]) <= 1
    n = min(y.shape[0], x.shape[0]) - 1024
    err = (y[1024:n] - x[1024:n].double()).abs().max()
    assert err < 1e-6
