"""A whole run with the timed path broken underneath comes out not
correct: the control (the reference in bfloat16 in the program's place),
and each fault that a cell can have.  The runs skip the harness's look for
a card and drive the rest on the CPU at a small size."""

import numpy as np
import pytest
import torch

from benchmark.harness import faults

from . import tiny

EDIT = "song_mono44k.edit_render"
PITCH = "song_mono44k.pitch_scan"


def wrap(monkeypatch, module, name, after=None, before=None):
    """Replace ``module.name`` by a call of the original whose arguments
    (``before``) or result (``after``) are broken."""
    orig = getattr(module, name)

    def broken(*args, **kwargs):
        if before is not None:
            args, kwargs = before(args, kwargs)
        out = orig(*args, **kwargs)
        return after(out) if after is not None else out

    monkeypatch.setattr(module, name, broken)


@pytest.mark.parametrize("cell", [EDIT, PITCH])
def test_control_is_not_correct(cell):
    res = tiny.run(cell, control=True)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_sound_run_is_correct():
    assert tiny.run(EDIT)["correct"]


def test_render_altered_where_produced(monkeypatch):
    """A token or an answer altered: half a second of the render dropped
    to silence."""
    from melonix_tpu_torch.engine import phase_vocoder as pv

    def hole(out):
        out = out.clone()
        out[len(out) // 2: len(out) // 2 + len(out) // 12] = 0.0
        return out

    wrap(monkeypatch, pv, "render_track_pv", after=hole)
    res = tiny.run(EDIT)
    assert not res["correct"]
    assert res["checks"]["resample_gap"]["value"] > res["checks"][
        "resample_gap"]["limit"]


def test_phase_state_left_unchanged(monkeypatch):
    """A step that returns its state unchanged: the phase vocoder's running
    phase never advances (every increment 0)."""
    from melonix_tpu_torch.kernels import pv as kpv

    wrap(monkeypatch, kpv, "phase_increments", after=torch.zeros_like)
    res = tiny.run(EDIT)
    assert not res["correct"]
    assert res["checks"]["spec_rel"]["value"] > res["checks"]["spec_rel"][
        "limit"]


def test_half_the_frames_left_out(monkeypatch):
    """Half of the batch left out: the second half of the analysis frames
    synthesised from silence."""
    from melonix_tpu_torch.kernels import pv as kpv

    def half(args, kwargs):
        a, b = args[0].clone(), args[1].clone()
        a[a.shape[0] // 2:] = 0.0
        b[b.shape[0] // 2:] = 0.0
        return (a, b) + tuple(args[2:]), kwargs

    wrap(monkeypatch, kpv, "synth_ola_phase", before=half)
    assert not tiny.run(EDIT)["correct"]


def test_positions_a_few_samples_off():
    """An answer altered where it is produced, as a resample anchor with
    the wrong segment's constants alters it: a dozen stretches read up to
    3 samples behind.  Magnitudes barely see it; ``resample_gap`` does."""
    with faults.planted("anchor_drift"):
        res = tiny.run(EDIT)
    c = res["checks"]
    assert not res["correct"]
    assert c["resample_gap"]["value"] > c["resample_gap"]["limit"]
    assert c["spec_rel"]["value"] < c["spec_rel"]["limit"]


# Two rests in the 6 s take, one of each kind (a breath, a silence).
RESTS = {"config": {"seconds": 6.0},
         "traffic": {"rests": {"every_s": 3.0, "length_s": [0.6, 2.0],
                               "fade_s": 0.25, "floor_db": -100.0}}}


@pytest.mark.parametrize("fault", ["voiced_all", "clarity_ignored",
                                   "energy_ignored"])
def test_voicing_decision_broken(fault):
    """The voicing decision broken: every frame voiced, or one of its two
    thresholds ignored, fails ``frame_mismatch`` on takes with rests."""
    assert tiny.run(PITCH, overrides=RESTS)["correct"]
    with faults.planted(fault):
        res = tiny.run(PITCH, overrides=RESTS)
    c = res["checks"]["frame_mismatch"]
    assert not res["correct"] and c["value"] > c["limit"]


def test_pitch_altered_where_produced(monkeypatch):
    """An answer altered: a tenth of the frames' notes a semitone off."""
    from melonix_tpu_torch.engine import pitch

    def sharp(c):
        k = len(c.note) // 10
        c.note[:k] = np.where(c.voiced[:k], c.note[:k] + 1.0, c.note[:k])
        return c

    wrap(monkeypatch, pitch, "pitch_curve", after=sharp)
    res = tiny.run(PITCH)
    assert not res["correct"]


def test_pitch_half_the_frames_left_out(monkeypatch):
    """Half of the batch left out: the second half of the frames come back
    with no clarity, so unvoiced."""
    from melonix_tpu_torch.engine import pitch

    def half(out):
        lag, clarity, energy = out
        clarity = clarity.clone()
        clarity[clarity.shape[0] // 2:] = 0.0
        return lag, clarity, energy

    wrap(monkeypatch, pitch, "_pitch_device", after=half)
    assert not tiny.run(PITCH)["correct"]


def test_a_failing_request_is_not_correct(monkeypatch):
    """An answer that never comes: every request raises."""
    from melonix_tpu_torch.engine import pitch

    calls = {"n": 0}
    orig = pitch.pitch_curve

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > 1:  # the warm-up passes
            raise RuntimeError("lost")
        return orig(*args, **kwargs)

    monkeypatch.setattr(pitch, "pitch_curve", flaky)
    res = tiny.run(PITCH)
    assert res["failed"] == res["attempted"] >= 1 and not res["correct"]
