"""The seeded generators repeat, and every seed gives the same sizes."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs

SEEDS = (0, 7, 2**31 + 5, -3, 2**70 + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_seed_repeats_and_fits(seed):
    a = inputs.stream_seed(seed, 1, 2)
    assert a == inputs.stream_seed(seed, 1, 2)
    assert 0 <= a < 2**63
    assert a != inputs.stream_seed(seed, 1, 3)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_song_repeats(seed):
    a = inputs.song(8000, 2.0, seed, "cpu")
    b = inputs.song(8000, 2.0, seed, "cpu")
    assert a.dtype == torch.float32 and a.shape == (16000,)
    assert torch.equal(a, b)
    assert not torch.equal(a, inputs.song(8000, 2.0, seed + 1, "cpu"))
    assert not torch.equal(a, inputs.song(8000, 2.0, seed, "cpu", take=1))


REST = {"every_s": 3.0, "length_s": (0.6, 2.0), "fade_s": 0.25,
        "floor_db": -100.0}


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_rests_repeat_and_take_both_kinds(seed):
    a = inputs.song(8000, 6.0, seed, "cpu", rests=REST)
    assert torch.equal(a, inputs.song(8000, 6.0, seed, "cpu", rests=REST))
    g_p, g_n = inputs.rest_gains(8000, 48000, seed, 0, "cpu", **REST)
    assert float(g_p.min()) == pytest.approx(1e-5)
    breath = (g_p < 1e-4) & (g_n == 1.0)
    silence = (g_p < 1e-4) & (g_n < 1e-4)
    assert bool(breath.any()) and bool(silence.any())
    assert 0.05 < float((g_p < 1.0).double().mean()) < 0.7
    # outside the rests the take is the song without them, bit for bit
    out = (g_p == 1.0) & (g_n == 1.0)
    plain = inputs.song(8000, 6.0, seed, "cpu")
    assert torch.equal(plain[out], a[out]) and not torch.equal(plain, a)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_rests_cross_both_voicing_thresholds(seed):
    """The reference finds frames unvoiced by their clarity alone and
    frames unvoiced by their energy alone, beside voiced frames."""
    from benchmark.reference import pitch as ref_pitch

    x = inputs.song(44100, 6.0, seed, "cpu", rests=REST)
    kw = dict(frame=2048, hop=512, fmin=55.0, fmax=1760.0)
    r = ref_pitch.curve(x, 44100, **kw)
    no_clarity = ref_pitch.curve(x, 44100, clarity_threshold=-1.0, **kw)
    no_energy = ref_pitch.curve(x, 44100, energy_threshold=-1.0, **kw)
    assert 0.3 < r["voiced"].mean() < 0.95
    assert (no_clarity["voiced"] & ~r["voiced"]).sum() >= 10
    assert (no_energy["voiced"] & ~r["voiced"]).sum() >= 10


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_melody_repeats(seed):
    x, notes, cents = inputs.melody(8000, 6.0, seed, "cpu", 2)
    y, notes2, cents2 = inputs.melody(8000, 6.0, seed, "cpu", 2)
    assert x.shape == (48000, 2) and torch.equal(x, y)
    assert np.array_equal(notes, notes2) and np.array_equal(cents, cents2)
    assert len(notes) == 4 and np.all(np.abs(cents) >= 20)
    assert not torch.equal(x[:, 0], x[:, 1])


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_marker_forms_repeat_with_fixed_counts(seed):
    a = inputs.edit_markers(inputs.rng(seed, 10, 4), 44100 * 180, 12, 0.25,
                            (0.005, 0.02), (1.0, 4.0))
    b = inputs.edit_markers(inputs.rng(seed, 10, 4), 44100 * 180, 12, 0.25,
                            (0.005, 0.02), (1.0, 4.0))
    assert a == b and len(a) == 12
    assert all(0.005 <= abs(m[2]) <= 0.02 and 1.0 <= abs(m[3]) <= 4.0
               for m in a)
    assert [m[0] for m in a] == sorted(m[0] for m in a)
    notes, cents = inputs.melody_notes(48000, 180.0, seed)
    s = inputs.snap_markers(inputs.rng(seed, 12, 0), 48000, notes, cents,
                            0.2, 0.2, (1.0, 4.0))
    assert len(s) == 120 == len(notes)
    assert s == inputs.snap_markers(inputs.rng(seed, 12, 0), 48000, notes,
                                    cents, 0.2, 0.2, (1.0, 4.0))
