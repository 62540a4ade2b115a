"""Randomized oracle-parity fuzz of the port's granular export: the cases of
``tests/test_fuzz_parity.py`` (its 8 random marker seeds and its 4
degenerate marker sets: a marker at sample 0, two markers on one sample, a
marker on the last sample, a time reversal) through melonix_tpu_torch's
CPU ``render_track`` against the literal NumPy transcription of the
reference C++ (``tests/oracle.py``).

The port rounds every float32 operation on its own, as the oracle does, so
the bar is exact equality in length and in every sample (the JAX suite's
2e-6 is the distance of JAX's fused multiply-adds, which the port does not
take).  The generators are those of ``test_fuzz_parity.py``, drawing from
the same seeds in the same order, so the cases are the same.
"""

import numpy as np
import pytest
import torch

import oracle
from melonix_tpu_torch.engine.grains import build_grain_table
from melonix_tpu_torch.engine.maps import MapKnots
from melonix_tpu_torch.engine.render import render_track
from melonix_tpu_torch.markers import Marker, sort_markers

torch.set_num_threads(2)

SR = 8000


def _signal(rng, seconds=0.8):
    t = np.arange(int(SR * seconds)) / SR
    x = 0.5 * np.sin(2 * np.pi * (150 + 80 * rng.random()) * t)
    x += 0.2 * np.sin(2 * np.pi * (300 + 200 * rng.random()) * t + rng.random())
    x += 0.02 * rng.standard_normal(len(t))
    return x.astype(np.float32)


def _random_markers(rng, n_samples):
    configs = []
    for _ in range(rng.integers(0, 5)):
        configs.append(
            Marker(
                sample=int(rng.integers(0, n_samples)),
                note=float(rng.uniform(30, 80)),
                d_time=float(rng.uniform(-0.08, 0.12)),
                pitch_bend=float(rng.uniform(-7, 7)),
            )
        )
    return sort_markers(configs)


def _edge_cases(n):
    return [
        [Marker(0, 50.0, 0.05, 2.0)],
        [Marker(n // 2, 50.0, 0.0, 0.0), Marker(n // 2, 55.0, 0.02, -1.0)],
        [Marker(n - 1, 50.0, 0.1, 3.0)],
        [Marker(n // 3, 50.0, -0.2, 1.0), Marker(2 * n // 3, 50.0, 0.15, -2.0)],
    ]


def _assert_oracle_exact(x, markers, what):
    table = build_grain_table(x)
    knots = MapKnots.from_markers(markers, SR, len(x))
    got = render_track(x, table, knots, device="cpu")
    want = oracle.export(
        x,
        list(zip(table.starts.tolist(), table.lengths.tolist())),
        [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers],
        SR,
    )
    assert len(got) == len(want), (what, len(got), len(want))
    assert got.dtype == np.float32
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (what, bad[:8], float(np.abs(got - want).max()))


@pytest.mark.parametrize("seed", range(8))
def test_render_matches_oracle_fuzz(seed):
    rng = np.random.default_rng(1000 + seed)
    x = _signal(rng)
    _assert_oracle_exact(x, _random_markers(rng, len(x)), f"seed {seed}")


@pytest.mark.parametrize("case", range(4), ids=[
    "at-sample-0", "two-on-one-sample", "on-the-last-sample",
    "time-reversal"])
def test_render_matches_oracle_edge_markers(case):
    x = _signal(np.random.default_rng(77))
    ms = sort_markers(_edge_cases(len(x))[case])
    _assert_oracle_exact(x, ms, f"case {case}")
