"""The numbers that decide ``correct``: an answer against its reference.

Each is a gap that reads 0 for an exact answer and grows with the fault;
a cell's limits file (``limits/<cell>.json``) holds each one's limit.
"""

from __future__ import annotations

import numpy as np
import torch


def audio_gaps(got: torch.Tensor, ref: torch.Tensor, *, size: int = 2048,
               hop: int = 512) -> dict:
    """A rendered track against its reference (1-D, on one device), by
    their Hann STFT magnitudes (float64, ``size`` / ``hop``):
    ``length_diff`` in samples; ``spec_rel``, the rms of the magnitudes'
    difference over the rms of the reference's magnitudes.

    Magnitudes, not samples: a phase vocoder's running phase is chaotic,
    since ``princarg`` near +-pi flips on the last bit and then offsets that
    bin's phase for good, so two sound float computations differ sample by
    sample, in some stretches by the whole signal, while their spectra
    agree to a few percent.  Where the samples land is judged apart
    (:func:`resample_gap`)."""
    n = min(got.shape[0], ref.shape[0])
    dev = ref.device
    win = torch.hann_window(size, periodic=True, dtype=torch.float64,
                            device=dev)

    def mags(x):
        x = x[:n].to(dev, torch.float64)
        if n < size:
            x = torch.nn.functional.pad(x, (0, size - n))
        return torch.stft(x, size, hop, window=win, center=False,
                          return_complex=True).abs()

    r = mags(ref)
    d2 = (mags(got) - r).square_().mean()
    scale = float(torch.sqrt(r.square_().mean()).clamp_min(1e-30))
    del r
    return {"length_diff": abs(int(got.shape[0]) - int(ref.shape[0])),
            "spec_rel": float(torch.sqrt(d2)) / scale}


def resample_gap(got: torch.Tensor, followed: torch.Tensor) -> float:
    """Where the samples land: the largest gap between the render and the
    reference's resample of the program's own stretched signal, over the
    rms of the latter.  Both read the same stretch, so the phase
    vocoder's chaos (see :func:`audio_gaps`) is not in it: what is left
    is the positions of the plan and B4 and B4's interpolation.  A sound
    render reads float32 rounding; positions a few samples off read a
    good part of the signal."""
    n = min(got.shape[0], followed.shape[0])
    if n == 0:
        return 0.0
    f = followed[:n].to(torch.float64)
    gap = (got[:n].to(f.device, torch.float64) - f).abs().max()
    return float(gap) / max(float(f.square().mean().sqrt()), 1e-30)


def pitch_gaps(note: np.ndarray, voiced: np.ndarray, ref: dict,
               tol_st: float = 0.01) -> dict:
    """A pitch curve against its reference: ``frames_diff``, the
    difference in frame counts; ``frame_mismatch``, the share of frames
    voiced on one side only or voiced on both with notes more than
    ``tol_st`` semitones apart."""
    n = min(len(note), len(ref["note"]))
    v, rv = np.asarray(voiced[:n], bool), ref["voiced"][:n]
    far = np.abs(np.asarray(note[:n], np.float64) - ref["note"][:n]) > tol_st
    bad = (v != rv) | (v & rv & far)
    return {"frames_diff": abs(len(note) - len(ref["note"])),
            "frame_mismatch": float(np.mean(bad)) if n else 1.0}


def worst(rows: list[dict]) -> list[tuple[str, float]]:
    """Each number's largest value over the compared answers."""
    return [(k, max(r[k] for r in rows)) for k in rows[0]] if rows else []
