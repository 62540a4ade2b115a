"""Hann STFT of the phase-vocoder and pitch engines (2048-pt, hop 512).

Counterpart of the STFT half of ``melonix_tpu/engine/spectral.py``.  The
fused |STFT| (:func:`stft_mags_device`) runs kernel B1 on a CUDA tensor and
its plain twin on a CPU tensor; :func:`stft_device` is the plain complex
STFT.  The 32768-point reference columns and the iSTFT are not ported yet
(ROADMAP queue A items 3 and 7).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import pv as kpv


def hann_window(size: int, periodic: bool = True) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    denom = size if periodic else size - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(np.float32)


def num_frames(n_samples: int, size: int, hop: int) -> int:
    if n_samples < size:
        return 1
    return 1 + (n_samples - size) // hop


def stft_device(wav: torch.Tensor, window: torch.Tensor, size: int, hop: int,
                n_frames: int) -> torch.Tensor:
    """One-shot STFT: (n_frames, size // 2 + 1) complex64, frames at
    ``hop * i`` (no centering), zeros past the end."""
    frames = kpv.hop_frames(wav, size, hop, n_frames)
    return torch.fft.rfft(frames * window[None, :])


def stft_mags_device(wav: torch.Tensor, window: torch.Tensor, size: int,
                     hop: int, n_frames: int, scale: float = 1.0
                     ) -> torch.Tensor:
    """Fused ``|STFT|`` of the first size//2 bins: (n_frames, size//2) f32,
    on the device of ``wav`` (B1 on CUDA, the plain twin on CPU)."""
    return kpv.stft_mag(wav, window, size, hop, n_frames, scale=scale)
