"""Spectrogram colormap (reference: spec-cache.cpp:79-96).

v = clamp(mag * k, 0, 255); three ranges:
  v <  85          → (v, 0, 0)                        (dim red)
  85 <= v < 170    → quarter-circle arc red→green:
                     a = (v-85)/85 * π/2, (v·cos a, v·sin a, 0)
  v >= 170         → (w, v, w) with w = (v-170)*3     (green → white)

k comes from the brightness slider: 2^(brightness/10 + 9) (app.cpp:75).
A NumPy version (host tiles, the 256-entry LUT) and a torch version (on the
device of its input), counterparts of ``melonix_tpu/ui/colormap.py``.
"""

from __future__ import annotations

import numpy as np
import torch

_PI = 3.141592  # the reference's literal (spec-cache.cpp:86), not M_PI


def colormap_np(mags: np.ndarray, k: float) -> np.ndarray:
    """float32 magnitudes (...,) → uint8 RGB (..., 3)."""
    v = np.clip(np.float32(mags) * np.float32(k), 0.0, 255.0)
    a = (v - 85.0) / 85.0 * (_PI / 2.0)
    r = np.where(v < 85.0, v, np.where(v < 170.0, v * np.cos(a), (v - 170.0) * 3.0))
    g = np.where(v < 85.0, 0.0, np.where(v < 170.0, v * np.sin(a), v))
    b = np.where(v < 170.0, 0.0, (v - 170.0) * 3.0)
    out = np.stack([r, g, b], axis=-1)
    return out.astype(np.uint8)  # C-cast truncation parity


def colormap_lut() -> np.ndarray:
    """(256, 3) uint8 LUT: ``LUT[v] = colormap(v)`` at integer v.

    The tile pipeline downloads the uint8 VALUE plane (1 byte/texel) and
    colormaps on the host through this table (v is quantized to 256 levels
    before the arcs; <= 3/255 per-component deviation from the float-v
    reference formula, PARITY.md).
    """
    return colormap_np(np.arange(256, dtype=np.float32), 1.0)


def colormap_torch(mags: torch.Tensor, k) -> torch.Tensor:
    """float32 magnitudes (...,) → uint8 RGB (..., 3), on ``mags``' device
    (the counterpart of ``colormap_jax``)."""
    v = torch.clamp(mags.to(torch.float32) * float(np.float32(k)), 0.0, 255.0)
    a = (v - 85.0) / 85.0 * (_PI / 2.0)
    r = torch.where(v < 85.0, v,
                    torch.where(v < 170.0, v * torch.cos(a), (v - 170.0) * 3.0))
    g = torch.where(v < 85.0, 0.0, torch.where(v < 170.0, v * torch.sin(a), v))
    b = torch.where(v < 170.0, 0.0, (v - 170.0) * 3.0)
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)
