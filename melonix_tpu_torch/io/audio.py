"""Audio helpers of the port (counterpart of ``melonix_tpu/io/audio.py``;
only the downmix so far)."""

from __future__ import annotations

import numpy as np


def downmix_mono(x: np.ndarray) -> np.ndarray:
    """Channel downmix: mean across channels (libswresample's default
    stereo→mono matrix is 0.5/0.5, app.cpp:669-684)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        return x.mean(axis=1).astype(np.float32)
    return x
