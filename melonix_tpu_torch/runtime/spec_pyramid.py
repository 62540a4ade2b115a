"""Device-resident multi-resolution spectrogram pyramid (BASELINE config #2).

Counterpart of ``melonix_tpu/runtime/spec_pyramid.py``.  The reference
computes every visible column on demand with a fresh 32768-pt DFT
(spec.cpp:44-66); the pyramid computes |STFT| once at file open at the base
hop (``stft_mags_device``: B1 at 2048 points, B12 at the other sizes), and
coarser levels (hop_l = base_hop * 2^l) are pairwise maxima over the frame
axis, with no further FFTs.  Max-pooling keeps transients visible at any
zoom.  After the build any viewport at any zoom is a gather: pick the level
whose hop matches the samples per pixel, index frames.

``compute_columns`` speaks the TileServer ``compute`` protocol:
``TileServer(wav, compute=pyramid.compute_columns, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..engine.spectral import (hann_window, num_frames, stft_mags_device,
                               track_on_device)


def _max_pool_frames(mags: torch.Tensor) -> torch.Tensor:
    """Pairwise max over the frame axis (pad odd tails with the last frame)."""
    if mags.shape[0] % 2:
        mags = torch.cat([mags, mags[-1:]], dim=0)
    return torch.maximum(mags[0::2], mags[1::2])


class SpecPyramid:
    """Device-resident |STFT| levels + zoom-aware column lookup.

    ``wav`` is a NumPy array (put on ``device``, default ``"cuda"``, no
    fallback) or a tensor (kept on its own device).
    """

    def __init__(
        self,
        wav,
        *,
        config: Config = DEFAULT_CONFIG,
        size: int | None = None,
        base_hop: int | None = None,
        min_frames: int = 64,
        device=None,
    ):
        self.config = config
        self.size = size or config.stft_size
        self.base_hop = base_hop or config.stft_hop
        wav_dev = track_on_device(wav, device)
        self.device = wav_dev.device
        self.n_samples = int(wav_dev.shape[0])
        win = torch.from_numpy(hann_window(self.size)).to(self.device)
        nf = num_frames(self.n_samples, self.size, self.base_hop)
        levels = [stft_mags_device(wav_dev, win, self.size, self.base_hop, nf)]
        while levels[-1].shape[0] > min_frames:
            levels.append(_max_pool_frames(levels[-1]))
        self.hops: list[int] = [self.base_hop * 2 ** i
                                for i in range(len(levels))]
        # One flat (sum_frames, n_bins) array, one gather for every level;
        # the per-level arrays are not kept (that would double the memory).
        self._flat = torch.cat(levels, dim=0)
        self._level_shapes = [tuple(lv.shape) for lv in levels]
        self._offsets = np.concatenate(
            [[0], np.cumsum([s[0] for s in self._level_shapes])]
        ).astype(np.int64)
        del levels

    @property
    def levels(self) -> list[torch.Tensor]:
        """Per-level views of the flat array."""
        return [
            self._flat[self._offsets[i] : self._offsets[i + 1]]
            for i in range(len(self._level_shapes))
        ]

    @property
    def n_bins(self) -> int:
        return self.size // 2

    def nbytes(self) -> int:
        return sum(int(np.prod(s)) * 4 for s in self._level_shapes)

    def level_for(self, samples_per_px: float) -> int:
        """Finest level whose hop does not oversample the request."""
        lvl = 0
        while lvl + 1 < len(self.hops) and self.hops[lvl + 1] <= samples_per_px:
            lvl += 1
        return lvl

    def compute_columns(self, starts, ends) -> np.ndarray:
        """TileServer ``compute`` protocol: (B,) ranges → (B, n_bins) mags.

        Each column [start, end) picks the level matching its width and the
        frame whose window end is nearest the column end (end-anchored like
        spec.cpp:47, modulo the Hann frame convention).
        """
        starts = np.asarray(starts, np.int64)
        ends = np.asarray(ends, np.int64)
        spp = np.maximum(ends - starts, 1)
        lvls = np.array([self.level_for(float(s)) for s in spp])
        hops = np.asarray(self.hops, np.int64)[lvls]
        frame_idx = np.maximum((ends - self.size) // hops, 0)
        n_level = self._offsets[lvls + 1] - self._offsets[lvls]
        flat_idx = self._offsets[lvls] + np.minimum(frame_idx, n_level - 1)
        idx = torch.from_numpy(flat_idx).to(self.device)
        got = self._flat[idx.clamp(0, self._flat.shape[0] - 1)].cpu().numpy()
        # The reference columns' working range is |X|/N with an untapered
        # window (A/2 for a unit sine); Hann's coherent gain is 1/2, so 2/N.
        return got * np.float32(2.0 / self.size)
