"""Grain segmentation: splice-safe grain table from zero crossings
(counterpart of ``melonix_tpu/engine/grains.py``).

The reference splits the track into grains at negative→positive zero
crossings (app.cpp:153-235): the primary search probes alternating ±offsets
around ``start + preferred_grain_size`` for a crossing where ``look_around``
samples before are < 0 and after are >= 0 (app.cpp:163-193, look_around=7);
if none is found within ±(preferred/2 - 1), a fallback scans linearly from
``start + 1.5 * preferred`` with look_around=3 (app.cpp:194-231).

The O(N·look) crossing *masks* are elementwise reductions (NumPy on the
host, or plain torch on a tensor's device: ``zero_crossing_mask_torch``);
the sequential chain "next start depends on previous grain end" is a tiny
loop over ~N/1500 steps on the host (NumPy, or the native C++ runtime,
``runtime/native.py``, which does masks and chain in one pass).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config


@dataclasses.dataclass(frozen=True)
class GrainTable:
    """Fixed-shape grain arrays: grain g covers source samples
    [starts[g], starts[g] + lengths[g]); grains tile the track contiguously
    (starts[g+1] == starts[g] + lengths[g])."""

    starts: np.ndarray  # int32 (G,)
    lengths: np.ndarray  # int32 (G,)

    def __len__(self) -> int:
        return len(self.starts)

    @property
    def ends(self) -> np.ndarray:
        return self.starts + self.lengths


def zero_crossing_mask_np(wav: np.ndarray, look_around: int) -> np.ndarray:
    """Boolean mask: m[idx] ⇔ idx is a valid neg→pos crossing.

    Matches the reference lambda (app.cpp:167-181): requires
    wav[idx-j] < 0 and wav[idx+1+j] >= 0 for j in [0, look_around), with
    bounds idx >= look_around and idx < n - look_around - 1.
    """
    wav = np.asarray(wav)
    n = len(wav)
    la = look_around
    m = np.zeros(n, bool)
    if n < 2 * la + 2:
        return m
    neg = (wav < 0).astype(np.int32)
    pos = (wav >= 0).astype(np.int32)
    cneg = np.concatenate([[0], np.cumsum(neg)])  # cneg[i] = sum(neg[:i])
    cpos = np.concatenate([[0], np.cumsum(pos)])
    idx = np.arange(la, n - la - 1)
    all_neg = (cneg[idx + 1] - cneg[idx + 1 - la]) == la  # wav[idx-la+1 .. idx]
    all_pos = (cpos[idx + 1 + la] - cpos[idx + 1]) == la  # wav[idx+1 .. idx+la]
    m[idx] = all_neg & all_pos
    return m


def zero_crossing_mask_torch(wav: torch.Tensor, look_around: int) -> torch.Tensor:
    """Twin of ``zero_crossing_mask_np`` in plain torch, on ``wav``'s device."""
    n = wav.shape[0]
    la = look_around
    dev = wav.device
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    cneg = torch.cat([zero, torch.cumsum((wav < 0).to(torch.int64), 0)])
    cpos = torch.cat([zero, torch.cumsum((wav >= 0).to(torch.int64), 0)])
    idx = torch.arange(n, device=dev)
    lo = (idx + 1 - la).clamp(0, n)
    hi = (idx + 1 + la).clamp(0, n)
    all_neg = (cneg[idx + 1] - cneg[lo]) == la
    all_pos = (cpos[hi] - cpos[(idx + 1).clamp_max(n)]) == la
    valid = (idx >= la) & (idx < n - la - 1)
    return all_neg & all_pos & valid


def _chain_from_masks(
    zc_primary: np.ndarray,
    zc_fallback: np.ndarray,
    n: int,
    pgs: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential chain selection given precomputed crossing masks."""
    starts: list[int] = []
    lengths: list[int] = []
    if n < pgs + 2:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    # Probe order i=0..pgs-1 maps to offsets: even i → +i/2, odd i → -(i/2),
    # i.e. offsets -half..+half with priority key 2*|off| + (off < 0).
    max_pos = (pgs - 2) // 2 if pgs >= 2 else 0  # largest even i = pgs-2 → +749
    max_neg = (pgs - 1) // 2  # largest odd i = pgs-1 → -749
    # Fallback-scan nonzero indices for fast "first crossing ≥ i0" queries.
    fb_idx = np.nonzero(zc_fallback)[0]

    start = 0
    while start < n - pgs - 1:
        target = start + pgs
        lo = max(0, target - max_neg)
        hi = min(n, target + max_pos + 1)
        window = zc_primary[lo:hi]
        cand = np.nonzero(window)[0]
        if cand.size:
            off = cand + lo - target
            key = 2 * np.abs(off) + (off < 0)
            best = int(cand[np.argmin(key)] + lo)
            starts.append(start)
            lengths.append(best - start)
            start = best
            continue
        # Fallback: first crossing at or after start + 1.5*pgs (app.cpp:198).
        i0 = start + pgs + pgs // 2
        j = np.searchsorted(fb_idx, i0, side="left")
        if j >= len(fb_idx):
            break
        best = int(fb_idx[j])
        starts.append(start)
        lengths.append(best - start)
        start = best
    return np.asarray(starts, np.int32), np.asarray(lengths, np.int32)


def build_grain_table(
    wav,
    config: Config = DEFAULT_CONFIG,
    *,
    backend: str = "auto",
) -> GrainTable:
    """Build the grain table for a track (a NumPy array or a tensor).

    ``backend``: "auto" takes the native C++ runtime (built at first use),
    and NumPy only where no C++ compiler is found; "numpy" / "native" force
    a choice; "torch" computes the crossing masks in plain torch on the
    tensor's device (the CPU for NumPy input), with the chain on the host.
    """
    pgs = config.preferred_grain_size
    if backend not in ("auto", "native", "numpy", "torch"):
        raise ValueError(f"unknown grain backend {backend!r}")
    if backend in ("auto", "native"):
        from ..runtime import native

        lib = native.try_load()
        if lib is not None:
            return native.build_grains(lib, _host_f32(wav), pgs)
        if backend == "native":
            raise RuntimeError("native runtime: no C++ compiler found")
    if backend == "torch":
        w = (wav if isinstance(wav, torch.Tensor)
             else torch.from_numpy(np.asarray(wav, np.float32)))
        w = w.to(torch.float32)
        zc7 = zero_crossing_mask_torch(w, config.zc_look_around).cpu().numpy()
        zc3 = zero_crossing_mask_torch(
            w, config.zc_look_around_fallback).cpu().numpy()
        n = int(w.shape[0])
    else:
        w = _host_f32(wav)
        zc7 = zero_crossing_mask_np(w, config.zc_look_around)
        zc3 = zero_crossing_mask_np(w, config.zc_look_around_fallback)
        n = len(w)
    starts, lengths = _chain_from_masks(zc7, zc3, n, pgs)
    return GrainTable(starts, lengths)


def _host_f32(wav) -> np.ndarray:
    """A contiguous float32 host copy (or view) of a track."""
    if isinstance(wav, torch.Tensor):
        wav = wav.detach().to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(np.asarray(wav, np.float32))
