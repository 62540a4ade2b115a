"""|STFT| kernel B12 for sizes other than 2048, beside its plain twin.

Counterpart of ``melonix_tpu/kernels/pallas_stft.py``.  The TPU kernel
contracted row-rolled frame views against dense cos/sin DFT matrices on the
MXU; the port's kernel (``csrc/stft_mag_sizes.cu``) runs the real-input FFT
of ``csrc/fft_real.cuh`` in shared memory, one block per frame, any size
``2^a * m`` (m odd) that the TPU kernel took, up to :data:`MAX_SIZE`.

``stft_mag`` launches the kernel for a CUDA tensor, runs
:func:`stft_mag_plain` for a CPU tensor, and raises for anything else;
``stft_mag.launches`` counts its launches.  ``twiddles`` is the float32
table of the real-input FFT, shared with B7 (``kernels/columns.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .pv import stft_mag_plain  # size-generic: the twin of B1 and B12

__all__ = ["MAX_SIZE", "supported", "stft_mag", "stft_mag_plain", "twiddles"]

# The transform keeps 4 * size bytes in dynamic shared memory (fft_real.cuh);
# 49152 points take 192 KB of the block's 227 KB.
MAX_SIZE = 49152
SLAB_PAD = 8  # the TPU kernel's largest size // hop
BT = 256  # the TPU kernel's bin tile


@functools.cache
def twiddles(size: int, device: torch.device) -> torch.Tensor:
    """(size // 2, 2) float32 cos/sin(2 pi j / size), computed in float64."""
    ang = 2.0 * np.pi * np.arange(size // 2, dtype=np.float64) / size
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def supported(size: int, hop: int) -> bool:
    """The shapes the TPU kernel took (``pallas_stft.supported``): whole-hop
    overlap, at most 8 hops per frame, 128-aligned hops and bins.  On CUDA
    :func:`stft_mag` takes them up to :data:`MAX_SIZE` and raises above."""
    return (
        size % hop == 0
        and size // hop <= SLAB_PAD
        and hop % 128 == 0
        and (size // 2) % BT == 0
    )


def stft_mag(wav, window, size: int, hop: int, n_frames: int,
             scale: float = 1.0) -> torch.Tensor:
    """B12 (``csrc/stft_mag_sizes.cu``); contract of :func:`stft_mag_plain`:
    ``(n_frames, size // 2)`` float32 ``|DFT(frame * window)| * scale``,
    frame f covering ``wav[f*hop : f*hop + size)``, zeros past the end."""
    if wav.device.type == "cpu":
        return stft_mag_plain(wav, window, size, hop, n_frames, scale)
    dev = _build.cuda_device(wav)
    if not supported(size, hop):
        raise ValueError(f"B12 takes no (size {size}, hop {hop}) frames")
    if size > MAX_SIZE:
        raise NotImplementedError(
            f"B12 size {size} is above its cap MAX_SIZE = {MAX_SIZE} (4 * size "
            "bytes of shared memory per frame; ROADMAP queue B, B12)"
        )
    if n_frames < 0:
        raise ValueError(f"n_frames {n_frames}")
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    out = torch.empty((n_frames, size // 2), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_stft_mag_sizes(
            wav.data_ptr(), wav.shape[0], window.data_ptr(),
            twiddles(size, dev).data_ptr(), out.data_ptr(), n_frames, size,
            hop, float(scale), _build.stream(dev),
        )
    _build.check("stft_mag_sizes", err)
    stft_mag.launches += 1
    return out


stft_mag.launches = 0
