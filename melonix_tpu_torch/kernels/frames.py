"""Frames at arbitrary sample offsets: kernel B9 and its plain PyTorch twin.

Counterpart of ``melonix_tpu/kernels/pallas_frames.py``.  The phase
vocoder's analysis fetch at the frame sizes B2 does not take: frame m is
``wav[s : s + size]`` with ``s = clip(starts[m], 0, n - 1)``, zeros past the
end.  The TPU kernel double-buffered one DMA per frame from a zero-padded
copy of the track and realigned it with lane rolls; the port's kernel
(``csrc/extract_frames.cu``) is one block per frame of coalesced loads that
read past-the-end samples as 0, with no padded copy.  It is a pure copy, so
it equals its twin bit for bit.

:func:`supported` is the TPU kernel's predicate: :func:`extract_frames`
launches the kernel for a CUDA tensor at the shapes it takes and runs
:func:`extract_frames_plain` on the tensor's device at the rest, as the JAX
package sends them to an XLA gather (``phase_vocoder.py:360-364``).
``extract_frames.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import _build

MAX_FRAMES = 200_000  # the TPU's SMEM bound on the starts array, kept


def supported(size: int, n_frames: int | None = None) -> bool:
    """``pallas_frames.supported``: size a multiple of 128, at least 1024,
    and (when given) at most :data:`MAX_FRAMES` frames."""
    ok = size % 128 == 0 and size // 128 >= 8
    if n_frames is not None:
        ok = ok and n_frames <= MAX_FRAMES
    return ok


def extract_frames_plain(wav, starts, size: int) -> torch.Tensor:
    """(F, size) float32: ``wav[s : s + size]``, s = clip(starts, 0, n - 1),
    zeros past the end."""
    n = wav.shape[0]
    s = starts.to(torch.int64).clamp(0, max(n - 1, 0))
    idx = s[:, None] + torch.arange(size, device=wav.device)[None, :]
    return torch.where(idx < n, wav[idx.clamp_max(max(n - 1, 0))], 0.0)


@_build.counted
def extract_frames(wav, starts, size: int) -> torch.Tensor:
    """B9 (``csrc/extract_frames.cu``) for the shapes :func:`supported`
    takes, :func:`extract_frames_plain` at the rest; contract of
    :func:`extract_frames_plain`."""
    f = starts.shape[0]
    if not supported(size, f) or not _build.on_card(wav):
        return extract_frames_plain(wav, starts, size)
    dev = wav.device
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(starts, "starts", torch.int32, (f,), dev)
    if wav.shape[0] == 0:
        raise ValueError("wav is empty")
    out = torch.empty((f, size), dtype=torch.float32, device=dev)
    _build.launch(extract_frames, "extract_frames", "mlx_extract_frames", dev,
                  wav, wav.shape[0], starts, out, f, size)
    return out
