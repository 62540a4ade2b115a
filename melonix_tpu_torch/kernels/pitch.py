"""Autocorrelation kernel B8 of the pitch engine, beside its plain twin.

Counterpart of ``melonix_tpu/kernels/pallas_pitch.py``.  The TPU kernel ran
the Wiener-Khinchin round trip (mean-subtract, zero-pad to 4096, forward
DFT, power, inverse DFT) as four-step bf16x3 MXU matmuls in a scrambled bin
order.  The port's kernel (``csrc/pitch_ac.cu``) packs two frames into one
complex 4096-point transform each way, on the register transform of
``csrc/fft_pair.cuh`` (three barriers a transform, twiddles in registers,
a persistent grid over the frame pairs).  Each frame is first scaled by a
power of two to an rms near 1, so a loud frame's rounding does not leak
into a quiet partner; the scale is exact and undone on the output.  The
kernel reads each frame once and writes ``w`` and ``ac``: device memory
bounds it.

``pitch_ac`` launches the kernel for a CUDA tensor at the shapes
:func:`supported` takes, runs :func:`pitch_ac_plain` on the tensor's device
otherwise (a CPU tensor, or a shape the kernel does not take), and raises
for any other device; ``pitch_ac.launches`` counts its launches.
"""

from __future__ import annotations

import torch

from . import _build
from .pv import hop_frames, pair_twiddles

FRAME = 2048  # the only analysis frame the kernel takes (config.pitch_frame)
NFFT = 2 * FRAME  # zero-padded linear-correlation length


def supported(frame: int, hop: int, n_frames: int) -> bool:
    """The shapes the TPU kernel took (``pallas_pitch.supported``)."""
    return frame == FRAME and hop % 128 == 0 and hop <= frame and n_frames >= 1


def pitch_ac_plain(wav, frame: int, hop: int, n_frames: int):
    """``(ac, w)``, both ``(n_frames, frame)`` float32: ``w`` the frames
    ``wav[f*hop : f*hop + frame]`` (zeros past the end) minus their mean,
    ``ac = irfft(|rfft(w, 2 frame)|^2, 2 frame)[:, :frame]`` their linear
    autocorrelation."""
    frames = hop_frames(wav.to(torch.float32), frame, hop, n_frames)
    w = frames - frames.mean(dim=1, keepdim=True)
    spec = torch.fft.rfft(w, n=2 * frame)
    power = spec.real * spec.real + spec.imag * spec.imag
    ac = torch.fft.irfft(power, n=2 * frame)[:, :frame]
    return ac.contiguous(), w.contiguous()


@_build.counted
def pitch_ac(wav, frame: int, hop: int, n_frames: int):
    """B8 (``csrc/pitch_ac.cu``) for the shapes :func:`supported` takes,
    :func:`pitch_ac_plain` at the rest; contract of :func:`pitch_ac_plain`."""
    if not supported(frame, hop, n_frames) or not _build.on_card(wav):
        return pitch_ac_plain(wav, frame, hop, n_frames)
    dev = wav.device
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    ac = torch.empty((n_frames, frame), dtype=torch.float32, device=dev)
    w = torch.empty_like(ac)
    _build.launch(pitch_ac, "pitch_ac", "mlx_pitch_ac", dev, wav, wav.shape[0],
                  pair_twiddles(NFFT, dev), ac, w, n_frames, hop)
    return ac, w
