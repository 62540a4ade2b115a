"""The roofline yardstick: published peaks and the work a kernel call needs.

Frozen copies of the arithmetic the port's chip smoke test used
(``chip_smoke.py``: ``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S``,
``fft_flops``, ``nbytes``, ``bound``), kept here so that a change to the
program cannot change what its kernels are measured against.  A bound is
computed from a call's shapes, so it counts the same work whatever
implements the kernel.
"""

from __future__ import annotations

import math

# Published H100 SXM peaks at 700 W (NVIDIA's data sheet): device memory
# bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def fft_flops(n_frames: int, size: int) -> float:
    """Operations of ``n_frames`` real ``size``-point FFTs (2.5 N log2 N)."""
    return n_frames * 2.5 * size * math.log2(size)


def nbytes(*tensors) -> int:
    """Bytes held by tensors (each read or written once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it): bytes over the memory
    rate against float32 operations over the float32 peak."""
    t_mem = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS_PER_S
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")
