"""|STFT| kernel B12 for sizes other than 2048, beside its plain twin.

Counterpart of ``melonix_tpu/kernels/pallas_stft.py``.  The TPU kernel
contracted row-rolled frame views against dense cos/sin DFT matrices on the
MXU; the port's kernel (``csrc/stft_mag_sizes.cu``) takes any size ``2^a *
m`` (m odd) that the TPU kernel took, by one of the routes :func:`route`
names from the size alone: the power-of-two sizes of
:data:`~melonix_tpu_torch.kernels.pv.PAIR_SIZES` run B1's kernel
(``csrc/stft_mag_pair.cuh``: two frames per complex transform on the
register-resident ``csrc/fft_pair.cuh``); :data:`LARGE_SIZES` one frame per
transform held on chip (``csrc/fft_large.cuh``: 65,536 points on a 2-CTA
cluster); the other sizes up to :data:`MAX_SIZE` the real-input FFT of
``csrc/fft_real.cuh`` in shared memory, one block per frame; above it, the
four-step route of ``csrc/fft_fourstep.cuh`` through a scratch buffer
(:func:`four_step_plan` picks its factors, :func:`four_step_plain` spells
its arithmetic in torch), whose column transforms, where the odd factor
does not fit one block, are Bluestein convolutions on the cluster
transform up to :data:`BLUESTEIN_MAX` points (two columns a cluster of
:func:`bluestein_cluster` CTAs: 2 up to :data:`LARGE_M` points, 4 above)
and direct sums above that.

``stft_mag`` launches the kernel for a CUDA tensor, runs
:func:`stft_mag_plain` for a CPU tensor, and raises for anything else;
``stft_mag.launches`` counts its launches, one a call whatever the route.
``twiddles`` is the float32 table of the real-input FFT, shared with B7
(``kernels/columns.py``), as are the four-step plan and
:func:`large_twiddles`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .pv import PAIR_SIZES, pair_twiddles
from .pv import stft_mag_plain  # size-generic: the twin of B1 and B12

__all__ = ["MAX_SIZE", "LARGE_SIZES", "BLUESTEIN_MAX", "supported", "route",
           "stft_mag", "stft_mag_plain", "twiddles", "circle",
           "large_pass_table", "large_twiddles", "bluestein_cluster",
           "bluestein_table", "four_step_plan", "four_step_plain"]

# The one-block transform keeps 4 * size bytes in dynamic shared memory
# (fft_real.cuh); 49152 points take 192 KB of the block's 227 KB.  Larger
# sizes take the four-step route.
MAX_SIZE = 49152
MAX_N1 = 16384  # the four-step rows keep 8 * N1 bytes: 128 KB
# Sizes whose frame is one transform held on chip (csrc/fft_large.cuh):
# 8192, 16,384 and 32,768 packed complex points.
LARGE_SIZES = (16384, 32768, 65536)
LARGE_M = 16384  # points of Large<M>, the one-CTA transform
# The largest four-step column Bluestein takes: its convolution runs on a
# cluster of up to 4 CTAs of LARGE_M points, L = 65,536 >= 2 * N2 - 1.
BLUESTEIN_MAX = 2 * LARGE_M
SLAB_PAD = 8  # the TPU kernel's largest size // hop
BT = 256  # the TPU kernel's bin tile


@functools.cache
def twiddles(size: int, device: torch.device) -> torch.Tensor:
    """(size // 2, 2) float32 cos/sin(2 pi j / size), computed in float64."""
    ang = 2.0 * np.pi * np.arange(size // 2, dtype=np.float64) / size
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def four_step_plan(size: int) -> tuple[int, int] | None:
    """(N1, N2) of the four-step route for ``size`` = N1 * N2, N1 a power of
    two (2..:data:`MAX_N1`).  Where N2 = 2^b * m (m odd, b >= 2) can stay
    within :data:`MAX_SIZE`, the column transforms are FFTs, and N1 is the
    one nearest sqrt(size), the larger on a tie.  Otherwise (an odd factor
    above 12,288, or a size above MAX_N1 * MAX_SIZE) they are no FFT but
    Bluestein convolutions or direct sums (:func:`route`) over N2 = size /
    N1 points, N1 as large as fits.  None for an odd ``size``, one below 8,
    or one that int32 indices cannot reach."""
    if size < 8 or size >= 1 << 31 or size % 2:
        return None
    a = (size & -size).bit_length() - 1  # size = 2^a * m
    best = None
    for c in range(1, a - 1):
        n1, n2 = 1 << c, size >> c
        if n1 > MAX_N1 or n2 > MAX_SIZE:
            continue
        key = (abs(n1.bit_length() - n2.bit_length()), -n1)
        if best is None or key < best[0]:
            best = (key, (n1, n2))
    if best is not None:
        return best[1]
    n1 = min(1 << a, MAX_N1)
    return n1, size // n1


def four_step_direct(n2: int) -> bool:
    """Whether the four-step route's N2-point columns are no FFT (an N2
    above :data:`MAX_SIZE` or without a factor 4, which the one-block real
    FFT needs) but Bluestein convolutions up to :data:`BLUESTEIN_MAX` points
    and direct sums above; ``csrc/fft_fourstep.cuh`` tests the same."""
    return n2 > MAX_SIZE or n2 % 4 != 0


@functools.cache
def circle(size: int, device: torch.device) -> torch.Tensor:
    """(size, 2) float32 cos/sin(2 pi j / size) for every j < size, computed
    in float64: the direct column sums' table (any ``size``, odd included)."""
    ang = 2.0 * np.pi * np.arange(size, dtype=np.float64) / size
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


@functools.cache
def large_pass_table(device: torch.device) -> torch.Tensor:
    """(8448, 2) float32 pass table of ``csrc/fft_large.cuh``'s
    ``Large<16384>``, computed in float64: :func:`circle` of 256 (pass 2),
    of 4096 (pass 3), and the first 4096 entries of :func:`circle` of
    :data:`LARGE_M` (pass 4, whose other twiddles are their powers)."""
    return torch.cat([circle(256, device), circle(4096, device),
                      circle(LARGE_M, device)[:4096]])


@functools.cache
def large_twiddles(size: int, device: torch.device) -> torch.Tensor:
    """The one float32 table of ``csrc/fft_large.cuh``'s real ``size``-point
    transform (``RealPlan<N>`` reads its offsets), computed in float64: the
    CTA transform's table (:func:`~melonix_tpu_torch.kernels.pv.pair_twiddles`
    of 8192 at 16,384 points, :func:`large_pass_table` above), at 65,536
    points (a 2-CTA cluster) then :func:`twiddles` of 32,768 (the radix-2
    step across the cluster), last :func:`twiddles` of ``size`` (the real
    split)."""
    if size not in LARGE_SIZES:
        raise ValueError(f"no on-chip transform of {size} points")
    cpu = torch.device("cpu")
    parts = ([pair_twiddles(8192, cpu)] if size == 16384
             else [large_pass_table(cpu)])
    if size == 65536:
        parts.append(twiddles(2 * LARGE_M, cpu))
    parts.append(twiddles(size, cpu))
    return torch.cat(parts).to(device)


def bluestein_cluster(n2: int) -> int:
    """The CTAs of the cluster that runs an ``n2``-point Bluestein column
    pair (``csrc/fft_fourstep.cuh:bluestein_cluster``): 2 (L = 32,768) up to
    :data:`LARGE_M` points, 4 (L = 65,536) up to :data:`BLUESTEIN_MAX`."""
    if not 1 <= n2 <= BLUESTEIN_MAX:
        raise ValueError(f"Bluestein takes columns of 1..{BLUESTEIN_MAX} "
                         f"points, not {n2}")
    return 2 if n2 <= LARGE_M else 4


@functools.cache
def _bluestein_np(n2: int, length: int) -> np.ndarray:
    """:func:`bluestein_table`'s rows for a convolution of ``length`` = C *
    LARGE_M points, as a float32 (rows, 2) array."""
    c_ctas = length // LARGE_M
    n = np.arange(n2, dtype=np.int64)
    b = np.exp(1j * np.pi * ((n * n) % (2 * n2)).astype(np.float64) / n2)
    c = np.zeros(length, np.complex128)
    c[:n2] = b
    c[length - n2 + 1:] = b[1:][::-1]
    spec = np.fft.fft(c) / length
    k = np.arange(LARGE_M, dtype=np.int64)
    rows = (np.arange(1, c_ctas, dtype=np.int64)[:, None] * k).ravel()
    ang = 2.0 * np.pi * rows.astype(np.float64) / length
    return np.concatenate(
        [np.stack([z.real, z.imag], axis=1).astype(np.float32)
         for z in (b, spec)]
        + [large_pass_table(torch.device("cpu")).numpy(),
           np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)])


@functools.cache
def bluestein_table(n2: int, device: torch.device) -> torch.Tensor:
    """(n2 + L + 8448 + (C - 1) * 16,384, 2) float32 table of the Bluestein
    columns (``csrc/fft_fourstep.cuh``, ``BluesteinPlan<C>``), C =
    :func:`bluestein_cluster` (n2) and L = C * :data:`LARGE_M`, computed in
    float64 and rounded once: the chirp b_n = e^(i pi n^2 / n2), n < n2, its
    angle from n^2 mod 2 n2 in int64 (exact); the spectrum of the
    convolution kernel c (c[m] = c[L - m] = b_m, m < n2; zeros between) over
    L points, scaled by 1 / L; :func:`large_pass_table` (the CTA's
    transform); then the cluster step's rows r = 1 .. C - 1 of (cos,
    sin)(2 pi r k / L), k < 16,384 (at C = 2 exactly :func:`twiddles` of
    32,768)."""
    length = bluestein_cluster(n2) * LARGE_M
    return torch.from_numpy(_bluestein_np(n2, length)).to(device)


def four_step_plain(frames: torch.Tensor, n1: int) -> torch.Tensor:
    """(B, size // 2) complex: the first size // 2 bins of the DFT of each
    real frame by the four-step decomposition the kernels run (plain torch,
    in the frames' precision): the real N2-point transforms of the strided
    columns x[n1 + N1 * n2], the twiddles W_N^(n1 * k2), the complex
    N1-point transforms, X[k2 + N2 * k1]."""
    b, size = frames.shape
    n2 = size // n1
    cols = frames.reshape(b, n2, n1)  # [., n2, n1] = x[n1 + N1 * n2]
    c = torch.fft.fft(cols, dim=1)  # C[., k2, n1]
    k2 = torch.arange(n2, dtype=torch.float64, device=frames.device)
    j1 = torch.arange(n1, dtype=torch.float64, device=frames.device)
    ang = -2.0 * np.pi * torch.remainder(k2[:, None] * j1[None, :], size) / size
    tw = torch.polar(torch.ones_like(ang), ang).to(c.dtype)
    x = torch.fft.fft(c * tw, dim=2)  # [., k2, k1] = X[k2 + N2 * k1]
    return x.transpose(1, 2).reshape(b, size)[:, : size // 2]


def supported(size: int, hop: int) -> bool:
    """The shapes the TPU kernel took (``pallas_stft.supported``): whole-hop
    overlap, at most 8 hops per frame, 128-aligned hops and bins.  On CUDA
    :func:`stft_mag` takes them by the routes of :func:`route` (below 2^31
    points; larger sizes raise)."""
    return (
        size % hop == 0
        and size // hop <= SLAB_PAD
        and hop % 128 == 0
        and (size // 2) % BT == 0
    )


def route(size: int) -> str:
    """The kernel route B12 takes at ``size`` points, by the size alone:
    ``"pair"`` (a power of two in :data:`PAIR_SIZES`: two frames per
    register-resident complex transform), ``"large"`` (:data:`LARGE_SIZES`:
    one frame per transform held on chip, 65,536 on a 2-CTA cluster),
    ``"one_block"`` (any other size up to :data:`MAX_SIZE`:
    ``fft_real.cuh``, a block per frame), ``"four_step"`` above it,
    ``"bluestein"`` where the four-step columns are Bluestein convolutions
    (an odd factor above 12,288, N2 <= :data:`BLUESTEIN_MAX`: on 2-CTA
    clusters up to N2 = 16,384, on 4-CTA clusters above,
    :func:`bluestein_cluster`) and ``"direct"`` where they are direct sums
    (a larger N2).  Raises NotImplementedError for a size no route takes
    (2^31 points and more)."""
    if size in PAIR_SIZES:
        return "pair"
    if size in LARGE_SIZES:
        return "large"
    if size <= MAX_SIZE:
        return "one_block"
    plan = four_step_plan(size)
    if plan is None:
        raise NotImplementedError(
            f"B12 size {size}: the four-step route indexes a frame with "
            "int32, so it takes sizes below 2^31")
    if not four_step_direct(plan[1]):
        return "four_step"
    return "bluestein" if plan[1] <= BLUESTEIN_MAX else "direct"


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
    way = route(size)
    if n_frames < 0:
        raise ValueError(f"n_frames {n_frames}")
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    out = torch.empty((n_frames, size // 2), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        if way in ("pair", "large", "one_block"):
            entry, tw = {
                "pair": (lib.mlx_stft_mag_pair, pair_twiddles),
                "large": (lib.mlx_stft_mag_large, large_twiddles),
                "one_block": (lib.mlx_stft_mag_sizes, twiddles),
            }[way]
            err = entry(
                wav.data_ptr(), wav.shape[0], window.data_ptr(),
                tw(size, dev).data_ptr(), out.data_ptr(), n_frames, size, hop,
                float(scale), _build.stream(dev),
            )
        else:
            n1, n2 = four_step_plan(size)
            scratch = four_step_scratch(n_frames, n1, n2, dev)
            entry, tw2 = {
                "four_step": (lib.mlx_stft_mag_4step, twiddles),
                "direct": (lib.mlx_stft_mag_4step, circle),
                "bluestein": (lib.mlx_stft_mag_bluestein, bluestein_table),
            }[way]
            err = entry(
                wav.data_ptr(), wav.shape[0], window.data_ptr(),
                twiddles(size, dev).data_ptr(), tw2(n2, dev).data_ptr(),
                scratch.data_ptr(), out.data_ptr(), n_frames, size, n1, hop,
                float(scale), _build.stream(dev),
            )
    _build.check("stft_mag_sizes", err)
    stft_mag.launches += 1
    return out


stft_mag.launches = 0


def four_step_scratch(n_frames: int, n1: int, n2: int, device):
    """The four-step route's scratch: rows k2 <= N2 / 2 of N1 complex
    values per frame, as float32 pairs."""
    return torch.empty((max(n_frames, 1), n2 // 2 + 1, n1, 2),
                       dtype=torch.float32, device=device)
