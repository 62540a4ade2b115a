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
cluster); the other sizes up to :data:`MAX_SIZE` the frame tile of
``csrc/fft_fourstep.cuh`` (:func:`frame_tile`: the four-step column tiles'
body on T whole frames a CTA, held in shared memory); above it, the
four-step route of ``csrc/fft_fourstep.cuh`` through a scratch buffer
(:func:`four_step_plan` picks its factors, :func:`four_step_plain` spells
its arithmetic in torch) in coalesced tiles (:func:`column_tile`,
:func:`row_tile`), whose column transforms, where the odd factor does not
fit a tile, are Bluestein convolutions: on the cluster transform up to
:data:`BLUESTEIN_MAX` points (two columns a cluster of
:func:`bluestein_cluster` CTAs: 2 up to :data:`LARGE_M` points, 4 above),
through device scratch above (:func:`bluestein_scratch_plan`, at most
:data:`BLUESTEIN_WORK` bytes of work space).

``stft_mag`` launches the kernel for a CUDA tensor at the shapes
:func:`supported` takes, runs :func:`stft_mag_plain` on the tensor's device
otherwise (a CPU tensor, or another shape), and raises for any other
device; ``stft_mag.launches`` counts its launches, one a call whatever the
route.  :func:`stft_mags` is the |STFT| at any shape: B1 at 2048 points,
``stft_mag`` at the others.
The tables are shared with B7 (``kernels/columns.py``): :func:`unit_roots`,
:func:`twiddles`, :func:`large_twiddles`, :func:`four_step_column_table`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from . import pv as kpv
from .pv import PAIR_SIZES, pair_twiddles
from .pv import stft_mag_plain  # size-generic: the twin of B1 and B12

__all__ = ["MAX_SIZE", "LARGE_SIZES", "BLUESTEIN_MAX", "BLUESTEIN_WORK",
           "supported", "route", "stft_mag", "stft_mag_plain", "stft_mags",
           "twiddles",
           "unit_roots", "large_pass_table", "large_twiddles",
           "bluestein_cluster", "bluestein_table", "bluestein_scratch_plan",
           "bluestein_scratch_table", "four_step_plan", "four_step_plain",
           "four_step_bluestein", "four_step_twiddles",
           "four_step_column_table", "column_tile", "frame_tile", "row_tile",
           "tile_config"]

# A frame tile of one frame keeps about 4 * size bytes in shared memory
# (csrc/fft_fourstep.cuh kMaxColumn); 49,152 points take 192 KB of the
# CTA's 227 KB.  Larger sizes take the four-step route.
MAX_SIZE = 49152
MAX_N1 = 16384  # a four-step row tile of one row keeps 8 * N1 bytes
# Sizes whose frame is one transform held on chip (csrc/fft_large.cuh):
# 8192, 16,384 and 32,768 packed complex points.
LARGE_SIZES = (16384, 32768, 65536)
LARGE_M = 16384  # points of Large<M>, the one-CTA transform
# The largest four-step column Bluestein takes: its convolution runs on a
# cluster of up to 4 CTAs of LARGE_M points, L = 65,536 >= 2 * N2 - 1.
BLUESTEIN_MAX = 2 * LARGE_M
# Above it the column pairs go through device scratch in chunks, L float2 of
# work space a pair, at most this many bytes in all (csrc/fft_fourstep.cuh
# kWorkBytes).
BLUESTEIN_WORK = 1 << 29
SMEM_MAX = 232448  # the H100's shared memory a CTA (fft_fourstep.cuh)
FRAME_SMS = 132  # the H100's SMs: B7's cap on a frame tile (kFrameSms)
ROW_LANES = 16  # a row tile's source rows, at most (kRowLanes)
SLAB_PAD = 8  # the TPU kernel's largest size // hop
BT = 256  # the TPU kernel's bin tile


def _roots_at(x: np.ndarray, n: int) -> np.ndarray:
    """(len(x), 2) float32 cos/sin(2 pi x / n), x int64, in float64."""
    ang = 2.0 * np.pi * (x % n).astype(np.float64) / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def unit_roots(size: int, count: int) -> np.ndarray:
    """(count, 2) float32 cos/sin(2 pi j / size), j < count, the angle from
    j mod size in int64 and float64, rounded once."""
    return _roots_at(np.arange(count, dtype=np.int64), size)


@functools.cache
def twiddles(size: int, device: torch.device) -> torch.Tensor:
    """(size // 2, 2) float32 cos/sin(2 pi j / size), computed in float64."""
    return torch.from_numpy(unit_roots(size, size // 2)).to(device)


def four_step_plan(size: int) -> tuple[int, int] | None:
    """(N1, N2) of the four-step route for ``size`` = N1 * N2, N1 a power of
    two (2..:data:`MAX_N1`).  Where N2 = 2^b * m (m odd, b >= 2) can stay
    within :data:`MAX_SIZE`, the column transforms are FFTs, and N1 is the
    one nearest sqrt(size), the larger on a tie.  Otherwise (an odd factor
    above 12,288, or a size above MAX_N1 * MAX_SIZE) they are Bluestein
    convolutions (:func:`route`) over N2 = size / N1 points, N1 as large as
    fits.  None for an odd ``size``, one below 8,
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


def four_step_bluestein(n2: int) -> bool:
    """Whether the four-step route's N2-point columns are no FFT tile (an N2
    above :data:`MAX_SIZE` or without a factor 4, which the tiles' real
    packing needs) but Bluestein convolutions: on a cluster up to
    :data:`BLUESTEIN_MAX` points, through device scratch above;
    ``csrc/fft_fourstep.cuh`` tests the same."""
    return n2 > MAX_SIZE or n2 % 4 != 0


def _log_fine(n: int) -> int:
    """log2 of the fine table of a coarse/fine pair over n points: the
    least power of two at least sqrt(n) (``fft_fourstep.cuh``)."""
    return ((n - 1).bit_length() - 1 + 2) // 2


def _coarse_fine(n: int, log_f: int) -> np.ndarray:
    """W_n^x for x < n as two float32 tables: fine (x < 2^log_f), then
    coarse W_n^(y 2^log_f) (y < ceil(n / 2^log_f))."""
    f = 1 << log_f
    coarse = np.arange(-(-n // f), dtype=np.int64) * f
    return np.concatenate([unit_roots(n, f), _roots_at(coarse, n)])


@functools.cache
def four_step_twiddles(size: int, n1: int,
                       device: torch.device) -> torch.Tensor:
    """The four-step rows' float32 table (``FourStep``), computed in float64
    and rounded once: W_N^x for x < N as a fine table (x < 2^f, 2^f the
    least power of two >= sqrt(N)) and a coarse one (W_N^(2^f y), y <
    ceil(N / 2^f)); W_N1^y (y < N1) for the rows' passes; the lane table
    W_N^(n1 q) at n1 * :data:`ROW_LANES` + q (q < 16).  A row tile forms
    W_N^(n1 k2) = W_N^(n1 k2_0) (coarse * fine) * W_N^(n1 (k2 - k2_0))
    (lane table): two float32 complex products more."""
    lanes = np.arange(n1, dtype=np.int64)[:, None] * np.arange(ROW_LANES)
    tab = np.concatenate([_coarse_fine(size, _log_fine(size)),
                          unit_roots(n1, n1), _roots_at(lanes.ravel(), size)])
    return torch.from_numpy(tab).to(device)


def tile_config(p: int) -> tuple[int, int]:
    """(threads, points a thread holds through a pass) of a tile CTA for
    P-point transforms (``tiles::config``): (256, 16) up to P = 256, (256,
    32) at 512, (512, 32) above."""
    return (256, 16) if p <= 256 else (256, 32) if p <= 512 else (512, 32)


def column_tile(n2: int) -> dict:
    """One column tile CTA's layout (``csrc/fft_fourstep.cuh`` ColTile) at
    an N2 = B m (m odd, B >= 4) the tiles take: ``m``, ``b`` (B), ``p`` (P =
    B / 2 complex points a packed sub-transform), ``t`` (T columns a CTA:
    32, or as many as keep T N2 / 2 within one batch of its
    :func:`tile_config`, 4096, 8192 or 16,384 points; at least 1), ``s`` (a
    sub-sequence's float2 stride, P + 1, or P where T m (P + 1) float2
    would pass the CTA's shared memory), ``smem`` (bytes) and ``config``
    (:func:`tile_config` of P)."""
    m = n2 // (n2 & -n2)
    b = n2 // m
    p = b // 2
    budget = 4096 if p <= 256 else 8192 if p <= 512 else 16384
    t = 32
    while t > 1 and t * (n2 // 2) > budget:
        t //= 2
    s = p + 1 if t * m * (p + 1) * 8 <= SMEM_MAX else p
    return dict(m=m, b=b, p=p, t=t, s=s, smem=t * m * s * 8,
                config=tile_config(p))


def frame_tile(size: int, count: int | None = None) -> dict:
    """One frame tile CTA's layout (``csrc/fft_fourstep.cuh``
    ``make_frame_tile``) at a ``size`` = B m up to :data:`MAX_SIZE` that is
    no power of two: :func:`column_tile` of N2 = ``size`` (``m``, ``b``,
    ``p``, ``config``), its ``t`` frames a CTA, with ``count`` (B7's
    columns) halved until ceil(count / t) >= min(count,
    :data:`FRAME_SMS`); ``s`` = P + 3 for m < 9, P + 1 above (the load's
    4-byte stores on 16 banks a half-warp); ``smem`` = t m s * 8 bytes;
    ``config`` (``frame_config``): (512, 32) where two CTAs' ``smem`` do
    not fit a SM, else :func:`tile_config` of P but (512, 16) for P > 512.
    Raises ValueError for a size the tile does not take."""
    if not (0 < size <= MAX_SIZE and size % 4 == 0 and size & (size - 1)):
        raise ValueError(f"no frame tile takes {size} points")
    c = column_tile(size)
    t = c["t"]
    if count is not None and count > 0:
        fill = min(count, FRAME_SMS)
        while t > 1 and -(-count // t) < fill:
            t //= 2
    s = c["p"] + (3 if c["m"] < 9 else 1)
    smem = t * c["m"] * s * 8
    config = c["config"]
    if 2 * smem > SMEM_MAX:
        config = (512, 32)
    elif config == (512, 32):
        config = (512, 16)
    return dict(m=c["m"], b=c["b"], p=c["p"], t=t, s=s, smem=smem,
                config=config)


def row_tile(n1: int) -> dict:
    """One row tile CTA's layout (``RowTile``): ``k`` source rows (8 up to
    N1 = 1024, then 8192 / N1, 1 at 16,384), ``pair`` (each source row k2
    <= N2 / 2 gives its mirror N2 - k2 too: up to N1 = 8192), ``seqs`` (2 k
    with pair, else k), ``s`` = N1 + 1 (float2), ``smem`` (bytes) and
    ``config`` (:func:`tile_config` of N1)."""
    pair = n1 <= 8192
    k = 8 if n1 <= 1024 else 8192 // n1 if pair else 1
    seqs = 2 * k if pair else k
    return dict(k=k, pair=pair, seqs=seqs, s=n1 + 1,
                smem=seqs * (n1 + 1) * 8, config=tile_config(n1))


@functools.cache
def four_step_column_table(n2: int, device: torch.device) -> torch.Tensor:
    """The column tiles' float32 table (``ColTile``), computed in float64:
    W_P^y (y < P, the sub-transforms' passes), W_N2^x (x < N2 / 2: the
    split's W_B^k = W_N2^(k m) and the twiddles W_N2^(s k)), W_m^x (x < m,
    the m-point sums)."""
    c = column_tile(n2)
    tab = np.concatenate([unit_roots(c["p"], c["p"]), unit_roots(n2, n2 // 2),
                          unit_roots(c["m"], c["m"])])
    return torch.from_numpy(tab).to(device)


@functools.cache
def large_pass_table(device: torch.device) -> torch.Tensor:
    """(8448, 2) float32 pass table of ``csrc/fft_large.cuh``'s
    ``Large<16384>``, computed in float64: :func:`unit_roots` of 256 (pass
    2), of 4096 (pass 3), and the first 4096 of :data:`LARGE_M` (pass 4,
    whose other twiddles are their powers)."""
    return torch.from_numpy(np.concatenate([
        unit_roots(256, 256), unit_roots(4096, 4096),
        unit_roots(LARGE_M, 4096)])).to(device)


@functools.cache
def large_twiddles(size: int, device: torch.device) -> torch.Tensor:
    """The one float32 table of ``csrc/fft_large.cuh``'s real ``size``-point
    transform (``RealPlan<N>`` reads its offsets; ``size`` a power of two
    1024 ... 65,536), computed in float64: the CTA transform's table
    (:func:`~melonix_tpu_torch.kernels.pv.pair_twiddles` of size / 2 up to
    16,384 points, :func:`large_pass_table` above), at 65,536 points (a
    2-CTA cluster) then :func:`twiddles` of 32,768 (the radix-2 step across
    the cluster), last :func:`twiddles` of ``size`` (the real split)."""
    if size not in LARGE_SIZES + tuple(2 * p for p in PAIR_SIZES):
        raise ValueError(f"no on-chip transform of {size} points")
    cpu = torch.device("cpu")
    parts = ([pair_twiddles(size // 2, cpu)] if size <= 16384
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


def bluestein_scratch_plan(n2: int) -> dict:
    """The Bluestein-through-scratch layout of an ``n2``-point column pair
    above :data:`BLUESTEIN_MAX` (``csrc/fft_fourstep.cuh`` ScratchPlan):
    ``l`` (L, the least power of two >= 2 n2 - 1), ``c`` (C = L /
    :data:`LARGE_M`, the parts of the level-one transforms), ``log_f`` (the
    fine table's log2: the least power of two >= sqrt(L)), and the table
    offsets ``spec``, ``pass_``, ``wc``, ``fine``, ``coarse``, ``lane``
    (float2)."""
    if n2 <= BLUESTEIN_MAX:
        raise ValueError(f"Bluestein through scratch takes columns above "
                         f"{BLUESTEIN_MAX} points, not {n2}")
    length = 1 << (2 * n2 - 2).bit_length()
    log_f = (length.bit_length() - 1 + 1) // 2
    spec = length
    pas = spec + length
    wc = pas + 8448
    fine = wc + length // LARGE_M
    coarse = fine + (1 << log_f)
    return dict(l=length, c=length // LARGE_M, log_f=log_f, spec=spec,
                pass_=pas, wc=wc, fine=fine, coarse=coarse,
                lane=coarse + (length >> log_f))


@functools.cache
def bluestein_scratch_table(n2: int, device: torch.device) -> torch.Tensor:
    """The float32 table of the Bluestein columns through scratch
    (:func:`bluestein_scratch_plan`), computed in float64 and rounded once:
    the chirp b_n = e^(i pi n^2 / n2), its angle from n^2 mod 2 n2 in
    int64, in the level-one transforms' [r][m] order (b_(C m + r) at r M +
    m, 0 from n2 on; L entries); the spectrum of the convolution kernel over
    L points, scaled by 1 / L; :func:`large_pass_table`; W_C^y (y < C, the middle step's
    passes); W_L^x for x < L as a fine table (x < 2^log_f) and a coarse one
    (W_L^(2^log_f y)); the lane table W_L^(r kl) at 32 r + kl (r < C, kl <
    32).  Each W_L^(r k) is W_L^(32 r (k / 32)) (coarse * fine) * W_L^(r (k
    mod 32)) (lane): two float32 complex products more."""
    sp = bluestein_scratch_plan(n2)
    length = sp["l"]
    lanes = np.arange(sp["c"], dtype=np.int64)[:, None] * np.arange(32)
    n = np.arange(n2, dtype=np.int64)
    b = np.exp(1j * np.pi * ((n * n) % (2 * n2)).astype(np.float64) / n2)
    c = np.zeros(length, np.complex128)
    c[:n2] = b
    c[length - n2 + 1:] = b[1:][::-1]
    spec = np.fft.fft(c) / length
    del c
    b_rm = np.zeros(length, np.complex128)
    b_rm[:n2] = b
    b_rm = b_rm.reshape(LARGE_M, sp["c"]).T.ravel()  # [m][r] to [r][m]
    tab = np.concatenate(
        [np.stack([z.real, z.imag], axis=1).astype(np.float32)
         for z in (b_rm, spec)]
        + [large_pass_table(torch.device("cpu")).numpy(),
           unit_roots(sp["c"], sp["c"]),
           _coarse_fine(length, sp["log_f"]),
           _roots_at(lanes.ravel(), length)])
    return torch.from_numpy(tab).to(device)


def bluestein_work(n_frames: int, n1: int, n2: int, device) -> torch.Tensor:
    """The work space of the Bluestein columns through scratch: L float2 a
    column pair, for min(pairs, :data:`BLUESTEIN_WORK` / (8 L)) pairs."""
    length = bluestein_scratch_plan(n2)["l"]
    pairs = min(max(n_frames, 1) * (n1 // 2), BLUESTEIN_WORK // (8 * length))
    return torch.empty((pairs, length, 2), dtype=torch.float32, device=device)


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
    ``"tile"`` (any other size up to :data:`MAX_SIZE`: the frame tile,
    :func:`frame_tile` frames a CTA), ``"four_step"`` above it (the
    columns in tiles), ``"bluestein"`` where the four-step columns are
    Bluestein convolutions on a cluster (an odd factor above 12,288, N2 <=
    :data:`BLUESTEIN_MAX`: on 2-CTA clusters up to N2 = 16,384, on 4-CTA
    clusters above, :func:`bluestein_cluster`) and ``"bluestein_scratch"``
    where they are Bluestein convolutions through device scratch (a larger
    N2).  Raises NotImplementedError for a size no route takes (2^31 points
    and more)."""
    if size in PAIR_SIZES:
        return "pair"
    if size in LARGE_SIZES:
        return "large"
    if size <= MAX_SIZE:
        return "tile"
    plan = four_step_plan(size)
    if plan is None:
        raise NotImplementedError(
            f"B12 size {size}: the four-step route indexes a frame with "
            "int32, so it takes sizes below 2^31")
    if not four_step_bluestein(plan[1]):
        return "four_step"
    return "bluestein" if plan[1] <= BLUESTEIN_MAX else "bluestein_scratch"


@_build.counted
def stft_mag(wav, window, size: int, hop: int, n_frames: int,
             scale: float = 1.0) -> torch.Tensor:
    """B12 (``csrc/stft_mag_sizes.cu``) at the shapes :func:`supported`
    takes, :func:`stft_mag_plain` at the rest; contract of
    :func:`stft_mag_plain`: ``(n_frames, size // 2)`` float32
    ``|DFT(frame * window)| * scale``, frame f covering ``wav[f*hop : f*hop
    + size)``, zeros past the end."""
    if not supported(size, hop) or not _build.on_card(wav):
        return stft_mag_plain(wav, window, size, hop, n_frames, scale)
    dev = wav.device
    way = route(size)
    if n_frames < 0:
        raise ValueError(f"n_frames {n_frames}")
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    out = torch.empty((n_frames, size // 2), dtype=torch.float32, device=dev)
    if way in ("pair", "large", "tile"):
        entry, tw = {
            "pair": ("mlx_stft_mag_pair", pair_twiddles),
            "large": ("mlx_stft_mag_large", large_twiddles),
            "tile": ("mlx_stft_mag_sizes", four_step_column_table),
        }[way]
        args = (wav, wav.shape[0], window, tw(size, dev), out, n_frames, size,
                hop, float(scale))
    else:
        n1, n2 = four_step_plan(size)
        scratch = four_step_scratch(n_frames, n1, n2, dev)
        head = (wav, wav.shape[0], window, four_step_twiddles(size, n1, dev))
        tail = (out, n_frames, size, n1, hop, float(scale))
        if way == "bluestein_scratch":
            entry = "mlx_stft_mag_bluestein_scratch"
            args = (*head, bluestein_scratch_table(n2, dev), scratch,
                    bluestein_work(n_frames, n1, n2, dev), *tail)
        else:
            entry, tw2 = {
                "four_step": ("mlx_stft_mag_4step", four_step_column_table),
                "bluestein": ("mlx_stft_mag_bluestein", bluestein_table),
            }[way]
            args = (*head, tw2(n2, dev), scratch, *tail)
    _build.launch(stft_mag, "stft_mag_sizes", entry, dev, *args)
    return out


def stft_mags(wav, window, size: int, hop: int, n_frames: int,
              scale: float = 1.0) -> torch.Tensor:
    """The |STFT| at any shape, contract of :func:`stft_mag_plain`: B1
    (``kernels.pv.stft_mag``) at 2048 points, :func:`stft_mag` (B12 where
    it takes the shape, the twin elsewhere) at the other sizes."""
    if size == kpv.FFT_N:
        return kpv.stft_mag(wav, window, size, hop, n_frames, scale)
    return stft_mag(wav, window, size, hop, n_frames, scale)


def four_step_scratch(n_frames: int, n1: int, n2: int, device):
    """The four-step route's scratch: rows k2 <= N2 / 2 of N1 complex
    values per frame, as float32 pairs."""
    return torch.empty((max(n_frames, 1), n2 // 2 + 1, n1, 2),
                       dtype=torch.float32, device=device)
