"""Variable-rate resamples: kernels B4 and B11 and their plain PyTorch twins.

Counterpart of ``melonix_tpu/kernels/pallas_resample.py``.  Positions are
**block-relative**: an int32 source base per 2048-sample output block (host
float64, with slack) plus a small float32 offset.  Absolute float32
positions would lose sub-sample precision past 2^23 source samples (~3 min
at 44.1 kHz).

``resample_pv`` (B4, ``csrc/resample_pv.cu``) evaluates the offsets from
the block's piecewise-analytic anchors, the offline PV render's tail; its
seven operands travel in one array (:func:`upload_pv_operands`).
``resample_lerp`` (B11, ``csrc/resample_lerp.cu``) takes them as given.
Each launches its kernel for CUDA tensors and runs its ``*_plain`` twin for
CPU tensors.  The live ``PvStream`` reads through :class:`LerpReader`, B11
for one stream's operands, validated once: one launch a read, straight into
mapped host memory.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

BLK = 2048  # output samples per block
SLACK = 128  # guard below the host base for device f32 rounding
LN2_12 = np.log(2.0) / 12.0  # d(bend)/dt -> d(ln rho)/dt


def expm1_precise(x: torch.Tensor) -> torch.Tensor:
    """f32 expm1 with ~1-ulp relative error for |x| <= 0.7: a 9-term Horner
    Taylor series, verbatim from the JAX package (XLA's f32 expm1 carried
    ~1.2e-4 relative error there).  Larger |x| falls back to exp(x) - 1."""
    p = 1.0 + x / 9.0
    for k in (8.0, 7.0, 6.0, 5.0, 4.0, 3.0, 2.0):
        p = 1.0 + x * p / k
    return torch.where(x.abs() <= 0.7, x * p, torch.exp(x) - 1.0)


def rows_for(max_rate: float) -> int:
    """Slab rows (of 128 samples) covering one block's span at ``max_rate``
    plus guards (``pallas_resample.rows_for``): B11's bound on a relative
    position is ``rows * 128 - 2``."""
    span = int(BLK * max(max_rate, 0.01)) + 2 * SLACK + 256
    return 8 * -(-(span // 128 + 2) // 8)


def block_bases(pos_block_starts: np.ndarray, n_src: int) -> np.ndarray:
    """Host: slab base per block from float64 start positions (with slack)."""
    base = np.floor(pos_block_starts).astype(np.int64) - SLACK
    return np.clip(base, 0, max(n_src - 1, 0)).astype(np.int32)


def pv_anchor_blocks(anc_j: np.ndarray, nb: int):
    """Host: per-block first-anchor index + live-anchor count.

    ``anc_j`` must be the UNPADDED ascending anchor list (block starts are
    always anchors, so a0[b] indexes the b*BLK anchor exactly).  kmax is
    the largest per-block anchor count."""
    anc_j = np.asarray(anc_j, np.int64)
    starts = np.arange(nb, dtype=np.int64) * BLK
    a0 = (np.searchsorted(anc_j, starts, side="right") - 1).astype(np.int32)
    nxt = np.append(a0[1:], len(anc_j)).astype(np.int32)
    cnt = (nxt - a0).astype(np.int32)
    kmax = int(cnt.max()) if nb else 1
    return a0, cnt, kmax


def positions_rel_plain(anc_j, anc_src, anc_r, anc_s, sr: int, n_out: int,
                        j0: int = 0):
    """(n_out,) float32 block-relative positions of output samples [j0, j0 +
    n_out): each sample takes the constants of the last anchor at or before
    it (the segmented broadcast of
    ``melonix_tpu/engine/phase_vocoder.py:_positions_rel_device``)."""
    j = torch.arange(j0, j0 + n_out, dtype=torch.int32, device=anc_j.device)
    a = (torch.searchsorted(anc_j, j, right=True) - 1).clamp_min(0)
    return position_at(j, a, anc_j, anc_src, anc_r, anc_s, sr)


def position_at(j, a, anc_j, anc_src, anc_r, anc_s, sr: int):
    """float32 block-relative positions of int32 output samples ``j``, each
    from the constants of its anchor ``a`` (same shape as ``j``)."""
    s = anc_s[a]
    srf = float(np.float32(sr))
    ln = float(np.float32(LN2_12))
    dt = (j - anc_j[a]).to(torch.float32) / srf
    em1 = expm1_precise(s * dt * ln)
    flat = s.abs() < 1e-9
    delta_p = torch.where(flat, dt, em1 / (torch.where(flat, 1.0, s) * ln))
    return (anc_src[a] + anc_r[a] * (delta_p * srf - em1)).clamp_min(0.0)


def lerp(frac, lo, hi) -> torch.Tensor:
    """float32 ``(1 - frac) * lo + frac * hi`` rounded as the TPU kernel
    B11 rounds it in interpret mode on the CPU: one fused multiply-add over
    the rounded ``frac * hi``.  The first product is exact in float64, so
    one float64 sum rounded to float32 gives the same value, except where
    that float64 sum itself rounds onto a float32 tie."""
    return ((1.0 - frac).double() * lo.double() + (frac * hi).double()).float()


def lerp_resample_rel(y, src_rel, base, stretch_len: int) -> torch.Tensor:
    """(n,) float32 lerp of ``y`` at base[j // BLK] + src_rel[j], indices
    clamped to [0, stretch_len - 1]
    (``melonix_tpu/engine/phase_vocoder.py:_lerp_resample_rel_xla``)."""
    b = base.to(torch.int64).repeat_interleave(BLK)[: src_rel.shape[0]]
    rel = torch.floor(src_rel)
    frac = src_rel - rel
    i0 = b + rel.to(torch.int64)
    return lerp(frac, y[i0.clamp(0, stretch_len - 1)],
                y[(i0 + 1).clamp(0, stretch_len - 1)])


def resample_pv_plain(y, base, anc_j, anc_src, anc_r, anc_s, sr: int,
                      n_out: int) -> torch.Tensor:
    """(n_out,) float32: :func:`positions_rel_plain`, then
    :func:`lerp_resample_rel` over the whole of ``y``."""
    pos = positions_rel_plain(anc_j, anc_src, anc_r, anc_s, sr, n_out)
    return lerp_resample_rel(y, pos, base, y.shape[0])


def upload_pv_operands(base, a0, cnt, anc_j, anc_src, anc_r, anc_s,
                       device):
    """B4's seven operands, packed into one int32 host array (the float32
    sections by their bits) and uploaded to ``device`` in one copy: views
    of it in :func:`resample_pv`'s order (base, a0, cnt, anc_j int32;
    anc_src, anc_r, anc_s float32)."""
    return _build.upload_packed((base, a0, cnt, anc_j),
                                (anc_src, anc_r, anc_s), device)


@_build.counted
def resample_pv(y, base, a0, cnt, anc_j, anc_src, anc_r, anc_s, sr: int,
                n_out: int) -> torch.Tensor:
    """B4 (``csrc/resample_pv.cu``): contract of :func:`resample_pv_plain`
    for sources under 2^31 samples with ``base`` from :func:`block_bases`;
    ``a0``/``cnt`` (from :func:`pv_anchor_blocks`) give each block's anchor
    range, which its CTA stages once in shared memory."""
    if not _build.on_card(y):
        return resample_pv_plain(y, base, anc_j, anc_src, anc_r, anc_s, sr,
                                 n_out)
    dev = y.device
    if n_out % BLK != 0:
        raise ValueError(f"n_out {n_out} is not a multiple of {BLK}")
    nb = n_out // BLK
    n_anc = anc_j.shape[0]
    if y.shape[0] == 0 or n_anc == 0 or y.shape[0] >= 1 << 31:
        raise ValueError(f"source of {y.shape[0]} samples (1 to 2^31 - 1), "
                         f"{n_anc} anchors")
    _build.require(y, "y", torch.float32, (y.shape[0],), dev)
    for name, t in (("base", base), ("a0", a0), ("cnt", cnt)):
        _build.require(t, name, torch.int32, (nb,), dev)
    _build.require(anc_j, "anc_j", torch.int32, (n_anc,), dev)
    for name, t in (("anc_src", anc_src), ("anc_r", anc_r), ("anc_s", anc_s)):
        _build.require(t, name, torch.float32, (n_anc,), dev)
    out = torch.empty((n_out,), dtype=torch.float32, device=dev)
    _build.launch(resample_pv, "resample_pv", "mlx_resample_pv", dev, y,
                  y.shape[0], base, a0, cnt, anc_j, anc_src, anc_r, anc_s,
                  n_anc, out, n_out, int(sr))
    return out


def resample_lerp_plain(y, pos, base, rows: int) -> torch.Tensor:
    """(n_out,) float32 lerp at block-relative positions, the TPU kernel's
    contract (``pallas_resample.resample_lerp_pallas``): r = floor(pos),
    rel = clip(r, 0, rows * 128 - 2), g[i] = y[base[j // BLK] + i] (0 past
    the end), out = :func:`lerp` of g[rel] and g[rel + 1]."""
    n = y.shape[0]
    fl = torch.floor(pos)
    frac = pos - fl
    rel = fl.clamp(0, rows * 128 - 2).to(torch.int64)
    i0 = base.to(torch.int64).repeat_interleave(BLK)[: pos.shape[0]] + rel

    def tap(i):
        return torch.where(i < n, y[i.clamp_max(n - 1)], 0.0)

    return lerp(frac, tap(i0), tap(i0 + 1))


@_build.counted
def resample_lerp(y, pos, base, rows: int) -> torch.Tensor:
    """B11 (``csrc/resample_lerp.cu``): contract of
    :func:`resample_lerp_plain`; ``len(pos)`` is a multiple of BLK and
    ``base`` holds one int32 per block.  On the card: the window entry that
    :class:`LerpReader` reads through, over the whole output into device
    memory."""
    if not _build.on_card(y):
        return resample_lerp_plain(y, pos, base, rows)
    dev = y.device
    n_out = pos.shape[0]
    if n_out % BLK != 0 or n_out >= 1 << 31 or rows < 1:
        raise ValueError(f"n_out {n_out} (a multiple of {BLK} under 2^31), "
                         f"rows {rows}")
    if y.shape[0] == 0:
        raise ValueError("empty source")
    _build.require(y, "y", torch.float32, (y.shape[0],), dev)
    _build.require(pos, "pos", torch.float32, (n_out,), dev)
    _build.require(base, "base", torch.int32, (n_out // BLK,), dev)
    out = torch.empty((n_out,), dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    _build.launch(resample_lerp, "resample_lerp", "mlx_resample_lerp_window",
                  dev, y, y.shape[0], pos, base, 0, n_out, int(rows), out, 0)
    return out


def _pinned(n: int) -> torch.Tensor:
    return torch.empty((n,), dtype=torch.float32, pin_memory=True)


class LerpReader:
    """B11 for one stream: the operands of :func:`resample_lerp_plain` over
    the whole padded output (``y``, ``pos``, ``base``, ``rows``), checked
    once.  :meth:`read` computes exactly the samples [j, j + n) with one
    launch of ``mlx_resample_lerp_window`` into a page-locked host buffer
    mapped into the card's address space, waits for it, and returns them;
    each sample is :func:`resample_lerp_plain`'s over the covering blocks,
    bit for bit.  The launch goes on the device's current stream, so it
    follows whatever the caller queued there, with the reader's card made
    current for it.  Launches count on ``resample_lerp.launches``.  CUDA
    only: other tensors raise.
    """

    def __init__(self, y, pos, base, rows: int):
        n_out = pos.shape[0] if pos.dim() == 1 else -1
        if n_out % BLK != 0 or y.dim() != 1 or y.shape[0] == 0:
            raise ValueError(f"positions {tuple(pos.shape)} (a multiple of "
                             f"{BLK}), source {tuple(y.shape)} (not empty)")
        if not 1 <= rows <= (2**31 + 1) // 128:
            raise ValueError(f"rows {rows}: rows * 128 - 2 must fit int32")
        _build.require(y, "y", torch.float32, (y.shape[0],), y.device)
        _build.require(pos, "pos", torch.float32, (n_out,), y.device)
        _build.require(base, "base", torch.int32, (n_out // BLK,), y.device)
        if not _build.on_card(y):
            raise ValueError(f"no kernel for a tensor on {y.device}: a "
                             "LerpReader reads from a card")
        self.device = y.device
        self.n_out = n_out
        self._ops = (y, pos, base)  # keeps the addresses alive
        self._args = (y.data_ptr(), y.shape[0], pos.data_ptr(),
                      base.data_ptr())
        self._rows = int(rows)
        self._host = self._host_np = None
        self._host_ptr = 0

    def _buffer(self, n: int) -> None:
        """Grow the mapped host buffer to the next power of two >= n."""
        if self._host is not None and self._host.shape[0] >= n:
            return
        if self._host is not None:  # a launch may still write the old one
            torch.cuda.current_stream(self.device).synchronize()
        self._host = _pinned(1 << (max(n, BLK) - 1).bit_length())
        self._host_np = self._host.numpy()
        self._host_ptr = _build.host_device_pointer(self._host)

    def launch(self, j: int, n: int, wait: bool = False) -> None:
        """Queue samples [j, j + n) into the host buffer; ``wait`` returns
        once they are there."""
        if not (0 <= j and 0 < n and j + n <= self.n_out):
            raise ValueError(f"window [{j}, {j + n}) outside [0, "
                             f"{self.n_out})")
        self._buffer(n)
        _build.launch(resample_lerp, "resample_lerp",
                      "mlx_resample_lerp_window", self.device, *self._args, j,
                      n, self._rows, self._host_ptr, int(wait))

    def read(self, j: int, n: int) -> np.ndarray:
        """Samples [j, j + n) as a view of the host buffer, valid until the
        next launch."""
        self.launch(j, n, wait=True)
        return self._host_np[:n]
