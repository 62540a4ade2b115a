"""Granular render: kernels B5 (per-step grain lerp) and B6 (block compact),
each beside its plain PyTorch twin.

Counterpart of ``melonix_tpu/kernels/pallas_render.py``.  The render of a
plan runs in two passes (``render_full``):

* B5 ``render_steps`` resamples each plan step's grain at ``i * rate`` with
  a lerp into a step-major ``(S, szmax)`` float32 array, zero past the
  step's ``sz``.  The upper tap is ``wav[src + 1]`` (zero at or past the
  end of the track): across a grain boundary that is the next grain's first
  sample, which is the reference's seam wherever grains tile.
* B6 ``compact`` places the rows into the flat track at the plan's
  ascending offsets, the last step covering a sample winning (each step's
  zero tail is overwritten by its successor).
* The host's seam fixes (``engine/render.seam_fixes``: warp jumps,
  track-end grains) are scattered on top.

Both kernels are bit-exact against their twins, and the whole pass against
``tests/oracle.py``: B5 rounds every operation as the oracle does (no FMA
contraction), B6 only moves data.

``render_steps`` and ``compact`` launch ``csrc/render_steps.cu`` and
``csrc/compact.cu`` for CUDA tensors and run ``render_steps_plain`` and
``compact_plain`` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

CBLK = 2048  # output samples per compact block


def _buckets(plan):
    """Powers of two (gmax, szmax) sized to the plan: ``szmax`` is the row
    length of B5's output; ``gmax`` bounds the grain (with its seam tap)."""
    gmax = 1024
    while gmax <= int(plan.grain_len.max()) + 1:
        gmax *= 2
    szmax = 1024
    while szmax < int(plan.sz.max()):
        szmax *= 2
    return gmax, szmax


def compact_blocks(offsets: np.ndarray, nb: int):
    """Host: per-block (first step, live count) for arbitrary ascending
    offsets; ``kmax`` is the largest count.  Block b's first step is the
    last one starting at or before ``b * CBLK``; the count runs to the
    first step starting at or after the block's end."""
    offsets = np.asarray(offsets, np.int64)
    starts = np.arange(nb, dtype=np.int64) * CBLK
    a0 = np.clip(
        np.searchsorted(offsets, starts, side="right") - 1, 0, None
    ).astype(np.int32)
    hi = np.searchsorted(offsets, starts + CBLK, side="left").astype(np.int32)
    cnt = np.maximum(hi - a0, 0).astype(np.int32)
    kmax = int(cnt.max()) if nb else 1
    return a0, cnt, kmax


def render_steps_plain(wav, gs, rate, sz, szmax: int) -> torch.Tensor:
    """(S, szmax) float32: row s, column i < sz[s] holds
    ``(1 - frac) * wav[gs + idx] + frac * wav[gs + idx + 1]`` with
    ``x = f32(i) * rate[s]``, ``idx = floor(x)``, ``frac = x - idx``, reads
    at or past ``len(wav)`` giving 0; columns i >= sz[s] are 0."""
    dev = wav.device
    n = wav.shape[0]
    i = torch.arange(szmax, dtype=torch.int32, device=dev)
    x = i.to(torch.float32)[None, :] * rate[:, None]
    idx = torch.floor(x)
    frac = x - idx
    src = gs.to(torch.int64)[:, None] + idx.to(torch.int64)
    wpad = torch.cat([wav, torch.zeros(1, dtype=wav.dtype, device=dev)])
    lo = wpad[src.clamp(0, n)]
    hi = wpad[(src + 1).clamp(0, n)]
    val = (1.0 - frac) * lo + frac * hi
    return torch.where(i[None, :] < sz[:, None], val, 0.0)


def render_steps(wav, gs, rate, sz, szmax: int) -> torch.Tensor:
    """B5 (``csrc/render_steps.cu``): contract of :func:`render_steps_plain`,
    bit-exact."""
    if wav.device.type == "cpu":
        return render_steps_plain(wav, gs, rate, sz, szmax)
    dev = _build.cuda_device(wav)
    n_steps = gs.shape[0]
    if n_steps == 0 or szmax <= 0:
        raise ValueError(f"empty render: {n_steps} steps, szmax {szmax}")
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(gs, "gs", torch.int32, (n_steps,), dev)
    _build.require(rate, "rate", torch.float32, (n_steps,), dev)
    _build.require(sz, "sz", torch.int32, (n_steps,), dev)
    out = torch.empty((n_steps, szmax), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_render_steps(
            wav.data_ptr(), wav.shape[0], gs.data_ptr(), rate.data_ptr(),
            sz.data_ptr(), n_steps, szmax, out.data_ptr(), _build.stream(dev),
        )
    _build.check("render_steps", err)
    render_steps.launches += 1
    return out


render_steps.launches = 0


def compact_plain(vals, off, out_len: int) -> torch.Tensor:
    """(out_len,) float32: sample j takes ``vals[s, j - off[s]]`` from the
    last step s with ``off[s] <= j < off[s] + szmax``, 0 where none does
    (the ascending fori-loop of ``pallas_render._compact``)."""
    szmax = vals.shape[1]
    j = torch.arange(out_len, dtype=torch.int64, device=vals.device)
    off64 = off.to(torch.int64)
    s = (torch.searchsorted(off64, j, right=True) - 1).clamp_min(0)
    rel = j - off64[s]
    live = (rel >= 0) & (rel < szmax)
    got = vals.reshape(-1)[s * szmax + rel.clamp(0, szmax - 1)]
    return torch.where(live, got, 0.0)


def compact(vals, off, a0, cnt, out_len: int) -> torch.Tensor:
    """B6 (``csrc/compact.cu``): contract of :func:`compact_plain`;
    ``a0``/``cnt`` (from :func:`compact_blocks`) give each 2048-sample
    block's candidate steps."""
    if vals.device.type == "cpu":
        return compact_plain(vals, off, out_len)
    dev = _build.cuda_device(vals)
    if vals.dim() != 2 or vals.shape[0] == 0:
        raise ValueError(f"vals must be (S >= 1, szmax), got {tuple(vals.shape)}")
    n_steps, szmax = vals.shape
    if not 0 < out_len < 2**31:
        raise ValueError(f"out_len {out_len} outside int32 offsets")
    nb = -(-out_len // CBLK)
    _build.require(vals, "vals", torch.float32, (n_steps, szmax), dev)
    _build.require(off, "off", torch.int32, (n_steps,), dev)
    _build.require(a0, "a0", torch.int32, (nb,), dev)
    _build.require(cnt, "cnt", torch.int32, (nb,), dev)
    out = torch.empty((out_len,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_compact(
            vals.data_ptr(), n_steps, szmax, off.data_ptr(), a0.data_ptr(),
            cnt.data_ptr(), out.data_ptr(), out_len, _build.stream(dev),
        )
    _build.check("compact", err)
    compact.launches += 1
    return out


compact.launches = 0


def render_full(wav, grain_start, rate, sz, offsets, out_len: int, fix_idx,
                fix_val, szmax: int) -> torch.Tensor:
    """(out_len,) render of a plan on ``wav``'s device: B5, then B6, then the
    seam fixes ``out[fix_idx] = fix_val`` (indices at or past ``out_len``
    dropped).  The plan arrays (``offsets`` = ``out_offset[:-1]``) and the
    fixes are host NumPy; the block map is built here and everything is
    uploaded once."""
    dev = wav.device
    offsets = np.asarray(offsets, np.int64)
    a0, cnt, _kmax = compact_blocks(offsets, -(-out_len // CBLK))

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    vals = render_steps(wav, put(grain_start, np.int32), put(rate, np.float32),
                        put(sz, np.int32), szmax)
    out = compact(vals, put(offsets, np.int32), put(a0, np.int32),
                  put(cnt, np.int32), out_len)
    keep = np.asarray(fix_idx) < out_len
    out[put(np.asarray(fix_idx)[keep], np.int64)] = put(
        np.asarray(fix_val)[keep], np.float32)
    return out
