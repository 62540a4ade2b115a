"""Granular render: kernels B5 (per-step grain lerp) and B6 (block compact),
fused into one output-indexed CUDA kernel, beside their plain PyTorch twins.

Counterpart of ``melonix_tpu/kernels/pallas_render.py``.  The TPU render of
a plan runs in two passes, each with its plain twin here:

* B5 (:func:`render_steps_plain`) resamples each plan step's grain at
  ``i * rate`` with a lerp into a step-major ``(S, szmax)`` float32 array,
  zero past the step's ``sz``.  The upper tap is ``wav[src + 1]`` (zero at
  or past the end of the track): across a grain boundary that is the next
  grain's first sample, which is the reference's seam wherever grains tile.
* B6 (:func:`compact_plain`) places the rows into the flat track at the
  plan's ascending offsets, the last step covering a sample winning (each
  step's zero tail is overwritten by its successor).

On the card one kernel computes both (:func:`render_granular`,
``csrc/render_granular.cu``): each output sample finds its step and lerps
its taps straight from the track, so the step-major array is never built;
:func:`render_granular_plain` is its twin, output-indexed the same way and
bit-equal to ``compact_plain(render_steps_plain(...))``.  The host's seam
fixes (``engine/render.seam_fixes``: warp jumps, track-end grains) are
scattered on top (:func:`render_full`).

All of it is bit-exact against ``tests/oracle.py``: the lerp rounds every
operation as the oracle does (no FMA contraction), the placement only moves
data.  ``render_granular`` launches the kernel for CUDA tensors and runs
its twin for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tracing
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


def render_granular_plain(wav, gs, rate, sz, off, out_len: int,
                          szmax: int) -> torch.Tensor:
    """(out_len,) float32, output-indexed: sample j takes the last step s
    with ``off[s] <= j`` (offsets ascend), ``rel = j - off[s]``, and is
    :func:`render_steps_plain`'s row s at column rel if ``rel < min(sz[s],
    szmax)``, else 0 (also where no step starts at or before j); taps
    outside ``[0, len(wav))`` read 0.  Bit-equal to
    ``compact_plain(render_steps_plain(...), off, out_len)`` without the
    ``(S, szmax)`` array."""
    dev = wav.device
    n = wav.shape[0]
    j = torch.arange(out_len, dtype=torch.int64, device=dev)
    off64 = off.to(torch.int64)
    s = (torch.searchsorted(off64, j, right=True) - 1).clamp_min(0)
    rel = j - off64[s]
    live = (rel >= 0) & (rel < sz.to(torch.int64)[s].clamp_max(szmax))
    x = rel.to(torch.float32) * rate[s]
    idx = torch.floor(x)
    frac = x - idx
    src = gs.to(torch.int64)[s] + idx.to(torch.int64)
    wpad = torch.cat([wav, torch.zeros(1, dtype=wav.dtype, device=dev)])

    def tap(i):
        return wpad[torch.where((i >= 0) & (i < n), i, n)]

    val = (1.0 - frac) * tap(src) + frac * tap(src + 1)
    return torch.where(live, val, 0.0)


def render_granular(wav, gs, rate, sz, off, a0, cnt, out_len: int,
                    szmax: int) -> torch.Tensor:
    """B5 + B6 (``csrc/render_granular.cu``): contract of
    :func:`render_granular_plain` for int32 plans and ``out_len < 2^31``;
    ``a0``/``cnt`` (from :func:`compact_blocks`) give each 2048-sample
    block's candidate steps, which its CTA stages in shared memory."""
    if wav.device.type == "cpu":
        return render_granular_plain(wav, gs, rate, sz, off, out_len, szmax)
    dev = _build.cuda_device(wav)
    n_steps = gs.shape[0]
    if n_steps == 0 or szmax <= 0 or wav.shape[0] == 0:
        raise ValueError(f"empty render: {n_steps} steps, szmax {szmax}, "
                         f"track of {wav.shape[0]} samples")
    if not 0 < out_len < 2**31:
        raise ValueError(f"out_len {out_len} outside 1 to 2^31 - 1 "
                         "(int32 offsets)")
    nb = -(-out_len // CBLK)
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    for name, t in (("gs", gs), ("sz", sz), ("off", off)):
        _build.require(t, name, torch.int32, (n_steps,), dev)
    _build.require(rate, "rate", torch.float32, (n_steps,), dev)
    _build.require(a0, "a0", torch.int32, (nb,), dev)
    _build.require(cnt, "cnt", torch.int32, (nb,), dev)
    out = torch.empty((out_len,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with (torch.cuda.device(dev),
          tracing.span("kernel.render_granular")):
        err = lib.mlx_render_granular(
            wav.data_ptr(), wav.shape[0], gs.data_ptr(), rate.data_ptr(),
            sz.data_ptr(), off.data_ptr(), n_steps, a0.data_ptr(),
            cnt.data_ptr(), szmax, out.data_ptr(), out_len,
            _build.stream(dev),
        )
    _build.check("render_granular", err)
    render_granular.launches += 1
    return out


render_granular.launches = 0


def render_full(wav, grain_start, rate, sz, offsets, out_len: int, fix_idx,
                fix_val, szmax: int) -> torch.Tensor:
    """(out_len,) render of a plan on ``wav``'s device: :func:`render_granular`
    (B5 + B6), then the seam fixes ``out[fix_idx] = fix_val`` (indices at or
    past ``out_len`` dropped).  The plan arrays (``offsets`` =
    ``out_offset[:-1]``) and the fixes are host NumPy; the block map is built
    here, and the six plan and block arrays go up in one copy."""
    offsets = np.asarray(offsets, np.int64)
    for name, a in (("grain_start", grain_start), ("offsets", offsets)):
        a = np.asarray(a)
        if a.size and (a.min() < -(2**31) or a.max() >= 2**31):
            raise ValueError(f"{name} outside int32")
    a0, cnt, _kmax = compact_blocks(offsets, -(-out_len // CBLK))
    gs_d, sz_d, off_d, a0_d, cnt_d, rate_d = _build.upload_packed(
        (grain_start, sz, offsets, a0, cnt), (rate,), wav.device)
    out = render_granular(wav, gs_d, rate_d, sz_d, off_d, a0_d, cnt_d,
                          out_len, szmax)
    keep = np.asarray(fix_idx) < out_len
    idx = torch.from_numpy(np.asarray(fix_idx, np.int64)[keep])
    val = torch.from_numpy(np.ascontiguousarray(np.asarray(fix_val)[keep],
                                                np.float32))
    out[idx.to(wav.device)] = val.to(wav.device)
    return out
