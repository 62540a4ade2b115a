"""Multi-device sharding of the analysis/render pipeline on torch.distributed
(counterpart of ``melonix_tpu/parallel/sharded.py``).

Two mesh axes, as in the JAX package:

* ``data`` -- a batch of tracks, sessions or channels: pure data
  parallelism;
* ``seq`` -- the sample/frame axis *within* one track: frames are sharded
  contiguously, and what crosses a shard boundary (the STFT window overlap,
  the phase vocoder's analysis phase, phase sum and OLA seam) moves one hop
  between neighbouring ranks.

JAX's ``shard_map`` is one program over all devices; torch.distributed is
one process per rank.  Every rank calls each function with the same
replicated host inputs, computes its own shard on the mesh's device, and
the shards are all-gathered, so every rank returns the whole result (as
``np.asarray`` of the JAX output is whole).  The one-hop ``ppermute``s are
all-gathers of the neighbours' rows (their payloads are a halo or one
frame of bins).  On a gloo group a payload on another device than the CPU
is staged through a host tensor; an NCCL group takes the payload on the
card as it is (no host copy) and refuses one on the CPU.  Each rank computes
on its own card: ``make_audio_mesh`` takes it from ``launch.rank_device``
(``cuda:{LOCAL_RANK}`` under a launcher), and every host operand is
uploaded to it.

A mesh covers the whole process group: ``data`` x ``seq`` ranks, seq
groups of consecutive ranks (rank = data_index * seq + seq_index, the JAX
mesh's row-major device order).  Without a process group, or at world size
1, the mesh is (1, 1) and no collective runs.  The per-rank compute goes
through the port's kernels on CUDA (B2 and B10 in the sequence-parallel
phase vocoder; B2, B3 and B4 in the data-parallel one; B7 in the sharded
columns) and their plain twins on the CPU; the rest is plain torch, as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

import atexit
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import pv as kpv
from ..kernels import resample as kres
from ..utils import Timer, registry
from .launch import grouped, rank_device

_GATHER_TIME = registry("parallel.gather", Timer)
_GATHER_BYTES = registry("parallel.gather_bytes")

# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class AudioMesh:
    """This rank's view of a (data, seq) mesh over the process group.

    ``shape`` is ``{"data": d, "seq": s}``; ``data`` and ``seq`` are the
    process groups of this rank's data column (ranks of one seq index) and
    seq row (ranks of one data index), None at world size 1; ``device`` is
    where this rank computes."""

    shape: dict
    rank: int
    data: object
    seq: object
    device: torch.device

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["seq"]

    @property
    def seq_index(self) -> int:
        return self.rank % self.shape["seq"]


def mesh_shape(n: int, data: int | None = None) -> tuple[int, int]:
    """(data, seq) of an n-rank mesh: ``data`` defaults to the largest power
    of two d with d * d <= n dividing n (sharded.py:30-47); the rest goes to
    ``seq``."""
    if data is None:
        data = 1
        while n % (data * 2) == 0 and data * 2 * data * 2 <= n:
            data *= 2
    if data < 1 or n % data != 0:
        raise ValueError(f"data {data} does not divide {n} ranks")
    return data, n // data


def world_size() -> int:
    """The size of the default process group, 1 without one."""
    return dist.get_world_size() if grouped() else 1


def make_audio_mesh(n: int | None = None, data: int | None = None, *,
                    device=None) -> AudioMesh:
    """A (data, seq) mesh over the whole process group (``n`` defaults to,
    and must equal, its world size).  Every rank must call it, in the same
    order as its other group creations: it creates every data and seq group
    on every rank, in one order.  ``device`` defaults to ``"cuda"`` (no
    fallback), this rank's own card (:func:`launch.rank_device`)."""
    world = world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs a process group of world size {n}; "
            f"this one has {world}"
        )
    d, s = mesh_shape(n, data)
    dev = rank_device("cuda" if device is None else device)
    if world == 1:
        return AudioMesh({"data": 1, "seq": 1}, 0, None, None, dev)
    rank = dist.get_rank()
    data_g = seq_g = None
    for i in range(d):  # seq rows: consecutive ranks
        ranks = list(range(i * s, (i + 1) * s))
        g = dist.new_group(ranks)
        if rank in ranks:
            seq_g = g
    for j in range(s):  # data columns: one seq index each
        ranks = list(range(j, n, s))
        g = dist.new_group(ranks)
        if rank in ranks:
            data_g = g
    return AudioMesh({"data": d, "seq": s}, rank, data_g, seq_g, dev)


# [(default group, device, mesh)]: the "auto" mesh of the live group, kept
# while the group lives and dropped by ``launch.leave_group`` and at exit
# (a process group freed while the interpreter shuts down aborts it)
_AUTO: list = []
atexit.register(_AUTO.clear)


def auto_mesh(device=None) -> AudioMesh | None:
    """The mesh that ``mesh="auto"`` means: a (data, seq) mesh over the
    process group on this rank's card (:func:`launch.rank_device`) when its
    world size is above 1, else None.  It is made once for a group and
    device (every rank makes it at the same call, so its groups form in one
    order on every rank) and reused while that group lives."""
    if world_size() <= 1:
        return None
    dev = rank_device("cuda" if device is None else device)
    world = dist.group.WORLD
    if not _AUTO or _AUTO[0][0] is not world or _AUTO[0][1] != dev:
        _AUTO[:] = [(world, dev, make_audio_mesh(device=dev))]
    return _AUTO[0][2]


def _gather(t: torch.Tensor, group, size: int) -> list[torch.Tensor]:
    """All-gather of equal-shaped tensors over ``group`` (``size`` ranks):
    every rank's tensor, in rank order, on ``t``'s device.  A gloo group
    takes the payload through a host tensor; an NCCL group takes it on the
    card, with no host copy and no wait for the card, and raises for a CPU
    tensor.  The ``parallel.gather`` timer holds the host's time in each
    gather (gloo: the staging and the exchange, after the device work
    queued before it is waited for, outside the timer; NCCL: queueing the
    collective on the stream, whose device time a profile shows as NCCL's
    kernels) and ``parallel.gather_bytes`` the bytes each rank sends."""
    if group is None:  # world size 1
        return [t]
    backend = dist.get_backend(group)
    if backend == "nccl" and t.device.type != "cuda":
        raise ValueError(
            f"an NCCL all-gather of a tensor on {t.device}: NCCL payloads "
            "stay on the card"
        )
    stage = backend == "gloo" and t.device.type != "cpu"
    src = t.detach().contiguous()
    if stage and src.device.type == "cuda":
        torch.cuda.current_stream(src.device).synchronize()
    with _GATHER_TIME:
        src = src.cpu() if stage else src
        out = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(out, src, group=group)
        out = [o.to(t.device) for o in out] if stage else out
    _GATHER_BYTES.inc(src.numel() * src.element_size())
    return out


def _gather_seq(mesh: AudioMesh, t: torch.Tensor) -> list[torch.Tensor]:
    return _gather(t, mesh.seq, mesh.shape["seq"])


def _gather_data(mesh: AudioMesh, t: torch.Tensor) -> list[torch.Tensor]:
    return _gather(t, mesh.data, mesh.shape["data"])


def _on(mesh: AudioMesh, a, dtype=None) -> torch.Tensor:
    """A host array or tensor as a contiguous tensor on the mesh's device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)))
    t = t.to(mesh.device)
    return (t if dtype is None else t.to(dtype)).contiguous()


def _right_halo(mesh: AudioMesh, head: torch.Tensor) -> torch.Tensor:
    """The right neighbour's ``head`` (its leading samples), zeros on the
    last seq rank (windows past the track end read zeros)."""
    i, n = mesh.seq_index, mesh.shape["seq"]
    heads = _gather_seq(mesh, head)
    return torch.zeros_like(head) if i == n - 1 else heads[i + 1]


# ----------------------------------------------------------------------
# Halo-exchange STFT and pitch: sample axis sharded over `seq`
# ----------------------------------------------------------------------


def _stft_local(chunk, halo_from_right, window, size: int, hop: int):
    """|rfft| of the frames whose start lies in this shard; the right halo
    provides their overlap.  (..., n_frames, size // 2 + 1)."""
    local = torch.cat([chunk, halo_from_right], dim=-1)
    n_frames = chunk.shape[-1] // hop
    frames = kpv.hop_frames(local, size, hop, n_frames) * window[None, :]
    spec = torch.fft.rfft(frames)
    return torch.sqrt(spec.real * spec.real + spec.imag * spec.imag)


def _seq_chunk(mesh: AudioMesh, n: int, size: int, hop: int) -> int:
    n_seq = mesh.shape["seq"]
    chunk = n // n_seq
    if n % n_seq or chunk % hop or size - hop > chunk:
        raise ValueError(f"{n} samples over {n_seq} seq shards: each shard "
                         f"must be a multiple of hop {hop} and hold the "
                         f"{size - hop}-sample halo")
    return chunk


def sharded_stft_mags(wav, window, mesh: AudioMesh, *, size: int,
                      hop: int) -> torch.Tensor:
    """STFT magnitudes of one track, sample axis sharded over ``seq``:
    (n // hop, size // 2 + 1), frames at hop * i, zeros past the end.
    ``len(wav)`` must split into seq shards of whole hops, each at least
    ``size - hop`` long (one-hop halo)."""
    w = _on(mesh, wav, torch.float32)
    chunk = _seq_chunk(mesh, w.shape[0], size, hop)
    i = mesh.seq_index
    local = w[i * chunk : (i + 1) * chunk]
    recv = _right_halo(mesh, local[: size - hop])
    mags = _stft_local(local, recv, _on(mesh, window, torch.float32), size,
                       hop)
    return torch.cat(_gather_seq(mesh, mags))


def sharded_pitch(wav, mesh: AudioMesh, *, frame: int, hop: int,
                  lag_min: int, lag_max: int):
    """(lag, clarity, energy) per frame, frame axis sharded over ``seq``
    (the port's ``pitch_core``; the halo contract of
    :func:`sharded_stft_mags`)."""
    from ..engine.pitch import pitch_core

    w = _on(mesh, wav, torch.float32)
    chunk = _seq_chunk(mesh, w.shape[0], frame, hop)
    i = mesh.seq_index
    local = w[i * chunk : (i + 1) * chunk]
    recv = _right_halo(mesh, local[: frame - hop])
    frames = kpv.hop_frames(torch.cat([local, recv]), frame, hop,
                            chunk // hop)
    frames = frames - frames.mean(dim=1, keepdim=True)
    lag, clarity, energy = pitch_core(frames, frame, lag_min, lag_max)
    return tuple(torch.cat(_gather_seq(mesh, v))
                 for v in (lag, clarity, energy))


def sharded_spectrogram_columns(wav, starts, ends, mesh: AudioMesh, *,
                                size: int) -> torch.Tensor:
    """Reference-parity columns (decay 2.5e-4), column axis sharded over
    ``seq`` (each column gathers its own window from the replicated track):
    (B, size // 2), B a multiple of the seq shards.  B7 on CUDA at the
    sizes it takes."""
    from ..engine.spectral import spectrogram_columns_device

    s = _on(mesh, starts, torch.int32)
    e = _on(mesh, ends, torch.int32)
    n_seq, i = mesh.shape["seq"], mesh.seq_index
    if s.shape[0] % n_seq:
        raise ValueError(f"{s.shape[0]} columns over {n_seq} seq shards")
    per = s.shape[0] // n_seq
    cols = spectrogram_columns_device(
        _on(mesh, wav, torch.float32), s[i * per : (i + 1) * per],
        e[i * per : (i + 1) * per], size=size, decay=2.5e-4)
    return torch.cat(_gather_seq(mesh, cols))


# ----------------------------------------------------------------------
# Granular renders: tracks over `data`, one track's output over `seq`
# ----------------------------------------------------------------------


def _scatter_diffs(pos, vals, length: int) -> torch.Tensor:
    """int32 (length,): ``diff(vals)`` added at ``pos`` (out-of-range
    positions dropped), the segmented broadcast's scatter."""
    d = torch.zeros(length, dtype=torch.int32, device=vals.device)
    keep = (pos >= 0) & (pos < length)
    return d.index_put_((pos[keep].long(),), torch.diff(vals)[keep],
                        accumulate=True)


def _seg_i32(pos, vals, base, length: int) -> torch.Tensor:
    """``base + cumsum(scatter of diff(vals) at pos)`` in int32: each sample
    holds the value of the last step starting at or before it."""
    return base + torch.cumsum(_scatter_diffs(pos, vals, length), dim=0,
                               dtype=torch.int32)


def _render_one(wav, grain_start, grain_len, rate, out_offset, seam_src,
                n_valid: int, out_len: int) -> torch.Tensor:
    """One track's granular render from its padded plan: per-step constants
    reach the samples by int32 segmented broadcasts (exact), two waveform
    gathers, the seam and in-grain masks kept in place
    (sharded.py:200-237)."""
    n = wav.shape[0]
    j = torch.arange(out_len, dtype=torch.int32, device=wav.device)
    offsets = out_offset[:-1].to(torch.int32)
    pos = offsets[1:]

    def seg(vals):
        return _seg_i32(pos, vals, vals[0], out_len)

    off = seg(offsets)
    gs = seg(grain_start.to(torch.int32))
    gl = seg(grain_len.to(torch.int32))
    seam = seg(seam_src.to(torch.int32))
    r = seg(rate.to(torch.float32).view(torch.int32)).view(torch.float32)
    x = (j - off).to(torch.float32) * r
    idx_f = torch.floor(x)
    frac = x - idx_f
    idx = idx_f.to(torch.int32)
    src = gs + idx
    in_grain = idx + 1 < gl

    def tap(i):
        return wav[i.clamp(0, n - 1).long()]

    zero = torch.zeros((), dtype=torch.float32, device=wav.device)
    hi = torch.where(in_grain, tap(src + 1),
                     torch.where(seam >= 0, tap(seam), zero))
    out = (1.0 - frac) * tap(src) + frac * hi
    return torch.where(j < n_valid, out, zero)


def _data_rows(mesh: AudioMesh, n_rows: int) -> range:
    """The rows of an ``n_rows`` batch that this rank's data index takes:
    one contiguous block, blocks in data-index order."""
    d = mesh.shape["data"]
    if n_rows % d:
        raise ValueError(f"{n_rows} rows over {d} data shards")
    per = n_rows // d
    return range(mesh.data_index * per, (mesh.data_index + 1) * per)


def _my_rows(mesh: AudioMesh, n_rows: int, local: bool) -> range:
    """This rank's rows of a batch operand of ``n_rows`` rows: all of them
    when the operand holds only this rank's rows (``local``), else its
    block of the whole batch."""
    return range(n_rows) if local else _data_rows(mesh, n_rows)


def data_max(mesh: AudioMesh, shared, own) -> tuple[np.ndarray, np.ndarray]:
    """One all-gather over ``data`` of this rank's host integers: the
    elementwise maximum of every rank's ``shared``, and every rank's ``own``
    (values of its block of rows, as many on every rank) in data-index
    order.  What a batch whose ranks planned only their own rows needs to
    agree on: the padded shapes and each row's lengths."""
    vals = np.concatenate([np.asarray(shared, np.int64),
                           np.asarray(own, np.int64)])
    got = torch.stack(_gather_data(mesh, _on(mesh, vals))).cpu().numpy()
    k = len(shared)
    return got[:, :k].max(axis=0), got[:, k:].reshape(-1)


def data_parallel_render(wav_b, grain_start_b, grain_len_b, rate_b,
                         out_offset_b, seam_src_b, n_valid_b,
                         mesh: AudioMesh, out_len: int, *,
                         local: bool = False) -> torch.Tensor:
    """Batched granular render, tracks sharded over ``data``: (B, out_len)
    from (B, n) tracks and the padded plans of
    :func:`granular_batch_args`.  With ``local`` the operands hold only
    this rank's block of rows (B / data of them), and only they are
    uploaded; the result is the whole batch either way."""
    ops = [_on(mesh, a) for a in (wav_b, grain_start_b, grain_len_b, rate_b,
                                  out_offset_b, seam_src_b, n_valid_b)]
    ops[0] = ops[0].to(torch.float32)
    rows = [_render_one(*(a[r] for a in ops[:6]), int(ops[6][r]), out_len)
            for r in _my_rows(mesh, ops[0].shape[0], local)]
    return torch.cat(_gather_data(mesh, torch.stack(rows)))


def seq_parallel_render(mesh: AudioMesh, wav, offsets, gstart, rate_bits,
                        base_off, base_gs, base_rb, n_valid_out: int,
                        out_len: int, fix_idx, fix_val) -> torch.Tensor:
    """Seq-sharded single-track granular render (sharded.py:273-348): each
    seq rank renders out_len / seq samples from its host-supplied step
    bases, scatters only the step starts strictly inside its span and
    cumsums locally (no collective but the final gather); seam fixes drop to
    the owning rank.  (out_len,), out_len a multiple of the seq shards."""
    n_seq, i = mesh.shape["seq"], mesh.seq_index
    if out_len % n_seq:
        raise ValueError(f"out_len {out_len} over {n_seq} seq shards")
    length = out_len // n_seq
    w = _on(mesh, wav, torch.float32)
    offs, gs_s, rb_s = (_on(mesh, a, torch.int32)
                        for a in (offsets, gstart, rate_bits))
    b_off, b_gs, b_rb = (_on(mesh, a, torch.int32)[i]
                         for a in (base_off, base_gs, base_rb))
    shard0 = i * length
    j = shard0 + torch.arange(length, dtype=torch.int32, device=w.device)
    n = w.shape[0]
    # step starts at or before shard0 are folded into the bases; a start
    # exactly at shard0 is the base itself
    p = offs[1:] - shard0
    pos = torch.where(p >= 1, p, length)
    off = _seg_i32(pos, offs, b_off, length)
    gs = _seg_i32(pos, gs_s, b_gs, length)
    r = _seg_i32(pos, rb_s, b_rb, length).view(torch.float32)
    x = (j - off).to(torch.float32) * r
    idx_f = torch.floor(x)
    frac = x - idx_f
    src = gs + idx_f.to(torch.int32)
    lo = w[src.clamp(0, n - 1).long()]
    hi = w[(src + 1).clamp(0, n - 1).long()]
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    out = torch.where(j < n_valid_out, (1.0 - frac) * lo + frac * hi, zero)
    fpos = _on(mesh, fix_idx, torch.int32) - shard0
    keep = (fpos >= 0) & (fpos < length)
    out[fpos[keep].long()] = _on(mesh, fix_val, torch.float32)[keep]
    return torch.cat(_gather_seq(mesh, out))


def seq_render(mesh: AudioMesh, plan, wav) -> tuple[np.ndarray, int]:
    """Pad, build operands and run ONE track's seq-sharded granular render:
    (padded output as a host array, n_grain_out)."""
    n_grain_out = int(plan.out_offset[-1]) if len(plan.out_offset) else 0
    if n_grain_out == 0 or plan.n_steps == 0:
        return np.zeros(0, np.float32), 0
    blk = mesh.shape["seq"] * 1024
    out_len = blk * -(-n_grain_out // blk)
    wav_np = np.asarray(wav, np.float32)
    args = seq_render_args(plan, wav_np, out_len, mesh.shape["seq"])
    out = seq_parallel_render(mesh, wav_np, *args[:6], int(args[6]), out_len,
                              args[7], args[8])
    return out.cpu().numpy(), n_grain_out


def seq_render_args(plan, wav, out_len: int, n_seq: int):
    """Host operands for :func:`seq_parallel_render`: the single-track
    device operands (``engine.render.render_device_args``) plus each seq
    shard's active-step base values, read off the host plan."""
    from ..engine.render import render_device_args

    offsets, gstart, rate_bits, n_valid, _out_len, fix_idx, fix_val = (
        render_device_args(plan, wav, out_len)
    )
    assert out_len % n_seq == 0, (out_len, n_seq)
    shard0 = np.arange(n_seq, dtype=np.int64) * (out_len // n_seq)
    sa = np.clip(
        np.searchsorted(offsets.astype(np.int64), shard0, side="right") - 1,
        0, len(offsets) - 1,
    ).astype(np.int64)
    return (
        offsets, gstart, rate_bits,
        offsets[sa].copy(), gstart[sa].copy(), rate_bits[sa].copy(),
        n_valid, fix_idx, fix_val,
    )


def granular_batch_args(plans, dims=None):
    """Bucket per-track RenderPlans to shared shapes for
    :func:`data_parallel_render`: padding steps carry strictly increasing
    out_offsets past each track's n_valid with rate 1, length 1 and seam -1,
    all masked out by ``n_valid``.  ``dims``, (steps, output length), gives
    shapes agreed over more plans than these (:func:`data_max`).  Returns
    (gs, gl, rt, oo, ss, nv, out_max)."""
    s_max, out_max = dims if dims is not None else granular_dims(plans)
    B = len(plans)
    gs = np.zeros((B, s_max), np.int32)
    gl = np.ones((B, s_max), np.int32)
    rt = np.ones((B, s_max), np.float32)
    oo = np.full((B, s_max + 1), 2**30, np.int32)
    ss = np.full((B, s_max), -1, np.int32)
    nv = np.zeros((B,), np.int32)
    for b, p in enumerate(plans):
        s = p.n_steps
        gs[b, :s] = p.grain_start
        gl[b, :s] = p.grain_len
        rt[b, :s] = p.rate
        oo[b, : s + 1] = p.out_offset
        oo[b, s + 1 :] = p.out_offset[-1] + 1 + np.arange(s_max - s)
        ss[b, :s] = p.seam_src
        nv[b] = p.out_offset[-1]
    return gs, gl, rt, oo, ss, nv, out_max


def granular_dims(plans) -> tuple[int, int]:
    """The shapes :func:`granular_batch_args` pads ``plans`` to: (most
    steps, longest grain output)."""
    return (max(p.n_steps for p in plans),
            max(int(p.out_offset[-1]) for p in plans))


# ----------------------------------------------------------------------
# Phase vocoder: tracks over `data`, one track's frames over `seq`
# ----------------------------------------------------------------------


def _wsum_masked(window, fr: int, size: int, hop: int, n_frames: int,
                 stretch_len: int) -> torch.Tensor:
    """Window-square OLA normaliser counting only frames < ``fr``
    (sharded.py:400-427): the padded frames carry no signal, so they carry
    no window energy either (else the real tail would be attenuated by up
    to size - hop samples).  The same float32 sums in the same order as the
    JAX package's."""
    k = size // hop
    pad_f = (-n_frames) % k
    total = (n_frames + pad_f) * hop + (k - 1) * hop + size
    w2 = window * window
    wsum = torch.zeros(total, dtype=torch.float32, device=window.device)
    segw0 = w2.repeat((n_frames + pad_f) // k)
    frame_of = torch.arange(segw0.shape[0], device=window.device) // size * k
    zero = torch.zeros((), dtype=torch.float32, device=window.device)
    for g in range(k):
        segw = torch.where(frame_of + g < fr, segw0, zero)
        wsum[g * hop : g * hop + segw.shape[0]] += segw
    out = (wsum[:stretch_len] if total >= stretch_len
           else torch.nn.functional.pad(wsum, (0, stretch_len - total)))
    return out.clamp_min(1e-8)


def _anchors(mesh: AudioMesh, anc_j, src_b, r_b, s_b):
    """Anchor operands on the mesh's device: int32 positions and the float
    values from their int32 bit patterns."""
    f32 = [_on(mesh, np.asarray(a, np.int32).view(np.float32))
           for a in (src_b, r_b, s_b)]
    return (_on(mesh, anc_j, torch.int32), *f32)


def data_parallel_pv(mesh: AudioMesh, *, size: int, hop: int, n_frames: int,
                     stretch_len: int, n_out_pad: int, sr: int,
                     formant: bool = False, n_ceps: int = 40,
                     lock: bool = False, local: bool = False):
    """Full PV render (stretch, masked normalisation, resample) of a batch
    of tracks sharded over ``data``; every track's plan fits one stretch
    chunk (:func:`pv_batch_args` buckets them to shared shapes).  Each row
    runs the engine's chunk core (B2 and B3 on CUDA at 2048 points, with
    formants and locking), :func:`_wsum_masked`, and B4 for the resample
    (the contract of the JAX package's XLA positions + lerp).

    Returns f(wav_b, starts_b, da_b, rho_b, f_real_b, window, anc_j_b,
    src_b, r_b, s_b, base_b) -> (B, n_out_pad) audio.  With ``local`` the
    batch operands hold only this rank's block of rows, and only they are
    uploaded.  (The JAX builder's ``fused``/``interpret`` pick its TPU
    kernels; here the device does.)"""
    from ..engine.phase_vocoder import _stretch_chunk_core

    n_bins = size // 2 + 1
    nb = n_out_pad // kres.BLK

    def step(wav_b, starts_b, da_b, rho_b, f_real_b, window, anc_j_b, src_b,
             r_b, s_b, base_b):
        win = _on(mesh, window, torch.float32)
        wav_b = _on(mesh, wav_b, torch.float32)
        f_real_b = np.asarray(f_real_b)
        z = torch.zeros(n_bins, dtype=torch.float32, device=mesh.device)
        rows = []
        for r in _my_rows(mesh, wav_b.shape[0], local):
            fr = int(f_real_b[r])
            y, _, _, _ = _stretch_chunk_core(
                wav_b[r], _on(mesh, starts_b[r], torch.int32),
                _on(mesh, da_b[r], torch.float32), win, 0, fr, z, z, z,
                size=size, hop=hop,
                rho_c=_on(mesh, rho_b[r], torch.float32) if formant else None,
                formant=formant, n_ceps=n_ceps, lock=lock,
            )
            y = y[:stretch_len] / _wsum_masked(win, fr, size, hop, n_frames,
                                               stretch_len)
            aj = np.asarray(anc_j_b[r])
            live = aj < n_out_pad  # the padding anchors sit at n_out_pad
            a0, cnt, _ = kres.pv_anchor_blocks(aj[live], nb)
            anc = _anchors(mesh, aj[live], np.asarray(src_b[r])[live],
                           np.asarray(r_b[r])[live],
                           np.asarray(s_b[r])[live])
            rows.append(kres.resample_pv(
                y, _on(mesh, base_b[r], torch.int32)[:nb],
                _on(mesh, a0), _on(mesh, cnt), *anc, sr, n_out_pad))
        return torch.cat(_gather_data(mesh, torch.stack(rows)))

    return step


def pv_dims(plans) -> tuple[int, int, int, int]:
    """The shapes :func:`pv_batch_args` pads ``plans`` to: (frames, padded
    output, anchors, block bases)."""
    return (max(p.n_frames for p in plans), max(p.n_out_pad for p in plans),
            max(p.anc_args[0].shape[0] for p in plans),
            max(len(p.base) for p in plans))


def pv_batch_args(plans, dims=None):
    """Bucket per-track PVPlans (one (size, hop, sr)) to the shared shapes
    :func:`data_parallel_pv` needs: tracks pad with edge frames masked by
    f_real.  ``dims`` gives shapes agreed over more plans than these
    (:func:`pv_dims`, :func:`data_max`).  Returns (builder kwargs, operand
    arrays)."""
    size, hop, sr = plans[0].size, plans[0].hop, plans[0].sr
    assert all((p.size, p.hop, p.sr) == (size, hop, sr) for p in plans)
    n_frames, n_out_pad, n_anc, n_base = (
        pv_dims(plans) if dims is None else dims)
    stretch_len = (n_frames - 1) * hop + size

    def pad1(a, n, mode="edge", const=None):
        a = np.asarray(a)
        if const is not None:
            return np.pad(a, (0, n - len(a)), constant_values=const)
        return np.pad(a, (0, n - len(a)), mode=mode)

    starts_b = np.stack([pad1(p.starts_m, n_frames) for p in plans])
    da_b = np.stack([pad1(p.da_m, n_frames, const=float(hop)) for p in plans])
    rho_b = np.stack(
        [pad1(p.rho_m.astype(np.float32), n_frames) for p in plans]
    )
    f_real_b = np.asarray([p.n_frames for p in plans], np.int32)
    anc_j_b = np.stack(
        [pad1(np.asarray(p.anc_args[0]), n_anc, const=n_out_pad) for p in plans]
    )
    src_b = np.stack([pad1(np.asarray(p.anc_args[1]), n_anc) for p in plans])
    r_b = np.stack([pad1(np.asarray(p.anc_args[2]), n_anc) for p in plans])
    s_b = np.stack([pad1(np.asarray(p.anc_args[3]), n_anc) for p in plans])
    base_b = np.stack([pad1(p.base, n_base) for p in plans])
    builder_kw = dict(
        size=size, hop=hop, n_frames=n_frames,
        stretch_len=stretch_len, n_out_pad=n_out_pad, sr=sr,
    )
    ops = (starts_b, da_b, rho_b, f_real_b, anc_j_b, src_b, r_b, s_b, base_b)
    return builder_kw, ops


def seq_parallel_pv(mesh: AudioMesh, *, size: int, hop: int, n_frames: int,
                    n_out_pad: int, sr: int, formant: bool = False,
                    n_ceps: int = 40, lock: bool = False):
    """Seq-sharded PV render of ONE track (sharded.py:603-785).

    Returns f(wav, starts, da, rho, f_real, window, anc_j, src_b, r_b, s_b,
    base) -> (n_out_pad,) audio, whole on every rank.  ``starts/da/rho``
    are the PVPlan frame arrays padded to ``n_frames`` (a multiple of the
    seq shards; :func:`seq_pv_args`); ``f_real`` masks the live count.

    Each seq rank takes n_frames / seq consecutive frames: analysis (B2 at
    2048 points on CUDA, over whole frame pairs of the global order, so its
    bins are one call's whatever the split), the formant gain, its left neighbour's last
    analysis phase, the princarg increments (global frame 0 zeroed), a
    local cumsum plus the exclusive carry of the preceding ranks' totals,
    summed in rank order (every rank forms the same value) and in float64,
    rounded to float32 once: the phase sums then depend neither on the
    number of shards nor on the device (the JAX package sums in float32,
    which on a 180 s track drifts ~5e-3 of rms off the exact sum), phi0
    from rank 0, the exact int mod-size ramp, identity locking,
    the live mask, then B10 (:func:`kernels.pv.synth_ola`, the twin at other
    sizes) and its (size - hop)-sample spill added to the right neighbour's
    head, over the rank's slice of the masked normaliser.  The normalised
    stretch is gathered to every rank, each resamples its own output blocks
    (the positions twin and lerp; the JAX package runs XLA there) and the
    output is gathered.  Four all-gathers over the seq group per call in
    the stretch: each rank's last analysis phase, its (first analysis
    phase, phase-sum total) pair, its OLA spill and its normalised span;
    and one of the output."""
    from ..engine.phase_vocoder import _analysis, _formant_gain, identity_lock

    n_seq, idx = mesh.shape["seq"], mesh.seq_index
    if n_frames % n_seq:
        raise ValueError(f"n_frames {n_frames} over {n_seq} seq shards")
    f_loc = n_frames // n_seq
    if f_loc * hop < size - hop:
        raise ValueError("shard span shorter than the OLA spill")
    if n_out_pad % (n_seq * kres.BLK):
        raise ValueError(f"n_out_pad {n_out_pad} over {n_seq} x {kres.BLK}")
    n_bins = size // 2 + 1
    span = n_frames * hop  # the fully covered stretched span
    n_loc = n_out_pad // n_seq
    synth = kpv.synth_ola if size == kpv.FFT_N else kpv.synth_ola_plain
    step_w = float(np.float32(2.0 * np.pi / size))

    # B2 transforms the frames of a call in pairs (2j, 2j + 1): each shard
    # analyses whole pairs of the global frame order, one frame more at an
    # odd edge, so that no frame's bins depend on how the frames are split
    lo, hi = idx * f_loc, (idx + 1) * f_loc
    lo2, hi2 = lo - lo % 2, min(hi + hi % 2, n_frames)

    def stretch(wav, starts_l, da_l, rho_l, f_real: int, win, wsum_l):
        dev = wav.device
        re, im = (a[lo - lo2 : lo - lo2 + f_loc]
                  for a in _analysis(wav, starts_l, win, size))
        mag = torch.sqrt(re * re + im * im)
        phi = torch.atan2(im, re)
        del re, im
        if formant:
            mag = mag * _formant_gain(mag, rho_l, size, n_ceps)
        k_idx = torch.arange(n_bins, device=dev)
        omega = k_idx.to(torch.float32) * step_w
        m_global = idx * f_loc + torch.arange(f_loc, device=dev)
        da = da_l.clamp_min(1e-3)[:, None]
        # the left neighbour's last analysis phase seeds my first frame
        prev_last = _gather_seq(mesh, phi[-1])[(idx - 1) % n_seq]
        phi_prev = torch.cat([prev_last[None, :], phi[:-1]], dim=0)
        dphi = torch.remainder(phi - phi_prev - omega[None, :] * da
                               + kpv.PI, kpv.TWO_PI) - kpv.PI
        incr = hop * dphi / da
        incr[m_global == 0] = 0.0  # global frame 0: psi_0 = phi_0 exactly
        local_cum = torch.cumsum(incr.double(), dim=0)
        del incr, dphi, phi_prev
        rows = _gather_seq(mesh, torch.stack([phi[0].double(), local_cum[-1]]))
        carry = torch.zeros(n_bins, dtype=torch.float64, device=dev)
        for r in range(idx):  # the preceding ranks' totals, in rank order
            carry = carry + rows[r][1]
        phi0 = rows[0][0].float()
        hm = (m_global * hop) % size
        ramp = ((hm[:, None] * k_idx[None, :]) % size).to(torch.float32)
        psis = (phi0[None, :] + ramp * step_w
                + (carry[None, :] + local_cum).float())
        del ramp, local_cum
        if lock:
            psis = identity_lock(psis, phi, mag)
        live = (m_global < f_real)[:, None]
        mag_live = torch.where(live, mag, torch.zeros((), device=dev))
        buf = synth(mag_live.contiguous(), psis.contiguous(), win, size, hop)
        # OLA seam: my tail overlaps the right neighbour's head
        spill = buf[f_loc * hop :]
        recv = _gather_seq(mesh, spill)[(idx - 1) % n_seq]
        keep = buf[: f_loc * hop].clone()
        if idx != 0:
            keep[: size - hop] += recv
        return keep / wsum_l

    def f(wav, starts, da, rho, f_real, window, anc_j, src_b, r_b, s_b,
          base):
        w = _on(mesh, wav, torch.float32)
        win = _on(mesh, window, torch.float32)
        fr = int(f_real)
        sl = slice(lo, hi)
        wsum = _wsum_masked(win, fr, size, hop, n_frames, span)
        y_l = stretch(
            w, _on(mesh, np.asarray(starts)[lo2:hi2], torch.int32),
            _on(mesh, np.asarray(da)[sl], torch.float32),
            _on(mesh, np.asarray(rho)[sl], torch.float32), fr, win,
            wsum[idx * f_loc * hop : (idx + 1) * f_loc * hop])
        y = torch.cat(_gather_seq(mesh, y_l))
        aj, src, rr, ss = _anchors(mesh, anc_j, src_b, r_b, s_b)
        j0 = idx * n_loc
        pos = kres.positions_rel_plain(aj, src, rr, ss, sr, n_loc, j0=j0)
        base_l = _on(mesh, base, torch.int32)[
            j0 // kres.BLK : (j0 + n_loc) // kres.BLK]
        out = kres.lerp_resample_rel(y, pos, base_l, span)
        return torch.cat(_gather_seq(mesh, out))

    return f


def seq_pv_args(plan, n_seq: int):
    """Pad a PVPlan's operands to seq-shardable shapes: (builder kwargs,
    operands).  Frame arrays pad to a multiple of ``n_seq`` past a window's
    worth of extra frames (so the fully covered span
    n_frames * hop reaches the real stretched tail; padded frames are
    masked live by f_real), the resample side to a multiple of ``n_seq *
    BLK`` output samples."""
    extra = -(-plan.size // plan.hop) - 1
    n_frames = n_seq * -(-(plan.n_frames + extra) // n_seq)
    pad_f = n_frames - plan.n_frames
    starts = np.pad(plan.starts_m, (0, pad_f), mode="edge")
    da = np.pad(plan.da_m, (0, pad_f), constant_values=float(plan.hop))
    rho = np.pad(plan.rho_m.astype(np.float32), (0, pad_f), mode="edge")

    quantum = n_seq * kres.BLK
    n_out_pad = quantum * -(-plan.n_out_pad // quantum)
    nb = n_out_pad // kres.BLK
    base = np.pad(np.asarray(plan.base), (0, nb - len(plan.base)), mode="edge")
    builder_kw = dict(
        size=plan.size, hop=plan.hop, n_frames=n_frames,
        n_out_pad=n_out_pad, sr=plan.sr,
    )
    anc_j, src_b, r_b, s_b = (np.asarray(a) for a in plan.anc_args)
    ops = (
        starts, da, rho, np.int32(plan.n_frames),
        anc_j, src_b, r_b, s_b, base,
    )
    return builder_kw, ops


# ----------------------------------------------------------------------
# Session steps: analysis (tracks over data, frames over seq) and renders
# ----------------------------------------------------------------------


def _halo_stft_mags(mesh: AudioMesh, wav_b, window, size: int, hop: int):
    """(B, F, bins) magnitudes: tracks over ``data``, frames over ``seq``,
    the window overlap through the right neighbour's halo."""
    wb = _on(mesh, wav_b, torch.float32)
    rows = list(_data_rows(mesh, wb.shape[0]))
    chunk = _seq_chunk(mesh, wb.shape[1], size, hop)
    i = mesh.seq_index
    local = wb[rows[0] : rows[-1] + 1, i * chunk : (i + 1) * chunk]
    recv = _right_halo(mesh, local[:, : size - hop].contiguous())
    cat = torch.cat([local, recv], dim=-1)
    win = _on(mesh, window, torch.float32)
    mags = torch.stack([_stft_local(r[:chunk], r[chunk:], win, size, hop)
                        for r in cat])
    mags = torch.cat(_gather_seq(mesh, mags), dim=1)
    return torch.cat(_gather_data(mesh, mags))


def session_step(mesh: AudioMesh, *, stft_size: int, stft_hop: int):
    """A full-pipeline step over ``mesh``: f(wav_b, window, gs, gl, rate,
    oo, ss, nv, out_len) -> (stft_mags, rendered)."""

    def step(wav_b, window, gs, gl, rate, oo, ss, nv, out_len):
        mags = _halo_stft_mags(mesh, wav_b, window, stft_size, stft_hop)
        rendered = data_parallel_render(wav_b, gs, gl, rate, oo, ss, nv,
                                        mesh, out_len)
        return mags, rendered

    return step


def session_step_full(mesh: AudioMesh, *, stft_size: int, stft_hop: int,
                      pv_size: int, pv_hop: int, pv_frames: int,
                      pv_stretch_len: int, pv_out_pad: int, sr: int):
    """Both engines in one step: sharded-STFT analysis, the data-parallel
    granular render and the data-parallel PV render.  Returns f(wav_b,
    window, granular plan..., out_len, pv_window, pv operands...) ->
    (stft_mags, granular, pv)."""
    pv = data_parallel_pv(
        mesh, size=pv_size, hop=pv_hop, n_frames=pv_frames,
        stretch_len=pv_stretch_len, n_out_pad=pv_out_pad, sr=sr,
    )

    def step(wav_b, window, gs, gl, rate, oo, ss, nv, out_len,
             pv_window, starts_b, da_b, rho_b, f_real_b,
             anc_j_b, src_b, r_b, s_b, base_b):
        mags = _halo_stft_mags(mesh, wav_b, window, stft_size, stft_hop)
        rendered = data_parallel_render(wav_b, gs, gl, rate, oo, ss, nv,
                                        mesh, out_len)
        pv_out = pv(wav_b, starts_b, da_b, rho_b, f_real_b, pv_window,
                    anc_j_b, src_b, r_b, s_b, base_b)
        return mags, rendered, pv_out

    return step
