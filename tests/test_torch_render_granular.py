"""B5 + B6 as one output-indexed kernel (``csrc/render_granular.cu``),
modelled on the CPU (no card here).

* ``render_granular_plain`` (the kernel's twin) equals the TPU kernels'
  twins composed, ``compact_plain(render_steps_plain(...))``, bit for bit,
  and JAX's ``render_pallas_full(interpret=True)`` with the seam fixes at
  the JAX suite's atol 2e-6 (XLA may contract the lerp into an FMA).
* ``render_track`` on the CPU equals ``tests/oracle.py`` exactly at the
  edges: +-24-semitone bends and a track shorter than one block.
* A NumPy model of the kernel's CTA walk (one 256-thread CTA per
  2048-sample block, candidates staged in shared-memory tiles of
  ``kTile``, 8 outputs a thread at a stride of 256; the constants read from
  the ``.cu``) writes every output once and equals the twin bit for bit.
* The wrapper's refusals and the C call it makes (a recording library on
  ``meta`` tensors).

Cases: plans of the default bucket and of +-24-semitone bends; offsets with
duplicates, a zero-length step and steps parked at and past ``out_len``; a
block of more candidates than one tile; a track shorter than one block.
Inputs come from seeded numpy generators.
"""

import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from melonix_tpu.engine import grains as jgrains
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.engine.render import build_render_plan as j_build_render_plan
from melonix_tpu.kernels import pallas_render
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import render as trender
from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.kernels import render as krender

torch.set_num_threads(2)

BLK = krender.CBLK


def _cu_const(name: str) -> int:
    text = (_build.CSRC / "render_granular.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))


THREADS = _cu_const("kThreads")
TILE = _cu_const("kTile")
PER = _cu_const("kBlk") // THREADS


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _song(sr, seconds, hz=190.0, seed=3):
    t = np.arange(int(sr * seconds)) / sr
    x = (0.6 * np.sin(2 * np.pi * hz * t) + 0.02 * np.sin(2 * np.pi * 41.0 * t)
         + 0.01 * np.random.default_rng(seed).standard_normal(len(t)))
    return x.astype(np.float32)


# (signal seconds, markers as (sample fraction, note, d_time, bend)) at 8 kHz
PLAN_CASES = {
    "default": (0.6, [(0.5, 57.0, 0.03, 4.0)]),
    "+24": (0.5, [(0.125, 57.0, 0.0, 24.0), (0.875, 57.0, 0.0, 24.0)]),
    "-24": (0.5, [(0.125, 57.0, 0.0, -24.0), (0.875, 57.0, 0.0, -24.0)]),
    "bends": (0.8, [(0.2, 57.0, 0.05, 24.0), (0.6, 57.0, -0.02, -24.0)]),
    "short": (0.2, []),  # a track shorter than one block
}
SR = 8000


def _markers(name, n):
    _sec, ms = PLAN_CASES[name]
    return [(int(f * n), note, dt, bend) for f, note, dt, bend in ms]


def _plan_case(name):
    """(wav, plan, markers) of a plan case."""
    x = _song(SR, PLAN_CASES[name][0])
    ms = _markers(name, len(x))
    knots = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], SR, len(x))
    return x, mt.build_render_plan(mt.build_grain_table(x), knots), ms


def _synthetic(name):
    """(wav, gs, rate, sz, off, out_len, szmax) of a hand-built plan: grains
    of 64-900 samples at rates 0.25-4, steps that overlap (a later start
    cuts the earlier step), leave gaps (zero tails) and end past the track
    (taps past n read 0); a zero-length step and a duplicate offset; steps
    parked at and past out_len.  ``"stacked"`` adds 300 zero-length steps
    at one offset: one block with more candidates than a tile."""
    rng = np.random.default_rng(1234)
    n = 6000
    wav = rng.standard_normal(n).astype(np.float32)
    s_live = 40
    gl = rng.integers(64, 900, s_live)
    rate = rng.uniform(0.25, 4.0, s_live).astype(np.float32)
    sz = np.ceil(gl / rate.astype(np.float64)).astype(np.int32)
    gs = rng.integers(0, n - 1000, s_live).astype(np.int32)
    gs[-2] = n - 10  # its taps run past the track's end
    space = (sz * rng.uniform(0.6, 1.3, s_live)).astype(np.int64)
    space[5] = 0  # zero-length step 5 shares step 6's offset
    sz[5] = 0
    space[10] = 0  # step 10, whole, hidden under step 11
    off = np.concatenate([[0], np.cumsum(space)[:-1]])
    out_len = int(off[-1] + sz[-1] // 2)  # the last step cut short
    parked = 3
    if name == "stacked":
        k = 300
        at = int(off[20])
        off = np.concatenate([off[:20], np.full(k, at), off[20:]])
        pad = lambda a, v: np.concatenate(  # noqa: E731
            [a[:20], np.full(k, v, a.dtype), a[20:]])
        gs, rate, sz = pad(gs, 7), pad(rate, np.float32(1.5)), pad(sz, 0)
    off = np.concatenate([off, [out_len, out_len, out_len + 5000]])
    gs = np.concatenate([gs, rng.integers(0, n, parked)]).astype(np.int32)
    rate = np.concatenate([rate, np.ones(parked, np.float32)])
    sz = np.concatenate([sz, np.full(parked, 700, np.int32)])
    szmax = 1024
    while szmax < int(sz.max()):
        szmax *= 2
    return wav, gs, rate, sz, off.astype(np.int64), out_len, szmax


def _operands(case):
    """(wav, gs, rate, sz, off, out_len, szmax) of any case (no fixes)."""
    if case in PLAN_CASES:
        x, plan, _ms = _plan_case(case)
        _gmax, szmax = krender._buckets(plan)
        return (x, plan.grain_start, plan.rate, plan.sz, plan.out_offset[:-1],
                plan.total_out, szmax)
    return _synthetic(case)


ALL_CASES = [*PLAN_CASES, "synthetic", "stacked"]


@pytest.mark.parametrize("case", ALL_CASES)
def test_plain_equals_the_composed_twins(case):
    """Bit for bit against compact_plain(render_steps_plain(...)), the twins
    of the two TPU kernels the one CUDA kernel replaces."""
    wav, gs, rate, sz, off, out_len, szmax = _operands(case)
    args = (_t(wav), _t(gs, np.int32), _t(rate, np.float32), _t(sz, np.int32))
    off_t = _t(off, np.int32)
    got = krender.render_granular_plain(*args, off_t, out_len, szmax)
    want = krender.compact_plain(krender.render_steps_plain(*args, szmax),
                                 off_t, out_len)
    assert got.shape == (out_len,) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert got.any()


def _jax_render_full(wav, gs, rate, sz, off, out_len, fix_idx, fix_val, gmax,
                     szmax):
    return np.asarray(pallas_render.render_pallas_full(
        jnp.asarray(wav), jnp.asarray(gs, jnp.int32),
        jnp.asarray(rate, jnp.float32), jnp.asarray(sz, jnp.int32),
        np.asarray(off, np.int64), out_len, jnp.asarray(fix_idx),
        jnp.asarray(fix_val), gmax=gmax, szmax=szmax, interpret=True))


@pytest.mark.parametrize("case", [*PLAN_CASES, "synthetic"])
def test_render_full_matches_tpu_kernels(case):
    """The CPU render (the twin, then the seam fixes) against the TPU
    kernels in interpret mode with the same fixes: the JAX suite's bar
    (test_pallas.py:213-216), indices and masking exactly."""
    if case in PLAN_CASES:
        x, plan, _ms = _plan_case(case)
        total = plan.total_out
        fix_idx, fix_val = trender.seam_fixes(plan, x, total)
        gmax, szmax = krender._buckets(plan)
        assert (gmax, szmax) == pallas_render._buckets(plan)
        ops = (x, plan.grain_start, plan.rate, plan.sz, plan.out_offset[:-1])
    else:
        *ops, total, szmax = _synthetic(case)
        fix_idx, fix_val = np.zeros(0, np.int32), np.zeros(0, np.float32)
        gmax = 1024
    got = krender.render_full(_t(ops[0]), *ops[1:], total, fix_idx, fix_val,
                              szmax).numpy()
    want = _jax_render_full(*ops, total, np.asarray(fix_idx, np.int32),
                            fix_val, gmax, szmax)
    assert got.shape == want.shape == (total,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.array_equal(got == 0, want == 0)
    if case in PLAN_CASES:  # rate 1 over most of a plan: mostly equal
        assert np.mean(got == want) > 0.8


@pytest.mark.parametrize("case", ["+24", "-24", "bends", "short"])
def test_render_track_equals_oracle_at_the_edges(case):
    """Through render_track on the CPU, exactly the reference's export."""
    x, _plan, ms = _plan_case(case)
    table = mt.build_grain_table(x)
    knots = mt.MapKnots.from_markers([mt.Marker(*m) for m in ms], SR, len(x))
    got = mt.render_track(x, table, knots, device="cpu")
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    want = oracle.export(x, grains, ms, SR)
    np.testing.assert_array_equal(got, want)
    if case == "short":
        assert _plan.n_steps > 0 and len(got) - 1500 < BLK


def test_bend_plans_reach_the_rates_they_name():
    """The bend cases do reach the rate range's ends, 4 and 0.25 (the same
    plans as JAX builds)."""
    for case in ("+24", "-24", "bends"):
        x, plan, ms = _plan_case(case)
        jk = JMapKnots.from_markers([JMarker(*m) for m in ms], SR, len(x))
        jplan = j_build_render_plan(jgrains.build_grain_table(x), jk)
        np.testing.assert_array_equal(plan.rate, jplan.rate)
        np.testing.assert_array_equal(plan.out_offset, jplan.out_offset)
    assert _plan_case("+24")[1].rate.max() >= 3.9
    assert _plan_case("-24")[1].rate.min() <= 0.26


def _cta_walk(wav, gs, rate, sz, off, a0, cnt, out_len, szmax):
    """NumPy model of csrc/render_granular.cu: per CTA b, warp 0 stages the
    candidates min(a0[b] + k, S - 1) tile by tile, each thread scans them
    ascending for its 8 outputs j = b * BLK + t + THREADS * i (the sample
    clamped to out_len - 1 for the choice), then lerps its chosen step's
    taps in float32, each operation rounded on its own.  Returns (out,
    writes per sample)."""
    n, n_steps = len(wav), len(gs)
    f32 = np.float32
    out = np.full(out_len, np.nan, f32)
    writes = np.zeros(out_len, np.int64)
    j_idx = (np.arange(THREADS)[:, None]
             + THREADS * np.arange(PER)[None, :])  # (threads, outputs)
    for b in range(-(-out_len // BLK)):
        first, count = int(a0[b]), int(cnt[b])
        j = b * BLK + j_idx
        jc = np.minimum(j, out_len - 1)
        sel = np.full(j.shape, -1)
        for k0 in range(0, count, TILE):
            tile = np.minimum(first + np.arange(k0, min(count, k0 + TILE)),
                              n_steps - 1)  # the staged candidates
            for k, o in enumerate(off[tile]):  # ascending: the last wins
                sel[o <= jc] = k0 + k
        s = np.minimum(first + sel, n_steps - 1)
        rel = jc - off[s]
        live = (sel >= 0) & (rel < np.minimum(sz[s], szmax))
        x = rel.astype(f32) * rate[s]
        fl = np.floor(x)
        frac = x - fl
        src = gs[s].astype(np.int64) + fl.astype(np.int64)

        def tap(i, live=live):
            ok = live & (i >= 0) & (i < n)
            return np.where(ok, wav[np.clip(i, 0, n - 1)], f32(0.0))

        val = np.where(live, (f32(1.0) - frac) * tap(src) + frac * tap(src + 1),
                       f32(0.0))
        store = j < out_len
        out[j[store]] = val[store]
        np.add.at(writes, j[store], 1)
    return out, writes


@pytest.mark.parametrize("case", ALL_CASES)
def test_cta_walk_writes_each_output_once_and_equals_the_twin(case):
    wav, gs, rate, sz, off, out_len, szmax = _operands(case)
    a0, cnt, kmax = krender.compact_blocks(off, -(-out_len // BLK))
    if case == "stacked":
        assert kmax > TILE  # some block stages several tiles
    gs, sz = np.asarray(gs, np.int32), np.asarray(sz, np.int32)
    rate = np.asarray(rate, np.float32)
    got, writes = _cta_walk(wav, gs, rate, sz, off, a0, cnt, out_len, szmax)
    assert (writes == 1).all()
    want = krender.render_granular_plain(_t(wav), _t(gs), _t(rate), _t(sz),
                                         _t(off, np.int32), out_len, szmax)
    np.testing.assert_array_equal(got, want.numpy())


def test_wrapper_refuses_other_devices():
    meta = torch.empty(4096, device="meta")
    i32 = torch.empty(3, dtype=torch.int32, device="meta")
    f32 = torch.empty(3, device="meta")
    before = krender.render_granular.launches
    with pytest.raises(ValueError, match="no kernel"):
        krender.render_granular(meta, i32, f32, i32, i32, i32[:2], i32[:2],
                                4096, 1024)
    assert krender.render_granular.launches == before


class _Recorder:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrapper's CUDA branch on ``meta`` tensors with a recording
    library: which entry would launch, with which sizes, without a card."""
    rec = _Recorder()
    monkeypatch.setattr(krender.render_granular, "launches",
                        krender.render_granular.launches)  # restored after
    monkeypatch.setattr(_build, "cuda_device", lambda t: t.device)
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return rec


def test_render_full_launches_the_entry_once(fake_cuda):
    """render_full on the card's path: the six plan and block arrays go up
    as one packed array (views of one storage), then one call of
    mlx_render_granular with (n, n_steps, szmax, out_len) and one launch
    counted."""
    x, plan, _ms = _plan_case("bends")
    total = plan.total_out
    fix_idx, fix_val = trender.seam_fixes(plan, x, total)
    _gmax, szmax = krender._buckets(plan)
    before = krender.render_granular.launches
    out = krender.render_full(_t(x).to("meta"), plan.grain_start, plan.rate,
                              plan.sz, plan.out_offset[:-1], total, fix_idx,
                              fix_val, szmax)
    assert out.shape == (total,) and out.device.type == "meta"
    (name, args), = fake_cuda.calls
    assert name == "mlx_render_granular"
    assert (args[1], args[6], args[9], args[11]) == (len(x), plan.n_steps,
                                                     szmax, total)
    assert krender.render_granular.launches == before + 1


def test_plan_upload_is_one_array_of_six_sections():
    x, plan, _ms = _plan_case("default")
    offs = plan.out_offset[:-1]
    a0, cnt, _k = krender.compact_blocks(offs, -(-plan.total_out // BLK))
    want = (plan.grain_start, plan.sz, offs, a0, cnt)
    views = _build.upload_packed(want, (plan.rate,), "cpu")
    assert len(views) == 6
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1
    for got, w in zip(views, want):
        assert got.dtype == torch.int32 and torch.equal(got, _t(w, np.int32))
    assert views[5].dtype == torch.float32
    assert torch.equal(views[5], _t(plan.rate, np.float32))


def test_wrapper_and_render_full_refuse_what_the_kernel_cannot_take(
        fake_cuda):
    meta = torch.device("meta")
    wav = torch.empty(4096, device=meta)
    i32 = torch.empty(3, dtype=torch.int32, device=meta)
    f32 = torch.empty(3, device=meta)
    blocks = torch.empty(1 << 20, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="2\\^31"):
        krender.render_granular(wav, i32, f32, i32, i32, blocks, blocks,
                                2**31, 1024)
    with pytest.raises(ValueError, match="empty render"):
        krender.render_granular(wav, i32[:0], f32[:0], i32[:0], i32[:0],
                                blocks[:1], blocks[:1], 100, 1024)
    with pytest.raises(ValueError, match="offsets outside int32"):
        krender.render_full(wav, np.zeros(2, np.int32), np.ones(2, np.float32),
                            np.ones(2, np.int32), np.array([0, 2**31]), 4096,
                            np.zeros(0, np.int64), np.zeros(0, np.float32),
                            1024)
    assert fake_cuda.calls == []
