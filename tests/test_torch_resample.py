"""B4's and B11's CUDA designs, modelled on the CPU (no card here).

* B4 (``csrc/resample_pv.cu``): one 256-thread CTA per 2048-sample output
  block, the block's anchors staged in shared-memory tiles, 8 outputs a
  thread at a stride of 256.  A torch model of that walk must write every
  output once and equal the plain twin ``resample_pv_plain`` bit for bit
  (it shares the twin's formulas, so any difference is the index map or the
  anchor choice), on bent-track plans, plans with >= 3 anchors a block and
  a block whose anchors span several tiles; and it must meet the TPU kernel
  (``resample_pv_pallas`` in interpret mode) at the bars of
  ``tests/test_torch_kernels.py`` (atol 5e-3, SNR < -60 dB).
* B4's operands go up as one packed array: its sections read back equal.
* B11's general wrapper runs the live read's entry over its whole output.
* B11's live read (``csrc/resample_lerp.cu``'s window entry through
  ``kres.LerpReader``): a model of the window's index map equals the twin
  over the covering blocks, and the TPU kernel, bit for bit, at windows that
  start or end inside a block and on the final odd block; the launcher's
  checks (on CPU and ``meta`` tensors) and the C call it makes (a recording
  library).

Inputs come from seeded numpy generators.
"""

import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.engine import phase_vocoder as jpv
from melonix_tpu.engine.maps import MapKnots as JMapKnots
from melonix_tpu.kernels import pallas_resample
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import phase_vocoder as tpv
from melonix_tpu_torch.engine import pv_stream as tps
from melonix_tpu_torch.kernels import _build
from melonix_tpu_torch.kernels import resample as kres
from torch_fake_card import fake_card

torch.set_num_threads(2)

SR = 8000
BLK = kres.BLK


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cu_const(name: str) -> int:
    text = (_build.CSRC / "resample_pv.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))


THREADS = _cu_const("kThreads")
TILE = _cu_const("kAncTile")
PER = BLK // THREADS


def _snr_db(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))


# ----------------------------------------------------------------------
# B4: the CTA walk
# ----------------------------------------------------------------------


def _markers(kind: str, n: int):
    if kind == "bent":  # tests/test_torch_live.py's bent_track
        return [JMarker(n // 3, 52.0, 0.08, 4.0),
                JMarker(2 * n // 3, 52.0, -0.03, -2.0)]
    rng = np.random.default_rng(7)
    spacing = {"dense": 400, "denser": 120}[kind]
    return [JMarker(int(s), 57.0, float(rng.uniform(-0.004, 0.004)),
                    float(rng.uniform(-3.0, 3.0)))
            for s in np.arange(1000, n - 1000, spacing)]


def _plan_case(kind: str):
    n = 4 * SR
    jplan = jpv.build_pv_plan(JMapKnots.from_markers(_markers(kind, n), SR, n),
                              n)
    plan = tpv.pv_plan_from_numpy(
        {k: getattr(jplan, k) for k in jplan.__dataclass_fields__})
    y = np.random.default_rng(5).standard_normal(plan.stretch_len)
    anc_j, src, r, s, n_real = plan.anc_np
    nb = plan.n_out_pad // BLK
    a0, cnt, kmax = kres.pv_anchor_blocks(anc_j[:n_real], nb)
    ops = (_t(plan.base), _t(a0), _t(cnt)) + tuple(
        _t(a[:n_real]) for a in (anc_j, src, r, s))
    return jplan, plan, _t(y.astype(np.float32)), ops, kmax


def _cta_model(y, base, a0, cnt, anc_j, anc_src, anc_r, anc_s, sr, n_out):
    """B4's kernel as a torch model: CTA b, thread t, output i at j = b *
    2048 + t + 256 i; anchors [a0, a0 + cnt) scanned in shared-memory tiles
    of TILE, the last at or before j kept; then the twin's position and lerp
    formulas.  Returns the output and how often each sample was written."""
    nb = n_out // BLK
    n_src, n_anc = y.shape[0], anc_j.shape[0]
    b = torch.arange(nb)[:, None, None]
    t = torch.arange(THREADS)[None, :, None]
    i = torch.arange(PER)[None, None, :]
    j = (b * BLK + t + THREADS * i).to(torch.int32)
    sel = torch.full(j.shape, -1, dtype=torch.int64)
    for k0 in range(0, int(cnt.max()), TILE):  # the CTA's tile passes
        for k in range(k0, min(k0 + TILE, int(cnt.max()))):
            a = (a0.long() + k).clamp_max(n_anc - 1)[:, None, None]
            take = (k < cnt)[:, None, None] & (anc_j[a] <= j)
            sel = torch.where(take, a.expand(j.shape), sel)
    assert int(sel.min()) >= 0  # block starts are anchors
    pos = kres.position_at(j, sel, anc_j, anc_src, anc_r, anc_s, sr)
    fl = torch.floor(pos)
    i0 = base.long()[b.expand(j.shape)] + fl.long()
    vals = kres.lerp(pos - fl, y[i0.clamp(0, n_src - 1)],
                     y[(i0 + 1).clamp(0, n_src - 1)])
    out = torch.full((n_out,), float("nan"))
    writes = torch.zeros(n_out, dtype=torch.int64)
    out[j.reshape(-1).long()] = vals.reshape(-1)
    writes.index_add_(0, j.reshape(-1).long(), torch.ones(j.numel(),
                                                           dtype=torch.int64))
    return out, writes


def test_cta_layout_constants():
    """256 threads of 8 outputs cover a 2048-sample block; the C entry's
    grid is one CTA a block."""
    text = (_build.CSRC / "resample_pv.cu").read_text()
    assert THREADS * PER == BLK and PER == 8
    assert "constexpr int kPer = kBlk / kThreads;" in text
    assert "n_out / kBlk), kThreads" in text


@pytest.mark.parametrize("kind,kmin", [("bent", 2), ("dense", 3),
                                       ("denser", 10)])
def test_cta_model_equals_twin_bit_for_bit(kind, kmin):
    _jplan, plan, y, ops, kmax = _plan_case(kind)
    assert kmax >= kmin
    out, writes = _cta_model(y, *ops, plan.sr, plan.n_out_pad)
    assert bool((writes == 1).all())
    want = kres.resample_pv_plain(y, ops[0], *ops[3:], plan.sr, plan.n_out_pad)
    assert torch.equal(out, want)


@pytest.mark.parametrize("kind", ["bent", "dense", "denser"])
def test_cta_model_meets_the_tpu_kernel(kind):
    """Against resample_pv_pallas in interpret mode (through the JAX
    package's _resample_pv_fused), the bars of
    test_torch_kernels.test_resample_pv_plain_matches_tpu_kernel."""
    jplan, plan, y, ops, _kmax = _plan_case(kind)
    out, _ = _cta_model(y, *ops, plan.sr, plan.n_out_pad)
    rows = pallas_resample.rows_for(max(jplan.rho_max,
                                        float(jplan.rho_m.max()), 1.0))
    want = np.asarray(jpv._resample_pv_fused(jplan, jnp.asarray(y.numpy()),
                                             rows, interpret=True))
    got = out.numpy()[: plan.n_out]
    assert np.abs(got - want[: plan.n_out]).max() < 5e-3
    assert _snr_db(got, want[: plan.n_out]) < -60.0


def test_cta_model_across_anchor_tiles():
    """A block holding more anchors than one shared-memory tile: the choice
    carries across the tile passes."""
    rng = np.random.default_rng(3)
    nb, n_src = 4, 12000
    inner = np.sort(rng.choice(np.arange(BLK + 1, 2 * BLK), 2 * TILE + 37,
                               replace=False))
    anc_j = np.sort(np.concatenate([np.arange(nb) * BLK, inner]))
    n_anc = len(anc_j)
    anc_src = rng.uniform(0.0, 2500.0, n_anc).astype(np.float32)
    anc_r = rng.uniform(0.5, 2.0, n_anc).astype(np.float32)
    anc_s = rng.uniform(-3.0, 3.0, n_anc).astype(np.float32)
    anc_s[::5] = 0.0  # the flat branch
    a0, cnt, kmax = kres.pv_anchor_blocks(anc_j, nb)
    assert kmax > 2 * TILE
    y = _t(rng.standard_normal(n_src).astype(np.float32))
    base = _t(rng.integers(0, 8000, nb).astype(np.int32))
    anc = [_t(a) for a in (anc_j.astype(np.int32), anc_src, anc_r, anc_s)]
    out, writes = _cta_model(y, base, _t(a0), _t(cnt), *anc, SR, nb * BLK)
    assert bool((writes == 1).all())
    assert torch.equal(out, kres.resample_pv_plain(y, base, *anc, SR,
                                                   nb * BLK))


# ----------------------------------------------------------------------
# B4: one packed upload
# ----------------------------------------------------------------------


def _operands(rng, nb=5, n_anc=13):
    ints = [rng.integers(-2**31, 2**31 - 1, m).astype(np.int32)
            for m in (nb, nb, nb, n_anc)]
    floats = [rng.standard_normal(n_anc).astype(np.float32) for _ in range(3)]
    return ints + floats


def test_packed_offsets():
    """Three per-block sections of nb, then four per-anchor sections of
    n_anc, back to back in one array."""
    views = kres.upload_pv_operands(*_operands(np.random.default_rng(0)),
                                    "cpu")
    ptr = views[0].data_ptr()
    assert [(v.data_ptr() - ptr) // 4 for v in views] == [0, 5, 10, 15, 28,
                                                         41, 54]
    assert sum(v.numel() for v in views) == 67


@pytest.mark.parametrize("nb,n_anc", [(1, 1), (5, 13), (3876, 3901)])
def test_packed_sections_read_back(nb, n_anc):
    ops = _operands(np.random.default_rng(nb), nb, n_anc)
    views = kres.upload_pv_operands(*ops, "cpu")
    assert len(views) == 7
    for k, (got, want) in enumerate(zip(views, ops, strict=True)):
        assert got.dtype == (torch.int32 if want.dtype == np.int32
                             else torch.float32), k
        assert got.is_contiguous() and torch.equal(got, _t(want)), k


def test_packed_views_share_one_array():
    views = kres.upload_pv_operands(*_operands(np.random.default_rng(0)),
                                    "cpu")
    assert len({v.untyped_storage().data_ptr() for v in views}) == 1


def test_packed_float_sections_keep_their_bits():
    """The float32 sections travel as their int32 bits: a NaN's payload, a
    negative zero and a subnormal come back as they went."""
    ops = _operands(np.random.default_rng(0), 1, 4)
    special = np.array([0x7FC01234, 0x80000000, 0x00000001, 0xFF800000],
                       np.uint32).view(np.float32)
    ops[4] = special
    views = kres.upload_pv_operands(*ops, "cpu")
    assert np.array_equal(views[4].numpy().view(np.uint32),
                          special.view(np.uint32))


def test_render_glue_uploads_once_and_matches_the_twin(monkeypatch):
    """``_resample_pv_fused`` hands B4 seven views of one uploaded array;
    the result equals the twin on the plan's own arrays bit for bit."""
    _jplan, plan, y, ops, _kmax = _plan_case("dense")
    seen = []
    real = kres.resample_pv

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(kres, "resample_pv", spy)
    got = tpv._resample_pv_fused(plan, y)
    (args,) = seen
    views = args[1:8]
    storages = {v.untyped_storage().data_ptr() for v in views}
    assert len(storages) == 1
    want = kres.resample_pv_plain(y, ops[0], *ops[3:], plan.sr, plan.n_out_pad)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# B11: the windowed read
# ----------------------------------------------------------------------


def _stream_case():
    """Positions and bases of a real stream's padded output (bent track),
    its final block odd (n_out % 2048 != 0), over a random source."""
    _jplan, plan, _y, ops, _kmax = _plan_case("bent")
    assert plan.n_out % BLK != 0
    rng = np.random.default_rng(11)
    y = _t(rng.standard_normal(plan.stretch_len).astype(np.float32))
    pos = kres.positions_rel_plain(*ops[3:], plan.sr, plan.n_out_pad)
    rows = kres.rows_for(max(plan.rho_max, float(plan.rho_m.max()), 1.0))
    return plan, y, pos, ops[0], rows


def _window_model(y, pos, base, rows, j, n):
    """The window kernel's index map: sample j + k from pos[j + k] and
    base[(j + k) // 2048], the slab clamp, zeros past the source."""
    jj = torch.arange(j, j + n)
    p = pos[jj]
    fl = torch.floor(p)
    i0 = base.long()[jj // BLK] + fl.clamp(0, rows * 128 - 2).long()
    n_src = y.shape[0]

    def tap(i):
        return torch.where(i < n_src, y[i.clamp_max(n_src - 1)], 0.0)

    return kres.lerp(p - fl, tap(i0), tap(i0 + 1))


def _windows(n_out):
    last = n_out - n_out % BLK  # the final odd block's start
    return [
        (0, 1), (0, BLK), (0, 1024), (1024, 1024),  # inside one block
        (1000, 2048), (2047, 2), (3 * BLK - 5, 3 * BLK + 11),  # across
        (5 * BLK + 700, 9000),
        (last - 300, n_out - last + 300),  # into the final odd block
        (last + 17, n_out - last - 17),  # inside it, to the end
        (n_out - 1, 1),
    ]


@pytest.mark.parametrize("w", range(11))
def test_window_equals_twin_and_tpu_kernel(w):
    plan, y, pos, base, rows = _stream_case()
    j, n = _windows(plan.n_out)[w]
    assert 0 <= j and j + n <= plan.n_out
    got = _window_model(y, pos, base, rows, j, n)
    b0, b1 = j // BLK, -(-(j + n) // BLK)
    blocks = kres.resample_lerp_plain(y, pos[b0 * BLK : b1 * BLK],
                                      base[b0:b1], rows)
    assert torch.equal(got, blocks[j - b0 * BLK : j + n - b0 * BLK])
    tpu = np.asarray(pallas_resample.resample_lerp_pallas(
        jnp.asarray(y.numpy()), jnp.asarray(pos[b0 * BLK : b1 * BLK].numpy()),
        jnp.asarray(base[b0:b1].numpy()), rows, interpret=True))
    np.testing.assert_array_equal(got.numpy(),
                                  tpu[j - b0 * BLK : j + n - b0 * BLK])


def test_random_windows_equal_twin():
    plan, y, pos, base, rows = _stream_case()
    full = kres.resample_lerp_plain(y, pos, base, rows)
    rng = np.random.default_rng(2)
    for _ in range(40):
        j = int(rng.integers(0, plan.n_out))
        n = int(rng.integers(1, min(32768, plan.n_out - j) + 1))
        assert torch.equal(_window_model(y, pos, base, rows, j, n),
                           full[j : j + n])


# ----------------------------------------------------------------------
# B11: the per-stream launcher
# ----------------------------------------------------------------------


def _reader_operands(device="cpu", nb=3):
    y = torch.zeros(9000, device=device)
    pos = torch.zeros(nb * BLK, device=device)
    base = torch.zeros(nb, dtype=torch.int32, device=device)
    return y, pos, base


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the launcher's checks must run first")

    monkeypatch.setattr(_build, "library", refuse)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_reader_refuses_other_devices(no_library, device):
    with pytest.raises(ValueError, match="no kernel"):
        kres.LerpReader(*_reader_operands(device), 20)


@pytest.mark.parametrize("which,dtype", [(0, torch.float64), (1, torch.int32),
                                         (2, torch.int64), (2, torch.float32)])
def test_reader_refuses_wrong_dtypes(no_library, which, dtype):
    ops = list(_reader_operands())
    ops[which] = ops[which].to(dtype)
    with pytest.raises(TypeError, match="dtype"):
        kres.LerpReader(*ops, 20)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_reader_refuses_non_contiguous(no_library, which):
    ops = list(_reader_operands())
    ops[which] = torch.repeat_interleave(ops[which], 2)[::2]
    assert not ops[which].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kres.LerpReader(*ops, 20)


def test_reader_refuses_bad_shapes_and_rows(no_library):
    y, pos, base = _reader_operands()
    with pytest.raises(ValueError, match="multiple"):
        kres.LerpReader(y, pos[:-1], base, 20)
    with pytest.raises(ValueError, match="shape"):
        kres.LerpReader(y, pos, base[:-1], 20)
    with pytest.raises(ValueError, match="rows"):
        kres.LerpReader(y, pos, base, 0)
    with pytest.raises(ValueError, match="rows"):
        kres.LerpReader(y, pos, base, (1 << 24) + 1)
    with pytest.raises(ValueError, match="device|on"):
        kres.LerpReader(y, pos.to("meta"), base, 20)


@pytest.fixture
def fake_cuda(monkeypatch):
    """The launcher on the fake card (stream 7), a plain host buffer
    standing in for the pinned one and a fixed device address."""
    rec = fake_card(monkeypatch, stream=7)
    grown = []
    monkeypatch.setattr(_build, "host_device_pointer", lambda t: 0xC0DE)
    monkeypatch.setattr(kres, "_pinned",
                        lambda n: grown.append(n) or torch.zeros(n))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type(
        "S", (), {"synchronize": lambda self: grown.append("sync")})())
    return rec, grown


def test_reader_launches_one_window_a_read(fake_cuda):
    rec, grown = fake_cuda
    y, pos, base = _reader_operands("meta", nb=20)
    r = kres.LerpReader(y, pos, base, 24)
    before = kres.resample_lerp.launches
    got = r.read(3000, 1500)
    assert got.shape == (1500,) and got.dtype == np.float32
    (name, args), = rec.calls
    assert name == "mlx_resample_lerp_window"
    assert args == (y.data_ptr(), 9000, pos.data_ptr(), base.data_ptr(),
                    3000, 1500, 24, 0xC0DE, 1, 7)
    assert kres.resample_lerp.launches == before + 1
    assert grown == [2048]
    r.read(4500, 2048)  # fits: no new buffer
    r.read(6548, 5000)  # grows to the next power of two, after a wait
    assert grown == [2048, "sync", 8192]
    r.launch(0, 10)  # no wait
    assert rec.calls[-1][1][-2] == 0
    assert kres.resample_lerp.launches == before + 4


@pytest.mark.parametrize("j,n", [(-1, 10), (0, 0), (20 * BLK - 5, 6)])
def test_reader_refuses_windows_outside_the_output(fake_cuda, j, n):
    rec, _grown = fake_cuda
    r = kres.LerpReader(*_reader_operands("meta", nb=20), 24)
    with pytest.raises(ValueError, match="window"):
        r.read(j, n)
    assert rec.calls == []


def test_host_device_pointer_needs_pinned_memory(no_library):
    with pytest.raises(ValueError, match="pinned"):
        _build.host_device_pointer(torch.zeros(8))
    with pytest.raises(ValueError, match="pinned"):
        _build.host_device_pointer(torch.zeros(8, device="meta"))


def test_resample_pv_refuses_sources_past_its_index_range(fake_cuda):
    """B4's kernel indexes the source in 32 unsigned bits: 2^31 samples and
    more raise before any launch."""
    rec, _grown = fake_cuda
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    ops = (torch.zeros(1, **i32),) * 4 + (torch.zeros(1, **meta),) * 3
    with pytest.raises(ValueError, match="2\\^31"):
        kres.resample_pv(torch.empty(1 << 31, **meta), *ops, SR, BLK)
    kres.resample_pv(torch.empty((1 << 31) - 1, **meta), *ops, SR, BLK)
    assert [name for name, _args in rec.calls] == ["mlx_resample_pv"]
    assert rec.calls[0][1][1] == (1 << 31) - 1


def test_resample_lerp_runs_the_window_entry_over_its_output(fake_cuda):
    """The general wrapper launches the entry the live read runs, from
    sample 0 over the whole output into device memory, without a wait."""
    rec, _grown = fake_cuda
    y, pos, base = _reader_operands("meta", nb=4)
    before = kres.resample_lerp.launches
    out = kres.resample_lerp(y, pos, base, 24)
    assert out.shape == (4 * BLK,) and out.device.type == "meta"
    (name, args), = rec.calls
    assert name == "mlx_resample_lerp_window"
    assert args == (y.data_ptr(), 9000, pos.data_ptr(), base.data_ptr(), 0,
                    4 * BLK, 24, out.data_ptr(), 0, 7)
    assert kres.resample_lerp.launches == before + 1


def test_reader_makes_its_card_current(fake_cuda, monkeypatch):
    """Every read launches inside a context of the reader's card (the
    launch path's), whichever card is current, and the launch runs with
    that card current."""
    rec, _grown = fake_cuda
    entered, current = [], [1]

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        current.append(dev)
        yield
        current.pop()

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "stream", lambda dev: current[-1])
    r = kres.LerpReader(*_reader_operands("meta", nb=2), 24)
    r.read(0, 100)
    r.read(100, 100)
    assert entered == [r.device] * 2 and current == [1]
    assert [args[-1] for _name, args in rec.calls] == [r.device] * 2


def test_window_entries_are_registered():
    """B11's source has one kernel and one launching entry, both bound."""
    text = (_build.CSRC / "resample_lerp.cu").read_text()
    entries = re.findall(r'extern "C" int (\w+)\(', text)
    assert entries == ["mlx_resample_lerp_window", "mlx_host_device_pointer"]
    assert text.count("__global__") == 1
    for name in entries:
        assert name in _build.SIGNATURES
    assert "mlx_resample_lerp" not in _build.SIGNATURES
    assert len(_build.SIGNATURES["mlx_resample_lerp_window"]) == 10


def test_cpu_stream_reads_through_the_twin():
    """A stream on the CPU has no launcher: its reads go through
    ``kres.resample_lerp`` (tests/test_torch_live.py counts them)."""
    n = 2 * SR
    x = (0.5 * np.sin(2 * np.pi * 330.0 * np.arange(n) / SR)).astype(
        np.float32)
    knots = mt.MapKnots.from_markers([mt.Marker(n // 2, 52.0, 0.05, 3.0)],
                                     SR, n)
    s = tps.PvStream(x, knots, device="cpu")
    assert s._reader is None
    assert s.read(1024).shape == (1024,)
