"""B7's and B12's frame tiles and B7's small on-chip sizes, modelled on the
CPU.

``csrc/fft_fourstep.cuh``'s ``frame_tile`` (B7 and B12 at the sizes up to
49,152 points that are no power of two) and ``csrc/fft_large.cuh``'s
``real_fft<N>`` on ``Pair<N / 2>`` (B7 at 1024 ... 8192 points) run only on
the card (chip_smoke.py phases 9 and 10 hold them against their twins
there).  These tests hold what the design rests on, without a kernel:

* the column tiles' body on whole frames (N1 = 1, N2 = N) in float32,
  through ``test_torch_fourstep.py``'s ``column_model`` and
  ``batch_fft_model``, against float64 ``np.fft.rfft`` at m = 3 ... 95 and
  P = 256 ... 8192;
* the frame tile's output map storing each bin k < N / 2 once;
* the frame load: whole 32-byte sectors a warp, the (sub, nn) stepping
  equal to the division it replaces, every slot written once, each
  half-warp's 4-byte shared stores on 16 banks;
* ``kstft.frame_tile`` against the header, within 227 KB at every B7 and
  B12 size, T a power of two, B7's 256-column drain at least 132 CTAs;
* the tables and the C entry each wrapper calls (recording library on
  ``meta`` tensors), and that no source includes ``fft_real.cuh`` any more.
"""

import os

import numpy as np
import pytest
import torch

from melonix_tpu_torch.kernels import columns as kcols
from melonix_tpu_torch.kernels import stft as kstft
from test_torch_fourstep import (_banks_distinct, _sectors_whole,
                                 batch_fft_model, column_model)
from test_torch_scan import _snr
from torch_fake_card import fake_card

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "melonix_tpu_torch", "csrc")
CPU = torch.device("cpu")

# Every size each kernel sends to the frame tile: B7's 1024 j and B12's 512
# j up to 49,152 points that are no power of two.
B7_TILE = [1024 * j for j in range(1, 49)
           if kcols.supported(1024 * j) and kcols.route(1024 * j) == "tile"]
B12_TILE = [512 * j for j in range(1, 97) if kstft.route(512 * j) == "tile"]


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_tile_sizes_are_the_odd_factor_sizes():
    """The frame tile takes exactly the B7 and B12 sizes up to 49,152 that
    are no power of two: m odd, 3 <= m <= 95, B >= 512."""
    assert B7_TILE == [1024 * j for j in range(3, 49) if j & (j - 1)]
    assert B12_TILE == [512 * j for j in range(3, 97) if j & (j - 1)]
    for size in B7_TILE + B12_TILE:
        ft = kstft.frame_tile(size)
        assert 3 <= ft["m"] <= 95 and ft["m"] % 2 and ft["b"] >= 512
        assert ft["b"] * ft["m"] == size


@pytest.mark.parametrize("size", [1536, 2560, 3584, 24576, 48128, 48640,
                                  49152])
def test_frame_model_matches_rfft(size):
    """The column tiles' body on whole frames (``column_model`` with N2 =
    N, its Stockham ``batch_fft_model``) at m = 3, 5, 7, 47 and 95 and P =
    256, 512, 4096 and 8192, T frames of a tile at once (two at T = 1),
    float32, against float64 rfft of the same float32 frames: < -110 dB
    over the bins below N / 2 (the kernels' bars are -100 dB (B7) and -80
    dB (B12) against their twins)."""
    ft = kstft.frame_tile(size)
    rng = np.random.default_rng(size)
    nt = max(ft["t"], 2)
    x = (rng.standard_normal((nt, size)) * np.hanning(size)).astype(
        np.float32)
    got = column_model(x.T, size)[: size // 2].T  # [frame][k]
    want = np.fft.rfft(x.astype(np.float64), axis=1)[:, : size // 2]
    assert got.shape == want.shape and _snr(got, want) < -110.0


def test_batch_fft_model_on_a_frame_tile_batch():
    """The Stockham of a frame tile at 1536 (T = 4, m = 3: twelve 256-point
    sequences in one batch of 256 x 16 points) is the DFT of each
    sequence."""
    ft = kstft.frame_tile(1536)
    seqs = ft["t"] * ft["m"]
    assert seqs * ft["p"] <= ft["config"][0] * ft["config"][1]
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((seqs, ft["p"])) + 1j * rng.standard_normal(
        (seqs, ft["p"]))).astype(np.complex64)
    got = batch_fft_model(z, -1.0, kstft.unit_roots(ft["p"], ft["p"]))
    assert _snr(got, np.fft.fft(z.astype(np.complex128), axis=1)) < -125.0


def _stored_bins(size):
    """How often the body's puts reach each bin k < N / 2 (the frame tile's
    store drops the rest): bin k1 (group 0), k1 + B p and k1 + B (m - p),
    and for 0 < k1 < P their mirrors B - k1 + B (m - 1 - p) and B - k1 + B
    (p - 1), p = 1 .. (m - 1) / 2."""
    ft = kstft.frame_tile(size)
    m, b, p = ft["m"], ft["b"], ft["p"]
    k1 = np.arange(p + 1)
    pp = np.arange(1, (m - 1) // 2 + 1)[:, None]
    mid = k1[(k1 > 0) & (k1 < p)]
    ks = np.concatenate([k1, (k1 + b * pp).ravel(), (k1 + b * (m - pp)).ravel(),
                         (b - mid + b * (m - 1 - pp)).ravel(),
                         (b - mid + b * (pp - 1)).ravel()])
    ks = ks[ks < size // 2]
    return np.bincount(ks, minlength=size // 2)


@pytest.mark.parametrize("kernel", ["b7", "b12"])
def test_every_bin_below_half_stored_once(kernel):
    """At every tile size of the kernel: each bin k < N / 2 once."""
    for size in B7_TILE if kernel == "b7" else B12_TILE:
        assert np.array_equal(_stored_bins(size),
                              np.ones(size // 2, np.int64)), size


def _frame_load(size, t_frames, kt):
    """The frame load of ``frame_tile``: for each frame j and step u, thread
    t (< kT) reads sample i = t + kT u and stores it at float index 2 ((sub
    T + j) S + nn / 2) + nn % 2, (sub, nn) starting at (t mod m, t / m) for
    each frame and stepped by (kT mod m, kT / m) with a carry, as the
    kernel does.  Returns the (frame, step, thread) arrays of i and of the
    shared float index (-1 past the frame)."""
    ft = kstft.frame_tile(size)
    m, s = ft["m"], ft["s"]
    t = np.arange(kt)
    steps = -(-size // kt)
    ii = np.full((t_frames, steps, kt), -1, np.int64)
    addr = np.full((t_frames, steps, kt), -1, np.int64)
    dsub, dnn = kt % m, kt // m
    for j in range(t_frames):
        sub, nn = t % m, t // m
        for u in range(steps):
            i = t + kt * u
            ok = i < size
            ii[j, u, ok] = i[ok]
            a = 2 * ((sub * t_frames + j) * s + nn // 2) + nn % 2
            addr[j, u, ok] = a[ok]
            sub, nn = sub + dsub, nn + dnn
            carry = sub >= m
            sub = np.where(carry, sub - m, sub)
            nn = np.where(carry, nn + 1, nn)
    return ii, addr


@pytest.mark.parametrize("kernel", ["b7", "b12"])
def test_frame_load_sectors_banks_and_slots(kernel):
    """At every tile size (B7 also at its 256-column T): each warp reads 32
    consecutive samples (whole sectors, the frame start 32-byte aligned);
    the stepping lands every sample where (sub, nn) = divmod's would; every
    slot of the T m sub-sequences gets one sample; each half-warp's 4-byte
    stores fall on 16 distinct banks."""
    for size in B7_TILE if kernel == "b7" else B12_TILE:
        counts = (None, 256) if kernel == "b7" else (None,)
        for count in counts:
            ft = kstft.frame_tile(size, count)
            tt, m, s, kt = ft["t"], ft["m"], ft["s"], ft["config"][0]
            ii, addr = _frame_load(size, tt, kt)
            ok = ii >= 0
            nn, sub = np.divmod(ii, m)
            j = np.arange(tt)[:, None, None]
            want = 2 * ((sub * tt + j) * s + nn // 2) + nn % 2
            assert np.array_equal(addr[ok], np.broadcast_to(want, ii.shape)[
                ok]), size
            slots = np.sort(addr[ok])
            assert len(np.unique(slots)) == tt * size, size
            w = ii.reshape(tt, -1, kt // 32, 32)
            for row in w.reshape(-1, 32)[::7]:  # a sample of the warps
                row = row[row >= 0]
                assert len(row) in (0, 32) and _sectors_whole(4 * row, 4)
            halves = addr.reshape(-1, 16)
            halves = halves[(halves >= 0).all(axis=1)]
            assert _banks_distinct(halves, 4), (size, count)


def test_frame_tile_fits_and_fills_the_card():
    """kstft.frame_tile at every B7 and B12 tile size: shared memory within
    227 KB (the largest 196,680 bytes, 49,152 points at T = 1), T a power of
    two within the column tile's, a sequence within a batch; B7 at 256
    columns leaves at least 132 CTAs (T = 1), at 1280 columns T = 8 where
    the budget allows it; fewer columns than SMs, T = 1."""
    biggest = 0
    for size in sorted(set(B7_TILE + B12_TILE)):
        ct = kstft.column_tile(size)
        for count in (None, 1, 100, 256, 1280):
            ft = kstft.frame_tile(size, count)
            t = ft["t"]
            assert ft["smem"] <= kstft.SMEM_MAX and t & (t - 1) == 0
            assert 1 <= t <= ct["t"] and ft["s"] % 2 == 1
            assert ft["p"] <= ft["config"][0] * ft["config"][1]
            if count is not None:
                assert -(-count // t) >= min(count, kstft.FRAME_SMS)
            biggest = max(biggest, ft["smem"])
        assert kstft.frame_tile(size, 256)["t"] == 1
        assert kstft.frame_tile(size, 1280)["t"] == min(ct["t"], 8)
    assert biggest == kstft.frame_tile(49152)["smem"] == 196680
    assert kstft.frame_tile(1536)["t"] == 4
    assert kstft.frame_tile(24576)["t"] == 1
    for size in (1024, 8192, 50176, 0, 1538):
        with pytest.raises(ValueError):
            kstft.frame_tile(size)


def test_frame_tile_header_constants():
    """fft_fourstep.cuh's frame tile rules and the python mirror agree."""
    src = _read("fft_fourstep.cuh")
    for line in (
            "constexpr int kFrameSms = 132;",
            "return n > 0 && n <= kMaxColumn && n % 4 == 0 && "
            "(n & (n - 1)) != 0;",
            "const int fill = count < kFrameSms ? count : kFrameSms;",
            "while (count > 0 && c.t > 1 && (count + c.t - 1) / c.t < fill) "
            "c.t /= 2;",
            "c.s = c.p + (c.m < 9 ? 3 : 1);",
            "if (2 * col_tile_smem(c) > kSmemMax) return 2;",
            "return k == 2 ? 3 : k;",
            "constexpr int kMaxColumn = 49152;"):
        assert line in src, line
    assert kstft.FRAME_SMS == 132 and kstft.MAX_SIZE == 49152
    # the body is shared: the column tiles and the frame tiles call it
    assert src.count("col_tile_body<kT, kPts>(s, ct, tab,") == 2
    # the frame tiles' configurations: 512 x 32 where one CTA fills a SM,
    # 512 x 16 above P = 512 where two fit
    for size, config in ((24576, (512, 16)), (49152, (512, 32)),
                         (48128, (512, 32)), (48640, (512, 32)),
                         (1536, (256, 16)), (3072, (256, 32))):
        assert kstft.frame_tile(size)["config"] == config, size
    for cu in ("spectrogram_columns.cu", "stft_mag_sizes.cu"):
        body = _read(cu)
        assert "switch (mlx::frame_config(ft)) {" in body
        assert "<512, 16>" in body and "kPts == 16 ? 2 : 1" in body


@pytest.mark.parametrize("size", [1024, 2048, 4096, 8192])
def test_small_large_tables_and_plan(size):
    """B7's on-chip sizes below 16,384: kstft.large_twiddles is
    kpv.pair_twiddles(N / 2) then twiddles(N), and RealPlan<N> puts the
    split at Pair<N / 2>::kTwiddles = N / 2 + N / 32 with N / 32 threads."""
    tab = kstft.large_twiddles(size, CPU)
    pair = kstft.__dict__["pair_twiddles"](size // 2, CPU)
    split = size // 2 + size // 32
    assert pair.shape[0] == split and tab.shape == (split + size // 2, 2)
    assert torch.equal(tab[:split], pair)
    assert torch.equal(tab[split:], kstft.twiddles(size, CPU))
    src = _read("fft_large.cuh")
    for line in ("static constexpr bool kPair = kM <= 8192;",
                 "using P = pairfft::Pair<kPair ? kM : 8192>;",
                 "static constexpr int kThreads = kPair ? P::kThreads : "
                 "L::kThreads;",
                 "static constexpr int kMid = kPair ? P::kTwiddles : "
                 "L::kTwiddles;",
                 "static constexpr int kSplit = kMid + (kCluster == 2 ? kM : "
                 "0);",
                 "pairfft::fft<M>(v, twr, smem, smem + P::kBuf, -1.0f);"):
        assert line in src, line
    assert size in kcols.LARGE_SIZES and kcols.route(size) == "large"
    cu = _read("spectrogram_columns.cu")
    assert f"case {size}:\n      return launch_columns_large<{size}>(" in cu


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on the fake card; the tables are CPU
    tensors whose pointers name them."""
    rec = fake_card(monkeypatch)
    rec.tables = {}

    def table(kind):
        def make(size, device):
            t = torch.zeros(4, 2)
            rec.tables[(kind, size)] = t.data_ptr()
            return t
        return make

    monkeypatch.setattr(kstft, "four_step_column_table", table("tile"))
    monkeypatch.setattr(kcols, "four_step_column_table", table("tile"))
    monkeypatch.setattr(kcols, "large_twiddles", table("large"))
    return rec


META = torch.device("meta")


@pytest.mark.parametrize("size,hop", [(1536, 384), (24576, 3072),
                                      (48640, 9728)])
def test_b12_tile_calls_its_entry_with_the_tile_table(fake_cuda, size, hop):
    """B12 at a tile size: one call of ``mlx_stft_mag_sizes`` with the
    column table of the size and (n_frames, size, hop, scale); one launch."""
    before = kstft.stft_mag.launches
    out = kstft.stft_mag(torch.zeros(90000).to(META),
                         torch.zeros(size).to(META), size, hop, 7, 0.5)
    assert out.shape == (7, size // 2)
    (name, args), = fake_cuda.calls
    assert name == "mlx_stft_mag_sizes" and args[5:9] == (7, size, hop, 0.5)
    assert args[3] == fake_cuda.tables[("tile", size)]
    assert kstft.stft_mag.launches == before + 1


@pytest.mark.parametrize("size,entry,kind", [
    (1024, "mlx_spectrogram_columns_large", "large"),
    (2048, "mlx_spectrogram_columns_large", "large"),
    (4096, "mlx_spectrogram_columns_large", "large"),
    (8192, "mlx_spectrogram_columns_large", "large"),
    (3072, "mlx_spectrogram_columns", "tile"),
    (24576, "mlx_spectrogram_columns", "tile"),
    (49152, "mlx_spectrogram_columns", "tile")])
def test_b7_calls_the_entry_of_its_route(fake_cuda, size, entry, kind):
    """B7 at 1024 ... 8192 points calls the on-chip entry with
    large_twiddles(size), at a tile size the frame tile's entry with the
    column table; (n_cols, size) as its siblings; one launch."""
    before = kcols.spectrogram_columns_fused.launches
    ends = torch.zeros(5, dtype=torch.int32).to(META)
    out = kcols.spectrogram_columns_fused(torch.zeros(90000).to(META), ends,
                                          ends, 1.0, size=size)
    assert out.shape == (5, size // 2) and out.dtype == torch.int32
    (name, args), = fake_cuda.calls
    assert name == entry and args[6:8] == (5, size)
    assert args[4] == fake_cuda.tables[(kind, size)]
    assert kcols.spectrogram_columns_fused.launches == before + 1


def test_refused_tile_launch_raises(fake_cuda):
    """A tile launch the library refuses raises and counts no launch."""
    fake_cuda.code = 1
    before = kstft.stft_mag.launches
    with pytest.raises(RuntimeError):
        kstft.stft_mag(torch.zeros(90000).to(META),
                       torch.zeros(1536).to(META), 1536, 384, 3)
    assert kstft.stft_mag.launches == before


def test_no_source_includes_fft_real():
    """fft_real.cuh is gone: no kernel source includes or names it, and
    neither the one-block kernels nor a "one_block" route remain."""
    names = sorted(os.listdir(CSRC))
    assert "fft_real.cuh" not in names
    for name in names:
        src = _read(name)
        assert "fft_real" not in src and "RealDft" not in src, name
        assert "columns_kernel" not in src and "stft_mag_sizes_kernel" \
            not in src, name
    for size in B7_TILE + B12_TILE + list(kcols.LARGE_SIZES):
        assert kstft.route(size) != "one_block"
        if kcols.supported(size):
            assert kcols.route(size) != "one_block"
