"""The port's file slice against melonix_tpu on the CPU: the native FLAC,
MP3 and Vorbis decodes, ``write_flac``, ``write_audio`` through the libav
shim, the long-tail import chain, ``.mlx`` and ``.melonix`` projects (with
a corruption corpus), ``resample`` and ``utils.tracing``.

Both packages decode through the same native sources (the port builds its
own library from them), so decodes are compared bit for bit; both write
files byte for byte alike.  The port's project loaders raise
``ProjectError`` and nothing else on any file that is not a project: the
JAX package's ``.mlx`` loader lets a ``ValueError`` from
``np.frombuffer`` through on a short sample body, so on the corpus the JAX
side is only required to raise.  ``resample`` is held to the JAX one at
SNR < -100 dB: both are float32 products of the same float64-built banks.
"""

import json
import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from melonix_tpu.io import libav as jlibav
from melonix_tpu.io.audio import DecodeError as JDecodeError
from melonix_tpu.io.audio import load_audio as j_load_audio
from melonix_tpu.io.audio import write_audio as j_write_audio
from melonix_tpu.io.flac import write_flac as j_write_flac
from melonix_tpu.io.melonix import load_melonix as j_load_melonix
from melonix_tpu.io.melonix import save_melonix as j_save_melonix
from melonix_tpu.io.project import Project as JProject
from melonix_tpu.io.project import load_project as j_load_project
from melonix_tpu.io.project import save_project as j_save_project
from melonix_tpu.io.resample import resample as j_resample
from melonix_tpu.markers import Marker as JMarker

import melonix_tpu_torch as mt
from melonix_tpu_torch.io import audio as taudio
from melonix_tpu_torch.io import libav as tlibav
from melonix_tpu_torch.io import resample as tresample
from melonix_tpu_torch.io.melonix import load_melonix, save_melonix
from melonix_tpu_torch.io.project import ProjectError
from melonix_tpu_torch.runtime import native as tnative
from melonix_tpu_torch.utils import tracing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
FIXTURE_FILES = sorted(os.listdir(FIXTURES))
SR = 8000


def _needs_libav():
    if tlibav.try_load() is None or jlibav.try_load() is None:
        pytest.skip(f"libav shim absent ({tlibav.build_error})")


def _smooth(n=10000, ch=None, sr=SR):
    t = np.arange(n) / sr
    x = 0.5 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(2 * np.pi * 440.0 * t)
    if ch is None:
        return x.astype(np.float32)
    return np.stack([x * (0.5 + 0.5 * c / max(ch - 1, 1)) for c in range(ch)],
                    axis=1).astype(np.float32)


def _snr_db(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    num = float(np.sum((got - want) ** 2))
    return 10.0 * np.log10(max(num, 1e-300) / float(np.sum(want ** 2)))


# ----------------------------------------------------------------------
# The native decoders
# ----------------------------------------------------------------------


def test_native_build_hashes_every_source_and_header():
    names = {p.name for p in tnative.SOURCES + tnative.HEADERS}
    assert names == {"melonix_native.cpp", "flac_decode.cpp", "mp3_decode.cpp",
                     "vorbis_decode.cpp", "mp3_tables.h", "pcm_cache.h"}
    make = open(os.path.join(REPO, "native", "Makefile")).read()
    srcs = next(line for line in make.splitlines() if line.startswith("SRCS"))
    assert srcs.split("=")[1].split() == [p.name for p in tnative.SOURCES]
    lib = tnative.try_load()
    assert lib is not None
    for codec in ("wav", "flac", "mp3", "vorbis"):
        assert hasattr(lib, f"mlx_{codec}_info")
        assert hasattr(lib, f"mlx_{codec}_read")
    stamp = tnative.BUILD_DIR / (tnative.LIB_NAME + ".sha256")
    assert stamp.read_text() == tnative.source_hash()


@pytest.mark.parametrize("mono", [True, False])
@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_decodes_equal_the_reference(name, mono):
    """Every fixture (MP3 at 44.1 and 22.05 kHz, mono and stereo; Ogg
    Vorbis) through the port's native decoder, bit for bit the JAX
    package's, each call counted."""
    path = os.path.join(FIXTURES, name)
    counter = {"mp3": tnative.decode_mp3,
               "ogg": tnative.decode_vorbis}[name.rsplit(".", 1)[1]]
    calls = counter.calls
    got, rate = mt.load_audio(path, mono=mono)
    assert counter.calls == calls + 1
    want, rate_j = j_load_audio(path, mono=mono)
    assert rate == rate_j > 0
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all() and got.size > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("ch", [1, 2, 6])
def test_flac_decodes_equal_the_reference(tmp_path, writer, ch):
    """FLACs written by either package decode alike through both, mono and
    multichannel; 16-bit samples come back exactly."""
    x = _smooth(9000, None if ch == 1 else ch)
    path = str(tmp_path / "x.flac")
    (mt.write_flac if writer == "port" else j_write_flac)(path, x, SR)
    calls = tnative.decode_flac.calls
    for mono in (True, False):
        got, rate = mt.load_audio(path, mono=mono)
        want, rate_j = j_load_audio(path, mono=mono)
        assert rate == rate_j == SR
        np.testing.assert_array_equal(got, want)
    assert tnative.decode_flac.calls == calls + 2
    full, _ = mt.load_audio(path, mono=False)
    q = np.clip(np.rint(x * 32768.0), -32768, 32767) / 32768.0
    np.testing.assert_array_equal(full, q.astype(np.float32))


def test_flac_without_a_compiler_falls_to_the_tail(tmp_path, monkeypatch):
    """Like the JAX chain: no native runtime, no shim, no ffmpeg ->
    DecodeError naming what is missing."""
    path = str(tmp_path / "x.flac")
    mt.write_flac(path, _smooth(), SR)
    monkeypatch.setattr(tnative, "try_load", lambda: None)
    monkeypatch.setattr(tlibav, "try_load", lambda: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(mt.DecodeError, match="ffmpeg"):
        mt.load_audio(path)


# ----------------------------------------------------------------------
# write_flac
# ----------------------------------------------------------------------


def _flac_input(kind):
    rng = np.random.default_rng(5)
    if kind == "mono":
        return _smooth(10000), {}
    if kind == "odd-tail":
        return _smooth(4096 * 2 + 7), {}
    if kind == "small-block":
        return _smooth(3001), {"block": 1152}
    if kind in ("independent", "left_side", "mid_side"):
        return _smooth(6000, 2), {"stereo_mode": kind}
    if kind == "24-bit":
        return _smooth(5000, 3), {"bits": 24}
    if kind == "8-bit":
        return _smooth(5000), {"bits": 8}
    if kind == "silence-and-constant":
        x = np.zeros(9000, np.float32)
        x[4096:8192] = 0.25
        return x, {}
    if kind == "noise":  # verbatim subframes
        return rng.uniform(-1, 1, 5000).astype(np.float32), {}
    if kind == "int16":
        return rng.integers(-32768, 32768, (4000, 2)).astype(np.int16), {}
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "mono", "odd-tail", "small-block", "independent", "left_side", "mid_side",
    "24-bit", "8-bit", "silence-and-constant", "noise", "int16"])
def test_write_flac_is_byte_identical(tmp_path, kind):
    x, kw = _flac_input(kind)
    a, b = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    mt.write_flac(a, x, SR, **kw)
    j_write_flac(b, x, SR, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()


# ----------------------------------------------------------------------
# write_audio through the libav shim; the long-tail chain
# ----------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("ext", ["m4a", "opus"])
def test_write_audio_lossy_decodes_alike(tmp_path, ext, writer):
    """Each package's .m4a / .opus decodes to the same samples through the
    other's ``load_audio``."""
    _needs_libav()
    x = _smooth(48000, 2, sr=48000)
    path = str(tmp_path / f"o.{ext}")
    (mt.write_audio if writer == "port" else j_write_audio)(path, x, 48000)
    for mono in (True, False):
        got, rate = mt.load_audio(path, mono=mono)
        want, rate_j = j_load_audio(path, mono=mono)
        assert rate == rate_j == 48000 and got.size > 0
        np.testing.assert_array_equal(got, want)


def test_write_audio_dispatch(tmp_path, monkeypatch):
    x = _smooth(4000)
    mt.write_audio(str(tmp_path / "a.wav"), x, SR)
    mt.write_audio(str(tmp_path / "a.flac"), x, SR)
    j_write_audio(str(tmp_path / "b.wav"), x, SR)
    j_write_audio(str(tmp_path / "b.flac"), x, SR)
    for ext in ("wav", "flac"):
        assert (open(tmp_path / f"a.{ext}", "rb").read()
                == open(tmp_path / f"b.{ext}", "rb").read())
    assert taudio.WRITABLE_EXTENSIONS == (
        ".wav", ".flac", ".m4a", ".aac", ".opus", ".ogg", ".mp3")
    monkeypatch.setattr(tlibav, "try_load", lambda: None)
    with pytest.raises(mt.DecodeError, match="libav shim unavailable"):
        mt.write_audio(str(tmp_path / "a.m4a"), x, SR)


def test_opus_in_ogg_falls_through_native_vorbis(tmp_path):
    """An .ogg holding Opus: the native Vorbis decoder rejects it and both
    chains go on to the shim, with the same samples."""
    _needs_libav()
    x = _smooth(48000, sr=48000)
    opus = str(tmp_path / "t.opus")
    mt.write_audio(opus, x, 48000)
    ogg = str(tmp_path / "t.ogg")
    os.rename(opus, ogg)
    got, rate = mt.load_audio(ogg)
    want, rate_j = j_load_audio(ogg)
    assert rate == rate_j == 48000
    np.testing.assert_array_equal(got, want)


def _long_tail_file(tmp_path, case):
    if case == "m4a":
        path = str(tmp_path / "x.m4a")
        if tlibav.try_load() is not None:
            tlibav.encode(path, _smooth(8000, sr=48000), 48000)
        else:
            open(path, "wb").write(os.urandom(2048))
        return path
    if case == "opus-in-ogg":
        path = str(tmp_path / "x.ogg")
        if tlibav.try_load() is not None:
            tlibav.encode(str(tmp_path / "x.opus"), _smooth(8000, sr=48000),
                          48000)
            os.rename(str(tmp_path / "x.opus"), path)
        else:
            open(path, "wb").write(b"OggS" + os.urandom(2048))
        return path
    if case == "garbage-mp3":
        path = str(tmp_path / "x.mp3")
        open(path, "wb").write(b"\xff\xfb\x90\x00" * 100)
        return path
    path = str(tmp_path / "x.unknown")
    open(path, "wb").write(os.urandom(512))
    return path


@pytest.mark.parametrize("case", ["m4a", "opus-in-ogg", "garbage-mp3",
                                  "unknown"])
def test_long_tail_without_shim_or_ffmpeg_raises(tmp_path, monkeypatch, case):
    """With the shim and the ffmpeg binary taken away, every file no native
    decoder reads raises DecodeError in both packages."""
    path = _long_tail_file(tmp_path, case)
    # built and cached first: with shutil.which patched, a first try_load
    # would find no compiler
    assert tnative.try_load() is not None
    monkeypatch.setattr(tlibav, "try_load", lambda: None)
    monkeypatch.setattr(jlibav, "try_load", lambda: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(mt.DecodeError):
        mt.load_audio(path)
    with pytest.raises(JDecodeError):
        j_load_audio(path)


def test_libav_absent_headers_give_none(monkeypatch):
    monkeypatch.setattr(tlibav, "link_flags", lambda cxx: None)
    tlibav.try_load.cache_clear()
    try:
        assert tlibav.try_load() is None
        assert tlibav.build_error == "libav headers absent"
        with pytest.raises(ValueError, match="unavailable"):
            tlibav.decode("x.m4a")
    finally:
        tlibav.try_load.cache_clear()
        tlibav.build_error = None


def test_libav_shim_is_built_from_the_source():
    """The shim is the port's own build of ``native/libav_decode.cpp``,
    never the library ``make`` leaves in ``native/``."""
    _needs_libav()
    lib = tlibav.try_load()
    assert lib._name == str(tnative.BUILD_DIR / tlibav.LIB_NAME)
    assert tlibav.SOURCE.name == "libav_decode.cpp"


# ----------------------------------------------------------------------
# .mlx and .melonix projects
# ----------------------------------------------------------------------

PROJECT_CASES = {
    "plain": (640, [], 50.0, 130.0),
    "markers": (1000, [(700, 62.0, 0.1, -3.0), (100, 57.0, -0.05, 2.5),
                       (400, 60.0, 0.0, 0.0)], 37.5, 96.0),
    "empty": (0, [(0, 50.0, 0.0, 1.0)], 0.0, 0.0),
}


def _projects(case):
    n, markers, brightness, tempo = PROJECT_CASES[case]
    wav = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    t = mt.Project(wav=wav, sample_rate=22050,
                   markers=[mt.Marker(*m) for m in markers],
                   brightness=brightness, tempo=tempo)
    j = JProject(wav=wav, sample_rate=22050,
                 markers=[JMarker(*m) for m in markers],
                 brightness=brightness, tempo=tempo)
    return t, j


def _same_project(got, want):
    assert got.sample_rate == want.sample_rate
    assert got.brightness == want.brightness and got.tempo == want.tempo
    assert [(m.sample, m.note, m.d_time, m.pitch_bend) for m in got.markers] \
        == [(m.sample, m.note, m.d_time, m.pitch_bend) for m in want.markers]
    assert got.wav.dtype == np.float32
    np.testing.assert_array_equal(got.wav, want.wav)


FORMATS = {
    "mlx": (mt.save_project, mt.load_project, j_save_project, j_load_project),
    "melonix": (save_melonix, load_melonix, j_save_melonix, j_load_melonix),
}


@pytest.mark.parametrize("case", sorted(PROJECT_CASES))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_project_round_trip_is_byte_identical(tmp_path, fmt, case):
    save, load, j_save, j_load = FORMATS[fmt]
    t, j = _projects(case)
    a = save(str(tmp_path / "port"), t)  # the extension is appended
    b = j_save(str(tmp_path / "jax"), j)
    assert a.endswith("." + fmt) and b.endswith("." + fmt)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = load(a), j_load(b)
    _same_project(got, want)
    assert [m.sample for m in got.markers] == sorted(
        m[0] for m in PROJECT_CASES[case][1])


def _corpus_base(tmp_path, fmt):
    t, _ = _projects("markers")
    t.wav = t.wav[:48]
    return open(FORMATS[fmt][0](str(tmp_path / "base"), t), "rb").read()


def _hostile(fmt, base):
    """Files whose counts claim more than the file holds."""
    out = []
    if fmt == "mlx":
        for n in (2**31 - 1, 2**62, 2**64 - 1, 49):
            out.append(base[:12] + struct.pack("<Q", n) + base[20:])
        for k in (2**31 - 1, 2**32 - 1, 4):
            out.append(base[:28] + struct.pack("<I", k) + base[32:])
        out.append(base[:4] + struct.pack("<I", 2) + base[8:])  # version
        out.append(b"MLXQ" + base[4:])
    else:
        for n in (2**31 - 1, -1, -2**31, 49):
            out.append(base[:4] + struct.pack("<i", n) + base[8:])
        k_off = 8 + 4 * 48 + 8
        for k in (2**31 - 1, -1, 4):
            out.append(base[:k_off] + struct.pack("<i", k) + base[k_off + 4:])
        out.append(struct.pack("<i", 2) + base[4:])  # version
        out.append(base[:8 + 4 * 48] + struct.pack("<i", 0)
                   + base[12 + 4 * 48:])  # sample rate 0
    return out


def _header_flips(fmt, base):
    """Every single-bit flip of the magic and version, and every flip that
    raises a count past what the file holds (in ``.mlx`` every raised count
    does; in ``.melonix`` the sample count's sign bit and the bits that put
    its samples past the end)."""
    out = []
    head = 8 if fmt == "mlx" else 4
    for byte in range(head):
        for bit in range(8):
            b = bytearray(base)
            b[byte] ^= 1 << bit
            out.append(bytes(b))
    counts = [(12, "<Q"), (28, "<I")] if fmt == "mlx" else [(4, "<i")]
    for off, code in counts:
        size = struct.calcsize(code)
        (value,) = struct.unpack_from(code, base, off)
        for bit in range(8 * size):
            b = bytearray(base)
            if b[off + bit // 8] & (1 << (bit % 8)):
                continue  # only 0 -> 1 flips
            b[off + bit // 8] |= 1 << (bit % 8)
            (raised,) = struct.unpack_from(code, b, off)
            if fmt == "mlx" or raised < 0 or 8 + 4 * raised > len(base):
                out.append(bytes(b))
    return out


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_corruption_corpus_raises_project_error(tmp_path, fmt):
    """Every truncation, the header flips and the hostile counts: the port
    raises ProjectError on each file (and allocates nothing from a count it
    has not checked); the JAX package raises some exception."""
    _save, load, _j_save, j_load = FORMATS[fmt]
    base = _corpus_base(tmp_path, fmt)
    corpus = [base[:cut] for cut in range(len(base))]
    corpus += _hostile(fmt, base) + _header_flips(fmt, base)
    path = str(tmp_path / f"bad.{fmt}")
    for i, data in enumerate(corpus):
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ProjectError):
            load(path)
        with pytest.raises(Exception):  # noqa: B017 - any exception
            j_load(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_seeded_bit_flips_load_alike_or_raise_project_error(tmp_path, fmt,
                                                            seed):
    """Seeded flips of 1-3 bits anywhere: where the JAX package loads the
    file, the port loads the same project; where it raises, the port raises
    ProjectError.  Never another exception from the port."""
    _save, load, _j_save, j_load = FORMATS[fmt]
    base = _corpus_base(tmp_path, fmt)
    rng = np.random.default_rng(seed)
    path = str(tmp_path / f"flip.{fmt}")
    for _ in range(150):
        b = bytearray(base)
        for pos in rng.integers(0, 8 * len(b), rng.integers(1, 4)):
            b[pos // 8] ^= 1 << (pos % 8)
        with open(path, "wb") as f:
            f.write(bytes(b))
        try:
            want = j_load(path)
        except Exception:  # noqa: BLE001 - any exception of the reference
            with pytest.raises(ProjectError):
                load(path)
            continue
        _same_project(load(path), want)


# ----------------------------------------------------------------------
# resample
# ----------------------------------------------------------------------


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 44100),
                                   (44100, 16000), (8000, 4000)])
def test_resample_matches_jax(rates, stereo):
    sr_in, sr_out = rates
    n = sr_in // 4 + 17
    rng = np.random.default_rng(sr_in + sr_out)
    t = np.arange(n) / sr_in
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if stereo:
        x = np.stack([x, 0.7 * x[::-1]], axis=1)
    got = tresample.resample(x, sr_in, sr_out, device="cpu")
    want = j_resample(x, sr_in, sr_out)
    assert got.shape == want.shape and got.dtype == np.float32
    assert _snr_db(got, want) < -100.0


def _peak_freq(x, sr):
    w = np.hanning(len(x))
    return np.argmax(np.abs(np.fft.rfft(x * w))) * sr / len(x)


def test_resample_preserves_tone():
    """tests/test_session.py::test_resample_preserves_tone on the port."""
    t = np.arange(SR * 2) / SR
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    for target in (12000, 44100, 4000):
        y = tresample.resample(x, SR, target, device="cpu")
        assert abs(len(y) - 2 * target) <= 1
        f = _peak_freq(y[target // 2 : -target // 2], target)
        assert abs(f - 440.0) < 2.0, (target, f)


def test_resample_multichannel_and_identity():
    """tests/test_session.py::test_resample_multichannel_and_identity."""
    x = np.random.default_rng(0).standard_normal((1000, 2)).astype(np.float32)
    same = tresample.resample(x, SR, SR, device="cpu")
    assert same is x or np.array_equal(same, x)
    y = tresample.resample(x, 8000, 4000, device="cpu")
    assert y.shape == (500, 2)
    assert tresample.resample(np.zeros(0, np.float32), 8000, 4000,
                              device="cpu").shape == (0,)


def test_resample_removes_above_nyquist():
    """tests/test_session.py::test_resample_removes_above_nyquist."""
    t = np.arange(SR * 2) / SR
    x = (np.sin(2 * np.pi * 3500.0 * t)).astype(np.float32)
    y = tresample.resample(x, SR, 4000, device="cpu")  # new Nyquist 2000
    assert np.sqrt(np.mean(y**2)) < 0.02


@pytest.mark.parametrize("fail", [False, True])
def test_resample_pins_ieee_float32_and_restores(monkeypatch, fail):
    """The products run at "highest" whatever the caller set, and the
    caller's setting comes back, also when the products raise."""
    seen = []
    real = tresample._polyphase_device

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        if fail:
            raise RuntimeError("boom")
        return real(*args)

    monkeypatch.setattr(tresample, "_polyphase_device", spy)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        x = _smooth(2000)
        if fail:
            with pytest.raises(RuntimeError, match="boom"):
                tresample.resample(x, SR, 12000, device="cpu")
        else:
            tresample.resample(x, SR, 12000, device="cpu")
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_resample_defaults_to_cuda():
    """No device given: the products go to ``cuda``, which this machine
    lacks, so the call raises rather than running on the CPU."""
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        tresample.resample(_smooth(1000), SR, 16000)


def test_filter_banks_equal_the_reference():
    from melonix_tpu.io.resample import _filter_banks as j_banks

    for up, down in ((160, 147), (147, 160), (160, 441), (1, 2)):
        got, want = tresample._filter_banks(up, down, 64), j_banks(up, down,
                                                                   64)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


# ----------------------------------------------------------------------
# tracing; the module boundary
# ----------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "tr" / "nested")
    with tracing.trace(log_dir):
        with tracing.span("melonix-region"):
            torch.ones(64).cumsum(0)
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "melonix-region" for e in events)


def test_trace_warns_and_runs_when_the_profiler_cannot_start(tmp_path,
                                                             caplog):
    ran = []
    with tracing.trace(str(tmp_path / "outer")):
        with tracing.trace(str(tmp_path / "inner")):
            ran.append(True)
    assert ran == [True]
    assert not (tmp_path / "inner").exists()
    assert any("profiler unavailable" in r.getMessage() for r in caplog.records)
    assert len(os.listdir(tmp_path / "outer")) == 1


def test_io_and_tracing_import_neither_jax_nor_the_reference():
    """In a fresh interpreter, every module of the port's ``io`` and
    ``utils.tracing`` import, and neither ``jax`` nor ``melonix_tpu``
    enters ``sys.modules``."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import melonix_tpu_torch.io as io\n"
        "mods = ['melonix_tpu_torch.io.' + m.name\n"
        "        for m in pkgutil.iter_modules(io.__path__)]\n"
        "mods.append('melonix_tpu_torch.utils.tracing')\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'melonix_tpu')]\n"
        "print(sorted(mods)); print(bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods, bad = res.stdout.splitlines()
    assert bad == "[]"
    for name in ("audio", "flac", "libav", "melonix", "project", "resample",
                 "wav"):
        assert f"melonix_tpu_torch.io.{name}" in mods
