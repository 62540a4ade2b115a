"""The port's WAV import (``melonix_tpu_torch.io.audio.load_audio``) against
``melonix_tpu.io.audio.load_audio``, bit for bit.

Both decode through the native ``mlx_wav_read`` of
``native/melonix_native.cpp``: its mono downmix sums the channels in float32
and multiplies by ``1.0f / ch``, which a NumPy mean does not reproduce at 3
or 6 channels.  The fixtures are seeded WAVs in every sample format the
decoder takes, at 1, 2, 3 and 6 channels.
"""

import struct

import numpy as np
import pytest

import oracle
from melonix_tpu.io.audio import load_audio as j_load_audio
from melonix_tpu.io.wav import read_wav as j_read_wav
from melonix_tpu.runtime import native as jnative

import melonix_tpu_torch as mt
from melonix_tpu_torch import cli
from melonix_tpu_torch.io import audio as taudio
from melonix_tpu_torch.runtime import native as tnative

RATE = 16000
FORMATS = ["int16", "uint8", "int24", "int32", "float32", "float64",
           "extensible"]
CHANNELS = [1, 2, 3, 6]
_EXT_PCM = bytes.fromhex("0100000000001000800000aa00389b71")  # KSDATAFORMAT_SUBTYPE_PCM


def _payload(fmt: str, n: int, ch: int, rng) -> tuple[int, int, bytes]:
    """(format tag, bits, interleaved sample bytes) of seeded samples."""
    if fmt in ("int16", "extensible"):
        return 1, 16, rng.integers(-32768, 32768, (n, ch)).astype("<i2").tobytes()
    if fmt == "uint8":
        return 1, 8, rng.integers(0, 256, (n, ch)).astype(np.uint8).tobytes()
    if fmt == "int24":
        v = rng.integers(-(1 << 23), 1 << 23, (n, ch)).astype("<i4")
        raw = v.view(np.uint8).reshape(n, ch, 4)[:, :, :3]
        return 1, 24, raw.tobytes()
    if fmt == "int32":
        return 1, 32, rng.integers(-(1 << 31), 1 << 31, (n, ch)).astype("<i4").tobytes()
    x = rng.uniform(-1.0, 1.0, (n, ch))
    if fmt == "float32":
        return 3, 32, x.astype("<f4").tobytes()
    return 3, 64, x.astype("<f8").tobytes()


def _write(path, fmt: str, n: int, ch: int, seed: int = 0) -> str:
    tag, bits, data = _payload(fmt, n, ch, np.random.default_rng(seed))
    align = ch * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if fmt == "extensible" else tag, ch,
                       RATE, RATE * align, align, bits)
    if fmt == "extensible":
        head += struct.pack("<HHI", 22, bits, (1 << ch) - 1) + _EXT_PCM
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(head)) + head
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _native_reference():
    """Both sides must take the native decoder: the reference's library is
    built by the suite's conftest, the port's by ``try_load``."""
    assert jnative.try_load() is not None
    assert hasattr(jnative.try_load(), "mlx_wav_info")
    assert tnative.try_load() is not None


@pytest.mark.parametrize("mono", [True, False])
@pytest.mark.parametrize("ch", CHANNELS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_audio_equals_the_reference(tmp_path, fmt, ch, mono):
    path = _write(tmp_path / f"{fmt}_{ch}.wav", fmt, 1001, ch, seed=ch)
    calls = tnative.decode_wav.calls
    got, rate = mt.load_audio(path, mono=mono)
    assert tnative.decode_wav.calls == calls + 1
    want, want_rate = j_load_audio(path, mono=mono)
    assert rate == want_rate == RATE
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == ((1001,) if mono or ch == 1 else (1001, ch))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ch", [3, 6])
def test_native_downmix_is_not_the_numpy_mean(tmp_path, ch):
    """Why the port decodes natively: at 3 and 6 channels the float32
    ``acc * (1.0f / ch)`` differs from a NumPy mean on some samples."""
    path = _write(tmp_path / "x.wav", "float32", 4001, ch, seed=ch)
    got, _ = mt.load_audio(path)
    x, _ = mt.read_wav(path)
    assert np.any(got != taudio.downmix_mono(x))
    acc = np.zeros(len(x), np.float32)
    for c in range(ch):
        acc += x[:, c]
    np.testing.assert_array_equal(got, acc * np.float32(1.0 / ch))


@pytest.mark.parametrize("ch", [1, 2])
def test_without_a_compiler_the_numpy_reader_agrees(tmp_path, monkeypatch, ch):
    path = _write(tmp_path / "x.wav", "int16", 777, ch, seed=5)
    monkeypatch.setattr(tnative, "try_load", lambda: None)
    calls = tnative.decode_wav.calls
    got, rate = mt.load_audio(path)
    assert tnative.decode_wav.calls == calls
    want, _ = j_load_audio(path)
    assert rate == RATE
    np.testing.assert_array_equal(got, want)


def _corrupt(path) -> str:
    data = bytearray(open(_write(path, "int16", 100, 1), "rb").read())
    data[34:36] = struct.pack("<H", 12)  # 12-bit PCM: no decoder takes it
    open(path, "wb").write(bytes(data))
    return str(path)


def _truncated(path) -> str:
    data = open(_write(path, "int16", 100, 1), "rb").read()
    open(path, "wb").write(data[:30])  # cut inside the fmt chunk
    return str(path)


def _not_riff(path) -> str:
    open(path, "wb").write(b"RIFX" + bytes(40))
    return str(path)


@pytest.mark.parametrize("make", [_corrupt, _truncated, _not_riff])
def test_bad_wav_raises_decode_error(tmp_path, make):
    path = make(tmp_path / "bad.wav")
    with pytest.raises(mt.DecodeError):
        mt.load_audio(path)
    with pytest.raises(Exception):  # the reference refuses it too
        j_load_audio(path)


def test_other_suffixes_raise_decode_error(tmp_path):
    """A ``.flac`` (once refused as "only WAV") decodes through the native
    FLAC decoder, bit for bit the reference's ``load_audio``, mono and
    multichannel; an empty one raises DecodeError in both."""
    path = str(tmp_path / "x.flac")
    rng = np.random.default_rng(3)
    mt.write_flac(path, rng.uniform(-1, 1, (4000, 3)).astype(np.float32),
                  RATE)
    for mono in (True, False):
        got, rate = mt.load_audio(path, mono=mono)
        want, rate_j = j_load_audio(path, mono=mono)
        assert rate == rate_j == RATE and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    empty = str(tmp_path / "empty.flac")
    open(empty, "wb").close()
    with pytest.raises(mt.DecodeError):
        mt.load_audio(empty)


def test_cli_render_of_three_channels_equals_the_oracle(tmp_path, capsys):
    """The granular CLI render of a 3-channel int16 WAV equals
    ``oracle.export`` of the reference's own decode, exactly."""
    n = 3 * RATE
    t = np.arange(n) / RATE
    rng = np.random.default_rng(12)
    x = np.stack([0.4 * np.sin(2 * np.pi * f * t) for f in (150, 220, 331)], 1)
    x += 0.05 * rng.standard_normal(x.shape)
    pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2")
    src = str(tmp_path / "in.wav")
    with open(src, "wb") as f:
        head = struct.pack("<HHIIHH", 1, 3, RATE, RATE * 6, 6, 16)
        data = pcm.tobytes()
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                + struct.pack("<I", 16) + head + b"data"
                + struct.pack("<I", len(data)) + data)
    markers = [(12000, 60.0, 0.1, 2.0), (30000, 62.0, -0.05, -1.0)]
    mpath = tmp_path / "m.json"
    mpath.write_text(mt.markers_to_json([mt.Marker(*m) for m in markers]))
    out = str(tmp_path / "out.wav")
    assert cli.main(["render", src, "--markers", str(mpath), "-o", out,
                     "--engine", "granular", "--dtype", "float32",
                     "--device", "cpu"]) == 0
    got, rate = j_read_wav(out)
    ref, _ = j_load_audio(src)
    want = oracle.export(ref, oracle.build_grains(ref, 1500), markers, RATE)
    assert rate == RATE
    np.testing.assert_array_equal(got, want)


class _Read(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["pitch", "{src}", "-o", "{out}"],
    ["autotune", "{src}", "-o", "{out}"],
    ["batch", "{src}", "-o", "{out}"],
])
def test_cli_analysis_and_batch_read_through_load_audio(tmp_path, monkeypatch,
                                                        argv):
    src = _write(tmp_path / "in.wav", "int16", 500, 3)
    seen = []

    def counting(path, *, mono=True):
        seen.append((path, mono))
        raise _Read

    monkeypatch.setattr(taudio, "load_audio", counting)
    args = [a.format(src=src, out=tmp_path / "o") for a in argv]
    with pytest.raises(_Read):
        cli.main([*args, "--device", "cpu"])
    assert seen == [(src, True)]
