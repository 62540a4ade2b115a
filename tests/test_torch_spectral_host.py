"""melonix_tpu_torch's frame matrix and host STFT against melonix_tpu's.

``extract_hop_frames`` equal to the JAX package's in both of its cases
(the hop divides the frame, and not), with and without samples past the
end; ``stft`` against ``melonix_tpu.engine.spectral.stft`` at the JAX
suite's spectral bar (test_spectral.py:94-110), and its round trip through
the port's ``istft_device`` at that suite's 1e-4 (test_spectral.py:78-88).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melonix_tpu.config import Config as JConfig
from melonix_tpu.engine import spectral as JS

from melonix_tpu_torch.config import Config
from melonix_tpu_torch.engine import spectral as S


@pytest.mark.parametrize("size,hop", [(512, 128), (512, 512), (1000, 250),
                                      (600, 250), (256, 300)])
@pytest.mark.parametrize("n_frames", [1, 7, 40])
def test_extract_hop_frames_matches_jax(size, hop, n_frames):
    x = np.random.default_rng(size + hop).standard_normal(9000).astype(
        np.float32)
    got = S.extract_hop_frames(torch.from_numpy(x), size, hop, n_frames)
    want = np.asarray(JS.extract_hop_frames(jnp.asarray(x), size, hop,
                                            n_frames))
    assert got.shape == want.shape == (n_frames, size)
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_hop_frames_zeros_past_the_end():
    x = np.arange(1, 1001, dtype=np.float32)
    for size, hop in ((512, 128), (600, 250)):
        got = S.extract_hop_frames(torch.from_numpy(x), size, hop, 6).numpy()
        want = np.asarray(JS.extract_hop_frames(jnp.asarray(x), size, hop, 6))
        np.testing.assert_array_equal(got, want)
        assert got[5, -1] == 0.0 and got[0, 0] == 1.0


@pytest.mark.parametrize("size,hop", [(512, 128), (1000, 250), (2048, 512)])
def test_stft_matches_jax(chirp, size, hop):
    x, _sr = chirp
    got, g_hop = S.stft(x, Config(stft_size=size, stft_hop=hop),
                        device="cpu")
    want, w_hop = JS.stft(x, JConfig(stft_size=size, stft_hop=hop))
    assert g_hop == w_hop == hop
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_stft_size_and_hop_override_the_config(chirp):
    x, _sr = chirp
    got, hop = S.stft(x, size=256, hop=64, device="cpu")
    want, _ = JS.stft(x, size=256, hop=64)
    assert hop == 64 and got.shape == want.shape == (
        S.num_frames(len(x), 256, 64), 129)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


def test_stft_roundtrip(chirp):
    x, _sr = chirp
    frames, hop = S.stft(x, Config(stft_size=512, stft_hop=128), device="cpu")
    win = torch.from_numpy(S.hann_window(512))
    out = S.istft_device(torch.from_numpy(frames), win, 512, hop,
                         len(x)).numpy()
    lo, hi = 512, len(x) - 512
    np.testing.assert_allclose(out[lo:hi], x[lo:hi], atol=1e-4)


def test_stft_defaults_to_the_card(chirp, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        S.stft(chirp[0])
