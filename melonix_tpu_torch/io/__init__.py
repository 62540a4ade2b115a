"""Audio I/O of the port (WAV only so far)."""

from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
