"""Render engines of the port: edit maps, STFT, phase vocoder."""
