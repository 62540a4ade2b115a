"""Render engines of the port: edit maps, STFT, grains and the granular
render, phase vocoder, sessions."""
