"""Render engines of the port: edit maps, STFT and spectrogram columns,
grains and the granular render, phase vocoder, sessions, the waveform
min/max pyramid."""
