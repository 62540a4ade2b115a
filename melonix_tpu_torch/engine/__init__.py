"""Render engines of the port: edit maps, STFT and spectrogram columns,
grains and the granular render, phase vocoder (with formant preservation),
sessions, the waveform min/max pyramid, the pitch curve and autotune."""
