"""Host runtime of the port: the native C++ grain chain and render plan,
the spectrogram tile server and the Hann |STFT| pyramid."""
