"""Display helpers of the port: the spectrogram colormap."""
