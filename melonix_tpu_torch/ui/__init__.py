"""The editor of the port (counterpart of ``melonix_tpu/ui/``).

``state.py`` (the editor state and its gestures, on a device), ``view.py``
(the scene raster), ``web.py`` (the browser shell: HTTP, the live
``/audio/stream``, autosave), ``dialogs.py`` (file dialogs), ``png.py``
(frame encoders) and ``colormap.py`` (the spectrogram colormap).  The
package exports no names of its own, as the JAX package's does not.
"""
