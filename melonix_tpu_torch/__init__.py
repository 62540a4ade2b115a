"""melonix_tpu_torch: the PyTorch/CUDA port of melonix_tpu.

The marker edit model, the host float64 render plan and the phase-vocoder
render (chunked stretch with exact phase carry, OLA normalisation,
variable-rate resample) plus the 2048/512 Hann |STFT|, on an NVIDIA GPU
through hand-written CUDA kernels (``kernels/``, sources in ``csrc/``).
Every public function runs on the device it is given: a CUDA tensor
launches the kernels, a CPU tensor runs their plain PyTorch twins.  The
package imports neither JAX nor ``melonix_tpu``.
"""

from .config import DEFAULT_CONFIG, Config
from .engine.maps import MapKnots
from .engine.phase_vocoder import render_track_pv
from .engine.spectral import stft_mags_device
from .io.wav import read_wav, write_wav
from .markers import Marker, markers_from_json, markers_to_json, sort_markers

__version__ = "0.1.0"

__all__ = [
    "Config",
    "DEFAULT_CONFIG",
    "Marker",
    "markers_from_json",
    "markers_to_json",
    "sort_markers",
    "MapKnots",
    "render_track_pv",
    "stft_mags_device",
    "read_wav",
    "write_wav",
    "__version__",
]
