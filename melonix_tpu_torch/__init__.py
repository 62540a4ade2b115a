"""melonix_tpu_torch: the PyTorch/CUDA port of melonix_tpu.

The marker edit model, the granular export (grain table, render plan and the
reference-parity render, with the native C++ host runtime), the
phase-vocoder render (chunked stretch with exact phase carry, OLA
normalisation, variable-rate resample, formant preservation, identity phase
locking, any frame size, multichannel), live playback (the streaming phase
vocoder and the player with both engines), the Hann
|STFT|, the spectrogram display data (reference-parity 32768-point columns,
the tile server, the Hann |STFT| pyramid and the waveform min/max pyramid),
and the analysis half of the editor (the pitch curve, suggested markers and
autotune), batch rendering, audio import and export (WAV, FLAC, MP3 and Ogg
Vorbis through the native decoders, the long tail through the libav shim),
``.mlx`` and ``.melonix`` projects, band-limited resampling, the session
warm-up at file open (``warmup_session``), and the multi-device renders and analyses on
torch.distributed (``parallel/``: tracks or channels over a mesh's ``data``
ranks, one track's frames over its ``seq`` ranks; one process per card,
``launch`` / ``join_group`` / ``rank_device``), on an NVIDIA GPU
through hand-written CUDA kernels (``kernels/``, sources in ``csrc/``).
Every public function runs on the device it is given: a CUDA tensor
launches the kernels, a CPU tensor runs their plain PyTorch twins.  The
package imports neither JAX nor ``melonix_tpu``.
"""

from .config import DEFAULT_CONFIG, Config
from .engine.grains import GrainTable, build_grain_table
from .engine.autotune import autotune, suggest_markers
from .engine.batch import render_batch
from .engine.maps import MapKnots
from .engine.phase_vocoder import (identity_lock, render_channels_pv,
                                   render_track_pv)
from .engine.player import Player
from .engine.pv_stream import PvStream
from .engine.pitch import PitchCurve, pitch_curve
from .engine.render import RenderPlan, build_render_plan, render, render_track
from .engine.session import render_session
from .engine.pyramid import build_pyramid
from .engine.spectral import spectrogram_columns, stft_mags_device
from .io import (Project, load_audio, load_project, read_wav, save_project,
                 write_audio, write_flac, write_wav)
from .io.audio import DecodeError
from .markers import Marker, markers_from_json, markers_to_json, sort_markers
from .parallel import (AudioMesh, data_parallel_pv, data_parallel_render,
                       join_group, launch, make_audio_mesh, rank_device, seq_parallel_pv, seq_parallel_render,
                       session_step, session_step_full, sharded_pitch,
                       sharded_spectrogram_columns, sharded_stft_mags)
from .runtime.spec_pyramid import SpecPyramid
from .runtime.tiles import TileServer
from .runtime.warmup import warmup_session, warmup_session_async

__version__ = "0.1.0"

__all__ = [
    "Config",
    "DEFAULT_CONFIG",
    "Marker",
    "markers_from_json",
    "markers_to_json",
    "sort_markers",
    "MapKnots",
    "GrainTable",
    "build_grain_table",
    "RenderPlan",
    "build_render_plan",
    "render",
    "render_track",
    "render_session",
    "render_batch",
    "AudioMesh",
    "make_audio_mesh",
    "launch",
    "join_group",
    "rank_device",
    "sharded_stft_mags",
    "sharded_pitch",
    "sharded_spectrogram_columns",
    "data_parallel_render",
    "seq_parallel_render",
    "data_parallel_pv",
    "seq_parallel_pv",
    "session_step",
    "session_step_full",
    "render_track_pv",
    "render_channels_pv",
    "identity_lock",
    "PvStream",
    "Player",
    "PitchCurve",
    "pitch_curve",
    "suggest_markers",
    "autotune",
    "stft_mags_device",
    "spectrogram_columns",
    "TileServer",
    "SpecPyramid",
    "build_pyramid",
    "load_audio",
    "write_audio",
    "DecodeError",
    "read_wav",
    "write_wav",
    "write_flac",
    "Project",
    "load_project",
    "save_project",
    "warmup_session",
    "warmup_session_async",
    "__version__",
]
