"""Multi-device renders and analyses on torch.distributed (counterpart of
``melonix_tpu/parallel``), one process per card (``launch``)."""

from .launch import RankDeviceError, join_group, launch, rank_device
from .sharded import (
    AudioMesh,
    make_audio_mesh,
    sharded_stft_mags,
    sharded_pitch,
    sharded_spectrogram_columns,
    data_parallel_render,
    granular_batch_args,
    seq_parallel_render,
    seq_render,
    seq_render_args,
    data_parallel_pv,
    pv_batch_args,
    seq_parallel_pv,
    seq_pv_args,
    session_step,
    session_step_full,
)

__all__ = [
    "RankDeviceError",
    "join_group",
    "launch",
    "rank_device",
    "AudioMesh",
    "make_audio_mesh",
    "sharded_stft_mags",
    "sharded_pitch",
    "sharded_spectrogram_columns",
    "data_parallel_render",
    "granular_batch_args",
    "seq_parallel_render",
    "seq_render",
    "seq_render_args",
    "data_parallel_pv",
    "pv_batch_args",
    "seq_parallel_pv",
    "seq_pv_args",
    "session_step",
    "session_step_full",
]
