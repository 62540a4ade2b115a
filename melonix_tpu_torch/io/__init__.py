"""Audio and project I/O of the port."""

from .audio import load_audio, write_audio
from .flac import write_flac
from .project import Project, load_project, save_project
from .wav import read_wav, write_wav

__all__ = [
    "load_audio",
    "write_audio",
    "read_wav",
    "write_wav",
    "write_flac",
    "Project",
    "load_project",
    "save_project",
]
