"""Build and load the port's hand-written CUDA kernels.

Every ``.cu`` file under ``melonix_tpu_torch/csrc/`` is compiled by its own
``nvcc`` for Hopper (``sm_90a``), all of them at once, and the objects are
linked into ONE shared library with a plain C interface,
``build/kernels/libmelonix_torch_kernels.so`` beside the package, loaded
with ``ctypes``.  No source includes PyTorch's headers, so a cold build takes
seconds, not minutes.  The build runs at the first kernel launch of a process
(never at import: the CPU tests import every module) and again whenever the
hash of the sources and flags changes.  One lock serialises the build and
the load, so threads that launch their first kernels together (the tile
server's worker and the caller) build once.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmelonix_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in nvcc.log
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_LOCK = threading.RLock()  # build() and the one-time load in library()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes (all return int = cudaError_t).
SIGNATURES = {
    # wav, n, win, tw, out, n_frames, hop, scale, stream
    "mlx_stft_mag": (_P, _L, _P, _P, _P, _I, _I, _F, _P),
    # wav, n, starts, win, tw, re, im, n_frames, stream
    "mlx_pv_analysis": (_P, _L, _P, _P, _P, _P, _P, _I, _P),
    # re, im, da, win, tw, phi0, resid_in, phi_prev, scratch,
    # s_re, s_im, s_phi, frames, y, resid_last, phi_last, phi0_eff,
    # n_frames, m0, f_real, hop, cart, lock, stream
    "mlx_pv_synth_ola_phase": (_P,) * 17 + (_I,) * 6 + (_P,),
    # re, im, da, phi0, resid_in, phi_prev, scratch, s_re, s_im, s_phi,
    # resid_last, phi_last, phi0_eff, n_frames, m0, f_real, hop, cart, lock,
    # stream
    "mlx_pv_phase_scan": (_P,) * 13 + (_I,) * 6 + (_P,),
    # y, n_src, base, a0, cnt, anc_j, anc_src, anc_r, anc_s, n_anc,
    # out, n_out, sr, stream
    "mlx_resample_pv": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P, _L, _I, _P),
    # wav, n, gs, rate, sz, n_steps, szmax, out, stream
    "mlx_render_steps": (_P, _L, _P, _P, _P, _I, _I, _P, _P),
    # vals, n_steps, szmax, off, a0, cnt, out, out_len, stream
    "mlx_compact": (_P, _I, _I, _P, _P, _P, _P, _I, _P),
    # wav, n, win, tw, out, n_frames, size, hop, scale, stream
    "mlx_stft_mag_sizes": (_P, _L, _P, _P, _P, _I, _I, _I, _F, _P),
    # wav, n, starts, ends, tw, out, n_cols, size, neg_decay, inv_size,
    # kgain, colormap, stream
    "mlx_spectrogram_columns": (_P, _L, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                                _I, _P),
    # wav, n, tw, ac, w, n_frames, hop, stream
    "mlx_pitch_ac": (_P, _L, _P, _P, _P, _I, _I, _P),
    # wav, n, starts, out, n_frames, size, stream
    "mlx_extract_frames": (_P, _L, _P, _P, _I, _I, _P),
    # y, n_src, pos, base, out, n_out, rows, stream
    "mlx_resample_lerp": (_P, _L, _P, _P, _P, _L, _I, _P),
    # mag, psi, win, tw, frames, y, n_frames, hop, stream
    "mlx_pv_synth_ola": (_P,) * 6 + (_I, _I, _P),
    # wav, n, starts, ends, tw, tw2, scratch, out, n_cols, size, n1,
    # neg_decay, inv_size, kgain, colormap, stream
    "mlx_spectrogram_columns_4step": (_P, _L) + (_P,) * 6 + (_I, _I, _I,
                                                             _F, _F, _F, _I,
                                                             _P),
    # wav, n, win, tw, tw2, scratch, out, n_frames, size, n1, hop, scale,
    # stream
    "mlx_stft_mag_4step": (_P, _L) + (_P,) * 5 + (_I, _I, _I, _I, _F, _P),
}


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of melonix_tpu_torch are built from source at first use"
    )


def build() -> Path:
    """Compile the kernels unless a library of the current hash exists:
    one ``nvcc -c`` per source, all started together, then one link."""
    with _LOCK:
        lib = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / (LIB_NAME + ".sha256")
        digest = source_hash()
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.{threading.get_ident()}"  # unique per thread
        nvcc = nvcc_path()
        jobs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _obj, proc in jobs:
            out = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
        if not failed:
            cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
                   *[str(obj) for _cmd, obj, _proc in jobs]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"link ({res.returncode}):\n{res.stderr}")
        (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
        for _cmd, obj, _proc in jobs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
        stamp.write_text(digest)
        return lib


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mlx_error_string.argtypes = (ctypes.c_int,)
    lib.mlx_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), one per process."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _load(build())
    return _LIB


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a launch error."""
    if err != 0:
        msg = library().mlx_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate a kernel operand: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def cuda_device(t):
    """The CUDA device of ``t``; raises for any device but CUDA (CPU
    tensors never reach here: the wrappers send them to the plain twins)."""
    if t.device.type != "cuda":
        raise ValueError(
            f"no kernel for a tensor on {t.device}: CUDA launches the "
            "kernel, CPU runs the plain twin"
        )
    return t.device
