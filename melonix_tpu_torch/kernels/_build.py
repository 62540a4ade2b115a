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
server's worker and the caller) build once.  A launcher calls :func:`build`
(which loads nothing and touches no card) before it starts its ranks, so
they find the library built.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``.  :func:`launch` is the one place a wrapper of
``kernels/`` launches one: it makes the operands' card current, opens the
span ``kernel.<name>``, calls the entry on PyTorch's current stream, raises
on a non-zero code (:func:`check`) and counts the launch on the wrapper
(:func:`counted`).  A wrapper asks :func:`on_card` whether its tensor is on
a card at all; it alone then picks its kernel or its plain twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..utils import tracing

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
    # n_frames, m0, f_real, hop, cart, lock, fused, stream
    "mlx_pv_synth_ola_phase": (_P,) * 17 + (_I,) * 7 + (_P,),
    # re, im, da, phi0, resid_in, phi_prev, scratch, s_re, s_im, s_phi,
    # resid_last, phi_last, phi0_eff, n_frames, m0, f_real, hop, cart, lock,
    # stream
    "mlx_pv_phase_scan": (_P,) * 13 + (_I,) * 6 + (_P,),
    # y, n_src, base, a0, cnt, anc_j, anc_src, anc_r, anc_s, n_anc,
    # out, n_out, sr, stream
    "mlx_resample_pv": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P, _L, _I, _P),
    # wav, n, gs, rate, sz, off, n_steps, a0, cnt, szmax, out, out_len,
    # stream
    "mlx_render_granular": (_P, _L, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I,
                            _P),
    # wav, n, win, tw, out, n_frames, size, hop, scale, stream
    "mlx_stft_mag_sizes": (_P, _L, _P, _P, _P, _I, _I, _I, _F, _P),
    "mlx_stft_mag_pair": (_P, _L, _P, _P, _P, _I, _I, _I, _F, _P),
    "mlx_stft_mag_large": (_P, _L, _P, _P, _P, _I, _I, _I, _F, _P),
    # wav, n, starts, ends, tw, out, n_cols, size, neg_decay, inv_size,
    # kgain, colormap, stream
    "mlx_spectrogram_columns": (_P, _L, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                                _I, _P),
    "mlx_spectrogram_columns_large": (_P, _L, _P, _P, _P, _P, _I, _I, _F, _F,
                                      _F, _I, _P),
    "mlx_spectrogram_columns_cluster": (_P, _L, _P, _P, _P, _P, _I, _I, _F,
                                        _F, _F, _I, _P),
    # wav, n, tw, ac, w, n_frames, hop, stream
    "mlx_pitch_ac": (_P, _L, _P, _P, _P, _I, _I, _P),
    # wav, n, starts, out, n_frames, size, stream
    "mlx_extract_frames": (_P, _L, _P, _P, _I, _I, _P),
    # y, n_src, pos, base, j0, n, rows, out, wait, stream
    "mlx_resample_lerp_window": (_P, _L, _P, _P, _L, _I, _I, _P, _I, _P),
    # host, &device
    "mlx_host_device_pointer": (_P, ctypes.POINTER(_P)),
    # mag, psi, win, tw, frames, y, n_frames, hop, fused, stream
    "mlx_pv_synth_ola": (_P,) * 6 + (_I, _I, _I, _P),
    # wav, n, win, tw, tw2, scratch, out, n_frames, size, n1, hop, scale,
    # stream
    "mlx_stft_mag_4step": (_P, _L) + (_P,) * 5 + (_I, _I, _I, _I, _F, _P),
    # wav, n, win, tw, tab, scratch, out, n_frames, size, n1, hop, scale,
    # stream
    "mlx_stft_mag_bluestein": (_P, _L) + (_P,) * 5 + (_I, _I, _I, _I, _F,
                                                      _P),
    # wav, n, win, tw, tab, scratch, work, out, n_frames, size, n1, hop,
    # scale, stream
    "mlx_stft_mag_bluestein_scratch": (_P, _L) + (_P,) * 6 + (_I, _I, _I, _I,
                                                              _F, _P),
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
    one ``nvcc -c`` per source, all started together, then one link.  It
    loads nothing and touches no card."""
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
    """Validate a kernel operand: device (a bare ``cuda`` is the current
    card), dtype, shape, contiguity."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def upload(device, *hosts: np.ndarray) -> tuple:
    """NumPy arrays ``hosts`` as tensors on ``device``, in order: one copy
    each from pageable memory, under one ``h2d`` span with their bytes,
    where ``device`` is not the CPU (there each tensor shares its array's
    memory)."""
    ts = tuple(torch.from_numpy(h) for h in hosts)
    if torch.device(device).type == "cpu":
        return ts
    with tracing.span("h2d", bytes=sum(h.nbytes for h in hosts), pageable=1):
        return tuple(t.to(device) for t in ts)


def upload_packed(ints, floats, device) -> tuple:
    """A kernel's small operands in one host-to-device copy: the int32
    arrays ``ints`` and the float32 arrays ``floats`` (by their bits),
    back to back in one int32 host array, uploaded to ``device``; returns
    views of it in that order (int32, then float32)."""
    ints = [np.asarray(a, np.int32) for a in ints]
    floats = [np.ascontiguousarray(a, np.float32).view(np.int32)
              for a in floats]
    (packed,) = upload(device, np.concatenate(ints + floats))
    views = torch.split(packed, [a.shape[0] for a in ints + floats])
    return views[: len(ints)] + tuple(v.view(torch.float32)
                                      for v in views[len(ints):])


def host_device_pointer(t) -> int:
    """The card's address of page-locked host tensor ``t``'s data
    (``cudaHostGetDevicePointer``); raises where the memory is not pinned
    and mapped into the card's address space."""
    if t.device.type != "cpu" or not t.is_pinned():
        raise ValueError("host_device_pointer: needs a pinned host tensor")
    out = ctypes.c_void_p()
    check("host_device_pointer",
          library().mlx_host_device_pointer(t.data_ptr(), ctypes.byref(out)))
    return int(out.value)


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the kernels take it:
    its raw handle, read without building a ``torch.cuda.Stream`` object
    (which costs a short kernel's launch several microseconds more).  It
    reads the handle through ``torch._C._cuda_getCurrentRawStream``, a
    private API of PyTorch that every launch relies on here; should it go,
    ``torch.cuda.current_stream(device).cuda_stream`` gives the same handle."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def on_card(t) -> bool:
    """Whether ``t`` is on a CUDA card, where a wrapper launches its kernel
    (at the shapes the kernel takes); False on the CPU, where it runs its
    plain twin.  Raises for any other device: no kernel and no twin runs
    there in a wrapper's stead."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(
        f"no kernel for a tensor on {t.device}: CUDA launches the "
        "kernel, CPU runs the plain twin"
    )


COUNTED: list = []  # every wrapper that counts its launches


def counted(fn):
    """Give the wrapper ``fn`` its launch count, ``fn.launches`` (0 here;
    :func:`launch` adds to it), and list it in :data:`COUNTED`."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launch(wrapper, name: str, entry: str, device, *args) -> None:
    """Launch the C entry point ``entry`` on ``device``'s current stream:
    ``device`` made the current card (the C side launches on the calling
    thread's current card, so a tensor on any card launches on its own),
    under the span ``kernel.<name>``, with ``args`` (a tensor by its data
    pointer, held until the call returns) and the stream last; raises if
    the entry reports an error (named ``name``), then adds one to
    ``wrapper.launches``.  ``wrapper`` is the calling wrapper as its module
    names it at the call, so that whatever holds that name meanwhile (a
    benchmark's timer) keeps the count."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device), tracing.span("kernel." + name):
        err = getattr(library(), entry)(*ptrs, stream(device))
    check(name, err)
    wrapper.launches += 1
