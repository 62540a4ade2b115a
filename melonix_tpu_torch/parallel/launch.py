"""One process per card: the port's counterpart of the JAX package's "every
device of the process".

The JAX package runs one process over every visible device and shards over
a mesh of them (``melonix_tpu/engine/session.py:_session_mesh``).  PyTorch
runs one process per card instead, each a rank of a torch.distributed
process group, and this module forms that group:

* :func:`rank_device` -- the card a rank computes on: under a launcher
  (``torchrun``, or :func:`launch`) a bare ``"cuda"`` is
  ``cuda:{LOCAL_RANK}``, made the current device before anything launches
  on it; a ``LOCAL_RANK`` with no card of its own raises
  :class:`RankDeviceError` before NCCL sees the rank.
* :func:`join_group` -- where the launcher's environment names a group
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and none exists, initialises it: NCCL on the cards,
  gloo on the CPU, with a finite timeout so that a dead rank ends the run.
* :func:`launch` -- builds the kernels and the native library once, then
  runs ``n`` ranks of ``python -m melonix_tpu_torch <argv>`` under
  PyTorch's own launcher (``torch.distributed.run --standalone``: a free
  local port, that environment, every rank stopped when one fails) and
  returns its exit code.

Nothing here retreats to fewer cards or to the CPU: a rank's failure is
the run's failure.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from ..engine.spectral import require_device

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
GROUP_TIMEOUT_S = 600  # a collective waits this long for a dead rank
STOP_GRACE_S = 60  # torchrun's own stop sends SIGKILL after 30 s
PACKAGE = "melonix_tpu_torch"

_JOINED = False  # join_group initialised the default group


class RankDeviceError(RuntimeError):
    """A rank's ``LOCAL_RANK`` names a card this machine does not have."""


def launched() -> bool:
    """Whether the launcher's environment names a process group."""
    return all(k in os.environ for k in LAUNCH_ENV)


def grouped() -> bool:
    """Whether a process group exists."""
    return dist.is_available() and dist.is_initialized()


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on, made current where it is a card.

    ``"cpu"`` stays ``"cpu"``.  Under a launcher or a process group with
    ``LOCAL_RANK`` set, a bare ``"cuda"`` is ``cuda:{LOCAL_RANK}``; without
    one it is the current card.  ``cuda:N`` stays ``cuda:N``.  A card index
    at or above ``torch.cuda.device_count()`` raises
    :class:`RankDeviceError`, naming the rank and the card count; CUDA where
    there is none raises as :func:`engine.spectral.require_device` does."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    require_device(dev)
    index = dev.index
    local = os.environ.get("LOCAL_RANK")
    if index is None and local is not None and (launched() or grouped()):
        index = int(local)
    count = torch.cuda.device_count()
    if index is not None and not 0 <= index < count:
        rank = os.environ.get("RANK", "?")
        raise RankDeviceError(
            f"rank {rank} (LOCAL_RANK {local}) asks for cuda:{index}, but "
            f"this process sees {count} card(s): one rank per card, no two "
            "ranks on one card (CUDA_VISIBLE_DEVICES limits the cards)"
        )
    if index is None:
        index = torch.cuda.current_device()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def join_group(device="cuda") -> torch.device:
    """This rank's device (:func:`rank_device`), after joining the process
    group that the launcher's environment names, if none exists yet: NCCL
    for a card, gloo for the CPU, through ``env://`` (``torchrun``'s store
    where it runs one), with ``GROUP_TIMEOUT_S`` for every collective.
    Without that environment, or with a group already formed, it only
    picks the device."""
    global _JOINED
    dev = rank_device(device)  # before NCCL: the port's error comes first
    if not launched() or grouped():
        return dev
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(  # env://: torchrun's store, or MASTER_ADDR's
        "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    _JOINED = True
    return dev


def leave_group() -> None:
    """Destroy the default group if :func:`join_group` formed it."""
    global _JOINED
    if _JOINED and grouped():
        from . import sharded

        sharded._AUTO.clear()  # its groups go with the default group
        dist.destroy_process_group()
    _JOINED = False


def is_rank0() -> bool:
    """Whether this process is rank 0 of its group (or has none)."""
    return not grouped() or dist.get_rank() == 0


def device_arg(argv) -> str:
    """The value of a CLI argument list's ``--device`` (the CLI's default
    ``cuda`` without one)."""
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def build_once(device: str) -> None:
    """The parent's builds before any rank starts: the native host library
    always, the CUDA kernels for a card (neither loads a library or touches
    a card, so no CUDA context exists in the parent)."""
    from ..kernels import _build
    from ..runtime import native

    native.build_library()
    if torch.device(device).type == "cuda":
        _build.build()


def launch(argv, n: int, *, module: str = PACKAGE, env=None,
           timeout: float | None = None) -> int:
    """Run ``python -m <module> <argv>`` as ``n`` ranks of one process
    group on this machine; 0 when every rank exits 0, else non-zero.

    The parent builds first (:func:`build_once`, on the ``--device`` of
    ``argv``), then runs ``python -m torch.distributed.run --standalone
    --nproc-per-node n``, with the package's
    directory on ``PYTHONPATH`` and ``OMP_NUM_THREADS`` the machine's cores
    over ``n`` unless ``env`` (default ``os.environ``) sets it.  The ranks
    write to this process's standard output and error.  When a rank fails,
    PyTorch's launcher stops the others and exits 1; past ``timeout``
    seconds it is told to stop its ranks and the result is 124."""
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    argv = [str(a) for a in argv]
    build_once(device_arg(argv))
    env = dict(os.environ if env is None else env)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "--max-restarts=0", "-m", module, *argv],
        env=env)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()  # the launcher stops its ranks, then exits
        try:
            proc.wait(timeout=STOP_GRACE_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        return 124
