"""A test-only target for ``melonix_tpu_torch.parallel.launch`` (run as
``python -m launch_target MODE ...`` with ``tests/`` on ``PYTHONPATH``).

* ``cli ARGS...`` -- the port's CLI (``cli.main(ARGS)``) with ``batch``'s
  file writer wrapped: every ``write_audio`` call is counted, and
  at the end the rank writes ``rank{RANK}.json`` to ``$LAUNCH_AUDIT_DIR``
  with its count, the world size its environment named and whether JAX or
  ``melonix_tpu`` was imported.
* ``fail DIR CODE`` -- every rank writes its pid to ``DIR/pid{RANK}``;
  rank 1 exits CODE once every rank has, the others sleep for two
  minutes.
* ``sleep DIR CODE`` -- every rank writes its pid and sleeps for two
  minutes.

It imports neither JAX nor ``melonix_tpu``.
"""

import json
import os
import sys
import time


def _cli(argv) -> int:
    from melonix_tpu_torch import cli
    from melonix_tpu_torch.io import audio

    writes = []

    def counted(fn):
        def wrapper(*args, **kw):
            writes.append(args[0])
            return fn(*args, **kw)
        return wrapper

    audio.write_audio = counted(audio.write_audio)
    rc = cli.main(argv)
    out = os.path.join(os.environ["LAUNCH_AUDIT_DIR"],
                       f"rank{os.environ['RANK']}.json")
    with open(out, "w") as f:
        json.dump({"rc": rc, "writes": len(writes),
                   "world": int(os.environ["WORLD_SIZE"]),
                   "jax": "jax" in sys.modules,
                   "melonix_tpu": "melonix_tpu" in sys.modules}, f)
    return rc


def _wait(directory: str, fail_rank: int | None, code: int) -> int:
    rank = int(os.environ["RANK"])
    with open(os.path.join(directory, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    if rank == fail_rank:  # once every rank has started
        world = int(os.environ["WORLD_SIZE"])
        end = time.monotonic() + 60
        while time.monotonic() < end and not all(
                os.path.exists(os.path.join(directory, f"pid{r}"))
                for r in range(world)):
            time.sleep(0.05)
        return code
    time.sleep(120)
    return 0


if __name__ == "__main__":
    mode, rest = sys.argv[1], sys.argv[2:]
    if mode == "cli":
        sys.exit(_cli(rest))
    sys.exit(_wait(rest[0], 1 if mode == "fail" else None, int(rest[1])))
