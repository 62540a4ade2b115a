"""Run one cell of the benchmark of melonix_tpu_torch, once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration and a traffic
mix; the run makes its inputs from the seed, warms the cell's shapes,
measures a closed loop of requests for ``--seconds``, compares a seeded
sample of the answers with the plain reference, and prints one JSON object
as the last line of standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics and the device's busy time with
``--trace 1``.  Without a card it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's own program and benchmark, ahead of anything installed
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core

    return core.main(ROOT, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
