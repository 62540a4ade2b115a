"""Readings that a cell's limits are set from, several seeds in one process.

    python3 benchmark/tools/readings.py --config song_mono44k \
        --traffic edit_render --seeds 1,2,3 --seconds 3 [--control] \
        [--fault anchor_drift ...]

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's
own load, and the comparison of the window's sampled answers with the
plain reference, as a run does; with ``--control`` also the control (the
reference in bfloat16 in the program's place) on the same requests, and
with ``--fault`` the program with that fault planted
(``harness/faults.py``), again on the same requests.  One JSON line a
seed.  The configuration and traffic are found by name, so a
cell can be read before ``BENCHMARK.json`` lists it.  Needs a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", action="append", default=[],
                   help="a fault of harness/faults.py (repeatable)")
    p.add_argument("--sample", type=int, default=None,
                   help="answers compared a seed (default: the traffic's)")
    p.add_argument("--each", action="store_true",
                   help="also print each compared answer's numbers")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import core, faults
    from benchmark.harness.manifest import BENCH_DIR, Manifest, load_json

    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    man = Manifest(ROOT)
    config = load_json(BENCH_DIR / "configs" / f"{args.config}.json")
    traffic = man.traffic(args.traffic)
    kind = man.request_kind(traffic["request"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        w = kind.Workload(config, traffic, seed, dev)
        w.request(1 << 40)
        core.sync(dev)
        sample = core.Reservoir(args.sample or int(traffic["check_sample"]),
                                seed)
        _, reqs = core.window(w, args.seconds, None, sample)
        row = {"seed": seed, "requests": len(reqs),
               "failed": sum(not r.ok for r in reqs),
               "mean_ms": sum(r.ms for r in reqs) / len(reqs),
               "program": dict(w.check(sample.items))}
        if args.each:
            row["each"] = [dict(w.check([kv]), request=kv[0])
                           for kv in sample.items]
        if args.control:
            kept = [(i, w.control_request(i)) for i, _ in sample.items]
            row["control"] = dict(w.check(kept))
        for name in args.fault:
            with faults.planted(name):
                kept = [(i, w.request(i)) for i, _ in sample.items]
            row[name] = dict(w.check(kept))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del w, sample
    return 0


if __name__ == "__main__":
    sys.exit(main())
