"""The control of a cell's correctness check: the plain reference put in
the program's place, computed in the precision below the configuration's.

    python3 benchmark/control.py --workload tx1t.b2048 --seeds 1 2 3

The configurations state float32 (the DP's scores, exact integers there;
Word-Blot's statistics); the control runs the reference in bfloat16.  For
each seed it makes the cell's inputs as a run does and prints the
control's reading of each number a run compares (the entry's
``control``).  Not part of a benchmark run; its readings set the upper
end of each limit (``PERF.md``).
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

from harness import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = core.benchmark()
    cell = core.cell_of(bench, args.workload)
    config = core.read_json("configs", cell["config"])
    traffic = core.read_json("traffic", cell["traffic"])
    for seed in args.seeds:
        entry = core.load("entries", traffic["entry"]).Entry(
            config, traffic, seed, args.device)
        t0 = time.perf_counter()
        readings = entry.control(args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", "readings": readings,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
