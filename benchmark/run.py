"""The benchmark of biseqt_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the program (``biseqt_tpu_torch``).  One run of one cell (see
``harness/core.py``): set-up, a closed-loop window of ``--seconds``,
with ``--trace 1`` a profiled stretch after it, then every call's output
held to the plain reference.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit); the numbers compared are also the last
lines of standard error.  Exits 2 without a result where no CUDA card,
or fewer than the cell asks for, is present, or where the run has
loaded JAX or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every cache of the run inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".benchcache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one thread in the host's thread pools: with the default pool (a thread
# a core) the CPU side of a call's tensor work waits on spinning peers,
# and the latency of short calls swings run to run
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

from harness import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = core.benchmark()
    cell = core.cell_of(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        core.log("no CUDA card: the benchmark measures the program on one")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        core.log("the cell asks for %d cards, %d present"
                 % (cell["chips"], torch.cuda.device_count()))
        return 2
    result, checks = core.run_cell(bench, args.workload, args.seed,
                                   args.seconds, bool(args.trace), "cuda",
                                   T_PROCESS)
    bad = core.forbidden_modules()
    if bad:
        core.log("the run loaded JAX or the JAX package: %s" % bad)
        return 2
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    for n, (v, lim) in checks.items():
        core.log("check %s: %r (limit %r)" % (n, v, lim))
    return 0


if __name__ == "__main__":
    sys.exit(main())
