"""Where the transcript leg's time goes: the port of
``experiments/txpath_probe.py``.

2048 pairs of 10240 letters (lengths 10000, 10% substitutions) at band
100, W 128 (``--quick``: 256 x 2048), local mode, timed on the host
clock to a synchronisation, fresh inputs every run, the median of
``reps`` runs:

* ``h2d``: the host-to-card copy of the two code batches alone;
* ``dp_dirs``: the DP kernel with directions (inputs already on the
  card);
* ``dp_walk``: the DP kernel and the walk enqueued back to back, the
  host waiting only at the end (the JAX script's one jitted dispatch,
  ``dp_walk_fused``);
* ``dp_walk_synced``: the same with the host waiting for the DP before
  it launches the walk (its two calls, ``dp_walk_two_calls``).

    python -m biseqt_tpu_torch.experiments.txpath_probe [--quick] [--B N]
"""

import argparse
import json
import time

import numpy as np
import torch

from ..ops.banded_dp import ModeFlags, on_device, resolve_device
from ..ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from ..ops.walk import traceback_walk
from ..profiling import materialize

__all__ = ["run", "main", "QUICK"]

SUBST = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
QUICK = dict(B=256, L=2048)


def run(B=2048, L=10240, band=100, reps=3, device="cuda"):
    """The four legs; one dict of ``<leg>_ms`` (median) and
    ``<leg>_ms_runs``."""
    device = resolve_device(device)
    W = 128
    flags = ModeFlags(local_start=True, local_end=True)
    kw = dict(W=W, subst=SUBST, go=-2.0, ge=-1.0, flags=flags,
              with_dirs=True, device=device)
    w_eff = torch.full((B,), band, dtype=torch.int32, device=device)
    lens = np.full((B,), L - 240, np.int32)
    dmin = np.full((B,), -(band // 2), np.int32)
    dminq = on_device(parity_adjusted_dmin(
        dmin, np.arange(B, dtype=np.int32) % 2), torch.int32, device)
    small = [on_device(x, torch.int32, device) for x in (lens, lens, dmin)]

    def codes(seed):
        rr = np.random.default_rng(seed * 7_000_003 + 5)
        ss = rr.integers(0, 4, (B, L), dtype=np.int8)
        ts = ss.copy()
        m = rr.random((B, L)) < 0.1
        ts[m] = (ts[m] + rr.integers(1, 4, int(m.sum()))) % 4
        return ss, ts

    def dp(args):
        return banded_dp_ad(*args, *small, w_eff=w_eff, **kw)

    def walk(res):
        return traceback_walk(res.dirs, dminq, res.end_i, res.end_j, W=W,
                              device=device)

    def dp_walk_synced(args):
        return walk(materialize(dp(args)))

    out = {"B": B, "L": L, "band": band}
    seed = [100]

    def timed(label, fn, resident=True):
        runs = []
        materialize(fn([on_device(x, torch.int8, device)
                        for x in codes(99)]))     # warm-up
        for _ in range(reps):
            seed[0] += 1
            host = codes(seed[0])
            args = ([materialize(on_device(x, torch.int8, device))
                     for x in host] if resident else host)
            t0 = time.perf_counter()
            materialize(fn(args))
            runs.append((time.perf_counter() - t0) * 1e3)
        out[label + "_ms"] = float(np.median(runs))
        out[label + "_ms_runs"] = runs

    timed("h2d", lambda host: [on_device(x, torch.int8, device)
                               for x in host], resident=False)
    timed("dp_dirs", lambda args: dp(args).score)
    timed("dp_walk", lambda args: walk(dp(args)))
    timed("dp_walk_synced", dp_walk_synced)
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--B", type=int, default=2048)
    args = ap.parse_args()
    size = dict(QUICK) if args.quick else dict(B=args.B, L=10240)
    print(json.dumps(run(**size)))


if __name__ == "__main__":
    main()
