"""Band-radius model validation (paper figure analog): the port of
``experiments/band_radius_stats.py``.

Simulates mutation-process alignment paths and measures how often their
diagonal drift stays within ``band_radius(K, g, sensitivity)``: the
empirical check of the sqrt(gK) random-walk model that shapes every band
in the framework.  Host work only (numpy and scipy), no device.

Usage: python -m biseqt_tpu_torch.experiments.band_radius_stats
"""

import json

import numpy as np

from ..blot import band_radius
from ..sequence import Alphabet
from ..stochastics import MutationProcess, rand_seq
from .util import with_dumpfile

A4 = Alphabet("ACGT")


@with_dumpfile
def run(Ks=(100, 400, 1600), gs=(0.05, 0.15, 0.3), sensitivity=0.99,
        n_trials=100, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for g in gs:
        M = MutationProcess(A4, subst_probs=0.1, go_prob=g, ge_prob=0.0,
                            rng=rng)
        for K in Ks:
            r = band_radius(K, g, sensitivity)
            inside_end = 0
            inside_sup = 0
            for _ in range(n_trials):
                S = rand_seq(A4, K, rng=rng)
                _, tx = M.mutate(S)
                d = dmax = 0
                for op in tx:
                    d += (op == "D") - (op == "I")
                    dmax = max(dmax, abs(d))
                inside_end += abs(d) <= r
                inside_sup += dmax <= r
            rows.append({
                "K": K, "g": g, "radius": int(r),
                # the model's sensitivity is an ENDPOINT quantile
                # (P(|d_K| <= r)); sup-containment over the whole path
                # is the stricter band-use criterion and runs ~2x the
                # tail by the reflection principle (~1 - 2 eps)
                "containment_endpoint": inside_end / n_trials,
                "containment_sup": inside_sup / n_trials,
                "target_endpoint": sensitivity,
                "target_sup_approx": 1 - 2 * (1 - sensitivity),
            })
    return rows


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dumpfile", default=None)
    ap.add_argument("--plot", nargs="?", const="band_radius.png",
                    default=None, metavar="PNG",
                    help="render the containment figure (from the cached "
                         "dumpfile when present: no recompute)")
    args = ap.parse_args()
    rows = run(dumpfile=args.dumpfile)
    for row in rows:
        print(json.dumps(row))
    if args.plot:
        from .figures import plot_band_radius

        plot_band_radius(rows, args.plot)


if __name__ == "__main__":
    main()
