"""All-vs-all overlap detection accuracy (BASELINE config 4): the port of
``experiments/overlap_recall.py``.

Simulates noisy long reads (PacBio-like 10-15% error) tiled over a
genome, runs the all-vs-all overlap statistics on ``device`` (the
blockwise engine on a mesh, or the sort-join engine), and reports
precision/recall of true overlaps plus diagonal estimation error.

Usage: python -m biseqt_tpu_torch.experiments.overlap_recall
[--quick] [--sweep]
"""

import argparse
import json
import time

import numpy as np
import torch

from ..ops.allvsall_sorted import overlap_stats_sorted_chunked
from ..parallel import make_mesh
from ..parallel.allvsall import overlap_matrix_sharded
from ..sequence import Alphabet, pack_sequences
from ..stochastics import MutationProcess, rand_seq
from .util import with_dumpfile

A4 = Alphabet("ACGT")


def simulate_reads(rng, genome_len=20000, read_len=3000, n_reads=24,
                   err=0.12):
    M = MutationProcess(A4, subst_probs=err * 0.6, go_prob=err * 0.2,
                        ge_prob=err * 0.5, rng=rng)
    genome = rand_seq(A4, genome_len, rng=rng)
    reads, starts = [], []
    for _ in range(n_reads):
        start = int(rng.integers(0, genome_len - read_len))
        r, _ = M.mutate(genome[start:start + read_len])
        reads.append(r)
        starts.append(start)
    return reads, starts


def simulate_packed(seed, genome_len, read_len, n_reads, err):
    """:func:`simulate_reads` from ``np.random.default_rng(seed)``,
    packed: ``(codes int8 [n, L], lengths int32 [n], starts)``; a
    top-level function, so a worker process can run it."""
    reads, starts = simulate_reads(np.random.default_rng(seed), genome_len,
                                   read_len, n_reads, err)
    codes, lens = pack_sequences(reads)
    return codes, lens, np.asarray(starts)


def true_overlap(starts, read_len, q, t, min_olap):
    o = read_len - abs(starts[q] - starts[t])
    return o >= min_olap


def ambiguous_overlap(starts, read_len, q, t, min_olap, wordlen):
    """True overlap exists but is below the labeling threshold: detecting
    it is correct behavior, not a false positive; such pairs are
    excluded from precision/recall accounting."""
    o = read_len - abs(starts[q] - starts[t])
    return 2 * wordlen < o < min_olap


def score_overlaps(stats, starts, read_len, wordlen, min_olap, min_score,
                   min_p):
    """The accounting of :func:`run` over numpy ``stats``: every pair
    q < t that :func:`ambiguous_overlap` does not exclude, predicted by
    the thresholds and labelled by :func:`true_overlap`, vectorised (the
    same counts, and the diagonal errors in the same order, as a loop
    over the pairs)."""
    starts = np.asarray(starts)
    n = len(starts)
    o = read_len - np.abs(starts[:, None] - starts[None, :])
    pairs = np.triu(np.ones((n, n), bool), k=1) & ~(
        (2 * wordlen < o) & (o < min_olap))
    pred = ((stats["s0"] >= min_score) & (stats["p"] >= min_p)
            & (stats["olap_len"] >= min_olap // 2))
    truth = o >= min_olap
    tp = pairs & pred & truth
    n_tp = int(tp.sum())
    n_fp = int((pairs & pred & ~truth).sum())
    n_fn = int((pairs & ~pred & truth).sum())
    qq, tt = np.nonzero(tp)
    d_errs = [abs(int(stats["diag"][q, t]) - (int(starts[t])
                                             - int(starts[q])))
              for q, t in zip(qq, tt)]
    return {
        # no predictions => precision is undefined (None), not 0.0:
        # "made no calls" must not read as "every call wrong"
        "precision": n_tp / (n_tp + n_fp) if n_tp + n_fp else None,
        "recall": n_tp / max(n_tp + n_fn, 1),
        "n_predictions": n_tp + n_fp,
        "diag_mae": float(np.mean(d_errs)) if d_errs else None,
    }


@with_dumpfile
def run(genome_len=20000, read_len=3000, n_reads=24, err=0.12,
        wordlen=8, min_olap=500, min_score=60.0, min_p=0.4, seed=0,
        engine="mesh", min_window=5, device="cuda"):
    rng = np.random.default_rng(seed)
    reads, starts = simulate_reads(rng, genome_len, read_len, n_reads, err)
    codes, lens = pack_sequences(reads)
    if engine == "sorted":
        # the at-scale sort-join engine; same stats contract
        stats = overlap_stats_sorted_chunked(
            codes, lens, wordlen=wordlen, n_reads=n_reads,
            min_window=min_window, device=device)
    else:
        stats = overlap_matrix_sharded(codes, lens, wordlen=wordlen,
                                       mesh=make_mesh(device=device),
                                       device=device)
    stats = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v) for k, v in stats.items()}
    return {"n_reads": n_reads, "err": err,
            **score_overlaps(stats, starts, read_len, wordlen, min_olap,
                             min_score, min_p)}


QUICK = dict(genome_len=8000, read_len=1500, n_reads=12)
SWEEP_ERRS = (0.10, 0.12, 0.15)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="BASELINE config-4 error sweep: 10/12/15%% error "
                         "at 1000 reads through the sort-join engine")
    ap.add_argument("--n-reads", type=int, default=1000)
    ap.add_argument("--min-window", type=int, default=5)
    ap.add_argument("--dumpfile", default=None)
    ap.add_argument("--plot", nargs="?", const="overlap_pr.png",
                    default=None, metavar="PNG",
                    help="with --sweep: render precision/recall vs error "
                         "bars (per-rate dumpfiles cache the sweep: pass "
                         "--dumpfile PREFIX to skip recompute)")
    args = ap.parse_args()
    if args.sweep:
        rows = []
        for err in SWEEP_ERRS:
            t0 = time.time()
            dump = ("%s.err%d.pkl" % (args.dumpfile, int(err * 100))
                    if args.dumpfile else None)
            row = run(
                genome_len=100_000, read_len=3000, n_reads=args.n_reads,
                err=err, engine="sorted", min_window=args.min_window,
                seed=int(err * 1000), dumpfile=dump,
            )
            row["elapsed_s"] = round(time.time() - t0, 1)
            row["min_window"] = args.min_window
            rows.append(row)
            print(json.dumps(row))
        if args.plot:
            from .figures import plot_overlap_pr

            plot_overlap_pr(rows, args.plot)
        return
    kw = dict(QUICK) if args.quick else {}
    print(json.dumps(run(dumpfile=args.dumpfile, **kw)))


if __name__ == "__main__":
    main()
