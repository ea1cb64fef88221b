"""Word-Blot band recall harness (the north-star accuracy metric): the
port of ``experiments/wordblot_recall.py``.

Plants homologous segments between two long random sequences at known
(diagonal band, antidiagonal range, match probability), runs
``WordBlot.similar_segments`` over a p_min sweep, and reports
**recall@k** (fraction of planted segments recovered among the top-k
reported segments) plus the p̂ estimation error.  The seed join and
the statistics run on ``device``; planting and assembly on the host.

Usage: python -m biseqt_tpu_torch.experiments.wordblot_recall [--quick]
"""

import argparse
import json

import numpy as np

from ..blot import WordBlot
from ..sequence import Alphabet
from ..stochastics import MutationProcess, rand_seq
from .util import with_dumpfile

A4 = Alphabet("ACGT")


def plant_homologies(rng, seq_len=20000, n_segments=4, seg_len=1000,
                     subst=0.1, gap=0.05):
    """Two random sequences sharing n mutated segments at random offsets.

    Returns (S, T, planted) where planted is a list of
    ``{'d': center diagonal, 'a': (a_lo, a_hi), 'p': planted match prob}``.
    """
    M = MutationProcess(A4, subst_probs=subst, go_prob=gap, ge_prob=gap,
                        rng=rng)
    S = rand_seq(A4, seq_len, rng=rng)
    T = rand_seq(A4, seq_len, rng=rng)
    planted = []
    slot = seq_len // n_segments
    for n in range(n_segments):
        # non-overlapping slots keep planted segments unambiguous
        i0 = n * slot + int(rng.integers(0, slot - seg_len))
        j0 = n * slot + int(rng.integers(0, slot - seg_len))
        core = S[i0:i0 + seg_len]
        mut, tx = M.mutate(core)
        T = T[:j0] + mut + T[j0 + len(mut):]
        matches = sum(1 for op in tx if op == "M")
        planted.append({
            "d": i0 - j0,
            "a": (i0 + j0, i0 + seg_len + j0 + len(mut)),
            "p": matches / len(tx),
        })
    return S, T, planted


def segment_hits(found, planted, radius):
    """Which planted segments does each found segment hit?"""
    hits = []
    for seg in found:
        (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
        hit = None
        for idx, pl in enumerate(planted):
            if not (d_lo - radius <= pl["d"] <= d_hi + radius):
                continue
            lo, hi = max(a_lo, pl["a"][0]), min(a_hi, pl["a"][1])
            if hi - lo >= 0.5 * (pl["a"][1] - pl["a"][0]):
                hit = idx
                break
        hits.append(hit)
    return hits


def index_memory_report(wb):
    """Bytes held by the host index arrays, against a reference-SQLite
    estimate: the "equal index memory" half of the north star.

    Ours: the SeedIndex keeps (d_, a, composite key) int64 arrays
    (24 B/seed); the persistent ``KmerIndex`` sorted triple costs
    3 x int32 = 12 B/k-mer, reported for comparability with the
    reference's persistent k-mer table.  Reference estimate (SQLite):
    ~40 B/seed and ~48 B/k-mer (a SQLite-format estimate, not a
    measurement).
    """
    idx = wb.seed_index
    n = len(idx)
    ours_seed_bytes = (
        idx._d_.nbytes + idx._a.nbytes + idx._comp.nbytes
    )
    n_kmers = len(wb.S) + len(wb.T) - 2 * (wb.wordlen - 1)
    return {
        "n_seeds": n,
        "seed_bytes": int(ours_seed_bytes),
        "seed_bytes_per_seed": round(ours_seed_bytes / max(n, 1), 1),
        "ref_seed_bytes_est": int(40 * n),
        "kmer_triple_bytes": int(12 * n_kmers),
        "ref_kmer_bytes_est": int(48 * n_kmers),
    }


@with_dumpfile
def run_sweep(seq_len=100000, n_segments=4, seg_len=1000, subst=0.1,
              gap=0.05, wordlen=8, K_min=500,
              p_mins=(0.5, 0.6, 0.7, 0.8), n_trials=3, seed=0,
              device="cuda"):
    rng = np.random.default_rng(seed)
    rows = []
    # plant + index ONCE per trial and sweep p_min over the SAME
    # WordBlot objects: p_min only changes the significance filter
    trials = []
    mem = None
    for _ in range(n_trials):
        S, T, planted = plant_homologies(
            rng, seq_len, n_segments, seg_len, subst, gap
        )
        wb = WordBlot(S, T, wordlen=wordlen, g_max=max(2 * gap, 0.1),
                      device=device)
        trials.append((wb, planted))
        mem = index_memory_report(wb)
    rows.append({"index_memory": mem, "seq_len": seq_len})
    for p_min in p_mins:
        recalls, precs, p_errs = [], [], []
        for wb, planted in trials:
            found = sorted(
                wb.similar_segments(K_min=K_min, p_min=p_min),
                key=lambda s: -s["num_seeds"],
            )
            k = n_segments  # recall@k with k = number planted
            hits = segment_hits(found[:k], planted, wb.band_radius(seg_len))
            recovered = set(h for h in hits if h is not None)
            recalls.append(len(recovered) / n_segments)
            precs.append(
                (sum(1 for h in hits if h is not None) / len(hits))
                if hits else 1.0
            )
            for seg, h in zip(found[:k], hits):
                if h is not None:
                    p_errs.append(abs(seg["p"] - planted[h]["p"]))
        rows.append({
            "p_min": p_min,
            "recall_at_k": float(np.mean(recalls)),
            "precision": float(np.mean(precs)),
            "p_hat_mae": float(np.mean(p_errs)) if p_errs else None,
        })
    return rows


QUICK = dict(seq_len=8000, n_segments=3, seg_len=600, n_trials=2,
             K_min=300)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dumpfile", default=None)
    ap.add_argument("--plot", nargs="?", const="wordblot_recall.png",
                    default=None, metavar="PNG",
                    help="render recall/precision/MAE vs p_min (from the "
                         "cached dumpfile when present: no recompute)")
    args = ap.parse_args()
    kw = dict(QUICK) if args.quick else {}
    rows = run_sweep(dumpfile=args.dumpfile, **kw)
    for r in rows:
        print(json.dumps(r))
    if args.plot:
        from .figures import plot_wordblot_recall

        plot_wordblot_recall(rows, args.plot)


if __name__ == "__main__":
    main()
