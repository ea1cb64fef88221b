"""N-way multiple homology: 10 sequences x ~100 kbp, the port of
``experiments/multiple_homology.py``.

Ten sequences share two planted homologous blocks (low divergence, as in
conserved elements); ``WordBlotMultiple`` sorts the N-way k-mer table on
``device`` and discovers the shared blocks.

Usage: python -m biseqt_tpu_torch.experiments.multiple_homology
[n_seqs] [block_len]
Prints one JSON line with timings + recall.
"""

import json
import sys
import time

import numpy as np

from ..blot import WordBlotMultiple
from ..sequence import Alphabet
from ..stochastics import MutationProcess, rand_seq

A4 = Alphabet("ACGT")


def run(n_seqs=10, blk=20_000, device="cuda"):
    """The experiment's JSON row: ``n_seqs`` sequences, each two mutated
    copies of two ``blk``-letter cores between random flanks."""
    rng = np.random.default_rng(7)
    M = MutationProcess(A4, subst_probs=0.03, go_prob=0.005, ge_prob=0.02,
                        rng=rng)
    core1 = rand_seq(A4, blk, rng=rng)
    core2 = rand_seq(A4, blk, rng=rng)
    seqs = []
    pivot_blocks = []
    for n in range(n_seqs):
        flank = lambda: rand_seq(A4, int(rng.integers(15_000, 25_000)),
                                 rng=rng)
        f1, f2, f3 = flank(), flank(), flank()
        b1, _ = M.mutate(core1)
        b2, _ = M.mutate(core2)
        seqs.append(f1 + b1 + f2 + b2 + f3)
        if n == 0:
            pivot_blocks = [
                (len(f1), len(f1) + len(b1)),
                (len(f1) + len(b1) + len(f2),
                 len(f1) + len(b1) + len(f2) + len(b2)),
            ]
    total = sum(len(s) for s in seqs)

    t0 = time.time()
    wbm = WordBlotMultiple(*seqs, wordlen=12, device=device)
    t_index = time.time() - t0
    n_seeds = len(wbm.seed_index)

    t0 = time.time()
    segs = list(wbm.similar_segments(K_min=5000, p_min=0.75))
    t_disc = time.time() - t0

    # recall: each planted block must be covered by a segment whose pivot
    # range (a / 2 ~ i0 for near-equal positions) overlaps it
    hits = [False, False]
    for seg in segs:
        a_lo, a_hi = seg["segment"][1]
        i_lo, i_hi = a_lo // 2, a_hi // 2
        for bi, (lo, hi) in enumerate(pivot_blocks):
            if i_lo < hi and i_hi > lo:
                hits[bi] = True
    return {
        "n_seqs": n_seqs, "total_bp": total, "n_way_seeds": n_seeds,
        "index_s": round(t_index, 2), "discover_s": round(t_disc, 2),
        "n_segments": len(segs),
        "block_recall": sum(hits) / 2.0,
        "ps": [round(s["p"], 3) for s in segs[:6]],
    }


def main():
    n_seqs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    blk = int(sys.argv[2]) if len(sys.argv) > 2 else 20_000
    print(json.dumps(run(n_seqs, blk)))


if __name__ == "__main__":
    main()
