"""Fixed-reference Word-Blot throughput (many queries against one
reference): the port of ``experiments/fixed_ref_bench.py``.

The reference's k-mer table is sorted ONCE on ``device``, then many
queries stream through host-side serving.  Default config: 100 x 10 kbp
queries against a 5 Mbp reference, each query a mutated copy of a random
reference locus; recall = fraction of queries whose top reported
segment's diagonal band contains the true locus.

Usage: python -m biseqt_tpu_torch.experiments.fixed_ref_bench [--quick]
"""

import argparse
import json
import time

import numpy as np

from ..blot import WordBlotLocalRef
from ..sequence import Alphabet
from ..stochastics import MutationProcess, rand_seq

A4 = Alphabet("ACGT")
# generous d tolerance: band quantization is ~r(K_min)
LOCUS_RADIUS = 200


def make_inputs(rng, ref_len, n_queries, query_len, err):
    ref = rand_seq(A4, ref_len, rng=rng)
    M = MutationProcess(A4, subst_probs=err * 0.6, go_prob=err * 0.2,
                        ge_prob=err * 0.5, rng=rng)
    queries, loci = [], []
    for _ in range(n_queries):
        r0 = int(rng.integers(0, ref_len - query_len))
        mut, _ = M.mutate(ref[r0:r0 + query_len])
        queries.append(mut)
        loci.append(r0)
    return ref, queries, loci


def locus_hits(tops, loci, radius=LOCUS_RADIUS):
    """How many top segments' diagonal bands hold their query's locus
    (the query is S, the reference T: the locus lies on d ~= -r0)."""
    hit = 0
    for top, r0 in zip(tops, loci):
        if top is None:
            continue
        d_lo, d_hi = top["segment"][0]
        if d_lo - radius <= -r0 <= d_hi + radius:
            hit += 1
    return hit


def run(ref_len=5_000_000, n_queries=100, query_len=10_000, err=0.10,
        wordlen=12, K_min=2000, p_min=0.5, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    ref, queries, loci = make_inputs(rng, ref_len, n_queries, query_len,
                                     err)
    t0 = time.time()
    wb = WordBlotLocalRef(ref, wordlen=wordlen, g_max=0.25, device=device)
    t_index = time.time() - t0

    def one(q):
        segs = sorted(
            wb.similar_segments(q, K_min=K_min, p_min=p_min),
            key=lambda s: -s["num_seeds"],
        )
        return segs[0] if segs else None

    # the first query separately: it pays the first calls' warm-up
    t0 = time.time()
    tops = [one(queries[0])]
    t_first = time.time() - t0
    t0 = time.time()
    tops += [one(q) for q in queries[1:]]
    t_query = time.time() - t0

    # batch API: one statistics call on the device for every query
    t0 = time.time()
    batch = wb.similar_segments_batch(queries, K_min=K_min, p_min=p_min)
    t_batch = time.time() - t0
    tops_b = [
        max(segs, key=lambda s: s["num_seeds"]) if segs else None
        for segs in batch
    ]
    if not all(
        (a is None and b is None) or a["segment"] == b["segment"]
        for a, b in zip(tops, tops_b)
    ):
        raise RuntimeError("batch API diverged from the serial API")

    return {
        "ref_len": ref_len, "n_queries": n_queries,
        "query_len": query_len, "err": err, "wordlen": wordlen,
        "index_s": round(t_index, 2),
        "first_query_s": round(t_first, 2),
        "query_total_s": round(t_query, 2),
        "queries_per_s": round(
            (n_queries - 1) / max(t_query, 1e-9), 2),
        "batch_total_s": round(t_batch, 2),
        "batch_queries_per_s": round(n_queries / max(t_batch, 1e-9), 2),
        "locus_recall": locus_hits(tops, loci) / n_queries,
    }


QUICK = dict(ref_len=200_000, n_queries=10, query_len=5_000, wordlen=10,
             K_min=1000)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    kw = dict(QUICK) if args.quick else {}
    print(json.dumps(run(**kw)))


if __name__ == "__main__":
    main()
