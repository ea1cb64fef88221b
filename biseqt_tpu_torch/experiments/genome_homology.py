"""Genome-scale homology mapping (BASELINE config 5, scaled by --size):
the port of ``experiments/genome_homology.py``.

Simulates a pair of related "genomes": genome B is genome A passed
through the mutation channel plus large-scale rearrangements (block
translocations), then Word-Blot (sparse assembly, wordlen 12) discovers
homologous blocks on ``device`` and ``pipeline.extend_segments``
extends every candidate there (the DP and walk kernels on a card, with
``--transcripts``).  Reports block recall and wall-clock per phase.

Usage: python -m biseqt_tpu_torch.experiments.genome_homology
[--size 2000000] [--quick] [--transcripts]
"""

import argparse
import json
import time

import numpy as np
import torch

from ..blot import WordBlot
from ..ops.banded_dp import resolve_device
from ..pipeline import extend_segments
from ..sequence import Alphabet
from ..stochastics import MutationProcess, rand_seq

A4 = Alphabet("ACGT")


def rearranged_pair(rng, size, n_blocks=8, subst=0.08, gap=0.02):
    """Genome A and a mutated, block-shuffled genome B + truth blocks."""
    M = MutationProcess(A4, subst_probs=subst, go_prob=gap, ge_prob=gap,
                        rng=rng)
    A_seq = rand_seq(A4, size, rng=rng)
    block = size // n_blocks
    order = rng.permutation(n_blocks)
    chunks = []
    truth = []  # (a_start_in_A, b_start_in_B, length)
    pos_b = 0
    for b in order:
        a_lo = int(b) * block
        mut, _ = M.mutate(A_seq[a_lo:a_lo + block])
        chunks.append(mut)
        truth.append((a_lo, pos_b, len(mut)))
        pos_b += len(mut)
    B_seq = chunks[0]
    for c in chunks[1:]:
        B_seq = B_seq + c
    return A_seq, B_seq, truth


def block_recall(segments, truth):
    """The share of truth blocks whose diagonal some segment hits."""
    found = 0
    for a_lo, b_lo, blen in truth:
        d = a_lo - b_lo
        found += any(
            s["segment"][0][0] - 64 <= d <= s["segment"][0][1] + 64
            and s["segment"][1][0] < (a_lo + b_lo) + 2 * blen
            and s["segment"][1][1] > (a_lo + b_lo)
            for s in segments
        )
    return found / len(truth)


def run_once(seed, size, n_blocks, wordlen, transcripts=False,
             device="cuda"):
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    A_seq, B_seq, truth = rearranged_pair(rng, size, n_blocks=n_blocks)
    t_sim = time.time() - t0

    t0 = time.time()
    wb = WordBlot(A_seq, B_seq, wordlen=wordlen, g_max=0.1, device=device)
    t_index = time.time() - t0

    K_min = max(size // n_blocks // 8, 200)
    t0 = time.time()
    segs = list(wb.similar_segments(K_min=K_min, p_min=0.6))
    t_discover = time.time() - t0

    t0 = time.time()
    ext = extend_segments(A_seq, B_seq, segs, use_pallas=None,
                          with_transcripts=transcripts, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_extend = time.time() - t0

    cells = sum(s.get("band_cells", 0) for s in ext)
    out = {
        "size": size, "n_blocks": n_blocks,
        "n_segments": len(ext),
        "block_recall": block_recall(ext, truth),
        "seeds": len(wb.seed_index),
        "t_simulate": round(t_sim, 2),
        "t_index": round(t_index, 2),
        "t_discover": round(t_discover, 2),
        "t_extend": round(t_extend, 2),
        "extended_cells": cells,
        "extend_gcups": round(cells / max(t_extend, 1e-9) / 1e9, 2),
    }
    if transcripts:
        txs = [s.get("transcript", "") for s in ext]
        n_ops = sum(len(t) for t in txs)
        n_m = sum(t.count("M") for t in txs)
        out["tx_total_ops"] = n_ops
        out["tx_match_frac"] = round(n_m / max(n_ops, 1), 4)
        # transcript mode may split oversized segments into overlapping
        # a-windows: n_segments counts OUTPUT rows and extended_cells
        # includes the window overlaps; n_discovered is the
        # discovery-level count comparable with score-only runs
        out["n_discovered"] = len(
            {s.get("source_index", i) for i, s in enumerate(ext)}
        )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2_000_000)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--wordlen", type=int, default=12)
    ap.add_argument("--warm", action="store_true",
                    help="run the flow twice on different genome pairs "
                         "and report the second pass as well")
    ap.add_argument("--transcripts", action="store_true",
                    help="extend with MSID transcripts (the walk on the "
                         "device); reports total ops + match fraction")
    ap.add_argument("--dumpfile", default=None,
                    help="cache the run's rows (pickle); a later --plot "
                         "re-renders without re-running the card")
    ap.add_argument("--plot", nargs="?", const="genome_phases.png",
                    default=None, metavar="PNG",
                    help="render per-phase wall-clock bars + GCUPS")
    args = ap.parse_args()
    size = 100_000 if args.quick else args.size
    n_blocks = 4 if args.quick else 8

    from ..utils import with_dumpfile

    @with_dumpfile
    def _runs():
        rows = []
        if args.warm:
            rows.append({"pass": "cold", **run_once(
                1, size, n_blocks, args.wordlen, args.transcripts)})
        res = run_once(2 if args.warm else 1, size, n_blocks,
                       args.wordlen, args.transcripts)
        if args.warm:
            res = {"pass": "warm", **res}
        rows.append(res)
        return rows

    rows = _runs(dumpfile=args.dumpfile)
    for res in rows:
        print(json.dumps(res))
    from ..profiling import report
    print(report())
    if args.plot:
        from .figures import plot_genome_phases

        plot_genome_phases(rows, args.plot)


if __name__ == "__main__":
    main()
