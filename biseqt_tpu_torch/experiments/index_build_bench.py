"""Index build + seed enumeration throughput (BASELINE config 3): the
port of ``experiments/index_build_bench.py``.

1,000 x 10 kbp random reads made on ``device``: builds the sorted k-mer
table (``ops.tables.build_kmer_table``, one stable sort), then runs the
all-vs-all seed statistics (``ops.allvsall_sorted.overlap_stats_sorted``,
the sort-join engine).  Each timed call gets fresh reads, after a
warm-up on other reads, and ends in a wait for the device.

Usage: python -m biseqt_tpu_torch.experiments.index_build_bench
[--reads 1000] [--len 10000]
"""

import argparse
import json
import time
from typing import NamedTuple

import torch

from ..ops.allvsall_sorted import overlap_stats_sorted
from ..ops.banded_dp import resolve_device
from ..ops.tables import build_kmer_table
from ..stochastics import rand_seq_batch


class IndexBuild(NamedTuple):
    """The experiment's JSON row, the timed run's reads and all-vs-all
    statistics (tensors on the device), and its two timed spans in
    seconds, unrounded: the table build and the all-vs-all call."""
    row: dict
    codes: torch.Tensor
    lens: torch.Tensor
    stats: dict
    seconds: tuple


def _wait(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(reads=1000, rlen=10000, wordlen=8, block=64, seed=0,
        device="cuda") -> IndexBuild:
    device = resolve_device(device)
    N, L, w = reads, rlen, wordlen
    gen = torch.Generator(device=device).manual_seed(seed)
    # fresh reads for every timed call, apart from the warm-up's
    codes_w = rand_seq_batch(gen, N, L, device=device)
    codes = rand_seq_batch(gen, N, L, device=device)
    lens = torch.full((N,), L, dtype=torch.int32, device=device)

    # --- k-mer table build (warm once, then time fresh reads) ---
    int(build_kmer_table(codes_w, lens, w, device=device)[3])
    _wait(device)
    t0 = time.perf_counter()
    keys, seqs, poss, n_valid = build_kmer_table(codes, lens, w,
                                                 device=device)
    n = int(n_valid)
    t_build = time.perf_counter() - t0

    # --- full all-vs-all via the sort-join engine ---
    w_join = max(w, 12) if N * L > 2_000_000 else w  # scale-appropriate k
    kw = dict(wordlen=w_join, n_reads=N, bucket=64, device=device)
    overlap_stats_sorted(codes_w, lens, **kw)
    del codes_w
    _wait(device)
    t0 = time.perf_counter()
    stats = overlap_stats_sorted(codes, lens, **kw)
    _wait(device)
    t_all = time.perf_counter() - t0

    row = {
        "reads": N, "read_len": L, "wordlen": w,
        "kmers_indexed": n,
        "t_table_build_s": round(t_build, 4),
        "kmers_per_s": round(n / t_build),
        "join_wordlen": w_join,
        "t_all_vs_all_s": round(t_all, 3),
        "pair_scores_per_s": round(N * N / t_all),
        "backend": device.type,
    }
    return IndexBuild(row, codes, lens, stats, (t_build, t_all))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--len", dest="rlen", type=int, default=10000)
    ap.add_argument("--wordlen", type=int, default=8)
    ap.add_argument("--block", type=int, default=64)
    args = ap.parse_args()
    print(json.dumps(run(args.reads, args.rlen, args.wordlen, args.block).row))


if __name__ == "__main__":
    main()
