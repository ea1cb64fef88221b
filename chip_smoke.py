"""Smoke run of the PyTorch + CUDA port (biseqt_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's two paths on the card.  The batched path, banded
extension with transcripts (``biseqt_tpu_torch.pipeline.extend_segments(
..., with_transcripts=True, device="cuda")``), runs at the shape of the
JAX package's transcript bench leg: 2048 homologous 10 kbp blocks (10%
substitutions plus short indels that stay within +-50 diagonals, band
100), planted between random spacers of S and T, one Word-Blot-style
segment dict per block, then one narrow launch of 12 segments.  The
pairwise path, ``pw.Aligner(..., backend="pallas_row", device="cuda")``,
aligns a planted 100 kbp DNA pair and a 2,000-residue protein pair.
The experiment probes (``biseqt_tpu_torch.experiments``) run at the
JAX package's probe shapes.  The discovery path,
``pipeline.discover_and_extend(..., with_transcripts=True,
device="cuda")``, runs at the JAX package's genome-homology config with
transcripts: two 5 Mbp genomes, the second the first's 8 blocks mutated
(8% substitutions, gap open and extend 0.02) and shuffled, word length
12, g_max 0.1, K_min 78125, p_min 0.6.  The mapping path runs the
JAX package's ingest, index and fixed-reference configs: a 5 Mbp
reference and 1000 reads of 10 kbp (each a random locus of it through
10% errors) written as FASTA, ingested by ``database.DB.load_fasta``
with a ``kmers.KmerIndex`` subscribed to the reads, the first 100
reads mapped by ``blot.WordBlotLocalRef`` (word length 12, g_max 0.25,
K_min 2000, p_min 0.5) and each extended with a transcript by
``pipeline.extend_segments``.  The N-way path runs
``blot.WordBlotMultiple`` on 10 sequences of ~100 kbp sharing two
20 kbp blocks (word length 12, K_min 5000, p_min 0.75).  The all-vs-all
path runs the sort-join engine (``ops.allvsall_sorted``) on 1000 random
reads of 10 kbp made on the card (``stochastics.rand_seq_batch``), the
JAX package's overlap-recall config (1000 noisy 3 kbp reads of a
100 kbp genome) and ``parallel.all_vs_all_overlaps(method="blockwise")``
on a world-of-one mesh.  The protein path runs
``protein.two_tier_scores`` on 16384 pairs of 2048 residues (10%
homologs): the Dayhoff-6 filter and the BLOSUM62 rescore, one launch
of the DP kernel each.  The experiments users run
(``biseqt_tpu_torch.experiments``) run at their scripts' default
configs, among them genome homology on 2 x 2 Mbp with transcripts.

Phases, each of which exits non-zero on failure:

1. builds the five CUDA kernels (``csrc/*.cu``, nvcc, sm_90a, one
   process each, all at once) and the C++ host tier from the
   checkout;
2. runs the main path with the kernels' launch counters set to 0, and
   requires every kernel to have been launched once per launch of the
   pipeline's plan;
3. rescores every transcript with affine gaps in numpy (exactly its
   score) and requires transcripts to cover most of each block;
4. on one full launch of the main path, holds the DP kernel (scores, end
   cells, the dirs plane on its live slots) and the walk kernel (trace
   bytes, cursors) to their plain PyTorch twins on the same CUDA
   tensors, exactly, and the transcripts to the C++ host walker's over
   the same plane;
5. times each kernel with CUDA events, and its plain twin (its loop of
   small steps replayed from CUDA graphs) on the host clock, at that
   launch's shape, and the replay guard of ``extend_segments`` (the
   trace's moves against the end cells, on the card) as called and
   replayed from a CUDA graph; times K1 on that launch's inputs tiled
   or sliced to 44-1024 plane rows (its time against the rows in
   flight), and counts the SASS instructions of K1's step loop (the
   main path's instance, by ``cuobjdump -sass``);
6. runs the pairwise path, counting the row kernel's launches: the
   100 kbp DNA pair (10% substitutions, short indels within +-50
   diagonals, band (-250, 250)) as B_GLOBAL, B_LOCAL and B_OVERLAP, and
   the protein pair under BLOSUM62 as B_LOCAL.  Each solve and
   traceback must launch the row kernel, give the C++ ``native``
   engine's score and the antidiagonal kernel's (``backend="pallas"``)
   exactly, and return a transcript that rescores to it.  Then, on the
   Aligner's own inputs with directions, the row kernel must equal its
   plain twin exactly (score, end cell, the whole plane) for the protein
   pair and for the DNA pair's first 10 kbp as B_LOCAL (W 512, the
   planner's block per pair); and the DNA pair's time is split into
   kernel (with its microseconds a row), copy and host walk;
7. holds the row kernel to its plain twin at the JAX package's
   score-bench shape (4096 pairs of 10 kbp, band 100, local; the
   planner's warp per pair): score-only on the whole batch, with
   directions on 512 pairs (scores, end cells, the whole plane),
   exactly, and times both;
8. runs the two probes' entry points with their launch counters set to
   0: the transpose probe (PyTorch's transpose of the u8 plane
   [1288, 512, 128], the same through int32, the kernel on the
   [256, 128, 128] sub-plane and on the whole plane) and the int16
   probe (all ten ops at [256, 128] on the probe's input, and at
   [65536, 128] and [1048576, 128] on random int16), every kernel
   result equal to its plain version, and prints each op's kernel,
   plain and bound milliseconds and share of the bound at each row
   count; then holds the transpose kernel to its plain version on
   phase 4's dirs plane, exactly, and times both;
9. runs the batched path on bands wider than 2048 lanes, counted: a
   segment whose band buckets to W 3072 on two random 1.2 kbp
   sequences, on the card and on the CPU (the plain twins), which must
   agree exactly and score 13.0; then holds the DP kernel to its plain
   twin at W 3072 (that launch's inputs) and W 4096 (a batch of 1.5 kbp
   pairs whose bands span every lane), exactly, and times both;
10. runs the discovery path on the genome pair with the DP and walk
   kernels' launch counters set to 0, and requires each to have been
   launched once per launch of the plan; holds Word-Blot on the card to
   Word-Blot on the CPU (seed arrays, segments, their seed counts and
   order exactly; p-hat, S0 and S1 within rtol 1e-5, atol 1e-6);
   rescores every transcript (exactly its score, its cells inside both
   genomes); requires block recall 1.0; prints the seconds of the seed
   build, discovery, extension and the whole call; on the plan's launch
   of the fewest antidiagonals holds the DP kernel (scores, end cells,
   the dirs plane on its live slots) and the walk kernel (trace bytes,
   cursors) to their plain twins on the card, exactly, and times the
   twins; times both kernels on every launch of the plan beside
   their bounds; and runs ``extend_segments`` on the card's segments
   with ``pipeline.PIPELINE_BYTES`` at 0 (the serial order) and at its
   default (launches in flight), each output equal to the call's, and
   prints both walls and the allocator peak;
11. runs the mapping path: writes the reference and the reads as
   FASTA, ingests the reference, then the reads with the index
   subscribed, and requires the DB to give back every letter; builds
   the read index on the card and holds it to the same build on the
   CPU (keys, sequence ids, positions exactly) and a few k-mers' hits
   to a numpy scan; maps the 100 queries serially and in one batch on
   the card and in one batch on the CPU, requiring batch = serial and
   card = CPU (segments and seed counts exactly, p-hat, S0 and S1
   within rtol 1e-5, atol 1e-6) and locus recall 1.0; extends each
   query's top segment with a transcript with the DP and walk kernels'
   launch counters set to 0, requiring one launch of each per launch
   of the plans, every transcript rescoring exactly to its score; holds
   both kernels to their plain twins on the first query's launch,
   exactly; extends the same segments again with the walk on the host
   (``device_walk=False``: the DP kernel launched once per launch, the
   walk kernel never), requiring transcripts and start cells equal to
   the device walk's; maps 8 reads of 5 kbp to a 60 kbp reference at
   DNA word length 16 (int64 k-mer keys) on the card and on the CPU,
   requiring the same table and segments and locus recall 1.0; and
   times ingest, the index, the queries (the share of the statistics on
   the card), the extension both ways and each launch of both kernels;
   and runs the 100 extensions with ``PIPELINE_BYTES`` at 0 and at its
   default as phase 10 does;
12. runs the N-way path on the card and on the CPU, requiring the
   same seed tuples, the same segments (p-hat, S0 and S1 within rtol
   1e-5, atol 1e-6) and block recall 1.0, and times the seed build and
   discovery;
13. runs the all-vs-all path: ``experiments.index_build_bench.run`` at
   its defaults (the k-mer table of 1000 x 10 kbp reads at word length
   8, then ``overlap_stats_sorted`` at word length 12, bucket 64,
   max_run auto, 8: each timed warm on the host clock; pair-scores/s,
   composites, peak memory), requiring the chunked run (max_chunk 256) to equal it
   exactly, the first 256 reads to give the CPU's result (window, diag,
   olap_len exactly; p and s0 within rtol 1e-5, atol 1e-6) and
   ``all_vs_all_overlaps(method="sorted")`` to return exactly the pairs
   the thresholds give on those stats; then the recall config (reads
   simulated by ``experiments.overlap_recall.simulate_packed`` in a
   worker process while phases 1-12 run; word length 8, min_score 60,
   min_p 0.4, min_olap 500) through ``overlap_stats_sorted_chunked``
   and ``overlap_recall.score_overlaps``, requiring the JAX
   package's precision and recall from its CPU run (``RECALL_JAX_CPU``)
   and the pairs check again; then the blockwise engine on 24 reads of
   3 kbp, requiring the card to equal the CPU;
14. runs the protein path with the DP kernel's launch counter set to 0,
   requiring one launch a tier, the rescore's scores equal to a
   full-only BLOSUM62 run exactly and homolog recall 1.0; holds the
   DP kernel to its plain twin on 256 pairs at A 6 and A 20 (scores
   exactly) and the call on 64 pairs to the CPU (every shared field
   exactly); and times the filter, the rescore and the full-only run by
   CUDA events beside the kernel's bound at this shape;
15. runs the ported experiments (``biseqt_tpu_torch.experiments``) at
   their scripts' default configs: ``band_radius_stats.run`` (host
   only, in a worker process while phases 1-12 run),
   ``wordblot_recall.run_sweep``, ``multiple_homology.run``,
   ``index_build_bench.run`` (run in phase 13) and
   ``genome_homology.run_once(1, 2_000_000, 8, 12, transcripts=True)``
   with the DP and walk kernels counted, each held to the JAX package's
   CPU run of the same config (every untimed field; p-hat's mean error
   within rtol 1e-5, atol 1e-6; the genome's transcript ops within rtol
   1e-4 and match fraction within 1e-3, ``GENOME_TX_TOL``), and prints
   one line each with the card;
16. runs the band-sharded engines and the checkpointed sweep on a
   world-of-one mesh (``sharded_phase``);
17. runs the row route, ``use_pallas=False`` (the row engine over the
   whole band on the card, its rows replayed from CUDA graphs, its plane
   walked on the host by ``native.traceback_batch``) with the DP and
   walk kernels' launch counters unmoved: phase 2's batch (every
   transcript rescored and covering 90% of its block, every score equal
   to phase 2's, the transcripts that differ counted; the narrow
   segments equal to the CPU's row route byte for byte), the
   band-filling segment (600.0, against 9.0 on the kernels' route) and
   ``discover_and_extend`` on a rearranged 100 kbp pair, equal to the
   JAX package's row route on the CPU exactly (``ROW_ROUTE_JAX_CPU``),
   beside the kernels' route on the same input;
18. runs bands above 4096 lanes, where a plane row of K1 and a pair of
   K4 is a thread-block cluster (``wide_phase``, ``WIDE_WS``): both
   kernels against their twins at W 6144-65536 byte for byte, timed
   beside their bounds; ``extend_segments`` on a segment of 7001
   diagonals (W 8192) with its launches counted, no twin reached, every
   transcript rescored and every score equal to the row route's; the
   Aligner on phase 6's pair with a 12001-diagonal band on K1, K4 and
   the C++ engine, the three scores equal;
19. runs the four path probes (``pipeline_tx_probe``, ``walk_probe``,
   ``adkernel_probe``, ``txpath_probe``) at the JAX scripts' default
   sizes, each printing its JSON line, and requires the walks to agree,
   no transcript mismatch and K1 and K4 scores equal.

Prints a kernels JSON line (per kernel: launches on its path, kernel,
plain and library milliseconds, and the bound: the least time the card
could take for the same work, from this run's bytes and operations;
for the DP and walk kernels also their launches on each path, their
times and bounds at the discovery path's largest launch, and the
twins' time and error on the launch held to them; for the DP kernel
also the protein path's times and bound and the in-flight queue's
walls and peaks; for both DP kernels a ``wide`` record per W of phase
18: cluster size, kernel and plain milliseconds, the twin's error, the
bound and the kernel's share of it),
then the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Fails (exit code not 0, no result)
without a CUDA card or outside the repository.
"""

import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_BLOCKS = 2048
BLOCK = 10_000
BAND = 100
NARROW = 12
GO, GE = -3.0, -1.0
PAIR_LEN = 100_000        # the pairwise path's DNA pair
PAIR_BAND = (-250, 250)
PROTEIN_LEN = 2000
TWIN_PREFIX = 10_000      # rows of the DNA pair held to the row twin
SCORE_BENCH = dict(B=4096, L=10240, n=10000, band=100, W=128)
I16_ROWS = 65536          # the int16 probe's ops where bytes bound them
I16_ROW_COUNTS = (256, I16_ROWS, 1 << 20)    # phase 8's int16 shapes
ROWS_IN_FLIGHT = (44, 128, 256, 512, 1024)   # K1's plane rows, phase 5

# Operations per unit of work, counted from each kernel's source at the
# smoke's settings, for the compute side of its bound.
# dp_ad.cu:144-208, local mode with directions: per band cell 6 float
# adds (H + go, the E and F reads with their wrap, diag, the lane mask,
# the tracker drift), 6 maxes (E, F, H twice, the local floor, the
# tracker) and 7 compares (two gap flags, two source tests, the local
# stop's two, the tracker).
DP_AD_OPS_PER_CELL = 19
# dp_row.cu:318-399, score-only, local: per band cell 5 float adds
# (diag, H + go, F + ge, the scan term, E) and 7 maxes (F, H before E,
# the local floor, the running max, P, H, the tracker).  The shuffles
# of the block scan are not counted: a bound of the recurrence alone.
DP_ROW_OPS_PER_CELL = 12
# walk.cu:174-202: ~50 integer instructions per action (bounds and
# parity tests, the nibble's address and shift, the fused step, the
# trace bit), as one step of the plain walk; the kernel's diagonal runs
# (walk.cu:130-173) do fewer per action.
WALK_OPS_PER_STEP = 50
WIDE_LEN = 1200               # phase 9: the W 3072 segment's sequences
WIDE_SEGMENT = ((-1100, 1100), (1200, 1300))
WIDE_SCORE = 13.0             # its score, as the JAX package gives it
WIDE_4096 = dict(B=8, L=1500)
# phase 10: the genome-homology config with transcripts (BASELINE.md
# config 5t, experiments/genome_homology.py --size 5000000 --transcripts):
# two 5 Mbp genomes, B the 8 blocks of A mutated and shuffled
GENOME = dict(size=5_000_000, blocks=8, sub=0.08, gap=0.02)
GENOME_SEED = 20261018
DISCOVERY = dict(wordlen=12, g_max=0.1, p_min=0.6,
                 K_min=GENOME["size"] // GENOME["blocks"] // 8)
DISCOVERY_TOL = dict(rtol=1e-5, atol=1e-6)   # p-hat, S0, S1: card vs CPU
# phase 11: reads mapped to a reference (BASELINE.md configs 6, 3 and 2f:
# experiments/ingest_bench.py, index_build_bench.py, fixed_ref_bench.py):
# every read a random locus through 10% errors (substitutions 0.06, gap
# open 0.02, gap extend 0.05), the first `queries` of them mapped
MAPPING = dict(ref=5_000_000, reads=1000, read_len=10_000, queries=100,
               sub=0.06, go=0.02, ge=0.05, index_wordlen=8)
MAPPING_SEED = 20261019
# phase 11's wide word: reads mapped to a reference shorter than
# WordBlotLocalRef.WIDE_MAX_REF at a word too wide for int32 keys
WIDE_MAPPING = dict(ref=60_000, reads=8, read_len=5000, wordlen=16)
MAPPER = dict(wordlen=12, g_max=0.25)
MAPPING_QUERY = dict(K_min=2000, p_min=0.5)
LOCUS_RADIUS = 200        # fixed_ref_bench.py's diagonal tolerance
# phase 12: N-way homology (BASELINE.md config 1b,
# experiments/multiple_homology.py): n sequences, each two mutated
# blocks between random flanks
NWAY = dict(n=10, block=20_000, flank=(15_000, 25_000), sub=0.03, go=0.005,
            ge=0.02)
NWAY_SEED = 7
NWAY_QUERY = dict(K_min=5000, p_min=0.75)
# phase 13: all-vs-all read overlaps (BASELINE.md config 4).  (a)
# experiments/index_build_bench.py's defaults: 1000 random reads of
# 10 kbp, joined at word length 12, bucket 64; (b) experiments/
# overlap_recall.py --sweep at its middle rate; (c) overlap_recall.run's
# default size through the blockwise engine on a mesh
OVERLAP = dict(reads=1000, read_len=10_000, wordlen=12, bucket=64,
               chunk=256, cpu_reads=256)
OVERLAP_SEED = 20261020
RECALL = dict(genome_len=100_000, read_len=3000, n_reads=1000, err=0.12,
              seed=120)
RECALL_SCORING = dict(wordlen=8, min_olap=500, min_score=60.0, min_p=0.4,
                      min_window=5)
# overlap_recall.run(genome_len=100_000, read_len=3000, n_reads=1000,
# err=0.12, engine="sorted", seed=120) of the JAX package on the CPU
# (PERF.md section 5); the card must give the same precision and recall
RECALL_JAX_CPU = dict(precision=0.9996057093289172,
                      recall=0.9999605569360628, n_predictions=25362,
                      diag_mae=39.88896339539287)
BLOCKWISE = dict(genome_len=20_000, read_len=3000, n_reads=24, err=0.12,
                 seed=0)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)        # p and s0: card vs CPU
# phase 14: two-tier protein search (BASELINE.md config 7p,
# experiments/protein_search.py at full size)
PROTEIN = dict(B=16384, L=2048, band=100, W=128, go=-11.0, ge=-1.0,
               seed=11, hom_frac=0.1, sub_rate=0.25, margin=5.0,
               twin_pairs=256, cpu_pairs=64)
# phase 15: the experiments at their scripts' default configs, held to
# the JAX package's CPU runs of the same configs (every untimed field;
# p-hat's mean error within DISCOVERY_TOL), which meet BASELINE.md's
# thresholds: Word-Blot recall@k 1.0 at p_min <= 0.7 and precision 1.0
# (config 2), N-way block recall 1.0 (1b), genome block recall 1.0 and
# match fraction 0.90 (5t).  experiments/band_radius_stats.py run():
# (K, g, radius, containment at the end, containment over the path)
BAND_RADIUS_JAX_CPU = [
    (100, 0.05, 6, 1.0, 1.0), (400, 0.05, 12, 1.0, 1.0),
    (1600, 0.05, 24, 0.99, 0.98), (100, 0.15, 10, 1.0, 1.0),
    (400, 0.15, 20, 0.97, 0.97), (1600, 0.15, 40, 0.99, 0.99),
    (100, 0.3, 15, 1.0, 0.99), (400, 0.3, 29, 1.0, 0.97),
    (1600, 0.3, 57, 0.99, 0.98)]
# experiments/wordblot_recall.py run_sweep(): the index report, and
# (p_min, recall@k, precision, p-hat MAE) per threshold
WORDBLOT_JAX_CPU = dict(
    index_memory={"n_seeds": 153853, "seed_bytes": 3692472,
                  "seed_bytes_per_seed": 24.0,
                  "ref_seed_bytes_est": 6154120,
                  "kmer_triple_bytes": 2399832,
                  "ref_kmer_bytes_est": 9599328},
    sweep=[(0.5, 1.0, 1.0, 0.115026700434031),
           (0.6, 1.0, 1.0, 0.08550716731641879),
           (0.7, 1.0, 1.0, 0.0747694104283471),
           (0.8, 0.8333333333333334, 1.0, 0.0360975387053694)])
# experiments/multiple_homology.py (10 sequences, 20 kbp blocks)
NWAY_JAX_CPU = dict(n_seqs=10, total_bp=1001436, n_way_seeds=936,
                    n_segments=2, block_recall=1.0, ps=[0.963, 0.963])
# experiments/genome_homology.py run_once(1, 2_000_000, 8, 12,
# transcripts=True), the script's default size
GENOME_RUN = dict(seed=1, size=2_000_000, n_blocks=8, wordlen=12)
GENOME_JAX_CPU = dict(size=2000000, n_blocks=8, n_segments=7,
                      block_recall=1.0, seeds=828996,
                      extended_cells=1406360160, tx_total_ops=2018609,
                      tx_match_frac=0.9016, n_discovered=7)
# The transcripts' totals are held within a tolerance, the rest exactly.
# On the CPU the JAX package extends with its row DP over the whole band
# and walks the row plane on the host; the port follows its TPU route
# (the antidiagonal DP on at most W - 1 diagonals, walked on the device),
# and the two routes may pick different alignments among equal-scoring
# ones: 5 ops of 2,018,609 on this config (tests/test_torch_experiments.py
# holds the port to the JAX script exactly at 20 kbp).  genome_row_route()
# runs this config on both routes on the card: the row route gives the
# JAX package's CPU run exactly, and one of the 7 transcripts differs.
GENOME_TX_TOL = dict(tx_total_ops=1e-4, tx_match_frac=1e-3)  # rel., abs.
# phase 16: the band-sharded engines on a world-of-one mesh.  (a) phase
# 6's 100 kbp pair, its band (-250, 250) laid out as the Aligner lays it
# out for the antidiagonal kernel (W 512, the top 501 diagonals); (b) a
# planted 20 kbp pair in a band of W 8192 (above the kernels' 4096); (c)
# the checkpointed sweep over phase 13's recall reads
SHARDED = dict(halo=64, ckpt_chunks=8, wide_len=20_000, wide_band=4095,
               wide_seed=20261021, sweep_wordlen=8, sweep_block=64,
               sweep_stop=8)
# dp_ad.cu:222-297, score-only, local: per band cell 6 float adds (H +
# go, the E and F wrap masks, diag, the lane mask, the tracker drift), 6
# maxes (E, F, H twice, the local floor, the tracker) and the 2 gap-flag
# compares; the source tests, the local stop and the tracker's compare
# run only with directions.
DP_AD_SCORE_OPS_PER_CELL = 14
# phase 17: the row route, extend_segments(use_pallas=False).  (b) a
# random 600 bp sequence against itself, its segment's padded band the
# 128 diagonals 0-127 (W 128), the identity on the lowest: the row route
# keeps that diagonal, K1's route (w_eff at most W - 1) does not
BAND_FILL = dict(seed=5, length=600, segment=((16, 111), (200, 1000)),
                 row_score=600.0, k1_score=9.0)
# (c) discover_and_extend(use_pallas=False) on a rearranged pair
# (rearranged_pair at GENOME's rates, 100 kbp in 4 blocks), held to the
# JAX package's discover_and_extend(use_pallas=False, with_transcripts=
# True) on the CPU on the same codes: the rows' count, scores (in the
# output's order), transcript ops, and the SHA-1 of every row's
# "<transcript> <origin_start> <mutate_start>\n" in that order
ROW_ROUTE = dict(size=100_000, blocks=4, seed=20261022, wordlen=12,
                 g_max=0.1, p_min=0.6)
ROW_ROUTE_JAX_CPU = dict(
    n_segments=4, scores=[19040.0, 19031.0, 18834.0, 18715.0],
    tx_total_ops=100861, sha1="857048dce96f95bf35f3bcfd884f4d1c4b7f2e57")
# phase 18: bands above 4096 lanes, each plane row of K1 and each pair
# of K4 a thread-block cluster.  (i) Both kernels against their twins at
# every W of the bucket grid from 6144, and at the two past the portable
# cluster size: K1 on three pairs of 10 kbp, one whose T is long enough
# that its band spans every lane and two aligned along the lanes where
# the cluster's blocks meet, in the main path's local mode with and
# without directions, and in the run-time global mode on their first
# 2 kbp; K4 on three pairs of 2000 rows laid out the same way, local,
# with and without directions.  (ii) extend_segments on two 200 kbp
# sequences whose 30 kbp homologous block (5% substitutions) carries a
# 7 kbp insertion in T: its segment spans 7001 diagonals (W 8192).
# (iii) Phase 6's pair through the Aligner with a 12001-diagonal band
# (W 12288) on both kernels and the C++ engine.
WIDE_WS = (6144, 8192, 12288, 16384, 24576, 32768, 49152, 65536)
WIDE_K1 = dict(length=10_000, flag_len=2000)
WIDE_K4_ROWS = 2000
WIDE_EXTENSION = dict(size=200_000, block_at=(60_000, 50_000),
                      block=30_000, insertion=7000, sub=0.05,
                      seed=20261023)
WIDE_ALIGNER_BAND = (-6000, 6000)


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def plant(np, rng, alphabet, Sequence):
    """S and T with N_BLOCKS homologous blocks between random spacers,
    and one segment dict per block from the planted coordinates."""
    s_parts, t_parts, segments = [], [], []
    s_pos = t_pos = 0
    half = BAND // 2
    for _ in range(N_BLOCKS):
        gap_s, gap_t = rng.integers(200, 1200, 2)
        core = rng.integers(0, 4, BLOCK).astype(np.int8)
        mut = core.copy()
        hit = rng.random(BLOCK) < 0.10
        mut[hit] = (mut[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        # six short indels: the diagonal drifts by at most 30 < BAND / 2
        pieces, last = [], 0
        for p in np.sort(rng.choice(np.arange(500, BLOCK - 500), 6,
                                    replace=False)):
            n = int(rng.integers(1, 6))
            pieces.append(mut[last:p])
            if rng.random() < 0.5:            # insertion into T
                pieces.append(rng.integers(0, 4, n).astype(np.int8))
                last = p
            else:                             # deletion from T
                last = p + n
        pieces.append(mut[last:])
        mut = np.concatenate(pieces)
        i0, j0 = s_pos + int(gap_s), t_pos + int(gap_t)
        d0 = i0 - j0
        a_lo = i0 + j0
        a_hi = (i0 + BLOCK) + (j0 + len(mut))
        segments.append({"segment": ((d0 - half, d0 + half), (a_lo, a_hi)),
                         "block": (i0, j0, BLOCK, len(mut))})
        s_parts += [rng.integers(0, 4, int(gap_s)).astype(np.int8), core]
        t_parts += [rng.integers(0, 4, int(gap_t)).astype(np.int8), mut]
        s_pos, t_pos = i0 + BLOCK, j0 + len(mut)
    S = Sequence(alphabet, np.concatenate(s_parts))
    T = Sequence(alphabet, np.concatenate(t_parts))
    return S, T, segments


def mutate(np, rng, core, alphabet_size, sub_rate, n_indels, margin):
    """``core`` with ``sub_rate`` substitutions and ``n_indels`` short
    indels (1-5 letters), the diagonal drift kept within 40."""
    mut = core.copy()
    hit = rng.random(len(core)) < sub_rate
    mut[hit] = (mut[hit] + rng.integers(1, alphabet_size, int(hit.sum()))
                ) % alphabet_size
    pieces, last, drift = [], 0, 0
    for p in np.sort(rng.choice(np.arange(margin, len(core) - margin),
                                n_indels, replace=False)):
        n = int(rng.integers(1, 6))
        pieces.append(mut[last:p])
        if drift <= 0:                    # insertion into T
            pieces.append(rng.integers(0, alphabet_size, n).astype(np.int8))
            last, drift = p, drift + n
        else:                             # deletion from T
            last, drift = p + n, drift - n
    pieces.append(mut[last:])
    return np.concatenate(pieces)


def channel(np, rng, core, sub, go, ge):
    """``core`` through the JAX package's mutation process
    (``stochastics.MutationProcess(subst_probs=sub, go_prob=go,
    ge_prob=ge).mutate``) in distribution, vectorized: before each origin
    letter it visits, the process opens insertion runs (each with
    probability go / 2, extended with probability ge), then deletes the
    letter and opens a deletion run (go / 2) or copies it through the
    substitution channel (1 - go; a uniform other letter with
    probability sub).  A deletion run's later letters are not visited."""
    L = len(core)
    # insertion runs before each visit, and their letters
    runs = rng.geometric(1 - go / 2, L) - 1
    run_lens = rng.geometric(1 - ge, int(runs.sum()))
    ins = np.zeros(L, np.int64)
    np.add.at(ins, np.repeat(np.arange(L), runs), run_lens)
    # the visit's own outcome: a deletion run's start, or a copy
    dele = rng.random(L) < (go / 2) / (1 - go / 2)
    del_lens = rng.geometric(1 - ge, L)
    visited = np.ones(L, bool)
    covered_to = 0
    for i in np.flatnonzero(dele):
        if i < covered_to:            # inside an earlier deletion run
            dele[i] = False
            continue
        covered_to = i + del_lens[i]
        visited[i + 1:covered_to] = False
        dele[i + 1:covered_to] = False
    ins = np.where(visited, ins, 0)
    copy = visited & ~dele
    letters = core.copy()
    hit = rng.random(L) < sub
    letters[hit] = (letters[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    width = ins + copy
    out = rng.integers(0, 4, int(width.sum())).astype(np.int8)
    out[(np.cumsum(width) - width + ins)[copy]] = letters[copy]
    return out


def rearranged_pair(np, rng, size, n_blocks, sub, gap):
    """Genome A and genome B, A's ``n_blocks`` blocks mutated by
    :func:`channel` and shuffled, with the truth blocks ``(start in A,
    start in B, length in B)``: ``experiments/genome_homology.py``'s
    ``rearranged_pair``."""
    A = rng.integers(0, 4, size).astype(np.int8)
    block = size // n_blocks
    chunks, truth, pos_b = [], [], 0
    for b in rng.permutation(n_blocks):
        a_lo = int(b) * block
        mut = channel(np, rng, A[a_lo:a_lo + block], sub, gap, gap)
        chunks.append(mut)
        truth.append((a_lo, pos_b, len(mut)))
        pos_b += len(mut)
    return A, np.concatenate(chunks), truth


def rescore(np, ops, s, t, si, sj, subst):
    """Affine-gap score of an MSID transcript starting at (si, sj), and
    whether its M / S letters agree with the characters."""
    if not ops:
        return 0.0, True
    o = np.frombuffer(ops.encode(), np.uint8)
    diag = (o == ord("M")) | (o == ord("S"))
    ins, dele = o == ord("I"), o == ord("D")
    adv_i = (diag | dele).astype(np.int64)
    adv_j = (diag | ins).astype(np.int64)
    i = si + np.cumsum(adv_i) - adv_i
    j = sj + np.cumsum(adv_j) - adv_j
    cs, ct = s[i[diag]], t[j[diag]]
    letters_ok = bool(np.all((cs == ct) == (o[diag] == ord("M"))))
    prev = np.concatenate([np.zeros(1, np.uint8), o[:-1]])
    opens = ((ins & (prev != ord("I"))).sum()
             + (dele & (prev != ord("D"))).sum())
    score = (subst[cs, ct].astype(np.float64).sum()
             + GE * (ins.sum() + dele.sum()) + GO * opens)
    return float(score), letters_ok


def nbytes(*tensors):
    """Bytes of the given tensors and numpy arrays together."""
    return sum(x.numel() * x.element_size() if hasattr(x, "element_size")
               else x.nbytes for x in tensors)


def genome_phase(dev, card, subst):
    """Phase 10: ``discover_and_extend`` at the genome-homology config,
    counted, with the card's discovery held to the CPU's, every
    transcript rescored, block recall 1.0, and K1 and the walk timed at
    the path's largest launch.  Returns the launches and the kernels'
    times and bounds at that launch."""
    import numpy as np
    import torch

    from biseqt_tpu_torch import pipeline, profiling
    from biseqt_tpu_torch.blot import WordBlot
    from biseqt_tpu_torch.experiments.genome_homology import block_recall
    from biseqt_tpu_torch.ops import dp_ad, walk
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    A4 = Alphabet("ACGT")
    flags = ModeFlags(local_start=True, local_end=True)
    gr = np.random.default_rng(GENOME_SEED)
    t0 = time.perf_counter()
    a_codes, b_codes, truth = rearranged_pair(
        np, gr, GENOME["size"], GENOME["blocks"], GENOME["sub"],
        GENOME["gap"])
    Sg, Tg = Sequence(A4, a_codes), Sequence(A4, b_codes)
    print("genome pair: |A| = %d, |B| = %d, %d blocks shuffled, %.0f%%"
          " substitutions, gap open and extend %.2f (%.1f s)"
          % (len(Sg), len(Tg), GENOME["blocks"], 100 * GENOME["sub"],
             GENOME["gap"], time.perf_counter() - t0))
    # warm-up: the discovery path's first PyTorch operations on the card
    pipeline.discover_and_extend(Sg[:50_000], Sg[:50_000], wordlen=12,
                                 K_min=5000, with_transcripts=True,
                                 device=dev)
    torch.cuda.synchronize()
    phases = ("seeds.build", "blot.discover", "pipeline.extend")
    before = profiling.counters()
    dp_ad.LAUNCHES = 0
    walk.LAUNCHES = 0
    t0 = time.perf_counter()
    found = pipeline.discover_and_extend(Sg, Tg, with_transcripts=True,
                                         device=dev, **DISCOVERY)
    whole_s = time.perf_counter() - t0
    disc_counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    after = profiling.counters()
    secs = {name: after[name]["seconds"]
            - before.get(name, {}).get("seconds", 0.0) for name in phases}
    if not all(disc_counts.values()):
        fail("discover_and_extend did not launch both kernels: %s"
             % disc_counts)

    # the card's discovery against the CPU's, both the port's
    wkw = dict(wordlen=DISCOVERY["wordlen"], g_max=DISCOVERY["g_max"])
    skw = dict(K_min=DISCOVERY["K_min"], p_min=DISCOVERY["p_min"])
    wb_card = WordBlot(Sg, Tg, device=dev, **wkw)
    segs_card = list(wb_card.similar_segments(**skw))
    t0 = time.perf_counter()
    wb_cpu = WordBlot(Sg, Tg, device="cpu", **wkw)
    segs_cpu = list(wb_cpu.similar_segments(**skw))
    cpu_s = time.perf_counter() - t0
    if not all(np.array_equal(g, w) for g, w in zip(
            wb_card.seed_index.seed_arrays(),
            wb_cpu.seed_index.seed_arrays())):
        fail("the card's seed arrays differ from the CPU's")
    strip = lambda segs: [(sg["segment"], sg["num_seeds"]) for sg in segs]
    if strip(segs_card) != strip(segs_cpu):
        fail("the card's segments differ from the CPU's: %s against %s"
             % (strip(segs_card), strip(segs_cpu)))
    stats = lambda segs: np.asarray([(sg["p"], *sg["score"])
                                     for sg in segs], np.float64)
    stat_err = float(np.abs(stats(segs_card) - stats(segs_cpu)).max(
        initial=0.0))
    if not np.allclose(stats(segs_card), stats(segs_cpu), **DISCOVERY_TOL):
        fail("the card's p-hat / scores differ from the CPU's (max |d| %r)"
             % stat_err)
    print("discovery on the card == on the CPU: %d seeds, %d segments"
          " (segments, seed counts and order exactly; p-hat, S0, S1 max |d|"
          " %.3g, within rtol %g, atol %g; the CPU's %.1f s)"
          % (len(wb_card.seed_index), len(segs_card), stat_err,
             DISCOVERY_TOL["rtol"], DISCOVERY_TOL["atol"], cpu_s))
    # the call's rows are the card's segments, split into windows
    by_source = {}
    for row in found:
        by_source.setdefault(row["source_index"], []).append(row)
    if sorted(by_source) != list(range(len(segs_card))) or any(
            row["segment"][0] != segs_card[k]["segment"][0]
            or row["num_seeds"] != segs_card[k]["num_seeds"]
            for k, rows in by_source.items() for row in rows):
        fail("discover_and_extend's rows are not WordBlot's segments")
    _, _, gcut, glaunches = pipeline.extension_plan(segs_card, len(Sg),
                                                    len(Tg), True)
    if any(c != len(glaunches) for c in disc_counts.values()):
        fail("a kernel was not launched once per launch of the plan (%d):"
             " %s" % (len(glaunches), disc_counts))

    # every transcript rescores to its score, inside S and T
    sg_arr, tg_arr = Sg.to_array(), Tg.to_array()
    for row in found:
        tx = row["transcript"]
        got_score, letters_ok = rescore(np, tx, sg_arr, tg_arr,
                                        row["origin_start"],
                                        row["mutate_start"], subst)
        i1 = row["origin_start"] + tx.count("M") + tx.count("S") \
            + tx.count("D")
        j1 = row["mutate_start"] + tx.count("M") + tx.count("S") \
            + tx.count("I")
        if got_score != row["score"] or not letters_ok or not (
                0 <= row["origin_start"] <= i1 <= len(Sg)
                and 0 <= row["mutate_start"] <= j1 <= len(Tg)):
            fail("genome row %d: transcript rescores to %r, score %r"
                 " (letters ok: %s), cells (%d, %d) to (%d, %d)"
                 % (row["source_index"], got_score, row["score"],
                    letters_ok, row["origin_start"], row["mutate_start"],
                    i1, j1))
    recall = block_recall(found, truth)
    if recall != 1.0:
        fail("block recall %r, not 1.0" % recall)
    queue = queue_runs("genome (%d launches)" % len(glaunches), dev, card,
                       lambda: sorted(pipeline.extend_segments(
                           Sg, Tg, segs_card, with_transcripts=True,
                           device=dev), key=lambda row: -row["score"]),
                       found)
    g_cells = sum(row["band_cells"] for row in found)
    g_ops = sum(len(row["transcript"]) for row in found)
    print("discover_and_extend (%s): %d seeds, %d segments discovered, %d"
          " rows after the window split, %d band cells, %d transcript ops"
          " (match fraction %.4f), block recall %.1f; launches %s in %d"
          " launches of the plan; seed build %.3f s, discovery %.3f s,"
          " extension %.3f s, the whole call %.3f s (host clock)"
          % (card, len(wb_card.seed_index), len(by_source), len(found),
             g_cells, g_ops,
             sum(row["transcript"].count("M") for row in found) / g_ops,
             recall, disc_counts, len(glaunches), secs["seeds.build"],
             secs["blot.discover"], secs["pipeline.extend"], whole_s))
    for idxs, LS, LT, W in glaunches:
        print("genome launch: %d pairs, LS %d, LT %d, W %d"
              % (len(idxs), LS, LT, W))

    # K1 and the walk on every launch of the plan, timed alone; the
    # largest launch (by band cells) stands for the path in the JSON
    # line.  On the launch of the fewest antidiagonals both kernels are
    # held to their plain twins on the card, on that launch's inputs.
    held = min(range(len(glaunches)), key=lambda n: (
        glaunches[n][1] + glaunches[n][2], len(glaunches[n][0])))
    twin = None
    timed = []
    for n_launch, (gidx, gLS, gLT, gW) in enumerate(glaunches):
        twin_of = None
        if n_launch == held:
            twin_of = lambda *a: hold_launch("genome", card, *a)
        got = time_launch(dev, card, "genome", gcut, gidx, gLS, gLT, gW,
                          sg_arr, tg_arr, subst, flags, twin_of, reps=2)
        if got["twin"] is not None:
            twin = got["twin"]
        timed.append((got["cells"], got["dp_ms"], got["dp_bound"],
                      got["walk_ms"], got["walk_bound"]))
    print("genome plan: dp_ad %.3f ms and walk %.3f ms over its %d launches"
          " (CUDA events, each launch alone), extension %.3f s"
          % (sum(t[1] for t in timed), sum(t[3] for t in timed), len(timed),
             secs["pipeline.extend"]))
    _, dp_ms, dp_bound, walk_ms, walk_bound = max(timed)
    return {"launches": disc_counts, "queue": queue,
            "dp_ad": {"ms": dp_ms, "bound_ms": dp_bound[0],
                      "bound_by": dp_bound[1],
                      "plan_ms": sum(t[1] for t in timed),
                      "held_launch": twin["shape"],
                      "held_plain_ms": twin["dp_plain_ms"],
                      "held_max_abs_err": twin["dp_err"]},
            "walk": {"ms": walk_ms, "bound_ms": walk_bound[0],
                     "bound_by": walk_bound[1],
                     "plan_ms": sum(t[3] for t in timed),
                     "held_launch": twin["shape"],
                     "held_plain_ms": twin["walk_plain_ms"],
                     "held_max_abs_err": twin["walk_err"]}}


def time_launch(dev, card, label, cut, idxs, LS, LT, W, s_arr, t_arr, subst,
                flags, twin_of=None, reps=2, quiet=False):
    """One launch of a plan, as ``extend_segments`` makes it: K1 and the
    walk run on its inputs, are timed alone by CUDA events (``reps``
    runs each after a warm-up) and set beside their bounds; ``twin_of``,
    where given, holds them to their twins (:func:`hold_launch`'s
    arguments after ``card``).  Returns the times, the bounds and the
    twin check's result."""
    import torch

    from biseqt_tpu_torch import pipeline
    from biseqt_tpu_torch.ops import dp_ad, walk
    from biseqt_tpu_torch.profiling import (FP32_OPS_PER_S, INT32_OPS_PER_S,
                                            bound_ms, cuda_ms)

    gx = pipeline.launch_inputs(cut, idxs, LS, LT, W, s_arr, t_arr, True)
    gon = {k: torch.from_numpy(v).to(dev) for k, v in gx.items()}
    gargs = (gon["s_codes"], gon["t_codes"], gon["s_lens"], gon["t_lens"],
             gon["dmin"])
    gkw = dict(W=W, subst=subst, go=GO, ge=GE, flags=flags,
               w_eff=gon["w_eff"], with_dirs=True, device=dev)
    gres = dp_ad.banded_dp_ad(*gargs, **gkw)
    greal = torch.arange(len(gx["dmin"]), device=dev) < len(idxs)
    gei = torch.where(greal, gres.end_i, -1)
    gej = torch.where(greal, gres.end_j, -1)
    gwalk = walk.traceback_walk(gres.dirs, gon["dminq"], gei, gej, W=W,
                                device=dev)
    twin = None
    if twin_of is not None:
        twin = twin_of(gargs, gkw, gon, gres, gei, gej, gwalk, LS, LT, W,
                       len(idxs))
    dp_ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*gargs, **gkw), reps)
    walk_ms = cuda_ms(lambda: walk.traceback_walk(
        gres.dirs, gon["dminq"], gei, gej, W=W, device=dev), reps)
    cells = sum((cut[k][5] - cut[k][4] + 1) * (cut[k][1] - cut[k][0])
                for k in idxs)
    dp_bound = bound_ms(nbytes(*gargs, gon["w_eff"], subst, *gres),
                        DP_AD_OPS_PER_CELL * cells, FP32_OPS_PER_S)
    tr32 = gwalk[0].to(torch.int32)
    reads = int(sum((((tr32 >> sh) & 3) != 0).sum()
                    for sh in (0, 2, 4, 6))) + int((gei >= 0).sum())
    walk_bound = bound_ms(reads + nbytes(gon["dminq"], gei, gej, *gwalk),
                          WALK_OPS_PER_STEP * reads, INT32_OPS_PER_S)
    steps = LS + LT
    if not quiet:
        print("%s launch (%s): %d pairs (%d real), LS %d, LT %d, W %d, %d"
              " band cells; dp_ad %.3f ms (%.4f us an antidiagonal step,"
              " %.2f GCUPS), bound %.4f ms (%s); walk %.3f ms (%d actions),"
              " bound %.4f ms (%s)"
              % (label, card, len(gx["dmin"]), len(idxs), LS, LT, W, cells,
                 dp_ms, dp_ms * 1e3 / steps, cells / dp_ms / 1e6, *dp_bound,
                 walk_ms, reads, *walk_bound))
    return {"dp_ms": dp_ms, "dp_bound": dp_bound, "walk_ms": walk_ms,
            "walk_bound": walk_bound, "cells": cells, "twin": twin}


def hold_launch(label, card, gargs, gkw, gon, gres, gei, gej, gwalk, LS,
                LT, W, n_real):
    """K1 and the walk on one launch of a plan against their plain twins
    on the card, on the same tensors: scores, end cells, the dirs plane
    on its live slots, trace bytes and cursors, exactly.  Returns the
    twins' times and the launch's shape."""
    import torch

    from biseqt_tpu_torch.ops import dp_ad, walk

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dp_ad.banded_dp_ad_reference(*gargs, **gkw)
    torch.cuda.synchronize()
    dp_plain_ms = (time.perf_counter() - t0) * 1e3
    dp_err = float((gres.score - want.score).abs().max())
    if not (torch.equal(gres.score, want.score)
            and torch.equal(gres.end_i, want.end_i)
            and torch.equal(gres.end_j, want.end_j)):
        fail("%s launch: DP kernel scores / end cells differ from the"
             " plain twin (max |d score| %r)" % (label, dp_err))
    low_live, high_live = dp_ad.live_nibbles(gon["dmin"], gon["w_eff"], W)
    gd, wd = gres.dirs, want.dirs
    bad = int((((gd ^ wd) & 15).ne(0) & low_live).sum()
              + (((gd ^ wd) >> 4).ne(0) & high_live).sum())
    if bad:
        fail("%s launch: DP kernel dirs plane differs from the plain"
             " twin on %d live nibbles" % (label, bad))
    del want
    t0 = time.perf_counter()
    w_want = walk.traceback_walk_reference(gres.dirs, gon["dminq"], gei, gej,
                                           W=W, device=gkw["device"])
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(gwalk, w_want)):
        fail("%s launch: walk kernel trace / cursors differ from the"
             " plain twin" % label)
    walk_err = float((gwalk[1] - w_want[1]).abs().max()
                     + (gwalk[2] - w_want[2]).abs().max())
    shape = "%d pairs (%d real), LS %d, LT %d, W %d" % (
        len(gon["dmin"]), n_real, LS, LT, W)
    print("%s launch (%s): %s: dp_ad kernel == plain twin (scores, end"
          " cells, dirs plane on its live slots; twin %.1f s), walk kernel =="
          " plain twin (trace bytes, cursors; twin %.1f s); %d"
          " antidiagonals, the twins replayed from CUDA graphs"
          % (label, card, shape, dp_plain_ms / 1e3, walk_plain_ms / 1e3,
             gres.dirs.shape[0] * 2))
    return {"shape": shape, "dp_plain_ms": dp_plain_ms, "dp_err": dp_err,
            "walk_plain_ms": walk_plain_ms, "walk_err": walk_err}


def phase_seconds(before, names):
    """Seconds each ``profiling.Phase`` of ``names`` took since the
    ``profiling.counters()`` snapshot ``before``."""
    from biseqt_tpu_torch import profiling

    after = profiling.counters()
    return {name: after.get(name, {}).get("seconds", 0.0)
            - before.get(name, {}).get("seconds", 0.0) for name in names}


def mapping_phase(dev, card, subst):
    """Phase 11: FASTA -> DB -> k-mer index -> reads mapped to a 5 Mbp
    reference and extended with transcripts, each step held to the CPU
    or to its twin.  Returns the kernels' launches and times on the
    path."""
    import os
    import tempfile

    import numpy as np
    import torch

    from biseqt_tpu_torch import pipeline, profiling
    from biseqt_tpu_torch.blot import WordBlotLocalRef
    from biseqt_tpu_torch.database import DB, write_fasta
    from biseqt_tpu_torch.kmers import KmerIndex, as_kmer_keys_np
    from biseqt_tpu_torch.ops import dp_ad, walk
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags
    from biseqt_tpu_torch.sequence import Alphabet, NamedSequence

    m = MAPPING
    A4 = Alphabet("ACGT")
    flags = ModeFlags(local_start=True, local_end=True)
    rng = np.random.default_rng(MAPPING_SEED)
    t0 = time.perf_counter()
    ref_codes = rng.integers(0, 4, m["ref"]).astype(np.int8)
    loci = rng.integers(0, m["ref"] - m["read_len"], m["reads"])
    reads = [channel(np, rng, ref_codes[r0:r0 + m["read_len"]], m["sub"],
                     m["go"], m["ge"]) for r0 in loci]
    print("mapping data: a %d bp reference, %d reads of %d bp through"
          " substitutions %.2f, gap open %.2f, gap extend %.2f (%d letters;"
          " %.1f s)" % (m["ref"], m["reads"], m["read_len"], m["sub"],
                        m["go"], m["ge"], sum(map(len, reads)),
                        time.perf_counter() - t0))
    names = ("smoke.map.ingest", "smoke.map.index", "blot.ref_index",
             "smoke.map.serial", "smoke.map.batch", "seeds.from_ref",
             "blot.stats", "smoke.map.extend")
    with tempfile.TemporaryDirectory() as td:
        ref_fa = os.path.join(td, "ref.fa")
        reads_fa = os.path.join(td, "reads.fa")
        write_fasta(ref_fa, [NamedSequence(A4, ref_codes, name="chr1")])
        write_fasta(reads_fa, [NamedSequence(A4, r, name="read%d" % k)
                               for k, r in enumerate(reads)])

        # -- ingest: the reference, then the reads with the index
        # subscribed (the index holds the reads alone)
        before = profiling.counters()
        with profiling.Phase("smoke.map.ingest"):
            db = DB(os.path.join(td, "map.db"), A4)
            (ref_rec,) = db.load_fasta(ref_fa)
            index = KmerIndex(m["index_wordlen"], A4,
                              device=dev).attach_to(db)
            read_recs = db.load_fasta(reads_fa)
        R = db.load_from_record(ref_rec)
        stored = [db.load_from_record(rec) for rec in read_recs]
        if len(stored) != m["reads"] or not np.array_equal(
                R.to_array(), ref_codes) or not all(
                np.array_equal(x.to_array(), r)
                for x, r in zip(stored, reads)):
            fail("the DB did not give back the reference and the reads")

        # -- the read index on the card, against the CPU and a scan
        with profiling.Phase("smoke.map.index"):
            index.refresh()
            torch.cuda.synchronize()
        on_cpu = KmerIndex(m["index_wordlen"], A4, device="cpu")
        t0 = time.perf_counter()
        on_cpu.index_kmers(stored)
        index_cpu_s = time.perf_counter() - t0
        if not all(torch.equal(g.cpu(), w)
                   for g, w in zip(index.table(), on_cpu.table())):
            fail("the read index on the card differs from the CPU's")
        keys = [as_kmer_keys_np(r, m["index_wordlen"], 4) for r in reads]
        flat = np.concatenate(keys)
        sid = np.repeat(np.arange(len(keys)), [len(k) for k in keys])
        pos = np.concatenate([np.arange(len(k)) for k in keys])
        for km in (int(keys[0][0]), int(keys[7][len(keys[7]) // 2]),
                   int(flat.max()),
                   int(rng.integers(0, 4 ** m["index_wordlen"]))):
            hit = np.flatnonzero(flat == km)
            if index.hits(km) != list(zip(sid[hit].tolist(),
                                          pos[hit].tolist())):
                fail("the index's hits of k-mer %d differ from a numpy scan"
                     % km)
        if index.num_kmers != flat.size:
            fail("the index holds %d k-mers, the reads %d"
                 % (index.num_kmers, flat.size))

        # -- fixed-reference discovery, serial and batched, against the CPU
        queries = stored[:m["queries"]]
        mapper = WordBlotLocalRef(R, device=dev, **MAPPER)
        list(mapper.similar_segments(queries[0], **MAPPING_QUERY))
        torch.cuda.synchronize()
        mid = profiling.counters()
        with profiling.Phase("smoke.map.serial"):
            serial = [list(mapper.similar_segments(q, **MAPPING_QUERY))
                      for q in queries]
        serial_s = phase_seconds(mid, names)
        mid = profiling.counters()
        with profiling.Phase("smoke.map.batch"):
            batch = mapper.similar_segments_batch(queries, **MAPPING_QUERY)
        batch_s = phase_seconds(mid, names)
        t0 = time.perf_counter()
        on_cpu_map = WordBlotLocalRef(R, device="cpu", **MAPPER)
        cpu_batch = on_cpu_map.similar_segments_batch(queries,
                                                      **MAPPING_QUERY)
        map_cpu_s = time.perf_counter() - t0
        if not (np.array_equal(mapper._ref_keys, on_cpu_map._ref_keys)
                and np.array_equal(mapper._ref_pos, on_cpu_map._ref_pos)):
            fail("the reference's k-mer table on the card differs from the"
                 " CPU's")
        strip = lambda segs: [(sg["segment"], sg["num_seeds"])
                              for sg in segs]
        stats = lambda segs: np.asarray([(sg["p"], *sg["score"])
                                         for sg in segs], np.float64)
        stat_err = 0.0
        for k, (ser, bat, cpu) in enumerate(zip(serial, batch, cpu_batch)):
            if strip(bat) != strip(ser) or strip(bat) != strip(cpu):
                fail("query %d: batch %s, serial %s, the CPU %s"
                     % (k, strip(bat), strip(ser), strip(cpu)))
            if bat:
                stat_err = max(stat_err, float(np.abs(
                    stats(bat) - stats(cpu)).max()), float(np.abs(
                        stats(bat) - stats(ser)).max()))
                if not (np.allclose(stats(bat), stats(cpu), **DISCOVERY_TOL)
                        and np.allclose(stats(bat), stats(ser),
                                        **DISCOVERY_TOL)):
                    fail("query %d: p-hat / scores differ (max |d| %r)"
                         % (k, stat_err))
        tops = [max(segs, key=lambda sg: sg["num_seeds"]) if segs else None
                for segs in batch]
        hit = sum(top is not None and top["segment"][0][0] - LOCUS_RADIUS
                  <= -int(r0) <= top["segment"][0][1] + LOCUS_RADIUS
                  for top, r0 in zip(tops, loci))
        recall = hit / len(queries)
        if recall != 1.0:
            fail("locus recall %r, not 1.0" % recall)

        # -- each query's top segment extended with a transcript, counted
        r_arr = R.to_array()
        dp_ad.LAUNCHES = 0
        walk.LAUNCHES = 0
        with profiling.Phase("smoke.map.extend"):
            mapped = [pipeline.extend_segments(
                q, R, [top], subst=subst, go_score=GO, ge_score=GE,
                with_transcripts=True, device=dev)
                for q, top in zip(queries, tops)]
            torch.cuda.synchronize()
        map_counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
        secs = phase_seconds(before, names)
        plans = [pipeline.extension_plan([top], len(q), len(R), True)
                 for q, top in zip(queries, tops)]
        n_plan = sum(len(plan[3]) for plan in plans)
        if any(c != n_plan for c in map_counts.values()):
            fail("mapping: a kernel was not launched once per launch of the"
                 " plans (%d): %s" % (n_plan, map_counts))
        cells = ops = matches = 0
        for q, rows in zip(queries, mapped):
            q_arr = q.to_array()
            for row in rows:
                tx = row["transcript"]
                got_score, letters_ok = rescore(
                    np, tx, q_arr, r_arr, row["origin_start"],
                    row["mutate_start"], subst)
                if got_score != row["score"] or not letters_ok:
                    fail("mapped read %s: transcript rescores to %r, score"
                         " %r (letters ok: %s)" % (q.name, got_score,
                                                   row["score"], letters_ok))
                cells += row["band_cells"]
                ops += len(tx)
                matches += tx.count("M")
        if ops < 0.8 * m["queries"] * m["read_len"]:
            fail("mapped transcripts hold %d ops, under 80%% of the queries'"
                 " letters" % ops)
        # one call, so one launch, a query: nothing to keep in flight
        queue = queue_runs("mapping (%d calls)" % len(queries), dev, card,
                           lambda: [pipeline.extend_segments(
                               q, R, [top], subst=subst, go_score=GO,
                               ge_score=GE, with_transcripts=True,
                               device=dev) for q, top in zip(queries, tops)],
                           mapped)

        # -- the same extension walked on the host (device_walk=False):
        # K1 on the card, each plane copied and walked by the C++ tier,
        # the transcripts the device walk's
        dp_ad.LAUNCHES = 0
        walk.LAUNCHES = 0
        t0 = time.perf_counter()
        host_walked = [pipeline.extend_segments(
            q, R, [top], subst=subst, go_score=GO, ge_score=GE,
            with_transcripts=True, device_walk=False, device=dev)
            for q, top in zip(queries, tops)]
        host_walk_s = time.perf_counter() - t0
        if (dp_ad.LAUNCHES, walk.LAUNCHES) != (n_plan, 0):
            fail("mapping, host walk: launches dp_ad %d, walk %d; the plans"
                 " hold %d" % (dp_ad.LAUNCHES, walk.LAUNCHES, n_plan))
        if host_walked != mapped:
            fail("mapping: the host walk's transcripts differ from the"
                 " device walk's")

        # -- each launch of the plans timed alone; the first query's
        # launch held to the twins
        timed = []
        twin = None
        for k, (q, plan) in enumerate(zip(queries, plans)):
            _, _, cut, launches = plan
            for idxs, LS, LT, W in launches:
                twin_of = None
                if twin is None:
                    twin_of = lambda *a: hold_launch("mapping", card, *a)
                got = time_launch(dev, card, "mapping", cut, idxs, LS, LT, W,
                                  q.to_array(), r_arr, subst, flags, twin_of,
                                  reps=1, quiet=k > 0)
                twin = twin or got["twin"]
                timed.append(got)
        db.close()
    dp_ms = sum(t["dp_ms"] for t in timed)
    walk_ms = sum(t["walk_ms"] for t in timed)
    dp_bound = sum(t["dp_bound"][0] for t in timed)
    walk_bound = sum(t["walk_bound"][0] for t in timed)
    ingest_letters = m["ref"] + sum(map(len, reads))
    print("mapping ingest (%s): %d records, %d letters in %.3f s (%.1f M"
          " letters/s; FASTA through the C++ packer, SQLite rows, the pool's"
          " .npy files)" % (card, 1 + m["reads"], ingest_letters,
                            secs["smoke.map.ingest"],
                            ingest_letters / secs["smoke.map.ingest"] / 1e6))
    print("mapping index (%s): %d k-mers of %d reads (word length %d) in"
          " %.4f s on the card (%.1f M k-mers/s), %.3f s on the CPU; == the"
          " CPU's table (keys, sequence ids, positions), hits == a numpy"
          " scan" % (card, index.num_kmers, m["reads"], m["index_wordlen"],
                     secs["smoke.map.index"],
                     index.num_kmers / secs["smoke.map.index"] / 1e6,
                     index_cpu_s))
    for name, got_s, whole in (("serial", serial_s, "smoke.map.serial"),
                               ("batch", batch_s, "smoke.map.batch")):
        wall = got_s[whole]
        print("mapping discovery, %s (%s): %d queries in %.3f s (%.2f"
              " queries/s); the statistics on the card %.3f s (%.1f%%, their"
              " dispatch and copy included), the seeds served on the host"
              " %.3f s (%.1f%%), the rest of the host work %.3f s (%.1f%%)"
              % (name, card, len(queries), wall, len(queries) / wall,
                 got_s["blot.stats"], 100 * got_s["blot.stats"] / wall,
                 got_s["seeds.from_ref"],
                 100 * got_s["seeds.from_ref"] / wall,
                 wall - got_s["blot.stats"] - got_s["seeds.from_ref"],
                 100 * (wall - got_s["blot.stats"] - got_s["seeds.from_ref"])
                 / wall))
    print("mapping discovery: the reference's table %.3f s on the card;"
          " batch == serial, the card == the CPU (%d segments, seed counts"
          " exactly; p-hat, S0, S1 max |d| %.3g; the CPU's batch %.1f s);"
          " locus recall %.2f" % (secs["blot.ref_index"],
                                  sum(map(len, batch)), stat_err, map_cpu_s,
                                  recall))
    print("mapping extension (%s): %d queries, %d rows, %d band cells, %d"
          " transcript ops (match fraction %.4f), every transcript rescored;"
          " launches %s = the plans' %d; %.3f s (%.3f GCUPS); over the %d"
          " launches, each alone by CUDA events: dp_ad %.3f ms (bound %.4f"
          " ms), walk %.3f ms (bound %.4f ms)"
          % (card, len(queries), sum(map(len, mapped)), cells, ops,
             matches / ops, map_counts, n_plan, secs["smoke.map.extend"],
             cells / secs["smoke.map.extend"] / 1e9, len(timed), dp_ms,
             dp_bound, walk_ms, walk_bound))
    print("mapping extension walked on the host (device_walk=False, %s):"
          " %.3f s for the %d queries (the device walk %.3f s), transcripts"
          " and start cells == the device walk's" % (
              card, host_walk_s, len(queries), secs["smoke.map.extend"]))
    wide_mapping(dev, card)
    return {"launches": map_counts, "queue": queue,
            "dp_ad": {"plan_ms": dp_ms, "plan_bound_ms": dp_bound,
                      "held_launch": twin["shape"],
                      "held_plain_ms": twin["dp_plain_ms"],
                      "held_max_abs_err": twin["dp_err"]},
            "walk": {"plan_ms": walk_ms, "plan_bound_ms": walk_bound,
                     "held_launch": twin["shape"],
                     "held_plain_ms": twin["walk_plain_ms"],
                     "held_max_abs_err": twin["walk_err"]}}


def wide_mapping(dev, card):
    """Phase 11, last: a few reads mapped to a reference shorter than
    ``WordBlotLocalRef.WIDE_MAX_REF`` at DNA word length 16, past int32
    keys, on the card and on the CPU: the reference's table and the
    segments equal, p-hat, S0 and S1 within the discovery tolerance, and
    locus recall 1.0."""
    import numpy as np

    from biseqt_tpu_torch.blot import WordBlotLocalRef
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    w, m = WIDE_MAPPING, MAPPING
    A4 = Alphabet("ACGT")
    rng = np.random.default_rng(MAPPING_SEED + 1)
    ref_codes = rng.integers(0, 4, w["ref"]).astype(np.int8)
    loci = rng.integers(0, w["ref"] - w["read_len"], w["reads"])
    reads = [Sequence(A4, channel(np, rng, ref_codes[r0:r0 + w["read_len"]],
                                  m["sub"], m["go"], m["ge"]))
             for r0 in loci]
    R = Sequence(A4, ref_codes)
    kw = dict(wordlen=w["wordlen"], g_max=MAPPER["g_max"])
    t0 = time.perf_counter()
    on_card = WordBlotLocalRef(R, device=dev, **kw)
    got = on_card.similar_segments_batch(reads, **MAPPING_QUERY)
    card_s = time.perf_counter() - t0
    on_cpu = WordBlotLocalRef(R, device="cpu", **kw)
    want = on_cpu.similar_segments_batch(reads, **MAPPING_QUERY)
    if not (on_card._ref_keys.dtype == np.int64
            and np.array_equal(on_card._ref_keys, on_cpu._ref_keys)
            and np.array_equal(on_card._ref_pos, on_cpu._ref_pos)):
        fail("wide word: the reference's table on the card differs from"
             " the CPU's")
    strip = lambda segs: [(sg["segment"], sg["num_seeds"]) for sg in segs]
    err = 0.0
    for k, (g, c) in enumerate(zip(got, want)):
        if strip(g) != strip(c):
            fail("wide word, read %d: the card %s, the CPU %s"
                 % (k, strip(g), strip(c)))
        if g:
            a, b = (np.asarray([(sg["p"], *sg["score"]) for sg in segs])
                    for segs in (g, c))
            err = max(err, float(np.abs(a - b).max()))
            if not np.allclose(a, b, **DISCOVERY_TOL):
                fail("wide word, read %d: p-hat / scores differ (max |d| %r)"
                     % (k, err))
    tops = [max(segs, key=lambda sg: sg["num_seeds"]) if segs else None
            for segs in got]
    recall = sum(top is not None and top["segment"][0][0] - LOCUS_RADIUS
                 <= -int(r0) <= top["segment"][0][1] + LOCUS_RADIUS
                 for top, r0 in zip(tops, loci)) / len(reads)
    if recall != 1.0:
        fail("wide word: locus recall %r, not 1.0" % recall)
    print("mapping at word length %d (%s): %d reads of %d bp against %d bp,"
          " int64 keys; the table and %d segments == the CPU's (p-hat, S0,"
          " S1 max |d| %.3g); locus recall %.2f; %.3f s on the card"
          % (w["wordlen"], card, len(reads), w["read_len"], w["ref"],
             sum(map(len, got)), err, recall, card_s))


def nway_phase(dev, card):
    """Phase 12: ``WordBlotMultiple`` at the N-way homology config on the
    card, held to the CPU, with block recall 1.0."""
    import numpy as np
    import torch

    from biseqt_tpu_torch import profiling
    from biseqt_tpu_torch.blot import WordBlotMultiple
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    n = NWAY
    A4 = Alphabet("ACGT")
    rng = np.random.default_rng(NWAY_SEED)
    cores = [rng.integers(0, 4, n["block"]).astype(np.int8)
             for _ in range(2)]
    seqs, blocks = [], []
    for k in range(n["n"]):
        f1, f2, f3 = (rng.integers(0, 4, int(rng.integers(*n["flank"])))
                      .astype(np.int8) for _ in range(3))
        b1, b2 = (channel(np, rng, c, n["sub"], n["go"], n["ge"])
                  for c in cores)
        seqs.append(Sequence(A4, np.concatenate([f1, b1, f2, b2, f3])))
        if k == 0:
            blocks = [(len(f1), len(f1) + len(b1)),
                      (len(f1) + len(b1) + len(f2),
                       len(f1) + len(b1) + len(f2) + len(b2))]
    torch.cuda.synchronize()
    before = profiling.counters()
    with profiling.Phase("smoke.nway.seeds"):
        on_card = WordBlotMultiple(*seqs, wordlen=12, device=dev)
    with profiling.Phase("smoke.nway.discover"):
        segs = list(on_card.similar_segments(**NWAY_QUERY))
    secs = phase_seconds(before, ("smoke.nway.seeds", "smoke.nway.discover",
                                  "blot.stats"))
    t0 = time.perf_counter()
    on_cpu = WordBlotMultiple(*seqs, wordlen=12, device="cpu")
    cpu_segs = list(on_cpu.similar_segments(**NWAY_QUERY))
    cpu_s = time.perf_counter() - t0
    if on_card.seed_index.seeds() != on_cpu.seed_index.seeds():
        fail("N-way seeds on the card differ from the CPU's")
    strip = lambda ss: [(sg["segment"], sg["num_seeds"]) for sg in ss]
    if strip(segs) != strip(cpu_segs):
        fail("N-way segments on the card differ from the CPU's: %s against"
             " %s" % (strip(segs), strip(cpu_segs)))
    stats = lambda ss: np.asarray([(sg["p"], *sg["score"]) for sg in ss],
                                  np.float64)
    stat_err = float(np.abs(stats(segs) - stats(cpu_segs)).max(initial=0.0))
    if not np.allclose(stats(segs), stats(cpu_segs), **DISCOVERY_TOL):
        fail("N-way p-hat / scores differ from the CPU's (max |d| %r)"
             % stat_err)
    # multiple_homology.py's recall: a segment's pivot range (a / 2)
    # overlaps each planted block
    hits = [any(sg["segment"][1][0] // 2 < hi and sg["segment"][1][1] // 2
                > lo for sg in segs) for lo, hi in blocks]
    recall = sum(hits) / len(blocks)
    if recall != 1.0:
        fail("N-way block recall %r, not 1.0" % recall)
    print("N-way homology (%s): %d sequences, %d bp, %d N-way seeds, %d"
          " segments (p-hat %s); == the CPU (seeds, segments, seed counts"
          " exactly; p-hat, S0, S1 max |d| %.3g; the CPU's %.2f s); block"
          " recall %.1f; seed build %.3f s (the k-mer table and its sort on"
          " the card, the expansion on the host), discovery %.3f s"
          " (statistics on the card %.4f s)"
          % (card, len(seqs), sum(map(len, seqs)), len(on_card.seed_index),
             len(segs), [round(sg["p"], 3) for sg in segs], stat_err, cpu_s,
             recall, secs["smoke.nway.seeds"], secs["smoke.nway.discover"],
             secs["blot.stats"]))


def stats_equal(np, got, want, exact, what):
    """Integer statistics exactly, p and s0 within STATS_TOL; returns
    the largest |d| of p and s0."""
    host = lambda v: v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    for k in exact:
        if not np.array_equal(host(got[k]), host(want[k])):
            fail("%s: %s differs" % (what, k))
    err = 0.0
    for k in ("p", "s0"):
        g, w = host(got[k]), host(want[k])
        if not np.allclose(g, w, **STATS_TOL):
            fail("%s: %s beyond rtol 1e-5, atol 1e-6" % (what, k))
        err = max(err, float(np.abs(g - w).max(initial=0.0)))
    return err


def overlap_phase(dev, card, recall_reads):
    """Phase 13: all-vs-all read overlaps (BASELINE config 4) on the
    card: the sort-join engine at 1000 x 10 kbp (timed; held to its
    chunked run, to the CPU on 256 reads, and to the pairs
    ``all_vs_all_overlaps`` returns), the recall config against the JAX
    package's CPU run, and the blockwise engine on a world-of-one mesh
    against the CPU."""
    import numpy as np
    import torch

    from biseqt_tpu_torch.experiments import index_build_bench
    from biseqt_tpu_torch.experiments.overlap_recall import (
        score_overlaps, simulate_packed)
    from biseqt_tpu_torch.ops.allvsall_sorted import (
        auto_max_run, overlap_stats_sorted, overlap_stats_sorted_chunked)
    from biseqt_tpu_torch.parallel import all_vs_all_overlaps, make_mesh
    from biseqt_tpu_torch.parallel.allvsall import overlap_matrix_sharded

    t_phase = time.perf_counter()
    ov = OVERLAP
    N, L, w = ov["reads"], ov["read_len"], ov["wordlen"]
    max_run = auto_max_run(N, L, w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)   # earlier phases' tensors
    # index_build_bench at its defaults: the k-mer table at word length
    # 8, then the sort-join at word length 12, bucket 64, each timed on
    # fresh reads after a warm-up
    ibb = index_build_bench.run(N, L, device=dev, seed=OVERLAP_SEED)
    codes, lens, stats = ibb.codes, ibb.lens, ibb.stats
    build_s, secs = ibb.seconds
    peak = torch.cuda.max_memory_allocated(dev) - held
    if (ibb.row["join_wordlen"], ibb.row["kmers_indexed"]) != (
            w, N * (L - ibb.row["wordlen"] + 1)):
        fail("index_build_bench: join word %d, %d k-mers indexed"
             % (ibb.row["join_wordlen"], ibb.row["kmers_indexed"]))
    kw = dict(wordlen=w, n_reads=N, bucket=ov["bucket"], device=dev)
    chunked = overlap_stats_sorted_chunked(codes, lens,
                                           max_chunk=ov["chunk"], **kw)
    for k in stats:
        if not torch.equal(chunked[k], stats[k]):
            fail("the chunked sort-join (max_chunk %d) differs from the"
                 " unchunked in %s" % (ov["chunk"], k))
    n = ov["cpu_reads"]
    sub_kw = dict(kw, n_reads=n)
    on_card = overlap_stats_sorted(codes[:n], lens[:n], **sub_kw)
    t0 = time.perf_counter()
    on_cpu = overlap_stats_sorted(codes[:n].cpu(), lens[:n].cpu(),
                                  **dict(sub_kw, device="cpu"))
    cpu_s = time.perf_counter() - t0
    cpu_err = stats_equal(np, on_card, on_cpu, ("window", "diag",
                                                "olap_len"),
                          "sort-join on %d reads, card vs CPU" % n)
    host = {k: v.cpu().numpy() for k, v in stats.items()}
    thresholds = dict(min_score=25.0, min_p=0.5, min_olap_len=0)
    pairs = all_vs_all_overlaps(codes, lens, wordlen=w, method="sorted",
                                bucket=ov["bucket"], device=dev,
                                **thresholds)
    mask = ((host["s0"] >= 25.0) & (host["p"] >= 0.5)
            & np.triu(np.ones((N, N), bool), k=1))
    if [(q, t) for q, t, *_ in pairs] != list(zip(*np.nonzero(mask))):
        fail("all_vs_all_overlaps' pairs differ from the thresholded stats")
    print("index_build_bench (%s): %s" % (card, json.dumps(ibb.row)))
    print("all-vs-all sort-join (%s): %d reads of %d bp, word %d, bucket"
          " %d, max_run %d (auto): the k-mer table (word %d, %d k-mers)"
          " %r s, the sort-join %r s warm, %.0f pair-scores/s; %d"
          " composites (%.0f MB int32), peak %.2f GB allocated by"
          " index_build_bench.run; == chunked"
          " (max_chunk %d) exactly; first %d reads == the CPU (window,"
          " diag, olap_len exactly, p/s0 max |d| %.3g; the CPU's %.2f s);"
          " all_vs_all_overlaps: %d pairs == the thresholded stats"
          % (card, N, L, w, ov["bucket"], max_run, ibb.row["wordlen"],
             ibb.row["kmers_indexed"], build_s, secs, N * N / secs,
             2 * max_run * N * L, 2 * max_run * N * L * 4 / 1e6, peak / 1e9,
             ov["chunk"], n, cpu_err, cpu_s, len(pairs)))

    # (b) the recall config
    rc, sc = RECALL, RECALL_SCORING
    r_codes, r_lens, starts = recall_reads.get(timeout=300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_stats = overlap_stats_sorted_chunked(
        r_codes, r_lens, wordlen=sc["wordlen"], n_reads=rc["n_reads"],
        min_window=sc["min_window"], device=dev)
    torch.cuda.synchronize()
    r_secs = time.perf_counter() - t0
    r_host = {k: v.cpu().numpy() for k, v in r_stats.items()}
    got = score_overlaps(r_host, starts, rc["read_len"], sc["wordlen"],
                         sc["min_olap"], sc["min_score"], sc["min_p"])
    for k in ("precision", "recall", "n_predictions"):
        if got[k] != RECALL_JAX_CPU[k]:
            fail("recall config: %s %r on the card, %r from the JAX package"
                 " on the CPU" % (k, got[k], RECALL_JAX_CPU[k]))
    r_pairs = all_vs_all_overlaps(
        r_codes, r_lens, wordlen=sc["wordlen"], min_score=sc["min_score"],
        min_p=sc["min_p"], min_olap_len=sc["min_olap"] // 2,
        method="sorted", bucket=64, device=dev)
    r_mask = ((r_host["s0"] >= sc["min_score"]) & (r_host["p"] >= sc["min_p"])
              & (r_host["olap_len"] >= sc["min_olap"] // 2)
              & np.triu(np.ones(r_host["p"].shape, bool), k=1))
    if [(q, t) for q, t, *_ in r_pairs] != list(zip(*np.nonzero(r_mask))):
        fail("recall config: all_vs_all_overlaps' pairs differ from the"
             " thresholded stats")
    print("overlap recall (%s): %d reads of %d bp from a %d bp genome, %.0f%%"
          " error, word %d: %.4f s on the card; precision %r, recall %r, %d"
          " predictions, diag MAE %r == the JAX package on the CPU"
          " (precision %r, recall %r, diag MAE %r); all_vs_all_overlaps: %d"
          " pairs == the thresholded stats"
          % (card, rc["n_reads"], rc["read_len"], rc["genome_len"],
             100 * rc["err"], sc["wordlen"], r_secs, got["precision"],
             got["recall"], got["n_predictions"], got["diag_mae"],
             RECALL_JAX_CPU["precision"], RECALL_JAX_CPU["recall"],
             RECALL_JAX_CPU["diag_mae"], len(r_pairs)))

    # (c) the blockwise engine on a world-of-one mesh
    bw = BLOCKWISE
    b_codes, b_lens, b_starts = simulate_packed(
        bw["seed"], bw["genome_len"], bw["read_len"], bw["n_reads"],
        bw["err"])
    mesh = make_mesh(device=dev)
    t0 = time.perf_counter()
    b_pairs = all_vs_all_overlaps(b_codes, b_lens, method="blockwise",
                                  mesh=mesh, device=dev)
    b_secs = time.perf_counter() - t0
    cpu_pairs = all_vs_all_overlaps(b_codes, b_lens, method="blockwise",
                                    mesh=make_mesh(device="cpu"),
                                    device="cpu")
    if [p[:3] for p in b_pairs] != [p[:3] for p in cpu_pairs] or not \
            np.allclose([p[3:] for p in b_pairs], [p[3:] for p in cpu_pairs],
                        **STATS_TOL):
        fail("blockwise all_vs_all_overlaps: the card's pairs differ from"
             " the CPU's")
    b_card = overlap_matrix_sharded(b_codes, b_lens, mesh=mesh, device=dev)
    b_cpu = overlap_matrix_sharded(b_codes, b_lens,
                                   mesh=make_mesh(device="cpu"),
                                   device="cpu")
    b_err = stats_equal(np, b_card, b_cpu, ("num_seeds", "diag", "olap_len"),
                        "blockwise stats, card vs CPU")
    b_score = score_overlaps(b_card, b_starts, bw["read_len"],
                             sc["wordlen"], sc["min_olap"], sc["min_score"],
                             sc["min_p"])
    print("blockwise all-vs-all (%s): %d reads of %d bp, mesh %s: %d pairs"
          " in %.4f s == the CPU (pairs exactly; stats: integers exactly,"
          " p/s0 max |d| %.3g); overlap_recall's accounting: precision %r,"
          " recall %r" % (card, bw["n_reads"], bw["read_len"], mesh,
                          len(b_pairs), b_secs, b_err,
                          b_score["precision"], b_score["recall"]))
    phase_s = time.perf_counter() - t_phase
    print("phase 13: %.1f s" % phase_s)
    return {"seconds": secs, "pair_scores_per_s": N * N / secs,
            "peak_bytes": peak, "recall": got, "recall_seconds": r_secs,
            "blockwise_seconds": b_secs, "phase_seconds": phase_s,
            "row": ibb.row}


def protein_phase(dev, card):
    """Phase 14: two-tier protein search (BASELINE config 7p) at
    experiments/protein_search.py's full size, K1 counted (one launch a
    tier), the rescore held to a full-only K1 run, K1 to its plain twin
    at A 6 and A 20, and the call to the CPU on 64 pairs."""
    import numpy as np
    import torch

    from biseqt_tpu_torch.experiments.protein_search import mk_batch
    from biseqt_tpu_torch.matrices import (BLOSUM62, DAYHOFF6_GROUPS,
                                           compression_map, reduced_matrix)
    from biseqt_tpu_torch.ops import dp_ad
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags
    from biseqt_tpu_torch.profiling import (FP32_OPS_PER_S, bound_ms,
                                            cuda_ms)
    from biseqt_tpu_torch.protein import (compress_codes, null_threshold,
                                          two_tier_scores)

    t_phase = time.perf_counter()
    pc = PROTEIN
    B, L, BW, W = pc["B"], pc["L"], pc["band"], pc["W"]
    flags = ModeFlags(local_start=True, local_end=True)
    lens = np.full((B,), L, np.int32)
    dmin = np.full((B,), -(BW // 2), np.int32)
    w_eff = np.full((B,), BW, np.int32)
    kw = dict(W=W, go=pc["go"], ge=pc["ge"], flags=flags)
    cells = B * L * BW                      # as the experiment counts them
    rng = np.random.default_rng(pc["seed"])
    cmap = compression_map(DAYHOFF6_GROUPS)
    red = reduced_matrix(BLOSUM62, DAYHOFF6_GROUPS)
    on = lambda x: torch.as_tensor(x, device=dev)
    g_lens, g_dmin, g_weff = on(lens), on(dmin), on(w_eff)

    def k1(a, b, mat, rows=slice(None), fn=dp_ad.banded_dp_ad):
        return fn(a[rows], b[rows], g_lens[rows], g_lens[rows],
                  g_dmin[rows], subst=mat, w_eff=g_weff[rows], device=dev,
                  **kw)

    ns, nt, _ = mk_batch(rng, B, L, 0.0, pc["sub_rate"])
    null = k1(on(compress_codes(ns, cmap)), on(compress_codes(nt, cmap)),
              red)
    thr = null_threshold(null.score, margin=pc["margin"])
    ss, ts, is_hom = mk_batch(rng, B, L, pc["hom_frac"], pc["sub_rate"])
    two_tier_scores(ss[:8], ts[:8], lens[:8], lens[:8], dmin[:8],
                    w_eff=w_eff[:8], threshold=thr, device=dev, **kw)
    torch.cuda.synchronize()
    dp_ad.LAUNCHES = 0
    t0 = time.perf_counter()
    res = two_tier_scores(ss, ts, lens, lens, dmin, w_eff=w_eff,
                          threshold=thr, engine="pallas", device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_ad.LAUNCHES
    if launches != 2:
        fail("two_tier_scores launched K1 %d times, not once a tier"
             % launches)
    g_ss, g_ts = on(ss), on(ts)
    full = k1(g_ss, g_ts, BLOSUM62)
    idx = res.survivor_idx
    full_np = full.score.cpu().numpy()
    if not np.array_equal(res.full_scores[idx], full_np[idx]):
        fail("the rescore tier's scores differ from a full-only K1 run")
    recall = float(res.survivors[is_hom].mean())
    if recall != 1.0:
        fail("two-tier homolog recall %r, not 1.0" % recall)
    frac = float(res.survivors.mean())

    # K1 against its plain twin on the card, at A 6 and A 20
    g_rs, g_rt = on(compress_codes(ss, cmap)), on(compress_codes(ts, cmap))
    twin = slice(0, pc["twin_pairs"])
    twin_ms = {}
    for A, a, b, mat in ((6, g_rs, g_rt, red), (20, g_ss, g_ts, BLOSUM62)):
        t0 = time.perf_counter()
        want = k1(a, b, mat, twin, dp_ad.banded_dp_ad_reference)
        torch.cuda.synchronize()
        twin_ms[A] = (time.perf_counter() - t0) * 1e3
        got = k1(a, b, mat, twin)
        if not torch.equal(got.score, want.score):
            fail("K1 differs from its plain twin on %d protein pairs at A %d"
                 % (pc["twin_pairs"], A))
    # the call on the card against the CPU
    c = pc["cpu_pairs"]
    small = (ss[:c], ts[:c], lens[:c], lens[:c], dmin[:c])
    c_card = two_tier_scores(*small, w_eff=w_eff[:c], threshold=thr,
                             device=dev, **kw)
    t0 = time.perf_counter()
    c_cpu = two_tier_scores(*small, w_eff=w_eff[:c], threshold=thr,
                            device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    for name in ("reduced_scores", "survivors", "survivor_idx",
                 "full_scores"):
        if not np.array_equal(getattr(c_card, name), getattr(c_cpu, name)):
            fail("two_tier_scores on %d pairs: %s differs between the card"
                 " and the CPU" % (c, name))

    # times by CUDA events: the filter, the rescore on the survivors,
    # and the full-only run
    rows = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    filter_ms = cuda_ms(lambda: k1(g_rs, g_rt, red), 3)
    rescore_ms = cuda_ms(lambda: k1(g_ss, g_ts, BLOSUM62, rows), 3)
    full_ms = cuda_ms(lambda: k1(g_ss, g_ts, BLOSUM62), 3)
    # K1 score-only reads the codes, lengths, band and table once and
    # writes the scores once
    work = (nbytes(g_ss, g_ts, g_lens, g_lens, g_dmin, g_weff, full.score)
            + 20 * 20 * 4, DP_AD_SCORE_OPS_PER_CELL * cells)
    bound, bound_by = bound_ms(*work, FP32_OPS_PER_S)
    eff = cells / ((filter_ms + rescore_ms) / 1e3) / 1e9
    full_gcups = cells / (full_ms / 1e3) / 1e9
    print("two-tier protein search (%s): %d pairs of %d residues, band %d"
          " (W %d), Dayhoff-6 filter at threshold %.1f, BLOSUM62 rescore;"
          " %d K1 launches; call %.4f s; survivors %d (%.4f), homolog"
          " recall %.1f, rescore == full-only K1 exactly; K1 == twin on %d"
          " pairs at A 6 and A 20 (twin %.0f / %.0f ms); %d pairs == the"
          " CPU (the CPU's %.2f s)"
          % (card, B, L, BW, W, thr, launches, wall, idx.size, frac, recall,
             pc["twin_pairs"], twin_ms[6], twin_ms[20], c, cpu_s))
    print("two-tier K1 times (CUDA events): filter %.3f ms, rescore %.3f ms"
          " (%d pairs), full-only %.3f ms; effective %.1f GCUPS, full-only"
          " %.1f GCUPS (cells = B * L * %d); K1 bound at this shape %.4f ms"
          " (%s; %.1f MB, %.2f G operations)"
          % (filter_ms, rescore_ms, idx.size, full_ms, eff, full_gcups, BW,
             bound, bound_by, work[0] / 1e6, work[1] / 1e9))
    phase_s = time.perf_counter() - t_phase
    print("phase 14: %.1f s" % phase_s)
    return {"launches": launches, "filter_ms": filter_ms,
            "rescore_ms": rescore_ms, "full_only_ms": full_ms,
            "bound_ms": bound, "bound_by": bound_by, "call_s": wall,
            "survivor_frac": frac, "effective_gcups": eff,
            "full_only_gcups": full_gcups, "twin_ms": twin_ms,
            "phase_seconds": phase_s}


def queue_runs(label, dev, card, extend, want):
    """The in-flight queue of ``extend_segments``: ``extend()`` (the
    phase's extension, called as the phase calls it) with
    ``pipeline.PIPELINE_BYTES`` at 0 (each launch finished before the
    next is dispatched) and at its default, in turns (serial, in flight,
    in flight, serial), each output equal to ``want`` byte for byte;
    prints the walls (host clock, ending in a synchronise) and each
    run's allocator peak above what was held."""
    import torch

    from biseqt_tpu_torch import pipeline

    from biseqt_tpu_torch import profiling

    spans = ("pipeline.launch", "pipeline.finish", "pipeline.compact")
    default = pipeline.PIPELINE_BYTES
    got = {name: {"seconds": [], "peak_bytes": [], "spans": []}
           for name in ("serial", "in_flight")}
    try:
        for name in ("serial", "in_flight", "in_flight", "serial"):
            budget = default if name == "in_flight" else 0
            pipeline.PIPELINE_BYTES = budget
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            before = profiling.counters()
            t0 = time.perf_counter()
            out = extend()
            torch.cuda.synchronize()
            got[name]["seconds"].append(time.perf_counter() - t0)
            got[name]["peak_bytes"].append(
                torch.cuda.max_memory_allocated(dev) - held)
            got[name]["spans"].append(phase_seconds(before, spans))
            if out != want:
                fail("%s: extend_segments with PIPELINE_BYTES %d differs"
                     " from the phase's output" % (label, budget))
    finally:
        pipeline.PIPELINE_BYTES = default
    print("%s in-flight queue (%s): PIPELINE_BYTES 0 (serial) %r s, K1's"
          " allocator peak %r bytes; PIPELINE_BYTES %d (default, in"
          " flight) %r s, peak %r bytes; every output == the phase's, byte"
          " for byte" % (label, card, got["serial"]["seconds"],
                         got["serial"]["peak_bytes"], default,
                         got["in_flight"]["seconds"],
                         got["in_flight"]["peak_bytes"]))
    for name in ("serial", "in_flight"):
        print("%s in-flight queue, %s: host seconds in %s" % (
            label, name, "; ".join(
                ", ".join("%s %.4f" % (k, v) for k, v in run.items())
                for run in got[name]["spans"])))
    return got


def band_radius_rows():
    """``band_radius_stats.run()`` at its defaults (host work only) and
    its seconds: run in a worker process while the card works."""
    from biseqt_tpu_torch.experiments import band_radius_stats

    t0 = time.perf_counter()
    rows = band_radius_stats.run()
    return rows, time.perf_counter() - t0


def experiments_phase(dev, card, band_rows, ibb_row):
    """Phase 15: the ported experiments at their scripts' default
    configs on the card, each held to the JAX package's CPU run of the
    same config (``*_JAX_CPU``), one line each with the card.
    ``index_build_bench`` ran in phase 13; its row is ``ibb_row``."""
    import numpy as np

    from biseqt_tpu_torch.experiments import (genome_homology,
                                              multiple_homology,
                                              wordblot_recall)
    from biseqt_tpu_torch.ops import dp_ad, walk

    t_phase = time.perf_counter()
    secs = {}
    rows, secs["band_radius_stats"] = band_rows.get(timeout=600)
    got = [(r["K"], r["g"], r["radius"], r["containment_endpoint"],
            r["containment_sup"]) for r in rows]
    if got != BAND_RADIUS_JAX_CPU:
        fail("band_radius_stats: %s, the JAX package's CPU run %s"
             % (got, BAND_RADIUS_JAX_CPU))
    print("experiment band_radius_stats (%s): %d rows (K, g) == the JAX"
          " package's CPU run; endpoint containment %s; %r s on the host"
          % (card, len(rows), [float(r[3]) for r in got],
             secs["band_radius_stats"]))

    t0 = time.perf_counter()
    rows = wordblot_recall.run_sweep(device=dev)
    secs["wordblot_recall"] = time.perf_counter() - t0
    want = WORDBLOT_JAX_CPU
    sweep = [(r["p_min"], r["recall_at_k"], r["precision"])
             for r in rows[1:]]
    mae = [r["p_hat_mae"] for r in rows[1:]]
    if (rows[0]["index_memory"] != want["index_memory"]
            or sweep != [w[:3] for w in want["sweep"]]
            or not np.allclose(mae, [w[3] for w in want["sweep"]],
                               **DISCOVERY_TOL)):
        fail("wordblot_recall: %s, the JAX package's CPU run %s"
             % (rows, want))
    print("experiment wordblot_recall (%s): 3 trials of 100 kbp pairs,"
          " (p_min, recall@k, precision) %s, p-hat MAE %s == the JAX"
          " package's CPU run; %d seeds, %.1f B a seed; %r s"
          % (card, sweep, mae, rows[0]["index_memory"]["n_seeds"],
             rows[0]["index_memory"]["seed_bytes_per_seed"],
             secs["wordblot_recall"]))

    t0 = time.perf_counter()
    row = multiple_homology.run(device=dev)
    secs["multiple_homology"] = time.perf_counter() - t0
    ps = row.pop("ps")
    untimed = {k: v for k, v in row.items() if not k.endswith("_s")}
    want = dict(NWAY_JAX_CPU)
    if untimed != {k: v for k, v in want.items() if k != "ps"} or not \
            np.allclose(ps, want["ps"], rtol=0, atol=1e-3):
        fail("multiple_homology: %s %s, the JAX package's CPU run %s"
             % (row, ps, want))
    print("experiment multiple_homology (%s): %s, ps %s == the JAX"
          " package's CPU run; %r s" % (card, json.dumps(row), ps,
                                        secs["multiple_homology"]))

    print("experiment index_build_bench (%s): %s (phase 13)"
          % (card, json.dumps(ibb_row)))

    g = GENOME_RUN
    dp_ad.LAUNCHES = 0
    walk.LAUNCHES = 0
    t0 = time.perf_counter()
    row = genome_homology.run_once(g["seed"], g["size"], g["n_blocks"],
                                   g["wordlen"], transcripts=True,
                                   device=dev)
    secs["genome_homology"] = time.perf_counter() - t0
    launches = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    if not launches["dp_ad"] or launches["dp_ad"] != launches["walk"]:
        fail("genome_homology.run_once: launches %s, not one walk a DP"
             " launch" % launches)
    untimed = {k: v for k, v in row.items() if not k.startswith("t_")
               and k != "extend_gcups"}
    want, tol = GENOME_JAX_CPU, GENOME_TX_TOL
    exact = {k: v for k, v in untimed.items() if k not in tol}
    if exact != {k: v for k, v in want.items() if k not in tol} or not (
            abs(row["tx_total_ops"] - want["tx_total_ops"])
            <= tol["tx_total_ops"] * want["tx_total_ops"]
            and abs(row["tx_match_frac"] - want["tx_match_frac"])
            <= tol["tx_match_frac"]):
        fail("genome_homology: %s, the JAX package's CPU run %s"
             % (untimed, want))
    print("experiment genome_homology (%s): %s == the JAX package's CPU"
          " run (untimed fields; transcript ops %d against %d, within rtol"
          " %g); launches %s; %r s"
          % (card, json.dumps(row), row["tx_total_ops"],
             want["tx_total_ops"], tol["tx_total_ops"], launches,
             secs["genome_homology"]))
    phase_s = time.perf_counter() - t_phase
    print("phase 15: %.1f s" % phase_s)
    return {"seconds": secs, "phase_seconds": phase_s,
            "launches": launches}


def sharded_phase(dev, card, core, mut, phase6, recall_reads):
    """Phase 16: the band-sharded engines (``parallel.sharded_dp``,
    ``parallel.sharded_dp_ad``) and the checkpointed sweep
    (``parallel.sweep``) on the card, on a world-of-one mesh (one card:
    the band axis has size 1, so no halo is exchanged).  (a) Phase 6's
    100 kbp pair: the traceback in B_LOCAL (halo 64, checkpoints every 8
    chunks) gives phase 6's native and row-kernel score exactly and a
    transcript that rescores to it; on the first TWIN_PREFIX letters the
    card equals the CPU (scores, checkpoints, transcript); both score
    engines in B_GLOBAL give phase 6's B_GLOBAL score.  (b) A planted
    20 kbp pair at W 8192: the traceback's score equals the C++ engine's
    (``pw.Aligner(backend="native")``), its transcript rescores.  (c)
    The sweep over phase 13's recall reads, stopped after 8 of its 16
    blocks, resumed, one block deleted and resumed again: bit for bit
    the same, and equal to one ``overlap_stats_block`` call (integer
    fields exactly, p and s0 within STATS_TOL)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from biseqt_tpu_torch import profiling, pw
    from biseqt_tpu_torch.parallel import (band_sharded_ad_traceback,
                                           banded_dp_band_sharded,
                                           banded_dp_band_sharded_ad,
                                           checkpointed_overlap_sweep,
                                           make_mesh)
    from biseqt_tpu_torch.parallel.allvsall import overlap_stats_block
    from biseqt_tpu_torch.parallel.sharded_dp_ad import _run_band_sharded_ad
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    t_phase = time.perf_counter()
    sh = SHARDED
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    mesh = make_mesh(device=dev)
    print("phase 16: mesh %s (one card: the band axis has size %d, no halo"
          " is exchanged)" % (mesh, mesh.shape["band"]))
    record = {"card": card, "calls": {}}

    def layout(n_diag_lo, n_diag_hi):
        """The Aligner's layout of the band (lo, hi) for the antidiagonal
        kernel: W, dmin (the top W - 1 lanes' start) and w_eff."""
        w_req = n_diag_hi - n_diag_lo + 1
        W = pw._bucket(w_req + 1, mini=128)
        return W, n_diag_hi - W + 1, w_req

    def timed(label, fn, steps, unit, cells):
        """``fn()`` on the host clock, synchronised, with the allocator's
        peak above what was held and the traceback's spans (the forward
        pass, the window re-solves with their copies to the host, the
        host walk)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        before = profiling.counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
        spans = {}
        for name, v in profiling.counters().items():
            was = before.get(name, {"seconds": 0.0, "calls": 0})
            if name.startswith("sharded.") and v["calls"] > was["calls"]:
                spans[name] = dict(seconds=v["seconds"] - was["seconds"],
                                   calls=v["calls"] - was["calls"])
        record["calls"][label] = dict(
            wall_s=wall, steps=steps, unit=unit, us_per_step=wall * 1e6 / steps,
            band_cells=cells, cells_per_s=cells / wall, peak_bytes=peak,
            spans=spans)
        print("%s (%s): %.3f s, %d %ss, %.2f us a %s, %.4g band cells/s,"
              " peak %.1f MB allocated%s"
              % (label, card, wall, steps, unit, wall * 1e6 / steps, unit,
                 cells / wall, peak / 1e6,
                 "".join("; %s %.3f s (%d calls)" % (k[8:], v["seconds"],
                                                     v["calls"])
                         for k, v in sorted(spans.items()))))
        return out

    def pair_args(s, t):
        return (s[None, :], t[None, :], np.asarray([len(s)], np.int32),
                np.asarray([len(t)], np.int32))

    def check_transcript(label, ops, si, sj, s, t, want):
        got, letters_ok = rescore(np, ops, s, t, si, sj, subst)
        if got != want or not letters_ok:
            fail("%s: the transcript rescores to %r (letters agree: %s),"
                 " not %r" % (label, got, letters_ok, want))
        return got

    # (a) phase 6's 100 kbp pair
    W, dmin, w_eff = layout(*PAIR_BAND)
    args = pair_args(core, mut)
    cells = len(core) * w_eff
    kw = dict(W=W, subst=subst, go=GO, ge=GE, w_eff=[w_eff], mesh=mesh,
              device=dev)
    local = dict(kw, flags=pw._FLAGS[pw.B_LOCAL], halo=sh["halo"])
    want_local = phase6["dna %s" % pw.B_LOCAL]
    steps = len(core) + len(mut) + 1
    # warm-up on a short prefix: the first CUDA graphs, allocator pools
    band_sharded_ad_traceback(core[:2000][None, :], mut[:2000][None, :],
                              [2000], [2000], [dmin], ckpt_chunks=2, **local)
    scores, tx = timed("band_sharded_ad_traceback B_LOCAL 100 kbp",
                       lambda: band_sharded_ad_traceback(
                           *args, [dmin], ckpt_chunks=sh["ckpt_chunks"],
                           **local), steps, "antidiagonal step", cells)
    got = float(scores[0])
    if not (got == want_local["native"] == want_local["row"]):
        fail("band-sharded traceback B_LOCAL score %r, phase 6's native %r"
             " and row kernel %r" % (got, want_local["native"],
                                     want_local["row"]))
    ops, si, sj = tx[0]
    check_transcript("band-sharded traceback B_LOCAL", ops, si, sj, core,
                     mut, got)
    print("band-sharded traceback B_LOCAL: score %r == phase 6's native and"
          " row kernel; %d ops from (%d, %d) rescore exactly"
          % (got, len(ops), si, sj))
    want_global = phase6["dna %s" % pw.B_GLOBAL]
    glob = dict(kw, flags=pw._FLAGS[pw.B_GLOBAL])
    ad = timed("banded_dp_band_sharded_ad B_GLOBAL 100 kbp",
               lambda: banded_dp_band_sharded_ad(*args, [dmin],
                                                 halo=sh["halo"], **glob),
               steps, "antidiagonal step", cells)
    # the row engine lays the band out as the row kernel does
    row = timed("banded_dp_band_sharded B_GLOBAL 100 kbp",
                lambda: banded_dp_band_sharded(*args, [dmin], **glob),
                len(core), "row", cells)
    got_ad, got_row = float(ad[0]), float(row[0])
    if not (got_ad == got_row == want_global["native"]
            == want_global["row"]):
        fail("band-sharded B_GLOBAL scores: antidiagonal %r, row %r; phase"
             " 6's native %r, row kernel %r" % (got_ad, got_row,
                                               want_global["native"],
                                               want_global["row"]))
    print("band-sharded B_GLOBAL: antidiagonal engine %r, row engine %r =="
          " phase 6's native and row kernel" % (got_ad, got_row))

    # the card against the CPU on the first TWIN_PREFIX letters
    n = TWIN_PREFIX
    pre = pair_args(core[:n], mut[:n])
    cpu_mesh = make_mesh(device="cpu")
    on = []
    for where, m in ((dev, mesh), (torch.device("cpu"), cpu_mesh)):
        pkw = dict(local, mesh=m, device=where)
        t0 = time.perf_counter()
        fwd = _run_band_sharded_ad(*pre, [dmin], ckpt_every=sh["ckpt_chunks"],
                                   **pkw)
        tb = band_sharded_ad_traceback(*pre, [dmin],
                                       ckpt_chunks=sh["ckpt_chunks"], **pkw)
        on.append(([x.cpu() for x in fwd], tb, time.perf_counter() - t0))
    (f_card, tb_card, s_card), (f_cpu, tb_cpu, s_cpu) = on
    names = ("scores", "Me", "Mo", "Ae", "Ao", "checkpoints")
    for name, a, b in zip(names, f_card, f_cpu):
        if not torch.equal(a, b):
            fail("band-sharded forward on the first %d letters: %s on the"
                 " card differs from the CPU" % (n, name))
    if not (np.array_equal(tb_card[0], tb_cpu[0]) and tb_card[1] == tb_cpu[1]):
        fail("band-sharded traceback on the first %d letters: the card gives"
             " %r, the CPU %r" % (n, tb_card, tb_cpu))
    check_transcript("band-sharded traceback, first %d letters" % n,
                     *tb_card[1][0], core[:n], mut[:n], float(tb_card[0][0]))
    print("band-sharded B_LOCAL on the first %d letters: card == CPU (scores,"
          " trackers, %d checkpoints, transcript of %d ops, score %r);"
          " card %.1f s, CPU %.1f s (forward with checkpoints + traceback)"
          % (n, f_card[5].shape[0], len(tb_card[1][0][0]),
             float(tb_card[0][0]), s_card, s_cpu))

    # (b) a planted pair in a band wider than the kernels' 4096 lanes
    wr = np.random.default_rng(sh["wide_seed"])
    L = sh["wide_len"]
    ws = wr.integers(0, 4, L).astype(np.int8)
    wt = mutate(np, wr, ws, 4, 0.10, 20, L // 20)
    band = (-sh["wide_band"], sh["wide_band"])
    Ww, wdmin, wweff = layout(*band)
    if Ww != 8192:
        fail("the wide band lays out at W %d, not 8192" % Ww)
    A4 = Alphabet("ACGT")
    with pw.Aligner(Sequence(A4, ws), Sequence(A4, wt),
                    alnmode=pw.BANDED_MODE, alntype=pw.B_LOCAL,
                    diag_range=band, subst_scores=subst, go_score=GO,
                    ge_score=GE, backend="native", device=dev) as aln:
        t0 = time.perf_counter()
        want_wide = aln.solve()
        native_s = time.perf_counter() - t0
    wscores, wtx = timed(
        "band_sharded_ad_traceback B_LOCAL W 8192",
        lambda: band_sharded_ad_traceback(
            *pair_args(ws, wt), [wdmin], W=Ww, subst=subst, go=GO, ge=GE,
            w_eff=[wweff], flags=pw._FLAGS[pw.B_LOCAL], mesh=mesh,
            halo=sh["halo"], ckpt_chunks=sh["ckpt_chunks"], device=dev),
        len(ws) + len(wt) + 1, "antidiagonal step", len(ws) * wweff)
    got_wide = float(wscores[0])
    if got_wide != want_wide:
        fail("band-sharded traceback at W 8192: %r, the C++ engine %r"
             % (got_wide, want_wide))
    wops, wsi, wsj = wtx[0]
    check_transcript("band-sharded traceback at W 8192", wops, wsi, wsj, ws,
                     wt, got_wide)
    print("band-sharded traceback at W %d (band %s, %d x %d): score %r =="
          " native.align's (%.2f s on the host); %d ops rescore exactly"
          % (Ww, band, len(ws), len(wt), got_wide, native_s, len(wops)))

    # (c) the checkpointed sweep over the recall reads
    r_codes, r_lens, _ = recall_reads.get(timeout=300)
    r_codes, r_lens = np.asarray(r_codes), np.asarray(r_lens)
    skw = dict(wordlen=sh["sweep_wordlen"], block=sh["sweep_block"],
               device=dev)
    n_blocks = -(-len(r_codes) // sh["sweep_block"])

    class Stop(Exception):
        pass

    def stop(done, total):
        if done == sh["sweep_stop"]:
            raise Stop

    with tempfile.TemporaryDirectory() as td:
        out_dir = os.path.join(td, "sweep")
        t0 = time.perf_counter()
        try:
            checkpointed_overlap_sweep(r_codes, r_lens, out_dir,
                                       progress=stop, **skw)
            fail("the sweep's progress callback did not stop it")
        except Stop:
            pass
        half_s = time.perf_counter() - t0
        written = sorted(f for f in os.listdir(out_dir)
                         if f.startswith("block_"))
        if len(written) != sh["sweep_stop"]:
            fail("the stopped sweep left %d blocks, not %d"
                 % (len(written), sh["sweep_stop"]))
        t0 = time.perf_counter()
        full = checkpointed_overlap_sweep(r_codes, r_lens, out_dir, **skw)
        rest_s = time.perf_counter() - t0
        os.remove(os.path.join(out_dir, "block_%05d.npz" % 3))
        again = checkpointed_overlap_sweep(r_codes, r_lens, out_dir, **skw)
    for k in full:
        if not np.array_equal(full[k], again[k]):
            fail("the resumed sweep differs from the first in %s" % k)
    t0 = time.perf_counter()
    whole = overlap_stats_block(r_codes, r_lens, r_codes, r_lens,
                                wordlen=sh["sweep_wordlen"], device=dev)
    whole = {k: v.cpu().numpy() for k, v in whole.items()}
    whole_s = time.perf_counter() - t0
    sweep_err = stats_equal(np, full, whole, ("num_seeds", "diag",
                                              "olap_len"),
                            "the sweep against one overlap_stats_block")
    print("checkpointed sweep (%s): %d reads, %d blocks of %d, stopped after"
          " %d (%.2f s), finished (%.2f s), block 3 deleted and resumed: bit"
          " for bit; == one overlap_stats_block (%.2f s; integers exactly,"
          " p/s0 max |d| %.3g)" % (card, len(r_codes), n_blocks,
                                   sh["sweep_block"], sh["sweep_stop"],
                                   half_s, rest_s, whole_s, sweep_err))
    record["sweep"] = dict(reads=len(r_codes), blocks=n_blocks,
                           stopped_s=half_s, finished_s=rest_s,
                           one_block_s=whole_s, max_abs_err=sweep_err)
    phase_s = time.perf_counter() - t_phase
    record["phase_s"] = phase_s
    print("sharded: " + json.dumps(record))
    print("phase 16: %.1f s" % phase_s)


def sharded_alone():
    """Phase 16 alone, on a pair made as phase 6 makes its DNA pair (its
    B_GLOBAL and B_LOCAL scores from the C++ engine, standing in for
    phase 6's) and the recall reads simulated in a worker process:

        python3 -c 'import chip_smoke; chip_smoke.sharded_alone()'
    """
    import numpy as np
    import torch

    from biseqt_tpu_torch import native, pw
    from biseqt_tpu_torch.experiments.overlap_recall import simulate_packed
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        recall_reads = pool.apply_async(simulate_packed, (
            RECALL["seed"], RECALL["genome_len"], RECALL["read_len"],
            RECALL["n_reads"], RECALL["err"]))
        if not native.available():
            fail("the C++ host tier (pwnative.cpp) did not build")
        rng = np.random.default_rng(20261016)
        core = rng.integers(0, 4, PAIR_LEN).astype(np.int8)
        mut = mutate(np, rng, core, 4, 0.10, 40, 1000)
        A4 = Alphabet("ACGT")
        subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
        phase6 = {}
        for alntype in (pw.B_GLOBAL, pw.B_LOCAL):
            with pw.Aligner(Sequence(A4, core), Sequence(A4, mut),
                            alnmode=pw.BANDED_MODE, alntype=alntype,
                            diag_range=PAIR_BAND, subst_scores=subst,
                            go_score=GO, ge_score=GE, backend="native",
                            device=dev) as aln:
                score = aln.solve()
            phase6["dna %s" % alntype] = {"row": score, "native": score}
        sharded_phase(dev, card, core, mut, phase6, recall_reads)
    finally:
        pool.terminate()
        pool.join()
    print(card)


def row_digest(rows):
    """The SHA-1 of every row's ``"<transcript> <origin_start>
    <mutate_start>\\n"``, in order (``ROW_ROUTE_JAX_CPU``'s)."""
    import hashlib

    h = hashlib.sha1()
    for row in rows:
        h.update(("%s %d %d\n" % (row["transcript"], row["origin_start"],
                                  row["mutate_start"])).encode())
    return h.hexdigest()


def row_route_phase(dev, card, S, T, segments, out, narrow, subst):
    """Phase 17: the row route, ``use_pallas=False`` (the row engine over
    the whole band on the card, its direction bytes walked on the host by
    ``native.traceback_batch``), with K1's and the walk's launch counters
    unmoved.  (a) Phase 2's batch: every transcript rescores to its score
    and covers 90% of its block, every score equals phase 2's (the same
    band: w_eff 133 < W - 1), the transcripts that differ are counted;
    the NARROW segments give the CPU's row route byte for byte.  (b) The
    band-filling case: 600.0 on the row route, 9.0 on K1's.  (c)
    ``discover_and_extend`` on a rearranged pair equals the JAX
    package's row route on the CPU exactly (``ROW_ROUTE_JAX_CPU``), and
    K1's route is compared with it."""
    import numpy as np
    import torch

    from biseqt_tpu_torch import pipeline, profiling
    from biseqt_tpu_torch.ops import dp_ad, walk
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    t_phase = time.perf_counter()
    A4 = Alphabet("ACGT")
    kw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True,
              use_pallas=False)
    spans = ("pipeline.launch", "pipeline.finish", "pipeline.compact")
    record = {"card": card}

    def counted(label, fn):
        """``fn()`` on the host clock (ending in a synchronise), with the
        allocator's peak above what was held and the pipeline's spans; K1
        and the walk must not be launched."""
        launches = (dp_ad.LAUNCHES, walk.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        before = profiling.counters()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (dp_ad.LAUNCHES, walk.LAUNCHES) != launches:
            fail("%s: the row route launched K1 or the walk (%s -> %s)"
                 % (label, launches, (dp_ad.LAUNCHES, walk.LAUNCHES)))
        return result, dict(
            seconds=wall,
            peak_bytes=torch.cuda.max_memory_allocated(dev) - held,
            spans=phase_seconds(before, spans))

    # -- (a) phase 2's batch ------------------------------------------------
    pipeline.extend_segments(S, T, segments[:2], device=dev, **kw)  # warm-up
    _, _, cut, launches = pipeline.extension_plan(segments, len(S), len(T),
                                                  True, row=True)
    rows_swept = sum(LS for _, LS, _, _ in launches)
    plane_bytes = sum(len(idxs) * LS * W for idxs, LS, _, W in launches)
    got, a = counted("(a)", lambda: pipeline.extend_segments(
        S, T, segments, device=dev, **kw))
    s_arr, t_arr = S.to_array(), T.to_array()
    short = 0
    for seg in got:
        tx = seg["transcript"]
        score, letters_ok = rescore(np, tx, s_arr, t_arr,
                                    seg["origin_start"], seg["mutate_start"],
                                    subst)
        if score != seg["score"] or not letters_ok:
            fail("row route: transcript of segment %d rescores to %r, score"
                 " %r (letters ok: %s)" % (seg["source_index"], score,
                                          seg["score"], letters_ok))
        if tx.count("M") + tx.count("S") + tx.count("D") < 0.9 * seg[
                "block"][2]:
            short += 1
    if short:
        fail("row route: %d transcripts cover less than 90%% of their block"
             % short)
    if [seg["source_index"] for seg in got] != [
            seg["source_index"] for seg in out]:
        fail("row route: rows differ from phase 2's")
    score_diff = sum(g["score"] != k["score"] for g, k in zip(got, out))
    tx_diff = sum((g["transcript"], g["origin_start"], g["mutate_start"])
                  != (k["transcript"], k["origin_start"], k["mutate_start"])
                  for g, k in zip(got, out))
    if score_diff:
        fail("row route: %d of %d scores differ from phase 2's K1 route on"
             " the same band" % (score_diff, len(got)))
    record["batch"] = dict(
        launches=len(launches), segments=len(got), rows_swept=rows_swept,
        us_a_row=a["seconds"] / rows_swept * 1e6, plane_bytes=plane_bytes,
        scores_differ=score_diff, transcripts_differ=tx_diff, **a)
    print("row route (a), %s: %d segments in %d launch(es) (LS %s, W %s),"
          " %.3f s end to end, %d DP rows swept, %.1f us a row, allocator"
          " peak %d bytes, %d plane bytes copied to the host; host seconds"
          " %s; K1 and the walk not launched; every transcript rescores"
          " exactly and covers >= 90%% of its block; scores == phase 2's K1"
          " route (%d differ), transcripts differ on %d of %d"
          % (card, len(got), len(launches),
             sorted({LS for _, LS, _, _ in launches}),
             sorted({W for _, _, _, W in launches}), a["seconds"],
             rows_swept, record["batch"]["us_a_row"], a["peak_bytes"],
             plane_bytes, json.dumps(a["spans"]), score_diff, tx_diff,
             len(got)))
    narrow_card, n = counted("(a) narrow", lambda: pipeline.extend_segments(
        S, T, segments[:NARROW], device=dev, **kw))
    t0 = time.perf_counter()
    narrow_cpu = pipeline.extend_segments(S, T, segments[:NARROW],
                                          device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    if narrow_card != narrow_cpu:
        fail("row route: the NARROW segments on the card differ from the"
             " CPU's row route")
    record["narrow"] = dict(card_s=n["seconds"], cpu_s=cpu_s)
    print("row route (a), the %d NARROW segments: card == CPU byte for byte"
          " (card %.3f s, CPU %.3f s); %d transcripts differ from phase 2's"
          % (NARROW, n["seconds"], cpu_s, sum(
              g != k for g, k in zip(narrow_card, narrow))))

    # -- (b) the band-filling case -------------------------------------------
    bf = BAND_FILL
    Sb = Sequence(A4, np.random.default_rng(bf["seed"]).integers(
        0, 4, bf["length"]).astype(np.int8))
    seg = [{"segment": bf["segment"]}]
    (bw,) = {W for _, _, _, W in pipeline.plan_launches(
        [pipeline.cut_segment(seg[0], len(Sb), len(Sb))], True, row=True)}
    row_b, _ = counted("(b)", lambda: pipeline.extend_segments(
        Sb, Sb, seg, device=dev, **kw))
    k1_b = pipeline.extend_segments(Sb, Sb, seg, subst=subst, go_score=GO,
                                    ge_score=GE, with_transcripts=True,
                                    device=dev)
    if (row_b[0]["score"], k1_b[0]["score"]) != (bf["row_score"],
                                                 bf["k1_score"]) or \
            row_b[0]["transcript"] != "M" * bf["length"]:
        fail("band-filling case: row route %r, K1 route %r; expected %r and"
             " %r" % (row_b[0]["score"], k1_b[0]["score"], bf["row_score"],
                      bf["k1_score"]))
    print("row route (b), the band-filling case (W %d, the identity on the"
          " band's lowest diagonal): row route %r (transcript M x %d), K1"
          " route %r" % (bw, row_b[0]["score"], bf["length"],
                         k1_b[0]["score"]))
    record["band_fill"] = dict(W=bw, row=row_b[0]["score"],
                               k1=k1_b[0]["score"])

    # -- (c) discover_and_extend on a rearranged pair -------------------------
    rr = ROW_ROUTE
    a_codes, b_codes, _ = rearranged_pair(
        np, np.random.default_rng(rr["seed"]), rr["size"], rr["blocks"],
        GENOME["sub"], GENOME["gap"])
    Sg, Tg = Sequence(A4, a_codes), Sequence(A4, b_codes)
    dkw = dict(wordlen=rr["wordlen"], g_max=rr["g_max"], p_min=rr["p_min"],
               K_min=rr["size"] // rr["blocks"] // 8, subst=subst,
               go_score=GO, ge_score=GE, with_transcripts=True, device=dev)
    found, c = counted("(c)", lambda: pipeline.discover_and_extend(
        Sg, Tg, use_pallas=False, **dkw))
    want = ROW_ROUTE_JAX_CPU
    gotc = dict(n_segments=len(found), scores=[r["score"] for r in found],
                tx_total_ops=sum(len(r["transcript"]) for r in found),
                sha1=row_digest(found))
    if gotc != want:
        fail("row route (c): %s, the JAX package's CPU run %s"
             % (gotc, want))
    segs = [{"segment": r["segment"]} for r in found]
    c_launches = pipeline.extension_plan(segs, len(Sg), len(Tg), True,
                                         row=True)[3]
    c_rows = sum(LS for _, LS, _, _ in c_launches)
    t0 = time.perf_counter()
    k1 = pipeline.discover_and_extend(Sg, Tg, use_pallas=None, **dkw)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    by_source = {r["source_index"]: r for r in k1}
    if sorted(by_source) != sorted(r["source_index"] for r in found):
        fail("row route (c): K1's route extended other segments")
    key = lambda r: (r["transcript"], r["origin_start"], r["mutate_start"])
    differ = [r for r in found if key(r) != key(by_source[r["source_index"]])]
    k1_ops = sum(len(r["transcript"]) for r in k1)
    k1_m = sum(r["transcript"].count("M") for r in k1)
    row_m = sum(r["transcript"].count("M") for r in found)
    record["rearranged"] = dict(
        rows_swept=c_rows, launches=len(c_launches),
        us_a_row=c["seconds"] / c_rows * 1e6, k1_seconds=k1_s,
        transcripts_differ=len(differ),
        scores_differ=sum(r["score"] != by_source[r["source_index"]]["score"]
                          for r in found),
        tx_total_ops=gotc["tx_total_ops"], k1_tx_total_ops=k1_ops,
        matches=row_m, k1_matches=k1_m, **c)
    print("row route (c), %s: discover_and_extend(use_pallas=False) on %d +"
          " %d bp (%d blocks) == the JAX package's CPU row route exactly"
          " (%d rows, scores %s, %d transcript ops, SHA-1 %s); %.3f s, %d"
          " launch(es), %d DP rows swept, %.1f us a row, peak %d bytes; K1's"
          " route (use_pallas=None, %.3f s): %d of %d transcripts differ,"
          " scores differ on %d, transcript ops %d against %d, M ops %d"
          " against %d" % (
              card, len(Sg), len(Tg), rr["blocks"], len(found),
              gotc["scores"], gotc["tx_total_ops"], gotc["sha1"],
              c["seconds"], len(c_launches), c_rows,
              record["rearranged"]["us_a_row"], c["peak_bytes"], k1_s,
              len(differ), len(found), record["rearranged"]["scores_differ"],
              k1_ops, gotc["tx_total_ops"], k1_m, row_m))
    phase_s = time.perf_counter() - t_phase
    record["phase_s"] = phase_s
    print("row route: " + json.dumps(record))
    print("phase 17: %.1f s" % phase_s)
    return record


def row_route_alone():
    """Phase 17 alone, after phase 2's main path (the smoke's batch
    planted and extended on K1's route, counted as phase 2 counts it):

        python3 -c 'import chip_smoke; chip_smoke.row_route_alone()'
    """
    import numpy as np
    import torch

    from biseqt_tpu_torch import native, pipeline
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    if not native.available():
        fail("the C++ host tier (pwnative.cpp) did not build")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    rng = np.random.default_rng(20261016)
    S, T, segments = plant(np, rng, Alphabet("ACGT"), Sequence)
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    kw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True,
              device=dev)
    out = pipeline.extend_segments(S, T, segments, **kw)
    narrow = pipeline.extend_segments(S, T, segments[:NARROW], **kw)
    row_route_phase(dev, card, S, T, segments, out, narrow, subst)
    print(card)


def genome_row_route():
    """The genome experiment's config (``GENOME_RUN``: 2 x 2 Mbp, 8
    blocks, word length 12, with transcripts) extended on the card on the
    row route (``use_pallas=False``) and on K1's (``None``), each row of
    ``genome_homology.run_once`` held to the JAX package's CPU run
    (``GENOME_JAX_CPU``, whose extension is the JAX row route): the row
    route must equal it exactly, and the count of transcripts the two
    routes give differently says whether the route accounts for
    ``GENOME_TX_TOL``.  Not a phase of the smoke (~5 min on the card, the
    row route's 1.57 M rows):

        python3 -c 'import chip_smoke; chip_smoke.genome_row_route()'
    """
    import numpy as np
    import torch

    from biseqt_tpu_torch import pipeline
    from biseqt_tpu_torch.blot import WordBlot
    from biseqt_tpu_torch.experiments.genome_homology import (
        block_recall, rearranged_pair)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    g = GENOME_RUN
    # run_once's steps, its extension's route chosen here
    A, B, truth = rearranged_pair(np.random.default_rng(g["seed"]),
                                  g["size"], n_blocks=g["n_blocks"])
    wb = WordBlot(A, B, wordlen=g["wordlen"], g_max=0.1, device=dev)
    segs = list(wb.similar_segments(
        K_min=max(g["size"] // g["n_blocks"] // 8, 200), p_min=0.6))
    got = {}
    for route, use_pallas in (("row", False), ("k1", None)):
        t0 = time.perf_counter()
        ext = pipeline.extend_segments(A, B, segs, use_pallas=use_pallas,
                                       with_transcripts=True, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        txs = [s["transcript"] for s in ext]
        n_ops = sum(len(t) for t in txs)
        row = dict(size=g["size"], n_blocks=g["n_blocks"],
                   n_segments=len(ext), block_recall=block_recall(ext, truth),
                   seeds=len(wb.seed_index),
                   extended_cells=sum(s["band_cells"] for s in ext),
                   tx_total_ops=n_ops,
                   tx_match_frac=round(sum(t.count("M") for t in txs)
                                       / max(n_ops, 1), 4),
                   n_discovered=len({s["source_index"] for s in ext}))
        got[route] = (ext, row, seconds)
        print("genome row route check, %s route (%s): %s, %.3f s; the JAX"
              " package's CPU run %s" % (route, card, json.dumps(row),
                                         seconds, json.dumps(GENOME_JAX_CPU)))
    key = lambda s: (s["transcript"], s["origin_start"], s["mutate_start"])
    differ = sum(key(a) != key(b) for a, b in zip(got["row"][0],
                                                  got["k1"][0]))
    print("genome row route check: %d of %d transcripts differ between the"
          " routes; the row route %s the JAX package's CPU run"
          % (differ, len(got["row"][0]),
             "equals" if got["row"][1] == GENOME_JAX_CPU else "differs from"))
    if got["row"][1] != GENOME_JAX_CPU:
        fail("the row route at the genome config: %s, the JAX package's CPU"
             " run %s" % (got["row"][1], GENOME_JAX_CPU))


def band_cells(np, s_lens, t_lens, d_lo, d_hi):
    """Cells of each pair's matrix (1 <= i <= s_len, 1 <= j <= t_len) on
    the diagonals d = i - j in [d_lo, d_hi], summed over the pairs."""
    total = 0
    for ls, lt, lo, hi in zip(s_lens, t_lens, d_lo, d_hi):
        d = np.arange(int(lo), int(hi) + 1)
        total += int(np.clip(np.minimum(ls, lt + d) - np.maximum(1, 1 + d)
                             + 1, 0, None).sum())
    return total


def packed(np, seqs):
    """int8 [len(seqs), longest] rows (zero-padded) and int32 lengths."""
    out = np.zeros((len(seqs), max(len(x) for x in seqs)), np.int8)
    for b, x in enumerate(seqs):
        out[b, :len(x)] = x
    return out, np.array([len(x) for x in seqs], np.int32)


def dp_ad_equal(torch, got, want, dmin, w_eff, W):
    """K1's outputs against its twin's: scores, end cells, and the dirs
    plane on its live slots."""
    from biseqt_tpu_torch.ops import dp_ad

    if not (torch.equal(got.score, want.score)
            and torch.equal(got.end_i, want.end_i)
            and torch.equal(got.end_j, want.end_j)):
        return False
    lo, hi = dp_ad.live_nibbles(dmin, w_eff, W)
    bad = (((got.dirs ^ want.dirs) & 15).ne(0) & lo).sum() \
        + (((got.dirs ^ want.dirs) >> 4).ne(0) & hi).sum()
    return int(bad) == 0


def wide_kernels(dev, card, rng, subst, W):
    """Phase 18 (i) at one W: K1 and K4 against their twins (exactly),
    timed beside their bounds.  Returns their records."""
    import numpy as np
    import torch

    from biseqt_tpu_torch.ops import dp_ad, dp_row
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags
    from biseqt_tpu_torch.profiling import FP32_OPS_PER_S, bound_ms, cuda_ms

    local = ModeFlags(local_start=True, local_end=True)
    rec = {}
    # -- K1: pair 0's band spans every lane, pairs 1 and 2 run along the
    # lanes where blocks 0 and 1, and the last two, meet
    blocks, lpt, held = dp_ad.cluster(W, device=dev)
    Wb = W // blocks
    n = WIDE_K1["length"]
    cores = rng.integers(0, 4, (3, n)).astype(np.int8)
    muts = [mutate(np, rng, c, 4, 0.10, 6, n // 10) for c in cores]
    t0 = rng.integers(0, 4, max(n + 64, W - n + 64)).astype(np.int8)
    off = (len(t0) - len(muts[0])) // 2
    t0[off:off + len(muts[0])] = muts[0]
    s_codes, s_lens = packed(np, list(cores))
    t_codes, t_lens = packed(np, [t0, muts[1], muts[2]])
    d0 = int(np.clip(-off - W // 2, -len(t0), n - W + 1))
    dmin = np.array([d0, -Wb, -(blocks - 1) * Wb], np.int32)
    w_eff = np.full(3, W - 1, np.int32)
    on = [torch.as_tensor(x, device=dev)
          for x in (s_codes, t_codes, s_lens, t_lens, dmin)]
    kw = dict(W=W, subst=subst, go=GO, ge=GE, flags=local,
              w_eff=torch.as_tensor(w_eff, device=dev), device=dev)
    got = dp_ad.banded_dp_ad(*on, with_dirs=True, **kw)
    score_only = dp_ad.banded_dp_ad(*on, **kw)
    t_plain = time.perf_counter()
    want = dp_ad.banded_dp_ad_reference(*on, with_dirs=True, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    if not (dp_ad_equal(torch, got, want, on[4], kw["w_eff"], W)
            and torch.equal(score_only.score, want.score)):
        fail("dp_ad at W %d differs from its plain twin (max |d score| %r)"
             % (W, float((got.score - want.score).abs().max())))
    # the run-time instance: global mode on the first flag_len letters of
    # pairs 1 and 2
    m = WIDE_K1["flag_len"]
    gon = [on[0][1:, :m].contiguous(), on[1][1:, :m].contiguous(),
           torch.full((2,), m, dtype=torch.int32, device=dev),
           torch.full((2,), m, dtype=torch.int32, device=dev), on[4][1:]]
    gkw = dict(kw, flags=ModeFlags(), w_eff=kw["w_eff"][1:])
    ggot = dp_ad.banded_dp_ad(*gon, with_dirs=True, **gkw)
    gwant = dp_ad.banded_dp_ad_reference(*gon, with_dirs=True, **gkw)
    if not dp_ad_equal(torch, ggot, gwant, gon[4], gkw["w_eff"], W):
        fail("dp_ad at W %d in global mode differs from its plain twin" % W)
    ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*on, with_dirs=True, **kw), 2)
    score_ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*on, **kw), 2)
    cells = band_cells(np, s_lens, t_lens, dmin + W - (W - 1), dmin + W - 1)
    bound = bound_ms(nbytes(*on, kw["w_eff"], subst, *got),
                     DP_AD_OPS_PER_CELL * cells, FP32_OPS_PER_S)
    rec["dp_ad"] = dict(W=W, blocks=blocks, lanes_per_thread=lpt,
                        clusters_held=held, ms=ms, score_ms=score_ms,
                        plain_ms=plain_ms, max_abs_err=0.0, cells=cells,
                        bound_ms=bound[0], bound_by=bound[1],
                        share=bound[0] / ms, scores=got.score.tolist())
    print("dp_ad at W %d (%s): a cluster of %d blocks (%d lanes a thread,"
          " %d clusters at once), 3 pairs of %d x %s; == plain twin (local"
          " with and without dirs, global on 2 x %d); kernel %.3f ms with"
          " dirs, %.3f ms scores only, plain %.0f ms; %d band cells, bound"
          " %.4f ms (%s), %.1f%% of it; scores %s"
          % (W, card, blocks, lpt, held, n, t_lens.tolist(), m, ms,
             score_ms, plain_ms, cells, bound[0], bound[1],
             100 * bound[0] / ms, got.score.tolist()))
    del got, want, score_only, ggot, gwant

    # -- K4: pair 0 spans every lane, pairs 1 and 2 run along the lanes
    # where the cluster's first two blocks, and its last two, meet
    rows = WIDE_K4_ROWS
    geo = dp_row.plan(3, W, True, sms=dp_row.sm_count(dev))
    per_block = geo.threads(W) * geo.lpt
    cores = rng.integers(0, 4, (3, rows)).astype(np.int8)
    muts = [mutate(np, rng, c, 4, 0.10, 4, rows // 10) for c in cores]
    t0 = rng.integers(0, 4, W - rows + 64).astype(np.int8)
    off = (len(t0) - len(muts[0])) // 2
    t0[off:off + len(muts[0])] = muts[0]
    s_codes, s_lens = packed(np, list(cores))
    t_codes, t_lens = packed(np, [t0, muts[1], muts[2]])
    dmax = np.array([rows - 32, per_block, (geo.cluster - 1) * per_block],
                    np.int32)
    on = [torch.as_tensor(x, device=dev)
          for x in (s_codes, t_codes, s_lens, t_lens, dmax - W + 1)]
    kw = dict(W=W, subst=subst, go=GO, ge=GE, flags=local, device=dev)
    got = dp_row.banded_dp_row(*on, with_dirs=True, **kw)
    score_only = dp_row.banded_dp_row(*on, **kw)
    t_plain = time.perf_counter()
    want = dp_row.banded_dp_row_reference(*on, with_dirs=True, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    if not (all(torch.equal(a, b) for a, b in zip(got, want))
            and torch.equal(score_only.score, want.score)):
        fail("dp_row at W %d differs from its plain twin (max |d score| %r)"
             % (W, float((got.score - want.score).abs().max())))
    ms = cuda_ms(lambda: dp_row.banded_dp_row(*on, with_dirs=True, **kw), 2)
    score_ms = cuda_ms(lambda: dp_row.banded_dp_row(*on, **kw), 2)
    cells = band_cells(np, s_lens, t_lens, dmax - W + 1, dmax)
    bound = bound_ms(nbytes(*on, subst, *got), DP_ROW_OPS_PER_CELL * cells,
                     FP32_OPS_PER_S)
    held = dp_row.clusters(W, device=dev)
    rec["dp_row"] = dict(W=W, blocks=geo.cluster, lanes_per_thread=geo.lpt,
                         threads=geo.threads(W), clusters_held=held, ms=ms,
                         score_ms=score_ms, plain_ms=plain_ms,
                         max_abs_err=0.0, cells=cells, bound_ms=bound[0],
                         bound_by=bound[1], share=bound[0] / ms,
                         scores=got.score.tolist())
    print("dp_row at W %d (%s): a cluster of %d blocks of %d threads (%d"
          " clusters at once), 3 pairs of %d rows x %s; == plain twin"
          " (local with and without dirs, the whole plane); kernel %.3f ms"
          " with dirs, %.3f ms scores only, plain %.0f ms; %d band cells,"
          " bound %.4f ms (%s), %.1f%% of it; scores %s"
          % (W, card, geo.cluster, geo.threads(W), held, rows,
             t_lens.tolist(), ms, score_ms, plain_ms, cells, bound[0],
             bound[1], 100 * bound[0] / ms, got.score.tolist()))
    return rec


class _TwinCalls:
    """Counts the plain twins' calls while it is entered (the kernels'
    wrappers must never reach them on a card)."""

    def __enter__(self):
        from biseqt_tpu_torch.ops import dp_ad, dp_row, walk

        self.calls = 0
        self.saved = [(m, name, getattr(m, name)) for m, name in (
            (dp_ad, "_sweep_plain"), (dp_row, "_sweep_plain"),
            (walk, "_walk_plain"))]
        for m, name, real in self.saved:
            def counted(*a, _real=real, **k):
                self.calls += 1
                return _real(*a, **k)
            setattr(m, name, counted)
        return self

    def __exit__(self, *exc):
        for m, name, real in self.saved:
            setattr(m, name, real)
        return False


def wide_phase(dev, card, dna_pair):
    """Phase 18: bands above 4096 lanes (see ``WIDE_WS``).  Returns the
    kernels' records at each W and the paths' counts."""
    import numpy as np
    import torch

    from biseqt_tpu_torch import pipeline, pw
    from biseqt_tpu_torch.ops import dp_ad, dp_row, walk
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    t_phase = time.perf_counter()
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    rng = np.random.default_rng(WIDE_EXTENSION["seed"])
    A4 = Alphabet("ACGT")
    record = {"dp_ad": [], "dp_row": []}

    # -- (i) the kernels against their twins at every W
    for W in WIDE_WS:
        rec = wide_kernels(dev, card, rng, subst, W)
        for name in record:
            record[name].append(rec[name])
        torch.cuda.empty_cache()
    t_kernels = time.perf_counter() - t_phase

    # -- (ii) a wide extension: the homologous block carries an insertion
    cfg = WIDE_EXTENSION
    i0, j0 = cfg["block_at"]
    blk, ins = cfg["block"], cfg["insertion"]
    s_arr = rng.integers(0, 4, cfg["size"]).astype(np.int8)
    core = s_arr[i0:i0 + blk].copy()
    hit = rng.random(blk) < cfg["sub"]
    core[hit] = (core[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    t_arr = rng.integers(0, 4, cfg["size"]).astype(np.int8)
    t_arr[j0:j0 + blk // 2] = core[:blk // 2]
    t_arr[j0 + blk // 2 + ins:j0 + blk + ins] = core[blk // 2:]
    S, T = Sequence(A4, s_arr), Sequence(A4, t_arr)
    seg = {"segment": ((i0 - j0 - ins, i0 - j0),
                       (i0 + j0, i0 + blk + j0 + blk + ins))}
    _, _, cut, launches = pipeline.extension_plan([seg], len(S), len(T),
                                                  True)
    widths = sorted({launch[3] for launch in launches})
    ekw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True,
               device=dev)
    dp_ad.LAUNCHES = walk.LAUNCHES = 0
    with _TwinCalls() as twins:
        t0 = time.perf_counter()
        out = pipeline.extend_segments(S, T, [seg], **ekw)
        ext_s = time.perf_counter() - t0
    counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    if counts != {"dp_ad": len(launches), "walk": len(launches)} \
            or twins.calls or min(widths) < 6144:
        fail("wide extension: W %s, %d launches planned, %s counted, %d"
             " twin calls" % (widths, len(launches), counts, twins.calls))
    for row in out:
        got, letters_ok = rescore(np, row["transcript"], s_arr, t_arr,
                                  row["origin_start"], row["mutate_start"],
                                  subst)
        if got != row["score"] or not letters_ok:
            fail("wide extension: a transcript rescores to %r, its score"
                 " %r" % (got, row["score"]))
    t0 = time.perf_counter()
    rows_route = pipeline.extend_segments(S, T, [seg], use_pallas=False,
                                          **ekw)
    row_s = time.perf_counter() - t0
    scores = [row["score"] for row in out]
    if scores != [row["score"] for row in rows_route]:
        fail("wide extension: K1's route scores %r, the row route %r"
             % (scores, [row["score"] for row in rows_route]))
    span = max(len(row["transcript"]) for row in out)
    if span < blk:
        fail("wide extension: the longest transcript has %d ops, the block"
             " %d letters" % (span, blk))
    print("wide extension (%s): 2 x %d bp, a %d bp block with a %d bp"
          " insertion in T, segment %s: %d rows in %d launches at W %s,"
          " launches %s, no twin call; %.3f s; scores %s == the row route's"
          " (%.3f s); transcripts rescore exactly, the longest %d ops"
          % (card, cfg["size"], blk, ins, seg["segment"], len(cut),
             len(launches), widths, counts, ext_s, scores, row_s, span))
    record["extension"] = dict(W=widths, launches=counts, seconds=ext_s,
                               row_route_seconds=row_s, scores=scores)

    # -- (iii) the Aligner on phase 6's pair, a 12001-diagonal band
    core, mut = dna_pair
    aligned = {}
    for backend in ("pallas", "pallas_row", "native"):
        n0 = (dp_ad.LAUNCHES, dp_row.LAUNCHES)
        with _TwinCalls() as twins, pw.Aligner(
                Sequence(A4, core), Sequence(A4, mut),
                alnmode=pw.BANDED_MODE, alntype=pw.B_LOCAL,
                diag_range=WIDE_ALIGNER_BAND, subst_scores=subst,
                go_score=GO, ge_score=GE, backend=backend,
                device=dev) as aln:
            t0 = time.perf_counter()
            score = aln.solve()
            seconds = time.perf_counter() - t0
        launched = (dp_ad.LAUNCHES - n0[0], dp_row.LAUNCHES - n0[1])
        want = {"pallas": (1, 0), "pallas_row": (0, 1), "native": (0, 0)}
        if launched != want[backend] or twins.calls:
            fail("wide Aligner %s: launches (K1, K4) %s, %d twin calls"
                 % (backend, launched, twins.calls))
        aligned[backend] = (score, seconds)
    if len({score for score, _ in aligned.values()}) != 1:
        fail("wide Aligner: scores differ: %s" % aligned)
    print("wide Aligner (%s): %d bp pair, diag_range %s (W %d): %s"
          % (card, len(core), WIDE_ALIGNER_BAND,
             pw._bucket(WIDE_ALIGNER_BAND[1] - WIDE_ALIGNER_BAND[0] + 1,
                        mini=128),
             ", ".join("%s %r (%.3f s)" % (b, sc, t)
                       for b, (sc, t) in aligned.items())))
    record["aligner"] = {b: {"score": sc, "seconds": t}
                         for b, (sc, t) in aligned.items()}
    phase_s = time.perf_counter() - t_phase
    record["kernels_s"] = t_kernels
    record["phase_s"] = phase_s
    print("phase 18: %.1f s (the kernels against their twins %.1f s)"
          % (phase_s, t_kernels))
    return record


def probes_phase(card):
    """Phase 19: the four path probes of ``biseqt_tpu_torch.experiments``
    at the JAX scripts' default sizes, each printing its JSON line."""
    from biseqt_tpu_torch.experiments import (adkernel_probe,
                                              pipeline_tx_probe,
                                              txpath_probe, walk_probe)

    t_phase = time.perf_counter()
    out = {}
    for name, module in (("pipeline_tx_probe", pipeline_tx_probe),
                         ("walk_probe", walk_probe),
                         ("adkernel_probe", adkernel_probe),
                         ("txpath_probe", txpath_probe)):
        t0 = time.perf_counter()
        row = module.run()
        row["seconds"] = time.perf_counter() - t0
        print("probe %s (%s): %s" % (name, card, json.dumps(row)))
        out[name] = row
    if not (out["pipeline_tx_probe"]["walks_agree"] is True
            and out["walk_probe"]["mismatches"] == 0
            and out["adkernel_probe"]["parity"] == 0.0):
        fail("a probe failed its check: %s" % json.dumps(out))
    print("phase 19: %.1f s" % (time.perf_counter() - t_phase))
    return out


def wide_alone():
    """Phases 18 and 19 alone, phase 18 (iii) on a pair made as phase 6
    makes its DNA pair:

        python3 -c 'import chip_smoke; chip_smoke.wide_alone()'
    """
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    rng = np.random.default_rng(20261016)
    core = rng.integers(0, 4, PAIR_LEN).astype(np.int8)
    mut = mutate(np, rng, core, 4, 0.10, 40, 1000)
    wide = wide_phase(dev, card, (core, mut))
    probes_phase(card)
    print(json.dumps({k: wide[k] for k in ("dp_ad", "dp_row")}))
    print(card)


def main():
    import torch
def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    import biseqt_tpu_torch  # noqa: F401  (outside the repository: fails)

    from biseqt_tpu_torch.experiments.overlap_recall import simulate_packed

    # host work of the sequential mutation model, in worker processes
    # while phases 1-12 run: phase 13's recall reads (~50 s) and phase
    # 15's band-radius statistics (no device work)
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        recall_reads = pool.apply_async(simulate_packed, (
            RECALL["seed"], RECALL["genome_len"], RECALL["read_len"],
            RECALL["n_reads"], RECALL["err"]))
        band_rows = pool.apply_async(band_radius_rows)
        run(recall_reads, band_rows)
    finally:
        pool.terminate()
        pool.join()


def run(recall_reads, band_rows):
    import numpy as np
    import torch

    from biseqt_tpu_torch import _build, native
    from biseqt_tpu_torch import pipeline, pw
    from biseqt_tpu_torch.experiments import i16_probe, transpose_probe
    from biseqt_tpu_torch.matrices import BLOSUM62, protein_alphabet
    from biseqt_tpu_torch.ops import dp_ad, dp_row, walk
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags, traceback_path
    from biseqt_tpu_torch.profiling import (FP32_OPS_PER_S, INT32_OPS_PER_S,
                                            bound_ms, cuda_ms, cuobjdump_sass,
                                            sass_step_loop)
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels = (("dp_ad", dp_ad), ("walk", walk), ("dp_row", dp_row),
               ("transpose_probe", transpose_probe), ("i16_probe", i16_probe))
    def build(name, module):
        t = time.perf_counter()
        _build.load(name, module._declare)
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        builds = [pool.submit(build, name, module)
                  for name, module in kernels]
        host_tier = pool.submit(native.available)
        build_s = [future.result() for future in builds]
        if not host_tier.result():
            fail("the C++ host tier (pwnative.cpp) did not build")
    for name, _ in kernels:
        function = ""
        for line in _build.build_log(name).splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[1].strip()
            elif "registers" in line or "spill" in line:
                print("ptxas %s %s: %s" % (name, function, line.strip()))
    print("build: %.1f s (%d kernels and the C++ tier, in parallel; %s)"
          % (time.perf_counter() - t0, len(kernels),
             ", ".join("%s %.1f s" % (name, s)
                       for (name, _), s in zip(kernels, build_s))))

    # -- data -------------------------------------------------------------
    rng = np.random.default_rng(20261016)
    A4 = Alphabet("ACGT")
    t0 = time.perf_counter()
    S, T, segments = plant(np, rng, A4, Sequence)
    print("planted %d blocks of %d bp: |S| = %d, |T| = %d (%.1f s)"
          % (N_BLOCKS, BLOCK, len(S), len(T), time.perf_counter() - t0))
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    kw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True,
              device=dev)
    # warm-up: CUDA context, allocator, library loads
    pipeline.extend_segments(S, T, segments[:2], **kw)
    torch.cuda.synchronize()

    # -- 2. the main path, counted ---------------------------------------
    dp_ad.LAUNCHES = 0
    walk.LAUNCHES = 0
    t0 = time.perf_counter()
    out = pipeline.extend_segments(S, T, segments, **kw)
    e2e = time.perf_counter() - t0
    narrow = pipeline.extend_segments(S, T, segments[:NARROW], **kw)
    counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    _, _, cut, launches = pipeline.extension_plan(segments, len(S), len(T),
                                                  True)
    n_launches = len(launches) + len(pipeline.plan_launches(cut[:NARROW],
                                                             True))
    print("launches: %d planned, %s counted" % (n_launches, counts))
    if any(c != n_launches for c in counts.values()):
        fail("a kernel was not launched once per launch: %s" % counts)
    cells = sum(seg["band_cells"] for seg in out)
    print("extend_segments: %d segments in %d launches, %.3f s end to end,"
          " %.3f GCUPS (band cells %d)"
          % (len(out), len(launches), e2e, cells / e2e / 1e9, cells))

    # -- 3. every transcript rescores to its score and covers its block -
    s_arr, t_arr = S.to_array(), T.to_array()
    short = 0
    for seg in out + narrow:
        tx = seg["transcript"]
        got, letters_ok = rescore(np, tx, s_arr, t_arr, seg["origin_start"],
                                  seg["mutate_start"], subst)
        if got != seg["score"] or not letters_ok:
            fail("transcript of segment %d rescores to %r, score %r"
                 " (letters ok: %s)" % (seg["source_index"], got,
                                        seg["score"], letters_ok))
        i0, j0, ls, lt = seg["block"]
        consumed_s = tx.count("M") + tx.count("S") + tx.count("D")
        if consumed_s < 0.9 * ls:
            short += 1
    if short:
        fail("%d transcripts cover less than 90%% of their block" % short)
    print("transcripts: %d rescored exactly, all cover >= 90%% of their"
          " block" % len(out + narrow))
    # phase 17 extends this batch again (phase 6 rebinds S and T)
    smoke_batch = (S, T, segments, out, narrow, subst)

    # -- 4. kernels against their plain twins on one full launch --------
    idxs, LS, LT, W = max(launches, key=lambda launch: len(launch[0]))
    x = pipeline.launch_inputs(cut, idxs, LS, LT, W, s_arr, t_arr, True)
    on = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    flags = ModeFlags(local_start=True, local_end=True)
    args = (on["s_codes"], on["t_codes"], on["s_lens"], on["t_lens"],
            on["dmin"])
    dkw = dict(W=W, subst=subst, go=GO, ge=GE, flags=flags,
               w_eff=on["w_eff"], with_dirs=True, device=dev)
    print("full launch: %d pairs (%d real), LS %d, LT %d, W %d"
          % (len(x["dmin"]), len(idxs), LS, LT, W))
    got = dp_ad.banded_dp_ad(*args, **dkw)
    t_plain = time.perf_counter()
    want = dp_ad.banded_dp_ad_reference(*args, **dkw)
    torch.cuda.synchronize()
    dp_plain_ms = (time.perf_counter() - t_plain) * 1e3
    dp_err = float((got.score - want.score).abs().max())
    if not (torch.equal(got.score, want.score)
            and torch.equal(got.end_i, want.end_i)
            and torch.equal(got.end_j, want.end_j)):
        fail("DP kernel scores / end cells differ from the plain twin"
             " (max |d score| %r)" % dp_err)
    low_live, high_live = dp_ad.live_nibbles(on["dmin"], on["w_eff"], W)
    gd, wd = got.dirs, want.dirs
    bad = (((gd ^ wd) & 15).ne(0) & low_live).sum() \
        + (((gd ^ wd) >> 4).ne(0) & high_live).sum()
    if int(bad):
        fail("DP kernel dirs plane differs from the plain twin on %d live"
             " nibbles" % int(bad))
    print("dp_ad kernel == plain twin: scores, end cells, dirs plane on"
          " its live slots")
    dirs4 = got.dirs          # phase 8 transposes this plane

    n = len(idxs)
    real = torch.arange(len(x["dmin"]), device=dev) < n
    ei = torch.where(real, got.end_i, -1)
    ej = torch.where(real, got.end_j, -1)
    w_got = walk.traceback_walk(got.dirs, on["dminq"], ei, ej, W=W,
                                device=dev)
    t_plain = time.perf_counter()
    w_want = walk.traceback_walk_reference(got.dirs, on["dminq"], ei, ej,
                                           W=W, device=dev)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t_plain) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(w_got, w_want)):
        fail("walk kernel trace / cursors differ from the plain twin")
    walk_err = float((w_got[1] - w_want[1]).abs().max()
                     + (w_got[2] - w_want[2]).abs().max())
    print("walk kernel == plain twin: trace bytes and cursors")

    tr, fi, fj = (v.cpu().numpy() for v in w_got)
    ops, si, sj = native.compact_sweep_ops_t(
        tr, fi, fj, x["s_codes"][:n], x["t_codes"][:n], x["s_lens"][:n],
        x["t_lens"][:n], flags)
    h_ops, h_si, h_sj = native.traceback_batch_ad(
        got.dirs.cpu().numpy(), x["dminq"][:n], x["s_codes"][:n],
        x["t_codes"][:n], x["s_lens"][:n], x["t_lens"][:n],
        got.end_i.cpu().numpy()[:n], got.end_j.cpu().numpy()[:n], flags)
    if ops != h_ops or not (np.array_equal(si, h_si)
                            and np.array_equal(sj, h_sj)):
        fail("walk + compaction transcripts differ from the C++ host"
             " walker's over the same plane")
    print("transcripts == C++ host walker's on the full launch (%d pairs)"
          % n)

    # -- 5. kernel times at the launch's shape, beside their bounds -------
    dp_ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*args, **dkw), 3)
    walk_ms = cuda_ms(lambda: walk.traceback_walk(
        got.dirs, on["dminq"], ei, ej, W=W, device=dev), 3)

    def guard():
        """extend_segments' check of the walk: its trace's moves against
        the end cells, on the card."""
        di, dj = walk.trace_moves(w_got[0], len(ei))
        return ((ei - w_got[1]) != di) | ((ej - w_got[2]) != dj)

    if bool(guard().any()):
        fail("the walk's moves do not lead from the end cells to its"
             " cursors")
    guard_ms = cuda_ms(guard, 3)
    # the same operations replayed from a CUDA graph: their device time
    # without the host's dispatch of each operation
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        guard()
    guard_device_ms = cuda_ms(graph.replay, 3)
    del graph
    launch_cells = sum(out[k]["band_cells"] for k in idxs)
    # K1 reads the codes, lengths, band and table once and writes the
    # scores, end cells and the plane once
    dp_work = (nbytes(*args, on["w_eff"], subst, *got),
               DP_AD_OPS_PER_CELL * launch_cells)
    dp_bound, dp_bound_by = bound_ms(*dp_work, FP32_OPS_PER_S)
    # the walk reads one plane byte per action (each op, and the stop of
    # each live walker) and writes the trace and cursors once
    tr32 = w_got[0].to(torch.int32)
    steps = int(sum((((tr32 >> s) & 3) != 0).sum() for s in (0, 2, 4, 6)))
    reads = steps + int((ei >= 0).sum())
    walk_work = (reads + nbytes(on["dminq"], ei, ej, *w_got),
                 WALK_OPS_PER_STEP * reads)
    walk_bound, walk_bound_by = bound_ms(*walk_work, INT32_OPS_PER_S)
    print("dp_ad: kernel %.3f ms (%.1f GCUPS on %d band cells), plain %.0f"
          " ms; bound %.4f ms (%s; %.1f MB, %.2f G operations)"
          % (dp_ms, launch_cells / dp_ms / 1e6, launch_cells, dp_plain_ms,
             dp_bound, dp_bound_by, dp_work[0] / 1e6, dp_work[1] / 1e9))
    print("walk: kernel %.3f ms (%d actions, window depth %d), plain %.0f"
          " ms; bound %.4f ms (%s; %.1f MB, %.2f G operations)"
          % (walk_ms, reads, walk.DEPTH, walk_plain_ms, walk_bound,
             walk_bound_by, walk_work[0] / 1e6, walk_work[1] / 1e9))
    print("replay guard (trace moves against end cells, on the card):"
          " %.4f ms per launch, %.4f ms replayed from a CUDA graph"
          % (guard_ms, guard_device_ms))

    # K1 against the plane rows in flight: the full launch's inputs
    # tiled or sliced to each row count, at the same LS, LT, W and Apad
    for n_rows in ROWS_IN_FLIGHT:
        pairs = 2 * n_rows

        def tile(v):
            reps = (-(-pairs // len(v)),) + (1,) * (v.dim() - 1)
            return v.repeat(reps)[:pairs]

        targs = [tile(v) for v in args]
        tkw = dict(dkw, w_eff=tile(on["w_eff"]))
        rows_ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*targs, **tkw), 3)
        print("dp_ad rows in flight: %d plane rows (%d pairs), %.3f ms,"
              " %.5f ms per row" % (n_rows, pairs, rows_ms, rows_ms / n_rows))
        del targs, tkw
    # K1's step loop in SASS: instructions from the back-branch's target
    # to the branch, per block barrier (one barrier per step)
    try:
        loop = sass_step_loop(cuobjdump_sass(_build.so_path("dp_ad")),
                              dp_ad.MAIN_KERNEL)
    except (OSError, subprocess.SubprocessError) as e:
        loop, why = None, "cuobjdump failed: %s" % e
    else:
        why = "no step loop found in %s" % dp_ad.MAIN_KERNEL
    if loop is None:
        print("dp_ad SASS step loop: not measured (%s)" % why)
    else:
        print("dp_ad SASS step loop of %s: %d instructions, %d barriers,"
              " %.1f instructions per step"
              % (loop["function"], loop["instructions"], loop["barriers"],
                 loop["instructions"] / loop["barriers"]))

    # -- 6. the pairwise path at real size, counted --------------------
    pairs = []
    core = rng.integers(0, 4, PAIR_LEN).astype(np.int8)
    mut = mutate(np, rng, core, 4, 0.10, 40, 1000)
    dna_pair = (core, mut)            # phase 16 aligns it again
    for alntype in pw.BANDED_TYPES:
        pairs.append(("dna %s" % alntype, Sequence(A4, core),
                      Sequence(A4, mut), alntype, PAIR_BAND, None, GO, GE))
    prot = rng.integers(0, 20, PROTEIN_LEN).astype(np.int8)
    pmut = mutate(np, rng, prot, 20, 0.15, 6, 100)
    P = protein_alphabet()
    pairs.append(("protein B_LOCAL", Sequence(P, prot), Sequence(P, pmut),
                  pw.B_LOCAL, (-100, 100), BLOSUM62, -11.0, -1.0))
    print("pairwise path: a %d bp DNA pair (|T| = %d), band %s; a %d-residue"
          " protein pair (|T| = %d), BLOSUM62"
          % (PAIR_LEN, len(mut), PAIR_BAND, PROTEIN_LEN, len(pmut)))

    def align(S, T, alntype, band, subst, go, ge, backend, traceback):
        with pw.Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=alntype,
                        diag_range=band, subst_scores=subst, go_score=go,
                        ge_score=ge, backend=backend, device=dev) as aln:
            t0 = time.perf_counter()
            score = aln.solve()             # a host float: synchronised
            t1 = time.perf_counter()
            alignment = aln.traceback() if traceback else None
            t2 = time.perf_counter()
        return score, alignment, aln.subst_scores, t1 - t0, t2 - t1

    # warm-up: the row kernel's first launch, on a small pair
    align(Sequence(A4, core[:500]), Sequence(A4, mut[:500]), pw.B_LOCAL,
          PAIR_BAND, None, GO, GE, "pallas_row", True)
    dp_row.LAUNCHES = 0
    row_out = [align(S, T, alntype, band, psub, go, ge, "pallas_row", True)
               for _, S, T, alntype, band, psub, go, ge in pairs]
    row_launches = dp_row.LAUNCHES
    print("launches of the row kernel on the pairwise path: %d"
          % row_launches)
    if row_launches < 2 * len(pairs):
        fail("the pairwise path did not go through the row kernel: %d"
             " launches for %d solves and tracebacks"
             % (row_launches, 2 * len(pairs)))
    row_err = 0.0
    phase6 = {}
    for (name, S, T, alntype, band, psub, go, ge), got in zip(pairs,
                                                              row_out):
        score, alignment, subst_np, t_solve, t_tb = got
        ref = align(S, T, alntype, band, psub, go, ge, "native", False)
        ad = align(S, T, alntype, band, psub, go, ge, "pallas", False)
        rescored = float(alignment.calculate_score(subst_np, go, ge))
        print("%s: pallas_row %r (solve %.3f s, traceback %.3f s),"
              " native %r (%.3f s), pallas %r (%.3f s), transcript"
              " rescores to %r, %d ops from (%d, %d)"
              % (name, score, t_solve, t_tb, ref[0], ref[3], ad[0], ad[3],
                 rescored, len(alignment.transcript),
                 alignment.origin_start, alignment.mutate_start))
        if not (score == ref[0] == ad[0] == rescored):
            fail("%s: the row kernel's score %r, native %r, pallas %r,"
                 " rescored transcript %r" % (name, score, ref[0], ad[0],
                                             rescored))
        row_err = max(row_err, abs(score - ref[0]))
        phase6[name] = {"row": score, "native": ref[0]}
        if alignment.transcript.origin_len < 0.9 * len(S) \
                and alntype != pw.B_LOCAL:
            fail("%s: the transcript covers too little of S" % name)

    def row_call(S, T, alntype, band, subst, go, ge):
        """The Aligner's own row-kernel call with directions, its inputs
        on the card, and the band's top diagonal."""
        with pw.Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=alntype,
                        diag_range=band, subst_scores=subst, go_score=go,
                        ge_score=ge, backend="pallas_row", device=dev) as aln:
            args, kw = aln._row_args(with_dirs=True)
        on = [torch.as_tensor(np.asarray(a), device=dev) for a in args]
        return on, kw, aln.diag_range[1]

    # where the Aligner's time goes: the kernel score-only and with
    # directions (CUDA events), the plane's copy to the host and the
    # host walk (host clock)
    sms = dp_row.sm_count(dev)
    for name, S, T, alntype, band, psub, go, ge in pairs[:-1]:
        on, kw, dmax = row_call(S, T, alntype, band, psub, go, ge)
        solve_ms = cuda_ms(lambda: dp_row.banded_dp_row(
            *on, **dict(kw, with_dirs=False)), 3)
        dirs_ms = cuda_ms(lambda: dp_row.banded_dp_row(*on, **kw), 3)
        res = dp_row.banded_dp_row(*on, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane = res.dirs[0].cpu().numpy()
        t1 = time.perf_counter()
        traceback_path(plane, S.to_array(), T.to_array(), int(res.end_i[0]),
                       int(res.end_j[0]), banded=True, dmax=dmax,
                       flags=kw["flags"])
        t2 = time.perf_counter()
        # K4 with directions reads the inputs once and writes the plane
        # (a byte per band cell), score and end cell once
        pair_bound, pair_bound_by = bound_ms(
            nbytes(*on, *res), DP_ROW_OPS_PER_CELL * plane.size,
            FP32_OPS_PER_S)
        print("%s: K4 score-only %.3f ms (%.4f us a row; %s), with"
              " directions %.3f ms (%.4f us a row; %s; bound %.4f ms, %s, %d"
              " band cells); plane to the host %.1f ms (%.1f MB), host walk"
              " %.1f ms"
              % (name, solve_ms, solve_ms * 1e3 / len(S),
                 dp_row.plan(1, kw["W"], sms=sms), dirs_ms,
                 dirs_ms * 1e3 / len(S),
                 dp_row.plan(1, kw["W"], True, sms=sms), pair_bound,
                 pair_bound_by,
                 plane.size, (t1 - t0) * 1e3, plane.nbytes / 1e6,
                 (t2 - t1) * 1e3))

    # the row kernel against its twin on the Aligner's own inputs, with
    # directions and score-only (the geometries of traceback and solve):
    # the protein pair whole (the shared-memory table, A 20) and the DNA
    # pair's first TWIN_PREFIX letters (W 512, a block)
    n = TWIN_PREFIX
    twin_cases = [
        pairs[-1],
        ("dna B_LOCAL, first %d bp" % n, Sequence(A4, core[:n]),
         Sequence(A4, mut[:n]), pw.B_LOCAL, PAIR_BAND, None, GO, GE),
    ]
    for name, S, T, alntype, band, psub, go, ge in twin_cases:
        on, kw_dirs, _ = row_call(S, T, alntype, band, psub, go, ge)
        for kw in (kw_dirs, dict(kw_dirs, with_dirs=False)):
            got = dp_row.banded_dp_row(*on, **kw)
            t0 = time.perf_counter()
            want = dp_row.banded_dp_row_reference(*on, **kw)
            torch.cuda.synchronize()
            t_twin = time.perf_counter() - t0
            row_err = max(row_err,
                          float((got.score - want.score).abs().max()))
            geo = dp_row.plan(1, kw["W"], kw["with_dirs"], sms=sms)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail("%s: the row kernel differs from its plain twin on the"
                     " Aligner's inputs (W %d, %s)" % (name, kw["W"], geo))
            print("%s: dp_row kernel == plain twin on the Aligner's inputs,"
                  " W %d, %s (score, end cell%s; twin %.1f s)"
                  % (name, kw["W"], geo,
                     ", the whole plane" if kw["with_dirs"] else "", t_twin))

    # -- 7. the row kernel against its twin at the score-bench shape -----
    sb = SCORE_BENCH
    rr = np.random.default_rng(20261017)
    B = sb["B"]
    host = (rr.integers(0, 4, (B, sb["L"]), dtype=np.int8),
            rr.integers(0, 4, (B, sb["L"]), dtype=np.int8),
            np.full((B,), sb["n"], np.int32), np.full((B,), sb["n"], np.int32),
            np.full((B,), -(sb["band"] // 2), np.int32))
    on = [torch.from_numpy(v).to(dev) for v in host]
    rkw = dict(W=sb["W"], subst=subst, go=-2.0, ge=-1.0,
               flags=ModeFlags(local_start=True, local_end=True),
               w_eff=torch.full((B,), sb["band"], dtype=torch.int32,
                                device=dev), device=dev)
    got = dp_row.banded_dp_row(*on, **rkw)
    t_plain = time.perf_counter()
    want = dp_row.banded_dp_row_reference(*on, **rkw)
    torch.cuda.synchronize()
    row_plain_ms = (time.perf_counter() - t_plain) * 1e3
    row_err = max(row_err, float((got.score - want.score).abs().max()))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("row kernel (score-only, %d pairs) differs from its plain twin"
             % B)
    nd = 512
    dkw = dict(rkw, w_eff=rkw["w_eff"][:nd], with_dirs=True)
    got_d = dp_row.banded_dp_row(*[v[:nd] for v in on], **dkw)
    t_plain = time.perf_counter()
    want_d = dp_row.banded_dp_row_reference(*[v[:nd] for v in on], **dkw)
    torch.cuda.synchronize()
    row_plain_dirs_ms = (time.perf_counter() - t_plain) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(got_d, want_d)):
        fail("row kernel (directions, %d pairs) differs from its plain twin"
             % nd)
    if not torch.equal(got_d.score, got.score[:nd]):
        fail("row kernel scores with and without directions differ")
    print("dp_row kernel == plain twin: %d pairs score-only, %d pairs with"
          " directions (scores, end cells, the whole plane; %s)"
          % (B, nd, dp_row.plan(B, sb["W"], sms=sms)))
    row_ms = cuda_ms(lambda: dp_row.banded_dp_row(*on, **rkw), 3)
    row_dirs_ms = cuda_ms(lambda: dp_row.banded_dp_row(
        *[v[:nd] for v in on], **dkw), 3)
    band_cells = B * sb["n"] * sb["band"]
    print("dp_row: kernel %.3f ms (%.1f GCUPS on %d band cells), plain"
          " %.0f ms; with directions on %d pairs: kernel %.3f ms (%.1f"
          " GCUPS), plain %.0f ms"
          % (row_ms, band_cells / row_ms / 1e6, band_cells, row_plain_ms, nd,
             row_dirs_ms, band_cells * nd / B / row_dirs_ms / 1e6,
             row_plain_dirs_ms))
    # K4 score-only reads the codes, lengths, band and table once and
    # writes the scores and end cells once
    row_work = (nbytes(*on, rkw["w_eff"], subst, *got),
                DP_ROW_OPS_PER_CELL * band_cells)
    row_bound, row_bound_by = bound_ms(*row_work, FP32_OPS_PER_S)
    print("dp_row: bound %.4f ms (%s; %.1f MB, %.2f G operations)"
          % (row_bound, row_bound_by, row_work[0] / 1e6, row_work[1] / 1e9))

    # -- 8. the experiment probes, counted -------------------------------
    transpose_probe.LAUNCHES = 0
    i16_probe.LAUNCHES = 0
    tr_legs = transpose_probe.run()
    i16_rows = i16_probe.run(rows=I16_ROW_COUNTS)
    probe_counts = {"transpose_probe": transpose_probe.LAUNCHES,
                    "i16_probe": i16_probe.LAUNCHES}
    print("launches of the probes' kernels: %s" % probe_counts)
    if not all(probe_counts.values()):
        fail("a probe did not go through its kernel: %s" % probe_counts)
    for leg in tr_legs:
        print("transpose probe: %s %s: ok=%s %.4f ms (%.1f GB/s eff; bound"
              " %.4f ms)" % (leg["leg"], leg["shape"], leg["ok"], leg["ms"],
                             leg["gbps"], leg["bound_ms"]))
    if not all(leg["ok"] for leg in tr_legs):
        fail("a transpose leg differs from the plain version")
    for row in i16_rows:
        if not row["ok"]:
            fail("i16 op %r at %d rows: %s" % (row["op"], row["rows"],
                                               row["error"]))
        print("i16 probe: OK %-22s [%7d, 128]: kernel %.4f ms, plain %.4f"
              " ms, bound %.4f ms, share %5.1f%%%s"
              % (row["op"], row["rows"], row["ms"], row["plain_ms"],
                 row["bound_ms"], 100 * row["bound_ms"] / row["ms"],
                 "" if row["ms"] <= row["plain_ms"] else
                 ", slower than plain"))
    i16_by_rows = {}
    for R in I16_ROW_COUNTS:
        ten = [row for row in i16_rows if row["rows"] == R]
        i16_by_rows[R] = {key: sum(row[key] for row in ten)
                          for key in ("ms", "plain_ms", "bound_ms")}
        print("i16 probe: ten ops at [%d, 128]: kernel %.4f ms, plain %.4f"
              " ms, bound %.4f ms, share %.1f%%"
              % (R, i16_by_rows[R]["ms"], i16_by_rows[R]["plain_ms"],
                 i16_by_rows[R]["bound_ms"],
                 100 * i16_by_rows[R]["bound_ms"] / i16_by_rows[R]["ms"]))
    # the probe's kernel leg and library leg on the whole probe plane
    tr_kernel, tr_library = (
        next(leg for leg in tr_legs if leg["leg"] == name
             and leg["shape"] == list(transpose_probe.PLANE))
        for name in ("kernel_transpose_u8", "library_transpose_u8"))
    i16_err = max(row["max_abs_err"] for row in i16_rows)

    # the transpose on phase 4's dirs plane, the walk redesign's input
    t_got = transpose_probe.transpose_minor(dirs4, device=dev)
    t_want = transpose_probe.transpose_minor_reference(dirs4, device=dev)
    tr_err = float((torch.maximum(t_got, t_want)
                    - torch.minimum(t_got, t_want)).max())
    if not torch.equal(t_got, t_want):
        fail("transpose kernel differs from the plain version on the dirs"
             " plane %s" % (tuple(dirs4.shape),))
    del t_got, t_want
    plane_ms = cuda_ms(lambda: transpose_probe.transpose_minor(
        dirs4, device=dev), 5)
    plane_library_ms = cuda_ms(
        lambda: transpose_probe.transpose_minor_reference(dirs4, device=dev),
        5)
    print("transpose of phase 4's dirs plane %s (%.1f MB): kernel %.4f ms,"
          " plain (= library) %.4f ms, bound %.4f ms; the walk over it"
          " %.3f ms" % (tuple(dirs4.shape), dirs4.numel() / 1e6, plane_ms,
                        plane_library_ms,
                        transpose_probe.transpose_bound_ms(dirs4), walk_ms))

    # -- 9. bands wider than 2048 lanes, counted -----------------------
    wr = np.random.default_rng(0)
    Sw = Sequence(A4, wr.choice(4, WIDE_LEN))
    Tw = Sequence(A4, wr.choice(4, WIDE_LEN))
    wseg = [{"segment": WIDE_SEGMENT}]
    ekw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True)
    dp_ad.LAUNCHES = 0
    walk.LAUNCHES = 0
    wide = pipeline.extend_segments(Sw, Tw, wseg, device=dev, **ekw)
    wide_counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    wide_cpu = pipeline.extend_segments(Sw, Tw, wseg, device="cpu", **ekw)
    wcut = [pipeline.cut_segment(seg, WIDE_LEN, WIDE_LEN) for seg in wseg]
    (widx, wLS, wLT, wW), = pipeline.plan_launches(wcut, True)
    print("wide band: W %d, launches %s, score %r, %d ops from (%d, %d)"
          % (wW, wide_counts, wide[0]["score"], len(wide[0]["transcript"]),
             wide[0]["origin_start"], wide[0]["mutate_start"]))
    if wW != 3072 or wide_counts != {"dp_ad": 1, "walk": 1}:
        fail("the wide segment did not run one W 3072 launch of each"
             " kernel: W %d, %s" % (wW, wide_counts))
    got_score, letters_ok = rescore(
        np, wide[0]["transcript"], Sw.to_array(), Tw.to_array(),
        wide[0]["origin_start"], wide[0]["mutate_start"], subst)
    if wide != wide_cpu or wide[0]["score"] != WIDE_SCORE \
            or got_score != WIDE_SCORE or not letters_ok:
        fail("wide band: the card gives %r, the CPU twins %r (rescored %r)"
             % (wide, wide_cpu, got_score))
    wx = pipeline.launch_inputs(wcut, widx, wLS, wLT, wW, Sw.to_array(),
                                Tw.to_array(), True)
    B4, L4 = WIDE_4096["B"], WIDE_4096["L"]
    codes = wr.integers(0, 4, (B4, L4)).astype(np.int8)
    mut = codes.copy()
    hit = wr.random((B4, L4)) < 0.1
    mut[hit] = (mut[hit] + 1) % 4
    w4 = dict(s_codes=codes, t_codes=mut,
              s_lens=np.full((B4,), L4, np.int32),
              t_lens=np.full((B4,), L4, np.int32),
              dmin=np.full((B4,), -2048, np.int32),
              w_eff=np.full((B4,), 4095, np.int32))
    wide_ms = {}
    for Ww, xs in ((wW, wx), (4096, w4)):
        won = {k: torch.from_numpy(np.asarray(v)).to(dev)
               for k, v in xs.items()}
        wargs = (won["s_codes"], won["t_codes"], won["s_lens"],
                 won["t_lens"], won["dmin"])
        wkw = dict(W=Ww, subst=subst, go=GO, ge=GE, flags=flags,
                   w_eff=won["w_eff"], with_dirs=True, device=dev)
        g = dp_ad.banded_dp_ad(*wargs, **wkw)
        t_plain = time.perf_counter()
        want = dp_ad.banded_dp_ad_reference(*wargs, **wkw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        lo_live, hi_live = dp_ad.live_nibbles(won["dmin"], won["w_eff"], Ww)
        bad = (((g.dirs ^ want.dirs) & 15).ne(0) & lo_live).sum() \
            + (((g.dirs ^ want.dirs) >> 4).ne(0) & hi_live).sum()
        if not (torch.equal(g.score, want.score)
                and torch.equal(g.end_i, want.end_i)
                and torch.equal(g.end_j, want.end_j)) or int(bad):
            fail("DP kernel at W %d differs from its plain twin" % Ww)
        dp_err = max(dp_err, float((g.score - want.score).abs().max()))
        wide_ms[Ww] = cuda_ms(lambda: dp_ad.banded_dp_ad(*wargs, **wkw), 3)
        print("dp_ad at W %d: %d pairs of %d x %d, kernel == plain twin"
              " (scores, end cells, dirs plane); kernel %.3f ms, plain %.0f"
              " ms" % (Ww, len(xs["dmin"]), wargs[0].shape[1],
                       wargs[1].shape[1], wide_ms[Ww], plain_ms))


    # -- 10. discovery and extension at the genome-homology config ------
    genome = genome_phase(dev, card, subst)

    # -- 11. reads mapped to a reference, from FASTA ---------------------
    mapping = mapping_phase(dev, card, subst)

    # -- 12. N-way homology ----------------------------------------------
    nway_phase(dev, card)

    # -- 13. all-vs-all read overlaps ------------------------------------
    overlap = overlap_phase(dev, card, recall_reads)

    # -- 14. two-tier protein search, counted ----------------------------
    protein = protein_phase(dev, card)

    # -- 15. the experiments at their default configs -----------------
    experiments = experiments_phase(dev, card, band_rows, overlap["row"])

    # -- 16. the band-sharded engines and the checkpointed sweep --------
    sharded_phase(dev, card, *dna_pair, phase6, recall_reads)

    # -- 17. the row route, use_pallas=False ------------------------------
    row_route_phase(dev, card, *smoke_batch)

    # -- 18. bands above 4096 lanes, each a thread-block cluster ----------
    wide = wide_phase(dev, card, dna_pair)

    # -- 19. the four path probes at the JAX scripts' sizes -------------
    probes = probes_phase(card)

    print(json.dumps({"kernels": [
        {"name": "dp_ad", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/dp_ad.cu",
         "replaces": "biseqt_tpu/ops/pallas_dp_ad.py:73",
         "launches": counts["dp_ad"], "max_abs_err": dp_err,
         "ms": dp_ms, "plain_ms": dp_plain_ms, "bound_ms": dp_bound,
         "bound_by": dp_bound_by, "library_ms": None,
         "launches_by_path": {"extend_segments": counts["dp_ad"],
                              "discover_and_extend":
                                  genome["launches"]["dp_ad"],
                              "map_reads": mapping["launches"]["dp_ad"],
                              "two_tier_protein": protein["launches"],
                              "genome_homology":
                                  experiments["launches"]["dp_ad"]},
         "discover_and_extend": genome["dp_ad"],
         "map_reads": mapping["dp_ad"],
         "in_flight_queue": {"discover_and_extend": genome["queue"],
                             "map_reads": mapping["queue"]},
         "two_tier_protein": {
             k: protein[k] for k in ("filter_ms", "rescore_ms",
                                     "full_only_ms", "bound_ms", "bound_by",
                                     "twin_ms")},
         "wide": wide["dp_ad"],
         "wide_extension": wide["extension"],
         "probes": {k: probes[k] for k in ("walk_probe", "adkernel_probe",
                                           "txpath_probe")}},
        {"name": "walk", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/walk.cu",
         "replaces": "biseqt_tpu/ops/pallas_walk.py:512",
         "launches": counts["walk"], "max_abs_err": walk_err,
         "ms": walk_ms, "plain_ms": walk_plain_ms, "bound_ms": walk_bound,
         "bound_by": walk_bound_by, "library_ms": None,
         "launches_by_path": {"extend_segments": counts["walk"],
                              "discover_and_extend":
                                  genome["launches"]["walk"],
                              "map_reads": mapping["launches"]["walk"],
                              "genome_homology":
                                  experiments["launches"]["walk"]},
         "discover_and_extend": genome["walk"],
         "map_reads": mapping["walk"]},
        {"name": "dp_row", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/dp_row.cu",
         "replaces": "biseqt_tpu/ops/pallas_dp.py:54",
         "launches": row_launches, "max_abs_err": row_err,
         "ms": row_ms, "plain_ms": row_plain_ms, "bound_ms": row_bound,
         "bound_by": row_bound_by, "library_ms": None,
         "wide": wide["dp_row"], "wide_aligner": wide["aligner"]},
        # the plain version is PyTorch's transpose copy: plain = library
        {"name": "transpose_probe", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/transpose_probe.cu",
         "replaces": "experiments/transpose_probe.py:66",
         "launches": probe_counts["transpose_probe"], "max_abs_err": tr_err,
         "ms": tr_kernel["ms"], "plain_ms": tr_library["ms"],
         "bound_ms": tr_kernel["bound_ms"], "bound_by": "bytes",
         "library_ms": tr_library["ms"]},
        # the ten ops at [I16_ROWS, 128], summed (and at each row count
        # of phase 8); each plain version is the op's PyTorch call, so
        # plain = library
        {"name": "i16_probe", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/i16_probe.cu",
         "replaces": "experiments/mosaic_i16_probe.py:21",
         "launches": probe_counts["i16_probe"], "max_abs_err": i16_err,
         "ms": i16_by_rows[I16_ROWS]["ms"],
         "plain_ms": i16_by_rows[I16_ROWS]["plain_ms"],
         "bound_ms": i16_by_rows[I16_ROWS]["bound_ms"], "bound_by": "bytes",
         "library_ms": i16_by_rows[I16_ROWS]["plain_ms"],
         "ten_ops_by_rows": i16_by_rows},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
