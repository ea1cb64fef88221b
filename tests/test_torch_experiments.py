"""The port's experiments (biseqt_tpu_torch.experiments) against the JAX
package's scripts under ``experiments/``, on the CPU.

Each experiment's core function runs at a small size (its ``--quick``
size, or smaller where the plain twins of the kernels would take
minutes) on ``device="cpu"``, on the same seed as the JAX script's
function.  Held exactly where the JAX package is exact: simulated
inputs, planted truth, band radii and containment, seeds, segments,
recall rows, overlap precision and recall, k-mer tables and integer
statistics.  Estimated match probabilities (p-hat and its mean error)
are held to rtol 1e-5, atol 1e-6, the discovery tolerance of
``tests/test_torch_blot.py``; ``multiple_homology``'s p-hats, which the
script rounds to three places, to 1e-3.  Timings are not compared.
"""

import json
import os
import sys

import numpy as np
import pytest

from biseqt_tpu_torch.experiments import (band_radius_stats, fixed_ref_bench,
                                          genome_homology, index_build_bench,
                                          ingest_bench, multiple_homology,
                                          overlap_recall, protein_search,
                                          util, wordblot_recall)
from biseqt_tpu_torch.ops.tables import build_kmer_table as port_table

_EXP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments",
)
sys.path.insert(0, _EXP)

import band_radius_stats as jax_band  # noqa: E402
import fixed_ref_bench as jax_fixed_ref  # noqa: E402
import genome_homology as jax_genome  # noqa: E402
import ingest_bench as jax_ingest  # noqa: E402
import multiple_homology as jax_multiple  # noqa: E402
import overlap_recall as jax_overlap  # noqa: E402
import protein_search as jax_protein  # noqa: E402
import util as jax_util  # noqa: E402
import wordblot_recall as jax_wordblot  # noqa: E402

P_TOL = dict(rtol=1e-5, atol=1e-6)
TIMINGS = {"index_s", "first_query_s", "query_total_s", "queries_per_s",
           "batch_total_s", "batch_queries_per_s", "discover_s",
           "t_simulate", "t_index", "t_discover", "t_extend",
           "extend_gcups", "native_ingest_s", "load_record_s",
           "python_ingest_s"}


def _codes(seq):
    return np.asarray(seq.to_array())


def _untimed(row):
    return {k: v for k, v in row.items() if k not in TIMINGS}


# -- band_radius_stats ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_band_radius_stats_rows_equal_the_jax_script(seed):
    kw = dict(Ks=(100, 400), gs=(0.05, 0.3), n_trials=20, seed=seed)
    assert band_radius_stats.run(**kw) == jax_band.run(**kw)


# -- wordblot_recall ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_plant_homologies_equals_the_jax_script(seed):
    kw = dict(seq_len=6000, n_segments=3, seg_len=500)
    S, T, planted = wordblot_recall.plant_homologies(
        np.random.default_rng(seed), **kw)
    jS, jT, jplanted = jax_wordblot.plant_homologies(
        np.random.default_rng(seed), **kw)
    assert np.array_equal(_codes(S), _codes(jS))
    assert np.array_equal(_codes(T), _codes(jT))
    assert planted == jplanted


def test_segment_hits_equals_the_jax_script():
    planted = [{"d": 100, "a": (1000, 3000), "p": 0.8},
               {"d": -400, "a": (5000, 6000), "p": 0.7}]
    found = [{"segment": ((90, 110), (900, 2500))},
             {"segment": ((-420, -410), (5200, 5400))},
             {"segment": ((-430, -380), (5000, 5900))},
             {"segment": ((500, 600), (0, 10000))}]
    got = wordblot_recall.segment_hits(found, planted, 12)
    assert got == jax_wordblot.segment_hits(found, planted, 12)
    assert got == [0, None, 1, None]


def test_wordblot_recall_sweep_equals_the_jax_script():
    """``--quick``: recall@k and precision rows exactly, the index report
    exactly, p-hat's mean error within the discovery tolerance."""
    got = wordblot_recall.run_sweep(device="cpu", **wordblot_recall.QUICK)
    want = jax_wordblot.run_sweep(seq_len=8000, n_segments=3, seg_len=600,
                                  n_trials=2, K_min=300)
    assert got[0] == want[0]
    assert [r["p_min"] for r in got[1:]] == [0.5, 0.6, 0.7, 0.8]
    for g, w in zip(got[1:], want[1:]):
        assert (g["p_min"], g["recall_at_k"], g["precision"]) == (
            w["p_min"], w["recall_at_k"], w["precision"])
        assert (g["p_hat_mae"] is None) == (w["p_hat_mae"] is None)
        if g["p_hat_mae"] is not None:
            np.testing.assert_allclose(g["p_hat_mae"], w["p_hat_mae"],
                                       **P_TOL)
    assert got[1]["recall_at_k"] == 1.0


# -- multiple_homology -------------------------------------------------------

def test_multiple_homology_row_equals_the_jax_script(monkeypatch, capsys):
    """Three sequences sharing two 6 kbp blocks: the JAX script's printed
    row (its ``main`` on ``argv``), timings aside."""
    monkeypatch.setattr(sys, "argv", ["multiple_homology.py", "3", "6000"])
    jax_multiple.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = multiple_homology.run(3, 6000, device="cpu")
    assert set(got) == set(want)
    ps, want_ps = got.pop("ps"), want.pop("ps")
    assert _untimed(got) == _untimed(want)
    np.testing.assert_allclose(ps, want_ps, rtol=0, atol=1e-3)
    assert got["n_segments"] >= 2 and got["block_recall"] == 1.0


# -- fixed_ref_bench ---------------------------------------------------------

def test_fixed_ref_inputs_equal_the_jax_script():
    args = (50_000, 4, 2_000, 0.1)
    ref, queries, loci = fixed_ref_bench.make_inputs(
        np.random.default_rng(0), *args)
    jref, jqueries, jloci = jax_fixed_ref.make_inputs(
        np.random.default_rng(0), *args)
    assert np.array_equal(_codes(ref), _codes(jref))
    assert all(np.array_equal(_codes(q), _codes(j))
               for q, j in zip(queries, jqueries))
    assert loci == jloci


def test_fixed_ref_run_equals_the_jax_script():
    """``--quick`` (10 reads of 5 kbp mapped to 200 kbp at word 10):
    locus recall and the config exactly, timings aside."""
    got = fixed_ref_bench.run(device="cpu", **fixed_ref_bench.QUICK)
    want = jax_fixed_ref.run(ref_len=200_000, n_queries=10,
                             query_len=5_000, wordlen=10, K_min=1000)
    assert set(got) == set(want)
    assert _untimed(got) == _untimed(want)
    assert got["locus_recall"] == 1.0


# -- ingest_bench ------------------------------------------------------------

def test_ingest_bench_row_has_the_jax_scripts_keys(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["ingest_bench.py", "--size", "50000",
                                      "--python-too"])
    jax_ingest.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = ingest_bench.run(50_000, python_too=True)
    assert set(got) == set(want)
    assert got["size"] == want["size"] == 50_000


# -- index_build_bench -------------------------------------------------------

def test_index_build_bench_equals_the_jax_functions():
    """The JAX script draws its reads with ``jax.random``, so the port's
    run is held to the JAX package's table build and sort-join
    statistics on the port's own reads: the table exactly, window, diag
    and olap_len exactly, p and s0 within the tolerance."""
    import jax.numpy as jnp
    from biseqt_tpu.ops.allvsall_sorted import overlap_stats_sorted
    from biseqt_tpu.ops.tables import build_kmer_table

    N, L, w = 40, 1500, 8
    res = index_build_bench.run(N, L, w, device="cpu")
    row = res.row
    assert row["kmers_indexed"] == N * (L - w + 1)
    assert (row["reads"], row["read_len"], row["join_wordlen"],
            row["backend"]) == (N, L, w, "cpu")
    codes, lens = res.codes.numpy(), res.lens.numpy()
    got = [t.numpy() for t in
           port_table(codes, lens, w, device="cpu")]
    want = [np.asarray(t) for t in build_kmer_table(jnp.asarray(codes),
                                                    jnp.asarray(lens), w)]
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    want = overlap_stats_sorted(jnp.asarray(codes), jnp.asarray(lens),
                                wordlen=w, n_reads=N, bucket=64)
    for k in ("window", "diag", "olap_len"):
        np.testing.assert_array_equal(res.stats[k].numpy(),
                                      np.asarray(want[k]))
    for k in ("p", "s0"):
        np.testing.assert_allclose(res.stats[k].numpy(), np.asarray(want[k]),
                                   **P_TOL)


# -- genome_homology ---------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_rearranged_pair_equals_the_jax_script(seed):
    A, B, truth = genome_homology.rearranged_pair(
        np.random.default_rng(seed), 12_000, n_blocks=4)
    jA, jB, jtruth = jax_genome.rearranged_pair(
        np.random.default_rng(seed), 12_000, n_blocks=4)
    assert np.array_equal(_codes(A), _codes(jA))
    assert np.array_equal(_codes(B), _codes(jB))
    assert truth == jtruth


def test_genome_homology_run_once_equals_the_jax_script():
    """Discovery and extension with transcripts on a 20 kbp pair of two
    blocks: every untimed field of the row exactly (seeds, segments,
    block recall, cells, transcript ops and match fraction)."""
    got = genome_homology.run_once(1, 20_000, 2, 12, transcripts=True,
                                   device="cpu")
    want = jax_genome.run_once(1, 20_000, 2, 12, transcripts=True)
    assert set(got) == set(want)
    assert _untimed(got) == _untimed(want)
    assert got["block_recall"] == 1.0 and got["tx_total_ops"] > 10_000


def test_block_recall_counts_as_the_jax_script():
    truth = [(0, 5000, 5000), (5000, 0, 5000)]
    rows = [{"segment": ((-5040, -4990), (5000, 15000))}]
    assert genome_homology.block_recall(rows, truth) == 0.5


# -- overlap_recall ----------------------------------------------------------

def test_simulate_reads_equals_the_jax_script():
    kw = dict(genome_len=8000, read_len=1500, n_reads=6, err=0.12)
    reads, starts = overlap_recall.simulate_reads(np.random.default_rng(4),
                                                  **kw)
    jreads, jstarts = jax_overlap.simulate_reads(np.random.default_rng(4),
                                                 **kw)
    assert starts == jstarts
    assert all(np.array_equal(_codes(r), _codes(j))
               for r, j in zip(reads, jreads))
    codes, lens, packed_starts = overlap_recall.simulate_packed(
        4, *kw.values())
    assert list(packed_starts) == starts
    assert list(lens) == [len(r) for r in reads]


@pytest.mark.parametrize("engine", ["mesh", "sorted"])
def test_overlap_recall_equals_the_jax_script(engine):
    """``--quick`` through both engines: precision, recall, the number
    of predictions and the diagonal error exactly."""
    got = overlap_recall.run(engine=engine, device="cpu",
                             **overlap_recall.QUICK)
    want = jax_overlap.run(genome_len=8000, read_len=1500, n_reads=12,
                           engine=engine)
    assert got == want
    assert got["n_predictions"] > 0


def test_score_overlaps_equals_the_loop_accounting():
    """The vectorised accounting against the JAX script's loop over
    pairs, on random statistics."""
    rng = np.random.default_rng(9)
    n, read_len, w, min_olap = 30, 1500, 8, 500
    starts = rng.integers(0, 6000, n).tolist()
    stats = {"s0": rng.uniform(0, 120, (n, n)), "p": rng.uniform(0, 1, (n, n)),
             "olap_len": rng.integers(0, 1500, (n, n)),
             "diag": rng.integers(-6000, 6000, (n, n))}
    tp = fp = fn = 0
    d_errs = []
    for q in range(n):
        for t in range(q + 1, n):
            if jax_overlap.ambiguous_overlap(starts, read_len, q, t,
                                             min_olap, w):
                continue
            pred = (stats["s0"][q, t] >= 60.0 and stats["p"][q, t] >= 0.4
                    and stats["olap_len"][q, t] >= min_olap // 2)
            truth = jax_overlap.true_overlap(starts, read_len, q, t,
                                             min_olap)
            if pred and truth:
                tp += 1
                d_errs.append(abs(int(stats["diag"][q, t])
                                  - (starts[t] - starts[q])))
            elif pred:
                fp += 1
            elif truth:
                fn += 1
    got = overlap_recall.score_overlaps(stats, starts, read_len, w, min_olap,
                                        60.0, 0.4)
    assert got == {"precision": tp / (tp + fp), "recall": tp / max(tp + fn, 1),
                   "n_predictions": tp + fp,
                   "diag_mae": float(np.mean(d_errs))}


# -- protein_search ----------------------------------------------------------

def test_mk_batch_equals_the_jax_script():
    got = protein_search.mk_batch(np.random.default_rng(11), 64, 200)
    want = jax_protein.mk_batch(np.random.default_rng(11), 64, 200)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_steady_runs_equals_the_jax_benchs():
    from bench import steady_runs

    ts = [0.5, 0.9, 1.4, 1.8, 2.5]
    assert protein_search.steady_runs(0.1, ts, 10 ** 9) == steady_runs(
        0.1, ts, 10 ** 9)


def test_protein_search_run_on_the_cpu():
    """The two-tier flow at a small size on the plain twin: every homolog
    survives the filter, the rescore equals a full-only run, and the
    per-call API equals the inline flow."""
    row = protein_search.run(B=32, L=64, n_batches=2, device="cpu")
    assert row["homolog_recall"] == 1.0
    assert row["rescore_exact"] and row["api_matches"]
    assert 0 < row["survivor_frac"] < 1
    assert row["eff_vs_uniform_dna"] is None


# -- util --------------------------------------------------------------------

def test_util_matches_the_jax_scripts_helpers(tmp_path):
    assert util.HAVE_MPL == jax_util.HAVE_MPL
    calls = []

    @util.with_dumpfile
    def rows(x):
        calls.append(x)
        return [{"x": x}]

    dump = str(tmp_path / "rows.pkl")
    assert rows(3, dumpfile=dump) == rows(4, dumpfile=dump) == [{"x": 3}]
    assert calls == [3]
    with util.Timer() as t:
        pass
    assert t.elapsed >= 0
