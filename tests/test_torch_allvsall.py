"""The port's sort-join all-vs-all engine (biseqt_tpu_torch.ops.
allvsall_sorted) against the JAX package's, on the same numpy inputs.

The cases are those of ``tests/test_parallel.py`` that exercise the
engine (neighbouring noisy reads, the chunked windows with a shifted
last one, the coverage regime of the auto partner cap, near-duplicate
long reads at a small bucket).  ``window``, ``diag`` and ``olap_len``
must be equal; ``p`` and ``s0`` within rtol 1e-5, atol 1e-6 (the JAX
package takes p̂'s root in float32, the port in float64 rounded once).
"""

import warnings

import numpy as np
import pytest

import jax.numpy as jnp

from biseqt_tpu.ops import allvsall_sorted as ref
from biseqt_tpu.sequence import Alphabet, pack_sequences
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch.ops import allvsall_sorted as port

A4 = Alphabet("ACGT")
EXACT = ("window", "diag", "olap_len")
RTOL, ATOL = 1e-5, 1e-6


def reads_with_overlaps(rng, n_reads=8, glen=2000, rlen=600, err=0.1):
    """Reads tiled over a genome with ~50% overlap between neighbours
    (``tests/test_parallel.py``'s generator)."""
    M = MutationProcess(A4, subst_probs=err, go_prob=err / 3,
                        ge_prob=err, rng=rng)
    genome = rand_seq(A4, glen, rng=rng)
    reads, starts = [], []
    step = (glen - rlen) // (n_reads - 1)
    for k in range(n_reads):
        start = k * step
        r, _ = M.mutate(genome[start:start + rlen])
        reads.append(r)
        starts.append(start)
    return reads, starts


def assert_stats_match(got, want, exact=EXACT):
    assert set(got) == set(want)
    for k in exact:
        assert np.array_equal(got[k].cpu().numpy(), np.asarray(want[k])), k
    for k in ("p", "s0"):
        g, w = got[k].cpu().numpy(), np.asarray(want[k])
        print("%s: max |d| %.3g" % (k, np.abs(g - w).max(initial=0.0)))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


def both(codes, lens, **kw):
    want = ref.overlap_stats_sorted(jnp.asarray(codes), jnp.asarray(lens),
                                    **kw)
    got = port.overlap_stats_sorted(codes, lens, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("kw", [dict(bucket=32, max_run=8),
                                dict(bucket=32), dict(bucket=64)])
def test_sorted_allvsall_matches_jax(rng, kw):
    """``test_sorted_allvsall_matches_blockwise``'s reads, and its
    qualitative structure on the port's result."""
    reads, starts = reads_with_overlaps(rng)
    codes, lens = pack_sequences(reads, pad_to=768)
    got, want = both(codes, lens, wordlen=8, n_reads=len(reads), **kw)
    assert_stats_match(got, want)
    s0, diag = got["s0"].numpy(), got["diag"].numpy()
    n = len(reads)
    for q in range(n - 1):
        assert s0[q, q + 1] > 25
        assert abs(diag[q, q + 1] - (starts[q + 1] - starts[q])) \
            <= 2 * kw["bucket"]
    assert s0[0, n - 1] < 25


@pytest.mark.parametrize("max_chunk", [4, 5, 11])
def test_sorted_allvsall_chunked_matches_jax(rng, max_chunk):
    """The chunked windows (3 windows over 11 rows at max_chunk 4, the
    last shifted back) equal the JAX package's chunked run and the
    port's own unchunked run."""
    reads, _ = reads_with_overlaps(rng, n_reads=11, glen=2400, rlen=500)
    codes, lens = pack_sequences(reads, pad_to=640)
    kw = dict(wordlen=8, n_reads=len(reads), bucket=32, max_run=8)
    want = ref.overlap_stats_sorted_chunked(
        jnp.asarray(codes), jnp.asarray(lens), max_chunk=max_chunk, **kw)
    got = port.overlap_stats_sorted_chunked(codes, lens, max_chunk=max_chunk,
                                            device="cpu", **kw)
    assert_stats_match(got, want)
    whole = port.overlap_stats_sorted(codes, lens, device="cpu", **kw)
    for k in whole:
        assert np.array_equal(got[k].numpy(), whole[k].numpy()), k


@pytest.mark.parametrize("max_run", [None, 4])
def test_sorted_allvsall_auto_max_run_coverage_regime(rng, max_run):
    """The coverage regime (mean run length ~24 at wordlen 4): the auto
    cap and the starved cap of 4 both equal the JAX package's, and the
    auto cap recovers the far-index pair's window."""
    glen, rlen, n = 2048, 256, 24
    genome = rng.integers(0, 4, glen, dtype=np.int8)
    reads = np.zeros((n, 256), np.int8)
    for k in range(n):
        s = (k * 83) % (glen - rlen)
        reads[k] = genome[s:s + rlen]
    lens = np.full((n,), rlen, np.int32)
    got, want = both(reads, lens, wordlen=4, n_reads=n, bucket=32,
                     max_run=max_run)
    assert_stats_match(got, want)
    if max_run is None:
        assert int(got["window"][0, 22]) >= (rlen - 34) // 2


def test_sorted_allvsall_large_nbins_no_overflow(rng):
    """Near-duplicate long reads at bucket 8 (nbins 1026): the capped
    rank keeps the (rank, dbin) encoding inside int32."""
    L = 4096
    reads = np.tile(rng.integers(0, 4, L, dtype=np.int8), (4, 1))
    lens = np.full((4,), L, np.int32)
    got, want = both(reads, lens, wordlen=10, n_reads=4, bucket=8,
                     max_run=4)
    assert_stats_match(got, want)
    diag, p = got["diag"].numpy(), got["p"].numpy()
    off = ~np.eye(4, dtype=bool)
    assert (np.abs(diag[off]) <= 16).all() and (p[off] > 0.8).all()


@pytest.mark.parametrize("args", [(24, 256, 4), (1000, 10_000, 12),
                                  (1000, 3000, 8), (8, 600, 8),
                                  (300, 10_000, 12), (5000, 10_000, 8)])
def test_auto_max_run_equals_jax(args):
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        want = ref.auto_max_run(*args)
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = port.auto_max_run(*args)
    assert got == want
    assert [(w.category, str(w.message)) for w in w_port] == \
        [(w.category, str(w.message)) for w in w_ref]


def test_auto_max_run_warns_when_the_budget_starves_it():
    with pytest.warns(RuntimeWarning, match="undercounted"):
        assert port.auto_max_run(5000, 10_000, 8) < 8


def test_composite_overflow_guard():
    codes = np.zeros((2, 8), np.int8)
    lens = np.full(2, 8, np.int32)
    with pytest.raises(ValueError, match="n_reads"):
        port.overlap_stats_sorted(codes, lens, wordlen=4, n_reads=3,
                                  device="cpu")
    big = np.zeros((50_000, 2), np.int8)
    with pytest.raises(ValueError, match="overflows int32"):
        port.overlap_stats_sorted(big, np.full(50_000, 2, np.int32),
                                  wordlen=2, n_reads=50_000, bucket=1,
                                  max_run=1, device="cpu")


def test_sorted_allvsall_without_seeds_matches_jax():
    """Reads too short for a word, and one read alone with words: no
    seed at all, every pair at the zero band, as in the JAX package."""
    codes = np.random.default_rng(0).integers(0, 4, (3, 50)).astype(np.int8)
    codes[2] = np.arange(50) % 4
    lens = np.asarray([3, 2, 50], np.int32)
    got, want = both(codes, lens, wordlen=8, n_reads=3, bucket=8)
    assert_stats_match(got, want)
    assert not got["window"].any()
