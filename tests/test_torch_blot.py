"""The port's Word-Blot (biseqt_tpu_torch.blot) against the JAX
package's, on the same sequences, on the CPU.

Segments, their seed counts and their order are held exactly, on both
assemblers (the dense grid, and the sparse run merging forced by
``MAX_GRID_CELLS = 1`` on both classes, restored after); p̂ and the
(S0, S1) scores to rtol 1e-5, atol 1e-6, printing the largest |d|.  The
planted homologies keep p̂ away from p_min.  Also held: the grid and its
3x3 sums, the fallback's densest band on pairs with no segment (a
seedless one among them), per-seed scores, and the overlap mode.
"""

import numpy as np
import pytest

from biseqt_tpu import blot as ref
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import blot as port
from biseqt_tpu_torch.sequence import from_reference

RTOL, ATOL = 1e-5, 1e-6
A4 = Alphabet("ACGT")


def _planted(seed, flank=400, core=400, sub=0.1, gap=0.05, cores=1):
    """S and T sharing ``cores`` mutated cores between random flanks."""
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=sub, go_prob=gap, ge_prob=gap,
                        rng=rng)
    S = rand_seq(A4, flank, rng=rng)
    T = rand_seq(A4, flank // 2, rng=rng)
    for _ in range(cores):
        c = rand_seq(A4, core, rng=rng)
        S = S + c + rand_seq(A4, flank, rng=rng)
        T = T + M.mutate(c)[0] + rand_seq(A4, flank + 37, rng=rng)
    return S, T


def _both(S, T, cls="WordBlot", **kw):
    return (getattr(ref, cls)(S, T, **kw),
            getattr(port, cls)(from_reference(S), from_reference(T),
                               device="cpu", **kw))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)[np.isfinite(want)]
    print("%s: max |d| %.3g over %d values" % (what, d.max(initial=0.0),
                                              want.size))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _same_segments(got, want):
    """Segments, seed counts and order exactly; p and scores to the
    tolerance."""
    strip = lambda segs: [(s["segment"], s["num_seeds"]) for s in segs]
    assert strip(got) == strip(want)
    if want:
        _close([s["p"] for s in got], [s["p"] for s in want], "p-hat")
        _close([s["score"] for s in got], [s["score"] for s in want],
               "(S0, S1)")


CASES = [  # seed, planted kwargs, WordBlot kwargs, K_min, p_min
    (0, dict(), dict(wordlen=8, g_max=0.2), 150, 0.6),
    (1, dict(cores=3, core=300, flank=250), dict(wordlen=8, g_max=0.2), 100,
     0.5),
    (2, dict(sub=0.05, gap=0.02, core=600), dict(wordlen=7, g_max=0.15),
     100, 0.3),
    (3, dict(sub=0.15, cores=2), dict(wordlen=10, g_max=0.1,
                                      sensitivity=0.95), 120, 0.55),
]


@pytest.mark.parametrize("seed,planted,kw,K_min,p_min", CASES)
def test_similar_segments_dense_match(seed, planted, kw, K_min, p_min):
    S, T = _planted(seed, **planted)
    wb_ref, wb = _both(S, T, **kw)
    n_d = (len(S) + len(T)) // max(wb.band_radius(K_min), 1) + 2
    n_a = (len(S) + len(T)) // max(2 * K_min, 2) + 2
    assert n_d * n_a <= wb.MAX_GRID_CELLS
    want = list(wb_ref.similar_segments(K_min=K_min, p_min=p_min))
    got = list(wb.similar_segments(K_min=K_min, p_min=p_min))
    assert want, "no planted homology found: the case is vacuous"
    _same_segments(got, want)
    # the grid and its 3x3 sums: the JAX grid's extent is bucketed, the
    # port's is not; the rest of the JAX grid is empty
    g_ref, n_ref, *geo_ref = wb_ref._grids(K_min)
    g, n, *geo = wb._grids(K_min)
    assert geo == geo_ref
    assert np.array_equal(g, np.asarray(g_ref)[:g.shape[0], :g.shape[1]])
    assert np.array_equal(n, np.asarray(n_ref)[:n.shape[0], :n.shape[1]])
    assert np.asarray(g_ref).sum() == g.sum() == len(wb.seed_index)


@pytest.mark.parametrize("seed,planted,kw,K_min,p_min", CASES[:3])
def test_similar_segments_sparse_match(seed, planted, kw, K_min, p_min):
    S, T = _planted(seed, **planted)
    wb_ref, wb = _both(S, T, **kw)
    try:
        ref.WordBlot.MAX_GRID_CELLS = 1
        port.WordBlot.MAX_GRID_CELLS = 1
        want = list(wb_ref.similar_segments(K_min=K_min, p_min=p_min))
        got = list(wb.similar_segments(K_min=K_min, p_min=p_min))
    finally:
        ref.WordBlot.MAX_GRID_CELLS = 1 << 22
        port.WordBlot.MAX_GRID_CELLS = 1 << 22
    assert want, "no sparse segment: the case is vacuous"
    _same_segments(got, want)


@pytest.mark.parametrize("pair", ["seedless", "unrelated"])
def test_at_least_one_fallback_match(pair):
    """No segment passes: ``at_least_one`` yields the densest band, the
    same argmax cell as the JAX package's."""
    rng = np.random.default_rng(9)
    if pair == "seedless":
        S = rand_seq(A4, 300, p=[1, 0, 0, 0], rng=rng)
        T = rand_seq(A4, 260, p=[0, 1, 0, 0], rng=rng)
    else:
        S, T = rand_seq(A4, 900, rng=rng), rand_seq(A4, 700, rng=rng)
    wb_ref, wb = _both(S, T, wordlen=6, g_max=0.2)
    assert (len(wb.seed_index) == 0) == (pair == "seedless")
    assert list(wb.similar_segments(K_min=200, p_min=0.95)) == []
    want = list(wb_ref.similar_segments(K_min=200, p_min=0.95,
                                        at_least_one=True))
    got = list(wb.similar_segments(K_min=200, p_min=0.95,
                                   at_least_one=True))
    assert len(got) == len(want) == 1
    _same_segments(got, want)


def test_score_num_seeds_and_p_hat_match():
    S, T = _planted(4, flank=100, core=100)
    wb_ref, wb = _both(S, T, wordlen=8)
    for args in ((50, 2000, 100, 0.9), (0, 2000, 100, 0.9),
                 (7, 300.5, 33, 1e-3)):
        _close(wb.score_num_seeds(*args), wb_ref.score_num_seeds(*args),
               "score_num_seeds")
    for n, K in ((0, 10), (50, 100), (3000, 1000), (5, 0)):
        _close(wb.estimate_match_probability(n, K),
               wb_ref.estimate_match_probability(n, K), "p-hat")


def test_score_seeds_match():
    S, T = _planted(5, flank=200, core=300)
    wb_ref, wb = _both(S, T, wordlen=8, g_max=0.2)
    want, got = wb_ref.score_seeds(K=150), wb.score_seeds(K=150)
    assert len(got) == len(want) == len(wb.seed_index) > 0
    assert [(s["seed"], s["neighs"]) for s in got] == \
        [(s["seed"], s["neighs"]) for s in want]
    _close([s["p"] for s in got], [s["p"] for s in want], "per-seed p-hat")


def _reads(seed, shift=500):
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.04, ge_prob=0.2,
                        rng=rng)
    genome = rand_seq(A4, 1500, rng=rng)
    return M.mutate(genome[0:900])[0], M.mutate(genome[shift:shift + 900])[0]


@pytest.mark.parametrize("case", ["overlap", "unrelated", "seedless"])
def test_overlap_band_and_profile_match(case):
    if case == "overlap":
        r1, r2 = _reads(10)
    elif case == "unrelated":
        rng = np.random.default_rng(11)
        r1, r2 = rand_seq(A4, 800, rng=rng), rand_seq(A4, 800, rng=rng)
    else:
        rng = np.random.default_rng(12)
        r1 = rand_seq(A4, 200, p=[1, 0, 0, 0], rng=rng)
        r2 = rand_seq(A4, 300, p=[0, 0, 1, 0], rng=rng)
    wb_ref, wb = _both(r1, r2, cls="WordBlotOverlap", wordlen=8, g_max=0.2)
    want = wb_ref.highest_scoring_overlap_band()
    got = wb.highest_scoring_overlap_band()
    assert (got is None) == (want is None) == (case != "overlap")
    if want is not None:
        assert got["d_band"] == want["d_band"]
        assert got["expected_len"] == want["expected_len"]
        _close([got["p"], *got["score"]], [want["p"], *want["score"]],
               "overlap band")
        assert want["d_band"][0] - 100 <= 500 <= want["d_band"][1] + 100
    (d_ref, p_ref), (d, p) = wb_ref.overlap_profile(), wb.overlap_profile()
    assert np.array_equal(d, d_ref)
    _close(p, p_ref, "overlap profile")


def test_band_geometry_matches():
    Ks = np.asarray([1, 10, 150, 78125, 10 ** 6])
    for g, sens in ((0.1, 0.99), (0.3, 0.95), (0.02, 0.999)):
        assert np.array_equal(port.band_radius(Ks, g, sens),
                              ref.band_radius(Ks, g, sens))
        assert np.array_equal(port.band_radii(range(10, 100, 7), g, sens),
                              ref.band_radii(range(10, 100, 7), g, sens))
    d = np.arange(-120, 130, 5)
    assert np.array_equal(port.expected_overlap_len(100, 80, d, 0.1),
                          ref.expected_overlap_len(100, 80, d, 0.1))
    assert port.P_MIN_EPS == ref.P_MIN_EPS
