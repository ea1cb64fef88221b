"""The port's Word-Blot (biseqt_tpu_torch.blot) against the JAX
package's, on the same sequences, on the CPU.

Segments, their seed counts and their order are held exactly, on both
assemblers (the dense grid, and the sparse run merging forced by
``MAX_GRID_CELLS = 1`` on both classes, restored after); p̂ and the
(S0, S1) scores to rtol 1e-5, atol 1e-6, printing the largest |d|.  The
planted homologies keep p̂ away from p_min.  Also held: the grid and its
3x3 sums, the fallback's densest band on pairs with no segment (a
seedless one among them), per-seed scores, and the overlap mode.  The
sparse assembler's candidate tuples are also held to the JAX package's
loop on seeds laid out by hand to stress its merge rule, and its
connected components to scipy's.

The fixed-reference modes and ``WordBlotMultiple`` have one tier in the
port (the reference's table or the N-way k-mer table sorted on the
device); each is held to both of the JAX package's tiers (its host
``argsort`` / dict tier and its device tier), with the same
tolerances: the reference tables, each query's seed arrays, the
segments of ``similar_segments`` and ``similar_segments_batch``
(both assemblers), the overlap bands, the N-way segments and per-seed
scores.  At words too wide for int32 keys (DNA word length 16, the
20-letter protein alphabet at 8) they are held to the JAX package's host
tier, the one that answers there, and past its size limit they raise as
its device tier does.
"""

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

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


# the sparse assembler's rule on seeds laid out by hand: runs given as
# (d-cell, first a, seeds, a-step) at DCELL 5 and ACELL 10, so a run
# breaks at an a-gap over 20 and two runs of adjacent cells meet when
# the later one starts at most 20 after the earlier one ends
DCELL, ACELL = 5, 10
SPARSE_LAYOUTS = {  # name: (runs, K_min, |S|)
    # equal first antidiagonals across adjacent cells
    "ties": ([(3, 100, 5, 4), (4, 100, 5, 4), (2, 100, 4, 6),
              (5, 130, 3, 3), (6, 100, 4, 5), (7, 100, 3, 9)], 10, 5000),
    # one chain through five cells, a second through three, apart
    "chains": ([(1, 100, 6, 5), (2, 140, 6, 5), (3, 180, 6, 5),
                (4, 220, 6, 5), (5, 260, 6, 5), (9, 400, 4, 5),
                (10, 425, 4, 5), (11, 450, 4, 5), (10, 700, 3, 5)],
               10, 5000),
    # a long run whose padded range meets two runs of the next cell and
    # one of the cell before; a third run of the next cell stays apart
    "fork": ([(3, 100, 30, 5), (4, 110, 3, 5), (4, 160, 3, 5),
              (4, 300, 4, 5), (2, 240, 3, 5), (2, 290, 3, 5)], 10, 5000),
    # runs of 1-2 seeds between a cell's kept runs, and beside them
    "short_runs": ([(3, 100, 4, 5), (3, 140, 2, 5), (3, 170, 1, 1),
                    (3, 200, 5, 5), (4, 125, 2, 3), (4, 230, 1, 1),
                    (2, 150, 2, 4)], 10, 5000),
    # components shorter than K_min among longer ones, and one of
    # exactly K_min (119 antidiagonals after its first)
    "short_boxes": ([(1, 100, 3, 2), (2, 110, 3, 2), (5, 200, 25, 8),
                     (6, 300, 4, 8), (8, 900, 3, 3), (9, 1000, 12, 10),
                     (12, 1500, 18, 7)], 60, 5000),
    # the segment length clamped to |S|, once at K_min and once below
    "clamped": ([(1, 100, 30, 10), (4, 600, 20, 10)], 40, 40),
    "clamped_out": ([(1, 100, 30, 10), (4, 600, 20, 10)], 41, 40),
    # no run of three seeds at all
    "no_run": ([(1, 100, 2, 5), (2, 100, 1, 1), (3, 400, 2, 9),
                (3, 500, 2, 9)], 1, 5000),
}


class _BruteSeeds:
    """Seed arrays, with counts by a scan of every seed."""

    def __init__(self, d_, a, lt):
        self.d_, self.a, self.lt = d_, a, lt

    def seed_arrays(self):
        return self.d_, self.a

    def seed_count(self, d_band, a_band):
        d = self.d_ - self.lt
        return int(((d >= d_band[0]) & (d <= d_band[1])
                    & (self.a >= a_band[0]) & (self.a <= a_band[1])).sum())


def _layout_seeds(runs, rng, noise=0):
    """(d_, a) of the runs, each seed on a random diagonal of its cell,
    plus ``noise`` scattered seeds, unique and sorted by (d_, a)."""
    d_, a = [], []
    for cell, a0, n, step in runs:
        a.extend(a0 + step * np.arange(n))
        d_.extend(cell * DCELL + rng.integers(0, DCELL, n))
    d_ = np.concatenate([np.asarray(d_, np.int64),
                         rng.integers(0, 16 * DCELL, noise)])
    a = np.concatenate([np.asarray(a, np.int64),
                        rng.integers(0, 3000, noise)])
    d_, a = np.unique(np.stack([d_, a]), axis=1)
    return d_, a


def _random_layout(seed):
    """Runs of 1-8 seeds, steps up to 12, in 14 adjacent cells, about
    half of them in a few clusters so that they chain; random K_min."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(int(rng.integers(1, 5))):
        c0, a0 = int(rng.integers(0, 10)), int(rng.integers(0, 2500))
        for _ in range(int(rng.integers(2, 12))):
            runs.append((c0 + int(rng.integers(0, 4)),
                         a0 + int(rng.integers(-30, 120)),
                         int(rng.integers(1, 9)), int(rng.integers(1, 13))))
    for _ in range(int(rng.integers(0, 30))):
        runs.append((int(rng.integers(0, 14)), int(rng.integers(0, 3000)),
                     int(rng.integers(1, 9)), int(rng.integers(1, 13))))
    K_min = int(rng.choice([1, 20, 45, 100]))
    return runs, K_min, 5000, int(rng.integers(0, 200))


@pytest.mark.parametrize("layout", list(SPARSE_LAYOUTS)
                         + ["random%d" % k for k in range(12)])
def test_sparse_assembler_keeps_the_loops_rule(layout):
    """The port's whole-array sparse assembler gives the JAX package's
    loop's candidate tuples, in its order, on seeds that stress the
    rule: ties in the runs' first antidiagonals across adjacent cells,
    chains through three or more cells, one run meeting two of an
    adjacent cell, runs of 1-2 seeds between kept runs, boxes shorter
    than K_min, no run of three at all, and random layouts."""
    if layout.startswith("random"):
        runs, K_min, ls, noise = _random_layout(int(layout[6:]))
    else:
        (runs, K_min, ls), noise = SPARSE_LAYOUTS[layout], 0
    lt = 5000
    d_, a = _layout_seeds(runs, np.random.default_rng(len(runs)), noise)
    boxes = []
    for mod in (ref, port):
        wb = mod.WordBlot.__new__(mod.WordBlot)
        wb.S, wb.T = np.zeros(ls), np.zeros(lt)
        wb.seed_index = _BruteSeeds(d_, a, lt)
        boxes.append(wb._collect_sparse(K_min, DCELL, ACELL))
    want, got = boxes
    assert got == want
    assert [type(x) for box in got for x in box] == \
        [type(x) for box in want for x in box]
    if layout in ("no_run", "clamped_out"):
        assert not want
    elif not layout.startswith("random"):
        assert want, "no candidate: the case is vacuous"


@pytest.mark.parametrize("graph", ["path", "random", "edgeless"])
def test_components_label_each_by_its_lowest_node(graph):
    """The sparse assembler's connected components against scipy's: a
    path through 5000 nodes in random order, a random graph of 5000
    nodes and edges, and no edge at all."""
    n = 5000
    rng = np.random.default_rng(23)
    if graph == "path":
        perm = rng.permutation(n)
        src, dst = perm[1:], perm[:-1]
    elif graph == "random":
        src, dst = rng.integers(0, n, n), rng.integers(0, n, n)
    else:
        src = dst = np.zeros(0, np.int64)
    label = port._components(n, src, dst)
    k, comp = connected_components(
        coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)),
        directed=False)
    lowest = np.full(k, n)
    np.minimum.at(lowest, comp, np.arange(n))
    assert np.array_equal(label, lowest[comp])


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


# ---------------------------------------------------------------------------
# fixed-reference modes
# ---------------------------------------------------------------------------

def _ref_and_queries(seed, ref_len=3000, n=4):
    """A random reference and queries: mutated copies of its loci with
    random flanks, one unrelated, one shorter than the word."""
    rng = np.random.default_rng(seed)
    T = rand_seq(A4, ref_len, rng=rng)
    M = MutationProcess(A4, subst_probs=0.08, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    queries = [rand_seq(A4, 400, rng=rng), rand_seq(A4, 5, rng=rng)]
    for _ in range(n):
        r0 = int(rng.integers(0, ref_len - 900))
        queries.append(rand_seq(A4, int(rng.integers(0, 200)), rng=rng)
                       + M.mutate(T[r0:r0 + 800])[0]
                       + rand_seq(A4, 100, rng=rng))
    return T, queries


def _fixed_both_tiers(cls, T, **kw):
    """The port's index and the JAX package's two tiers; the tables
    must be equal."""
    got = getattr(port, cls)(from_reference(T), device="cpu", **kw)
    wants = [getattr(ref, cls)(T, device=tier, **kw)
             for tier in (True, False)]
    for want in wants:
        assert np.array_equal(got._ref_keys, want._ref_keys)
        assert np.array_equal(got._ref_pos, want._ref_pos)
        assert got._ref_keys.dtype == got._ref_pos.dtype == np.int64
    return got, wants


@pytest.mark.parametrize("seed,kw,K_min,p_min", [
    (40, dict(wordlen=8, g_max=0.2), 100, 0.5),
    (41, dict(wordlen=10, g_max=0.25, sensitivity=0.95), 300, 0.6),
])
@pytest.mark.parametrize("assembler", ["dense", "sparse"])
def test_local_ref_matches_both_tiers(monkeypatch, seed, kw, K_min, p_min,
                                      assembler):
    T, queries = _ref_and_queries(seed)
    if assembler == "sparse":
        for cls in (ref.WordBlot, port.WordBlot):
            monkeypatch.setattr(cls, "MAX_GRID_CELLS", 1)
    got, wants = _fixed_both_tiers("WordBlotLocalRef", T, **kw)
    pq = [from_reference(q) for q in queries]
    serial = [list(got.similar_segments(q, K_min=K_min, p_min=p_min))
              for q in pq]
    assert sum(1 for segs in serial if segs) >= 4
    for want in wants:
        for q, g, segs in zip(queries, pq, serial):
            wb_ref = want._as_wordblot(ref.WordBlot, q)
            wb = got._as_wordblot(port.WordBlot, g)
            for a, b in zip(wb.seed_index.seed_arrays(),
                            wb_ref.seed_index.seed_arrays()):
                assert np.array_equal(a, b)
            assert wb.seed_index._acap == wb_ref.seed_index._acap
            _same_segments(segs, list(want.similar_segments(
                q, K_min=K_min, p_min=p_min)))
    batch = got.similar_segments_batch(pq, K_min=K_min, p_min=p_min)
    want_batch = wants[0].similar_segments_batch(queries, K_min=K_min,
                                                 p_min=p_min)
    assert len(batch) == len(queries)
    for b, s, w in zip(batch, serial, want_batch):
        assert b == s                    # the batch equals the serial API
        _same_segments(b, w)


def test_local_ref_batch_of_seedless_queries():
    T, _ = _ref_and_queries(42)
    got, _ = _fixed_both_tiers("WordBlotLocalRef", T, wordlen=8)
    q = from_reference(rand_seq(A4, 300, p=[1, 0, 0, 0], rng=1))
    assert got.similar_segments_batch([q, q], K_min=100, p_min=0.5) == [[], []]


def test_local_ref_matches_pairwise():
    """Seeds served from the reference's table are the pairwise join's."""
    T, queries = _ref_and_queries(43)
    got, _ = _fixed_both_tiers("WordBlotLocalRef", T, wordlen=8)
    q = from_reference(queries[-1])
    pair = port.WordBlot(q, from_reference(T), wordlen=8, device="cpu")
    for a, b in zip(got._as_wordblot(port.WordBlot, q).seed_index
                    .seed_arrays(), pair.seed_index.seed_arrays()):
        assert np.array_equal(a, b)
    assert list(got.similar_segments(q, K_min=100, p_min=0.5)) == \
        list(pair.similar_segments(K_min=100, p_min=0.5))


@pytest.mark.parametrize("case", ["overlap", "unrelated"])
def test_overlap_ref_matches_both_tiers(case):
    if case == "overlap":
        r1, r2 = _reads(44)
    else:
        rng = np.random.default_rng(45)
        r1, r2 = rand_seq(A4, 800, rng=rng), rand_seq(A4, 800, rng=rng)
    got, wants = _fixed_both_tiers("WordBlotOverlapRef", r2, wordlen=8,
                                   g_max=0.2)
    res = got.highest_scoring_overlap_band(from_reference(r1))
    assert (res is None) == (case != "overlap")
    for want in wants:
        w = want.highest_scoring_overlap_band(r1)
        assert (res is None) == (w is None)
        if w is not None:
            assert (res["d_band"], res["expected_len"]) == \
                (w["d_band"], w["expected_len"])
            _close([res["p"], *res["score"]], [w["p"], *w["score"]],
                   "overlap band against the reference's table")


# ---------------------------------------------------------------------------
# N-way
# ---------------------------------------------------------------------------

def _nway(seed, n, core=300, sub=0.05, flank=100):
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=sub, go_prob=0.01, ge_prob=0.05,
                        rng=rng)
    c = rand_seq(A4, core, rng=rng)
    return [rand_seq(A4, flank, rng=rng) + M.mutate(c)[0]
            + rand_seq(A4, flank, rng=rng) for _ in range(n)]


def _same_nway(got, want):
    assert [(s["segment"], s["num_seeds"]) for s in got] == \
        [(s["segment"], s["num_seeds"]) for s in want]
    if want:
        _close([(s["p"], *s["score"]) for s in got],
               [(s["p"], *s["score"]) for s in want], "N-way p-hat, S0, S1")


@pytest.mark.parametrize("seed,n,kw,K_min,p_min,min_score", [
    (50, 3, dict(wordlen=8, g_max=0.15), 80, 0.5, 25.0),
    (51, 4, dict(wordlen=6, g_max=0.2, max_hits_per_kmer=2), 100, 0.6, 25.0),
    (52, 3, dict(wordlen=4, g_max=0.15), 50, 0.35, None),   # the soup
])
def test_wordblot_multiple_matches_both_tiers(seed, n, kw, K_min, p_min,
                                              min_score):
    seqs = _nway(seed, n) if seed != 52 else [
        rand_seq(A4, 500, rng=seed + k) for k in range(n)]
    got = port.WordBlotMultiple(*[from_reference(s) for s in seqs],
                                device="cpu", **kw)
    segs = list(got.similar_segments(K_min=K_min, p_min=p_min,
                                     min_score=min_score))
    assert segs
    for tier in (True, False):
        want = ref.WordBlotMultiple(*seqs, device=tier, **kw)
        assert got.seed_index.seeds() == want.seed_index.seeds()
        _same_nway(segs, list(want.similar_segments(
            K_min=K_min, p_min=p_min, min_score=min_score)))
        assert got.band_radius(K_min) == want.band_radius(K_min)
        for n_seeds, seglen in ((0, 0), (30, 500), (10 ** 6, 10)):
            assert got.estimate_match_probability(n_seeds, seglen) == \
                want.estimate_match_probability(n_seeds, seglen)


def test_wordblot_multiple_gate_and_score_seeds_match():
    """The S0 gate rejects background soup the p-hat threshold passes,
    as in the JAX package; per-seed scores are equal."""
    soup = [rand_seq(A4, 500, rng=60 + k) for k in range(3)]
    got = port.WordBlotMultiple(*[from_reference(s) for s in soup],
                                wordlen=4, g_max=0.15, device="cpu")
    assert list(got.similar_segments(K_min=50, p_min=0.35)) == []
    seqs = _nway(61, 3, sub=0.03)
    got = port.WordBlotMultiple(*[from_reference(s) for s in seqs],
                                wordlen=6, g_max=0.15, device="cpu")
    want = ref.WordBlotMultiple(*seqs, wordlen=6, g_max=0.15)
    g, w = got.score_seeds(K=80), want.score_seeds(K=80)
    assert g and [(s["seed"], s["neighs"]) for s in g] == \
        [(s["seed"], s["neighs"]) for s in w]
    assert [s["p"] for s in g] == [s["p"] for s in w]     # host float64
    empty = port.WordBlotMultiple(
        *[from_reference(rand_seq(A4, 40, p=p, rng=1))
          for p in ([1, 0, 0, 0], [0, 1, 0, 0])], wordlen=4, device="cpu")
    assert empty.score_seeds(K=20) == []
    assert list(empty.similar_segments(K_min=20, p_min=0.5)) == []


# ---------------------------------------------------------------------------
# words too wide for int32 keys
# ---------------------------------------------------------------------------

P20 = Alphabet("ACDEFGHIKLMNPQRSTVWY")
WIDE = [(A4, 16), (P20, 8)]       # |Σ|^w = 2^32 and 2.56e10


@pytest.mark.parametrize("alphabet,wordlen", WIDE)
@pytest.mark.parametrize("assembler", ["dense", "sparse"])
def test_local_ref_wide_words_match_host_tier(monkeypatch, alphabet, wordlen,
                                              assembler):
    """A word past int32 keys on a reference under ``WIDE_MAX_REF``: the
    table, each query's seeds and the segments (serial and batched) equal
    the JAX package's host tier, the only tier of it that answers."""
    if assembler == "sparse":
        for cls in (ref.WordBlot, port.WordBlot):
            monkeypatch.setattr(cls, "MAX_GRID_CELLS", 1)
    rng = np.random.default_rng(46)
    T = rand_seq(alphabet, 3000, rng=rng)
    M = MutationProcess(alphabet, subst_probs=0.02, go_prob=0.01,
                        ge_prob=0.05, rng=rng)
    queries = [T[1000:2000], rand_seq(alphabet, 400, rng=rng),
               rand_seq(alphabet, 100, rng=rng) + M.mutate(T[200:1200])[0]]
    got = port.WordBlotLocalRef(from_reference(T), wordlen=wordlen,
                                device="cpu")
    want = ref.WordBlotLocalRef(T, wordlen=wordlen, device=False)
    assert got._ref_keys.dtype == got._ref_pos.dtype == np.int64
    assert np.array_equal(got._ref_keys, want._ref_keys)
    assert np.array_equal(got._ref_pos, want._ref_pos)
    pq = [from_reference(q) for q in queries]
    serial = [list(got.similar_segments(q, K_min=200, p_min=0.5))
              for q in pq]
    for q, g, segs in zip(queries, pq, serial):
        for a, b in zip(got._as_wordblot(port.WordBlot, g).seed_index
                        .seed_arrays(), want._as_wordblot(ref.WordBlot, q)
                        .seed_index.seed_arrays()):
            assert np.array_equal(a, b)
        _same_segments(segs, list(want.similar_segments(q, K_min=200,
                                                        p_min=0.5)))
    assert len(serial[0]) == 1 and serial[1] == [] and serial[2]
    assert got.similar_segments_batch(pq, K_min=200, p_min=0.5) == serial


@pytest.mark.parametrize("alphabet,wordlen", WIDE)
def test_overlap_ref_wide_words_match_host_tier(alphabet, wordlen):
    rng = np.random.default_rng(47)
    r2 = rand_seq(alphabet, 1500, rng=rng)
    r1 = r2[700:] + rand_seq(alphabet, 600, rng=rng)
    got = port.WordBlotOverlapRef(from_reference(r2), wordlen=wordlen,
                                  g_max=0.2, device="cpu")
    want = ref.WordBlotOverlapRef(r2, wordlen=wordlen, g_max=0.2,
                                  device=False)
    assert np.array_equal(got._ref_keys, want._ref_keys)
    res = got.highest_scoring_overlap_band(from_reference(r1))
    w = want.highest_scoring_overlap_band(r1)
    assert (res["d_band"], res["expected_len"]) == (w["d_band"],
                                                    w["expected_len"])
    _close([res["p"], *res["score"]], [w["p"], *w["score"]],
           "wide-word overlap band")


def test_fixed_ref_wide_word_answers_where_the_jax_package_does():
    """The repro: a 3 kbp reference and the query at [1000:2000] at DNA
    word length 16 give one segment on both packages.  A reference of
    ``WIDE_MAX_REF`` letters or more raises at that word, as the JAX
    package's device tier does, one letter less answers; an int32 word
    answers at any length."""
    rng = np.random.default_rng(0)
    T = rand_seq(A4, 3000, rng=rng)
    q = T[1000:2000]
    want = list(ref.WordBlotLocalRef(T, wordlen=16).similar_segments(
        q, 200, 0.5))
    got = list(port.WordBlotLocalRef(from_reference(T), wordlen=16,
                                     device="cpu").similar_segments(
        from_reference(q), 200, 0.5))
    assert len(got) == len(want) == 1
    _same_segments(got, want)
    assert port.WordBlotLocalRef.WIDE_MAX_REF == \
        ref.WordBlotLocalRef.DEVICE_MIN_REF == 1 << 16
    long = rand_seq(A4, 1 << 16, rng=rng)
    for cls in ("WordBlotLocalRef", "WordBlotOverlapRef"):
        with pytest.raises(ValueError, match="must fit int32; got 4\\^16"):
            getattr(ref, cls)(long, wordlen=16)
        with pytest.raises(ValueError, match="must fit int32; got 4\\^16"):
            getattr(port, cls)(from_reference(long), wordlen=16,
                               device="cpu")
    got = port.WordBlotLocalRef(from_reference(long[1:]), wordlen=16,
                                device="cpu")
    assert got._ref_keys.shape == (len(long) - 16,)
    assert port.WordBlotLocalRef(from_reference(long), wordlen=15,
                                 device="cpu")._ref_keys.shape == \
        (len(long) - 14,)


@pytest.mark.parametrize("alphabet,wordlen", WIDE)
def test_wordblot_multiple_wide_words_match_host_tier(alphabet, wordlen):
    rng = np.random.default_rng(53)
    M = MutationProcess(alphabet, subst_probs=0.02, go_prob=0.005,
                        ge_prob=0.05, rng=rng)
    c = rand_seq(alphabet, 600, rng=rng)
    seqs = [rand_seq(alphabet, 100, rng=rng) + M.mutate(c)[0]
            + rand_seq(alphabet, 100, rng=rng) for _ in range(3)]
    kw = dict(wordlen=wordlen, g_max=0.15)
    got = port.WordBlotMultiple(*[from_reference(s) for s in seqs],
                                device="cpu", **kw)
    want = ref.WordBlotMultiple(*seqs, device=False, **kw)
    assert got.seed_index.seeds() == want.seed_index.seeds()
    segs = list(got.similar_segments(K_min=200, p_min=0.5))
    assert segs
    _same_nway(segs, list(want.similar_segments(K_min=200, p_min=0.5)))
