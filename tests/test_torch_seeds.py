"""The port's SeedIndex (biseqt_tpu_torch.seeds) against the JAX
package's, on the same sequences, on the CPU.

The sorted (d_, a) arrays are held exactly, every band query on random
bands exactly, and a snapshot written by either package loads in the
other and answers the same.  ``SeedIndexMultiple`` (one tier, its
k-mer table sorted on the device) is held to both of the JAX package's
tiers, the host dict tier and the device tier, exactly: the seed
tuples, their order, and the tuple budget's caps.  At words too wide for
int32 keys (past int64 too) it is held to the host tier, the one that
answers there, and past its size limit it raises as the device tier does.
"""

import numpy as np
import pytest

from biseqt_tpu import seeds as ref_seeds
from biseqt_tpu.seeds import SeedIndex as RefSeedIndex
from biseqt_tpu.sequence import Alphabet, Sequence
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import seeds as port_seeds
from biseqt_tpu_torch.seeds import Seed, SeedIndex, SeedIndexMultiple
from biseqt_tpu_torch.sequence import from_reference

A4 = Alphabet("ACGT")


def _pair(seed, n, sub=0.1, gap=0.03, flank=0):
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=sub, go_prob=gap, ge_prob=0.1,
                        rng=rng)
    S = rand_seq(A4, n, rng=rng)
    T, _ = M.mutate(S)
    if flank:
        T = rand_seq(A4, flank, rng=rng) + T
    return S, T


CASES = [(0, 300, 6, 0), (1, 800, 8, 150), (2, 2000, 12, 500),
         (3, 50, 4, 10), (4, 10, 12, 0)]


def _both(seed, n, wordlen, flank, **kw):
    S, T = _pair(seed, n, flank=flank)
    return (RefSeedIndex(S, T, wordlen, **kw),
            SeedIndex(from_reference(S), from_reference(T), wordlen,
                      device="cpu", **kw))


def _queries(ref, port, rng):
    ls, lt = len(ref.S), len(ref.T)
    for _ in range(25):
        d0, d1 = np.sort(rng.integers(-lt - 5, ls + 5, 2))
        a0, a1 = np.sort(rng.integers(-5, ls + lt + 5, 2))
        for d_band, a_band in (((d0, d1), None), ((d0, d1), (a0, a1)),
                               (None, (a0, a1)), (None, None)):
            assert port.seed_count(d_band, a_band) == \
                ref.seed_count(d_band, a_band), (d_band, a_band)
            for g, w in zip(port.seed_arrays(d_band, a_band),
                            ref.seed_arrays(d_band, a_band)):
                assert np.array_equal(g, w)
        assert port.seeds(d_band=(d0, d1), a_band=(a0, a1)) == \
            ref.seeds(d_band=(d0, d1), a_band=(a0, a1))
    assert np.array_equal(port.seed_count_by_d_(), ref.seed_count_by_d_())
    assert port.seeds() == ref.seeds()


@pytest.mark.parametrize("seed,n,wordlen,flank", CASES)
def test_seed_index_matches(seed, n, wordlen, flank):
    ref, port = _both(seed, n, wordlen, flank)
    assert len(port) == len(ref)
    assert port._d_.dtype == np.int64 and port._a.dtype == np.int64
    assert np.array_equal(port._d_, ref._d_)
    assert np.array_equal(port._a, ref._a)
    assert port._acap == ref._acap
    assert port.d_(-3) == ref.d_(-3)
    _queries(ref, port, np.random.default_rng(seed))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_both_ways(tmp_path, writer):
    """A snapshot written by one package loads in the other (no join is
    run) and answers every band query the same."""
    S, T = _pair(7, 600, flank=80)
    path = str(tmp_path / "seeds")           # '.npz' is appended
    kw = dict(wordlen=7, path=path)
    if writer == "jax":
        first = RefSeedIndex(S, T, **kw)
        second = SeedIndex(from_reference(S), from_reference(T),
                           device="cpu", **kw)
        ref, port = first, second
    else:
        first = SeedIndex(from_reference(S), from_reference(T),
                          device="cpu", **kw)
        second = RefSeedIndex(S, T, **kw)
        ref, port = second, first
    assert (tmp_path / "seeds.npz").exists()
    assert len(second) == len(first) > 0
    assert np.array_equal(second._d_, first._d_)
    _queries(ref, port, np.random.default_rng(8))
    # a snapshot of other sequences is refused
    with pytest.raises(AssertionError, match="different sequences"):
        SeedIndex(from_reference(T), from_reference(S), device="cpu", **kw)


def test_seed_tuple():
    s = Seed(3, 5)
    assert (s.i, s.j) == (3, 5) and s == (3, 5)
    assert repr(s) == "Seed(i=3, j=5)"


def _multiple_seqs(seed, n, twice=True, sub=0.05):
    """``n`` sequences sharing a mutated core, planted twice per sequence
    when ``twice`` (so shared k-mers repeat and cross products fan
    out)."""
    rng = np.random.default_rng(seed)
    M = MutationProcess(A4, subst_probs=sub, go_prob=0.02, ge_prob=0.05,
                        rng=rng)
    core = rand_seq(A4, 400, rng=rng)
    out = []
    for _ in range(n):
        s = rand_seq(A4, 100, rng=rng) + M.mutate(core)[0] \
            + rand_seq(A4, 150, rng=rng)
        if twice:
            s = s + M.mutate(core)[0] + rand_seq(A4, 80, rng=rng)
        out.append(s)
    return out


def _multiple_both_tiers(seqs, **kw):
    got = SeedIndexMultiple(*[from_reference(s) for s in seqs],
                            device="cpu", **kw)
    for tier in (True, False):
        want = ref_seeds.SeedIndexMultiple(*seqs, device=tier, **kw)
        assert got.seeds() == want.seeds(), tier
        assert len(got) == got.seed_count() == len(want)
    return got


@pytest.mark.parametrize("h", [1, 2, 4])
def test_seed_index_multiple_matches_both_tiers(h):
    got = _multiple_both_tiers(_multiple_seqs(30, 4), wordlen=8,
                               max_hits_per_kmer=h)
    assert len(got) > 30
    assert all(isinstance(x, int) for x in got.seeds()[0])
    assert got.seeds() == sorted(got.seeds())


@pytest.mark.parametrize("seed,n,wordlen", [(31, 2, 6), (32, 3, 5),
                                            (33, 6, 10)])
def test_seed_index_multiple_shapes_match_both_tiers(seed, n, wordlen):
    """Two sequences, short words (many repeats), and more sequences
    than the word shares (few or no N-way seeds)."""
    _multiple_both_tiers(_multiple_seqs(seed, n, twice=n < 6, sub=0.1),
                         wordlen=wordlen)


def test_seed_index_multiple_tuple_budget_matches_both_tiers():
    """A poly-A run saturating the cap in all six sequences would expand
    to 8^6 tuples; the budget caps it identically on every tier."""
    rng = np.random.default_rng(34)
    polyA = Sequence(A4, [0] * 60)
    seqs = [rand_seq(A4, 120, rng=rng) + polyA + rand_seq(A4, 120, rng=rng)
            for _ in range(6)]
    got = _multiple_both_tiers(seqs, wordlen=8, max_hits_per_kmer=8,
                               max_tuples_per_kmer=500)
    assert 0 < len(got) < 5000
    big = SeedIndexMultiple(*[from_reference(s) for s in seqs], wordlen=8,
                            max_hits_per_kmer=8, max_tuples_per_kmer=1 << 30,
                            device="cpu")
    assert len(big) > 200_000


def test_seed_index_multiple_without_shared_kmers():
    rng = np.random.default_rng(35)
    seqs = [rand_seq(A4, 50, p=[1, 0, 0, 0], rng=rng),
            rand_seq(A4, 60, p=[0, 1, 0, 0], rng=rng),
            rand_seq(A4, 5, rng=rng)]
    assert _multiple_both_tiers(seqs, wordlen=4).seeds() == []
    with pytest.raises(ValueError, match="max_hits_per_kmer"):
        SeedIndexMultiple(*[from_reference(s) for s in seqs],
                          max_hits_per_kmer=0, device="cpu")


def test_fit_tuple_budget_matches():
    rng = np.random.default_rng(36)
    for N, h, budget in ((3, 8, 100), (10, 8, 4096), (22, 8, 1 << 20),
                         (4, 1, 1)):
        c = rng.integers(1, h + 1, (50, N))
        got = port_seeds._fit_tuple_budget(c, h, budget)
        assert np.array_equal(got, ref_seeds._fit_tuple_budget(c, h, budget))
        assert got.dtype == np.int64
        assert (got.astype(np.float64).prod(axis=1) <= budget).all()


P20 = Alphabet("ACDEFGHIKLMNPQRSTVWY")


@pytest.mark.parametrize("alphabet,wordlen,h", [
    (A4, 16, 8), (A4, 16, 1), (P20, 8, 8),
    (A4, 32, 2),          # |Σ|^w = 2^64: past int64, the exact keys' ranks
    (P20, 15, 8),         # 20^15 > 2^63
])
def test_seed_index_multiple_wide_words_match_host_tier(alphabet, wordlen, h):
    """Words past int32 keys on inputs of at most ``WIDE_MAX_LETTERS``
    letters: the seeds equal the JAX package's host tier, the only tier
    of it that answers there."""
    rng = np.random.default_rng(37)
    M = MutationProcess(alphabet, subst_probs=0.02, go_prob=0.005,
                        ge_prob=0.05, rng=rng)
    core = rand_seq(alphabet, 500, rng=rng)
    seqs = [rand_seq(alphabet, 80, rng=rng) + M.mutate(core)[0]
            + rand_seq(alphabet, 60, rng=rng) + M.mutate(core[:200])[0]
            for _ in range(4)]
    got = SeedIndexMultiple(*[from_reference(s) for s in seqs],
                            wordlen=wordlen, max_hits_per_kmer=h,
                            device="cpu")
    want = ref_seeds.SeedIndexMultiple(*seqs, wordlen=wordlen,
                                       max_hits_per_kmer=h, device=False)
    assert got.seeds() == want.seeds()
    assert len(got) > 50


def test_seed_index_multiple_wide_word_answers_where_the_jax_package_does():
    """The repro: a 3 kbp reference and twice the query at [1000:2000]
    give 985 seeds at DNA word length 16 on both packages.  Past
    ``WIDE_MAX_LETTERS`` letters in all that word raises, as the JAX
    package's device tier does; at the limit it answers."""
    rng = np.random.default_rng(0)
    T = rand_seq(A4, 3000, rng=rng)
    q = T[1000:2000]
    want = ref_seeds.SeedIndexMultiple(T, q, q, wordlen=16).seeds()
    got = SeedIndexMultiple(*map(from_reference, (T, q, q)), wordlen=16,
                            device="cpu").seeds()
    assert len(got) == len(want) == 985 and got == want
    assert SeedIndexMultiple.WIDE_MAX_LETTERS == 200_000
    big = [rand_seq(A4, 100_000, rng=rng), rand_seq(A4, 100_001, rng=rng)]
    with pytest.raises(ValueError, match="must fit int32; got 4\\^16"):
        ref_seeds.SeedIndexMultiple(*big, wordlen=16)
    with pytest.raises(ValueError, match="must fit int32; got 4\\^16"):
        SeedIndexMultiple(*map(from_reference, big), wordlen=16,
                          device="cpu")
    at_limit = [big[0], big[1][1:]]
    assert SeedIndexMultiple(*map(from_reference, at_limit), wordlen=16,
                             device="cpu").seeds() == \
        ref_seeds.SeedIndexMultiple(*at_limit, wordlen=16).seeds()
