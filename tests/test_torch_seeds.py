"""The port's SeedIndex (biseqt_tpu_torch.seeds) against the JAX
package's, on the same sequences, on the CPU.

The sorted (d_, a) arrays are held exactly, every band query on random
bands exactly, and a snapshot written by either package loads in the
other and answers the same.
"""

import numpy as np
import pytest

from biseqt_tpu.seeds import SeedIndex as RefSeedIndex
from biseqt_tpu.sequence import Alphabet
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch.seeds import Seed, SeedIndex
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
