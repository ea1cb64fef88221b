"""The port's table ops (biseqt_tpu_torch.ops.tables) against the JAX
package's, on the same seeded inputs, on the CPU.

Integers are held exactly.  The JAX ``seed_join`` sorts T's keys with an
unstable sort, so the order of one S position's seeds is unspecified
there: its seeds are held as a set (and their S positions in order);
``seed_join_sorted``'s (d_, a) order is total and held exactly.  The
port has no static capacity: a join emits exactly its seeds, held to
the JAX package's valid slots (its output at a capacity, cut to the
total); past 2^31 - 1 seeds, where the JAX total wraps negative, it
raises OverflowError.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from biseqt_tpu.ops import tables as ref
from biseqt_tpu_torch.ops import tables as port
from biseqt_tpu_torch.seeds import SeedIndex
from biseqt_tpu_torch.sequence import Alphabet, Sequence

CPU = dict(device="cpu")


def _codes(rng, B, L, A=4, pad_inside=0.0):
    """int8 codes with PAD (-1) tails past random lengths and, with
    ``pad_inside``, PAD letters inside the rows too."""
    codes = rng.integers(0, A, (B, L)).astype(np.int8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = L
    codes[np.arange(L)[None, :] >= lens[:, None]] = -1
    if pad_inside:
        codes[rng.random((B, L)) < pad_inside] = -1
        codes[0, L // 3] = -1         # row 0 is whole: one PAD inside
    return codes, lens


def _np(x):
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x)


@pytest.mark.parametrize("wordlen,A,pad_inside", [
    (1, 4, 0.0), (5, 4, 0.0), (8, 4, 0.02), (12, 4, 0.01), (15, 4, 0.0),
    (3, 20, 0.05)])
def test_kmer_keys_match(wordlen, A, pad_inside):
    rng = np.random.default_rng(wordlen * 100 + A)
    codes, lens = _codes(rng, 5, 64, A, pad_inside)
    want = np.asarray(ref.kmer_keys(jnp.asarray(codes), jnp.asarray(lens),
                                    wordlen, A))
    got = _np(port.kmer_keys(codes, lens, wordlen, A, **CPU))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    if pad_inside:
        # a PAD inside a window sentinels it
        inside = (codes == -1) & (np.arange(64)[None, :] < lens[:, None])
        assert inside.any()
        b, p = np.argwhere(inside)[0]
        assert (got[b, max(p - wordlen + 1, 0):p + 1] == port.KEY_SENTINEL
                ).all()


def test_kmer_keys_short_rows():
    """Rows shorter than the word: every window is a sentinel (the JAX
    function refuses this shape), and one letter longer: one key."""
    codes = np.zeros((2, 3), np.int8)
    lens = np.asarray([3, 2], np.int32)
    got = _np(port.kmer_keys(codes, lens, 5, **CPU))
    assert got.shape == (2, 3) and (got == port.KEY_SENTINEL).all()
    codes = np.asarray([[1, 2, 3, 0, 1, -1]], np.int8)
    lens = np.asarray([5], np.int32)
    got = _np(port.kmer_keys(codes, lens, 5, **CPU))
    assert np.array_equal(got, np.asarray(ref.kmer_keys(
        jnp.asarray(codes), jnp.asarray(lens), 5)))
    assert got[0, 0] == 1 * 256 + 2 * 64 + 3 * 16 + 0 * 4 + 1


@pytest.mark.parametrize("wordlen,A", [(16, 4), (8, 20)])
def test_kmer_keys_int32_value_error(wordlen, A):
    codes, lens = np.zeros((1, 32), np.int8), np.asarray([32], np.int32)
    with pytest.raises(ValueError, match="fit int32"):
        ref.kmer_keys(jnp.asarray(codes), jnp.asarray(lens), wordlen, A)
    with pytest.raises(ValueError, match="fit int32"):
        port.kmer_keys(codes, lens, wordlen, A, **CPU)


@pytest.mark.parametrize("wordlen", [3, 6])
def test_build_kmer_table_and_nway_match(wordlen):
    rng = np.random.default_rng(wordlen)
    codes, lens = _codes(rng, 6, 80, 4, 0.01)
    want = [np.asarray(x) for x in ref.build_kmer_table(
        jnp.asarray(codes), jnp.asarray(lens), wordlen, 4)]
    got = [_np(x) for x in port.build_kmer_table(codes, lens, wordlen,
                                                 **CPU)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    want = [np.asarray(x) for x in ref.nway_shared_seeds(
        jnp.asarray(codes), jnp.asarray(lens), wordlen, 4)]
    got = [_np(x) for x in port.nway_shared_seeds(codes, lens, wordlen,
                                                  **CPU)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_hit_ranges_and_run_boundaries_match():
    rng = np.random.default_rng(11)
    table = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
    table[-7:] = port.KEY_SENTINEL
    query = np.concatenate([rng.integers(-3, 55, 200),
                            [port.KEY_SENTINEL]]).astype(np.int32)
    want = ref.hit_ranges(jnp.asarray(table), jnp.asarray(query))
    got = port.hit_ranges(table, query, **CPU)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    for keys in (table, np.asarray([-1, -1, 0, 0, 2], np.int32)):
        want = ref.run_boundaries(jnp.asarray(keys))
        got = port.run_boundaries(keys, **CPU)
        for g, w in zip(got, want):
            assert np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("capacity", [None, 1, 37, 64, 200])
def test_expand_join_matches(capacity):
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 5, 20).astype(np.int32)
    counts[[0, 7, 19]] = 0
    starts = rng.integers(0, 100, 20).astype(np.int32)
    total = int(counts.sum())
    # the JAX package at its capacity: the first min(capacity, total)
    # slots are the pairs, the rest masked
    capacity = total if capacity is None else capacity
    wq, wt, wv, wtotal = ref.expand_join(jnp.asarray(starts),
                                         jnp.asarray(counts), capacity)
    assert int(wtotal) == total
    n = min(capacity, total)
    assert np.asarray(wv)[:n].all() and not np.asarray(wv)[n:].any()
    got = port.expand_join(starts, counts, **CPU)
    assert [len(_np(g)) for g in got] == [total, total]
    for g, w in zip(got, (wq, wt)):
        assert np.array_equal(_np(g)[:n], np.asarray(w)[:n])


def test_expand_join_empty():
    q, t = port.expand_join(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            **CPU)
    assert len(_np(q)) == len(_np(t)) == 0
    q, t = port.expand_join(np.zeros(3, np.int32), np.zeros(3, np.int32),
                            **CPU)
    assert len(_np(q)) == len(_np(t)) == 0


def test_expand_join_overflow(monkeypatch):
    """Past 2^31 - 1 pairs the JAX total wraps negative, and the port
    raises before it allocates a slot; a join of exactly the limit
    still fits (the limit lowered here to reach it cheaply)."""
    counts = np.asarray([1 << 30, 1 << 30, 2], np.int32)
    starts = np.zeros(3, np.int32)
    want = ref.expand_join(jnp.asarray(starts), jnp.asarray(counts), 4)
    assert int(want[3]) < 0
    with pytest.raises(OverflowError, match="2\\^31"):
        port.expand_join(starts, counts, **CPU)
    monkeypatch.setattr(port, "MAX_SEEDS", 9)
    counts = np.asarray([4, 5], np.int32)
    assert len(_np(port.expand_join(starts[:2], counts, **CPU)[0])) == 9
    with pytest.raises(OverflowError, match="2\\^31"):
        port.expand_join(starts[:2], counts + 1, **CPU)


def test_seed_index_overflow_error(monkeypatch):
    """SeedIndex raises the JAX package's OverflowError when the join
    passes the seed limit (lowered here to reach it)."""
    A4 = Alphabet("ACGT")
    S = Sequence(A4, np.zeros(40, np.int8))
    monkeypatch.setattr(port, "MAX_SEEDS", 100)
    with pytest.raises(OverflowError, match="wordlen=4"):
        SeedIndex(S, S, 4, device="cpu")


def _pair(seed, L0, L1, planted=True):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, L0).astype(np.int8)
    t = rng.integers(0, 4, L1).astype(np.int8)
    if planted:
        n = min(L0, L1) // 2
        t[L1 - n:] = s[:n]
        flip = rng.random(n) < 0.1
        t[L1 - n:][flip] = (t[L1 - n:][flip] + 1) % 4
    return s, t


@pytest.mark.parametrize("seed,L0,L1,wordlen", [
    (0, 300, 250, 5), (1, 512, 512, 8), (2, 100, 400, 4), (3, 64, 64, 12),
    (4, 20, 30, 6)])
def test_seed_joins_match(seed, L0, L1, wordlen):
    s, t = _pair(seed, L0, L1)
    # PAD tails: the true lengths ride alongside
    s_pad = np.concatenate([s, np.full(13, -1, np.int8)])
    args = (s_pad, L0, t, L1, wordlen, 4)
    jargs = (jnp.asarray(s_pad), jnp.int32(L0), jnp.asarray(t),
             jnp.int32(L1), wordlen, 4)
    total = int(ref.seed_total(*jargs))
    assert port.seed_total(*args, **CPU) == total
    cap = max(total, 1)
    want = ref.seed_join(*jargs, capacity=cap)
    got = port.seed_join(*args, **CPU)
    assert int(want["total"]) == total
    wi, wj, wv = (np.asarray(want[k]) for k in ("i", "j", "valid"))
    gi, gj = _np(got["i"]), _np(got["j"])
    assert len(gi) == len(gj) == total == wv.sum()
    assert np.array_equal(gi, wi[wv])
    assert sorted(zip(gi, gj)) == sorted(zip(wi[wv], wj[wv]))
    # every pair is a k-mer match
    for i, j in zip(gi, gj):
        assert np.array_equal(s[i:i + wordlen], t[j:j + wordlen])
    # the JAX package's sorted join at a capacity past the total: its
    # first total slots are the port's, the rest the sentinel tail
    want = ref.seed_join_sorted(*jargs, capacity=cap + 5)
    got = port.seed_join_sorted(*args, **CPU)
    assert int(want["total"]) == total
    assert (np.asarray(want["d_"])[total:] == port.KEY_SENTINEL).all()
    for k in ("d_", "a"):
        assert np.array_equal(_np(got[k]), np.asarray(want[k])[:total]), k
