"""The port's k-mer module (biseqt_tpu_torch.kmers) against the JAX
package's, on the same sequences, on the CPU.

Exact throughout: packed keys, the sorted (key, seq, pos) table, hits,
distinct k-mers and counts, what masking drops, and the ``.npz``
snapshots, which each package loads from the other.  The k-mer scores
(float32 on the device) to rtol 1e-5, atol 1e-6.  Also held: the
uint64 repair of ``as_kmer_keys_np`` (the JAX package's raises
``UFuncTypeError`` on unsigned 64-bit codes).
"""

import io
import os

import numpy as np
import pytest
import torch

from biseqt_tpu import kmers as ref
from biseqt_tpu.database import DB as RefDB
from biseqt_tpu.sequence import Alphabet, Sequence
from biseqt_tpu.stochastics import rand_seq
from biseqt_tpu_torch import kmers as port
from biseqt_tpu_torch.database import DB
from biseqt_tpu_torch.sequence import from_reference

RTOL, ATOL = 1e-5, 1e-6
A4 = Alphabet("ACGT")
P4 = from_reference(A4)


def _seqs(seed, lens):
    rng = np.random.default_rng(seed)
    return [rand_seq(A4, n, rng=rng) for n in lens]


def _both(seqs, wordlen, **kw):
    return (ref.KmerIndex(wordlen, A4, **kw).index_kmers(seqs),
            port.KmerIndex(wordlen, P4, device="cpu").index_kmers(
                [from_reference(s) for s in seqs]))


def _same_table(got, want):
    for g, w in zip(got.table(), want.table()):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got.num_kmers, got.num_seqs) == (want.num_kmers, want.num_seqs)


def test_kmer_as_int_and_as_kmer_seq_match():
    for a in range(4):
        for b in range(4):
            for c in range(4):
                assert port.kmer_as_int((a, b, c), P4) == \
                    ref.kmer_as_int((a, b, c), A4)
    for s in _seqs(1, (1, 7, 50)):
        for w in (1, 3, 8):
            assert port.as_kmer_seq(from_reference(s), w) == \
                ref.as_kmer_seq(s, w)


def test_as_kmer_seq_wide_wordlen_matches():
    """|Σ|**wordlen >= 2**63: the exact Python-int loop."""
    A2 = Alphabet("01")
    s = Sequence(A2, np.array([1] + [0] * 64 + [1, 1], np.int8))
    got = port.as_kmer_seq(from_reference(s), 63)
    assert got == ref.as_kmer_seq(s, 63)
    assert got[0] == 2 ** 62 and len(got) == 5


def test_as_kmer_keys_np_negative_and_edge_windows_match():
    c = np.array([0, 1, -1, 2, 3, 0, 1, 2], np.int64)
    got = port.as_kmer_keys_np(c, 3, 4)
    assert got.tolist() == ref.as_kmer_keys_np(c, 3, 4).tolist() == \
        [-1, -1, -1, 2 * 16 + 3 * 4, 3 * 16 + 1, 1 * 4 + 2]
    assert got.dtype == np.int64
    assert port.as_kmer_keys_np(np.array([1, 2], np.int8), 3, 4).size == 0
    cf = np.array([0.0, 1.0, -1.0, 2.0], np.float64)
    assert port.as_kmer_keys_np(cf, 2, 4).tolist() == \
        ref.as_kmer_keys_np(cf, 2, 4).tolist() == [1, -1, -1]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.uint64, np.int8,
                                   np.int32, np.float64])
def test_as_kmer_keys_np_accepts_every_code_dtype(dtype):
    """The repair: unsigned codes (uint64 raised ``UFuncTypeError`` in the
    JAX package's in-place pass) give the int64 codes' keys."""
    codes = np.random.default_rng(2).integers(0, 4, 40)
    want = ref.as_kmer_keys_np(codes.astype(np.int64), 5, 4)
    got = port.as_kmer_keys_np(codes.astype(dtype), 5, 4)
    assert got.dtype == np.int64 and got.tolist() == want.tolist()
    short = np.array([0, 1, 2, 3, 0, 1], dtype)
    assert port.as_kmer_keys_np(short, 3, 4).tolist() == [6, 27, 44, 49]


def test_jax_package_uint64_defect_is_not_inherited():
    codes = np.array([0, 1, 2, 3, 0, 1], np.uint64)
    with pytest.raises(TypeError):
        ref.as_kmer_keys_np(codes, 3, 4)
    assert port.as_kmer_keys_np(codes, 3, 4).tolist() == [6, 27, 44, 49]


@pytest.mark.parametrize("seed,lens,wordlen", [
    (3, (60,) * 5, 5),
    (4, (10, 7, 16, 3, 40), 4),          # one row shorter than the word
    (5, (300, 120, 500), 8),
    (6, (200, 200), 2),                  # every key repeated many times
])
def test_index_table_and_queries_match(seed, lens, wordlen):
    want, got = _both(_seqs(seed, lens), wordlen)
    _same_table(got, want)
    assert got.kmers() == want.kmers()
    for g, w in zip(got.counts(), want.counts()):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    for km in want.kmers()[:60] + [4 ** wordlen - 1, 0]:
        assert got.hits(km) == want.hits(km)


def test_score_kmers_and_masking_threshold_match():
    """The scores within tolerance; masking at a threshold equal to a
    k-mer's own score keeps that k-mer (the test is ``>``), and drops
    exactly the JAX package's occurrences."""
    rng = np.random.default_rng(7)
    core = Sequence(A4, (0, 1, 2, 3, 0) * 30)
    seqs = [core, rand_seq(A4, 150, rng=rng), Sequence(A4, (0, 1, 0, 2) * 40)]
    want, got = _both(seqs, 5)
    (wu, ws), (gu, gs) = want.score_kmers(), got.score_kmers()
    assert np.array_equal(gu, wu) and gs.dtype == np.float32
    d = np.abs(gs.astype(np.float64) - ws)
    print("k-mer scores: max |d| %.3g over %d" % (d.max(), d.size))
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
    # thresholds between distinct scores, so float rounding cannot flip
    # a k-mer; and one equal to the top score (nothing above it)
    distinct = np.unique(ws)
    for thr in [(distinct[-2] + distinct[-3]) / 2, 5.0, float(distinct[-1])]:
        w_idx, g_idx = _both(seqs, 5)
        assert g_idx.mask_repetitive(max_score=thr) == \
            w_idx.mask_repetitive(max_score=thr)
        _same_table(g_idx, w_idx)
    assert g_idx.num_kmers == want.num_kmers    # the top score kept


def test_empty_index_queries():
    idx = port.KmerIndex(4, P4, device="cpu")
    assert idx.hits(3) == [] and idx.kmers() == []
    assert [x.size for x in idx.counts()] == [0, 0]
    with pytest.raises(ValueError, match="no sequences"):
        idx.index_kmers([])
    with pytest.raises(ValueError, match="fit int32"):
        port.KmerIndex(16, P4, device="cpu")


def test_incremental_refresh_matches():
    """insert, refresh, insert, refresh through each package's DB hook:
    the merged tables are equal; a refresh with nothing pending keeps
    the table; a direct index followed by a refresh keeps both."""
    def run(db_cls, idx_cls, alphabet, **kw):
        db = db_cls(":memory:", alphabet)
        idx = idx_cls(4, alphabet, **kw).attach_to(db)
        db.load_fasta(io.StringIO(">a\nACGTACGTAC\n"))
        idx.refresh()
        db.load_fasta(io.StringIO(">b\nTTACGTTT\n>c\nACGTTTACG\n"))
        idx.refresh()
        tbl = idx.table()
        idx.refresh()
        assert idx.table()[0] is tbl[0]
        direct = idx_cls(4, alphabet, **kw)
        direct.index_kmers([alphabet.parse("GGACGTACGG")])
        db2 = db_cls(":memory:", alphabet)
        direct.attach_to(db2)
        db2.load_fasta(io.StringIO(">d\nTTACGTTT\n"))
        direct.refresh()
        return idx, direct

    want = run(RefDB, ref.KmerIndex, A4)
    got = run(DB, port.KmerIndex, P4, device="cpu")
    km = ref.kmer_as_int([0, 1, 2, 3], A4)
    for g, w in zip(got, want):
        _same_table(g, w)
        assert g.hits(km) == w.hits(km)
    assert {s for s, _ in got[0].hits(km)} == {0, 1, 2}
    assert got[1].num_seqs == 2 and got[1].num_kmers == 7 + 5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_loads_in_the_other_package(tmp_path, writer):
    seqs = _seqs(8, (40, 33, 57))
    p = str(tmp_path / "idx.npz")
    if writer == "jax":
        want = ref.KmerIndex(4, A4, path=p).index_kmers(seqs)
        got = port.KmerIndex(4, P4, path=p, device="cpu")
    else:
        got = port.KmerIndex(4, P4, path=p, device="cpu").index_kmers(
            [from_reference(s) for s in seqs])
        want = ref.KmerIndex(4, A4, path=p)
    _same_table(got, want)
    assert got._lens == want._lens and got._ids == want._ids
    assert got._ids == [s.content_id for s in seqs]
    km = want.kmers()[3]
    assert got.hits(km) == want.hits(km)
    z = np.load(p, allow_pickle=True)
    assert sorted(z.files) == ["ids", "keys", "lens", "letters", "poss",
                               "seqs", "wordlen"]
    assert z["ids"].dtype == object and str(z["letters"]) == "A\x00C\x00G\x00T"


def test_snapshot_path_without_suffix_and_mismatches(tmp_path):
    p = str(tmp_path / "idx_cache")          # no .npz suffix on purpose
    idx = port.KmerIndex(4, P4, path=p, device="cpu")
    idx.index_kmers([Sequence(A4, (0, 1, 2, 3, 0, 1, 2, 3))])
    assert os.path.exists(p + ".npz")
    again = port.KmerIndex(4, P4, path=p, device="cpu")
    assert again.num_kmers == idx.num_kmers == 5
    with pytest.raises(ValueError, match="alphabet mismatch"):
        port.KmerIndex(4, from_reference(Alphabet("TGCA")), path=p,
                       device="cpu")
    with pytest.raises(ValueError, match="wordlen mismatch"):
        port.KmerIndex(5, P4, path=p, device="cpu")


def test_masking_persists_to_the_snapshot(tmp_path):
    """The masked table is what the next process loads, in either
    package."""
    rng = np.random.default_rng(5)
    p = str(tmp_path / "idx.npz")
    seqs = [Sequence(A4, tuple(rng.integers(0, 4, 500).tolist())),
            Sequence(A4, (0, 1, 0, 2) * 100)]
    idx = port.KmerIndex(4, P4, path=p, device="cpu")
    idx.index_kmers([from_reference(s) for s in seqs])
    removed = idx.mask_repetitive(max_score=5.0)
    assert removed > 0
    _same_table(port.KmerIndex(4, P4, path=p, device="cpu"),
                ref.KmerIndex(4, A4, path=p))
    assert ref.KmerIndex(4, A4, path=p).num_kmers == idx.num_kmers


def test_kmer_cache_matches_and_is_shared(tmp_path):
    s = rand_seq(A4, 50, rng=9)
    d = str(tmp_path / "kc")
    want = ref.KmerCache(d, wordlen=6, alphabet=A4).as_kmer_seq(s)
    cache = port.KmerCache(d, wordlen=6, alphabet=P4)
    assert os.path.basename(cache._file(from_reference(s))) == \
        os.path.basename(ref.KmerCache(d, 6, A4)._file(s))
    got = cache.as_kmer_seq(from_reference(s))         # the JAX file
    fresh = port.KmerCache(str(tmp_path / "own"), 6, P4).as_kmer_seq(
        from_reference(s))
    assert got.tolist() == want.tolist() == fresh.tolist() == \
        ref.as_kmer_seq(s, 6)
