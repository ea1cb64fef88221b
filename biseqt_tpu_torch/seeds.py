"""Seed indexing: exact k-mer matches in diagonal/antidiagonal coordinates.

The port of :mod:`biseqt_tpu.seeds` (the reference's ``biseqt/seeds.py
— SeedIndex, SeedIndexMultiple``).  Seeds are enumerated by a
sorted-merge join on the device (:func:`.ops.tables.seed_join_sorted`)
and kept in band coordinates

    d = i - j   (diagonal; stored shifted as d_ = d + |T| >= 0)
    a = i + j   (antidiagonal)

sorted by (d_, a).  One copy brings the sorted arrays to the host, where
band queries (``seeds(d_band=..., a_band=...)``, ``seed_count``) are
binary searches, the role the reference's SQL B-tree played.  A
snapshot (``path=``, a ``.npz`` of those arrays and the sequences'
content ids) is the JAX package's format: either package loads the
other's.

``SeedIndexMultiple`` enumerates N-way seeds, one position per
sequence: the k-mer table of all N sequences is sorted on the device
(:func:`.ops.tables.nway_shared_seeds`) and the capped cross products
are expanded on the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from .kmers import as_kmer_keys_np, as_kmer_seq
from .ops import tables
from .ops.banded_dp import resolve_device
from .profiling import Phase, host_copy
from .sequence import Sequence, pack_sequences

__all__ = ["Seed", "SeedIndex", "SeedIndexMultiple"]


class Seed(tuple):
    """A seed: exact k-mer match at origin position i, mutate position j."""

    def __new__(cls, i, j):
        return tuple.__new__(cls, (int(i), int(j)))

    @property
    def i(self):
        return self[0]

    @property
    def j(self):
        return self[1]

    def __repr__(self):
        return "Seed(i=%d, j=%d)" % (self[0], self[1])


class SeedIndex:
    """All exact k-mer matches between a pair of sequences, band-queryable.

    The join runs once on ``device`` (``"cuda"`` by default; it raises
    where no card is present, ``"cpu"`` runs it on the host); the sorted
    arrays then live on the host for the O(log n) band queries of the
    Word-Blot layer.  A snapshot at ``path`` is loaded if it exists
    (``.npz`` is appended to a name without it), else written after the
    build.

    Attributes:
        S, T: the two sequences.
        wordlen: seed k-mer length.
    """

    def __init__(self, S: Sequence, T: Sequence, wordlen: int,
                 path: str = None, device="cuda"):
        assert S.alphabet == T.alphabet
        self.device = resolve_device(device)
        self.S, self.T = S, T
        self.wordlen = int(wordlen)
        self.alphabet = S.alphabet
        if path is not None and not path.endswith(".npz"):
            path = path + ".npz"
        self.path = path
        if path is not None and os.path.exists(path):
            self._load(path)
        else:
            with Phase("seeds.build"):
                self._build()
            if path is not None:
                self._save(path)

    def _build(self):
        ls, lt = len(self.S), len(self.T)
        try:
            out = tables.seed_join_sorted(
                self.S.to_array(), ls, self.T.to_array(), lt, self.wordlen,
                len(self.alphabet), device=self.device)
        except OverflowError:
            raise OverflowError(
                "seed count exceeds 2^31 for wordlen=%d — use a longer "
                "wordlen or mask repetitive k-mers" % self.wordlen) from None
        # one copy of the sorted (d_, a) arrays to the host
        with Phase("seeds.fetch"):
            da = torch.stack([out["d_"], out["a"]]).to(torch.int64)
            self._d_, self._a = host_copy(da).numpy()
        # composite key for O(log n) 2-D band queries
        self._acap = ls + lt + 1
        self._comp = self._d_ * self._acap + self._a

    # -- persistence ----------------------------------------------------------
    def _save(self, path: str):
        np.savez_compressed(
            path, d_=self._d_, a=self._a, acap=self._acap,
            wordlen=self.wordlen,
            ids=np.asarray([self.S.content_id, self.T.content_id]),
        )

    def _load(self, path: str):
        z = np.load(path, allow_pickle=True)
        assert int(z["wordlen"]) == self.wordlen, "wordlen mismatch"
        assert z["ids"].tolist() == [self.S.content_id, self.T.content_id], (
            "snapshot is for different sequences")
        self._d_ = z["d_"]
        self._a = z["a"]
        self._acap = int(z["acap"])
        self._comp = self._d_ * self._acap + self._a

    # -- conventions ----------------------------------------------------------
    def d_(self, d: int) -> int:
        """Shifted diagonal: d_ = d + |T| (kept nonnegative like the ref)."""
        return int(d) + len(self.T)

    # -- queries --------------------------------------------------------------
    def __len__(self):
        return int(self._d_.shape[0])

    def seed_count(self, d_band: Tuple[int, int] = None,
                   a_band: Tuple[int, int] = None) -> int:
        """Number of seeds with d in d_band and a in a_band (inclusive)."""
        if a_band is None:
            lo, hi = self._range(d_band)
            return int(hi - lo)
        return self._count_2d(d_band, a_band)

    def seeds(self, d_band=None, a_band=None) -> List[Seed]:
        """Seeds (i, j), optionally band-restricted; sorted by (d, a)."""
        d_arr, a_arr = self._select(d_band, a_band)
        lt = len(self.T)
        i = (a_arr + d_arr - lt) // 2
        j = (a_arr - (d_arr - lt)) // 2
        return [Seed(ii, jj) for ii, jj in zip(i, j)]

    def seed_arrays(self, d_band=None, a_band=None):
        """Band-restricted (d_, a) numpy arrays (analysis tier)."""
        return self._select(d_band, a_band)

    def seed_count_by_d_(self) -> np.ndarray:
        """Per-diagonal seed counts, indexed by shifted diagonal d_: the
        input to overlap-band scoring."""
        n_d = len(self.S) + len(self.T) + 1
        return np.bincount(self._d_, minlength=n_d).astype(np.int64)

    # -- internals ------------------------------------------------------------
    def _range(self, d_band):
        if d_band is None:
            return 0, len(self)
        lo = np.searchsorted(self._d_, self.d_(d_band[0]), side="left")
        hi = np.searchsorted(self._d_, self.d_(d_band[1]), side="right")
        return int(lo), int(hi)

    def _count_2d(self, d_band, a_band) -> int:
        d_lo = self.d_(d_band[0]) if d_band else 0
        d_hi = self.d_(d_band[1]) if d_band else self._acap - 1
        a_lo, a_hi = (a_band if a_band else (0, self._acap - 1))
        # clamp to the composite key's stride so a-ranges never bleed into
        # the next diagonal's key space
        a_lo = max(int(a_lo), 0)
        a_hi = min(int(a_hi), self._acap - 1)
        if a_hi < a_lo:
            return 0
        # per-diagonal counts via composite-key searchsorted, vectorized
        ds = np.arange(d_lo, d_hi + 1, dtype=np.int64)
        lo = np.searchsorted(self._comp, ds * self._acap + a_lo, "left")
        hi = np.searchsorted(self._comp, ds * self._acap + a_hi, "right")
        return int((hi - lo).sum())

    def _select(self, d_band, a_band):
        lo, hi = self._range(d_band)
        d_arr = self._d_[lo:hi]
        a_arr = self._a[lo:hi]
        if a_band is not None:
            m = (a_arr >= a_band[0]) & (a_arr <= a_band[1])
            d_arr, a_arr = d_arr[m], a_arr[m]
        return d_arr, a_arr


class SeedIndexMultiple:
    """Seeds shared by N >= 2 sequences (k-mers present in every one).

    A seed is an N-tuple of positions, one per sequence, where the same
    k-mer occurs: for every k-mer present in all N sequences, the cross
    product of its first ``max_hits_per_kmer`` positions in each, with
    the per-sequence cap lowered for a k-mer whose product would exceed
    ``max_tuples_per_kmer`` (:func:`_fit_tuple_budget`).  The k-mer table
    is sorted on ``device`` (``"cuda"`` by default; it raises where no
    card is present); the expansion runs on the host.  Seeds are sorted
    tuples, equal to both tiers of the JAX package.

    Words too wide for ``ops.tables``' int32 keys (|Σ|^wordlen >= 2^31)
    are answered for inputs of at most :attr:`WIDE_MAX_LETTERS` letters
    in all, as in the JAX package, whose host tier serves them: the
    table is keyed by :func:`.kmers.as_kmer_keys_np`'s int64 keys (past
    2^63, the exact keys' ranks) and sorted on ``device`` the same way.
    A larger input at such a word raises ``ops.tables``' ``ValueError``,
    as the JAX package's device tier does.
    """

    WIDE_MAX_LETTERS = 200_000

    def __init__(self, *seqs: Sequence, wordlen: int = 8,
                 max_hits_per_kmer: int = 8, device="cuda",
                 max_tuples_per_kmer: int = 4096):
        assert len(seqs) >= 2
        self.device = resolve_device(device)
        self.seqs = seqs
        self.wordlen = int(wordlen)
        self.alphabet = seqs[0].alphabet
        h = int(max_hits_per_kmer)
        if h < 1:
            raise ValueError("max_hits_per_kmer must be >= 1, got %d" % h)
        # the per-sequence cap alone is exponential in N: one
        # low-complexity k-mer with >= h occurrences in each of N = 10
        # sequences would expand to h^N tuples
        self._max_tuples = max(int(max_tuples_per_kmer), 1)
        self._build(h)

    def _table(self):
        """The (key, seq, pos)-sorted k-mer table of every sequence, real
        windows only, as int64 keys and int32 sequence ids and positions
        (numpy)."""
        A = len(self.alphabet)
        if (A ** self.wordlen >= 2 ** 31 and sum(map(len, self.seqs))
                <= self.WIDE_MAX_LETTERS):
            if A ** self.wordlen < 2 ** 63:
                keys = [as_kmer_keys_np(s.to_array(np.int64), self.wordlen, A)
                        for s in self.seqs]
            else:
                keys = [np.array(as_kmer_seq(s, self.wordlen), dtype=object)
                        for s in self.seqs]
            return kmer_table_np(keys, self.device)
        codes, lengths = pack_sequences(list(self.seqs))
        kk, ss, pp = (x.cpu().numpy() for x in tables.nway_shared_seeds(
            codes, lengths, self.wordlen, A, device=self.device))
        valid = kk != tables.KEY_SENTINEL
        return kk[valid].astype(np.int64), ss[valid], pp[valid]

    def _build(self, h: int):
        kk, ss, pp = self._table()
        N = len(self.seqs)
        self._seeds = []
        if kk.size == 0:
            return
        # cap every (key, seq) subgroup at its first h rows (the table is
        # (key, seq, pos)-sorted, so subgroup order is position order)
        idx = np.arange(kk.shape[0])
        sub = np.empty(kk.shape, bool)
        sub[0] = True
        sub[1:] = (kk[1:] != kk[:-1]) | (ss[1:] != ss[:-1])
        first = np.maximum.accumulate(np.where(sub, idx, 0))
        keep = (idx - first) < h
        kk, ss, pp, sub = kk[keep], ss[keep], pp[keep], sub[keep]
        # key runs; a key whose run holds N subgroups touches every
        # sequence (seq ids ascend within a key, so subgroup s of a
        # qualifying key belongs to sequence s)
        ks = np.empty(kk.shape, bool)
        ks[0] = True
        ks[1:] = kk[1:] != kk[:-1]
        key_id = np.cumsum(ks) - 1
        n_keys = int(key_id[-1]) + 1
        nsub = np.bincount(key_id[sub], minlength=n_keys)
        qual = np.flatnonzero(nsub == N)
        if qual.size == 0:
            return
        qmap = np.full(n_keys, -1, np.int64)
        qmap[qual] = np.arange(qual.size)
        g_row = qmap[key_id]
        rows = g_row >= 0
        idx2 = np.arange(kk.shape[0])
        rank2 = idx2 - np.maximum.accumulate(np.where(sub, idx2, 0))
        g_row, s_row, p_row, r_row = (
            g_row[rows], ss[rows], pp[rows], rank2[rows])
        G = qual.size
        # per-(key, seq) capped hit counts and a [G, N, h] position table
        c = np.bincount(g_row * N + s_row, minlength=G * N).reshape(G, N)
        post = np.zeros((G, N, h), np.int64)
        post[g_row, s_row, r_row] = p_row
        c = _fit_tuple_budget(c, h, self._max_tuples)
        # cross-product expansion, the last sequence varying fastest:
        # stride[:, s] = product of the counts of sequences after s
        rc = np.cumprod(c[:, ::-1], axis=1)[:, ::-1]
        stride = np.concatenate([rc[:, 1:], np.ones((G, 1), np.int64)],
                                axis=1)
        totals = rc[:, 0]
        offsets = np.cumsum(totals)
        starts = offsets - totals
        m = np.arange(int(offsets[-1]))
        gq = np.searchsorted(offsets, m, side="right")
        t = m - starts[gq]
        cols = np.empty((m.shape[0], N), np.int64)
        for s in range(N):
            cols[:, s] = post[gq, s, (t // stride[gq, s]) % c[gq, s]]
        order = np.lexsort(tuple(cols[:, s] for s in reversed(range(N))))
        self._seeds = [tuple(int(x) for x in r) for r in cols[order]]

    def __len__(self):
        return len(self._seeds)

    def seeds(self):
        return list(self._seeds)

    def seed_count(self):
        return len(self._seeds)


def kmer_table_np(keys, device):
    """The k-mer table of sequences whose window keys are ``keys`` (one
    array a sequence, -1 for a window that holds no word), sorted by
    (key, seq, pos) on ``device``: int64 keys and int32 sequence ids and
    positions, numpy, real windows only.  Keys past int64 (object arrays
    of Python ints) are replaced by their ranks, equal where the keys
    are."""
    ss = np.repeat(np.arange(len(keys), dtype=np.int32),
                   [k.shape[0] for k in keys])
    pp = np.concatenate([np.arange(k.shape[0], dtype=np.int32)
                         for k in keys])
    kk = np.concatenate(keys)
    if kk.dtype == object:
        kk = np.unique(kk, return_inverse=True)[1].astype(np.int64)
    real = kk >= 0
    kk, ss, pp = kk[real], ss[real], pp[real]
    # (seq, pos) is the flat order, so a stable sort by key gives the
    # (key, seq, pos) order
    kk, order = torch.sort(torch.from_numpy(kk).to(device), stable=True)
    order = order.cpu().numpy()
    return kk.cpu().numpy(), ss[order], pp[order]


def _fit_tuple_budget(c, h: int, max_tuples: int):
    """Lower per-sequence hit caps until each k-mer's cross-product size
    fits the budget.

    ``c``: [G, N] int64 per-(k-mer, sequence) capped hit counts
    (``c <= h``).  Returns adjusted counts: for every row whose product
    exceeds ``max_tuples``, counts are re-capped at the largest
    ``h' < h`` that fits (down to 1: a product of 1**N always fits).
    """
    c = np.asarray(c, np.int64).copy()
    # float64 products: int64 overflows at large N (8^22 > 2^63)
    prod = c.astype(np.float64).prod(axis=1)
    for hp in range(h - 1, 0, -1):
        over = prod > max_tuples
        if not over.any():
            break
        c[over] = np.minimum(c[over], hp)
        prod[over] = c[over].astype(np.float64).prod(axis=1)
    return c
