"""Seed indexing: exact k-mer matches in diagonal/antidiagonal coordinates.

The port of :mod:`biseqt_tpu.seeds` (the reference's ``biseqt/seeds.py
— SeedIndex``).  Seeds are enumerated by a sorted-merge join on the
device (:func:`.ops.tables.seed_join_sorted`) and kept in band
coordinates

    d = i - j   (diagonal; stored shifted as d_ = d + |T| >= 0)
    a = i + j   (antidiagonal)

sorted by (d_, a).  One copy brings the sorted arrays to the host, where
band queries (``seeds(d_band=..., a_band=...)``, ``seed_count``) are
binary searches, the role the reference's SQL B-tree played.  A
snapshot (``path=``, a ``.npz`` of those arrays and the sequences'
content ids) is the JAX package's format: either package loads the
other's.

``SeedIndexMultiple`` (N-way seeds) is not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from .ops import tables
from .ops.banded_dp import resolve_device
from .profiling import Phase
from .sequence import Sequence

__all__ = ["Seed", "SeedIndex"]


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
        da = torch.stack([out["d_"], out["a"]]).to(torch.int64)
        self._d_, self._a = da.cpu().numpy()
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
