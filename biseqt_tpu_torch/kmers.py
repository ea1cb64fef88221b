"""K-mer packing and indexing: sorted tables on the device replace SQLite.

The port of :mod:`biseqt_tpu.kmers` (the reference's ``biseqt/kmers.py —
kmer_as_int, as_kmer_seq, KmerIndex, KmerCache``).  The reference's
inverted index (a SQLite table ``kmers_{wordlen}(kmer, seq, pos)`` and
its B-tree) is one sorted triple of int32 tensors on ``device``
(:func:`.ops.tables.build_kmer_table`, ``"cuda"`` by default); point
lookups are binary searches over host copies, and persistence is the
JAX package's ``.npz`` snapshot: either package loads the other's.
"""

from __future__ import annotations

import os
from typing import Iterable, List

import numpy as np
import torch

from .ops import tables
from .ops.banded_dp import resolve_device
from .sequence import Alphabet, Sequence, pack_sequences
from .stochastics import binomial_to_normal, normal_neg_log_pvalue

__all__ = ["kmer_as_int", "as_kmer_seq", "as_kmer_keys_np", "KmerIndex",
           "KmerCache"]


def kmer_as_int(contents, alphabet: Alphabet) -> int:
    """Pack one k-mer (iterable of letter codes) into an integer:
    base-|Σ| positional encoding, most significant first."""
    k = 0
    n = len(alphabet)
    for c in contents:
        assert 0 <= c < n
        k = k * n + int(c)
    return k


def as_kmer_seq(seq: Sequence, wordlen: int) -> List[int]:
    """All overlapping k-mers of ``seq`` as packed integers (host tier).

    Vectorized on :func:`as_kmer_keys_np`; keys too wide for int64
    (|Σ|**wordlen >= 2**63, e.g. DNA wordlen >= 32) take the exact
    Python-int rolling loop.
    """
    n = len(seq.alphabet)
    if n ** wordlen < 2 ** 63:
        # Sequence codes are validated non-negative, so no -1 windows
        return as_kmer_keys_np(seq.to_array(), wordlen, n).tolist()
    out = []
    val = 0
    mod = n ** wordlen
    for i, c in enumerate(seq.contents):
        val = (val * n + c) % mod
        if i >= wordlen - 1:
            out.append(val)
    return out


def as_kmer_keys_np(codes: np.ndarray, wordlen: int,
                    alphabet_len: int) -> np.ndarray:
    """Vectorized host-tier k-mer packing over a code array.

    Same values as :func:`as_kmer_seq` / ``ops.tables.kmer_keys``
    (base-|Σ|, most significant first), in ``wordlen`` numpy passes.
    Windows containing a negative code (ambiguity or PAD) come back as
    -1.  Returns int64 of length ``len(codes) - wordlen + 1`` (empty if
    the sequence is shorter than ``wordlen``).  Codes of any integer or
    float dtype are accepted.
    """
    codes = np.asarray(codes)
    if codes.dtype.kind != "i":
        # float and object codes, and unsigned ones: the in-place +=
        # below adds into int64 keys, which numpy refuses for uint64
        codes = codes.astype(np.int64)
    m = codes.shape[0] - int(wordlen) + 1
    if m <= 0:
        return np.empty(0, np.int64)
    key = np.zeros(m, np.int64)
    has_neg = codes.size and int(codes.min()) < 0
    if not has_neg:
        # hot path (validated Sequence codes are never negative): two
        # in-place passes per position
        for t in range(int(wordlen)):
            key *= alphabet_len
            key += codes[t:t + m]
        return key
    bad = np.zeros(m, bool)
    for t in range(int(wordlen)):
        cc = codes[t:t + m]
        key *= alphabet_len
        key += np.maximum(cc, 0)
        bad |= cc < 0
    key[bad] = -1
    return key


class KmerIndex:
    """An inverted k-mer index over a collection of sequences.

    Holds the ``(kmer, seq, pos)`` table, sorted lexicographically, as
    int32 tensors on ``device`` (``"cuda"`` by default; it raises where
    no card is present).  ``path`` (optional) names an ``.npz`` snapshot
    (``.npz`` is appended to a name without it): an existing snapshot is
    loaded instead of rebuilt, and every build or mask rewrites it.
    """

    def __init__(self, wordlen: int, alphabet: Alphabet, path: str = None,
                 device="cuda"):
        if len(alphabet) ** wordlen >= 2 ** 31:
            raise ValueError("alphabet**wordlen must fit int32; got %d^%d"
                             % (len(alphabet), wordlen))
        self.device = resolve_device(device)
        self.wordlen = int(wordlen)
        self.alphabet = alphabet
        if path and not path.endswith(".npz"):
            path = path + ".npz"
        self.path = path
        self._ids: List[str] = []       # content ids of indexed sequences
        self._lens: List[int] = []
        self._keys = None               # sorted int32 [N]
        self._seqs = None
        self._poss = None
        self._n = 0
        self._keys_np = None            # host copies for hits()
        self._pending = []              # sequences collected by attach_to
        if path and os.path.exists(path):
            self.load(path)

    # -- building -------------------------------------------------------------
    def index_kmers(self, seqs: Iterable[Sequence], append: bool = False):
        """(Re)build the table over ``seqs``: one pack, one sort on the
        device.  With ``append=True`` the batch is merged into the
        existing table by one stable sort of the concatenation (the
        incremental path of :meth:`refresh`), sequence ids continuing
        after the already-indexed ones."""
        seqs = list(seqs)
        if not seqs:
            raise ValueError("no sequences to index")
        if not append:
            self._ids, self._lens = [], []
            self._keys = self._seqs = self._poss = None
            self._n = 0
        base = len(self._lens)
        self._ids += [getattr(s, "content_id", None) for s in seqs]
        self._lens += [len(s) for s in seqs]
        codes, lengths = pack_sequences(seqs)
        keys, sids, poss, n_valid = tables.build_kmer_table(
            codes, lengths, self.wordlen, len(self.alphabet),
            device=self.device)
        n = int(n_valid)
        keys, sids, poss = keys[:n], sids[:n] + base, poss[:n]
        if self._n:
            keys = torch.cat([self._keys, keys])
            sids = torch.cat([self._seqs, sids])
            poss = torch.cat([self._poss, poss])
            keys, order = torch.sort(keys, stable=True)
            sids, poss = sids[order], poss[order]
        self._keys, self._seqs, self._poss = keys, sids, poss
        self._n = int(keys.shape[0])
        self._keys_np = None
        if self.path:
            self.save(self.path)
        return self

    @property
    def num_kmers(self) -> int:
        """Total number of indexed k-mer occurrences."""
        return self._n

    @property
    def num_seqs(self) -> int:
        return len(self._lens)

    # -- queries --------------------------------------------------------------
    def hits(self, kmer: int):
        """All (seq_id, pos) occurrences of a packed k-mer: a binary
        search over host copies of the columns (copied on first use), the
        reference's point query."""
        if self._n == 0:
            return []
        if self._keys_np is None or len(self._keys_np) != self._n:
            self._keys_np, self._seqs_np, self._poss_np = (
                x.cpu().numpy() for x in self.table())
        lo = int(np.searchsorted(self._keys_np, np.int32(kmer), "left"))
        hi = int(np.searchsorted(self._keys_np, np.int32(kmer), "right"))
        return list(zip(self._seqs_np[lo:hi].tolist(),
                        self._poss_np[lo:hi].tolist()))

    def kmers(self):
        """Distinct k-mers present in the index (host list of ints)."""
        if self._n == 0:
            return []
        is_start, _ = tables.run_boundaries(self._keys, device=self.device)
        return self._keys[is_start].cpu().tolist()

    def counts(self):
        """(distinct_kmers, occurrence_counts) as host int32 arrays."""
        if self._n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        uniq, cnt = torch.unique_consecutive(self._keys, return_counts=True)
        return (uniq.cpu().numpy().astype(np.int32),
                cnt.cpu().numpy().astype(np.int32))

    def score_kmers(self):
        """−log p-value of each distinct k-mer's count under a uniform
        null (the normal approximation to its binomial count), computed on
        ``device``: large values flag repetitive k-mers to mask before
        seeding.  Returns host ``(kmers int32, scores float32)``."""
        uniq, cnt = self.counts()
        total = int(sum(self._lens)) - len(self._lens) * (self.wordlen - 1)
        p_null = 1.0 / (len(self.alphabet) ** self.wordlen)
        mu, sd = binomial_to_normal(total, p_null, device=self.device)
        scores = normal_neg_log_pvalue(mu, sd, cnt.astype(np.float32),
                                       device=self.device)
        return uniq, scores.cpu().numpy()

    def mask_repetitive(self, max_score: float = 10.0):
        """Drop the occurrences of k-mers whose score exceeds
        ``max_score``; returns how many were removed.  The snapshot is
        rewritten, so a later load does not bring them back."""
        uniq, scores = self.score_kmers()
        bad = uniq[scores > max_score]
        if bad.size == 0:
            return 0
        keep = ~torch.isin(self._keys,
                           torch.as_tensor(bad, device=self.device))
        self._keys, self._seqs, self._poss = (
            x[keep] for x in self.table())
        removed = self._n - int(self._keys.shape[0])
        self._n -= removed
        self._keys_np = None
        if self.path:
            self.save(self.path)
        return removed

    # -- database integration -------------------------------------------------
    def attach_to(self, db):
        """Subscribe to a :class:`..database.DB`'s ``sequence-inserted``
        event: inserted sequences are collected, and :meth:`refresh`
        indexes them in one batch."""

        def on_insert(db_, rec, seq):
            self._pending.append(seq)

        db.add_event_listener("sequence-inserted", on_insert)
        return self

    def refresh(self):
        """Index the sequences collected by :meth:`attach_to` since the
        last refresh, merged into the existing table (earlier batches
        are not indexed again, and sequences indexed directly by
        :meth:`index_kmers` stay)."""
        if self._pending:
            pending, self._pending = self._pending, []
            self.index_kmers(pending, append=self._n > 0)
        return self

    # -- table access for downstream ops --------------------------------------
    def table(self):
        """The sorted (keys, seqs, poss) int32 tensors on ``device``."""
        return self._keys, self._seqs, self._poss

    # -- persistence ----------------------------------------------------------
    def save(self, path: str):
        """Write the JAX package's snapshot format: the three columns,
        lengths, an object array of content ids, the word length and the
        ``\\x00``-joined letters."""
        keys, seqs, poss = (np.asarray(None) if x is None else x.cpu().numpy()
                            for x in self.table())
        np.savez_compressed(
            path, keys=keys, seqs=seqs, poss=poss,
            lens=np.asarray(self._lens, np.int64),
            ids=np.asarray(self._ids, dtype=object),
            wordlen=self.wordlen,
            letters="\x00".join(self.alphabet.letters),
        )

    def load(self, path: str):
        z = np.load(path, allow_pickle=True)
        if int(z["wordlen"]) != self.wordlen:
            raise ValueError("wordlen mismatch: snapshot %d vs index %d"
                             % (int(z["wordlen"]), self.wordlen))
        saved_letters = str(z["letters"])
        if saved_letters != "\x00".join(self.alphabet.letters):
            raise ValueError(
                "alphabet mismatch: snapshot %r vs index %r"
                % (saved_letters.split("\x00"), list(self.alphabet.letters)))
        self._keys, self._seqs, self._poss = (
            torch.as_tensor(z[k], device=self.device)
            for k in ("keys", "seqs", "poss"))
        self._lens = z["lens"].tolist()
        self._ids = z["ids"].tolist()
        self._n = int(z["keys"].shape[0])
        self._keys_np = None
        return self


class KmerCache:
    """Cache of packed k-mer arrays keyed by sequence content id: a
    directory of ``.npy`` files, the role of the reference's SQLite
    k-mer sequence cache (``biseqt/kmers.py — KmerCache``)."""

    def __init__(self, path: str, wordlen: int, alphabet: Alphabet):
        self.path = path
        self.wordlen = int(wordlen)
        self.alphabet = alphabet
        os.makedirs(path, exist_ok=True)

    def _file(self, seq: Sequence) -> str:
        return os.path.join(
            self.path, "%s.w%d.npy" % (seq.content_id, self.wordlen))

    def as_kmer_seq(self, seq: Sequence) -> np.ndarray:
        f = self._file(seq)
        if os.path.exists(f):
            return np.load(f)
        if len(self.alphabet) ** self.wordlen < 2 ** 63:
            out = as_kmer_keys_np(
                seq.to_array(), self.wordlen, len(self.alphabet))
        else:
            out = np.asarray(as_kmer_seq(seq, self.wordlen), dtype=np.int64)
        np.save(f, out)
        return out
