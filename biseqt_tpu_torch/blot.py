"""Word-Blot: statistical similar-segment discovery without full DP.

The port of :mod:`biseqt_tpu.blot` (the reference's ``biseqt/blot.py —
band_radius, band_radii, expected_overlap_len, WordBlot,
WordBlotOverlap, WordBlotOverlapRef, WordBlotLocalRef,
WordBlotMultiple``).

Seeds (exact k-mer matches) are viewed in (diagonal d = i - j,
antidiagonal a = i + j) coordinates.  A local alignment of length K with
gap probability g stays inside a diagonal band of radius ~ sqrt(g K), so
similar segments show up as seed-dense (d, a) rectangles.  Each
candidate's seed count is scored under two hypotheses (H0 unrelated,
background rate |Σ|^-w per cell; H1 related at match probability p,
rate ~ p^w per column) and the match probability is estimated as
p̂ = (n/K)^(1/w).

The seed join, the (d, a) histogram, its 3x3 neighbourhood sums and the
statistics run on ``device`` (:mod:`.seeds`, :mod:`.ops.blot_stats`;
``"cuda"`` by default, raising where no card is present); connected
components over the occupied cells (``scipy.ndimage``), the sparse
run merging and the band queries run on the host.

The fixed-reference modes (``WordBlotOverlapRef``, ``WordBlotLocalRef``)
sort the reference's k-mer table once on ``device`` and serve each
query's seeds on the host (packing, binary searches, a ragged
expansion); ``WordBlotMultiple`` clusters N-way seeds
(:class:`.seeds.SeedIndexMultiple`) on the host and scores every
candidate in one batched call on ``device``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List

import numpy as np
from scipy import ndimage
from scipy.special import erfcinv
import torch

from .kmers import as_kmer_keys_np
from .ops import blot_stats, tables
from .ops.banded_dp import resolve_device
from .profiling import Phase
from .seeds import SeedIndex, SeedIndexMultiple, kmer_table_np
from .sequence import Sequence

__all__ = [
    "P_MIN_EPS", "band_radius", "band_radii", "expected_overlap_len",
    "WordBlot", "WordBlotOverlap", "WordBlotOverlapRef", "WordBlotLocalRef",
    "WordBlotMultiple",
]


# ---------------------------------------------------------------------------
# band geometry math
# ---------------------------------------------------------------------------

# p-hat is float32 (counts stay far below the 2^24 float32 integer limit
# at any realistic component size); the p_min threshold is applied with
# this margin so a component whose true p-hat equals p_min cannot flip
# on float32 rounding
P_MIN_EPS = 1e-5


def _batched_stats(ns, areas, seglens, wordlen: int, alphabet_len: int,
                   device):
    """(p-hat, s0, s1) numpy arrays for per-candidate (n, area, seglen)
    columns, rounded to float32, in one pass on ``device``.  Shared by
    the pairwise (:func:`_score_components`) and N-way paths."""
    with Phase("blot.stats"):
        ns, areas, seglens = (np.float32(x) for x in (ns, areas, seglens))
        p = blot_stats.estimate_match_probability(ns, seglens, wordlen,
                                                  device=device)
        s0, s1 = blot_stats.h0_h1_scores(ns, areas, seglens, p, wordlen,
                                         alphabet_len, device=device)
        return tuple(torch.stack([p, s0, s1]).cpu().numpy())


def _score_components(cand, wordlen: int, alphabet_len: int, device):
    """(p-hat, s0, s1) numpy arrays for candidate boxes
    [(d_lo, d_hi, a_lo, a_hi, n, seglen)], in one pass on ``device``."""
    arr = np.asarray(cand, np.float64)
    return _batched_stats(arr[:, 4], (arr[:, 1] - arr[:, 0] + 1) * arr[:, 5],
                          arr[:, 5], wordlen, alphabet_len, device)


def band_radius(K, gap_prob, sensitivity=0.99):
    """Diagonal band radius containing a length-K alignment w.p.
    ``sensitivity``: after K columns the path's diagonal is a sum of
    ~ g*K centered ±1 indel steps, Normal with sd ~ sqrt(g*K), and the
    two-sided (1-ε) quantile gives r = erfcinv(ε) * sqrt(2 g K)."""
    eps = 1.0 - float(sensitivity)
    r = erfcinv(eps) * np.sqrt(2.0 * float(gap_prob) * np.asarray(K, float))
    return np.maximum(1, np.ceil(r)).astype(int)


def band_radii(Ks, gap_prob, sensitivity=0.99):
    """Vectorized :func:`band_radius` over segment lengths."""
    return band_radius(np.asarray(list(Ks)), gap_prob, sensitivity)


def expected_overlap_len(len0, len1, diag, gap_prob):
    """Expected alignment-column length of an overlap along a diagonal:
    along diagonal d the gap-free overlap spans ``L(d) = min(len0 - d,
    len1 + d, len0, len1)`` residues, and indels (prob g per column)
    stretch columns by ~ 1/(1 - g/2)."""
    d = np.asarray(diag)
    L = np.minimum(
        np.minimum(len0 - d, len1 + d), np.minimum(len0, len1)
    )
    L = np.maximum(L, 0)
    return np.ceil(L / (1.0 - float(gap_prob) / 2.0)).astype(int)


# ---------------------------------------------------------------------------
# WordBlot
# ---------------------------------------------------------------------------

class WordBlot:
    """Pairwise similar-segment discovery over a :class:`SeedIndex`.

    Args:
        S, T: the two sequences.
        wordlen: k-mer length w.
        g_max: maximum gap probability the band model should tolerate.
        sensitivity: band-radius sensitivity (1 - ε).
        path: the seed index's snapshot (see :class:`SeedIndex`).
        device: where the seed join and the statistics run (``"cuda"``
            by default).
    """

    def __init__(self, S: Sequence, T: Sequence, wordlen: int = 8,
                 g_max: float = 0.3, sensitivity: float = 0.99,
                 path: str = None, device="cuda"):
        self.device = resolve_device(device)
        self.S, self.T = S, T
        self.wordlen = int(wordlen)
        self.g_max = float(g_max)
        self.sensitivity = float(sensitivity)
        self.seed_index = SeedIndex(S, T, wordlen, path=path,
                                    device=self.device)

    # -- thin re-exports ------------------------------------------------------
    def band_radius(self, K) -> int:
        return int(band_radius(K, self.g_max, self.sensitivity))

    def seed_count(self, d_band=None, a_band=None) -> int:
        return self.seed_index.seed_count(d_band=d_band, a_band=a_band)

    def score_num_seeds(self, num_seeds, area, seglen, p_match):
        """(S0, S1) neg-log p-values of a band's seed count; see
        :func:`ops.blot_stats.h0_h1_scores`."""
        s0, s1 = blot_stats.h0_h1_scores(
            num_seeds, area, seglen, p_match, self.wordlen,
            len(self.S.alphabet), device=self.device)
        return float(s0), float(s1)

    def estimate_match_probability(self, num_seeds, seglen) -> float:
        return float(blot_stats.estimate_match_probability(
            num_seeds, seglen, self.wordlen, device=self.device))

    # -- core machinery -------------------------------------------------------
    def _grids(self, K: int):
        """The (d-cell, a-cell) histogram and its 3x3 sums, memoized per K
        (the seed set is immutable; similar_segments and _best_fallback
        both need the grid)."""
        cached = getattr(self, "_grids_cache", None)
        if cached is not None and cached[0] == K:
            return cached[1]
        out = self._grids_impl(K)
        self._grids_cache = (K, out)
        return out

    def _grids_impl(self, K: int):
        r = self.band_radius(K)
        d_, a = self.seed_index.seed_arrays()
        acell = max(2 * K, 2)
        dcell = max(r, 1)
        # every seed's cell and its 3x3 neighbours lie inside this grid
        n_d = (len(self.S) + len(self.T)) // dcell + 2
        n_a = (len(self.S) + len(self.T)) // acell + 2
        grid = blot_stats.grid_counts(d_ // dcell, a // acell, n_d, n_a,
                                      device=self.device)
        neigh = blot_stats.box_sum3(grid, device=self.device)
        return (grid.cpu().numpy(), neigh.cpu().numpy(), dcell, acell, r)

    def score_seeds(self, K: int) -> List[Dict]:
        """Per-seed local match-probability estimates: each seed's
        neighbours within its band neighbourhood (±band_radius in d, ±K
        in a, up to bucket quantization), converted to p̂."""
        grid, neigh, dcell, acell, r = self._grids(K)
        d_, a = self.seed_index.seed_arrays()
        lt = len(self.T)
        # the 3x3 neighbourhood spans ~3 a-cells = 6K antidiagonals = ~3K
        # alignment columns, similar_segments' calibration
        seg_cols = min(3 * acell / 2.0, float(min(len(self.S), len(self.T))))
        ns = neigh[d_ // dcell, a // acell]
        ps = blot_stats.estimate_match_probability(
            ns.astype(np.float32), seg_cols, self.wordlen,
            device=self.device).cpu().numpy()
        ii = (a + d_ - lt) // 2
        jj = (a - (d_ - lt)) // 2
        return [
            {"seed": (int(i), int(j)), "neighs": int(n), "p": float(p)}
            for i, j, n, p in zip(ii, jj, ns, ps)
        ]

    # dense (d, a) grids beyond this many cells switch to the sparse
    # run-merging assembler
    MAX_GRID_CELLS = 1 << 22

    def similar_segments(self, K_min: int, p_min: float,
                         at_least_one: bool = False) -> Iterable[Dict]:
        """Discover maximal similar segments.

        Yields dicts ``{'segment': ((d_min, d_max), (a_min, a_max)),
        'p': p̂, 'score': (S0, S1), 'num_seeds': n}``, ``d`` in true
        (unshifted) diagonal coordinates.  With ``at_least_one`` a pair
        with no segment yields its densest band.

        Two assemblers, one contract: a dense bucket grid with connected
        components, and, where the grid would pass ``MAX_GRID_CELLS``, a
        sparse merge of sorted runs (O(#seeds log)).
        """
        with Phase("blot.discover"):
            segs = list(self._similar_segments_inner(K_min, p_min,
                                                     at_least_one))
        yield from segs

    def _candidates(self, K_min, p_min):
        """Candidate boxes [(d_lo, d_hi, a_lo, a_hi, n, seglen)] of the
        assembler the grid's size picks."""
        r = self.band_radius(K_min)
        acell = max(2 * K_min, 2)
        dcell = max(r, 1)
        n_d = (len(self.S) + len(self.T)) // dcell + 2
        n_a = (len(self.S) + len(self.T)) // acell + 2
        if n_d * n_a > self.MAX_GRID_CELLS:
            return self._collect_sparse(K_min, dcell, acell)
        return self._collect_components(K_min, p_min)

    def _similar_segments_inner(self, K_min, p_min, at_least_one):
        cand = self._candidates(K_min, p_min)
        found = 0
        for seg in self._emit_components(cand, p_min):
            found += 1
            yield seg
        if found == 0 and at_least_one:
            yield self._best_fallback(K_min, p_min)

    def _collect_components(self, K_min, p_min):
        """Candidate boxes [(d_lo, d_hi, a_lo, a_hi, n, seglen)] of the
        dense assembler: connected components of hot grid cells."""
        grid, neigh, dcell, acell, r = self._grids(K_min)
        lt = len(self.T)
        # a cell is "hot" if its 3x3 neighbourhood (≈ a (3r, 6K) window,
        # ~3K alignment columns per band) has enough seeds to suggest
        # match probability >= p_min over K_min columns
        win_cols = 3 * acell / 2.0
        thresh = max(1.0, win_cols * (p_min ** self.wordlen) * 0.5)
        hot = neigh >= thresh
        if not hot.any():
            return []
        labels, n_comp = ndimage.label(hot, structure=np.ones((3, 3)))
        # bounding boxes in one pass (linear in the grid)
        boxes = ndimage.find_objects(labels)
        cand = []
        for sl_d, sl_a in boxes:
            d_lo = int(sl_d.start) * dcell
            d_hi = int(sl_d.stop) * dcell - 1
            a_lo = int(sl_a.start) * acell
            a_hi = int(sl_a.stop) * acell - 1
            n = self.seed_index.seed_count(
                d_band=(d_lo - lt, d_hi - lt), a_band=(a_lo, a_hi))
            # clamp to the real maximum alignment length: the quantized
            # a-range can exceed min(|S|, |T|)
            seglen = min((a_hi - a_lo + 1) / 2.0,
                         float(min(len(self.S), len(self.T))))
            if seglen < K_min:
                continue
            cand.append((d_lo, d_hi, a_lo, a_hi, n, seglen))
        return cand

    def _emit_components(self, cand, p_min):
        """Score candidate boxes in one pass and yield the surviving
        segment dicts."""
        if not cand:
            return
        lt = len(self.T)
        p_hats, s0s, s1s = _score_components(
            cand, self.wordlen, len(self.S.alphabet), self.device)
        for k, (d_lo, d_hi, a_lo, a_hi, n, seglen) in enumerate(cand):
            # the epsilon keeps components exactly at p_min from flipping
            # on float32 rounding
            if p_hats[k] < p_min - P_MIN_EPS:
                continue
            yield {
                "segment": ((int(d_lo) - lt, int(d_hi) - lt),
                            (int(a_lo), int(a_hi))),
                "p": float(p_hats[k]),
                "score": (float(s0s[k]), float(s1s[k])),
                "num_seeds": int(n),
            }

    def _collect_sparse(self, K_min, dcell, acell):
        """Candidate boxes of the sparse assembler: antidiagonal runs per
        diagonal cell, merged across adjacent cells; O(#seeds log
        #seeds), host work only.

        A run boundary is "d-cell changed or a-gap > 2 cells", so one
        pass over the (cell, a)-sorted seeds labels every run.
        """
        d_, a = self.seed_index.seed_arrays()
        lt = len(self.T)
        if len(d_) == 0:
            return []
        dc = d_ // dcell
        # order by (cell, a): run detection needs each cell's seeds in
        # antidiagonal order whichever exact diagonal they are on
        order0 = np.lexsort((a, dc))
        dc, a_o = dc[order0], a[order0]
        new_run = np.empty(len(d_), bool)
        new_run[0] = True
        new_run[1:] = (dc[1:] != dc[:-1]) | (np.diff(a_o) > 2 * acell)
        starts = np.flatnonzero(new_run)
        ends = np.append(starts[1:], len(d_))
        run_d = dc[starts]
        run_alo = a_o[starts]
        run_ahi = a_o[ends - 1]
        run_n = ends - starts
        # drop background singleton runs before merging
        keep = run_n >= 3
        if not keep.any():
            return []
        run_d, run_alo, run_ahi = run_d[keep], run_alo[keep], run_ahi[keep]
        # union adjacent-diagonal runs with overlapping (padded) a-ranges
        order = np.argsort(run_alo, kind="stable")
        parent = np.arange(len(run_d))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        last_in_cell: Dict[int, int] = {}
        for idx in order:
            c = int(run_d[idx])
            for cc in (c - 1, c, c + 1):
                other = last_in_cell.get(cc)
                if other is not None and (
                        run_ahi[other] + acell >= run_alo[idx] - acell):
                    ra, rb = find(idx), find(other)
                    if ra != rb:
                        parent[rb] = ra
            last_in_cell[c] = idx
        comps: Dict[int, list] = {}
        for idx in range(len(run_d)):
            comps.setdefault(find(idx), []).append(idx)

        cand = []
        for members in comps.values():
            ms = np.asarray(members)
            d_lo = int(run_d[ms].min()) * dcell
            d_hi = (int(run_d[ms].max()) + 1) * dcell - 1
            a_lo = int(run_alo[ms].min())
            a_hi = int(run_ahi[ms].max())
            # exact rectangle count (the dense path's statistics)
            n = self.seed_index.seed_count(
                d_band=(d_lo - lt, d_hi - lt), a_band=(a_lo, a_hi))
            seglen = max(min((a_hi - a_lo + 1) / 2.0,
                             float(min(len(self.S), len(self.T)))), 1.0)
            if seglen < K_min:
                continue
            cand.append((d_lo, d_hi, a_lo, a_hi, n, seglen))
        return cand

    def _best_fallback(self, K_min, p_min) -> Dict:
        """One segment around the densest band, for a caller who wants a
        ranking when thresholding yields nothing."""
        grid, neigh, dcell, acell, r = self._grids(K_min)
        lt = len(self.T)
        u, v = np.unravel_index(np.argmax(neigh), neigh.shape)
        d_lo, d_hi = (u - 1) * dcell, (u + 2) * dcell - 1
        a_lo, a_hi = (v - 1) * acell, (v + 2) * acell - 1
        n = self.seed_index.seed_count(
            d_band=(d_lo - lt, d_hi - lt), a_band=(a_lo, a_hi))
        seglen = max(min((a_hi - a_lo + 1) / 2.0,
                         float(min(len(self.S), len(self.T)))), 1.0)
        p_hat = self.estimate_match_probability(n, seglen)
        s0, s1 = self.score_num_seeds(
            n, (d_hi - d_lo + 1) * seglen, seglen, max(p_hat, 1e-3))
        return {
            "segment": ((d_lo - lt, d_hi - lt), (a_lo, a_hi)),
            "p": p_hat, "score": (s0, s1), "num_seeds": n,
        }


# ---------------------------------------------------------------------------
# Overlap mode
# ---------------------------------------------------------------------------

class WordBlotOverlap(WordBlot):
    """Read-overlap discovery: only bands crossing sequence ends matter.

    Instead of free (d, a) rectangles, candidates are full diagonal bands
    [d-r, d+r] scored over their whole antidiagonal extent: a suffix of
    one read aligning a prefix of the other.
    """

    def highest_scoring_overlap_band(self, p_min: float = 0.5,
                                     min_score: float = 25.0) -> Dict:
        """Score every diagonal band, return the best overlap candidate.

        A candidate must reject H0 with S0 >= ``min_score`` neg-log-p (p̂
        alone cannot discriminate: the 1/w-th root compresses background
        counts toward ~0.5; the default includes a multiple-testing
        allowance for the |S|+|T| bands scanned).  Among significant
        bands the one with the most estimated matched columns (p̂ · K_d)
        wins.

        Returns ``{'d_band': (d_lo, d_hi), 'p': p̂, 'score': (S0, S1),
        'expected_len': K_d}`` or None if no significant overlap exists.
        """
        prof = self._band_profile()
        if prof is None:
            return None
        diags, K_d, r_d, r_max, sums, p_hat = prof
        seglen = np.maximum(K_d, 1).astype(float)
        area = (2.0 * r_max + 1) * seglen
        s0, s1 = blot_stats.h0_h1_scores(
            sums, area, seglen, np.maximum(p_hat, 1e-3), self.wordlen,
            len(self.S.alphabet), device=self.device)
        s0, s1 = s0.cpu().numpy(), s1.cpu().numpy()
        ok = (K_d >= 2 * self.wordlen) & (s0 >= min_score)
        if not ok.any():
            return None
        rank = np.where(ok, p_hat * seglen, -1.0)
        best = int(np.argmax(rank))
        return {
            "d_band": (int(diags[best] - r_d[best]),
                       int(diags[best] + r_d[best])),
            "p": float(p_hat[best]),
            "score": (float(s0[best]), float(s1[best])),
            "expected_len": int(K_d[best]),
        }

    def _band_profile(self):
        """Per-diagonal band statistics (diags, K_d, r_d, r_max, sums,
        p̂), or None for a seedless pair."""
        ls, lt = len(self.S), len(self.T)
        counts = self.seed_index.seed_count_by_d_()
        if counts.sum() == 0:
            return None
        diags = np.arange(counts.shape[0]) - lt  # true d per bin
        K_d = expected_overlap_len(ls, lt, diags, self.g_max)
        r_d = band_radius(np.maximum(K_d, 2), self.g_max, self.sensitivity)
        # sliding band sums with the max radius window; each band is then
        # scored with that window's own area
        r_max = int(r_d.max())
        sums = blot_stats.sliding_band_sums(
            counts, r_max, device=self.device).cpu().numpy().astype(float)
        p_hat = blot_stats.estimate_match_probability(
            sums, np.maximum(K_d, 1).astype(float), self.wordlen,
            device=self.device).cpu().numpy()
        return diags, K_d, r_d, r_max, sums, p_hat

    def overlap_profile(self):
        """(diags, p̂ per diagonal band) for inspection and benchmarks."""
        prof = self._band_profile()
        if prof is None:
            counts = self.seed_index.seed_count_by_d_()
            return (np.arange(counts.shape[0]) - len(self.T),
                    np.zeros(counts.shape[0]))
        diags, _, _, _, _, p_hat = prof
        return diags, p_hat


# ---------------------------------------------------------------------------
# Fixed-reference modes
# ---------------------------------------------------------------------------

class _FixedRefBase:
    """Shared machinery of the fixed-reference modes: the reference's
    k-mer positions as one sorted table (keys ascending, positions
    ascending within a key), sorted once on ``device`` (``"cuda"`` by
    default) and copied to the host, and an adapter that dresses a
    query's seeds up as a :class:`WordBlot`-family object.  A query's
    seeds are served on the host (packing, binary searches and a ragged
    expansion, O(|query| + hits)); only its candidates' statistics run
    on ``device``.

    Words too wide for ``ops.tables``' int32 keys (|Σ|^wordlen >= 2^31)
    are answered for references shorter than :attr:`WIDE_MAX_REF`
    letters, as in the JAX package, whose host tier serves them: the
    table is keyed by :func:`.kmers.as_kmer_keys_np`'s int64 keys and
    sorted on ``device`` the same way.  A longer reference at such a word
    raises ``ops.tables``' ``ValueError``, as the JAX package's device
    tier does."""

    WIDE_MAX_REF = 1 << 16

    def __init__(self, ref: Sequence, wordlen: int = 8, g_max: float = 0.3,
                 sensitivity: float = 0.99, device="cuda"):
        self.device = resolve_device(device)
        self.ref = ref
        self.wordlen = int(wordlen)
        self.g_max = float(g_max)
        self.sensitivity = float(sensitivity)
        A = len(ref.alphabet)
        with Phase("blot.ref_index"):
            if A ** self.wordlen >= 2 ** 31 and len(ref) < self.WIDE_MAX_REF:
                self._ref_keys, _, pos = kmer_table_np(
                    [as_kmer_keys_np(ref.to_array(np.int64), self.wordlen,
                                     A)], self.device)
                self._ref_pos = pos.astype(np.int64)
            else:
                keys, _, poss, n_valid = tables.build_kmer_table(
                    ref.to_array()[None, :], [len(ref)], self.wordlen, A,
                    device=self.device)
                n = int(n_valid)
                # one copy of the (key, pos) columns to the host
                kp = torch.stack([keys[:n], poss[:n]]).to(torch.int64)
                self._ref_keys, self._ref_pos = kp.cpu().numpy()

    def _as_wordblot(self, cls, query: Sequence):
        wb = cls.__new__(cls)
        wb.device = self.device
        wb.S, wb.T = query, self.ref
        wb.wordlen = self.wordlen
        wb.g_max, wb.sensitivity = self.g_max, self.sensitivity
        wb.seed_index = _SeedsFromRefIndex(
            query, self.ref, self.wordlen, self._ref_keys, self._ref_pos)
        return wb


class WordBlotOverlapRef(_FixedRefBase):
    """Overlap detection of many queries against one fixed read: the
    read's k-mer table is built once, and each query's overlap band
    statistics stream through in O(|query| + hits)."""

    def highest_scoring_overlap_band(self, query: Sequence, **kw):
        return self._as_wordblot(
            WordBlotOverlap, query).highest_scoring_overlap_band(**kw)


class WordBlotLocalRef(_FixedRefBase):
    """Many queries against one fixed reference, its k-mer table built
    once; each query streams through in O(|query| + hits)."""

    def similar_segments(self, query: Sequence, K_min: int, p_min: float,
                         **kw):
        """Similar segments between ``query`` (as S) and the reference (as
        T): :meth:`WordBlot.similar_segments` over seeds served from the
        reference's table."""
        return self._as_wordblot(WordBlot, query).similar_segments(
            K_min, p_min, **kw)

    def similar_segments_batch(self, queries, K_min: int, p_min: float):
        """Many queries with one call of the statistics on ``device`` for
        all their candidates; returns one list of segment dicts per query,
        equal to :meth:`similar_segments` query by query."""
        cands = [self._as_wordblot(WordBlot, q)._candidates(K_min, p_min)
                 for q in queries]
        out = [[] for _ in queries]
        flat = [c for cc in cands for c in cc]
        if not flat:
            return out
        p, s0, s1 = _score_components(
            flat, self.wordlen, len(self.ref.alphabet), self.device)
        lt = len(self.ref)
        k = 0
        for qi, cc in enumerate(cands):
            for (d_lo, d_hi, a_lo, a_hi, n, seglen) in cc:
                if p[k] >= p_min - P_MIN_EPS:
                    out[qi].append({
                        "segment": ((int(d_lo) - lt, int(d_hi) - lt),
                                    (int(a_lo), int(a_hi))),
                        "p": float(p[k]),
                        "score": (float(s0[k]), float(s1[k])),
                        "num_seeds": int(n),
                    })
                k += 1
        return out


class _SeedsFromRefIndex(SeedIndex):
    """A query's :class:`SeedIndex` against a reference's prebuilt sorted
    k-mer table, on the host: the query's k-mers packed, two binary
    searches over the reference keys for each window's hit run, and the
    ragged runs expanded into flat (i, j) arrays by inverting their
    cumulative counts (the numpy mirror of ``ops.tables.expand_join``),
    then sorted by (d_, a)."""

    def __init__(self, S, T, wordlen, ref_keys, ref_pos):
        with Phase("seeds.from_ref"):
            self.S, self.T = S, T
            self.wordlen = wordlen
            self.alphabet = S.alphabet
            self.path = None
            lt = len(T)
            qk = as_kmer_keys_np(S.to_array(np.int64), wordlen,
                                 len(S.alphabet))
            starts = np.searchsorted(ref_keys, qk, side="left")
            ends = np.searchsorted(ref_keys, qk, side="right")
            counts = np.where(qk >= 0, ends - starts, 0)
            cum = np.cumsum(counts)
            total = int(cum[-1]) if counts.shape[0] else 0
            slot = np.arange(total)
            i = np.searchsorted(cum, slot, side="right")
            rank = slot - (cum[i] - counts[i])
            j = ref_pos[starts[i] + rank]
            d_ = i - j + lt
            a = i + j
            order = np.lexsort((a, d_))
            self._d_ = d_[order]
            self._a = a[order]
            self._acap = len(S) + lt + 1
            self._comp = self._d_ * self._acap + self._a


# ---------------------------------------------------------------------------
# Multiple sequences
# ---------------------------------------------------------------------------

class WordBlotMultiple:
    """N-way similar segments over :class:`.seeds.SeedIndexMultiple`:
    seeds are position tuples (one per sequence); a similar segment is a
    tuple of diagonal bands (one per non-pivot sequence) and an
    antidiagonal range, dense in N-way seeds.  ``device`` (``"cuda"`` by
    default) sorts the k-mer table and scores the candidates; the
    clustering runs on the host."""

    def __init__(self, *seqs: Sequence, wordlen: int = 8, g_max: float = 0.3,
                 sensitivity: float = 0.99, device="cuda", **seed_index_kw):
        assert len(seqs) >= 2
        self.device = resolve_device(device)
        self.seqs = seqs
        self.wordlen = int(wordlen)
        self.g_max = float(g_max)
        self.sensitivity = float(sensitivity)
        # max_hits_per_kmer and max_tuples_per_kmer pass through
        self.seed_index = SeedIndexMultiple(*seqs, wordlen=wordlen,
                                            device=self.device,
                                            **seed_index_kw)

    def band_radius(self, K) -> int:
        return int(band_radius(K, self.g_max, self.sensitivity))

    def estimate_match_probability(self, num_seeds, seglen) -> float:
        # an N-way seed survives in all N sequences: E[n] ≈ K p^((N-1) w)
        n_other = len(self.seqs) - 1
        n = max(float(num_seeds), 0.0)
        K = max(float(seglen), 1.0)
        return float(np.clip(
            (n / K) ** (1.0 / (self.wordlen * n_other)), 0.0, 1.0))

    def score_seeds(self, K: int) -> List[Dict]:
        """Per-seed local match-probability estimates, the N-way analog of
        :meth:`WordBlot.score_seeds`: each seed is bucketed by its
        diagonal tuple (cell size = band radius on each axis) and
        antidiagonal cell; its neighbourhood count is the number of seeds
        within ±1 cell along every axis, and p̂ is the ``1/((N-1) w)``-th
        root of the neighbourhood's density."""
        seeds = self.seed_index.seeds()
        if not seeds:
            return []
        r = max(self.band_radius(K), 1)
        acell = max(2 * K, 2)
        # cell key per seed: (N-1 diagonal cells, antidiagonal cell)
        cells = []
        counts: Dict[tuple, int] = {}
        for tup in seeds:
            i0 = tup[0]
            key = tuple((i0 - p) // r for p in tup[1:]) \
                + ((i0 + tup[1]) // acell,)
            cells.append(key)
            counts[key] = counts.get(key, 0) + 1
        # neighbourhood = 3^N cells; N is small
        n_axes = len(cells[0])
        offsets = list(itertools.product((-1, 0, 1), repeat=n_axes))
        neigh_cache: Dict[tuple, int] = {}

        def neighborhood(key):
            got = neigh_cache.get(key)
            if got is None:
                got = sum(
                    counts.get(tuple(k + o for k, o in zip(key, off)), 0)
                    for off in offsets)
                neigh_cache[key] = got
            return got

        # the pairwise score_seeds' calibration: the 3-cell
        # a-neighbourhood spans ~3K alignment columns
        seg_cols = min(3 * acell / 2.0,
                       float(min(len(s) for s in self.seqs)))
        w_eff = self.wordlen * (len(self.seqs) - 1)
        out = []
        for tup, key in zip(seeds, cells):
            n = neighborhood(key)
            p = float(np.clip((n / seg_cols) ** (1.0 / w_eff), 0.0, 1.0))
            out.append({"seed": tuple(int(x) for x in tup),
                        "neighs": int(n), "p": p})
        return out

    def similar_segments(self, K_min: int, p_min: float,
                         min_score: float = 25.0) -> Iterable[Dict]:
        """Cluster N-way seeds by their diagonal tuple and antidiagonal
        cell.

        Yields ``{'segment': (((d_lo, d_hi),) * (N-1), (a_min, a_max)),
        'p': p̂, 'score': (S0, S1), 'num_seeds': n}``.  A candidate must
        reject H0 (``S0 >= min_score``; ``None`` turns the gate off) as
        well as reach p̂ >= p_min: p̂ takes the ``1/((N-1) w)``-th root
        of the density, so background k-mers at a low ``p_min`` clear
        it while their count is explained by the ``|Σ|^-((N-1) w)``
        background rate.  The H0 / H1 statistics are the pairwise ones
        with word length ``(N-1) * w`` over the area Π band widths ×
        seglen.
        """
        seeds = self.seed_index.seeds()
        if not seeds:
            return
        r = self.band_radius(K_min)
        acell = max(2 * K_min, 2)
        buckets: Dict[tuple, list] = {}
        for tup in seeds:
            i0 = tup[0]
            ds = tuple((i0 - p) // max(r, 1) for p in tup[1:])
            a = i0 + tup[1]
            buckets.setdefault(ds, []).append((tup, a))
        # merge buckets whose diagonal tuples are axis neighbours: an
        # alignment whose pivot diagonal drifts across a cell boundary
        # (the drift's scale is r by construction) would otherwise split
        # into fragments shorter than K_min
        parent = {ds: ds for ds in buckets}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for ds in list(buckets):
            for axis in range(len(ds)):
                nb = ds[:axis] + (ds[axis] + 1,) + ds[axis + 1:]
                if nb in buckets:
                    ra, rb = find(ds), find(nb)
                    if ra != rb:
                        parent[rb] = ra
        clusters: Dict[tuple, dict] = {}
        for ds, members in buckets.items():
            c = clusters.setdefault(find(ds), {"members": [], "cells": []})
            c["members"].extend(members)
            c["cells"].append(ds)

        max_cols = float(min(len(s) for s in self.seqs))
        rr = max(r, 1)
        # collect every candidate run, then score them all in one call
        pend = []
        for c in clusters.values():
            members = sorted(c["members"], key=lambda m: m[1])
            # split into antidiagonal runs at gaps > 2 * acell
            run = [members[0]]
            runs = []
            for m in members[1:]:
                if m[1] - run[-1][1] > 2 * acell:
                    runs.append(run)
                    run = []
                run.append(m)
            runs.append(run)
            d_bands = tuple(
                (min(ds[ax] for ds in c["cells"]) * rr - r,
                 (max(ds[ax] for ds in c["cells"]) + 1) * rr + r)
                for ax in range(len(c["cells"][0])))
            # tuple-position area: Π (non-pivot band widths) × seglen
            width_prod = 1.0
            for (dl, dh) in d_bands:
                width_prod *= float(dh - dl + 1)
            for run in runs:
                a_lo, a_hi = run[0][1], run[-1][1]
                seglen = max(min((a_hi - a_lo) / 2.0, max_cols),
                             float(self.wordlen))
                if seglen < K_min:
                    continue
                pend.append((d_bands, int(a_lo), int(a_hi), len(run),
                             seglen, width_prod * seglen))
        if not pend:
            return
        w_eff = self.wordlen * (len(self.seqs) - 1)
        cols = np.asarray([(n, area, seglen)
                           for (_, _, _, n, seglen, area) in pend],
                          np.float64)
        p_hats, s0s, s1s = _batched_stats(
            cols[:, 0], cols[:, 1], cols[:, 2], w_eff,
            len(self.seqs[0].alphabet), self.device)
        for k, (d_bands, a_lo, a_hi, n, seglen, _) in enumerate(pend):
            if p_hats[k] < p_min - P_MIN_EPS:
                continue
            if min_score is not None and s0s[k] < min_score:
                continue
            yield {
                "segment": (d_bands, (a_lo, a_hi)),
                "p": float(p_hats[k]),
                "score": (float(s0s[k]), float(s1s[k])),
                "num_seeds": n,
            }
