"""Plain read mapping to a fixed reference: the benchmark's reference for
each read's segments and its best one.

NumPy (and the float64 statistics of :mod:`.blot`); it imports nothing
of the program under test.  The definitions are :mod:`.blot`'s, with the
read as S and the reference as T, and the reference biseqt
``WordBlotLocalRef`` contract as the library serves it:

* the reference's table is its k-mer keys and positions, sorted once by
  key (positions ascending within a key); a read's seeds are found by
  two binary searches for each of its windows and sorted by (d_, a);
* where the (d, a) grid of cells (:func:`.blot.similar_segments`) holds
  at most ``MAX_GRID_CELLS`` cells, the candidate boxes are its hot
  cells' 8-connected components, taken sparsely: the threshold is at
  least 1, so only cells within one cell of an occupied cell can be hot;
* beyond, the sparse assembly of the library's contract: each d-cell's
  seeds in antidiagonal order split into runs at gaps of more than two
  a-cells; runs of fewer than 3 seeds are dropped; in order of their
  first antidiagonal (ties in (d-cell, a) order), each run joins the
  latest earlier run of its own and each neighbouring d-cell whose last
  antidiagonal, plus one a-cell, reaches its first less one a-cell; a
  component's box spans its runs' d-cells whole and their antidiagonals
  exactly, and components come in the order of their first run;
* each box's seeds are counted exactly, its length is min((a_hi - a_lo
  + 1) / 2, min(|S|, |T|)) columns, and its statistics and the p_min test
  are :func:`.blot.stats`'s;
* a read's best segment has the most seeds, the first on a tie.

Provenance of ``MAX_GRID_CELLS``: the library's switch between its two
assemblers (``WordBlot.MAX_GRID_CELLS`` in the port and the JAX
package), copied so that the yardstick cannot move with the program.
"""

import numpy as np
import torch

from . import blot

MAX_GRID_CELLS = 1 << 22


class RefTable:
    """The reference's ``w``-mer keys sorted once, with their positions."""

    def __init__(self, ref, w, A):
        keys = blot.kmer_keys(np.asarray(ref, np.int64), w, A)
        order = np.argsort(keys, kind="stable")
        self.keys, self.pos = keys[order], order.astype(np.int64)
        self.len, self.w, self.A = len(ref), w, A

    def seeds(self, read):
        """The read's seeds against the reference, sorted by (d_, a)."""
        qk = blot.kmer_keys(np.asarray(read, np.int64), self.w, self.A)
        lo = np.searchsorted(self.keys, qk, "left")
        counts = np.searchsorted(self.keys, qk, "right") - lo
        ends = np.cumsum(counts)
        total = int(ends[-1]) if len(ends) else 0
        i = np.repeat(np.arange(len(qk), dtype=np.int64), counts)
        at = np.arange(total) - np.repeat(ends - counts, counts)
        j = self.pos[np.repeat(lo, counts) + at]
        d_, a = i - j + self.len, i + j
        o = np.lexsort((a, d_))
        return d_[o], a[o]


def _components(cells):
    """8-connected components of the cells ``(d, a)`` (row-major sorted):
    bounding boxes ``(d0, d1, a0, a1)`` (half-open), in the order of each
    component's first cell."""
    index = {c: k for k, c in enumerate(cells)}
    parent = list(range(len(cells)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for k, (d, a) in enumerate(cells):
        for dd in (-1, 0, 1):
            for da in (-1, 0, 1):
                other = index.get((d + dd, a + da))
                if other is not None:
                    ra, rb = find(k), find(other)
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
    boxes = {}
    for k, (d, a) in enumerate(cells):
        b = boxes.setdefault(find(k), [d, d, a, a])
        b[0], b[1] = min(b[0], d), max(b[1], d)
        b[2], b[3] = min(b[2], a), max(b[3], a)
    return [(b[0], b[1] + 1, b[2], b[3] + 1) for _, b in sorted(boxes.items())]


def hot_boxes(d_, a, dcell, acell, n_d, n_a, thresh):
    """The dense grid's candidate boxes ``(d_lo, d_hi, a_lo, a_hi)``
    (inclusive, shifted diagonals), from the occupied cells alone."""
    if not len(d_):
        return []
    cell = (np.clip(d_ // dcell, 0, n_d - 1) * n_a
            + np.clip(a // acell, 0, n_a - 1))
    occ, cnt = np.unique(cell, return_counts=True)
    off = np.array([(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)])
    cd = (occ // n_a)[:, None] + off[:, 0]
    ca = (occ % n_a)[:, None] + off[:, 1]
    inside = (cd >= 0) & (cd < n_d) & (ca >= 0) & (ca < n_a)
    keys, inv = np.unique((cd * n_a + ca)[inside], return_inverse=True)
    sums = np.bincount(inv, weights=np.broadcast_to(cnt[:, None],
                                                    cd.shape)[inside])
    hot = keys[sums >= thresh]
    cells = [(int(k // n_a), int(k % n_a)) for k in hot]
    return [(d0 * dcell, d1 * dcell - 1, a0 * acell, a1 * acell - 1)
            for d0, d1, a0, a1 in _components(cells)]


def run_boxes(d_, a, dcell, acell):
    """The sparse assembly's candidate boxes ``(d_lo, d_hi, a_lo, a_hi)``
    (inclusive, shifted diagonals)."""
    if not len(d_):
        return []
    dc = d_ // dcell
    o = np.lexsort((a, dc))
    dc, ao = dc[o], a[o]
    cut = np.flatnonzero((dc[1:] != dc[:-1]) | (np.diff(ao) > 2 * acell))
    starts = np.concatenate([[0], cut + 1])
    ends = np.concatenate([cut + 1, [len(dc)]])
    # (d-cell, first antidiagonal, last antidiagonal) of each run of 3 or
    # more seeds
    runs = [(int(dc[s]), int(ao[s]), int(ao[e - 1]))
            for s, e in zip(starts, ends) if e - s >= 3]
    parent = list(range(len(runs)))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    latest = {}
    for idx in sorted(range(len(runs)), key=lambda r: runs[r][1]):
        c, lo, _ = runs[idx]
        for cc in (c - 1, c, c + 1):
            other = latest.get(cc)
            if other is not None and runs[other][2] + acell >= lo - acell:
                ra, rb = find(idx), find(other)
                if ra != rb:
                    parent[rb] = ra
        latest[c] = idx
    comps = {}
    for idx in range(len(runs)):
        comps.setdefault(find(idx), []).append(runs[idx])
    return [(min(r[0] for r in m) * dcell, (max(r[0] for r in m) + 1) * dcell
             - 1, min(r[1] for r in m), max(r[2] for r in m))
            for m in comps.values()]


def similar_segments(read, table, g_max, K_min, p_min, sensitivity=0.99,
                     dtype=torch.float64, max_grid_cells=MAX_GRID_CELLS):
    """The read's segments against the reference of ``table``, in the
    library's order: dicts with ``segment`` ((d_lo, d_hi), (a_lo, a_hi))
    in true diagonals, ``num_seeds``, ``p`` and ``score`` (S0, S1)."""
    ls, lt, w = len(read), table.len, table.w
    d_, a = table.seeds(read)
    r = blot.band_radius(K_min, g_max, sensitivity)
    acell, dcell = max(2 * K_min, 2), max(r, 1)
    n_d = (ls + lt) // dcell + 2
    n_a = (ls + lt) // acell + 2
    if n_d * n_a > max_grid_cells:
        boxes = run_boxes(d_, a, dcell, acell)
    else:
        thresh = max(1.0, 3 * acell / 2.0 * (p_min ** w) * 0.5)
        boxes = hot_boxes(d_, a, dcell, acell, n_d, n_a, thresh)
    acap = ls + lt + 1
    out = []
    for d_lo, d_hi, a_lo, a_hi in boxes:
        n = blot.count(d_, a, acap, d_lo, d_hi, a_lo, a_hi)
        K = min((a_hi - a_lo + 1) / 2.0, float(min(ls, lt)))
        if K < K_min:
            continue
        p, s0, s1 = blot.stats(n, (d_hi - d_lo + 1) * K, K, w, table.A,
                               dtype)
        if p < p_min - blot.P_MIN_EPS:
            continue
        out.append({"segment": ((d_lo - lt, d_hi - lt), (a_lo, a_hi)),
                    "num_seeds": n, "p": p, "score": (s0, s1)})
    return out


def best(segments):
    """The index of the segment with the most seeds (the first on a tie),
    None where there is none."""
    if not segments:
        return None
    return max(range(len(segments)), key=lambda k: segments[k]["num_seeds"])
