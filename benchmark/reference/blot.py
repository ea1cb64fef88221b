"""Plain Word-Blot discovery: the benchmark's reference for seeds and
similar segments.

NumPy (and ``torch.special.erfinv`` for one quantile); it imports nothing
of the program under test.  The definitions are the reference biseqt
``WordBlot``'s as the library serves it (its documented contract):

* a seed is a pair (i, j) with S[i:i+w] == T[j:j+w]; it sits on the
  shifted diagonal d_ = i - j + |T| and the antidiagonal a = i + j;
* a segment of K columns with gap probability g stays within the band
  radius r = ceil(erfcinv(1 - sensitivity) sqrt(2 g K)) (at least 1);
* seeds are counted in a grid of cells r diagonals by 2 K antidiagonals;
  a cell is hot when its 3 x 3 neighbourhood holds at least
  max(1, (3 K) p_min^w / 2) seeds; each 8-connected component of hot
  cells (numbered in row-major order of its first cell) is a candidate
  box, whose seeds are counted exactly and whose length is
  min((a_hi - a_lo + 1) / 2, min(|S|, |T|)) columns; boxes shorter than
  K are dropped;
* p = (n / K)^(1/w); S0 = -log P(N >= n) for N ~ Binomial(area, |A|^-w)
  and S1 the same for Binomial(K, p^w), each by its normal approximation
  with the deviation floored at 1 and log erfc(z) taken directly up to
  z = 3 and by its asymptotic series beyond; a box is a segment when
  p >= p_min - 1e-5.

Everything is computed in float64 (``dtype`` may lower the statistics'
precision: the control).
"""

import math

import numpy as np
import torch

P_MIN_EPS = 1e-5


def kmer_keys(codes, w, A):
    """The key of every window of ``w`` letters (int64): the letters as
    the digits of a base-``A`` number, the first the most significant."""
    n = len(codes) - w + 1
    keys = np.zeros(max(n, 0), np.int64)
    for k in range(w):
        keys = keys * A + codes[k:k + n]
    return keys


def seeds(s, t, w, A):
    """Every seed, sorted by (d_, a): ``(d_, a)`` int64 arrays."""
    ks, kt = kmer_keys(s, w, A), kmer_keys(t, w, A)
    # both sides sorted by key; each S window meets its key's run of T
    qs = np.argsort(ks, kind="stable")
    order = np.argsort(kt, kind="stable")
    sk = kt[order]
    lo = np.searchsorted(sk, ks[qs], "left")
    counts = np.searchsorted(sk, ks[qs], "right") - lo
    i = np.repeat(qs.astype(np.int64), counts)
    ends = np.cumsum(counts)
    at = np.arange(int(ends[-1]) if len(ends) else 0) - np.repeat(
        ends - counts, counts)
    j = order[np.repeat(lo, counts) + at].astype(np.int64)
    d_, a = i - j + len(t), i + j
    o = np.argsort(d_ * (len(s) + len(t) + 1) + a)
    return d_[o], a[o]


def band_radius(K, g, sensitivity=0.99):
    q = float(torch.special.erfinv(torch.tensor(float(sensitivity),
                                                dtype=torch.float64)))
    return max(1, int(math.ceil(q * math.sqrt(2.0 * g * K))))


def _components(hot):
    """8-connected components of a boolean grid's true cells, numbered in
    row-major order of their first cell: a list of ``(d0, d1, a0, a1)``
    bounding boxes (half-open)."""
    cells = np.argwhere(hot)
    if not len(cells):
        return []
    index = {(int(d), int(a)): k for k, (d, a) in enumerate(cells)}
    parent = list(range(len(cells)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for k, (d, a) in enumerate(cells):
        for dd in (-1, 0, 1):
            for da in (-1, 0, 1):
                other = index.get((int(d) + dd, int(a) + da))
                if other is not None:
                    ra, rb = find(k), find(other)
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
    boxes = {}
    for k, (d, a) in enumerate(cells):
        r = find(k)
        b = boxes.setdefault(r, [d, d, a, a])
        b[0], b[1] = min(b[0], d), max(b[1], d)
        b[2], b[3] = min(b[2], a), max(b[3], a)
    # argwhere is row-major and every root is its component's first cell
    return [(b[0], b[1] + 1, b[2], b[3] + 1)
            for _, b in sorted(boxes.items())]


def count(d_, a, acap, d_lo, d_hi, a_lo, a_hi):
    """Seeds with d_ in [d_lo, d_hi] and a in [a_lo, a_hi]."""
    comp = d_ * acap + a
    ds = np.arange(d_lo, d_hi + 1, dtype=np.int64)
    a_lo, a_hi = max(a_lo, 0), min(a_hi, acap - 1)
    lo = np.searchsorted(comp, ds * acap + a_lo, "left")
    hi = np.searchsorted(comp, ds * acap + a_hi, "right")
    return int((hi - lo).sum())


def _log_erfc(z):
    if z <= 3.0:
        return math.log(math.erfc(z))
    return (-z * z - math.log(z) - 0.5 * math.log(math.pi)
            + math.log1p(-1.0 / (2.0 * z * z)))


def _neg_log_p(mu, sd, x):
    return -(_log_erfc((x - mu) / sd / math.sqrt(2.0)) - math.log(2.0))


def stats(n, area, K, w, A, dtype=torch.float64):
    """``(p, S0, S1)`` of a box with ``n`` seeds, ``area`` band cells and
    ``K`` columns, each rounded to the torch ``dtype`` at every step of
    the arithmetic (float64: the reference; lower: the control)."""
    r = (lambda v: v) if dtype == torch.float64 else (
        lambda v: float(torch.tensor(v, dtype=torch.float64).to(dtype)))
    K = max(K, 1.0)
    p = r(min(max(r(r(n / K) ** r(1.0 / w)), 0.0), 1.0))
    p0 = A ** -w
    mu0 = r(area * p0)
    sd0 = max(r(math.sqrt(r(mu0 * (1.0 - p0)))), 1.0)
    pw = r(p ** w)
    mu1 = r(K * pw)
    sd1 = max(r(math.sqrt(r(mu1 * (1.0 - pw)))), 1.0)
    return p, r(_neg_log_p(mu0, sd0, n)), r(_neg_log_p(mu1, sd1, n))


def similar_segments(s, t, w, A, g_max, K_min, p_min, sensitivity=0.99,
                     seed_arrays=None, dtype=torch.float64):
    """The segments Word-Blot discovers, in its order: dicts with
    ``segment`` ((d_lo, d_hi), (a_lo, a_hi)) in true diagonals,
    ``num_seeds``, ``p`` and ``score`` (S0, S1)."""
    ls, lt = len(s), len(t)
    d_, a = seeds(s, t, w, A) if seed_arrays is None else seed_arrays
    r = band_radius(K_min, g_max, sensitivity)
    acell, dcell = max(2 * K_min, 2), max(r, 1)
    n_d = (ls + lt) // dcell + 2
    n_a = (ls + lt) // acell + 2
    grid = np.bincount(np.clip(d_ // dcell, 0, n_d - 1) * n_a
                       + np.clip(a // acell, 0, n_a - 1),
                       minlength=n_d * n_a).reshape(n_d, n_a)
    pad = np.zeros((n_d + 2, n_a + 2), np.int64)
    pad[1:-1, 1:-1] = grid
    neigh = sum(pad[i:i + n_d, j:j + n_a] for i in range(3)
                for j in range(3))
    thresh = max(1.0, 3 * acell / 2.0 * (p_min ** w) * 0.5)
    acap = ls + lt + 1
    out = []
    for d0, d1, a0, a1 in _components(neigh >= thresh):
        d_lo, d_hi = d0 * dcell, d1 * dcell - 1
        a_lo, a_hi = a0 * acell, a1 * acell - 1
        n = count(d_, a, acap, d_lo, d_hi, a_lo, a_hi)
        K = min((a_hi - a_lo + 1) / 2.0, float(min(ls, lt)))
        if K < K_min:
            continue
        p, s0, s1 = stats(n, (d_hi - d_lo + 1) * K, K, w, A, dtype)
        if p < p_min - P_MIN_EPS:
            continue
        out.append({"segment": ((d_lo - lt, d_hi - lt), (a_lo, a_hi)),
                    "num_seeds": n, "p": p, "score": (s0, s1)})
    return out
