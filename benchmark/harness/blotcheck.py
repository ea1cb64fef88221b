"""Judging discovered segments against the reference's (shared by the
entries that discover)."""

import numpy as np


def segment_diff(got, want):
    """How many of ``got``'s segments differ from ``want``'s, in order,
    by box or seed count (a missing or extra one counts)."""
    key = lambda sg: (tuple(map(tuple, sg["segment"])), int(sg["num_seeds"]))
    n = sum(key(g) != key(w) for g, w in zip(got, want))
    return n + abs(len(got) - len(want))


def stat_gap(got, want, names=("p", "S0", "S1")):
    """The widest gap of the statistics ``names`` between matching
    segments, each relative to the reference's value (at least 1)."""
    gap = 0.0
    for g, w in zip(got, want):
        for name in names:
            a, b = _stat(g, name), _stat(w, name)
            gap = max(gap, abs(a - b) / max(abs(b), 1.0))
    return gap


def _stat(sg, name):
    return float(sg["p"] if name == "p" else
                 sg["score"][0 if name == "S0" else 1])


def seeds_diff(got, want):
    """0 when the seed arrays ``(d_, a)`` equal the reference's, else the
    number of seeds that differ (at least 1)."""
    (gd, ga), (wd, wa) = got, want
    if len(gd) == len(wd) and np.array_equal(gd, wd) and \
            np.array_equal(ga, wa):
        return 0
    n = min(len(gd), len(wd))
    return max(1, int(((gd[:n] != wd[:n]) | (ga[:n] != wa[:n])).sum())
               + abs(len(gd) - len(wd)))
