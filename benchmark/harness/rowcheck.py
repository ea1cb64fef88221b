"""Judging extension rows against the reference (shared by the entries
that extend)."""

from reference import align, cut as refcut


def call_gap(out, rows, want, s, t, subst, go, ge, seen, tag):
    """The worst gap of one call's output rows ``out`` against the rows
    the reference expects (``rows``: ``[(source index, segment, cut)]``;
    ``want``: their reference scores).  A row's gap is the larger of
    |score - reference| and |its transcript's rescoring - reference|; a
    row that is missing, or whose transcript leaves its band or misreads
    its letters, reads as the whole reference score (at least 1), and so
    does every row of a call that raised or returned another number of
    rows.  ``seen`` caches rescorings under ``(tag, row, transcript,
    start)``."""
    full = lambda R: max(abs(float(R)), 1.0)
    if out is None or len(out) != len(rows):
        return max((full(R) for R in want), default=1.0)
    got = {(r["source_index"], tuple(map(tuple, r["segment"]))): r
           for r in out}
    worst = 0.0
    for idx, (src, seg, c) in enumerate(rows):
        R = float(want[idx])
        r = got.get((src, tuple(map(tuple, seg))))
        if r is None:
            worst = max(worst, full(R))
            continue
        key = (tag, idx, r["transcript"], r["origin_start"],
               r["mutate_start"])
        if key not in seen:
            seen[key] = align.rescore(
                r["transcript"], r["origin_start"], r["mutate_start"], s, t,
                c, refcut.band(c), subst, go, ge)
        tx_score, ok = seen[key]
        gap = abs(float(r["score"]) - R)
        worst = max(worst, gap, abs(tx_score - R) if ok else full(R))
    return worst


def reference_scores(groups, subst, go, ge, dtype, device):
    """The reference's score of every row of every group ``(s, t, rows)``,
    one array a group, in one sweep."""
    import numpy as np

    s_list, t_list, bands, sizes = [], [], [], []
    for s, t, rows in groups:
        for _, _, c in rows:
            s_list.append(s[c[0]:c[1]])
            t_list.append(t[c[2]:c[3]])
            bands.append(refcut.band(c))
        sizes.append(len(rows))
    flat = align.local_scores(s_list, t_list, bands, subst, go, ge,
                              dtype=dtype, device=device)
    return np.split(flat, np.cumsum(sizes)[:-1])
