"""Work of the banded affine-gap DP (K1, ``dp_ad_kernel``), counted from
the recurrence and not from any kernel's source, so that a rewritten
kernel is held to the same work.

Operations per band cell (float32; local mode, the main path's), from
the Gotoh recurrence of ``reference/align.py``:

    F = max(H_up + (go + ge), F_up + ge)        2 adds, 1 max
    E = max(H_left + (go + ge), E_left + ge)    2 adds, 1 max
    diag = H_diag + subst[s, t]                 1 add (the lookup is a load)
    H = max(0, diag, E, F)                      3 maxes
    best = max(best, H)                         1 max (local end)

11 operations for the score alone.  A transcript needs each cell's
directions and the end cell: which of diag, E and F (or the local stop)
gave H (3 compares: H == diag, H == E, H == 0), whether E and F extend a
gap (2 compares: E_left + ge >= H_left + go + ge, the same for F) and
whether H beats the best so far (1 compare, whose position is kept):
6 more, 17 with directions.  The program's kernel counts 14 and 19 from
its source (a drifted form: lane and wrap masks and the tracker's drift
are its own bookkeeping, which the recurrence does not need).

Bytes: each pair's letter codes read once (one byte a letter of its S
and T cutouts); with directions the plane written once, half a byte (a
nibble) a band cell; the score written (4 bytes) and with directions the
end cell (8 bytes).
"""

OPS_PER_CELL = {False: 11, True: 17}


def work(rows, with_dirs):
    """``(operations, bytes)`` of the DP over ``rows``, each ``(band
    cells, S letters, T letters)``."""
    cells = sum(r[0] for r in rows)
    nbytes = sum(r[1] + r[2] for r in rows) + 4 * len(rows)
    if with_dirs:
        nbytes += cells / 2 + 8 * len(rows)
    return OPS_PER_CELL[bool(with_dirs)] * cells, nbytes
