"""The geometry of a batched banded extension, frozen.

Provenance: copied from ``biseqt_tpu_torch/pipeline.py`` as it stood at
commit d6aa63c (``PAD_RADIUS``, ``PAD_A``, ``DIRS_BUDGET``, ``_bucket``,
``_split_windows``, ``cut_segment`` and the ``band_cells`` of each output
row), which in turn is the JAX package's geometry.  It is the library's
contract for which cells an extension covers: each candidate segment's
(d, a) rectangle grown by ``PAD_RADIUS`` diagonals and ``PAD_A``
antidiagonals, split into overlapping a-windows where its direction plane
would pass ``DIRS_BUDGET``.  The benchmark counts band cells with these
rules and the reference aligns inside the bands they give, so a change to
the program's padding or windows cannot change the yardstick.
"""

PAD_RADIUS = 16
PAD_A = 512
DIRS_BUDGET = 512 << 20


def bucket(n, mini=128):
    """Round up to the half-power-of-two grid (1M, 1.5M, 2M, 3M, ...)."""
    n = max(int(n), 1)
    if n <= mini:
        return mini
    step = max(mini, 1 << (max(n.bit_length(), 2) - 2))
    return ((n + step - 1) // step) * step


def split_windows(segments, with_transcripts, pad_radius=PAD_RADIUS,
                  pad_a=PAD_A, dirs_budget=DIRS_BUDGET):
    """The rows an extension solves: ``[(source index, ((d_lo, d_hi),
    (a_lo, a_hi)))]``.  With transcripts a segment whose antidiagonal span
    would fill more than ``dirs_budget`` bytes of direction plane is split
    into overlapping a-windows."""
    rows = []
    for k, seg in enumerate(segments):
        (d_lo, d_hi), (a_lo, a_hi) = seg["segment"]
        W_est = bucket(d_hi - d_lo + 1 + 2 * pad_radius, mini=128)
        max_a = max(2 * dirs_budget // W_est, 8 * pad_a)
        span = a_hi - a_lo + 1
        if not with_transcripts or span <= max_a:
            rows.append((k, ((d_lo, d_hi), (a_lo, a_hi))))
            continue
        n_win = -(-span // max_a)
        step = -(-span // n_win)
        for w in range(n_win):
            lo = a_lo + w * step
            hi = min(lo + step + 2 * pad_a, a_hi)
            rows.append((k, ((d_lo, d_hi), (lo, hi))))
    return rows


def cut_segment(segment, len_s, len_t, pad_radius=PAD_RADIUS, pad_a=PAD_A):
    """The padded rectangle of a row and its band relative to the cutouts:
    ``(i_lo, i_hi, j_lo, j_hi, d_lo', d_hi')``."""
    (d_lo, d_hi), (a_lo, a_hi) = segment
    d_lo -= pad_radius
    d_hi += pad_radius
    a_lo -= pad_a
    a_hi += pad_a
    i_lo = max((a_lo + d_lo) // 2, 0)
    i_hi = min((a_hi + d_hi + 1) // 2 + 1, len_s)
    j_lo = max((a_lo - d_hi) // 2, 0)
    j_hi = min((a_hi - d_lo + 1) // 2 + 1, len_t)
    i_hi = max(i_hi, i_lo + 1)
    j_hi = max(j_hi, j_lo + 1)
    off = i_lo - j_lo
    return (i_lo, i_hi, j_lo, j_hi, d_lo - off, d_hi - off)


def band(cut):
    """The diagonals ``(lo, hi)`` of the cutouts that the extension
    aligns in: the top ``min(width, W - 1)`` of the cut's band, where W
    is the band's width rounded up to the launch grid (one lane of the
    launch absorbs the pairing of even and odd diagonals)."""
    dl, dh = cut[4], cut[5]
    W = bucket(dh - dl + 1, mini=128)
    return max(dl, dh - W + 2), dh


def band_cells(cut):
    """Band cells of a row as the library counts them: the cut band's
    width times the rows of its S cutout."""
    return (cut[5] - cut[4] + 1) * (cut[1] - cut[0])


def rows_of(segments, len_s, len_t, with_transcripts):
    """Every row an extension of ``segments`` solves, with its cut:
    ``[(source index, segment, cut)]``."""
    return [(k, seg, cut_segment(seg, len_s, len_t))
            for k, seg in split_windows(segments, with_transcripts)]
