"""gcups: band cells of every call of the window (counted by the
benchmark from the segments it hands over) over the window's seconds,
in 1e9 a second."""


def read(rec):
    cells = sum(c["cells"] for c in rec["calls"])
    return cells / rec["window_s"] / 1e9 if cells else None
