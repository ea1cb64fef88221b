"""k1_roofline.extend: the DP kernel's share of its roofline in
the traced stretch (``harness.readers.k1_roofline_pct``)."""

from harness import readers


def read(rec):
    return readers.k1_roofline_pct(rec)
