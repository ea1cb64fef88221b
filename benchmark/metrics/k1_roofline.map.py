"""k1_roofline.map: the DP kernel's share of its roofline in the traced
stretch (``harness.readers.k1_roofline_pct``), its work counted from the
rows of the reference's best segments."""

from harness import readers


def read(rec):
    return readers.k1_roofline_pct(rec)
