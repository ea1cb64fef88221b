"""step_mfu.genome: the whole call's share of the card's float32 peak:
the DP's operations for every call of the window (``counts/dp_ad.py``,
from the band cells the benchmark counts) over the window's seconds
times the peak (``harness/peaks.py``), in percent."""

from harness import readers


def read(rec):
    return readers.step_mfu_pct(rec)
